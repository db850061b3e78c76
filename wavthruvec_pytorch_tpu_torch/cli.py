"""Command line of the port (JAX package: cli.py): the training loops, the
serving front ends, and the data-preparation and model-upkeep commands:

    python -m wavthruvec_pytorch_tpu_torch.cli train-text2vec --config ... [--max_steps N]
    python -m wavthruvec_pytorch_tpu_torch.cli train-vec2wav  --config ... [--max_steps N]
    python -m wavthruvec_pytorch_tpu_torch.cli synthesize --text "..." --ref_npy ... --spk_emb ...
    python -m wavthruvec_pytorch_tpu_torch.cli serve      --spk_emb_dir ...  (stdin loop)
    python -m wavthruvec_pytorch_tpu_torch.cli serve-http --spk_emb_dir ... [--port 8571]
    python -m wavthruvec_pytorch_tpu_torch.cli eval-text2vec --config ... [--step N --rtf]
    python -m wavthruvec_pytorch_tpu_torch.cli prepare-data --wavs_path ... --model_path DIR
    python -m wavthruvec_pytorch_tpu_torch.cli pre-spk-emb --wavs_root ... --out_dir ...
    python -m wavthruvec_pytorch_tpu_torch.cli make-demo-data [--root ./data/demo]
    python -m wavthruvec_pytorch_tpu_torch.cli recalibrate-bn --t2v_checkpoint ... --filelist ...
    python -m wavthruvec_pytorch_tpu_torch.cli recalibrate-bn --generator_checkpoint ... --filelist ...
    python -m wavthruvec_pytorch_tpu_torch.cli export-torch --stage t2v|v2w --checkpoint DIR

The flags are the JAX package's (the training commands take their loop's,
``train/text2vec_loop.py`` and ``train/vec2wav_loop.py``, and
``eval-text2vec`` ``infer/eval.py``'s), plus ``--device`` (default: the
card; pass ``--device cpu`` to run the kernels' plain versions on the CPU)
and, for ``synthesize``, ``--t2v_config`` / ``--v2w_config`` as the serving
commands have them.  Checkpoints are the torch reference's files
(``checkpoint_{step}.pth.tar``, ``g_XXXXXXXX``), which the training loops
write, or the JAX package's orbax directories, read without JAX
(``orbax_format``): variables for serving, ``eval-text2vec`` and
``recalibrate-bn``, training states for the loops' resume and for
``export-torch``, which writes the reference's files from one as the JAX
package's ``export-torch`` does.  Without a checkpoint a model takes seeded
random weights.  Pretrained wav2vec 2.0 and SpeechBrain weights are read
from local paths only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "train-text2vec":
        from wavthruvec_pytorch_tpu_torch.train import text2vec_loop

        text2vec_loop.main(text2vec_loop.parse_args(rest))
        return 0
    if cmd == "train-vec2wav":
        from wavthruvec_pytorch_tpu_torch.train import vec2wav_loop

        vec2wav_loop.main(vec2wav_loop.parse_args(rest))
        return 0
    if cmd == "synthesize":
        return _synthesize(rest)
    if cmd == "serve":
        return _serve(rest)
    if cmd == "serve-http":
        return _serve_http(rest)
    if cmd == "eval-text2vec":
        from wavthruvec_pytorch_tpu_torch.infer import eval as t2v_eval

        return t2v_eval.main(t2v_eval.parse_args(rest))
    if cmd == "prepare-data":
        return _prepare_data(rest)
    if cmd == "pre-spk-emb":
        return _pre_spk_emb(rest)
    if cmd == "make-demo-data":
        return _make_demo_data(rest)
    if cmd == "recalibrate-bn":
        return _recalibrate_bn(rest)
    if cmd == "export-torch":
        return _export_torch(rest)
    print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
    return 1


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--t2v_config", default="",
                   help="Text2VecConfig JSON (e.g. data/demo/text2vec_tiny.json)")
    p.add_argument("--v2w_config", default="",
                   help="Vec2WavConfig JSON (e.g. data/demo/vec2wav_tiny.json)")
    p.add_argument("--t2v_checkpoint", default=None,
                   help="the reference's checkpoint_{step}.pth.tar (key 'model'), or the JAX "
                   "package's orbax Text2Vec variables directory")
    p.add_argument("--gen_checkpoint", default=None,
                   help="the reference's g_XXXXXXXX (key 'generator'), or the JAX package's "
                   "orbax Generator variables directory")
    p.add_argument("--vocab_path", default="./data/vocab.txt")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--max_frames", type=int, default=0,
                   help="output frame cap (default: the largest frame bucket)")
    p.add_argument("--gen_precision", choices=("f32", "bf16"), default="f32",
                   help="vocoder serving precision: bf16 folds weight norm and stores and "
                   "computes the convolutions in bf16 (audio stays f32)")
    p.add_argument("--gru_impl", choices=("scan", "pallas"), default=None,
                   help="CBHG BiGRU recurrence (default: the config's): 'scan' computes it in "
                   "f32; 'pallas' rounds h and w_hh to bf16 with an f32 carry where the JAX "
                   "package's Pallas gate admits the shape, and computes f32 elsewhere")
    p.add_argument("--device", default=None, help="default: the card (cuda)")


def _configs(a):
    from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
    from wavthruvec_pytorch_tpu_torch.text import TextFrontend

    if a.t2v_config:
        t2v_cfg = load_config(Text2VecConfig, a.t2v_config)
        vocab_path = t2v_cfg.vocab_path
    else:
        vocab_path = a.vocab_path
        t2v_cfg = dataclasses.replace(Text2VecConfig(), vocab_path=vocab_path,
                                      vocab_size=TextFrontend.from_vocab_file(vocab_path).vocab_size)
    if a.gru_impl:
        t2v_cfg = dataclasses.replace(t2v_cfg, gru_impl=a.gru_impl)
    v2w_cfg = load_config(Vec2WavConfig, a.v2w_config) if a.v2w_config else Vec2WavConfig()
    return t2v_cfg, v2w_cfg, TextFrontend.from_vocab_file(vocab_path)


def _serving_parser() -> argparse.ArgumentParser:
    """The flags of the stdin (``serve``) and HTTP (``serve-http``) front ends."""
    p = argparse.ArgumentParser()
    p.add_argument("--spk_emb_dir", required=True)
    p.add_argument("--ref_feat_dir", default=None,
                   help="{spk}/*.npy wav2vec reference clips for the Text2Vec conditioning "
                   "(cached per speaker)")
    _add_common(p)
    p.add_argument("--out_dir", default="./serve_out")
    p.add_argument("--speaker", default=None, help="default speaker id")
    p.add_argument("--warmup", action="store_true",
                   help="run every batch and text bucket once before serving")
    p.add_argument("--max_batch", type=int, default=1,
                   help="coalesce up to N queued requests into one batched synthesis call "
                   "(responses keep request order)")
    p.add_argument("--coalesce_wait_ms", type=float, default=0.0,
                   help="after the first queued request, wait up to this long for more "
                   "before dispatching (0: dispatch at once with whatever is queued)")
    p.add_argument("--pcm", action="store_true",
                   help="write raw int16 PCM to stdout (framed by control lines) instead "
                   "of wav files")
    p.add_argument("--stream_chunk", type=int, default=0,
                   help="with --pcm: emit audio in chunks of N latent frames while later "
                   "chunks compute (StreamingVocoder)")
    return p


def _build_serving_stack(a):
    """(synth, store) from parsed serving flags, shared by both front ends."""
    from wavthruvec_pytorch_tpu_torch.infer.serve import SpeakerStore
    from wavthruvec_pytorch_tpu_torch.infer.synthesize import (
        Synthesizer,
        init_import_models,
        make_serving_generator,
    )

    t2v_cfg, v2w_cfg, frontend = _configs(a)
    t2v_state, gen_state = init_import_models(
        t2v_cfg, v2w_cfg, t2v_checkpoint=a.t2v_checkpoint, gen_checkpoint=a.gen_checkpoint)
    gen, gen_state = make_serving_generator(v2w_cfg, gen_state, a.gen_precision,
                                            device=a.device)
    synth = Synthesizer(t2v_cfg, v2w_cfg, t2v_state, gen_state, frontend, device=a.device,
                        gen=gen)
    store = SpeakerStore(synth, a.spk_emb_dir, a.ref_feat_dir)
    return synth, store


def _serve(rest) -> int:
    """The stdin -> wav synthesis loop (infer/serve.py)."""
    from wavthruvec_pytorch_tpu_torch.infer.serve import serve_loop

    a = _serving_parser().parse_args(rest)
    synth, store = _build_serving_stack(a)
    n = serve_loop(synth, store, a.out_dir, default_speaker=a.speaker, alpha=a.alpha,
                   max_frames=a.max_frames or None, do_warmup=a.warmup,
                   max_batch=a.max_batch, pcm=a.pcm, stream_chunk=a.stream_chunk or None,
                   coalesce_wait_ms=a.coalesce_wait_ms)
    print(f"served {n} requests", file=sys.stderr if a.pcm else sys.stdout)
    return 0


def _serve_http(rest) -> int:
    """The HTTP server (infer/http_serve.py): POST /synthesize {"text",
    "speaker"?} -> audio/wav; queued requests coalesce into batched calls of
    up to --max_batch."""
    from wavthruvec_pytorch_tpu_torch.infer.http_serve import serve_http

    p = _serving_parser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571)
    a = p.parse_args(rest)
    synth, store = _build_serving_stack(a)

    def ready(server, service):
        host, port = server.server_address[:2]
        print(f"serving on http://{host}:{port} (speakers={len(store.speakers())}, "
              f"max_batch={a.max_batch})", flush=True)

    n = serve_http(synth, store, host=a.host, port=a.port, default_speaker=a.speaker,
                   alpha=a.alpha, max_frames=a.max_frames or None, max_batch=a.max_batch,
                   do_warmup=a.warmup, ready_cb=ready, coalesce_wait_ms=a.coalesce_wait_ms)
    print(f"served {n} requests")
    return 0


def _synthesize(rest) -> int:
    import numpy as np

    from wavthruvec_pytorch_tpu_torch.data.vocoder_data import load_spk_emb
    from wavthruvec_pytorch_tpu_torch.infer.streaming import StreamingVocoder
    from wavthruvec_pytorch_tpu_torch.infer.synthesize import (
        Synthesizer,
        init_import_models,
        make_serving_generator,
        write_wav,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--text", action="append", required=True)
    p.add_argument("--ref_npy", required=True, help="wav2vec .npy of the reference speaker")
    p.add_argument("--spk_emb", required=True, help=".npy/.pth speaker embedding")
    _add_common(p)
    p.add_argument("--out_dir", default="./results")
    p.add_argument("--fused", action="store_true",
                   help="accepted for the JAX command line: the port's f32 serving Generator "
                   "always runs the fused ResBlock2 kernel")
    p.add_argument("--folded", action="store_true",
                   help="pre-fold weight norm (the reference's remove_weight_norm)")
    p.add_argument("--stream", action="store_true",
                   help="chunked vocoder inference (O(chunk) memory, low time to first "
                   "audio; equal to the full forward)")
    p.add_argument("--chunk_frames", type=int, default=100)
    a = p.parse_args(rest)

    t2v_cfg, v2w_cfg, frontend = _configs(a)
    ref = np.load(a.ref_npy).squeeze()[None].astype(np.float32)
    t2v_state, gen_state = init_import_models(
        t2v_cfg, v2w_cfg, t2v_checkpoint=a.t2v_checkpoint, gen_checkpoint=a.gen_checkpoint,
        folded=a.folded)
    gen, gen_state = make_serving_generator(v2w_cfg, gen_state, a.gen_precision,
                                            folded=a.folded, device=a.device)
    synth = Synthesizer(t2v_cfg, v2w_cfg, t2v_state, gen_state, frontend, device=a.device,
                        gen=gen)
    spk = load_spk_emb(a.spk_emb)[None]
    B = len(a.text)
    ref_b, spk_b = np.repeat(ref, B, axis=0), np.repeat(spk, B, axis=0)
    max_frames = a.max_frames or None
    if a.stream:
        out = synth.text_to_latents(a.text, ref_b, alpha=a.alpha, max_frames=max_frames)
        sv = StreamingVocoder(synth.gen, v2w_cfg, chunk_frames=a.chunk_frames)
        # the noise synthesize() draws with its default seed 0
        wavs = sv.vocode(out["feat_postnet_output"], spk_b, synth._noise(B, 0))
        n_samples = out["total_frames"] * v2w_cfg.total_upsample
    else:
        wavs, n_samples = synth.synthesize(a.text, ref_b, spk_b, alpha=a.alpha,
                                           max_frames=max_frames)
    os.makedirs(a.out_dir, exist_ok=True)
    sr = v2w_cfg.sampling_rate
    for i, (w, n) in enumerate(zip(wavs, n_samples)):
        path = os.path.join(a.out_dir, f"synth_{i}.wav")
        write_wav(path, w[: int(n)], sample_rate=sr)
        print(f"{path}: {int(n) / sr:.2f}s")
    return 0


def _make_demo_data(rest) -> int:
    from wavthruvec_pytorch_tpu_torch.data.demo import make_demo_data

    p = argparse.ArgumentParser()
    p.add_argument("--root", default="./data/demo")
    p.add_argument("--n_speakers", type=int, default=2)
    p.add_argument("--n_utts", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="accepted as the other commands take it: the demo data is made with "
                   "numpy on the host")
    a = p.parse_args(rest)
    root = make_demo_data(a.root, a.n_speakers, a.n_utts, seed=a.seed)
    print(f"demo dataset written to {root}; train on it with:")
    print(f"  python -m wavthruvec_pytorch_tpu_torch.cli train-text2vec "
          f"--config {root}/text2vec_tiny.json --max_steps 3 --device cpu")
    print(f"  python -m wavthruvec_pytorch_tpu_torch.cli train-vec2wav "
          f"--config {root}/vec2wav_tiny.json --max_steps 3 --device cpu")
    return 0


def _prepare_data(rest) -> int:
    """wavs -> wav2vec 2.0 latents, filelists and a vocabulary
    (data/ingest.py)."""
    from wavthruvec_pytorch_tpu_torch.data.ingest import Wav2VecFeaturizer, prepare_data

    p = argparse.ArgumentParser()
    p.add_argument("--wavs_path", required=True)
    p.add_argument("--feat_output_path", required=True)
    p.add_argument("--label_file_path", required=True)
    p.add_argument("--enc_train_list_path", default="./data/enc_train.txt")
    p.add_argument("--enc_val_list_path", default="./data/enc_val.txt")
    p.add_argument("--vocab_path", default="./data/vocab.txt")
    p.add_argument("--model_path", default=None,
                   help="local wav2vec 2.0 checkpoint directory (config.json and "
                   "pytorch_model.bin or model.safetensors)")
    p.add_argument("--random_init", action="store_true",
                   help="seeded random weights of wav2vec 2.0 large, for pipeline runs")
    p.add_argument("--n_speakers", type=int, default=15)
    p.add_argument("--n_files_per_speaker", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default=None, help="default: the card (cuda)")
    a = p.parse_args(rest)
    featurizer = Wav2VecFeaturizer(a.model_path, random_init=a.random_init, device=a.device)
    prepare_data(a.wavs_path, a.feat_output_path, a.label_file_path, a.enc_train_list_path,
                 a.enc_val_list_path, a.vocab_path, featurizer, a.n_speakers,
                 a.n_files_per_speaker, a.batch_size)
    return 0


def _pre_spk_emb(rest) -> int:
    """wavs -> a speaker embedding a speaker (data/spk_emb.py)."""
    from wavthruvec_pytorch_tpu_torch.data.spk_emb import (
        SpeakerEmbedder,
        SpeechBrainEmbedder,
        precompute_speaker_embeddings,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--wavs_root", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_files_per_speaker", type=int, default=50)
    p.add_argument("--speechbrain_ckpt", default=None,
                   help="SpeechBrain spkrec-ecapa-voxceleb embedding_model.ckpt (a local file): "
                   "selects SpeechBrain's ECAPA, the embedder the reference uses "
                   "(vec2wav/pre_spk_emb.py:12)")
    p.add_argument("--speechbrain", action="store_true",
                   help="SpeechBrain's ECAPA with seeded random weights, for pipeline runs")
    p.add_argument("--device", default=None, help="default: the card (cuda)")
    a = p.parse_args(rest)
    if a.speechbrain_ckpt is not None or a.speechbrain:
        embedder = SpeechBrainEmbedder(torch_ckpt=a.speechbrain_ckpt, device=a.device)
    else:
        embedder = SpeakerEmbedder(device=a.device)
    embs = precompute_speaker_embeddings(a.wavs_root, a.out_dir, embedder=embedder,
                                         n_files_per_speaker=a.n_files_per_speaker)
    print(f"wrote {len(embs)} speaker embeddings to {a.out_dir}")
    return 0


def _parse_filelist(path: str, max_items: int):
    """``npy|text|spk`` rows (the reference's filelists, prepare_data.py:90-93)
    -> [(npy, text, spk)]: the first field is the path, the last the
    speaker, everything between the text (which may hold '|').  A row with
    fewer than 3 fields raises with its line number."""
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            if len(parts) < 3:
                raise ValueError(f"{path}:{lineno}: expected 'npy|text|spk' (>=3 |-separated "
                                 f"fields), got {len(parts)}: {line!r}")
            rows.append((parts[0], "|".join(parts[1:-1]), parts[-1]))
            if len(rows) >= max_items:
                break
    return rows


def _recalibrate_bn(rest) -> int:
    """Re-estimate a checkpoint's BatchNorm running statistics from
    calibration data (infer/recalibrate.py) and write the checkpoint again:
    ``--t2v_checkpoint`` (``checkpoint_{step}.pth.tar``, key ``model``)
    refreshes Text2Vec's ECAPA and CBHG statistics, ``--generator_checkpoint``
    (``g_XXXXXXXX``, key ``generator``) the Generator's Conditional
    BatchNorms.  The output, ``{out}/`` + the input's file name, carries
    every other entry of the input unchanged (a Text2Vec file's optimizer
    state, learning rate and epoch), so it resumes as the input would.  An
    input that is the JAX package's orbax variables directory (what the JAX
    command writes) is written as the torch reference's file, which the
    port and the JAX package's importers load: ``checkpoint_{step}.pth.tar``
    (with an optimizer stub at the config's learning rate) or
    ``g_{step:08d}``, the step from the directory's name (0 without one)."""
    import numpy as np
    import torch

    from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
    from wavthruvec_pytorch_tpu_torch.checkpoint import _save
    from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
    from wavthruvec_pytorch_tpu_torch.data.vocoder_data import load_spk_emb
    from wavthruvec_pytorch_tpu_torch.infer.recalibrate import (
        recalibrate_generator_bn,
        recalibrate_text2vec_bn,
        text2vec_calibration_batches,
    )
    from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
    from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
    from wavthruvec_pytorch_tpu_torch.text import TextFrontend

    p = argparse.ArgumentParser()
    p.add_argument("--t2v_checkpoint", default="",
                   help="the reference's checkpoint_{step}.pth.tar, or the JAX package's orbax "
                   "Text2Vec variables directory")
    p.add_argument("--generator_checkpoint", default="",
                   help="the reference's g_XXXXXXXX, or the JAX package's orbax Generator "
                   "variables directory")
    p.add_argument("--filelist", required=True,
                   help="npy|text|spk calibration lines (e.g. the val list)")
    p.add_argument("--feat_root", default="", help="root of the filelist's npy paths")
    p.add_argument("--config", default="", help="config JSON of the selected stage")
    p.add_argument("--vocab_path", default="./data/vocab.txt")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_items", type=int, default=128)
    p.add_argument("--max_frames", type=int, default=0,
                   help="Text2Vec: the inference frame cap (default: the largest frame bucket)")
    p.add_argument("--spk_emb_dir", default="",
                   help="generator: the directory of {spk}.npy/.pth speaker embeddings")
    p.add_argument("--gen_frames", type=int, default=400,
                   help="generator: latent frames a calibration row (rows are cropped; shorter "
                   "rows are skipped)")
    p.add_argument("--seed", type=int, default=1234,
                   help="generator: the seed of the CBN noise (a CPU torch.Generator)")
    p.add_argument("--out", required=True,
                   help="output directory; the file keeps the input's name.  Where the JAX "
                   "command writes an orbax directory, this one writes the torch reference's "
                   "file: from an orbax variables input, checkpoint_{step}.pth.tar or "
                   "g_{step:08d} (the step from the input's name)")
    p.add_argument("--device", default=None, help="default: the card (cuda)")
    a = p.parse_args(rest)
    if bool(a.t2v_checkpoint) == bool(a.generator_checkpoint):
        p.error("pass exactly one of --t2v_checkpoint / --generator_checkpoint")
    src = a.t2v_checkpoint or a.generator_checkpoint
    from_orbax = os.path.isdir(src)
    step = max(ckpt.checkpoint_step(src), 0)
    name = os.path.basename(os.path.normpath(src))
    if from_orbax:
        name = f"checkpoint_{step}.pth.tar" if a.t2v_checkpoint else f"g_{step:08d}"
    out_path = os.path.join(a.out, name)
    if os.path.abspath(out_path) == os.path.abspath(src):
        p.error(f"--out would overwrite the input {src}")
    rows = _parse_filelist(a.filelist, a.max_items)

    def featpath(npy):
        return os.path.join(a.feat_root, npy) if a.feat_root else npy

    if a.t2v_checkpoint:
        if a.config:
            cfg = load_config(Text2VecConfig, a.config)
        else:
            cfg = Text2VecConfig(vocab_path=a.vocab_path,
                                 vocab_size=TextFrontend.from_vocab_file(a.vocab_path).vocab_size)
        obj = (ckpt.reference_text2vec(ckpt.load_torch_state_dict(src, key="model", cfg=cfg), cfg)
               if from_orbax else ckpt._load(src))
        frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
        t2v = Text2Vec(cfg, device=a.device)
        t2v.load_state_dict(obj["model"], strict=True)
        items = [(text, np.load(featpath(npy)).squeeze().astype(np.float32))
                 for npy, text, _spk in rows]
        batches = text2vec_calibration_batches(frontend, cfg, items, batch_size=a.batch_size)
        recalibrate_text2vec_bn(t2v, batches, max_frames=a.max_frames or cfg.frame_buckets[-1])
        _save({**obj, "model": t2v.state_dict()}, out_path)
        print(f"recalibrated Text2Vec BN stats over {len(items)} items ({len(batches)} batches) "
              f"-> {out_path}")
        return 0

    cfg = load_config(Vec2WavConfig, a.config) if a.config else Vec2WavConfig()
    obj = ({"generator": ckpt.load_torch_state_dict(src, key="generator", cfg=cfg)}
           if from_orbax else ckpt._load(src))
    gen = Generator(cfg, device=a.device)
    gen.load_state_dict(obj["generator"], strict=True)

    def spk_vec(spk):
        d = a.spk_emb_dir or cfg.spk_emb_path
        for ext in (".npy", ".pth"):
            path = os.path.join(d, spk + ext)
            if os.path.exists(path):
                return load_spk_emb(path).reshape(-1)[: cfg.spk_dim]
        raise FileNotFoundError(f"no speaker embedding {spk}.npy/.pth under {d!r} "
                                "(--spk_emb_dir)")

    keep, skipped = [], 0
    for npy, _text, spk in rows:
        lat = np.load(featpath(npy)).squeeze().astype(np.float32)
        if lat.shape[0] < a.gen_frames:
            skipped += 1
            continue
        keep.append((lat[: a.gen_frames], spk_vec(spk)))
    if skipped:
        print(f"skipped {skipped} rows shorter than --gen_frames={a.gen_frames}")
    if not keep:
        raise ValueError(f"no calibration rows with >= {a.gen_frames} frames; lower --gen_frames")
    noise = torch.Generator().manual_seed(a.seed)
    batches = []
    for i in range(0, len(keep), a.batch_size):
        chunk = keep[i: i + a.batch_size]
        batches.append((np.stack([lat for lat, _ in chunk]),
                        np.stack([emb for _, emb in chunk]).astype(np.float32),
                        torch.randn((len(chunk), cfg.noise_dim), generator=noise).numpy()))
    recalibrate_generator_bn(gen, batches)
    _save({**obj, "generator": gen.state_dict()}, out_path)
    print(f"recalibrated Generator CBN stats over {len(keep)} items ({len(batches)} batches) "
          f"-> {out_path}")
    return 0


def _export_torch(rest) -> int:
    """The JAX package's ``export-torch``, without JAX: an orbax training
    state of the JAX package as the torch reference's files, keys and
    values equal to what the JAX command writes from the same directory.

    * t2v (a ``T2VTrainState``): ``checkpoint_{step}.pth.tar`` = {model,
      optimizer, learning_rate, epoch};
    * v2w (a ``GANTrainState``): ``g_{step:08d}`` {generator} and
      ``do_{step:08d}`` {mpd, msd, optim_g, optim_d, steps, epoch}.

    As in the JAX command the optimizer entries are stubs at the config's
    learning rate with empty state: the LAMB and AdamW moments are not
    written.  The port's loops resume from the directory itself, moments
    included (``train-text2vec --restore_step``, ``train-vec2wav``)."""
    from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
    from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config

    p = argparse.ArgumentParser()
    p.add_argument("--stage", required=True, choices=("t2v", "v2w"))
    p.add_argument("--checkpoint", required=True,
                   help="orbax checkpoint dir (t2v: .../checkpoint_{step}; "
                   "v2w: .../state_{step:08d})")
    p.add_argument("--config", default="", help="stage config JSON")
    p.add_argument("--out", default="",
                   help="t2v: output file (default checkpoint_{step}.pth.tar next to the input); "
                   "v2w: output dir (default the input's parent)")
    p.add_argument("--step", type=int, default=-1,
                   help="step for the output name (default: parsed from the checkpoint name)")
    a = p.parse_args(rest)

    raw = ckpt.restore_checkpoint(a.checkpoint)
    step = a.step if a.step >= 0 else max(ckpt.checkpoint_step(a.checkpoint), 0)
    parent = os.path.dirname(os.path.abspath(a.checkpoint))
    if a.stage == "t2v":
        cfg = load_config(Text2VecConfig, a.config) if a.config else Text2VecConfig()
        out = a.out or os.path.join(parent, f"checkpoint_{step}.pth.tar")
        ckpt.export_text2vec(out, raw, cfg, epoch=int(raw.get("epoch", 0) or 0))
        print(f"wrote {out}")
    else:
        cfg = load_config(Vec2WavConfig, a.config) if a.config else Vec2WavConfig()
        out_dir = a.out or parent
        ckpt.export_vec2wav(out_dir, step, raw, cfg)
        print(f"wrote {out_dir}/g_{step:08d} and {out_dir}/do_{step:08d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
