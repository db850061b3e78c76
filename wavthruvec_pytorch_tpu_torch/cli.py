"""Command line of the port (JAX package: cli.py), the training loops and
the serving front ends:

    python -m wavthruvec_pytorch_tpu_torch.cli train-text2vec --config ... [--max_steps N]
    python -m wavthruvec_pytorch_tpu_torch.cli train-vec2wav  --config ... [--max_steps N]
    python -m wavthruvec_pytorch_tpu_torch.cli synthesize --text "..." --ref_npy ... --spk_emb ...
    python -m wavthruvec_pytorch_tpu_torch.cli serve      --spk_emb_dir ...  (stdin loop)
    python -m wavthruvec_pytorch_tpu_torch.cli serve-http --spk_emb_dir ... [--port 8571]

The flags are the JAX package's (the training commands take their loop's,
``train/text2vec_loop.py`` and ``train/vec2wav_loop.py``), plus ``--device``
(default: the card; pass ``--device cpu`` to run the kernels' plain versions
on the CPU) and, for ``synthesize``, ``--t2v_config`` / ``--v2w_config`` as
the serving commands have them.  Checkpoints are the torch reference's files
(``checkpoint_{step}.pth.tar``, ``g_XXXXXXXX``), which the training loops
write; without one a model takes seeded random weights.  The JAX package's
other subcommands are not ported yet: each exits with status 2 and names its
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

# the JAX subcommands that are not ported, and where ROADMAP.md queues them
NOT_PORTED = {
    "eval-text2vec": "queue 1 item 11 (infer/eval.py)",
    "prepare-data": "queue 1 item 11 (data/ingest.py)",
    "pre-spk-emb": "queue 1 item 11 (data/spk_emb.py and ECAPA's wav path)",
    "make-demo-data": "queue 1 item 11 (data/demo.py)",
    "export-torch": "queue 1 item 11 (the port's own checkpoints are already the torch "
                    "reference's files; what remains is the orbax route, an orbax checkpoint "
                    "of the JAX package, which the JAX package's own export-torch converts)",
    "recalibrate-bn": "queue 1 item 11 (infer/recalibrate.py)",
}


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
    if cmd in NOT_PORTED:
        print(f"{cmd} is not ported to wavthruvec_pytorch_tpu_torch yet: ROADMAP.md, "
              f"{NOT_PORTED[cmd]}.", file=sys.stderr)
        return 2
    print(f"unknown command: {cmd}\n{__doc__}", file=sys.stderr)
    return 1


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--t2v_config", default="",
                   help="Text2VecConfig JSON (e.g. data/demo/text2vec_tiny.json)")
    p.add_argument("--v2w_config", default="",
                   help="Vec2WavConfig JSON (e.g. data/demo/vec2wav_tiny.json)")
    p.add_argument("--t2v_checkpoint", default=None,
                   help="the reference's checkpoint_{step}.pth.tar (key 'model')")
    p.add_argument("--gen_checkpoint", default=None,
                   help="the reference's g_XXXXXXXX (key 'generator')")
    p.add_argument("--vocab_path", default="./data/vocab.txt")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--max_frames", type=int, default=0,
                   help="output frame cap (default: the largest frame bucket)")
    p.add_argument("--gen_precision", choices=("f32", "bf16"), default="f32",
                   help="vocoder serving precision: bf16 folds weight norm and stores and "
                   "computes the convolutions in bf16 (audio stays f32)")
    p.add_argument("--gru_impl", choices=("scan", "pallas"), default=None,
                   help="CBHG BiGRU recurrence: the port computes 'pallas' (bf16 w_hh, "
                   "f32 carry) only")
    p.add_argument("--device", default=None, help="default: the card (cuda)")


def _configs(a):
    from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
    from wavthruvec_pytorch_tpu_torch.text import TextFrontend

    if a.gru_impl == "scan":
        raise NotImplementedError(
            "--gru_impl scan is not ported: the port has one set of BiGRU numerics, the JAX "
            "package's 'pallas' (bf16 w_hh, f32 carry; ROADMAP.md, watch list 'BiGRU numerics')")
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


if __name__ == "__main__":
    sys.exit(main())
