"""Text2Vec evaluation (JAX package: infer/eval.py; reference:
text2vec/eval.py:19-138).

Loads a checkpoint, synthesizes the reference's six AISHELL-3 test sentences
(each with a speaker reference clip of wav2vec features) and saves
``{results_dir}/{log_seed}/{step}_{i}_feat(.postnet).npy``; ``--rtf`` times
the reference's commented-out loop (eval.py:131-138).

    python -m wavthruvec_pytorch_tpu_torch.cli eval-text2vec --config data/demo/text2vec.json \\
        --checkpoint_path run/30_30_spk_4fft/model_new --step 6 [--rtf] [--device cpu]

The checkpoint is the JAX package's orbax variables directory
``checkpoint_{step}`` or the torch reference's ``checkpoint_{step}.pth.tar``
(key ``model``), the directory first, as in JAX.  Without one the model takes seeded random weights, with a
warning, as the JAX package does.  Runs on the card unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.checkpoint import load_torch_state_dict
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, load_config
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.text import TextFrontend, pad_to_bucket

# the reference's test set (eval.py:104-118)
TEST_SENTENCES: List[str] = [
    "广州女大学生登山失联四天警方找到疑似女尸",
    "尊敬的观众朋友们大家好",
    "教育部要求处理艺人高考成绩造假问题",
    "在这一年半的时间里",
    "他们俩一起去过很多地方",
    "国内动力电池巨头宁德时代",
]

LATENT_HZ = 50.0  # wav2vec 2.0 latent frames a second


def load_model(cfg: Text2VecConfig, checkpoint_path: str, step: int, device=None) -> Text2Vec:
    """``Text2Vec`` with the weights of ``{checkpoint_path}/checkpoint_{step}``,
    taken in the JAX package's order (infer/eval.py:55-62): the orbax
    variables directory of that name where it exists (a training state
    there raises, as it does in JAX), else ``checkpoint_{step}.pth.tar``,
    else seeded random weights (``torch.manual_seed(0)``) and a warning."""
    device = resolve_device(device)
    path = os.path.join(checkpoint_path, f"checkpoint_{step}")
    if os.path.exists(path) or os.path.exists(path + ".pth.tar"):
        src = path if os.path.exists(path) else path + ".pth.tar"
        model = Text2Vec(cfg, device=device)
        model.load_state_dict(load_torch_state_dict(src, key="model", cfg=cfg), strict=True)
        print(f"restored checkpoint_{step}" if src == path
              else f"loaded checkpoint_{step}.pth.tar")
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = Text2Vec(cfg, device="cpu")
        model = model.to(device)
        print(f"WARNING: no checkpoint at {path}; using random init")
    return model.eval()


def synthesize_one(model: Text2Vec, cfg: Text2VecConfig, frontend: TextFrontend, text: str,
                   ref_feat: np.ndarray, alpha: float = 1.0):
    """One sentence, its text padded to a text bucket and its output to the
    frame bucket of ``2 * len(ref) + 64`` frames -> (feat, feat_postnet), each
    [total_frames, n_feat] on the host."""
    dev = next(model.parameters()).device
    seq = frontend.text_to_sequence(text)
    n_pad = pad_to_bucket(len(seq), cfg.text_buckets)
    ids = np.zeros((1, n_pad), np.int64)
    ids[0, : len(seq)] = seq
    pos = np.where(ids != 0, np.arange(1, n_pad + 1)[None], 0)
    max_frames = pad_to_bucket(min(int(ref_feat.shape[0] * 2 + 64), cfg.max_seq_len),
                               cfg.frame_buckets)
    out = model.infer(torch.as_tensor(ids, device=dev), torch.as_tensor(pos, device=dev),
                      torch.as_tensor(ref_feat[None], dtype=torch.float32, device=dev),
                      max_frames, alpha)
    total = int(out["total_frames"][0])
    return (out["feat_output"][0, :total].cpu().numpy(),
            out["feat_postnet_output"][0, :total].cpu().numpy())


def _config(args) -> Text2VecConfig:
    if args.config:
        return load_config(Text2VecConfig, args.config)
    vocab = args.vocab_path or Text2VecConfig().vocab_path
    if not os.path.exists(vocab) and os.path.exists("./data/demo/vocab.txt"):
        vocab = "./data/demo/vocab.txt"  # the bundled demo vocabulary, as the JAX package
        print(f"vocab fallback: {vocab}")
    return Text2VecConfig(vocab_path=vocab,
                          vocab_size=TextFrontend.from_vocab_file(vocab).vocab_size)


def main(args: Optional[argparse.Namespace] = None) -> int:
    if args is None:
        args = parse_args()
    cfg = _config(args)
    frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
    model = load_model(cfg, args.checkpoint_path, args.step, device=args.device)

    out_dir = os.path.join(args.results_dir, str(args.log_seed))
    os.makedirs(out_dir, exist_ok=True)
    for i, sentence in enumerate(TEST_SENTENCES[: args.n_sentences]):
        ref_path = args.ref_npys[i] if i < len(args.ref_npys) else None
        if ref_path and os.path.exists(ref_path):
            ref = np.load(ref_path).squeeze()
        else:
            ref = np.random.default_rng(i).standard_normal((128, cfg.n_feat_dim)) * 0.1
        feat, feat_postnet = synthesize_one(model, cfg, frontend, sentence, ref, args.alpha)
        np.save(os.path.join(out_dir, f"{args.step}_{i}_feat.npy"), feat)
        np.save(os.path.join(out_dir, f"{args.step}_{i}_feat.postnet.npy"), feat_postnet)
        print(f"[{i}] {sentence} -> {feat.shape[0]} frames")

    if args.rtf:
        ref = np.random.default_rng(0).standard_normal((128, cfg.n_feat_dim)) * 0.1
        synthesize_one(model, cfg, frontend, TEST_SENTENCES[0], ref)  # warm-up
        t0 = time.perf_counter()
        frames = 0
        for k in range(args.rtf_iters):
            f, _ = synthesize_one(model, cfg, frontend, TEST_SENTENCES[k % len(TEST_SENTENCES)],
                                  ref)
            frames += f.shape[0]
        dt = time.perf_counter() - t0
        audio_s = frames / LATENT_HZ
        print(f"t2v RTF: {dt / audio_s:.4f} ({audio_s / dt:.1f}x realtime), "
              f"{args.rtf_iters / dt:.2f} utt/s")
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--step", type=int, default=0)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--log_seed", type=str, default="1")
    parser.add_argument("--checkpoint_path", type=str, default="./run/30_30_spk_4fft/model_new")
    parser.add_argument("--feat_ground_truth", type=str, default="/data_mnt/aishell3/w2v_feat/")
    parser.add_argument("--ref_npys", nargs="*", default=[])
    parser.add_argument("--n_sentences", type=int, default=6)
    parser.add_argument("--vocab_path", type=str, default="")
    parser.add_argument("--config", type=str, default="",
                        help="Text2VecConfig JSON (default: the default config with "
                        "--vocab_path's vocabulary)")
    parser.add_argument("--results_dir", type=str, default="results")
    parser.add_argument("--rtf", action="store_true")
    parser.add_argument("--rtf_iters", type=int, default=20)
    parser.add_argument("--device", default=None, help="default: the card (cuda)")
    return parser.parse_args(argv)
