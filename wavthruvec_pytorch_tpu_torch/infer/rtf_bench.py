"""Realtime-factor benchmark of the port's synthesis (JAX package:
infer/rtf_bench.py; the reference's timing loop is commented out at
text2vec/eval.py:131-138): ``Text2Vec.infer`` then the serving
``Generator`` on a batch of B texts at ``n_frames`` latent frames, timed
across batch sizes.

    python -m wavthruvec_pytorch_tpu_torch.infer.rtf_bench [--batch-sizes 1 4 8] \\
        [--frames 500] [--t2v_config FILE] [--v2w_config FILE] [--device cpu]

Each row, printed as a JSON line: ``batch``, ``x_realtime`` (seconds of
audio made a second), ``utt_per_sec``, ``ms_per_batch`` and ``device``.  A
batch's time is the median over ``iters`` runs after ``WARMUP``, each
between two CUDA events on the card's stream (``time.perf_counter`` on the
CPU), the host's work between them included.  The JAX bench chains its
dispatches and subtracts a null program's time: both belong to the TPU
runtime's fetch path and are not carried over.  The weights are seeded
random (``torch.manual_seed(0)``), the inputs drawn from
``default_rng(batch)``; the default configs are ``Text2VecConfig()`` and
``Vec2WavConfig()``, as the JAX bench's.  Without a card and without
``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.device import resolve_device

WARMUP = 3
N_TEXT, REF_T = 32, 128  # the JAX bench's text length and reference clip


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def median_ms(fn: Callable[[], object], device: torch.device, iters: int,
              warmup: int = WARMUP) -> float:
    """The median milliseconds of ``fn()`` over ``iters`` runs after
    ``warmup``: CUDA events around each run on the card, the host clock on
    the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def build_models(t2v_cfg: Text2VecConfig, v2w_cfg: Vec2WavConfig, device: torch.device,
                 gen_precision: str = "f32"):
    """Seeded Text2Vec (f32) and the serving Generator of ``gen_precision``,
    both in eval mode on ``device``."""
    from wavthruvec_pytorch_tpu_torch.infer.synthesize import make_serving_generator
    from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
    from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator

    torch.manual_seed(0)
    t2v = Text2Vec(t2v_cfg, device=device).eval()
    gen_state = Generator(v2w_cfg, device=device).state_dict()
    gen, state = make_serving_generator(v2w_cfg, gen_state, gen_precision, device=device)
    gen.load_state_dict(state, strict=True)
    return t2v, gen.eval()


def make_inputs(t2v_cfg: Text2VecConfig, v2w_cfg: Vec2WavConfig, B: int, device: torch.device,
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """B texts of ``N_TEXT - 2`` ids and two pads, their positions, a
    reference clip of ``REF_T`` frames, speaker embeddings and noise."""
    rng = np.random.default_rng(seed)
    src = np.zeros((B, N_TEXT), np.int64)
    src[:, :N_TEXT - 2] = rng.integers(4, t2v_cfg.vocab_size, (B, N_TEXT - 2))
    pos = np.where(src != 0, np.arange(1, N_TEXT + 1)[None], 0)
    arrays = {"src_seq": src, "src_pos": pos,
              "ref": rng.standard_normal((B, REF_T, t2v_cfg.n_feat_dim)) * 0.1,
              "spk": rng.standard_normal((B, v2w_cfg.spk_dim)),
              "noise": rng.standard_normal((B, v2w_cfg.noise_dim))}
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype == np.int64 else torch.float32
                               ).to(device) for k, v in arrays.items()}


def run(batch_sizes: Sequence[int] = (1, 4, 8), n_frames: int = 500, iters: int = 16,
        t2v_cfg: Optional[Text2VecConfig] = None, v2w_cfg: Optional[Vec2WavConfig] = None,
        device=None) -> List[Dict]:
    device = resolve_device(device)
    t2v_cfg, v2w_cfg = t2v_cfg or Text2VecConfig(), v2w_cfg or Vec2WavConfig()
    t2v, gen = build_models(t2v_cfg, v2w_cfg, device)
    audio_per_utt = n_frames * v2w_cfg.total_upsample / v2w_cfg.sampling_rate
    rows = []
    for B in batch_sizes:
        x = make_inputs(t2v_cfg, v2w_cfg, B, device, seed=B)

        @torch.inference_mode()
        def pipe():
            out = t2v.infer(x["src_seq"], x["src_pos"], x["ref"], n_frames, 1.0)
            return gen(out["feat_postnet_output"], x["spk"], x["noise"])

        ms = median_ms(pipe, device, iters)
        rows.append({"batch": B, "x_realtime": B * audio_per_utt / (ms / 1e3),
                     "utt_per_sec": B / (ms / 1e3), "ms_per_batch": ms,
                     "device": device_name(device)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 4, 8])
    p.add_argument("--frames", type=int, default=500)
    p.add_argument("--t2v_config", default="", help="a Text2VecConfig JSON file")
    p.add_argument("--v2w_config", default="", help="a Vec2WavConfig JSON file")
    p.add_argument("--device", default=None, help="default: the card")
    a = p.parse_args(argv)
    return run(tuple(a.batch_sizes), a.frames,
               t2v_cfg=load_config(Text2VecConfig, a.t2v_config) if a.t2v_config else None,
               v2w_cfg=load_config(Vec2WavConfig, a.v2w_config) if a.v2w_config else None,
               device=a.device)


if __name__ == "__main__":
    main()
