"""Training-step benchmark of the port (JAX package: infer/train_bench.py):
the Text2Vec step (MAS and the beta-binomial prior path) and the Vec2Wav
GAN step, on the card.

    python -m wavthruvec_pytorch_tpu_torch.infer.train_bench \\
        [--stage t2v|v2w|both|v2w-sweep|t2v-sweep|t2v-flash] [--B 16] [--T 1024] \\
        [--flash] [--remat] [--dtype float32|bfloat16] [--dropout0] \\
        [--t2v_config FILE] [--v2w_config FILE] [--device cpu]

Each row is printed as one JSON line with the JAX bench's keys, plus
``device`` (``torch.cuda.get_device_name(0)``, or ``"cpu"``),
``peak_mem_gib`` (``torch.cuda.max_memory_allocated`` over the timed steps;
null on the CPU) and, for a Text2Vec row, ``first_total_loss``, the first
step's loss, ``last_total_loss``, the last step's, taken after
``WARMUP + iters - 1`` updates, and ``last_grad_norm``, the global norm of
the last step's gradients as LAMB took them: remat recomputes the FFT
blocks in the backward, so the last two are where it could show.  Timing: a host clock
around each step, which ends in ``torch.cuda.synchronize()``; the median of
the steps after ``WARMUP`` untimed ones.  The weights are seeded random; the
batch is the JAX bench's, drawn from ``default_rng(0)``.

``--prng`` takes only its default: it names the JAX PRNG of the dropout
keys (``Text2VecConfig.dropout_prng_impl``), and the port draws dropout from
PyTorch's generator.  The default configs are ``Text2VecConfig()`` and
``Vec2WavConfig()``, as the JAX bench's; ``run()`` takes others.  Without a
card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.device import resolve_device

PRNG_DEFAULT = "threefry2x32"
WARMUP = 2
ITERS = 10


def check_prng(prng: str) -> None:
    if prng != PRNG_DEFAULT:
        raise ValueError(f"--prng {prng} selects a JAX PRNG for the dropout keys "
                         "(Text2VecConfig.dropout_prng_impl); the port draws dropout from "
                         f"PyTorch's generator, so only the default {PRNG_DEFAULT!r} is taken")


def _device_fields(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"device": "cpu", "peak_mem_gib": None}
    return {"device": torch.cuda.get_device_name(device),
            "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30}


def _time_steps(step, device: torch.device, iters: int) -> float:
    """The median seconds of ``step()`` after ``WARMUP`` untimed calls,
    each ended by a synchronize; the card's peak memory is reset after the
    first call."""
    ts = []
    for i in range(WARMUP + iters):
        t0 = time.perf_counter()
        step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ts.append(time.perf_counter() - t0)
        if i == 0 and device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
    return float(np.median(ts[WARMUP:]))


def bench_t2v(B: int = 16, N: int = 64, T: int = 1024, dtype: str = "float32",
              remat: bool = False, flash: bool = False, dropout: Optional[float] = None,
              prng: str = PRNG_DEFAULT, cfg: Optional[Text2VecConfig] = None, device=None,
              iters: int = ITERS) -> Dict:
    """One Text2Vec training step at B items of N text ids and T frames."""
    from wavthruvec_pytorch_tpu_torch.train.text2vec_train import (
        Text2VecTrainer,
        make_padded_batch,
    )

    check_prng(prng)
    device = resolve_device(device)
    cfg = dataclasses.replace(cfg or Text2VecConfig(), compute_dtype=dtype, remat=remat,
                              flash_attention=flash)
    if dropout is not None:
        cfg = dataclasses.replace(cfg, dropout=dropout)
    rng = np.random.default_rng(0)
    items = []
    for _ in range(B):
        n = int(rng.integers(N // 2, N + 1))
        t = int(rng.integers(T // 2, T + 1))
        items.append({
            "text_enc": rng.integers(1, cfg.vocab_size, n),
            "feat_gt_target": rng.standard_normal((t, cfg.n_feat_dim)).astype(np.float32),
            "attn_prior": (rng.random((t, n)) + 0.05).astype(np.float32)})
    torch.manual_seed(0)
    trainer = Text2VecTrainer(cfg, device=device)
    batch = trainer.to_device(make_padded_batch(items, cfg, text_pad=N, frame_pad=T))
    losses = []

    def step():
        total, metrics, _ = trainer.forward(batch)
        trainer.backward(total)
        trainer.apply_gradients()
        losses.append(metrics["total_loss"])

    dt = _time_steps(step, device, iters)
    grad_norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in trainer.params if p.grad is not None]))
    return {"stage": "text2vec_train_step", "batch": B, "text_pad": N, "frame_pad": T,
            "dtype": dtype, "remat": remat, "flash": flash, "dropout": cfg.dropout,
            "prng": prng, "sec_per_step": dt, "steps_per_sec": 1.0 / dt,
            **_device_fields(device), "first_total_loss": losses[0].item(),
            "last_total_loss": losses[-1].item(), "last_grad_norm": grad_norm.item()}


def bench_v2w(B: int = 2, T: int = 256, dtype: str = "float32",
              cfg: Optional[Vec2WavConfig] = None, device=None, iters: int = ITERS) -> Dict:
    """One Vec2Wav GAN step at B whole utterances of T latent frames."""
    from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer, log_mel

    device = resolve_device(device)
    cfg = dataclasses.replace(cfg or Vec2WavConfig(), compute_dtype=dtype)
    rng = np.random.default_rng(0)
    L = T * cfg.total_upsample
    audio = torch.from_numpy((rng.standard_normal((B, L, 1)) * 0.1).astype(np.float32))
    batch = {"wv_feat": torch.from_numpy(
                 rng.standard_normal((B, T, cfg.n_feat_dim)).astype(np.float32)),
             "spk_emb": torch.from_numpy(rng.standard_normal((B, cfg.spk_dim)).astype(np.float32)),
             "audio": audio, "mel_loss": log_mel(cfg, audio)}
    torch.manual_seed(0)
    trainer = GANTrainer(cfg, device=device, seed=0)
    batch = trainer.to_device(batch)
    dt = _time_steps(lambda: trainer.step(batch), device, iters)
    return {"stage": "vec2wav_gan_train_step", "batch": B, "frames": T, "dtype": dtype,
            "sec_per_step": dt, "audio_sec_per_sec": B * L / cfg.sampling_rate / dt,
            **_device_fields(device)}


def _emit(row: Dict) -> Dict:
    print(json.dumps(row), flush=True)
    return row


def sweep_t2v(cfg=None, device=None) -> List[Dict]:
    """The Text2Vec step's levers: bf16 compute, remat, batch size."""
    return [_emit(bench_t2v(B=B, T=T, dtype=dt, remat=rm, cfg=cfg, device=device))
            for B, T, dt, rm in [(16, 1024, "float32", False), (16, 1024, "bfloat16", False),
                                 (32, 1024, "float32", False), (32, 1024, "bfloat16", False),
                                 (16, 2048, "bfloat16", True)]]


def sweep_v2w(cfg=None, device=None) -> List[Dict]:
    """The GAN step's levers: whole utterances against windows of
    ``8192 // 320`` frames, batch size, bf16."""
    seg = 8192 // 320
    return [_emit(bench_v2w(B, T, dt, cfg=cfg, device=device))
            for B, T, dt in [(2, 256, "float32"), (8, 256, "float32"), (8, seg, "float32"),
                             (16, seg, "float32"), (32, seg, "float32"), (64, seg, "float32"),
                             (16, seg, "bfloat16"), (64, seg, "bfloat16"),
                             (8, 256, "bfloat16")]]


def sweep_t2v_flash(cfg=None, device=None) -> List[Dict]:
    """The 3072-frame step, dense against flash, with and without remat;
    dropout 0 on every row (the flash kernels apply none).  Running out of
    the card's memory is a row, not a failure; each row's peak is its own
    (the peak is reset before its timed steps)."""
    out = []
    for B, T, dt, rm, fl in [(16, 3072, "bfloat16", False, False),
                             (16, 3072, "bfloat16", False, True),
                             (16, 3072, "bfloat16", True, True)]:
        try:
            row = bench_t2v(B=B, T=T, dtype=dt, remat=rm, flash=fl, dropout=0.0, cfg=cfg,
                            device=device)
        except torch.cuda.OutOfMemoryError as e:
            row = {"stage": "text2vec_train_step", "batch": B, "frame_pad": T, "dtype": dt,
                   "remat": rm, "flash": fl, "error": f"{type(e).__name__}: {str(e)[:200]}"}
        out.append(_emit(row))
    return out


def run(stage: str = "both", B: Optional[int] = None, T: Optional[int] = None,
        flash: bool = False, remat: bool = False, dtype: Optional[str] = None,
        dropout0: bool = False, prng: str = PRNG_DEFAULT,
        t2v_cfg: Optional[Text2VecConfig] = None, v2w_cfg: Optional[Vec2WavConfig] = None,
        device=None, iters: int = ITERS) -> List[Dict]:
    """The rows of the command line's ``--stage`` and flags, each printed;
    ``iters`` timed steps a row of ``t2v``, ``v2w`` or ``both`` (the sweeps
    take ``ITERS``)."""
    check_prng(prng)
    if stage == "t2v" and (B or T or flash or dtype or remat or dropout0):
        return [_emit(bench_t2v(B=B or 16, T=T or 1024, dtype=dtype or "float32", remat=remat,
                                flash=flash, dropout=0.0 if (flash or dropout0) else None,
                                prng=prng, cfg=t2v_cfg, device=device, iters=iters))]
    rows = []
    if stage in ("t2v", "both"):
        rows.append(_emit(bench_t2v(cfg=t2v_cfg, device=device, iters=iters)))
    if stage in ("v2w", "both"):
        rows.append(_emit(bench_v2w(cfg=v2w_cfg, device=device, iters=iters)))
    if stage == "v2w-sweep":
        rows += sweep_v2w(v2w_cfg, device)
    if stage == "t2v-sweep":
        rows += sweep_t2v(t2v_cfg, device)
    if stage == "t2v-flash":
        rows += sweep_t2v_flash(t2v_cfg, device)
    return rows


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--stage", default="both",
                   choices=["t2v", "v2w", "both", "v2w-sweep", "t2v-sweep", "t2v-flash"])
    p.add_argument("--B", type=int, default=None)
    p.add_argument("--T", type=int, default=None)
    p.add_argument("--flash", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--dtype", default=None)
    p.add_argument("--dropout0", action="store_true",
                   help="zero attention/ffn dropout (flash rows force this)")
    p.add_argument("--prng", default=PRNG_DEFAULT,
                   help="the JAX dropout PRNG; the port takes only the default")
    p.add_argument("--t2v_config", default="", help="a Text2VecConfig JSON file")
    p.add_argument("--v2w_config", default="", help="a Vec2WavConfig JSON file")
    p.add_argument("--device", default=None, help="default: the card")
    a = p.parse_args(argv)
    return run(a.stage, a.B, a.T, a.flash, a.remat, a.dtype, a.dropout0, a.prng,
               load_config(Text2VecConfig, a.t2v_config) if a.t2v_config else None,
               load_config(Vec2WavConfig, a.v2w_config) if a.v2w_config else None, a.device)


if __name__ == "__main__":
    main()
