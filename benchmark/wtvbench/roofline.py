"""Peaks of one NVIDIA H100 SXM (its data sheet, dense rates at the 700 W
limit) and the least time each hand-written kernel of the program could
take: the larger of its bytes over the memory bandwidth and its operations
over the peak of the arithmetic it performs.  Bytes count each input read
once and each output written once.  The formulas are those of the
program's on-chip checks (``chip_smoke.py``: ``bound_ms``, ``flash_bound``,
the fused unit's and the BiGRU's counts), copied here so that a change to
the program cannot move the yardstick.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

PEAK_F32 = 67e12            # f32 on the CUDA cores
PEAK_BF16 = 989e12          # bf16 on the tensor cores
PEAK_TF32 = 495e12
PEAK_F32_TC = PEAK_TF32 / 3  # f32-accurate products on the tensor cores (3xTF32)
PEAK_BYTES = 3.35e12        # HBM3


def bound_s(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    """Least seconds for the work."""
    return max(n_bytes / PEAK_BYTES, n_ops / peak_ops)


def flash_bound_s(B: int, H: int, T: int, D: int, elem_bytes: int, n_products: int, n_in: int,
                  n_out: int, n_rows: int, peak_ops: float) -> float:
    """One flash call over [B, H, T, D]: ``n_products`` products of 2 B H T^2
    D operations; ``n_in`` and ``n_out`` [B, T, H, D] tensors, ``n_rows`` f32
    [B, H, T] rows and the int32 segment ids moved."""
    n_bytes = elem_bytes * (n_in + n_out) * B * T * H * D + 4.0 * n_rows * B * H * T + 4.0 * B * T
    return bound_s(n_bytes, 2.0 * n_products * B * H * T * T * D, peak_ops)


# (products, inputs, outputs, f32 rows) of the forward, dK/dV and dQ kernels
FLASH_CALLS = {"fwd": (2, 3, 1, 1), "dkv": (4, 4, 2, 2), "dq": (3, 4, 1, 2)}


def flash_step_bound_s(B: int, H: int, D: int, lengths: Iterable[Tuple[int, int]], bf16: bool
                       ) -> float:
    """Forward and backward flash calls of one training step: ``lengths``
    lists (padded length, layers) of each FFT stack."""
    elem, peak = (2, PEAK_BF16) if bf16 else (4, PEAK_F32_TC)
    total = 0.0
    for T, layers in lengths:
        for call in FLASH_CALLS.values():
            total += layers * flash_bound_s(B, H, T, D, elem, *call, peak)
    return total


def fused_units(frames: int, channels0: int, rates, kernels, dilations) -> List[Tuple[int, int, int]]:
    """(C, T, k) of every ResBlock2 unit of one Generator forward over
    ``frames`` latent frames."""
    units, T = [], frames
    for i, u in enumerate(rates):
        T *= u
        C = channels0 // 2 ** (i + 1)
        for k, dil in zip(kernels, dilations):
            units.extend((C, T, k) for _ in dil[:2])
    return units


def fused_unit_counts(B: int, C: int, T: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) of one fused unit call over [B, T, C]."""
    return 2.0 * k * C * C * T * B, 4.0 * (2 * B * T * C + k * C * C + C)


def fused_forward_bound_s(B: int, frames: int, channels0: int, rates, kernels, dilations) -> float:
    """The units of one Generator forward, each at 3xTF32 on the tensor cores."""
    total = 0.0
    for C, T, k in fused_units(frames, channels0, rates, kernels, dilations):
        n_ops, n_bytes = fused_unit_counts(B, C, T, k)
        total += bound_s(n_bytes, n_ops, PEAK_F32_TC)
    return total


def gru_counts(B: int, T: int, H: int, D: int = 2) -> Tuple[float, float, float]:
    """(operations, forward bytes, backward-loop bytes) of the f32 BiGRU
    recurrence at [D, B, T] with hidden size H: the hidden products, 2 D B T
    H 3H operations either way; the forward reads gi, w_hh and b_hh and
    writes h; the backward loop's bytes are the program's own count (dy
    twice, four tensors of gi's size, w_hh)."""
    n_ops = 2.0 * D * B * T * 3 * H * H
    gi = D * B * T * 3 * H
    fwd_bytes = 4.0 * (gi + D * H * 3 * H + D * 3 * H + D * B * T * H)
    bwd_bytes = 4.0 * (2 * D * B * T * H + 2 * gi + D * H * 3 * H + 2 * gi)
    return n_ops, fwd_bytes, bwd_bytes


def gru_step_bound_s(B: int, T: int, H: int) -> float:
    """The forward and backward-loop kernels of one training step."""
    n_ops, fb, bb = gru_counts(B, T, H)
    return bound_s(fb, n_ops, PEAK_F32) + bound_s(bb, n_ops, PEAK_F32)
