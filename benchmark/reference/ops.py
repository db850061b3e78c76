"""Plain PyTorch building blocks of the benchmark's reference.

Everything here is written from the published model description (FastSpeech
FFT blocks, RAD-TTS alignment, ECAPA-TDNN, CBHG, HiFi-GAN) in f32 and in
torch's own layout; it imports nothing of the program under test.

``Ops`` carries the precision of the products (matmuls, convolutions):

* ``"f32"``: f32 operands; the caller turns TF32 off (``precision_flags``);
* ``"tf32"``: the same calls with TF32 on, the control of an f32 cell;
* ``"fp8"``: the control of a bf16 cell, its activations one format
  down: every operand and every result of a product rounded to float8
  e4m3 in the forward (as a bf16 program rounds them to bf16), and every
  gradient that reaches one rounded to float8 e5m2 in the backward, each
  with one scale a tensor (its absolute maximum maps to the format's
  largest value).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


@contextlib.contextmanager
def precision_flags(mode: str):
    """TF32 on for ``"tf32"``, off otherwise, restored afterwards."""
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _scaled_round(t: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


class _FP8(torch.autograd.Function):
    """e4m3 in the forward, e5m2 on the way back."""

    @staticmethod
    def forward(ctx, t):
        return _scaled_round(t, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale; its gradient
    rounded to float8 e5m2 the same way."""
    return _FP8.apply(t)


class Ops:
    """The products of the reference in one precision mode.  ``remat``
    recomputes the largest blocks in the backward to save memory (the same
    numbers); the operation count turns it off."""

    def __init__(self, mode: str = "f32", remat: bool = True):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.remat = remat

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.mode == "fp8" else t

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def matmul(self, a, b):
        return self.q(torch.matmul(self.q(a), self.q(b)))

    def einsum(self, eq, a, b):
        return self.q(torch.einsum(eq, self.q(a), self.q(b)))

    def conv1d(self, x, w, b=None, **kw):
        return self.q(F.conv1d(self.q(x), self.q(w), b, **kw))

    def conv2d(self, x, w, b=None, **kw):
        return self.q(F.conv2d(self.q(x), self.q(w), b, **kw))

    def conv_transpose1d(self, x, w, b=None, **kw):
        return self.q(F.conv_transpose1d(self.q(x), self.q(w), b, **kw))


def conv_btc(ops: Ops, x, w, b=None, padding=0, dilation=1):
    """A 1-D convolution over [B, T, C] (weight [out, in, k])."""
    return ops.conv1d(x.transpose(1, 2), w, b, padding=padding, dilation=dilation).transpose(1, 2)


def layer_norm(x, w, b, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def batch_norm(x, P, pre: str, train: bool, affine: bool = True, eps: float = 1e-5,
               record: Optional[dict] = None):
    """BatchNorm over the last dim of [..., C]: the batch's mean and biased
    variance in train mode (kept in ``record`` under ``pre`` if given), the
    running statistics in eval mode."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        if record is not None:
            record[pre] = (mean.detach(), var.detach())
    else:
        mean, var = P[pre + "running_mean"], P[pre + "running_var"]
    y = (x - mean) * torch.rsqrt(var + eps)
    if affine:
        y = y * P[pre + "weight"] + P[pre + "bias"]
    return y


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||, the norm over every dim but the first."""
    dims = list(range(1, v.dim()))
    return g * v / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-32)


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """FastSpeech's position table: sin on even, cos on odd dims, row 0 zero."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    i = np.arange(d_hid, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, 2.0 * np.floor(i / 2.0) / d_hid)
    table = np.where(np.arange(d_hid)[None, :] % 2 == 0, np.sin(ang), np.cos(ang))
    table[0] = 0.0
    return table.astype(np.float32)


def l2n(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


def spectral_weight(P, pre: str, train: bool, state: dict) -> torch.Tensor:
    """``weight_orig / sigma`` by one power iteration in train mode (the new
    vectors go to ``state``), by the stored vectors in eval mode."""
    w = P[pre + "weight_orig"]
    wm = w.reshape(w.shape[0], -1)
    u, v = state.get(pre + "weight_u", P[pre + "weight_u"]), state.get(pre + "weight_v", P[pre + "weight_v"])
    if train:
        with torch.no_grad():
            v = l2n(torch.mv(wm.t(), u))
            u = l2n(torch.mv(wm, v))
        state[pre + "weight_u"], state[pre + "weight_v"] = u, v
    sigma = torch.dot(u, torch.mv(wm, v))
    return w / sigma

