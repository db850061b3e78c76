"""One HiFi-GAN ResBlock2 unit, ``conv_{k,d}(leaky_relu(x)) + b + x``, as a
hand-written CUDA kernel (``csrc/fused_resblock.cu``) with its plain PyTorch
version beside it.

JAX counterpart: ``wavthruvec_pytorch_tpu/ops/fused_resblock.py``
(``fused_conv_residual`` and its oracle ``conv_residual_reference``).  The
port's f32 serving Generator (``fused=True``) runs every ResBlock2 unit
through ``fused_conv_residual``: on a CUDA tensor it launches the kernel, on
a CPU tensor it runs ``conv_residual_plain``.  The training Generator
(``fused=False``) does not call it, nor does the bf16 serving Generator,
whose units take ``conv_residual_plain`` in bf16 on every device
(``models.vec2wav.fused_supported``), as the JAX package's bf16 units take
XLA's convolution.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from wavthruvec_pytorch_tpu_torch.ops import kernel_build


def conv_residual_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        dilation: int = 1, neg_slope: float = 0.1) -> torch.Tensor:
    """x [B, T, C], w [k, C_in, C_out], b [C_out] -> lrelu -> dilated conv
    with "same" zero padding (k*d - d)//2 -> + b + x.

    The convolution runs in ``w``'s dtype.  With bf16 ``w`` and ``b`` and an
    f32 ``x`` (the bf16 serving Generator's units) it is the JAX package's
    XLA branch of a bf16 unit: lrelu(x) rounded to bf16, the product in
    bf16, ``b`` added in bf16 after it, the residual in f32."""
    k = w.shape[0]
    pad = (k * dilation - dilation) // 2
    xt = F.leaky_relu(x, neg_slope).transpose(1, 2)
    wt = w.permute(2, 1, 0)
    if w.dtype == x.dtype:
        y = F.conv1d(xt, wt, b, padding=pad, dilation=dilation)
    else:
        y = F.conv1d(xt.to(w.dtype), wt, padding=pad, dilation=dilation) + b.to(w.dtype)[:, None]
    return y.transpose(1, 2) + x


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("fused_resblock")
    fn = lib.fused_resblock_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_conv_residual(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        dilation: int = 1, neg_slope: float = 0.1) -> torch.Tensor:
    """x [B, T, C] f32, w [k, C, C] f32 (the weight-normed kernel), b [C] f32
    -> [B, T, C].  CPU tensors take ``conv_residual_plain``; CUDA tensors
    launch the kernel; anything else raises.  The kernel has no backward, so
    a call that autograd would record raises on every device."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        raise RuntimeError(
            "fused_conv_residual has no backward and refuses inputs that require a gradient; "
            "train with Generator(fused=False), whose ResBlock2 units autograd sees.")
    if x.device.type == "cpu":
        return conv_residual_plain(x, w, b, dilation, neg_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_residual: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    B, T, C = x.shape
    k = w.shape[0]
    if tuple(w.shape) != (k, C, C) or k % 2 != 1:
        raise ValueError(f"w must be [k, {C}, {C}] with odd k, got {tuple(w.shape)}")
    if tuple(b.shape) != (C,):
        raise ValueError(f"b must be [{C}], got {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}, "
                             f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    lib = _lib()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_resblock_forward(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, T, C, k, dilation, neg_slope, stream)
    kernel_build.check(lib, err, "fused_resblock_forward")
    fused_conv_residual.launches += 1
    return out


fused_conv_residual.launches = 0
