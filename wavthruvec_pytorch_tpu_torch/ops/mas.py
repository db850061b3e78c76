"""Width-1 monotonic alignment search (MAS) as a hand-written CUDA kernel
(``csrc/mas.cu``) with its plain PyTorch version beside it.

JAX counterparts: ``wavthruvec_pytorch_tpu/ops/mas.py``
(``mas_width1_batched``, the ``lax.scan`` version the JAX model calls) and
``ops/mas_pallas.py`` (``mas_width1_pallas``), which compute the same
function; ``mas_width1_numpy`` there is the reference's numba kernel.
Log-domain Viterbi over frames with large-finite -1e30 in place of -inf:
row 0 pinned to text index 0, text columns at or past ``in_len`` masked, a
tie going to the left neighbour, the backtrack from ``(out_len-1,
in_len-1)`` with rows at or past ``out_len`` left at 0, and a trailing
``opt[0, 0] = 1`` for every item with frames.

The port's training forward runs ``mas_width1``: on a CUDA tensor it
launches the kernel, on a CPU tensor it runs ``mas_width1_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from wavthruvec_pytorch_tpu_torch.ops import kernel_build

_NEG = -1e30
_MAX_THREADS = 1024     # one thread per text column
_STATIC_SHARED = 256    # the kernel's own shared words beside the dynamic bits


def mas_width1_plain(attn: torch.Tensor, in_lens: torch.Tensor,
                     out_lens: torch.Tensor) -> torch.Tensor:
    """attn [B, T, N] soft alignment (frames x text), in_lens/out_lens [B]
    -> [B, T, N] float32 hard 0/1 alignment.  A loop over the T frames of
    [B, N] row updates, then the backtrack, in tensor ops."""
    B, T, N = attn.shape
    dev = attn.device
    in_lens = in_lens.to(device=dev, dtype=torch.int64)
    out_lens = out_lens.to(device=dev, dtype=torch.int64)
    col = torch.arange(N, device=dev)
    log_a = torch.log(attn.to(torch.float32).clamp(min=0.0)).clamp(min=_NEG)
    log_a = torch.where(col < in_lens[:, None, None], log_a, log_a.new_full((), _NEG))
    log_a[:, 0, 1:] = _NEG  # pin the path start to text index 0

    neg_col = log_a.new_full((B, 1), _NEG)
    take_left = torch.zeros(B, T, N, dtype=torch.bool, device=dev)
    log_p = log_a[:, 0]
    for i in range(1, T):
        shifted = torch.cat([neg_col, log_p[:, :-1]], dim=1)
        take_left[:, i] = shifted >= log_p
        log_p = log_a[:, i] + torch.maximum(shifted, log_p)

    opt = torch.zeros(B, T, N, dtype=torch.float32, device=dev)
    curr = in_lens - 1
    for i in range(T - 1, -1, -1):
        active = i < out_lens
        opt[:, i] = ((col == curr[:, None]) & active[:, None]).to(torch.float32)
        came_left = take_left[:, i].gather(1, curr.clamp(min=0)[:, None])[:, 0] & (curr >= 0)
        curr = curr - (active & came_left & (i > 0)).to(torch.int64)
    opt[:, 0, 0] = torch.where(out_lens > 0, 1.0, opt[:, 0, 0])
    return opt


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("mas")
    lib.mas_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.mas_forward.restype = ctypes.c_int
    lib.mas_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mas_shared_bytes.restype = ctypes.c_size_t
    lib.mas_max_shared_bytes.argtypes = [ctypes.c_int]
    lib.mas_max_shared_bytes.restype = ctypes.c_int
    return lib


def mas_width1(attn: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor) -> torch.Tensor:
    """attn [B, T, N] float32, in_lens/out_lens [B] integer -> [B, T, N]
    float32 hard alignment.  CPU tensors take ``mas_width1_plain``; CUDA
    tensors launch the kernel (one launch), with its take-left bits in shared
    memory where they fit the card's opt-in shared memory per block and in a
    global scratch where they do not; anything else raises.  Lengths are
    read as ``0 <= in_len <= N`` and ``0 <= out_len <= T``."""
    if attn.device.type == "cpu":
        return mas_width1_plain(attn, in_lens, out_lens)
    if attn.device.type != "cuda":
        raise ValueError(f"mas_width1: unsupported device {attn.device}")
    if attn.dim() != 3:
        raise ValueError(f"attn must be [B, T, N], got {tuple(attn.shape)}")
    B, T, N = attn.shape
    if not 1 <= N <= _MAX_THREADS:
        raise ValueError(f"mas_width1 takes 1 <= N <= {_MAX_THREADS} text positions, got {N}")
    if attn.dtype != torch.float32 or not attn.is_contiguous():
        raise ValueError(f"attn must be a contiguous float32 tensor, got {attn.dtype} "
                         f"(contiguous={attn.is_contiguous()})")
    for name, t in (("in_lens", in_lens), ("out_lens", out_lens)):
        if tuple(t.shape) != (B,) or t.dtype.is_floating_point or t.device != attn.device:
            raise ValueError(f"{name} must be an integer [{B}] tensor on {attn.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _lib()
    bits_bytes = lib.mas_shared_bytes(T, N)
    bits = None
    if bits_bytes + _STATIC_SHARED > lib.mas_max_shared_bytes(attn.device.index):
        bits = torch.empty(B * bits_bytes // 4, dtype=torch.int32, device=attn.device)
    in32 = in_lens.to(torch.int32).contiguous()
    out32 = out_lens.to(torch.int32).contiguous()
    opt = torch.empty_like(attn)
    stream = torch.cuda.current_stream(attn.device).cuda_stream
    err = lib.mas_forward(attn.data_ptr(), in32.data_ptr(), out32.data_ptr(), opt.data_ptr(),
                          B, T, N, None if bits is None else bits.data_ptr(), stream)
    kernel_build.check(lib, err, "mas_forward")
    mas_width1.launches += 1
    return opt


mas_width1.launches = 0
