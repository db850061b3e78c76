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
launches the kernel (one launch a call), on a CPU tensor it runs
``mas_width1_plain``.  ``mas_plan`` picks the kernel's shape by N: an item
is a cluster of ``cluster`` blocks, each owning ``32 * k`` text columns.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from wavthruvec_pytorch_tpu_torch.ops import kernel_build

_NEG = -1e30
# the kernel's shape (csrc/mas.cu): a block owns 32 * k text columns, k <= 4
# a lane of its chain warp, and an item is a cluster of at most 8 blocks
MAX_N = 1024
MAX_CLUSTER = 8
MAX_K = 4
BLOCK_COLUMNS = 96      # the columns a block aims at: 8 blocks an item at N = 768
STAGES, STAGE_ROWS = 4, 32
BARRIER_BYTES = 128


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


class MASPlan(NamedTuple):
    cluster: int  # blocks an item (a thread-block cluster)
    k: int        # text columns a lane of a block's chain warp: a block owns 32 k
    smem: int     # dynamic shared memory a block, bytes


def shared_bytes(T: int, k: int) -> int:
    """Shared memory a block needs at T frames and k columns a lane, with
    Tp = T rounded up to 32: the mbarriers, the left block's edge words (Tp
    + 32), the take-left bits (a word per 32 rows and column: Tp k words)
    and the log_a ring (``STAGES`` stages of ``STAGE_ROWS`` rows of 32 k
    floats).  ``mas_shared_bytes`` in csrc/mas.cu computes the same."""
    tp = -(-T // 32) * 32
    return BARRIER_BYTES + 4 * (tp + 32 + tp * k + STAGES * STAGE_ROWS * 32 * k)


def mas_plan(T: int, N: int, smem_optin: int = 232448) -> MASPlan:
    """The kernel's shape for items of T frames and N text positions on a
    card whose blocks may opt into ``smem_optin`` bytes of shared memory (an
    H100's by default).  k is the least that splits N over ceil(N /
    ``BLOCK_COLUMNS``) blocks, at most 8, of 32 k columns; then ``cluster``
    = ceil(N / 32 k), so every block owns a column below N.  Raises where N
    or T is past what the kernel takes."""
    if not 1 <= N <= MAX_N:
        raise ValueError(f"mas_width1 takes 1 <= N <= {MAX_N} text positions, got {N}")
    k = -(-N // (32 * min(MAX_CLUSTER, -(-N // BLOCK_COLUMNS))))
    smem = shared_bytes(T, k)
    if smem > smem_optin:
        raise ValueError(f"mas_width1: T={T} frames at N={N} need {smem} bytes of shared memory "
                         f"a block, past the card's {smem_optin}")
    return MASPlan(-(-N // (32 * k)), k, smem)


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("mas")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mas_forward.argtypes = [ptr] * 4 + [i32] * 5 + [ctypes.c_size_t, ptr]
    lib.mas_shared_bytes.argtypes = [i32, i32]
    lib.mas_shared_bytes.restype = ctypes.c_size_t
    lib.mas_row_chain.argtypes = [ptr, i32, i32, ptr]
    lib.mas_shared_limit.argtypes = [i32, ctypes.POINTER(i32)]
    return lib


_smem_limit: Dict[int, int] = {}


def shared_limit(device: torch.device) -> int:
    """The shared memory, in bytes, a block may opt into on a CUDA device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _smem_limit:
        lib = _lib()
        smem = ctypes.c_int()
        kernel_build.check(lib, lib.mas_shared_limit(index, ctypes.byref(smem)),
                           "mas_shared_limit")
        _smem_limit[index] = smem.value
    return _smem_limit[index]


def mas_width1(attn: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor) -> torch.Tensor:
    """attn [B, T, N] float32, in_lens/out_lens [B] integer -> [B, T, N]
    float32 hard alignment.  CPU tensors take ``mas_width1_plain``; CUDA
    tensors launch the kernel once, in the shape ``mas_plan`` picks (a
    refused launch raises, a cluster the card cannot schedule included);
    anything else raises.  Lengths are read as ``0 <= in_len <= N`` and
    ``0 <= out_len <= T``."""
    if attn.device.type == "cpu":
        return mas_width1_plain(attn, in_lens, out_lens)
    if attn.device.type != "cuda":
        raise ValueError(f"mas_width1: unsupported device {attn.device}")
    if attn.dim() != 3:
        raise ValueError(f"attn must be [B, T, N], got {tuple(attn.shape)}")
    B, T, N = attn.shape
    if attn.dtype != torch.float32 or not attn.is_contiguous():
        raise ValueError(f"attn must be a contiguous float32 tensor, got {attn.dtype} "
                         f"(contiguous={attn.is_contiguous()})")
    for name, t in (("in_lens", in_lens), ("out_lens", out_lens)):
        if tuple(t.shape) != (B,) or t.dtype.is_floating_point or t.device != attn.device:
            raise ValueError(f"{name} must be an integer [{B}] tensor on {attn.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    plan = mas_plan(T, N, shared_limit(attn.device))
    opt = torch.empty_like(attn)
    if B == 0 or T == 0:
        return opt
    in32 = in_lens.to(torch.int32).contiguous()
    out32 = out_lens.to(torch.int32).contiguous()
    lib = _lib()
    err = lib.mas_forward(attn.data_ptr(), in32.data_ptr(), out32.data_ptr(), opt.data_ptr(),
                          B, T, N, plan.cluster, plan.k, plan.smem,
                          torch.cuda.current_stream(attn.device).cuda_stream)
    kernel_build.check(lib, err, "mas_forward")
    mas_width1.launches += 1
    return opt


mas_width1.launches = 0


def mas_row_chain(rows: int, k: int, device="cuda") -> None:
    """The serial floor's microbenchmark: one warp runs ``rows`` rows of the
    chain at ``k`` columns a lane (a shuffle, compares, max, add and the
    take-left bits a row; no loads, logs or stores), so its time over
    ``rows`` is one row's dependent step on the kernel's path.  CUDA only;
    the main path never calls it."""
    out = torch.empty(32, dtype=torch.float32, device=device)
    lib = _lib()
    kernel_build.check(lib, lib.mas_row_chain(out.data_ptr(), rows, k,
                                              torch.cuda.current_stream(out.device).cuda_stream),
                       "mas_row_chain")
