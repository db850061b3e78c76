"""Flash attention with segment masking as hand-written CUDA kernels
(``csrc/flash_attn.cu``: the forward, dK/dV and dQ) with the plain PyTorch
version beside them.

JAX counterpart: ``jax.experimental.pallas.ops.tpu.flash_attention`` (jax
0.9.0), which the JAX package's ``MultiHeadAttention`` calls on the TPU
(``models/fft_block.py:106-134``); its CPU oracle is
``mha_reference_no_custom_vjp``.  Query row r attends to key c only where
``seg[r] == seg[c]`` (1 real, 0 pad in the FFT blocks); elsewhere the score
is ``-0.7 * f32max``.  Scores, the softmax and the products' sums are f32
whatever the input dtype; the unnormalised probabilities are rounded to the
input dtype before the product with v, as the TPU kernel does in bf16.

``flash_attention`` (``FlashAttention.apply``) is what the model calls: on a
CUDA tensor its forward is the forward kernel and its backward the two
backward kernels, after one shared ``backward_inputs``; on a CPU tensor
both are the plain version (the backward by autograd through it).  Any
other device or dtype raises, and so does a CUDA shape the kernels do not
take (``kernel_shape_ok``: T % 64 == 0).  The kernels take every head dim
JAX's flash branch takes: up to 256 the templates built for ``WIDTHS``
(``flash_fwd``, ``flash_bwd_dkv``, ``flash_bwd_dq``), past 256 the wide
kernels (``flash_fwd_wide``, ``flash_bwd_dkv_wide``, ``flash_bwd_dq_wide``)
at any multiple of ``WIDE_PAD``, each output chunk a block of its own
(``wide_chunks``: 256 columns, a pair of them a block in the bf16 dQ; in
the f32 dQ all of D up to ``DQ_F32_COLS`` = 512, ``dq_f32_chunks``;
``wide_blocks``).  The wrappers zero-pad
D to ``kernel_width(D)`` and slice the results back, which is exact
(padded columns add 0 to every q.k, and padded v columns give output
columns that are dropped; ``sm_scale`` stays the caller's), as JAX pads
d_k above 128 to a multiple of 128.  The f32 kernels run on the tensor
cores at f32 accuracy (3xTF32), whatever
``torch.backends.cuda.matmul.allow_tf32`` says, which governs cuBLAS only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from wavthruvec_pytorch_tpu_torch.ops import kernel_build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPES = (torch.float32, torch.bfloat16)
WIDTHS = (64, 128, 224, 256)  # head dims the templates are built for (csrc/flash_attn.cu)
WIDE_PAD = 64  # past WIDTHS[-1]: the wide kernels' head dim is a multiple of it (WK)
WIDE_CHUNK = 256  # the wide kernels' output columns a chunk (WCH), but the f32 dQ's
DQ_F32_COLS = 512  # the wide f32 dQ's output columns a chunk at most (DQ_COLS)
_SPLIT_ROWS, _SPLIT_KEYS = 128, 32  # the f32 forwards' query rows a block, keys a tile
_DKV_KEYS, _DKV_QUERIES = 32, 16  # the wide f32 dK/dV's keys a block, queries a tile
_DQ_QUERIES, _DQ_KEYS = 32, 16  # the wide f32 dQ's queries a block, keys a tile


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor,
                          sm_scale: float):
    """q, k, v [B, H, T, D] (f32 or bf16), seg [B, T] integer ids ->
    (out [B, H, T, D] in q's dtype, lse [B, H, T] f32).  The probabilities
    are rounded to the input dtype before the product with v; their
    gradient passes the rounding unchanged, as the kernels' backward keeps
    dP in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    s = torch.where(same, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True).detach()  # the result does not depend on m
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p_in = p + (p.to(q.dtype).float() - p).detach()  # rounded value, identity gradient
    out = torch.matmul(p_in, v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _lib() -> ctypes.CDLL:
    lib = kernel_build.load("flash_attn")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [f32, i32, i32, ptr, ptr]
    lib.flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 4 + [f32, i32, ptr]
    lib.flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 4 + [f32, i32, ptr]
    lib.flash_fwd_wide.argtypes = lib.flash_fwd.argtypes
    lib.flash_bwd_dkv_wide.argtypes = lib.flash_bwd_dkv.argtypes[:-1] + [i32, ptr, ptr]
    lib.flash_bwd_dq_wide.argtypes = lib.flash_bwd_dq.argtypes[:-1] + [i32, ptr, ptr]
    for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq, lib.flash_fwd_wide,
               lib.flash_bwd_dkv_wide, lib.flash_bwd_dq_wide):
        fn.restype = ctypes.c_int
    return lib


def head_dim_ok(D: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take head dim D in ``dtype``: any D >= 1 in
    float32 or bfloat16 (zero-padded to ``kernel_width(D)``)."""
    return dtype in _DTYPES and D >= 1


def wide(D: int) -> bool:
    """Whether head dim D runs the wide kernels (D > 256)."""
    return D > WIDTHS[-1]


def kernel_width(D: int) -> int:
    """The head dim the kernels run head dim D at: the least of ``WIDTHS``
    that is at least D, or past 256 the next multiple of ``WIDE_PAD`` (the
    wide kernels' score-product stage; 448 runs unpadded)."""
    if wide(D):
        return -(-D // WIDE_PAD) * WIDE_PAD
    return next(w for w in WIDTHS if w >= D)


def wide_chunks(W: int, chunk: int = WIDE_CHUNK) -> list:
    """The output-column chunks of the wide kernels at padded head dim W =
    ``kernel_width(D)``: ``chunk`` columns each, the last what remains (448
    -> [256, 192]), every one a multiple of the kernels' 32-column TMA box.
    Every wide kernel takes ``WIDE_CHUNK`` (a block each; the bf16 dQ a
    block per two), but the f32 dQ, ``dq_f32_chunks``."""
    return [min(chunk, W - c) for c in range(0, W, chunk)]


def dq_f32_chunks(W: int) -> list:
    """The wide f32 dQ's output-column chunks at padded head dim W (the
    kernel's ``dq_f32_chunk``): W in as few chunks of at most
    ``DQ_F32_COLS`` as will do, each a multiple of ``WIDE_PAD`` and all but
    the last equal (448 -> [448]; 576 -> [320, 256]; 768 -> [384, 384]), so
    up to 512 a block computes the scores once for all of dQ."""
    n = -(-W // DQ_F32_COLS)
    return wide_chunks(W, WIDE_PAD * -(-(W // WIDE_PAD) // n))


def wide_blocks(name: str, dtype: torch.dtype, W: int) -> list:
    """The output-column chunks each block of the wide kernel ``name``
    (``flash_fwd_wide``, ``flash_bwd_dkv_wide`` or ``flash_bwd_dq_wide``)
    covers in ``dtype`` at padded head dim W, one list a blockIdx.z (before
    any split): ``wide_chunks(W)`` one a block, but two a block in the bf16
    dQ (a consumer warpgroup each) and ``dq_f32_chunks(W)`` in the f32 dQ."""
    if name == "flash_bwd_dq_wide":
        if dtype == torch.float32:
            return [[c] for c in dq_f32_chunks(W)]
        chunks = wide_chunks(W)
        return [chunks[i:i + 2] for i in range(0, len(chunks), 2)]
    return [[c] for c in wide_chunks(W)]


def kernel_shape_ok(B: int, H: int, T: int, D: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take q, k, v [B, H, T, D] in ``dtype``: T % 64 == 0
    and ``head_dim_ok``."""
    return min(B, H, T) >= 1 and T % 64 == 0 and head_dim_ok(D, dtype)


def f32_splits(BH: int, T: int, n_sm: int, chunks: int = 1) -> int:
    """Key splits of the f32 forward for B * H = BH heads of length T on
    ``n_sm`` SMs, its output in ``chunks`` column chunks (the wide forward's
    ``len(wide_chunks(W))``, a block each).  A block takes 128 query rows of
    one chunk and one SM, so serving's B * H = 2 gives 2 T / 128 blocks a
    chunk, too few for the card; each split adds that many blocks over a
    share of the 32-key tiles.  Chooses the split count s (every split
    non-empty, at most 32) that minimises waves(s) * (tiles a split + 2),
    the 2 standing for a block's Q load and its share of the merge; ties go
    to fewer splits."""
    return _splits(BH * -(-T // _SPLIT_ROWS) * chunks, T // _SPLIT_KEYS, n_sm)


def dkv_f32_splits(BH: int, T: int, n_sm: int, chunks: int) -> int:
    """Query splits of the wide f32 dK/dV (``wide_dkv_f32``) for B * H = BH
    heads of length T on ``n_sm`` SMs, at ``chunks = len(wide_chunks(W))``.
    A block takes 32 keys of one chunk and one SM, so one head of 3072
    gives 192 blocks at D = 448, 1.45 waves of 132; each split adds that
    many blocks over a share of the 16-query tiles, and its partial dK and
    dV are summed afterwards by a second pass over them.  The cost is
    ``f32_splits``' (the 2 standing for a block's K and V load), and a
    split must save a tenth of the unsplit cost, the rest standing for that
    pass: so a grid that already fills the card, as the f32 training batch
    [8, 1, 3072, 448] does (1536 blocks), takes none."""
    return _splits(BH * (T // _DKV_KEYS) * chunks, T // _DKV_QUERIES, n_sm, min_gain=0.1)


def dq_f32_splits(BH: int, T: int, n_sm: int, chunks: int) -> int:
    """Key splits of the wide f32 dQ (``wide_dq_f32``) for B * H = BH heads
    of length T on ``n_sm`` SMs, at ``chunks = len(dq_f32_chunks(W))``: the
    mirror image of ``dkv_f32_splits``.  A block takes 32 queries of one
    chunk and one SM, so one head of 3072 gives 96 blocks at D = 448 (one
    chunk), under one wave of 132; each split adds that many blocks over a
    share of the 16-key tiles, and its partial dQ is summed afterwards by
    ``wide_dq_f32_merge``.  The cost and the tenth a split must save are
    ``dkv_f32_splits``', so the f32 training batch [8, 1, 3072, 448] (768
    blocks) takes none."""
    return _splits(BH * (T // _DQ_QUERIES) * chunks, T // _DQ_KEYS, n_sm, min_gain=0.1)


def _splits(blocks: int, tiles: int, n_sm: int, min_gain: float = 0.0) -> int:
    """The split count s (every split of the ``tiles`` non-empty, at most
    32) that minimises waves(s) * (tiles a split + 2) for ``blocks`` blocks
    a split on ``n_sm`` SMs, one block an SM; ties go to fewer splits, and
    1 unless the best saves more than ``min_gain`` of the unsplit cost."""
    best, best_cost, one = 1, None, None
    for s in range(1, min(32, tiles) + 1):
        per = -(-tiles // s)
        if -(-tiles // per) != s:  # some split would be empty
            continue
        cost = -(-blocks * s // n_sm) * (per + 2)
        one = cost if s == 1 else one
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best if best_cost < (1.0 - min_gain) * one else 1


def _check(q, k, v, seg, *more):
    """Raise for what the kernels do not take, whatever the device; returns
    (B, H, T, D)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, D], got {tuple(q.shape)}")
    B, H, T, D = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    for t in (k, v) + more:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"k, v (and dout) must match q {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not kernel_shape_ok(B, H, T, D, q.dtype):
        raise ValueError(f"flash attention kernels take T % 64 == 0; got T={T}, D={D}, "
                         f"{q.dtype}")
    if tuple(seg.shape) != (B, T) or seg.dtype.is_floating_point or seg.device != q.device:
        raise ValueError(f"seg must be an integer [{B}, {T}] tensor on {q.device}, got "
                         f"{seg.dtype} {tuple(seg.shape)} on {seg.device}")
    return B, H, T, D


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"flash attention kernels: unsupported device {t.device}")


def _aligned(*tensors) -> None:
    """Every kernel loads by TMA, bulk copies or cp.async: 16-byte aligned
    bases."""
    for t in tensors:
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"flash attention kernels: a {t.dtype} {tuple(t.shape)} tensor is "
                             f"not 16-byte aligned (data_ptr {t.data_ptr():#x})")


def _btkd(t: torch.Tensor, width: int) -> torch.Tensor:
    """[B, H, T, D] -> the kernels' contiguous [B, T, H, width], zero-padded
    past D (no copy for a transposed view of a [B, T, H, D] tensor, as the
    model passes, at width D)."""
    x = t.transpose(1, 2)
    if width == t.shape[-1]:
        return x.contiguous()
    padded = x.new_zeros(*x.shape[:-1], width)
    padded[..., :t.shape[-1]] = x
    return padded


def _forward(q, k, v, seg, sm_scale: float, is_wide: bool):
    """Launch the forward kernels of one family (the templates, or the wide
    kernels); returns (out, lse) as ``flash_fwd`` documents them."""
    _require_cuda(q)
    B, H, T, D = _check(q, k, v, seg)
    if wide(D) != is_wide:
        raise ValueError(f"head dim D={D} runs flash_fwd{'_wide' if wide(D) else ''}")
    W = kernel_width(D)
    qc, kc, vc = _btkd(q, W), _btkd(k, W), _btkd(v, W)
    out = torch.empty_like(qc)
    lse = torch.empty(B, H, T, device=q.device, dtype=torch.float32)
    seg32 = seg.to(torch.int32).contiguous()
    _aligned(qc, kc, vc, seg32)
    lib, is_bf16 = _lib(), int(q.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    nsplit, part = 1, None
    if q.dtype == torch.float32:
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        chunks = len(wide_blocks("flash_fwd_wide", q.dtype, W)) if is_wide else 1
        nsplit = f32_splits(B * H, T, n_sm, chunks)
        if nsplit > 1:
            part = torch.empty(nsplit * B * H * T * (W + 2), device=q.device, dtype=torch.float32)
    name = "flash_fwd_wide" if is_wide else "flash_fwd"
    err = getattr(lib, name)(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), seg32.data_ptr(),
                             out.data_ptr(), lse.data_ptr(), B, H, T, W, float(sm_scale), is_bf16,
                             nsplit, None if part is None else part.data_ptr(), stream)
    kernel_build.check(lib, err, name)
    return out[..., :D].transpose(1, 2), lse


def flash_fwd(q, k, v, seg, sm_scale: float):
    """The forward kernel at D <= 256: q, k, v [B, H, T, D] CUDA f32 or
    bf16, seg [B, T] -> (out [B, H, T, D], a view of a [B, T, H, width]
    tensor; lse [B, H, T] f32).  One call (in f32 with split keys, the
    kernel and its merge)."""
    result = _forward(q, k, v, seg, sm_scale, is_wide=False)
    flash_fwd.launches += 1
    return result


def flash_fwd_wide(q, k, v, seg, sm_scale: float):
    """The wide forward kernel at D > 256, as ``flash_fwd``: one launch, a
    block per 128 query rows, head and chunk of ``wide_chunks`` (in f32 also
    per key split, and then the merge)."""
    result = _forward(q, k, v, seg, sm_scale, is_wide=True)
    flash_fwd_wide.launches += 1
    return result


class BackwardInputs(NamedTuple):
    """What both backward kernels read, made once a backward: q, k, v, dout
    in the kernels' [B, T, H, width] layout (zero-padded to
    ``kernel_width(D)``), int32 seg [B, T], lse and
    delta = rowsum(dO * out) [B, H, T] f32; ``shape`` is (B, H, T, D)."""
    shape: Tuple[int, int, int, int]
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    seg: torch.Tensor
    dout: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor


def backward_inputs(q, k, v, seg, out, lse, dout) -> BackwardInputs:
    """Check and lay out the backward's inputs ([B, H, T, D] as the forward
    took them) on any device."""
    B, H, T, D = _check(q, k, v, seg, out, dout)
    if tuple(lse.shape) != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{B}, {H}, {T}], got {lse.dtype} {tuple(lse.shape)}")
    # delta = rowsum(dO * out), outside the kernels as in the JAX package
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    W = kernel_width(D)
    ins = BackwardInputs((B, H, T, D), _btkd(q, W), _btkd(k, W), _btkd(v, W),
                         seg.to(torch.int32).contiguous(), _btkd(dout, W), lse.contiguous(), delta)
    _aligned(ins.q, ins.k, ins.v, ins.seg, ins.dout, ins.lse, ins.delta)
    return ins


def _backward(ins: BackwardInputs, sm_scale: float, name: str, n_out: int):
    """Launch the backward kernel ``name`` of the C library on
    ``backward_inputs``' result; returns its ``n_out`` gradients [B, H, T, D]
    in q's dtype.  The wide dK/dV and dQ also take their query or key
    splits and their scratch (``dkv_f32_splits``, ``dq_f32_splits``; one
    split in bf16)."""
    _require_cuda(ins.q)
    B, H, T, D = ins.shape
    if wide(D) != name.endswith("_wide"):
        raise ValueError(f"head dim D={D} does not run {name}")
    W = ins.q.shape[-1]
    grads = [torch.empty_like(ins.q) for _ in range(n_out)]
    splits = []
    if name in ("flash_bwd_dkv_wide", "flash_bwd_dq_wide"):
        nsplit, part = 1, None
        if ins.q.dtype == torch.float32:
            n_sm = torch.cuda.get_device_properties(ins.q.device).multi_processor_count
            rule = dkv_f32_splits if name == "flash_bwd_dkv_wide" else dq_f32_splits
            nsplit = rule(B * H, T, n_sm, len(wide_blocks(name, ins.q.dtype, W)))
            if nsplit > 1:
                part = torch.empty(n_out * nsplit * B * H * T * W, device=ins.q.device,
                                   dtype=torch.float32)
        splits = [nsplit, None if part is None else part.data_ptr()]
    lib = _lib()
    err = getattr(lib, name)(ins.q.data_ptr(), ins.k.data_ptr(), ins.v.data_ptr(),
                             ins.seg.data_ptr(), ins.dout.data_ptr(), ins.lse.data_ptr(),
                             ins.delta.data_ptr(), *(g.data_ptr() for g in grads), B, H, T, W,
                             float(sm_scale), int(ins.q.dtype == torch.bfloat16), *splits,
                             torch.cuda.current_stream(ins.q.device).cuda_stream)
    kernel_build.check(lib, err, name)
    return [g[..., :D].transpose(1, 2) for g in grads]


def flash_bwd_dkv(ins: BackwardInputs, sm_scale: float):
    """The dK/dV kernel at D <= 256 on ``backward_inputs``' result -> (dk,
    dv) [B, H, T, D] in q's dtype.  One launch."""
    dk, dv = _backward(ins, sm_scale, "flash_bwd_dkv", 2)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(ins: BackwardInputs, sm_scale: float):
    """The dQ kernel at D <= 256 on ``backward_inputs``' result -> dq
    [B, H, T, D] in q's dtype.  One launch."""
    (dq,) = _backward(ins, sm_scale, "flash_bwd_dq", 1)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv_wide(ins: BackwardInputs, sm_scale: float):
    """The wide dK/dV kernel at D > 256, as ``flash_bwd_dkv``: one call, a
    block per 64 keys (bf16) or 32 keys and query split (f32), head and
    chunk of ``wide_chunks``; in f32 with split queries, the kernel and the
    sum of its splits."""
    dk, dv = _backward(ins, sm_scale, "flash_bwd_dkv_wide", 2)
    flash_bwd_dkv_wide.launches += 1
    return dk, dv


def flash_bwd_dq_wide(ins: BackwardInputs, sm_scale: float):
    """The wide dQ kernel at D > 256, as ``flash_bwd_dq``: one call, a
    block per 64 queries, head and two chunks of ``wide_chunks`` (bf16) or
    per 32 queries, head, chunk of ``dq_f32_chunks`` and key split (f32);
    in f32 with split keys, the kernel and the sum of its splits."""
    (dq,) = _backward(ins, sm_scale, "flash_bwd_dq_wide", 1)
    flash_bwd_dq_wide.launches += 1
    return dq


# launches of each kernel
KERNELS = (flash_fwd, flash_bwd_dkv, flash_bwd_dq, flash_fwd_wide, flash_bwd_dkv_wide,
           flash_bwd_dq_wide)
for _fn in KERNELS:
    _fn.launches = 0


def kernels_for(D: int):
    """The (forward, dK/dV, dQ) wrappers that run head dim D."""
    return KERNELS[3:] if wide(D) else KERNELS[:3]


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, seg, sm_scale)``: q, k, v [B, H, T, D], seg [B, T] ->
    out [B, H, T, D].  CUDA tensors run the kernels, CPU tensors the plain
    version; it saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, seg, sm_scale):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, seg, sm_scale)
        else:
            out, lse = kernels_for(q.shape[-1])[0](q, k, v, seg, sm_scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                o, _ = flash_attention_plain(*qkv, seg, ctx.sm_scale)
                dq, dk, dv = torch.autograd.grad(o, qkv, dout)
        else:
            _, bwd_dkv, bwd_dq = kernels_for(q.shape[-1])
            ins = backward_inputs(q, k, v, seg, out, lse, dout)
            dk, dv = bwd_dkv(ins, ctx.sm_scale)
            dq = bwd_dq(ins, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Differentiable flash attention: q, k, v [B, H, T, D] float32 or
    bfloat16 on the CPU or a CUDA device, seg [B, T] integer ids -> out
    [B, H, T, D] in q's dtype."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    return FlashAttention.apply(q, k, v, seg, sm_scale)
