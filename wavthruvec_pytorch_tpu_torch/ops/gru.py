"""Forward recurrence of D stacked GRU directions as hand-written CUDA
kernels (``csrc/gru_fwd.cu``) with their plain PyTorch version beside them,
in the two numerics of the JAX package's ``_gru_fwd_core``
(models/layers.py:756-787), torch nn.GRU gates and h0 = 0 in both:

* "bf16", ``gru_fwd``: JAX ``gru_impl="pallas"`` (``ops/gru_pallas.py``,
  ``gru_fwd_pallas``): ``h`` and ``w_hh`` rounded to bf16 for the hidden
  matmul with f32 accumulation, h carried in f32;
* "f32", ``gru_fwd_f32``: JAX ``gru_impl="scan"`` (its ``lax.scan``), and
  ``"pallas"`` wherever JAX's gate ``gru_pallas_supported`` refuses the
  shape: ``h`` and ``w_hh`` in f32, f32 products and sums.

``gru_numerics`` maps ``(gru_impl, D, B, H)`` to one of the two as JAX does.
On CUDA tensors each wrapper launches its kernel, on CPU tensors it runs
``gru_fwd_plain``.  On the card ``gru_fwd_plan`` picks the kernel's route by
shape: one persistent cooperative launch with ``w_hh`` resident in shared
memory (the CBHG's shapes), or one launch a time step where the weights do
not fit.

``GRURecurrence`` makes the recurrence differentiable: its forward is
``gru_fwd`` or ``gru_fwd_f32``, its backward ``gru_bwd``, the JAX package's
custom VJP ``_gru_stacked_bwd`` (models/layers.py:795-840), the same for
both numerics and in f32: the gates and gh recomputed for all T by one
matmul, the reverse recurrence (JAX's reverse ``lax.scan``, :829) in the
hand-written kernel ``csrc/gru_bwd.cu`` through ``gru_bwd_loop`` on CUDA
tensors and in ``gru_bwd_loop_plain`` on CPU tensors, and the weight
gradients as large matmuls after it.  ``gru_bwd_plan`` picks that kernel's
route as ``gru_fwd_plan`` does the forward's; its persistent route runs in
thread-block clusters of two (``PAIR``), each block multiplying half the
columns for both blocks' units, and where the card cannot hold every pair at
once (``max_clusters``) the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from wavthruvec_pytorch_tpu_torch.ops import kernel_build


PRECISIONS = ("bf16", "f32")

# JAX's Pallas gate (ops/gru_pallas.py:35,77-84), copied as a shape rule: the
# 14 MiB budget is the TPU's VMEM and the H % 128 clause its lane width.  They
# mean nothing on the card and are kept because they decide which numerics
# JAX computes under gru_impl="pallas".
_JAX_VMEM_BUDGET = 14 * 1024 * 1024


def gru_pallas_supported(D: int, B: int, H: int) -> bool:
    """JAX's ``gru_pallas_supported``: bf16 ``w_hh`` resident, the
    double-buffered step rows and the f32 carry within 14 MiB, H % 128 == 0."""
    w_bytes = D * H * 3 * H * 2
    step_bytes = 2 * (D * B * 3 * H * 4 + D * B * H * 4)
    scratch = D * B * H * 4 + D * 3 * H * 4
    return H % 128 == 0 and (w_bytes + step_bytes + scratch) <= _JAX_VMEM_BUDGET


def gru_numerics(impl: str, D: int, B: int, H: int) -> str:
    """The numerics JAX's ``_gru_fwd_core`` computes for ``impl`` at D
    directions, batch B and H units: "bf16" for ``"pallas"`` where its gate
    holds, "f32" everywhere else (``"scan"``, the gate refusing, or any other
    string, as JAX's ``if impl == "pallas"`` falls through to the scan)."""
    return "bf16" if impl == "pallas" and gru_pallas_supported(D, B, H) else "f32"


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def gru_fwd_plain(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  precision: str = "bf16") -> torch.Tensor:
    """gi [D, B, T, 3H] f32 (input projections + b_ih), w_hh [D, H, 3H],
    b_hh [D, 3H] -> hidden states [D, B, T, H].  "bf16": ``h`` and ``w_hh``
    are rounded to bf16 and their products summed in f32, as ``gru_fwd``'s
    kernel does; "f32": neither is rounded (JAX's scan, ``gru_fwd_f32``)."""
    _check_precision(precision)
    bf16 = precision == "bf16"
    D, B, T, H3 = gi.shape
    H = H3 // 3
    w = w_hh.to(torch.bfloat16).to(torch.float32) if bf16 else w_hh.to(torch.float32)
    h = gi.new_zeros(D, B, H)
    ys = []
    for t in range(T):
        gh = torch.bmm(h.to(torch.bfloat16).to(torch.float32) if bf16 else h, w) + b_hh[:, None]
        gi_t = gi[:, :, t]
        r = torch.sigmoid(gi_t[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi_t[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gi_t[..., 2 * H:] + r * gh[..., 2 * H:])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=2)


# the persistent kernels' block (csrc/gru_fwd.cu): threads, warps, batch rows
# a tile, and the hidden units a block may own (their template instances)
_P_WARPS, _BM = 8, 16
PERSISTENT_UNITS = (8, 16, 24, 32)
_F_STAGE = 2048  # floats of one of the f32 kernel's two h stages
_STEP_UNITS = 8  # the steps route's hidden units a block, one warp each


class GRUPlan(NamedTuple):
    """How a wrapper runs a shape on the card: ``route`` "persistent" (one
    launch for all T steps with every block resident, ``units`` hidden units
    of one direction a block, their ``w_hh`` rows resident in ``smem`` bytes
    of shared memory) or "steps" (one launch a time step, ``units`` hidden
    units a block, no dynamic shared memory); ``blocks`` a launch;
    ``cluster`` the blocks of a thread-block cluster: ``PAIR`` on the
    backward's persistent route (0 where the card cannot hold every pair at
    once, which its wrapper refuses), 1 elsewhere."""

    route: str
    blocks: int
    units: int
    smem: int
    cluster: int = 1


def persistent_smem(U: int, B: int, H: int) -> int:
    """Shared-memory bytes of the bf16 persistent kernel (``persistent_smem``
    in csrc/gru_fwd.cu): the [3U, H + 8] bf16 ``w_hh`` slice, a [16, H + 8]
    bf16 h tile, the 8 warps' [16, 3U] f32 partial sums, gi [B, 3U], the f32
    carry [B, U] and b_hh [3U]."""
    hp, r = H + 8, 3 * U
    return 2 * r * hp + 2 * _BM * hp + 4 * _P_WARPS * _BM * r + 4 * B * r + 4 * B * U + 4 * r


def persistent_f32_smem(U: int, B: int, H: int) -> int:
    """Shared-memory bytes of the f32 persistent kernel
    (``persistent_f32_smem`` in csrc/gru_fwd.cu): the [3U, H + 4] f32
    ``w_hh`` slice, the 8 warps' [16, 3U] f32 partial sums (at least two h
    stages of 2048 floats, which lie there), gi [B, 3U], the f32 carry
    [B, U] and b_hh [3U].  No whole h tile: h_{t-1} streams through the
    stages from L2."""
    hp, r = H + 4, 3 * U
    red = max(_P_WARPS * _BM * r, 2 * _F_STAGE)
    return 4 * (r * hp + red + B * r + B * U + r)


def gru_fwd_plan(D: int, B: int, H: int, n_sm: int, smem_bytes: int,
                 precision: str = "bf16") -> GRUPlan:
    """The route of ``precision``'s kernel for D directions of H units at
    batch B on a card with ``n_sm`` SMs and ``smem_bytes`` of shared memory a
    block.  Persistent when some ``U`` in ``PERSISTENT_UNITS`` gives at most
    one block an SM (D * ceil(H / U) <= n_sm, so the cooperative launch is
    resident) and its shared memory fits; the smallest such U (the most
    blocks).  Otherwise the steps route, which takes any D, B and
    H % 8 == 0.  A choice by shape, made before the launch."""
    _check_precision(precision)
    smem_of = persistent_smem if precision == "bf16" else persistent_f32_smem
    for U in PERSISTENT_UNITS:
        blocks = D * -(-H // U)
        if blocks > n_sm:
            continue
        smem = smem_of(U, B, H)
        if smem <= smem_bytes:
            return GRUPlan("persistent", blocks, U, smem)
        break  # a larger U only needs more shared memory
    return GRUPlan("steps", D * -(-H // _STEP_UNITS), _STEP_UNITS, 0)


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a build of ``csrc/gru_fwd.cu`` on ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gru_fwd_device_limits.argtypes = [ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.gru_fwd_persistent.argtypes = [ptr] * 6 + [i32] * 5 + [ctypes.c_longlong, ptr]
    lib.gru_fwd_persistent_f32.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.c_longlong, ptr]
    lib.gru_fwd_barrier_loop.argtypes = [ptr] + [i32] * 3 + [ctypes.c_longlong, ptr]
    lib.gru_fwd_steps.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.gru_fwd_steps_f32.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    for fn in (lib.gru_fwd_device_limits, lib.gru_fwd_persistent, lib.gru_fwd_persistent_f32,
               lib.gru_fwd_barrier_loop, lib.gru_fwd_steps, lib.gru_fwd_steps_f32):
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return bind_fwd(kernel_build.load("gru_fwd"))


_limits: Dict[int, Tuple[int, int]] = {}


def device_limits(device: torch.device) -> Tuple[int, int]:
    """(SMs, shared-memory bytes a block may opt into) of a CUDA device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _limits:
        lib = _lib()
        n_sm, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            kernel_build.check(lib, lib.gru_fwd_device_limits(ctypes.byref(n_sm),
                                                              ctypes.byref(smem)),
                               "gru_fwd_device_limits")
        _limits[index] = (n_sm.value, smem.value)
    return _limits[index]


_W_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _checked_shape(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, precision: str):
    """(D, B, T, H) of CUDA tensors ``precision``'s kernel takes; raises
    otherwise."""
    if gi.device.type != "cuda":
        raise ValueError(f"gru_fwd: unsupported device {gi.device}")
    if gi.dim() != 4 or gi.shape[-1] % 3 != 0:
        raise ValueError(f"gi must be [D, B, T, 3H], got {tuple(gi.shape)}")
    D, B, T, H3 = gi.shape
    H = H3 // 3
    if H % 8 != 0:
        raise ValueError(f"gru_fwd needs H % 8 == 0 (16-byte weight rows), got H={H}")
    w_dtype = _W_DTYPES[precision]
    if tuple(w_hh.shape) != (D, H, H3) or w_hh.dtype != w_dtype:
        raise ValueError(f"w_hh must be {w_dtype} [{D}, {H}, {H3}], got {w_hh.dtype} "
                         f"{tuple(w_hh.shape)}")
    if tuple(b_hh.shape) != (D, H3):
        raise ValueError(f"b_hh must be [{D}, {H3}], got {tuple(b_hh.shape)}")
    for name, t in (("gi", gi), ("b_hh", b_hh)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")
    for name, t in (("w_hh", w_hh), ("b_hh", b_hh)):
        if t.device != gi.device:
            raise ValueError(f"{name} is on {t.device}, gi on {gi.device}")
    return D, B, T, H


def _launch(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, plan: GRUPlan,
            precision: str, lib: ctypes.CDLL = None) -> torch.Tensor:
    """Run checked CUDA tensors on ``plan``'s route of ``precision``'s
    kernel (in ``lib``, a ``bind_fwd`` library, if given: a measurement
    build); an empty output launches nothing."""
    D, B, T, H = gi.shape[0], gi.shape[1], gi.shape[2], gi.shape[3] // 3
    y = torch.empty(D, B, T, H, device=gi.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    lib = lib or _lib()
    wrapper = gru_fwd if precision == "bf16" else gru_fwd_f32
    w_t = w_hh.transpose(1, 2).contiguous()  # [D, 3H, H]: no copy for a transposed view
    stream = torch.cuda.current_stream(gi.device).cuda_stream
    if plan.route == "persistent":
        counter = torch.zeros(D, device=gi.device, dtype=torch.int32)
        if precision == "bf16":
            hx = torch.empty(2, D, B, H, device=gi.device, dtype=torch.bfloat16)
            err = lib.gru_fwd_persistent(gi.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(),
                                         y.data_ptr(), hx.data_ptr(), counter.data_ptr(),
                                         D, B, T, H, plan.units, plan.smem, stream)
        else:  # h_{t-1} is read back from y itself
            err = lib.gru_fwd_persistent_f32(gi.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(),
                                             y.data_ptr(), counter.data_ptr(),
                                             D, B, T, H, plan.units, plan.smem, stream)
        kernel_build.check(lib, err, f"gru_fwd_persistent ({precision})")
        wrapper.step_launches += 1
    else:
        steps = lib.gru_fwd_steps if precision == "bf16" else lib.gru_fwd_steps_f32
        err = steps(gi.data_ptr(), w_t.data_ptr(), b_hh.data_ptr(), y.data_ptr(),
                    D, B, T, H, stream)
        kernel_build.check(lib, err, f"gru_fwd_steps ({precision})")
        wrapper.step_launches += T
    wrapper.launches += 1
    wrapper.time_steps += T
    return y


def gru_fwd(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The bf16 numerics (JAX ``gru_impl="pallas"``): gi [D, B, T, 3H] f32
    contiguous, w_hh [D, H, 3H] bf16 (any strides), b_hh [D, 3H] f32
    contiguous -> [D, B, T, H] f32.  CPU tensors take ``gru_fwd_plain``;
    CUDA tensors launch the kernel on the route ``gru_fwd_plan`` picks for
    the shape; anything else raises."""
    if gi.device.type == "cpu":
        return gru_fwd_plain(gi, w_hh, b_hh)
    D, B, T, H = _checked_shape(gi, w_hh, b_hh, "bf16")
    return _launch(gi, w_hh, b_hh, gru_fwd_plan(D, B, H, *device_limits(gi.device)), "bf16")


def gru_fwd_f32(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The f32 numerics (JAX ``gru_impl="scan"``): as ``gru_fwd`` with
    w_hh [D, H, 3H] f32 (any strides), and h and w_hh unrounded.  CPU
    tensors take ``gru_fwd_plain(..., "f32")``; CUDA tensors launch the f32
    kernel on the route ``gru_fwd_plan(..., "f32")`` picks; anything else
    raises."""
    if gi.device.type == "cpu":
        return gru_fwd_plain(gi, w_hh, b_hh, "f32")
    D, B, T, H = _checked_shape(gi, w_hh, b_hh, "f32")
    return _launch(gi, w_hh, b_hh, gru_fwd_plan(D, B, H, *device_limits(gi.device), "f32"),
                   "f32")


def gru_fwd_steps(gi: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """``gru_fwd`` (bf16 ``w_hh``) or ``gru_fwd_f32`` (f32 ``w_hh``) on the
    one-launch-a-step route whatever the shape, CUDA tensors only: to time
    that route beside the planner's (the main path never calls it).  Counts
    in the counters of the wrapper whose numerics it runs."""
    precision = "f32" if w_hh.dtype == torch.float32 else "bf16"
    D, B, T, H = _checked_shape(gi, w_hh, b_hh, precision)
    plan = GRUPlan("steps", D * -(-H // _STEP_UNITS), _STEP_UNITS, 0)
    return _launch(gi, w_hh, b_hh, plan, precision)


# each wrapper's calls that launched its kernel, the device launches they
# issued (1 a call on the persistent route, T on the steps route) and the
# time steps they ran
for _fn in (gru_fwd, gru_fwd_f32):
    _fn.launches = 0
    _fn.step_launches = 0
    _fn.time_steps = 0


def _barrier_loop(D: int, T: int, plan: GRUPlan, device: torch.device) -> None:
    if plan.route != "persistent":
        raise ValueError(f"the barrier loop needs the persistent route, got {plan}")
    lib = _lib()
    counter = torch.zeros(D, device=device, dtype=torch.int32)
    err = lib.gru_fwd_barrier_loop(counter.data_ptr(), D, plan.blocks // D, T, plan.smem,
                                   torch.cuda.current_stream(device).cuda_stream)
    kernel_build.check(lib, err, "gru_fwd_barrier_loop")


def gru_barrier_loop(D: int, B: int, T: int, H: int, device, precision: str = "bf16") -> None:
    """The persistent route's serial floor at (D, B, T, H) for
    ``precision``'s kernel: its grid and shared memory, running the T - 1
    per-direction barriers and nothing else (to time; the main path never
    calls it).  Raises if the shape takes the steps route."""
    device = torch.device(device)
    _barrier_loop(D, T, gru_fwd_plan(D, B, H, *device_limits(device), precision), device)


# --- backward ------------------------------------------------------------------

def gru_bwd_loop_plain(dys: torch.Tensor, gi: torch.Tensor, gh: torch.Tensor,
                       hprev: torch.Tensor, w_hh: torch.Tensor):
    """The reverse recurrence of JAX's ``_gru_stacked_bwd`` (its ``lax.scan``,
    models/layers.py:829), the plain version of ``gru_bwd_loop``'s kernel:
    dys, hprev [D, B, T, H], gi, gh [D, B, T, 3H] (gh = hprev . w_hh + b_hh),
    w_hh [D, H, 3H] f32 -> (dgi, dgh), both [D, B, T, 3H]: dgi = [dr_pre,
    dz_pre, dn_pre] and dgh = [dr_pre, dz_pre, dhn] at every step.

    Everything that does not depend on the carried gradient is computed for
    all T at once: the gates, and the factors that turn the total gradient
    on h_t into the gate gradients.  The loop over T then carries only dh
    [D, B, H] (4 launches a step).  The arithmetic is JAX's, reassociated."""
    D, B, T, H = hprev.shape
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    h_n = gh[..., 2 * H:]
    n = torch.tanh(gi[..., 2 * H:] + r * h_n)
    # with g the total gradient on h_t: dn_pre = g * dn, and
    # [dr_pre, dz_pre, dhn] = g * coef (JAX's dgh), dh_{t-1} = g * z + dgh . w_hh^T
    dn = (1.0 - z) * (1.0 - n * n)
    coef = torch.stack([dn * h_n * r * (1.0 - r), (hprev - n) * z * (1.0 - z), dn * r], dim=3)
    coef_t = coef.permute(2, 0, 1, 3, 4).contiguous()  # [T, D, B, 3, H]
    z_t = z.permute(2, 0, 1, 3).contiguous()
    dys_t = dys.permute(2, 0, 1, 3).contiguous()
    w_t = w_hh.transpose(1, 2)  # [D, 3H, H]
    g_all = torch.empty_like(dys_t)  # [T, D, B, H]
    dh = dys.new_zeros(D, B, H)
    for t in range(T - 1, -1, -1):
        g = torch.add(dys_t[t], dh, out=g_all[t])
        dgh = (coef_t[t] * g[:, :, None]).view(D, B, 3 * H)
        dh = torch.baddbmm(g * z_t[t], dgh, w_t)
    g = g_all.permute(1, 2, 0, 3)  # [D, B, T, H]
    dgh = (coef * g[:, :, :, None]).reshape(D, B, T, 3 * H)
    return torch.cat([dgh[..., :2 * H], g * dn], dim=-1), dgh


# the backward kernel's persistent block (csrc/gru_bwd.cu): the hidden units
# a block may own (its instances), the blocks of its clusters (a pair, each
# block multiplying half the columns for both blocks' units), the batch-row
# passes whose inputs and carry a thread holds in registers, and the floats
# of one of its two dgh stages
BWD_UNITS = (8, 16)
PAIR = 2
_B_PASSES, _B_STAGE = 4, 4096


def persistent_bwd_smem(U: int, H: int) -> int:
    """Shared-memory bytes of the backward kernel's persistent route
    (``persistent_bwd_smem`` in csrc/gru_bwd.cu): the pair's 2U rows of w_hh
    over the block's half of the 3H columns (U x 3H f32 in all), two dgh
    stages of 4096 floats (where the warps' partial sums also lie), the
    partner's sums [2, 16, U] and two mbarriers.  The step's inputs and the
    carried gradient live in registers, so the batch does not enter."""
    return 4 * (3 * U * H + 2 * _B_STAGE + 2 * _BM * U) + 16


def pair_blocks(U: int, H: int) -> int:
    """A direction's blocks on the backward's persistent route
    (``pair_blocks`` in csrc/gru_bwd.cu): ceil(H / U) rounded up to whole
    pairs, so that a pair never spans two directions (a block past H owns
    no unit and multiplies its half of the columns for its partner)."""
    return PAIR * -(-H // (PAIR * U))


def cluster_size(blocks: int, clusters) -> int:
    """The blocks a cluster of the backward's persistent grid of ``blocks``
    blocks: ``PAIR`` where ``clusters[PAIR]``, the pairs the card can hold
    at once (``max_clusters``), cover the grid; 0 otherwise (or where
    ``clusters`` is None: not asked)."""
    if clusters is not None and clusters.get(PAIR, 0) * PAIR >= blocks:
        return PAIR
    return 0


def _bwd_batch_tile(B: int) -> int:
    """The backward kernel's batch rows a pass (``bwd_batch_tile`` in
    csrc/gru_bwd.cu): the smallest power of two covering min(B, 16)."""
    bt = 1
    while bt < _BM and bt < B:
        bt *= 2
    return bt


def gru_bwd_plan(D: int, B: int, H: int, n_sm: int, smem_bytes: int,
                 clusters=None) -> GRUPlan:
    """The route of the backward kernel for D directions of H units at batch
    B on a card with ``n_sm`` SMs and ``smem_bytes`` of shared memory a
    block.  Persistent when some ``U`` in ``BWD_UNITS`` gives at most one
    block an SM (D * pair_blocks(U, H) <= n_sm), its rows of w_hh fit in shared
    memory and B takes at most 4 passes of its batch tile; the smallest such
    U, in clusters of ``cluster_size(blocks, clusters)`` (pairs, each
    block multiplying half the columns for both blocks' units; 0, which the
    wrapper refuses, where the card cannot hold them).  Otherwise the steps
    route, which takes any D, B and H % 8 == 0.  A choice by shape, made
    before the launch."""
    for U in BWD_UNITS:
        blocks = D * pair_blocks(U, H)
        if blocks > n_sm:
            continue
        smem = persistent_bwd_smem(U, H)
        if smem <= smem_bytes and B <= _B_PASSES * _bwd_batch_tile(B):
            return GRUPlan("persistent", blocks, U, smem, cluster_size(blocks, clusters))
        break  # a larger U needs more shared memory
    return GRUPlan("steps", D * -(-H // _STEP_UNITS), _STEP_UNITS, 0)


def bwd_plan(D: int, B: int, H: int, device) -> GRUPlan:
    """``gru_bwd_plan`` at the card's limits, with its cluster size from the
    card's ``max_clusters`` on the persistent route."""
    device = torch.device(device)
    n_sm, smem = device_limits(device)
    plan = gru_bwd_plan(D, B, H, n_sm, smem)
    if plan.route != "persistent":
        return plan
    return gru_bwd_plan(D, B, H, n_sm, smem, max_clusters(D, B, H, plan, device))


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a build of ``csrc/gru_bwd.cu`` on ``lib``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gru_bwd_persistent.argtypes = [ptr] * 8 + [i32] * 6 + [ctypes.c_longlong, ptr]
    lib.gru_bwd_max_clusters.argtypes = [i32] * 5 + [ctypes.c_longlong, ctypes.POINTER(i32)]
    lib.gru_bwd_steps.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    for fn in (lib.gru_bwd_persistent, lib.gru_bwd_max_clusters, lib.gru_bwd_steps):
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    return bind_bwd(kernel_build.load("gru_bwd"))


_clusters: Dict[tuple, Dict[int, int]] = {}


def max_clusters(D: int, B: int, H: int, plan: GRUPlan, device: torch.device) -> Dict[int, int]:
    """{C: the clusters of C blocks the card can hold at once} for C = 2 and
    4, of the backward kernel on ``plan``'s persistent route at (D, B, H), as
    cudaOccupancyMaxActiveClusters reports for its instance and shared memory
    (4 only to print: the kernel runs in pairs)."""
    lib = _bwd_lib()
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, D, B, H, plan.units, plan.smem)
    if key not in _clusters:
        counts = {}
        with torch.cuda.device(index):
            for C in (PAIR, 2 * PAIR):
                n = ctypes.c_int()
                kernel_build.check(lib, lib.gru_bwd_max_clusters(D, B, H, plan.units, C,
                                                                 plan.smem, ctypes.byref(n)),
                                   f"gru_bwd_max_clusters (C={C})")
                counts[C] = n.value
        _clusters[key] = counts
    return _clusters[key]


def _checked_bwd_shape(dys, gi, gh, hprev, w_hh):
    """(D, B, T, H) of CUDA tensors the backward kernel takes; raises
    otherwise."""
    if dys.device.type != "cuda":
        raise ValueError(f"gru_bwd_loop: unsupported device {dys.device}")
    if dys.dim() != 4:
        raise ValueError(f"dys must be [D, B, T, H], got {tuple(dys.shape)}")
    D, B, T, H = dys.shape
    if H % 8 != 0:
        raise ValueError(f"gru_bwd_loop needs H % 8 == 0 (16-byte rows), got H={H}")
    want = {"dys": (D, B, T, H), "hprev": (D, B, T, H), "gi": (D, B, T, 3 * H),
            "gh": (D, B, T, 3 * H), "w_hh": (D, H, 3 * H)}
    for name, t in (("dys", dys), ("gi", gi), ("gh", gh), ("hprev", hprev), ("w_hh", w_hh)):
        if tuple(t.shape) != want[name] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {list(want[name])}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dys.device:
            raise ValueError(f"{name} is on {t.device}, dys on {dys.device}")
        if name != "w_hh" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return D, B, T, H


def _launch_bwd(dys, gi, gh, hprev, w_hh, plan: GRUPlan, lib: ctypes.CDLL = None):
    """Run checked CUDA tensors on ``plan``'s route of the backward kernel
    (in ``lib``, a ``bind_bwd`` library, if given: a measurement build); an
    empty output launches nothing."""
    D, B, T, H = dys.shape
    dgi, dgh = torch.empty_like(gi), torch.empty_like(gi)
    if dgi.numel() == 0:
        return dgi, dgh
    if plan.route == "persistent" and plan.cluster < 1:  # every block resident, or no launch
        raise RuntimeError(f"gru_bwd_loop: the card cannot hold all {plan.blocks} blocks of "
                           f"{plan.smem} bytes in clusters of {PAIR} at once")
    lib = lib or _bwd_lib()
    w = w_hh.contiguous()  # [D, H, 3H]: the rows a block keeps are w_hh[d, j]
    stream = torch.cuda.current_stream(dys.device).cuda_stream
    ptrs = (dys.data_ptr(), gi.data_ptr(), gh.data_ptr(), hprev.data_ptr(), w.data_ptr(),
            dgi.data_ptr(), dgh.data_ptr())
    if plan.route == "persistent":
        counter = torch.zeros(D, device=dys.device, dtype=torch.int32)
        err = lib.gru_bwd_persistent(*ptrs, counter.data_ptr(), D, B, T, H, plan.units,
                                     plan.cluster, plan.smem, stream)
        gru_bwd_loop.step_launches += 1
    else:
        gz = torch.empty(D, B, H, device=dys.device, dtype=torch.float32)
        err = lib.gru_bwd_steps(*ptrs, gz.data_ptr(), D, B, T, H, stream)
        gru_bwd_loop.step_launches += T
    kernel_build.check(lib, err, f"gru_bwd ({plan.route})")
    gru_bwd_loop.launches += 1
    gru_bwd_loop.time_steps += T
    return dgi, dgh


def gru_bwd_loop(dys: torch.Tensor, gi: torch.Tensor, gh: torch.Tensor, hprev: torch.Tensor,
                 w_hh: torch.Tensor):
    """``gru_bwd_loop_plain``'s function: dys, hprev [D, B, T, H] and gi, gh
    [D, B, T, 3H] f32 contiguous, w_hh [D, H, 3H] f32 (any strides) -> (dgi,
    dgh) [D, B, T, 3H].  CPU tensors take ``gru_bwd_loop_plain``; CUDA tensors
    launch the kernel on the route ``gru_bwd_plan`` picks for the shape;
    anything else raises."""
    if dys.device.type == "cpu":
        return gru_bwd_loop_plain(dys, gi, gh, hprev, w_hh)
    D, B, T, H = _checked_bwd_shape(dys, gi, gh, hprev, w_hh)
    return _launch_bwd(dys, gi, gh, hprev, w_hh, bwd_plan(D, B, H, dys.device))


def gru_bwd_steps(dys: torch.Tensor, gi: torch.Tensor, gh: torch.Tensor, hprev: torch.Tensor,
                  w_hh: torch.Tensor):
    """``gru_bwd_loop`` on the one-launch-a-step route whatever the shape,
    CUDA tensors only: to check and time that route beside the planner's
    (the main path never calls it).  Counts in ``gru_bwd_loop``'s counters."""
    D, B, T, H = _checked_bwd_shape(dys, gi, gh, hprev, w_hh)
    return _launch_bwd(dys, gi, gh, hprev, w_hh,
                       GRUPlan("steps", D * -(-H // _STEP_UNITS), _STEP_UNITS, 0))


# the calls that launched the kernel, the device launches they issued (1 a
# call on the persistent route, T on the steps route) and the time steps run
gru_bwd_loop.launches = 0
gru_bwd_loop.step_launches = 0
gru_bwd_loop.time_steps = 0


def gru_bwd_barrier_loop(D: int, B: int, T: int, H: int, device) -> None:
    """The backward kernel's serial floor at (D, B, T, H): its persistent
    grid and shared memory running the T - 1 per-direction barriers and
    nothing else (the forward library's barrier kernel; to time, the main
    path never calls it).  Raises if the shape takes the steps route."""
    device = torch.device(device)
    _barrier_loop(D, T, gru_bwd_plan(D, B, H, *device_limits(device)), device)


def _gru_bwd(loop, dys, gi, hprev, w_hh, b_hh):
    D, B, T, H = hprev.shape
    gh = torch.matmul(hprev, w_hh[:, None]) + b_hh[:, None, None]  # [D, B, T, 3H]
    dgi, dgh = loop(dys, gi, gh, hprev, w_hh)
    dw_hh = torch.matmul(hprev.reshape(D, B * T, H).transpose(1, 2), dgh.reshape(D, B * T, 3 * H))
    return dgi, dw_hh, dgh.sum(dim=(1, 2))


def gru_bwd(dys: torch.Tensor, gi: torch.Tensor, hprev: torch.Tensor, w_hh: torch.Tensor,
            b_hh: torch.Tensor):
    """Backward of the recurrence, JAX's ``_gru_stacked_bwd``: dys, hprev
    [D, B, T, H], gi [D, B, T, 3H], w_hh [D, H, 3H] f32, b_hh [D, 3H] ->
    (dgi [D, B, T, 3H], dw_hh [D, H, 3H], db_hh [D, 3H]).

    As in JAX, for both numerics, the gates are recomputed from the
    forward's f32 ``hprev`` with the f32 ``w_hh`` (under "bf16" not the
    bf16 copy the forward multiplied by): gh by one matmul for all T, then
    the reverse loop ``gru_bwd_loop`` (the kernel on CUDA tensors), then
    dw_hh and db_hh each as one large reduction."""
    return _gru_bwd(gru_bwd_loop, dys, gi, hprev, w_hh, b_hh)


def gru_bwd_plain(dys: torch.Tensor, gi: torch.Tensor, hprev: torch.Tensor,
                  w_hh: torch.Tensor, b_hh: torch.Tensor):
    """``gru_bwd`` with the plain loop ``gru_bwd_loop_plain`` on any device:
    the backward's plain version."""
    return _gru_bwd(gru_bwd_loop_plain, dys, gi, hprev, w_hh, b_hh)


class GRURecurrence(torch.autograd.Function):
    """The D-direction recurrence with a gradient.  ``apply(gi, w_hh, b_hh,
    precision="bf16")``: gi [D, B, T, 3H] f32 (input projections + b_ih),
    w_hh [D, H, 3H] f32 (the parameters), b_hh [D, 3H] -> [D, B, T, H].  The
    forward is ``gru_fwd`` on a bf16 copy of ``w_hh`` made here ("bf16") or
    ``gru_fwd_f32`` on ``w_hh`` itself ("f32"): the kernel on CUDA tensors;
    the backward ``gru_bwd`` for both (its loop the kernel on CUDA tensors).
    The gradients of the input projection reach ``w_ih``, ``b_ih`` and x
    through the autograd of the matmul that made ``gi``."""

    @staticmethod
    def forward(ctx, gi, w_hh, b_hh, precision="bf16"):
        _check_precision(precision)
        if precision == "bf16":
            ys = gru_fwd(gi, w_hh.to(torch.bfloat16), b_hh)
        else:
            ys = gru_fwd_f32(gi, w_hh, b_hh)
        ctx.save_for_backward(gi, ys, w_hh, b_hh)
        return ys

    @staticmethod
    def backward(ctx, dys):
        gi, ys, w_hh, b_hh = ctx.saved_tensors
        GRURecurrence.backward_calls += 1
        hprev = torch.cat([ys.new_zeros(ys.shape[:2] + (1, ys.shape[3])), ys[:, :, :-1]], dim=2)
        return gru_bwd(dys.contiguous(), gi, hprev, w_hh, b_hh) + (None,)


# backward passes run, counted as gru_fwd counts its launches
GRURecurrence.backward_calls = 0
