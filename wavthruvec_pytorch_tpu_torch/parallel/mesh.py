"""Data parallelism over cards, one process per card (JAX package:
parallel/mesh.py; reference: ``init_process_group('nccl', tcp://...)``,
DDP and ``DistributedSampler``, vec2wav/train.py:58-60, 91-94, 114-122).

A job is started by ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``);
``maybe_distributed_init`` joins its process group and names the rank's
device.  Then:

* every rank holds the same parameters: rank 0's, broadcast by
  ``globalize_state`` after init or restore;
* each rank reads its own share of the file list (``process_shard``) and
  steps on its local batch of ``local_batch_size`` items, padded to the
  same shape on every rank (``data/dataset.py`` ``pad_to_max``);
* the trainers average the gradients over the ranks (``all_reduce_mean``)
  before the clip and the optimizer, and ``models/layers.BatchNorm`` takes
  its train-mode statistics over the global batch; so a step computes what
  one process computes on the concatenated global batch, up to the order
  of f32 sums.

This is what JAX's ``jit`` over a mesh computes with the batch sharded on
its data axis.  Without a process group every function here is a no-op,
and single-process runs are unchanged bit for bit.  The collectives
(``all_reduce_mean``, ``mean_scalars``, ``all_reduce_sum``) run whenever a
group is up, also at world size 1, where they are exact; the rest (BatchNorm's global
statistics, ``globalize_state``, ``mesh_for_batch``) act only at world size
above 1, where they have something to do.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# the largest bucket a collective of ``all_reduce_mean`` or
# ``globalize_state`` moves at once
BUCKET_BYTES = 32 * 2**20

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class World:
    """The process group as a data-parallel mesh: this process's rank, the
    number of ranks, and the device the rank computes on."""

    rank: int
    size: int
    device: torch.device


def group_active() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if group_active() else 1


def rank() -> int:
    return dist.get_rank() if group_active() else 0


def is_main_process() -> bool:
    """Rank 0, the one that writes the job's files (or the only process)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if group_active():
        dist.barrier()


def maybe_distributed_init(device=None, backend: Optional[str] = None
                           ) -> Optional[torch.device]:
    """Join the launcher's process group (JAX: ``maybe_distributed_init``).

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``; without all of them, or with a group already joined,
    it does nothing and returns None.  Otherwise it joins the group over
    ``tcp://MASTER_ADDR:MASTER_PORT`` and returns the rank's device:
    ``cuda:LOCAL_RANK`` (made the current card) for ``device`` None or
    ``"cuda"``, the given card for ``"cuda:i"``, or the CPU for ``"cpu"``.
    The backend is NCCL on a card and gloo on the CPU unless ``backend``
    says otherwise: two ranks that share one card need gloo, since NCCL
    takes one card per rank."""
    env = {k: os.environ.get(k) for k in _LAUNCH_ENV}
    if any(v is None for v in env.values()) or group_active():
        return None
    r, n, local = int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("maybe_distributed_init: no GPU is visible; pass device='cpu' "
                               "to train on the CPU over gloo")
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            rank=r, world_size=n)
    return dev


def local_batch_size(global_batch_size: int) -> int:
    """The items a rank steps on for a global batch; raises when the global
    batch does not divide over the ranks (JAX: ``local_batch_size``)."""
    n = world_size()
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} ranks")
    return global_batch_size // n


def mesh_for_batch(batch_size: int, device=None) -> Optional[World]:
    """The data-parallel world for a global batch, or None at world size 1
    (JAX: ``mesh_for_batch``).  Every rank takes part, so the batch must
    divide over the ranks (``local_batch_size`` raises otherwise)."""
    if world_size() == 1:
        return None
    local_batch_size(batch_size)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return World(rank(), world_size(), torch.device(device))


def process_shard(items: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List:
    """Rank i's share of a file list: ``items[i::n]``, cut to ``len // n``
    so that every rank makes the same number of batches (JAX:
    ``process_shard``; the reference's ``DistributedSampler``)."""
    n = world_size() if process_count is None else process_count
    i = rank() if process_index is None else process_index
    if n == 1:
        return list(items)
    return list(items)[i::n][:len(items) // n]


def shard_batch(batch: Dict, world: Optional[World], device=None) -> Dict:
    """This rank's rows of a global batch that every rank holds alike, as
    tensors on its device: rank r takes rows ``[r * b, (r + 1) * b)`` of each
    array, b the local batch (JAX's data sharding puts them on device r).
    Without a world the whole batch goes to ``device``.  Entries that are
    not arrays (file names) are sliced as lists."""
    dev = world.device if world is not None else torch.device(device or "cpu")
    out = {}
    for k, v in batch.items():
        n = len(v)
        lo, hi = (0, n) if world is None else (world.rank * n // world.size,
                                               (world.rank + 1) * n // world.size)
        if isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = torch.as_tensor(v[lo:hi]).to(dev)
        else:
            out[k] = list(v)[lo:hi]
    return out


def _buckets(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The tensors grouped by dtype and device into buckets of at most
    ``BUCKET_BYTES`` (a tensor larger than that is a bucket of its own)."""
    groups: Dict[tuple, List[List[torch.Tensor]]] = {}
    sizes: Dict[tuple, int] = {}
    for t in tensors:
        key = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        if key not in groups or sizes[key] + nbytes > BUCKET_BYTES:
            groups.setdefault(key, []).append([])
            sizes[key] = 0
        groups[key][-1].append(t)
        sizes[key] += nbytes
    return [b for bs in groups.values() for b in bs if b]


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor, in place, by its mean over the ranks (no-op
    without a process group).  The tensors are flattened into a few buckets
    (``BUCKET_BYTES``), one all-reduce each, not one a tensor."""
    if not group_active():
        return
    n = dist.get_world_size()
    for bucket in _buckets(tensors):
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat)
        flat.div_(n)
        for t, f in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(f)


@torch.no_grad()
def mean_scalars(scalars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' means of detached scalars (a step's reported losses), in
    one all-reduce of f32 values, each cast back to its own dtype (the same
    values without a process group)."""
    values = torch.stack([v.float() for v in scalars.values()])
    all_reduce_mean([values])
    return {k: x.to(v.dtype) for (k, v), x in zip(scalars.items(), values.unbind())}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the ranks' gradients: rank r's
    input reaches every rank's output, so its gradient is the sum of the
    output gradients of all ranks."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably (``t`` itself without a
    process group)."""
    return _AllReduceSum.apply(t) if group_active() else t


@torch.no_grad()
def globalize_state(modules: Sequence[torch.nn.Module],
                    optimizers: Sequence[torch.optim.Optimizer] = ()) -> None:
    """Give every rank rank 0's parameters, buffers and optimizer state
    (JAX: ``globalize_state``), bucketed like ``all_reduce_mean``.  A no-op
    below world size 2.  The optimizers' states must hold the same tensors
    on every rank: empty after init, or loaded from the same file.  Over
    NCCL, which moves only card tensors, the optimizers' scalar step counts
    that PyTorch keeps on the CPU are left as each rank loaded them."""
    if world_size() == 1:
        return
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    for opt in optimizers:
        for state in opt.state.values():
            tensors.extend(v for v in state.values() if isinstance(v, torch.Tensor))
    if dist.get_backend() == "nccl":
        tensors = [t for t in tensors if t.is_cuda]
    for bucket in _buckets(tensors):
        flat = _flatten_dense_tensors(bucket)
        dist.broadcast(flat, 0)
        for t, f in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(f)
