"""Run a function on N local ranks, as ``torchrun --nproc_per_node N``
would run a script: each rank is a process started with
``torch.multiprocessing``'s spawn method and the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR=localhost``, a free
``MASTER_PORT``), so the function's ``maybe_distributed_init`` joins their
group.  The tests run two ranks over gloo on the CPU with it, and
``chip_smoke.py`` two ranks on one card.

The function must be importable by name from a module that the children
can import (spawn pickles it by reference) and return something picklable
by value (numbers, numpy arrays).  Every wait has a deadline: a rank that
fails, dies or hangs ends the run with an error naming it, and the other
ranks are killed.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank: int, world: int, port: int, args: Sequence,
               results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist

    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn: Callable, world: int, args: Sequence = (), timeout: float = 300.0
              ) -> List[Any]:
    """``fn(*args)`` on ranks 0..world-1; returns their results in rank
    order.  Raises ``RuntimeError`` with the rank's traceback if one fails
    or dies, ``TimeoutError`` if the ranks have not all returned within
    ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, tuple(args), results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, done = {}, False
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} did not "
                                   f"return within {timeout:.0f} s")
            try:
                r, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{value}")
            out[r] = value
        done = True
    finally:
        for p in procs:  # every result is read: the queue is drained
            if done:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world)]
