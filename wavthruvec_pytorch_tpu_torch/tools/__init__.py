"""Measurement scripts of the port, each run on its own on an NVIDIA GPU,
and what they share: building variant libraries with nvcc, and timing
launches queued behind a spin."""

from __future__ import annotations

import ctypes
import subprocess

import torch

from wavthruvec_pytorch_tpu_torch.ops import kernel_build


def start_build(source: str, library: str, defines=()) -> subprocess.Popen:
    """Start nvcc building ``source`` into the shared library ``library``
    with the port's flags and ``csrc/`` on the include path; each of
    ``defines`` ("NAME" or "NAME=value") becomes a -D (a bare name is 1)."""
    cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-I", kernel_build.SRC_DIR,
           *(f"-D{d}" if "=" in d else f"-D{d}=1" for d in defines), "-o", library, source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_builds(builds) -> dict:
    """Wait for ``{name: (start_build's process, library)}``; returns
    ``{name: (the loaded library, nvcc's output)}`` and raises where a build
    failed."""
    libs = {}
    for name, (proc, library) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = (ctypes.CDLL(library), log)
    return libs


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls queued behind a
    ~30 ms spin of the card, so the CUDA events time the device alone."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
