"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  Libraries go
to ``wavthruvec_pytorch_tpu_torch/build/`` under a name that carries the
hash of the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  Nothing
is compiled when a module is imported: the first launch of a kernel builds
it, and ``build_all`` builds every kernel at once, one ``nvcc`` process per
source, all started together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
KERNELS = ("fused_resblock", "gru_fwd", "gru_bwd", "mas", "flash_attn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (CUDA_HOME or nvcc on PATH).")
    return path


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by the hash of that source,
    of every header ``csrc/*.cuh`` (any source may include any) and of the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh")))
    for path in [os.path.join(SRC_DIR, f"{name}.cu")] + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path) or
    None when the library for this source is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build of the same source is harmless


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every kernel that is not built yet, all nvcc processes in parallel."""
    names = list(names)
    started = {n: _start_build(n) for n in names}
    for n in names:
        if started[n] is not None:
            _finish_build(n, started[n])


def build_log(name: str) -> str:
    """nvcc's output (with ptxas's register report) of the last build of
    ``csrc/<name>.cu``; empty if it was never built here."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(name, started)
            lib = ctypes.CDLL(library_path(name))
            lib.wtv_error_string.argtypes = [ctypes.c_int]
            lib.wtv_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise for a nonzero cudaError_t returned by a kernel's C entry point."""
    if err != 0:
        msg = lib.wtv_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError_t {err} ({msg})")
