"""The native ``.npy`` reader and prefetcher (JAX package:
data/native_io.py; the port's copy of its C++ source is
``csrc/npy_loader.cc``).

It is host code: ``g++`` builds it at first use into
``wavthruvec_pytorch_tpu_torch/build/``, beside the kernels, under a name
that carries the hash of the source and the flags (``ops/kernel_build.py``
names the kernels so), and ``ctypes`` loads it.  Where the build fails,
every read takes ``np.load``, as in the JAX package; the first call prints
which reader was taken, and ``reader()`` says it.

    from wavthruvec_pytorch_tpu_torch.data import native_io
    with native_io.Prefetcher(paths) as pf:       # reads overlapped on threads
        for i in range(len(paths)):
            arr = pf.get(i)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from typing import List, Optional, Sequence

import numpy as np

from wavthruvec_pytorch_tpu_torch.ops.kernel_build import BUILD_DIR, SRC_DIR

SRC = os.path.join(SRC_DIR, "npy_loader.cc")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# the prefetcher's reading threads, and the files they may read ahead of ``get``
N_THREADS, WINDOW = 4, 64

_lib = None  # the loaded library, or the reason it is not there
_lib_lock = threading.Lock()


def library_path() -> str:
    """``build/libwtv_io-<hash>.so``, the hash of the source and the flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libwtv_io-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> Optional[str]:
    """Run g++ into ``out``; returns None, or why it failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp], capture_output=True,
                              text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ did not run: {e}"
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr.strip()[-2000:]}"
    os.replace(tmp, out)  # atomic: a concurrent build of the same source is harmless
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed; None where it cannot be
    built (reads then take ``np.load``).  The first call prints which."""
    global _lib
    with _lib_lock:
        if _lib is None:
            out = library_path()
            err = None if os.path.exists(out) else _build(out)
            if err is None:
                lib = ctypes.CDLL(out)
                _declare(lib)
                _lib = lib
                print(f"npy reader: native ({os.path.relpath(out, os.path.dirname(BUILD_DIR))})")
            else:
                _lib = err
                print(f"npy reader: np.load, the native reader did not build ({err})")
        return _lib if isinstance(_lib, ctypes.CDLL) else None


def reader() -> str:
    """``"native"`` or ``"np.load"``: the reader that reads take."""
    return "native" if get_lib() is not None else "np.load"


def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.wtv_prefetch_create.restype = ctypes.c_void_p
    lib.wtv_prefetch_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
    lib.wtv_prefetch_take.restype = ctypes.c_void_p
    lib.wtv_prefetch_take.argtypes = [ctypes.c_void_p, ctypes.c_int64, i64p,
                                      ctypes.POINTER(ctypes.c_int)]
    lib.wtv_free.restype = None
    lib.wtv_free.argtypes = [ctypes.c_void_p]
    lib.wtv_prefetch_destroy.restype = None
    lib.wtv_prefetch_destroy.argtypes = [ctypes.c_void_p]


def _np_load(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32, copy=False)


class Prefetcher:
    """In-order ``.npy`` reads (C order; f4, f8, i2, i4 or i8; up to 4
    dims) as float32 over a fixed list of files, ``N_THREADS`` native
    threads reading up to ``WINDOW`` files ahead of ``get``, which takes
    increasing indices.  ``close`` (or the ``with`` block) stops the
    threads."""

    def __init__(self, paths: Sequence[str]):
        self._handle = None
        self.paths: List[str] = list(paths)
        self._lib = get_lib()
        if self._lib is not None and self.paths:
            self._c_paths = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])  # the threads read these
            self._handle = self._lib.wtv_prefetch_create(self._c_paths, len(self.paths),
                                                         N_THREADS, WINDOW)

    def __len__(self) -> int:
        return len(self.paths)

    def get(self, index: int) -> np.ndarray:
        """File ``index`` as float32: the array a thread read, taken with no
        copy (the library frees it when the array goes); ``np.load``
        without the library, and, printed, for a file the native reader
        fails on."""
        if self._handle is None:
            return _np_load(self.paths[index])
        shape, ndim = (ctypes.c_int64 * 4)(), ctypes.c_int()
        ptr = self._lib.wtv_prefetch_take(self._handle, index, shape, ctypes.byref(ndim))
        if not ptr:
            print(f"npy reader: np.load for {self.paths[index]}: the native read failed "
                  f"({ndim.value})")
            return _np_load(self.paths[index])
        shp = tuple(shape[i] for i in range(ndim.value))
        buf = (ctypes.c_float * int(np.prod(shp))).from_address(ptr)
        weakref.finalize(buf, self._lib.wtv_free, ptr)
        return np.frombuffer(buf, np.float32).reshape(shp)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.wtv_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
