"""zarr v2 arrays in an OCDBT store, as orbax writes a checkpoint's leaves:
``{name}/.zarray`` (JSON: shape, chunks, dtype, compressor, fill value) and
one chunk a key, ``{name}/i.j...`` (``dimension_separator`` "."; a 0-d
array's chunk is ``{name}/0``), each a whole chunk in C order, compressed
with zstd.  A chunk the store lacks is the fill value.

``<f4``, ``<f8``, ``<i4``, ``<i8``, ``|b1`` and ``|u1`` come back as numpy
arrays; ``bfloat16``, which numpy lacks, as a ``torch.bfloat16`` tensor
made from the bits through a ``uint16`` view.  Any other dtype raises.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.orbax_format import zstd
from wavthruvec_pytorch_tpu_torch.orbax_format.ocdbt import OcdbtStore

DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
          "|b1": np.bool_, "|u1": np.uint8, "bfloat16": np.uint16}
GROUP_BYTES = 64 << 20           # stored chunk bytes decompressed in one call


class ZarrError(ValueError):
    """An array this reader does not take, or whose chunks do not fit it."""


class ArrayPlan:
    """An array's metadata and the store keys of its chunks."""

    def __init__(self, name: str, meta: Dict):
        self.name = name
        if meta.get("zarr_format") != 2:
            raise ZarrError(f"{name}: zarr format {meta.get('zarr_format')}, not 2")
        dtype = meta["dtype"]
        if not isinstance(dtype, str) or dtype not in DTYPES:
            raise ZarrError(f"{name}: dtype {dtype!r} is not taken (only {sorted(DTYPES)})")
        if meta.get("order", "C") != "C" or meta.get("filters"):
            raise ZarrError(f"{name}: order {meta.get('order')!r} / filters "
                            f"{meta.get('filters')!r} are not taken")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise ZarrError(f"{name}: compressor {compressor.get('id')!r} is not taken")
        self.compressed = compressor is not None
        self.bfloat16 = dtype == "bfloat16"
        self.dtype = np.dtype(DTYPES[dtype])
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        if len(self.chunks) != len(self.shape):
            raise ZarrError(f"{name}: chunks {self.chunks} for shape {self.shape}")
        self.fill = meta.get("fill_value")
        sep = meta.get("dimension_separator", ".")
        grid = [range(math.ceil(s / c)) if c else range(1)
                for s, c in zip(self.shape, self.chunks)]
        self.grid = list(itertools.product(*grid))
        if not self.shape:
            self.keys = [f"{name}/0".encode()]
        else:
            self.keys = [f"{name}/{sep.join(map(str, idx))}".encode() for idx in self.grid]

    def assemble(self, chunks: Sequence[Optional[bytes]]):
        """The array from its chunks' decompressed bytes (None: missing)."""
        fill = 0 if self.fill is None else self.fill
        if isinstance(fill, str):                    # "NaN", "Infinity", "-Infinity"
            fill = float(fill)
        if self.bfloat16:                            # the float's top 16 bits
            fill = int(np.float32(fill).view(np.uint32)) >> 16
        out = np.full(self.shape, fill, dtype=self.dtype)
        csize = math.prod(self.chunks)
        for idx, data in zip(self.grid, chunks):
            if data is None:
                continue
            if len(data) != csize * self.dtype.itemsize:
                raise ZarrError(f"{self.name}: a chunk of {len(data)} bytes, a chunk of "
                                f"{self.chunks} {self.dtype} has "
                                f"{csize * self.dtype.itemsize}")
            block = np.frombuffer(data, self.dtype.newbyteorder("<")).reshape(self.chunks)
            sl = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, self.chunks, self.shape))
            out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
        if self.bfloat16:
            return torch.from_numpy(out).view(torch.bfloat16)
        return out


def plan_array(store: OcdbtStore, name: str) -> ArrayPlan:
    raw = store.read(f"{name}/.zarray".encode())
    if raw is None:
        raise ZarrError(f"the store has no array {name!r} ({name}/.zarray)")
    return ArrayPlan(name, json.loads(raw))


def read_arrays(store: OcdbtStore, names: Sequence[str],
                stats: Optional[Dict[str, float]] = None) -> List:
    """The arrays ``names`` of ``store``.  Their chunks are read and
    decompressed in groups of whole arrays, each group one
    ``zstd.decompress_many`` call over about ``GROUP_BYTES`` of stored
    chunks (a group closes at the first array that reaches it), and each
    group's arrays are assembled before the next group is read: the
    compressed and decoded chunks held at once stay within a few groups'
    bytes, whatever the checkpoint's size.  ``stats`` gets the chunks'
    compressed bytes under ``"bytes"``."""
    plans = [plan_array(store, n) for n in names]
    out: List = []
    raw: List[Tuple[int, int, bytes]] = []
    size = 0
    for i, plan in enumerate(plans):
        for j, key in enumerate(plan.keys):
            data = store.read(key)
            if data is not None:
                raw.append((i, j, data))
                size += len(data)
        if size >= GROUP_BYTES or i == len(plans) - 1:
            out += _assemble_group(plans, len(out), i + 1, raw)
            if stats is not None:
                stats["bytes"] = stats.get("bytes", 0) + size
            raw, size = [], 0
    return out


def _assemble_group(plans: Sequence[ArrayPlan], start: int, stop: int,
                    raw: List[Tuple[int, int, bytes]]) -> List:
    """The arrays ``plans[start:stop]`` from their stored chunks ``raw``
    (array index, chunk index, bytes)."""
    to_decode = [k for k, (i, _, _) in enumerate(raw) if plans[i].compressed]
    decoded = zstd.decompress_many([raw[k][2] for k in to_decode])
    chunks: List[List[Optional[bytes]]] = [[None] * len(p.keys) for p in plans[start:stop]]
    for i, j, data in raw:
        chunks[i - start][j] = data
    for k, data in zip(to_decode, decoded):
        i, j, _ = raw[k]
        chunks[i - start][j] = data
    return [p.assemble(c) for p, c in zip(plans[start:stop], chunks)]
