"""tensorstore's OCDBT key-value store, read-only (the format tensorstore
documents as "OCDBT on-disk format"), as orbax writes it under a
checkpoint directory.

* ``manifest.ocdbt`` holds the store's config, a table of data files and
  the versions; the newest version names the root node of a b-tree.  An
  orbax checkpoint's root tree is the merge of each process's sub-database
  (``ocdbt.process_N/``): its data file table names files under those
  directories, so following the root manifest reaches every process's keys.
* A b-tree node is interior (height > 0: each entry a child's first key,
  the length of the prefix all its keys share, and the child's location)
  or a leaf (each entry a key and its value, inline or a (data file,
  offset, length) reference).  Keys are stored relative to the prefix the
  parent gives, each as the length it shares with the key before it plus
  the rest.
* Manifests and nodes start with a magic number (``0c db 3a 2a`` and
  ``0c db 20 de``), a length, a version and a compression (0 none, 1 zstd
  over the body), and end with the CRC-32C of everything before it, which
  is checked here with a table-driven CRC-32C of this module's own
  (``zlib.crc32`` is CRC-32, another polynomial).

The store lists its keys and reads one key at a time, loading only the
nodes on the key's path (each node decoded once a store).
"""

from __future__ import annotations

import os
import struct
from bisect import bisect_right
from typing import Dict, Iterator, List, Optional, Tuple

from wavthruvec_pytorch_tpu_torch.orbax_format import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


class OcdbtError(ValueError):
    """A store that does not read: a bad magic, length or checksum, or a
    body that does not parse."""


# --- CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) -----------------

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data`` (``crc32c(b"123456789") == 0xE3069283``)."""
    t = _CRC_TABLE
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# --- the body's encodings --------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def varint(self) -> int:
        v, shift = 0, 0
        buf = self.buf
        while True:
            if self.pos >= len(buf) or shift > 63:
                raise OcdbtError("truncated or overlong varint")
            b = buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OcdbtError("truncated body")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> bytes:
        return self.take(n)


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node: checks its magic, length and
    CRC-32C, and decompresses it."""
    if len(raw) < 18:
        raise OcdbtError(f"{what}: {len(raw)} bytes is too short")
    if struct.unpack_from(">I", raw)[0] != magic:
        raise OcdbtError(f"{what}: bad magic {raw[:4].hex()}")
    if struct.unpack_from("<Q", raw, 4)[0] != len(raw):
        raise OcdbtError(f"{what}: its length field says {struct.unpack_from('<Q', raw, 4)[0]}, "
                         f"it has {len(raw)} bytes")
    if crc32c(raw[:-4]) != struct.unpack_from("<I", raw, len(raw) - 4)[0]:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(raw[:-4])
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = raw[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from None
    raise OcdbtError(f"{what}: compression format {compression}")


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                                     # base path lengths: a split of the path
    paths, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + r.take(suffix[i])
        paths.append(path.decode())
        prev = path
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError("key prefix longer than the key before it")
        key = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


class _Node:
    __slots__ = ("height", "keys", "values", "children", "prefixes")


class OcdbtStore:
    """The store under ``root`` (a checkpoint directory), at its newest
    version."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            body = _unwrap(f.read(), MANIFEST_MAGIC, path)
        r = _Reader(body)
        r.take(16)                                   # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"{path}: manifest kind {kind} (numbered manifests) is not taken")
        r.varint()                                   # max inline value bytes
        self.max_node_bytes = r.varint()
        r.take(1)                                    # version tree arity (log2)
        if r.varint() == 1:                          # zstd: its level, int32
            r.take(4)
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            raise OcdbtError(f"{path}: no version inline")
        gen = r.varints(n)
        height = r.u8s(n)
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        newest = max(range(n), key=gen.__getitem__)
        self._root = None
        if num_keys[newest]:
            self._root = (files[fid[newest]], off[newest], length[newest], height[newest])
        self._nodes: Dict[tuple, _Node] = {}

    # --- nodes ---------------------------------------------------------------

    def _read_file(self, rel: str, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} past its end")
        return data

    def _node(self, loc: tuple) -> _Node:
        node = self._nodes.get(loc)
        if node is not None:
            return node
        rel, offset, length, height = loc
        body = _unwrap(self._read_file(rel, offset, length), NODE_MAGIC,
                       f"{os.path.join(self.root, rel)}@{offset}")
        if len(body) > self.max_node_bytes:
            raise OcdbtError(f"node of {len(body)} bytes over the config's {self.max_node_bytes}")
        r = _Reader(body)
        node = _Node()
        node.height = r.u8s(1)[0]
        if node.height != height:
            raise OcdbtError(f"node of height {node.height} where its parent says {height}")
        files = _data_file_table(r)
        n = r.varint()
        node.keys, node.prefixes = _keys(r, n, node.height > 0)
        if node.height > 0:
            fid, off, length = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)          # each subtree's keys, tree bytes, indirect value bytes
            node.children = [(files[fid[i]], off[i], length[i], node.height - 1)
                             for i in range(n)]
            node.values = None
        else:
            lengths = r.varints(n)
            kinds = r.u8s(n)
            if any(k > 1 for k in kinds):
                raise OcdbtError(f"value kind {max(kinds)}")
            n_ind = sum(kinds)
            fid, off = r.varints(n_ind), r.varints(n_ind)
            values, j = [], 0
            for i in range(n):
                if kinds[i]:
                    values.append((files[fid[j]], off[j], lengths[i]))
                    j += 1
                else:
                    values.append(r.take(lengths[i]))
            node.values = values
            node.children = None
        if r.pos != len(body):
            raise OcdbtError(f"{len(body) - r.pos} bytes after a node's entries")
        self._nodes[loc] = node
        return node

    # --- the key-value interface ---------------------------------------------

    def _entries(self, loc: tuple, prefix: bytes) -> Iterator[Tuple[bytes, object]]:
        node = self._node(loc)
        if node.height == 0:
            for key, value in zip(node.keys, node.values):
                yield prefix + key, value
            return
        for key, common, child in zip(node.keys, node.prefixes, node.children):
            yield from self._entries(child, prefix + key[:common])

    def keys(self) -> List[bytes]:
        """Every key, in order."""
        if self._root is None:
            return []
        return [k for k, _ in self._entries(self._root, b"")]

    def _value(self, value) -> bytes:
        return value if isinstance(value, bytes) else self._read_file(*value)

    def read(self, key: bytes) -> Optional[bytes]:
        """The value of ``key``, or None where the store has no such key."""
        if self._root is None:
            return None
        loc, prefix = self._root, b""
        while True:
            node = self._node(loc)
            if not key.startswith(prefix):
                return None
            rel = key[len(prefix):]
            if node.height == 0:
                i = bisect_right(node.keys, rel) - 1
                return self._value(node.values[i]) if i >= 0 and node.keys[i] == rel else None
            i = bisect_right(node.keys, rel) - 1
            if i < 0:
                return None
            prefix += node.keys[i][:node.prefixes[i]]
            loc = node.children[i]
