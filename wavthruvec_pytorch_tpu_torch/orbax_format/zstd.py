"""A zstd decoder (RFC 8878) in numpy and the standard library: the codec
of an orbax checkpoint's OCDBT nodes and zarr chunks, read here without a
zstd binding (Python 3.12 has none, and the card's machine lists none).

It takes frames with and without a content size, single-segment or not,
several frames back to back and skippable frames; raw, RLE and compressed
blocks; literals raw, RLE, Huffman-coded in 1 or 4 streams, or treeless
(the previous block's table); Huffman weights given directly or
FSE-compressed; sequences in predefined, RLE, FSE and repeat modes, with
the repeat offsets; and the XXH64 content checksum where a frame's flag
asks for one.  Dictionaries are not taken: an orbax checkpoint uses none.
Anything malformed raises ``ZstdError``.

Speed.  A float array compresses to little more than Huffman-coded
literals: 128 KiB blocks of 4 streams each.  The streams are independent
once the frame's headers and tables are read, so ``decompress_many``
decodes in three passes: (1) walk every block of every frame in Python,
reading its headers, tables and sequences; (2) decode all the frames'
Huffman streams together, one symbol of every stream a numpy step, each
stream through its own table widened to an 11-bit lookup; (3) execute each
block's sequences over its literals.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50          # ... 0x184D2A5F, the high 28 bits
_BLOCK_MAX = 1 << 17
_HUF_BITS = 11                   # Huffman codes are at most 11 bits
_BATCH_BYTES = 64 << 20          # Huffman stream bytes a lockstep pass takes


class ZstdError(ValueError):
    """A zstd frame that does not decode."""


# --- bit readers -----------------------------------------------------------

class _BackBits:
    """A backward bitstream (RFC 8878 section 4.1): its last byte's highest
    set bit marks the end, and bits are read from there towards the first
    byte.  Reading past the start yields zeros and leaves ``p`` negative."""

    __slots__ = ("buf", "p")

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise ZstdError("bitstream without an end mark")
        self.buf = buf
        self.p = 8 * (len(buf) - 1) + buf[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.p - n
        self.p = p
        if p >= 0:
            v = int.from_bytes(self.buf[p >> 3:(p + n + 7) >> 3], "little") >> (p & 7)
            return v & ((1 << n) - 1)
        top = p + n
        if top <= 0:
            return 0
        return (int.from_bytes(self.buf[:(top + 7) >> 3], "little") & ((1 << top) - 1)) << -p


def _read_ncount(buf: bytes, pos: int, max_symbol: int, max_log: int):
    """An FSE table description at ``buf[pos:]`` (RFC 8878 4.1.1): returns
    (normalized counts, accuracy log, the position after it)."""
    bitpos = pos * 8

    def peek(n):
        b = bitpos >> 3
        return (int.from_bytes(buf[b:b + 4], "little") >> (bitpos & 7)) & ((1 << n) - 1)

    log = peek(4) + 5
    bitpos += 4
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    norm: List[int] = []
    prev0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if prev0:
            n0 = len(norm)
            while True:
                r = peek(2)
                bitpos += 2
                n0 += r
                if r != 3:
                    break
            if n0 > max_symbol:
                raise ZstdError("FSE table: zero run past the last symbol")
            norm.extend([0] * (n0 - len(norm)))
        mx = 2 * threshold - 1 - remaining
        v = peek(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            bitpos += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bitpos += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(norm) > max_symbol + 1:
        raise ZstdError("FSE table: counts do not sum to the table size")
    end = (bitpos + 7) >> 3
    if end > len(buf):
        raise ZstdError("FSE table past the end of its block")
    return norm, log, end


def _fse_table(norm: Sequence[int], log: int):
    """The decoding table of normalized counts ``norm`` (RFC 8878 4.1.1):
    (symbols, bits to read, baselines, log), one entry a state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(norm)
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE table: the spread does not close")
    nb, base = [0] * size, [0] * size
    for st in range(size):
        s = sym[st]
        n = nxt[s]
        nxt[s] = n + 1
        b = log - (n.bit_length() - 1)
        nb[st] = b
        base[st] = (n << b) - size
    return sym, nb, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


# --- sequences' codes (RFC 8878 3.1.1.3.2.1.1) -----------------------------

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_DEFAULT = _fse_table([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,
                          2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = _fse_table([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                          1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                          -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = _fse_table([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                          1, -1, -1, -1, -1, -1], 5)
# (default table, largest symbol, largest accuracy log) of LL, OF, ML
_SEQ_KINDS = ((_LL_DEFAULT, 35, 9), (_OF_DEFAULT, 31, 8), (_ML_DEFAULT, 52, 9))


# --- Huffman tables --------------------------------------------------------

def _huffman_weights_fse(data: bytes) -> List[int]:
    """Huffman weights compressed with FSE: two states over one backward
    bitstream, decoded in turn until a read overflows the stream."""
    norm, log, used = _read_ncount(data, 0, 255, 6)
    sym, nb, base, _ = _fse_table(norm, log)
    br = _BackBits(data[used:])
    s1, s2 = br.read(log), br.read(log)
    out: List[int] = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + br.read(nb[s1])
        if br.p < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + br.read(nb[s2])
        if br.p < 0:
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise ZstdError("Huffman weights: more than 255")
    return out


def _huffman_table(buf: bytes, pos: int) -> Tuple[np.ndarray, int]:
    """A Huffman tree description at ``buf[pos]`` (RFC 8878 4.2.1) as an
    11-bit lookup: entry ``v`` of the next 11 bits is ``symbol | bits << 8``.
    Returns (table, the position after the description)."""
    if pos >= len(buf):
        raise ZstdError("Huffman tree description past its block")
    head = buf[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        raw = buf[pos:pos + (n + 1) // 2]
        pos += (n + 1) // 2
        weights = [w for b in raw for w in (b >> 4, b & 15)][:n]
    else:
        weights = _huffman_weights_fse(buf[pos:pos + head])
        pos += head
    if pos > len(buf) or any(w > _HUF_BITS for w in weights):
        raise ZstdError("Huffman tree description malformed")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman tree without a symbol")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > _HUF_BITS:
        raise ZstdError("Huffman weights do not make a prefix code")
    weights.append(rest.bit_length())
    table = np.empty(1 << max_bits, np.uint16)
    at = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                span = 1 << (w - 1)
                table[at:at + span] = s | ((max_bits + 1 - w) << 8)
                at += span
    return np.repeat(table, 1 << (_HUF_BITS - max_bits)), pos


# --- pass 1: the blocks' headers, tables and sequences ---------------------

class _Frame:
    __slots__ = ("blocks", "checksum", "size")

    def __init__(self):
        self.blocks: list = []        # ("raw", bytes) | ("lit", literals key, sequences)
        self.checksum: Optional[int] = None
        self.size: Optional[int] = None


class _Pass1:
    """Walks frames, collecting each block's pieces; Huffman literals become
    jobs for ``_decode_streams`` whose results fill ``self.lits``."""

    def __init__(self):
        self.lits: List[Optional[bytes]] = []
        self.jobs: List[tuple] = []          # (lits index, [(stream, table, n)], size)

    def frames(self, data: bytes) -> List[_Frame]:
        out, pos = [], 0
        if not data:
            raise ZstdError("empty input")
        while pos < len(data):
            if len(data) - pos < 4:
                raise ZstdError("truncated frame")
            magic = struct.unpack_from("<I", data, pos)[0]
            if magic >> 4 == _SKIPPABLE >> 4:
                if len(data) - pos < 8:
                    raise ZstdError("truncated skippable frame")
                pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
                if pos > len(data):
                    raise ZstdError("truncated skippable frame")
                continue
            if magic != MAGIC:
                raise ZstdError(f"bad magic {magic:#010x} at byte {pos}")
            frame, pos = self._frame(data, pos + 4)
            out.append(frame)
        return out

    def _frame(self, data: bytes, pos: int) -> Tuple[_Frame, int]:
        if pos >= len(data):
            raise ZstdError("truncated frame header")
        fhd = data[pos]
        pos += 1
        fcs_flag, single, dict_flag = fhd >> 6, (fhd >> 5) & 1, fhd & 3
        has_checksum = (fhd >> 2) & 1
        if fhd & 0x08:
            raise ZstdError("reserved frame header bit set")
        if not single:
            pos += 1                              # the window descriptor
        dict_bytes = (0, 1, 2, 4)[dict_flag]
        if dict_bytes and int.from_bytes(data[pos:pos + dict_bytes], "little"):
            raise ZstdError("frames with a dictionary are not taken")
        pos += dict_bytes
        fcs_bytes = (1 if single else 0, 2, 4, 8)[fcs_flag]
        frame = _Frame()
        if fcs_bytes:
            size = int.from_bytes(data[pos:pos + fcs_bytes], "little")
            frame.size = size + 256 if fcs_bytes == 2 else size
        pos += fcs_bytes
        if pos > len(data):
            raise ZstdError("truncated frame header")
        st = {"huf": None, "tables": [None, None, None], "rep": [1, 4, 8]}
        while True:
            if pos + 3 > len(data):
                raise ZstdError("truncated block header")
            head = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, btype, bsize = head & 1, (head >> 1) & 3, head >> 3
            if btype == 1:                        # RLE: one byte, bsize times
                if pos >= len(data) or bsize > _BLOCK_MAX:
                    raise ZstdError("truncated RLE block")
                frame.blocks.append(("raw", data[pos:pos + 1] * bsize))
                pos += 1
            elif bsize > _BLOCK_MAX or pos + bsize > len(data):
                raise ZstdError(f"block of {bsize} bytes past the input or the limit")
            elif btype == 0:
                frame.blocks.append(("raw", data[pos:pos + bsize]))
                pos += bsize
            elif btype == 2:
                frame.blocks.append(self._compressed(data[pos:pos + bsize], st))
                pos += bsize
            else:
                raise ZstdError("reserved block type")
            if last:
                break
        if has_checksum:
            if pos + 4 > len(data):
                raise ZstdError("truncated content checksum")
            frame.checksum = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        return frame, pos

    def _compressed(self, blk: bytes, st: dict):
        key, pos = self._literals(blk, st)
        return ("lit", key, self._sequences(blk, pos, st))

    def _literals(self, blk: bytes, st: dict) -> Tuple[int, int]:
        b0 = blk[0]
        ltype, fmt = b0 & 3, (b0 >> 2) & 3
        key = len(self.lits)
        if ltype < 2:                             # raw or RLE
            if fmt in (0, 2):
                size, pos = b0 >> 3, 1
            elif fmt == 1:
                size, pos = (b0 >> 4) + (blk[1] << 4), 2
            else:
                size, pos = (b0 >> 4) + (blk[1] << 4) + (blk[2] << 12), 3
            if ltype == 0:
                if pos + size > len(blk):
                    raise ZstdError("raw literals past their block")
                self.lits.append(blk[pos:pos + size])
                return key, pos + size
            if pos >= len(blk):
                raise ZstdError("RLE literals past their block")
            self.lits.append(blk[pos:pos + 1] * size)
            return key, pos + 1
        nhead = (3, 3, 4, 5)[fmt]
        if nhead > len(blk):
            raise ZstdError("truncated literals header")
        v = int.from_bytes(blk[:nhead], "little")
        bits = (10, 10, 14, 18)[fmt]
        size = (v >> 4) & ((1 << bits) - 1)
        csize = (v >> (4 + bits)) & ((1 << bits) - 1)
        pos, end = nhead, nhead + csize
        if end > len(blk) or size > _BLOCK_MAX:
            raise ZstdError("compressed literals past their block")
        if ltype == 2:
            table, pos = _huffman_table(blk, pos)
            st["huf"] = table
        elif st["huf"] is None:
            raise ZstdError("treeless literals without a previous table")
        table = st["huf"]
        if fmt == 0:
            streams = [(blk[pos:end], size)]
        else:
            if pos + 6 > end:
                raise ZstdError("truncated jump table")
            s1, s2, s3 = struct.unpack_from("<HHH", blk, pos)
            pos += 6
            q = (size + 3) // 4
            if size < 6 or pos + s1 + s2 + s3 > end:
                raise ZstdError("jump table past the literals")
            cuts = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, end]
            streams = [(blk[cuts[i]:cuts[i + 1]], q if i < 3 else size - 3 * q)
                       for i in range(4)]
        self.lits.append(None)
        self.jobs.append((key, [(s, table, n) for s, n in streams], size))
        return key, end

    def _sequences(self, blk: bytes, pos: int, st: dict) -> List[Tuple[int, int, int]]:
        if pos >= len(blk):
            raise ZstdError("missing sequences section")
        b0 = blk[pos]
        if b0 == 0:
            if pos + 1 != len(blk):
                raise ZstdError("bytes after an empty sequences section")
            return []
        if b0 < 128:
            nseq, pos = b0, pos + 1
        elif b0 < 255:
            nseq, pos = ((b0 - 128) << 8) + blk[pos + 1], pos + 2
        else:
            nseq, pos = blk[pos + 1] + (blk[pos + 2] << 8) + 0x7F00, pos + 3
        modes = blk[pos]
        pos += 1
        if modes & 3:
            raise ZstdError("reserved bits set in the sequence modes")
        tables = st["tables"]
        for i, shift in enumerate((6, 4, 2)):       # LL, OF, ML
            mode = (modes >> shift) & 3
            default, max_symbol, max_log = _SEQ_KINDS[i]
            if mode == 0:
                tables[i] = default
            elif mode == 1:
                if blk[pos] > max_symbol:
                    raise ZstdError("RLE sequence symbol out of range")
                tables[i] = _rle_table(blk[pos])
                pos += 1
            elif mode == 2:
                norm, log, pos = _read_ncount(blk, pos, max_symbol, max_log)
                tables[i] = _fse_table(norm, log)
            elif tables[i] is None:
                raise ZstdError("repeat mode without a previous table")
        (ll_sym, ll_nb, ll_base, ll_log), (of_sym, of_nb, of_base, of_log), \
            (ml_sym, ml_nb, ml_base, ml_log) = tables
        br = _BackBits(blk[pos:])
        read = br.read
        s_ll, s_of, s_ml = read(ll_log), read(of_log), read(ml_log)
        rep = st["rep"]
        r0, r1, r2 = rep
        seqs = []
        for i in range(nseq):
            of_code, ml_code, ll_code = of_sym[s_of], ml_sym[s_ml], ll_sym[s_ll]
            if of_code > 31:
                raise ZstdError("offset code out of range")
            ofv = (1 << of_code) + read(of_code)
            ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
            ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
            if ofv > 3:
                r0, r1, r2 = ofv - 3, r0, r1
            else:
                idx = ofv if ll == 0 else ofv - 1
                if idx == 1:
                    r0, r1 = r1, r0
                elif idx == 2:
                    r0, r1, r2 = r2, r0, r1
                elif idx == 3:
                    r0, r1, r2 = r0 - 1, r0, r1
                if r0 <= 0:
                    raise ZstdError("repeat offset 0")
            seqs.append((ll, ml, r0))
            if i != nseq - 1:
                s_ll = ll_base[s_ll] + read(ll_nb[s_ll])
                s_ml = ml_base[s_ml] + read(ml_nb[s_ml])
                s_of = of_base[s_of] + read(of_nb[s_of])
        if br.p != 0:
            raise ZstdError("sequence bitstream not consumed exactly")
        st["rep"] = [r0, r1, r2]
        return seqs


# --- pass 2: every Huffman stream in lockstep ------------------------------

def _decode_streams(streams: List[Tuple[bytes, np.ndarray, int]]) -> List[np.ndarray]:
    """Decode Huffman streams (bytes, 11-bit table, symbols), all together:
    each numpy step reads one symbol of every stream not yet done."""
    out: List[Optional[np.ndarray]] = [None] * len(streams)
    order = sorted(range(len(streams)), key=lambda i: -streams[i][2])
    start = 0
    while start < len(order):
        stop, nbytes = start, 0
        while stop < len(order) and (stop == start or nbytes < _BATCH_BYTES):
            nbytes += len(streams[order[stop]][0]) + 2
            stop += 1
        _decode_batch([streams[i] for i in order[start:stop]], order[start:stop], out)
        start = stop
    return out


def _decode_batch(streams, ids, out) -> None:
    n = len(streams)
    lens = np.array([len(s) + 2 for s, _, _ in streams], np.int64)
    base = np.concatenate([[0], np.cumsum(lens)[:-1]])          # 2 zero bytes lead each
    buf = np.zeros(int(lens.sum()) + 3, np.uint8)
    bit_end = np.empty(n, np.int64)
    table_ids: Dict[int, int] = {}
    tables, toff = [], np.empty(n, np.int32)
    for i, (s, table, _) in enumerate(streams):
        if not s or s[-1] == 0:
            raise ZstdError("Huffman stream without an end mark")
        buf[base[i] + 2:base[i] + 2 + len(s)] = np.frombuffer(s, np.uint8)
        bit_end[i] = (base[i] + 2 + len(s) - 1) * 8 + s[-1].bit_length() - 1
        t = table_ids.setdefault(id(table), len(tables))
        if t == len(tables):
            tables.append(table)
        toff[i] = t << _HUF_BITS
    if int(bit_end.max()) >= 1 << 31:
        raise ZstdError("Huffman batch too large")
    # w[b]: the 32 bits from byte b up, an unaligned view of buf (no copy)
    w32 = np.ndarray((len(buf) - 3,), dtype="<u4", buffer=buf, strides=(1,))
    tab = np.concatenate(tables).astype(np.uint32)
    counts = np.array([c for _, _, c in streams], np.int64)      # descending
    maxn = int(counts[0])
    sym = np.empty((maxn, n), np.uint8)
    q = (bit_end - _HUF_BITS).astype(np.uint32)  # the lowest bit of each stream's next peek
    toff = toff.astype(np.uint32)
    b, sh = np.empty(n, np.uint32), np.empty(n, np.uint32)
    k = 0
    for na in range(n, 0, -1):                   # stretches where the first na streams run
        stop = int(counts[na - 1])
        if stop <= k:
            continue
        qa, ba, sa, ta = q[:na], b[:na], sh[:na], toff[:na]
        for k in range(k, stop):
            np.right_shift(qa, 3, out=ba)
            wa = w32[ba]
            np.bitwise_and(qa, 7, out=sa)
            np.right_shift(wa, sa, out=wa)
            np.bitwise_and(wa, (1 << _HUF_BITS) - 1, out=wa)
            np.add(wa, ta, out=wa)
            ea = tab[wa]
            sym[k, :na] = ea
            np.right_shift(ea, 8, out=ea)
            np.subtract(qa, ea, out=qa)
        k = stop
    if not np.array_equal(q.astype(np.int64) + _HUF_BITS, (base + 2) * 8):
        raise ZstdError("Huffman stream not consumed exactly")
    sym = np.ascontiguousarray(sym.T)
    for j, i in enumerate(ids):
        out[i] = sym[j, :counts[j]]


# --- pass 3 and the entry points -------------------------------------------

def _execute(lit: bytes, seqs, out: bytearray, frame_start: int) -> None:
    lp = 0
    for ll, ml, off in seqs:
        if ll:
            if lp + ll > len(lit):
                raise ZstdError("sequence takes more literals than there are")
            out += lit[lp:lp + ll]
            lp += ll
        start = len(out) - off
        if start < frame_start:
            raise ZstdError("match offset before the frame's start")
        if ml <= off:
            out += out[start:start + ml]
        else:
            chunk = bytes(out[start:])
            out += (chunk * (ml // off + 1))[:ml]
    out += lit[lp:]


def decompress_many(blobs: Sequence[bytes]) -> List[bytes]:
    """Decompress each of ``blobs`` (one or more zstd frames each), the
    Huffman streams of all of them in one lockstep pass."""
    p1 = _Pass1()
    parsed = [p1.frames(bytes(b)) for b in blobs]
    jobs = p1.jobs
    flat = [s for _, streams, _ in jobs for s in streams]
    decoded = iter(_decode_streams(flat))
    for key, streams, size in jobs:
        lit = b"".join(next(decoded).tobytes() for _ in streams)
        if len(lit) != size:
            raise ZstdError("literals of the wrong size")
        p1.lits[key] = lit
    result = []
    for frames in parsed:
        out = bytearray()
        for frame in frames:
            start = len(out)
            for block in frame.blocks:
                n0 = len(out)
                if block[0] == "raw":
                    out += block[1]
                else:
                    _execute(p1.lits[block[1]], block[2], out, start)
                if len(out) - n0 > _BLOCK_MAX:
                    raise ZstdError("block larger than 128 KiB")
            if frame.size is not None and len(out) - start != frame.size:
                raise ZstdError(f"frame of {len(out) - start} bytes, its header says "
                                f"{frame.size}")
            if frame.checksum is not None and \
                    xxh64(memoryview(out)[start:]) & 0xFFFFFFFF != frame.checksum:
                raise ZstdError("content checksum mismatch")
        result.append(bytes(out))
    return result


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data``."""
    return decompress_many([data])[0]


# --- XXH64 -----------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the zstd content checksum keeps its low 32 bits)."""
    data = bytes(data)
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64, (seed - _P1) & _M64]
        lanes = struct.unpack_from(f"<{n // 32 * 4}Q", data)
        v1, v2, v3, v4 = v
        for j in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[j])
            v2 = _round(v2, lanes[j + 1])
            v3 = _round(v3, lanes[j + 2])
            v4 = _round(v4, lanes[j + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for x in (v1, v2, v3, v4):
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        i = n // 32 * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= struct.unpack_from("<I", data, i)[0] * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= data[i] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)
