"""zstd (RFC 8878): the codec of the JAX package's orbax checkpoints.

orbax writes each array as a zarr v2 chunk with compressor ``zstd`` inside
an OCDBT database whose b-tree nodes are zstd-compressed too
(``utils/ocdbt.py``, ``utils/orbax.py``).  The card's machine has no zstd
binding, so the port carries its own codec:

  * ``decompress(data)``: the C++ decoder, ``csrc/zstd_decode.cpp`` (a host
    source, built with the host compiler by ``ops/_build.host_library``):
    every frame libzstd writes, concatenated and skippable frames, the XXH64
    checksum checked.  Every entry point decodes through it; a build that
    fails raises (nothing falls back).
  * ``decompress_plain(data)``: the same decoder in Python, for the tests.
  * ``compress_raw(data)``: a frame of raw blocks only.  Such a frame is
    valid zstd (libzstd and tensorstore read it); a compressing encoder is
    not part of the port.

A frame that names a dictionary, a checksum mismatch and malformed input
raise ``ValueError`` naming the input (``name=``).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from ._build import host_library

MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17


def _lib():
    return host_library("zstd_decode")


def decompress(data, name: str = "zstd data") -> memoryview:
    """Every frame of ``data`` decoded through the C++ decoder: straight
    into a buffer of the size the frames declare, else through the
    decoder's own growing one."""
    buf = data if isinstance(data, bytes) else bytes(data)
    lib = _lib()
    err = ctypes.create_string_buffer(256)
    n = lib.aihab_zstd_content_size(buf, len(buf))
    if n >= 0:
        out = np.empty(n, np.uint8)
        rc = lib.aihab_zstd_decode_into(buf, len(buf), out.ctypes.data, n,
                                        err, len(err))
    else:
        handle, size = ctypes.c_void_p(), ctypes.c_longlong()
        rc = lib.aihab_zstd_decode(buf, len(buf), ctypes.byref(handle),
                                   ctypes.byref(size), err, len(err))
        if rc == 0:
            out = np.empty(size.value, np.uint8)
            lib.aihab_zstd_take(handle, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"{name}: corrupt zstd data: "
                         f"{err.value.decode(errors='replace')}")
    return memoryview(out)


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` through the C++ library."""
    buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    out = ctypes.c_ulonglong()
    _lib().aihab_xxh64(buf.ctypes.data, len(buf), seed, ctypes.byref(out))
    return out.value


def compress_raw(data, checksum: bool = True) -> bytes:
    """A zstd frame holding ``data`` in raw blocks (no compression), with
    its content size, and its XXH64 checksum (through the C++ library) when
    ``checksum``."""
    data = memoryview(data).cast("B")
    n = len(data)
    # the frame content size in 8 bytes (flag 3), single segment: no window
    out = [struct.pack("<IB", MAGIC, 0xE0 | (4 if checksum else 0)),
           struct.pack("<Q", n)]
    if n == 0:
        out.append(bytes((1, 0, 0)))  # one empty last raw block
    for at in range(0, n, BLOCK_MAX):
        size = min(BLOCK_MAX, n - at)
        last = at + size >= n
        header = (size << 3) | int(last)
        out.append(header.to_bytes(3, "little"))
        out.append(data[at:at + size])
    if checksum:
        out.append(struct.pack("<I", xxh64(data) & 0xFFFFFFFF))
    return b"".join(out)


# ---- the plain decoder (tests only) ---------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, \
    1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, v):
    acc = (acc + v * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64_plain(data, seed: int = 0) -> int:
    """XXH64 in Python (numpy for the 32-byte stripes)."""
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        stripes = n // 32
        lanes = np.frombuffer(data[:stripes * 32], "<u8").reshape(-1, 4)
        with np.errstate(over="ignore"):
            acc = np.array(v, np.uint64)
            p2, p1 = np.uint64(_P2), np.uint64(_P1)
            for row in lanes:
                acc = acc + row * p2
                acc = (acc << np.uint64(31)) | (acc >> np.uint64(33))
                acc = acc * p1
        v = [int(x) for x in acc]
        p = stripes * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for x in v:
            h ^= _round(0, x)
            h = (h * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


class _Corrupt(Exception):
    pass


def _fail(msg):
    raise _Corrupt(msg)


class _Forward:
    def __init__(self, data: bytes):
        self.v = int.from_bytes(data, "little")
        self.n = len(data) * 8
        self.pos = 0

    def peek(self, nb):
        return (self.v >> self.pos) & ((1 << nb) - 1)

    def read(self, nb):
        v = self.peek(nb)
        self.pos += nb
        if self.pos > self.n:
            _fail("FSE table description runs past its data")
        return v


class _Backward:
    def __init__(self, data: bytes):
        if not data:
            _fail("empty bitstream")
        if data[-1] == 0:
            _fail("bitstream without its end marker")
        self.v = int.from_bytes(data, "little")
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def peek(self, nb):
        if self.pos >= nb:
            return (self.v >> (self.pos - nb)) & ((1 << nb) - 1)
        if self.pos <= 0:
            return 0
        return (self.v & ((1 << self.pos) - 1)) << (nb - self.pos)

    def read(self, nb):
        if nb == 0:
            return 0
        v = self.peek(nb)
        self.pos -= nb
        return v


def _build_fse(norm, log):
    size = 1 << log
    sym = [0] * size
    nxt = [0] * len(norm)
    high = size - 1
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
        _fail("FSE table: bad distribution")
    table = []
    for u in range(size):
        s = sym[u]
        ns = nxt[s]
        nxt[s] += 1
        nb = log - (ns.bit_length() - 1)
        table.append((s, nb, (ns << nb) - size))
    return log, table


def _read_fse(data: bytes, max_sym, max_log):
    br = _Forward(data)
    log = br.read(4) + 5
    if log > max_log:
        _fail("FSE table: accuracy log too large")
    norm = []
    remaining, threshold, nb = (1 << log) + 1, 1 << log, log + 1
    while remaining > 1 and len(norm) <= max_sym:
        mx = (2 * threshold - 1) - remaining
        v = br.peek(nb)
        if (v & (threshold - 1)) < mx:
            value = v & (threshold - 1)
            br.read(nb - 1)
        else:
            value = v & (2 * threshold - 1)
            if value >= threshold:
                value -= mx
            br.read(nb)
        count = value - 1
        remaining -= abs(count)
        norm.append(count)
        if count == 0:
            while True:
                rep = br.read(2)
                norm.extend([0] * rep)
                if len(norm) > max_sym + 1:
                    _fail("FSE table: too many symbols")
                if rep != 3:
                    break
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1 or len(norm) > max_sym + 1:
        _fail("FSE table: bad counts")
    return _build_fse(norm, log), (br.pos + 7) // 8


def _read_huffman(data: bytes):
    if not data:
        _fail("Huffman tree: no header")
    hb = data[0]
    if hb >= 128:
        nw = hb - 127
        nbytes = (nw + 1) // 2
        if 1 + nbytes > len(data):
            _fail("Huffman tree: weights past the block")
        weights = [(data[1 + i // 2] & 15) if i & 1 else data[1 + i // 2] >> 4
                   for i in range(nw)]
        used = 1 + nbytes
    else:
        if hb == 0 or 1 + hb > len(data):
            _fail("Huffman tree: bad size")
        q = data[1:1 + hb]
        (log, table), hdr = _read_fse(q, 255, 6)
        if hdr >= hb:
            _fail("Huffman tree: no weight stream")
        bs = _Backward(q[hdr:])
        s1, s2 = bs.read(log), bs.read(log)
        weights = []
        while True:
            if len(weights) > 253:
                _fail("Huffman tree: too many weights")
            sym, nbits, base = table[s1]
            weights.append(sym)
            s1 = base + bs.read(nbits)
            if bs.pos < 0:
                weights.append(table[s2][0])
                break
            sym, nbits, base = table[s2]
            weights.append(sym)
            s2 = base + bs.read(nbits)
            if bs.pos < 0:
                weights.append(table[s1][0])
                break
        used = 1 + hb
    if any(w > 11 for w in weights):
        _fail("Huffman tree: weight too large")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        _fail("Huffman tree: no weights")
    maxbits = total.bit_length()
    rest = (1 << maxbits) - total
    if rest & (rest - 1):
        _fail("Huffman tree: weights do not complete")
    weights.append(rest.bit_length())
    if maxbits > 11 or len(weights) > 256:
        _fail("Huffman tree: bad weights")
    sym, nbits = [], []
    for w in range(1, maxbits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                sym.extend([s] * (1 << (w - 1)))
                nbits.extend([maxbits + 1 - w] * (1 << (w - 1)))
    return (maxbits, sym, nbits), used


def _huffman_stream(huf, data: bytes, count: int) -> bytearray:
    maxbits, sym, nbits = huf
    bs = _Backward(data)
    out = bytearray(count)
    for i in range(count):
        idx = bs.peek(maxbits)
        out[i] = sym[idx]
        bs.pos -= nbits[idx]
    if bs.pos != 0:
        _fail("Huffman stream not consumed exactly")
    return out


_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]


def _seq_table(prev, mode, data: bytes, dflt, dflt_log, max_sym, max_log):
    if mode == 0:
        return _build_fse(dflt, dflt_log), 0
    if mode == 1:
        if not data:
            _fail("sequences: RLE table past the block")
        if data[0] > max_sym:
            _fail("sequences: RLE symbol out of range")
        return (0, [(data[0], 0, 0)]), 1
    if mode == 2:
        return _read_fse(data, max_sym, max_log)
    if prev is None:
        _fail("sequences: repeat mode without a table")
    return prev, 0


def _decode_block(st, p: bytes, out: bytearray, frame_start: int):
    n = len(p)
    if n < 1:
        _fail("compressed block: empty")
    ltype, sf = p[0] & 3, (p[0] >> 2) & 3
    csize, streams = 0, 1
    if ltype < 2:
        if sf in (0, 2):
            regen, hdr = p[0] >> 3, 1
        elif sf == 1:
            if n < 2:
                _fail("literals header past the block")
            regen, hdr = (p[0] >> 4) + (p[1] << 4), 2
        else:
            if n < 3:
                _fail("literals header past the block")
            regen, hdr = (p[0] >> 4) + (p[1] << 4) + (p[2] << 12), 3
    else:
        streams = 1 if sf == 0 else 4
        hdr = 3 if sf < 2 else (4 if sf == 2 else 5)
        if n < hdr:
            _fail("literals header past the block")
        h = int.from_bytes(p[:hdr], "little")
        bits = 10 if sf < 2 else (14 if sf == 2 else 18)
        regen = (h >> 4) & ((1 << bits) - 1)
        csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    if regen > BLOCK_MAX:
        _fail("literals larger than a block")
    at = hdr
    if ltype == 0:
        if at + regen > n:
            _fail("raw literals past the block")
        lit = bytes(p[at:at + regen])
        at += regen
    elif ltype == 1:
        if at + 1 > n:
            _fail("RLE literals past the block")
        lit = bytes([p[at]]) * regen
        at += 1
    else:
        if at + csize > n:
            _fail("compressed literals past the block")
        q = p[at:at + csize]
        if ltype == 2:
            st["huf"], used = _read_huffman(q)
            q = q[used:]
        elif st["huf"] is None:
            _fail("treeless literals without an earlier tree")
        if streams == 1:
            lit = bytes(_huffman_stream(st["huf"], q, regen))
        else:
            if len(q) < 6:
                _fail("four literal streams: no jump table")
            s1, s2, s3 = struct.unpack("<HHH", q[:6])
            if 6 + s1 + s2 + s3 > len(q):
                _fail("four literal streams: bad sizes")
            seg = (regen + 3) // 4
            if 3 * seg > regen:
                _fail("four literal streams: too few literals")
            d = q[6:]
            cuts = [0, s1, s1 + s2, s1 + s2 + s3, len(d)]
            counts = [seg, seg, seg, regen - 3 * seg]
            lit = b"".join(bytes(_huffman_stream(
                st["huf"], d[cuts[i]:cuts[i + 1]], counts[i]))
                for i in range(4))
        at += csize
    if at >= n:
        _fail("sequences section missing")
    b0 = p[at]
    if b0 < 128:
        nseq, at = b0, at + 1
    elif b0 < 255:
        if at + 2 > n:
            _fail("sequences header past the block")
        nseq, at = ((b0 - 128) << 8) + p[at + 1], at + 2
    else:
        if at + 3 > n:
            _fail("sequences header past the block")
        nseq, at = p[at + 1] + (p[at + 2] << 8) + 0x7F00, at + 3
    if nseq == 0:
        if at != n:
            _fail("bytes after an empty sequences section")
        out += lit
        return
    if at >= n:
        _fail("sequences modes past the block")
    modes = p[at]
    at += 1
    if modes & 3:
        _fail("sequences: reserved mode bits set")
    st["ll"], k = _seq_table(st["ll"], (modes >> 6) & 3, p[at:], _LL_DEFAULT,
                             6, 35, 9)
    at += k
    st["of"], k = _seq_table(st["of"], (modes >> 4) & 3, p[at:], _OF_DEFAULT,
                             5, 31, 8)
    at += k
    st["ml"], k = _seq_table(st["ml"], (modes >> 2) & 3, p[at:], _ML_DEFAULT,
                             6, 52, 9)
    at += k
    if at >= n:
        _fail("sequences bitstream missing")
    bs = _Backward(p[at:])
    (lll, llt), (ofl, oft), (mll, mlt) = st["ll"], st["of"], st["ml"]
    sll, sof, sml = bs.read(lll), bs.read(ofl), bs.read(mll)
    rep = st["rep"]
    lp = 0
    for i in range(nseq):
        lsym, lnb, lbase = llt[sll]
        osym, onb, obase = oft[sof]
        msym, mnb, mbase = mlt[sml]
        if osym > 31:
            _fail("sequences: offset code too large")
        if lsym > 35 or msym > 52:
            _fail("sequences: bad length code")
        ofv = (1 << osym) + bs.read(osym)
        ml = _ML_BASE[msym] + bs.read(_ML_BITS[msym])
        ll = _LL_BASE[lsym] + bs.read(_LL_BITS[lsym])
        if ofv > 3:
            offset = ofv - 3
            rep[:] = [offset, rep[0], rep[1]]
        else:
            idx = ofv - 1 + (1 if ll == 0 else 0)
            if idx == 0:
                offset = rep[0]
            else:
                offset = rep[0] - 1 if idx == 3 else rep[idx]
                if offset == 0:
                    _fail("sequences: zero repeat offset")
                if idx == 1:
                    rep[:] = [offset, rep[0], rep[2]]
                else:
                    rep[:] = [offset, rep[0], rep[1]]
        if i + 1 < nseq:
            sll = lbase + bs.read(lnb)
            sml = mbase + bs.read(mnb)
            sof = obase + bs.read(onb)
        if bs.pos < 0:
            _fail("sequences bitstream overrun")
        if lp + ll > len(lit):
            _fail("sequences: literals overrun")
        out += lit[lp:lp + ll]
        lp += ll
        if offset == 0 or offset > len(out) - frame_start:
            _fail("sequences: offset past the output")
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            for k in range(ml):
                out.append(out[start + k])
    if bs.pos != 0:
        _fail("sequences bitstream not consumed exactly")
    out += lit[lp:]


def _decode_frame(p: bytes, at0: int, out: bytearray) -> int:
    n = len(p)
    if n - at0 < 6:
        _fail("frame header cut")
    fhd = p[at0 + 4]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    checksum, did_flag = (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        _fail("frame header: reserved bit set")
    at = at0 + 5
    if not single:
        at += 1  # the window descriptor (the whole output is kept)
    did_size = (0, 1, 2, 4)[did_flag]
    fcs_size = (1 if single else 0) if fcs_flag == 0 else 1 << fcs_flag
    if at + did_size + fcs_size > n:
        _fail("frame header cut")
    if int.from_bytes(p[at:at + did_size], "little"):
        _fail("frame names a dictionary (not supported)")
    at += did_size
    fcs: Optional[int] = None
    if fcs_size:
        fcs = int.from_bytes(p[at:at + fcs_size], "little")
        fcs += 256 if fcs_size == 2 else 0
    at += fcs_size
    start = len(out)
    st = {"huf": None, "ll": None, "of": None, "ml": None, "rep": [1, 4, 8]}
    while True:
        if at + 3 > n:
            _fail("block header cut")
        bh = int.from_bytes(p[at:at + 3], "little")
        at += 3
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 3:
            _fail("reserved block type")
        if size > BLOCK_MAX:
            _fail("block larger than 128 KiB")
        if btype == 0:
            if at + size > n:
                _fail("raw block cut")
            out += p[at:at + size]
            at += size
        elif btype == 1:
            if at + 1 > n:
                _fail("RLE block cut")
            out += bytes([p[at]]) * size
            at += 1
        else:
            if at + size > n:
                _fail("compressed block cut")
            before = len(out)
            _decode_block(st, p[at:at + size], out, start)
            if len(out) - before > BLOCK_MAX:
                _fail("block decodes past 128 KiB")
            at += size
        if last:
            break
    if fcs is not None and len(out) - start != fcs:
        _fail("frame content size does not match")
    if checksum:
        if at + 4 > n:
            _fail("checksum cut")
        want = int.from_bytes(p[at:at + 4], "little")
        if want != xxh64_plain(out[start:]) & 0xFFFFFFFF:
            _fail("checksum mismatch")
        at += 4
    return at


def decompress_plain(data, name: str = "zstd data") -> bytes:
    """``decompress`` in Python (for the tests)."""
    p = bytes(data)
    out = bytearray()
    try:
        if not p:
            _fail("no frame")
        at = 0
        while at < len(p):
            if len(p) - at < 4:
                _fail("trailing bytes after the last frame")
            magic = int.from_bytes(p[at:at + 4], "little")
            if magic & 0xFFFFFFF0 == 0x184D2A50:
                if len(p) - at < 8:
                    _fail("skippable frame cut")
                size = int.from_bytes(p[at + 4:at + 8], "little")
                if size > len(p) - at - 8:
                    _fail("skippable frame cut")
                at += 8 + size
            elif magic == MAGIC:
                at = _decode_frame(p, at, out)
            else:
                _fail("bad magic number")
    except _Corrupt as e:
        raise ValueError(f"{name}: corrupt zstd data: {e}") from None
    return bytes(out)
