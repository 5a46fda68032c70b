"""blosc1 frames of LZ4 blocks: the codec of the JAX package's zarr cache
store (``TensorStoreStore``: compressor ``blosc``, cname ``lz4``, clevel 5,
shuffle -1).

  * ``decompress(frame)`` and ``compress(data, typesize)``: the C++ codec,
    ``csrc/blosc_lz4.cpp`` (a host source, ``ops/_build.host_library``),
    blocks on threads of their own.  Every entry point goes through it; a
    build that fails raises (nothing falls back).
  * ``decompress_plain`` and ``compress_plain``, with ``lz4_decode_plain``
    and ``lz4_encode_plain``: the same codec in Python, for the tests.

``compress`` picks what ``shuffle: -1`` picks: the byte shuffle for items
wider than one byte, the bit shuffle for bytes.  Its frames are not
c-blosc's byte for byte, but c-blosc (and so tensorstore) decodes them to
the same array.  A malformed frame raises ``ValueError`` naming the input.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from ._build import host_library

HEADER = 16
BLOCK = 1 << 18
_ERRORS = {1: "bad header", 2: "size does not match its header",
           3: "not an LZ4 frame (only blosc's lz4 codec is read)",
           4: "bad block table", 5: "corrupt stream"}


def _threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _buffer(data) -> np.ndarray:
    return np.frombuffer(memoryview(data).cast("B"), np.uint8)


def header(frame) -> dict:
    """The 16-byte blosc1 header's fields."""
    b = bytes(memoryview(frame)[:HEADER])
    if len(b) < HEADER:
        raise ValueError("blosc frame shorter than its header")
    version, versionlz, flags, typesize, nbytes, blocksize, cbytes = \
        struct.unpack("<BBBBIII", b)
    return dict(version=version, versionlz=versionlz, flags=flags,
                typesize=typesize, nbytes=nbytes, blocksize=blocksize,
                cbytes=cbytes)


def decompress(frame, name: str = "blosc data") -> memoryview:
    """A blosc1 frame decoded through the C++ codec."""
    src = _buffer(frame)
    out = np.empty(header(src)["nbytes"], np.uint8)
    rc = host_library("blosc_lz4").aihab_blosc_decompress(
        src.ctypes.data, len(src), out.ctypes.data, len(out), _threads())
    if rc != 0:
        raise ValueError(f"{name}: corrupt blosc frame: "
                         f"{_ERRORS.get(rc, rc)}")
    return memoryview(out)


def compress(data, typesize: int) -> bytes:
    """``data`` (a multiple of ``typesize`` bytes) as a blosc1 frame."""
    src = _buffer(data)
    n = len(src)
    cap = HEADER + n + 8 * (n // 8192 + 1)
    out = np.empty(cap, np.uint8)
    size = ctypes.c_longlong()
    rc = host_library("blosc_lz4").aihab_blosc_compress(
        src.ctypes.data, n, int(typesize), out.ctypes.data,
        ctypes.byref(size), _threads())
    if rc != 0:
        raise ValueError(f"blosc compress: {n} bytes of {typesize}-byte "
                         "items cannot be framed")
    return out[:size.value].tobytes()


# ---- the plain codec (tests only) ------------------------------------------

def lz4_decode_plain(src: bytes, n_out: int) -> bytes:
    out = bytearray()
    ip, end = 0, len(src)
    if end == 0:
        if n_out:
            raise ValueError("empty LZ4 block")
        return b""
    while True:
        token = src[ip]
        ip += 1
        ll = token >> 4
        if ll == 15:
            while True:
                b = src[ip]
                ip += 1
                ll += b
                if b != 255:
                    break
        out += src[ip:ip + ll]
        ip += ll
        if ip >= end:
            break
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if offset == 0 or offset > len(out):
            raise ValueError("LZ4 offset past the output")
        ml = token & 15
        if ml == 15:
            while True:
                b = src[ip]
                ip += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(out) - offset
        for k in range(ml):
            out.append(out[start + k])
    if len(out) != n_out:
        raise ValueError("LZ4 block decodes to the wrong size")
    return bytes(out)


def _put_len(out: bytearray, n: int) -> None:
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)


def lz4_encode_plain(src: bytes) -> bytes:
    """The C++ encoder's greedy parse (the same hash, the same matches, the
    same step over data that does not compress)."""
    n = len(src)
    out = bytearray()
    table = {}
    anchor = ip = 0

    def emit(lit_end, offset, ml):
        ll = lit_end - anchor
        t = min(ll, 15) << 4
        if ml:
            t |= min(ml - 4, 15)
        out.append(t)
        if ll >= 15:
            _put_len(out, ll - 15)
        out.extend(src[anchor:lit_end])
        if ml:
            out.extend((offset & 255, offset >> 8))
            if ml - 4 >= 15:
                _put_len(out, ml - 4 - 15)

    if n >= 13:
        mflimit, mlimit = n - 12, n - 5
        misses = 0
        while ip < mflimit:
            seq = src[ip:ip + 4]
            h = ((int.from_bytes(seq, "little") * 2654435761) & 0xFFFFFFFF) \
                >> 16
            ref = table.get(h)
            table[h] = ip
            if ref is not None and ip - ref <= 65535 and \
                    src[ref:ref + 4] == seq:
                ml = 4
                while ip + ml < mlimit and src[ref + ml] == src[ip + ml]:
                    ml += 1
                emit(ip, ip - ref, ml)
                ip += ml
                anchor = ip
                misses = 0
            else:
                ip += 1 + (misses >> 6)
                misses += 1
    emit(n, 0, 0)
    return bytes(out)


def _byte_shuffle(a: np.ndarray, ts: int, inverse: bool) -> np.ndarray:
    items = len(a) // ts
    body = a[:items * ts]
    if inverse:
        body = body.reshape(ts, items).T.reshape(-1)
    else:
        body = body.reshape(items, ts).T.reshape(-1)
    return np.concatenate([body, a[items * ts:]])


def _bit_shuffle(a: np.ndarray, ts: int, inverse: bool) -> np.ndarray:
    items = len(a) // ts
    if items % 8:
        return a.copy()
    body = a[:items * ts]
    if inverse:
        # rows (byte j, bit k) of items / 8 bytes -> bits [item, byte, bit]
        bits = np.unpackbits(body.reshape(ts, 8, items // 8), axis=2,
                             bitorder="little")  # [ts, 8, items]
        bits = bits.transpose(2, 0, 1)           # [items, ts, 8]
        body = np.packbits(bits, axis=2, bitorder="little").reshape(-1)
    else:
        bits = np.unpackbits(body.reshape(items, ts, 1), axis=2,
                             bitorder="little")  # [items, ts, 8]
        bits = bits.transpose(1, 2, 0)           # [ts, 8, items]
        body = np.packbits(bits, axis=2, bitorder="little").reshape(-1)
    return np.concatenate([body, a[items * ts:]])


def decompress_plain(frame, name: str = "blosc data") -> bytes:
    """``decompress`` in Python."""
    src = bytes(frame)
    h = header(src)
    flags, ts, nbytes = h["flags"], h["typesize"], h["nbytes"]
    blocksize = h["blocksize"]
    if flags & 0x2:
        return src[HEADER:HEADER + nbytes]
    if nbytes == 0:
        return b""
    if flags >> 5 != 1:
        raise ValueError(f"{name}: corrupt blosc frame: {_ERRORS[3]}")
    nblocks = -(-nbytes // blocksize)
    out = []
    for b in range(nblocks):
        bsize = min(blocksize, nbytes - b * blocksize)
        leftover = bsize < blocksize
        at = struct.unpack_from("<I", src, HEADER + 4 * b)[0]
        split = (not flags & 0x10 and ts <= 16 and blocksize // ts >= 128
                 and not leftover)
        nsplit = ts if split else 1
        neblock = bsize // nsplit
        parts = []
        for _ in range(nsplit):
            cs = struct.unpack_from("<I", src, at)[0]
            at += 4
            chunk = src[at:at + cs]
            at += cs
            parts.append(chunk if cs == neblock
                         else lz4_decode_plain(chunk, neblock))
        block = np.frombuffer(b"".join(parts), np.uint8)
        if flags & 0x1:
            if ts > 1:
                block = _byte_shuffle(block, ts, inverse=True)
        elif flags & 0x4:
            block = _bit_shuffle(block, ts, inverse=True)
        out.append(block.tobytes())
    return b"".join(out)


def compress_plain(data, typesize: int) -> bytes:
    """``compress`` in Python: the same frame, byte for byte."""
    src = np.frombuffer(bytes(data), np.uint8)
    ts = int(typesize)
    n = len(src)
    block = max(BLOCK - BLOCK % (8 * ts), 8 * ts)
    if n < block:
        block = n if n else 1
    flags = 0x20 | 0x10 | (0x1 if ts > 1 else 0x4)

    def framed(fl, body_len):
        return struct.pack("<BBBBIII", 2, 1, fl, ts, n, block,
                           HEADER + body_len)

    if n == 0:
        return framed(flags | 0x2, 0)
    blocks = []
    for b in range(-(-n // block)):
        piece = src[b * block:(b + 1) * block]
        sh = (_byte_shuffle(piece, ts, False) if ts > 1
              else _bit_shuffle(piece, ts, False)).tobytes()
        enc = lz4_encode_plain(sh)
        if len(enc) >= len(sh):
            enc = sh
        blocks.append(struct.pack("<I", len(enc)) + enc)
    total = HEADER + 4 * len(blocks) + sum(len(x) for x in blocks)
    if total >= HEADER + n:
        return framed(flags | 0x2, n) + src.tobytes()
    starts, at = [], HEADER + 4 * len(blocks)
    for x in blocks:
        starts.append(at)
        at += len(x)
    return (struct.pack("<BBBBIII", 2, 1, flags, ts, n, block, at)
            + struct.pack(f"<{len(starts)}I", *starts) + b"".join(blocks))
