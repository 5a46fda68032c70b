"""Every image the JAX package reads, on its routes, against its decoders
(ROADMAP A9b): progressive JPEGs (cv2's and PIL's scripts, restart
intervals, 4:2:0/4:2:2/4:4:4/gray; the C++ Huffman decode against the
Python reference, the pixels against JAX's native libjpeg path at m = 8, 4,
2, 1), cut JPEGs (baseline and progressive, with libjpeg's interblock
smoothing) against the native path and ``cv2.imread``, CMYK and YCCK JPEGs,
Adam7 PNGs and the BMPs cv2 reads against ``cv2.imdecode``, the loader's
routes folder by folder (C5) and the server's, an arithmetic-coded JPEG on
every route and the modes no libjpeg reads, and the fixture tool's
re-codes.  The Python reference runs at <= 64 x 96, the C++
at <= 256 x 256."""

import io
import os
import struct
import zlib

import cv2
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from aihab_clip_tpu.data import load_folders as jax_load_folders
from aihab_clip_tpu.data import make_synthetic_cs_dataset as jax_make_synthetic
from aihab_clip_tpu.native import (native_bulk_decode_resize,
                                   native_decode_resize_mem)

from aihab_clip_tpu_torch.data import decode as D
from aihab_clip_tpu_torch.data import load_folders
from aihab_clip_tpu_torch.data.bulk_load import decode_files
from aihab_clip_tpu_torch.ops import jpeg as J
from aihab_clip_tpu_torch.tools import jpeg_fixtures as F
from torch_jpeg_batch import decode_batch

SAMPLING = {"420": 0x221111, "422": 0x211111, "444": 0x111111}


def _photo(h, w, seed=0):
    """A smooth image with noise: edges and flat areas, like a photo."""
    rng = np.random.default_rng(seed)
    x = rng.normal(128, 60, (h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    x += rng.normal(0, 10, x.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def _cv2_jpeg(img, progressive=True, sampling="420", rst=0, quality=90):
    return cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])[1].tobytes()


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img[:, :, ::-1]).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _gray_progressive(img):
    return cv2.imencode(".jpg", img[:, :, 0],
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()


def _progressive_files(h, w, seed):
    """name -> progressive JPEG: cv2's script at three samplings, with a
    restart interval, PIL's script and a gray one."""
    img = _photo(h, w, seed)
    files = {f"cv2 {s}": _cv2_jpeg(img, sampling=s) for s in SAMPLING}
    files["cv2 restarts"] = _cv2_jpeg(img, rst=2)
    files["pil"] = _pil_jpeg(img, progressive=True, quality=85)
    files["gray"] = _gray_progressive(img)
    return files


def _imread(tmp_path, data: bytes):
    p = tmp_path / "probe.jpg"
    p.write_bytes(data)
    img = cv2.imread(str(p))
    return None if img is None else img[:, :, ::-1]


def _assert_cpp_equals_python(data: bytes, rules=("2.1",)):
    for rule in rules:
        ref = D.jpeg_coefficients(data, smooth=rule)
        for s in (8, 4, 2, 1):
            got = J.coefficients(data, s, rule)
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                assert np.array_equal(a, J.pack_blocks(b, s)), (rule, s)


@pytest.mark.parametrize("shape", [(64, 96), (37, 53), (17, 3)])
def test_progressive_cpp_equals_python(shape):
    """csrc/jpeg_entropy.cpp's coefficients of progressive files are the
    Python reference's (DC and AC first and refine scans, EOB runs,
    correction bits, restarts), packed for every IDCT size; and the
    reference decodes them to cv2.imdecode's pixels."""
    for name, data in _progressive_files(*shape, seed=shape[0]).items():
        assert D.parse_jpeg(data).progressive, name
        _assert_cpp_equals_python(data)
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert np.array_equal(D.decode_image(data), ref[:, :, ::-1]), name


@pytest.mark.parametrize("m,prescale_min", [(8, 0), (4, 128), (2, 64),
                                            (1, 32)])
def test_progressive_native_bit_for_bit(m, prescale_min):
    """The fast decode of progressive files (C++ + J1/J2's plain versions)
    equals JAX's native libjpeg path at each DCT scale, bit for bit, and
    the Python pipeline."""
    blobs = list(_progressive_files(256, 256, seed=m).values())
    dim = 64
    got, ok = decode_batch(blobs, dim, "native", prescale_min)
    assert ok.all()
    for i, data in enumerate(blobs):
        h = D.parse_jpeg(data)
        assert D.prescale_factor((h.width, h.height), prescale_min) == m
        native = native_decode_resize_mem(data, dim, prescale_min)
        assert np.array_equal(got[i].numpy(), native), i
    small = _progressive_files(48, 48, seed=9)["cv2 420"]
    ref = D.resize_bilinear(D.decode_jpeg(small, m), 24, 24)
    assert np.array_equal(ref, native_decode_resize_mem(
        small, 24, {8: 0, 4: 24, 2: 12, 1: 6}[m]))


def _gray_from_blocks(blocks: np.ndarray, q: np.ndarray, rows: int) -> bytes:
    """A gray baseline JPEG of ``rows`` rows of blocks: quantized blocks
    [n, 64] (natural order; DC steps within 11 bits, AC within 10) under
    the 16-bit table ``q`` [64], with the standard Huffman tables."""
    from aihab_clip_tpu_torch.data.encode import (_AC_LUMA, _DC_LUMA,
                                                  _BitWriter, _code_table,
                                                  _encode_block, _segment)

    writer, pred = _BitWriter(), 0
    dc, ac = _code_table(_DC_LUMA), _code_table(_AC_LUMA)
    for blk in blocks:
        zz = blk[D._ZIGZAG].tolist()
        _encode_block(writer, zz, pred, dc, ac)
        pred = zz[0]
    cols = len(blocks) // rows
    size = (8 * rows).to_bytes(2, "big") + (8 * cols).to_bytes(2, "big")
    return b"".join([
        b"\xff\xd8",
        _segment(0xDB, bytes([0x10]) + q[D._ZIGZAG].astype(">u2").tobytes()),
        _segment(0xC0, bytes([8]) + size + bytes([1, 1, 0x11, 0])),
        _segment(0xC4, bytes([0x00] + _DC_LUMA[0] + _DC_LUMA[1])),
        _segment(0xC4, bytes([0x10] + _AC_LUMA[0] + _AC_LUMA[1])),
        _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0])), writer.flush(),
        b"\xff\xd9"])


def _simd_corner_blocks(rng, n: int) -> np.ndarray:
    """Quantized blocks [n, 64] of five kinds in turn: the DC alone, row 0
    alone, row 0 with column 4 (the 4x4's zero test reads it, its IDCT
    does not), dense, and sparse; DCs of 900-2047 (which a 16-bit table
    takes past 8192 in the SIMD lanes)."""
    b = np.zeros((n, 64), np.int64)
    keep = [np.arange(1), np.arange(8), np.r_[0:8, 12:64:8], np.arange(64),
            np.flatnonzero(rng.random(64) < 0.15)]
    for i in range(n):
        k = keep[i % 5]
        b[i, k] = rng.integers(-1023, 1024, len(k))
    dc = rng.integers(900, 2048, n) * rng.choice([-1, 1], n)
    b[:, 0] = np.where(np.arange(n) % 2, dc, b[:, 0])
    b[:, 0] = np.cumsum(np.clip(np.diff(b[:, 0], prepend=0), -2047, 2047))
    return b


GRAY_REDUCED = {8: cv2.IMREAD_GRAYSCALE, 4: cv2.IMREAD_REDUCED_GRAYSCALE_2,
                2: cv2.IMREAD_REDUCED_GRAYSCALE_4,
                1: cv2.IMREAD_REDUCED_GRAYSCALE_8}


@pytest.mark.parametrize("seed", range(3))
def test_idct_simd_forms_match_native_and_cv2(seed):
    """Blocks that reach libjpeg-turbo's SIMD IDCT corners under 16-bit
    tables: blocks with no AC rows whose dequantized DC passes 8192 (the
    islow and 4x4 take them through a shortcut that wraps the DC x 4 in
    16 bits, where the full pass saturates), a column-4 term that the 4x4
    tests for and never reads, and sums past int32 (4x4, 2x2).
    data/decode.py, and the fast decode (C++ + J1/J2's plain versions) on
    the native route, equal JAX's native path and cv2.imdecode bit for bit
    at m = 8, 4, 2, 1."""
    rng = np.random.default_rng(seed)
    rows = 8
    blocks = _simd_corner_blocks(rng, rows * rows)
    q = rng.choice([1, 2, 9, 16, 30, 99, 255, 4099, 32768, 65535],
                   64).astype(np.uint16)
    q[0] = (9, 30, 4099)[seed]
    dq0 = ((blocks[:, 0] * int(q[0]) + 32768) & 0xFFFF) - 32768
    shortcut = ~blocks[:, 8:].any(1) & (np.abs(dq0) >= 8192)
    assert shortcut.sum() >= 5
    data = _gray_from_blocks(blocks, q, rows)
    for m in (8, 4, 2, 1):
        size = rows * m
        native = native_decode_resize_mem(data, size, 0 if m == 8 else size)
        ref = D.decode_jpeg(data, m)
        assert ref.shape == (size, size, 3) and np.array_equal(ref, native), m
        cv = cv2.imdecode(np.frombuffer(data, np.uint8), GRAY_REDUCED[m])
        assert np.array_equal(cv, ref[:, :, 0]), m
        got = J.decode_blobs([data], size, "native",
                                0 if m == 8 else size, device="cpu")
        assert np.array_equal(got[0], native), m


def _cut_points(data: bytes, n: int):
    start = data.index(b"\xff\xda")
    return sorted({start + (len(data) - start) * k // n
                   for k in range(1, n)} | {len(data) - 2})


@pytest.mark.parametrize("kind", ["baseline", "baseline restarts",
                                  "progressive", "progressive restarts",
                                  "progressive 444"])
def test_cut_jpeg_matches_native_and_imread(kind, tmp_path):
    """A JPEG cut inside its scans (C6): the native route decodes it bit
    for bit with JAX's native path (libjpeg's zero bits, the rest of the
    scan left as it is, a restart marker clearing it; the cut progressive
    file's interblock smoothing of libjpeg-turbo 2.1), the imread route
    with cv2.imread (cv2's libjpeg-turbo 3.1 smoothing), and the imdecode
    route drops it as cv2.imdecode does; the C++ coefficients are the
    Python reference's."""
    img = _photo(48, 48, seed=len(kind))
    data = {"baseline": _cv2_jpeg(img, False),
            "baseline restarts": _cv2_jpeg(img, False, rst=1),
            "progressive": _cv2_jpeg(img),
            "progressive restarts": _cv2_jpeg(img, rst=2),
            "progressive 444": _cv2_jpeg(img, sampling="444")}[kind]
    for cut_at in _cut_points(data, 9):
        cut = data[:cut_at]
        if native_decode_resize_mem(cut, 24, 0) is None:   # in a segment
            with pytest.raises(D.DecodeError):
                D.parse_jpeg(cut)
            continue
        assert not D.parse_jpeg(cut).complete
        _assert_cpp_equals_python(cut, ("2.1", "3.1"))
        for pm in (0, 24, 12):
            native = native_decode_resize_mem(cut, 24, pm)
            got = J.decode_blobs([cut], 24, "native", pm,
                                    device="cpu")
            assert native is not None and np.array_equal(got[0], native), \
                (cut_at, pm)
        full = D.decode_image(cut)
        assert np.array_equal(full, _imread(tmp_path, cut)), cut_at
        got = J.decode_blobs([cut], 48, "imread", device="cpu")
        assert np.array_equal(got[0], D.resize_bilinear(full, 48, 48))
        assert cv2.imdecode(np.frombuffer(cut, np.uint8), 1) is None
        assert J.decode_blobs([cut], 48, "imdecode",
                              device="cpu") == [None]


@pytest.mark.parametrize("size", [24, 32])
def test_cut_narrow_progressive_matches_native_and_imread(size, tmp_path):
    """The smoothing's edges: a cut progressive 4:2:0 photo of two iMCU
    rows whose chroma is two blocks wide, where libjpeg-turbo 2.1 keeps
    the first column's DC two columns to the right and cv2's 3.1 picks
    other rows two up; both agree bit for bit, and the C++ with Python."""
    data = _cv2_jpeg(_photo(size, size, size))
    for cut_at in _cut_points(data, 7):
        cut = data[:cut_at]
        native = native_decode_resize_mem(cut, size, 0)
        if native is None:
            continue
        _assert_cpp_equals_python(cut, ("2.1", "3.1"))
        got = J.decode_blobs([cut], size, "native", device="cpu")
        assert np.array_equal(got[0], native), cut_at
        assert np.array_equal(D.decode_image(cut), _imread(tmp_path, cut))


def test_cut_segments_after_the_scans_as_libjpeg():
    """Every prefix of a progressive file past its first scan: where
    libjpeg refuses it (a cut SOS, a DHT cut in its counts) the parse is a
    DecodeError, where it decodes it (a DHT cut in its symbols, between
    segments) the port decodes it to the native path's pixels."""
    data = _progressive_files(24, 40, seed=3)["cv2 420"]
    refused = decoded = 0
    for cut_at in range(data.index(b"\xff\xda") + 14, len(data), 3):
        cut = data[:cut_at]
        native = native_decode_resize_mem(cut, 16, 0)
        try:
            header = D.parse_jpeg(cut)
        except D.DecodeError:
            assert native is None, cut_at
            refused += 1
            continue
        assert native is not None, cut_at
        got = J.decode_blobs([cut], 16, "native", device="cpu")
        assert np.array_equal(got[0], native), cut_at
        decoded += header.progressive
    assert refused and decoded


def _adobe_files():
    """name -> four-component JPEG: PIL's CMYK, the fixture tool's CMYK and
    YCCK (4:4:4 and 2x2 on Y and K), baseline and progressive."""
    buf = io.BytesIO()
    Image.fromarray(_photo(40, 56, 4)).convert("CMYK").save(buf, "JPEG",
                                                            quality=90)
    files = {"pil cmyk": buf.getvalue()}
    planes = F.adobe_planes(33, 50, seed=2)
    for t, name in ((0, "cmyk"), (2, "ycck")):
        for samp in ((1, 1), (2, 2)):
            base = F.encode_adobe(planes, t, 90, samp)
            files[f"{name} {samp}"] = base
            files[f"{name} {samp} progressive"] = F.progressive_recode(base)
    return files


def test_cmyk_ycck_against_cv2():
    """CMYK and YCCK JPEGs (Adobe transform 0 and 2, baseline and
    progressive): libjpeg's YCCK -> CMYK and cv2's CMYK -> BGR bit for bit
    with cv2.imdecode before any resize; the imread route's fast decode
    (J2's CMYK instance, plain) equals it resized; JAX's native path
    refuses them, and so does the port's native route."""
    files = _adobe_files()
    blobs = list(files.values())
    got = J.decode_blobs(blobs, 20, "imread", device="cpu")
    native = J.decode_blobs(blobs, 20, "native", 40, device="cpu")
    for (name, data), img, nat in zip(files.items(), got, native):
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        full = D.decode_image(data)
        assert np.array_equal(full, ref[:, :, ::-1]), name
        assert np.array_equal(img, D.resize_bilinear(full, 20, 20)), name
        assert native_decode_resize_mem(data, 20, 0) is None and nat is None
        _assert_cpp_equals_python(data)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _png_rows(px, depth):
    h = px.shape[0]
    if depth == 16:
        return px.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    flat = px.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per)))
    shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
    return (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _png_filter(rows, bpp, seed):
    """Scanlines filtered with types 0-4 in turn (from ``seed``)."""
    out, prior = [], np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = (y + seed) % 5
        left = np.r_[np.zeros(bpp, np.int32), row[:-bpp]][:len(row)]
        upleft = np.r_[np.zeros(bpp, np.int32), prior[:-bpp]][:len(row)]
        if f == 4:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        else:
            pred = [0, left, prior, (left + prior) >> 1][f]
        out.append(bytes([f]) + bytes(((row - pred) & 255).astype(np.uint8)))
        prior = row
    return b"".join(out)


def _png(px, depth, ctype, palette=None, interlace=1, seed=0) -> bytes:
    """Samples [h, w, c] (palette indices for colour type 3) -> PNG bytes,
    Adam7-interlaced or not."""
    h, w, c = px.shape
    bpp = max(1, c * depth // 8)
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)) if interlace \
        else ((0, 0, 1, 1),)
    raw = b"".join(_png_filter(_png_rows(px[y::dy, x::dx], depth), bpp, seed)
                   for x, y, dx, dy in passes
                   if px[y::dy, x::dx].size)
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + _png_chunk(b"IDAT", zlib.compress(raw)) \
        + _png_chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype,depths,channels", [
    (0, (1, 2, 4, 8, 16), 1), (2, (8, 16), 3), (3, (1, 2, 4, 8), 1),
    (4, (8, 16), 2), (6, (8, 16), 4)])
def test_adam7_png_against_cv2(ctype, depths, channels):
    """Adam7 PNGs of every colour type and depth that the plain path takes
    (every filter type, passes that are empty at small sizes) decode bit
    for bit with cv2.imdecode, as their plain twins do."""
    rng = np.random.default_rng(ctype)
    for h, w in ((1, 1), (3, 5), (9, 7), (17, 12)):
        for depth in depths:
            px = rng.integers(0, 1 << depth, (h, w, channels))
            pal = (rng.integers(0, 256, (1 << depth, 3)) if ctype == 3
                   else None)
            for interlace in (1, 0):
                data = _png(px, depth, ctype, pal, interlace, seed=h)
                ref = cv2.imdecode(np.frombuffer(data, np.uint8),
                                   cv2.IMREAD_COLOR)
                assert np.array_equal(D.decode_image(data), ref[:, :, ::-1]), \
                    (h, w, depth, interlace)


def _bmp(width, height, bpp, pixels, comp=0, palette=None, masks=None,
         os2=False, clrused=None, topdown=False) -> bytes:
    if os2:
        hdr = struct.pack("<IHHHH", 12, width, height, 1, bpp)
        pal = b"" if palette is None else palette.astype(np.uint8).tobytes()
    else:
        n = 0 if palette is None else len(palette)
        hdr = struct.pack("<IiiHHIIiiII", 40, width,
                          -height if topdown else height, 1, bpp, comp,
                          len(pixels), 2835, 2835,
                          n if clrused is None else clrused, 0)
        pal = b"" if palette is None else np.concatenate(
            [palette, np.zeros((len(palette), 1))], 1).astype(np.uint8) \
            .tobytes()
        if masks is not None:
            pal += struct.pack("<III", *masks)
    off = 14 + len(hdr) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + hdr \
        + pal + pixels


def _bmp_rows(arr) -> bytes:
    pitch = (arr.shape[1] + 3) & -4
    return np.pad(arr, ((0, 0), (0, pitch - arr.shape[1]))).tobytes()


def _bmp_packed(idx, bpp) -> bytes:
    return _bmp_rows(_png_rows(idx[:, :, None], bpp))


def _bmp_cases():
    """name -> BMP bytes: palettes, OS/2, 16-bit, 32-bit bit fields, RLE8
    and RLE4 with deltas, early ends and runs past a row."""
    rng = np.random.default_rng(5)
    cases = {}
    for h, w in ((3, 5), (9, 7), (17, 33)):
        for bpp in (1, 4, 8):
            pal = rng.integers(0, 256, (1 << bpp, 3))
            idx = rng.integers(0, 1 << bpp, (h, w))
            cases[f"pal{bpp} {w}"] = _bmp(w, h, bpp, _bmp_packed(idx, bpp),
                                          0, pal)
            cases[f"pal{bpp} top-down {w}"] = _bmp(
                w, h, bpp, _bmp_packed(idx, bpp), 0, pal, topdown=True)
            cases[f"os2 pal{bpp} {w}"] = _bmp(w, h, bpp, _bmp_packed(idx, bpp),
                                              0, pal, os2=True)
        cases[f"clrused {w}"] = _bmp(w, h, 8, _bmp_packed(
            rng.integers(0, 5, (h, w)), 8), 0, rng.integers(0, 256, (3, 3)),
            clrused=3)
        px = rng.integers(0, 65536, (h, w)).astype("<u2").view(np.uint8) \
            .reshape(h, -1)
        cases[f"555 {w}"] = _bmp(w, h, 16, _bmp_rows(px))
        cases[f"555 fields {w}"] = _bmp(w, h, 16, _bmp_rows(px), 3,
                                        masks=(0x7C00, 0x3E0, 0x1F))
        cases[f"565 fields {w}"] = _bmp(w, h, 16, _bmp_rows(px), 3,
                                        masks=(0xF800, 0x7E0, 0x1F))
        cases[f"444 fields {w}"] = _bmp(w, h, 16, _bmp_rows(px), 3,
                                        masks=(0xF00, 0xF0, 0xF))
        px32 = rng.integers(0, 256, (h, 4 * w)).astype(np.uint8)
        cases[f"32 fields {w}"] = _bmp(w, h, 32, _bmp_rows(px32), 3,
                                       masks=(0xFF0000, 0xFF00, 0xFF))
        cases[f"os2 24 {w}"] = _bmp(w, h, 24, _bmp_rows(
            rng.integers(0, 256, (h, 3 * w)).astype(np.uint8)), os2=True)
    pal = rng.integers(0, 256, (256, 3))
    rle8 = {"rle8": [3, 5, 0, 3, 1, 2, 3, 0, 0, 0, 6, 9, 0, 0, 2, 7, 0, 2,
                     2, 1, 1, 8, 0, 1],
            "rle8 early end": [6, 5, 0, 0, 3, 7, 0, 1],
            "rle8 past a row": [7, 5, 0, 1],
            "rle8 run over a row": [6, 5, 0, 0, 6, 6, 0, 0, 2, 1, 0, 1],
            "rle8 line end first": [0, 0, 6, 6, 0, 0, 2, 1, 0, 1],
            "rle8 cut": [2, 5, 0, 0]}
    for name, codes in rle8.items():
        cases[name] = _bmp(6, 4, 8, bytes(codes), 1, pal)
    rle4 = {"rle4": [2, 0x12, 0, 3, 0x34, 0x50, 0, 2, 1, 1, 0, 0, 6, 0x56,
                     0, 0, 6, 0x78, 0, 0, 1, 1, 0, 1],
            "rle4 early end": [6, 0x12, 0, 0, 0, 1],
            "rle4 past a row": [7, 0x12, 0, 1]}
    for name, codes in rle4.items():
        cases[name] = _bmp(6, 4, 4, bytes(codes), 2, pal[:16])
    cases["cut pixels"] = _bmp(8, 8, 24, bytes(100))
    return cases


def test_bmp_variants_against_cv2():
    """The BMPs cv2 reads (OS/2's header, 1/4/8-bit palettes, RLE8 and
    RLE4, 16-bit 555 and 565 by BI_BITFIELDS, 32-bit BI_BITFIELDS) decode
    bit for bit with cv2.imdecode; where cv2 returns None, so does the
    port."""
    for name, data in _bmp_cases().items():
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        try:
            got = D.decode_image(data)
        except D.DecodeError:
            got = None
        if ref is None:
            assert got is None, name
        else:
            assert np.array_equal(got, ref[:, :, ::-1]), name


def _tree(tmp_path, size=200):
    tree = jax_make_synthetic(tmp_path / "tree", n_train_per_class=3,
                              n_test_per_class=1, image_size=size)
    return tree["dataset_paths"][0], tree["index_file_names"][0]


def _rename_to_png(folder, index_name, victim):
    """``victim`` (a labelled JPEG) rewritten as a PNG under .png, its
    index row renamed with it."""
    path = os.path.join(folder, victim)
    png = victim.rsplit(".", 1)[0] + ".png"
    cv2.imwrite(os.path.join(folder, png), cv2.imread(path))
    os.remove(path)
    csv = os.path.join(folder, index_name)
    df = pd.read_csv(csv)
    df["file"] = df["file"].replace(victim, png)
    df.to_csv(csv, index=False)


def test_c5_mixed_folder_takes_cv2_route(tmp_path):
    """C5's repro: a tree of 200 px photos, one labelled JPEG rewritten as
    a PNG.  At 40 px with the prescale on, JAX decodes that folder with
    cv2.imread at full scale; so does the port: the same file list, the
    pixels within one level of JAX's cv2.resize (bit for bit with the
    port's cv2.imread pixels resized), where the prescale would have
    differed by tens of levels.  An all-JPEG folder takes the native path
    bit for bit."""
    folder, index_name = _tree(tmp_path)
    jax_all = jax_load_folders([folder], [index_name], 40, prescale=True)
    mine_all = load_folders([folder], [index_name], 40, prescale=True,
                            device="cpu")
    assert mine_all.file_names == jax_all.file_names
    assert np.array_equal(mine_all.images, jax_all.images)
    _rename_to_png(folder, index_name, jax_all.file_names[1])
    jax_mixed = jax_load_folders([folder], [index_name], 40, prescale=True)
    mine = load_folders([folder], [index_name], 40, prescale=True,
                        device="cpu")
    assert mine.file_names == jax_mixed.file_names
    diff = np.abs(mine.images.astype(int) - jax_mixed.images.astype(int))
    assert diff.max() <= 1
    for name, img in zip(mine.file_names, mine.images):
        data = open(os.path.join(folder, name), "rb").read()
        assert np.array_equal(img, D.resize_bilinear(D.decode_image(data),
                                                     40, 40)), name
    prescaled = [D.resize_bilinear(D.decode_jpeg(open(os.path.join(
        folder, n), "rb").read(), 2), 40, 40)
        for n in mine.file_names if n.endswith(".jpg")]
    jpegs = [img for n, img in zip(mine.file_names, mine.images)
             if n.endswith(".jpg")]
    assert max(np.abs(a.astype(int) - b).max()
               for a, b in zip(prescaled, jpegs)) > 1


def test_cmyk_in_a_jpeg_folder_is_dropped_as_jax_drops_it(tmp_path,
                                                          capsys):
    """A CMYK .jpg in an all-JPEG RGB folder: JAX's native path refuses it
    and its loader drops it with a warning; the port drops the same file.
    The BGR route (cv2.imread) keeps it, as JAX's does."""
    folder, index_name = _tree(tmp_path, 64)
    names = load_folders([folder], [index_name], 32, device="cpu").file_names
    victim = names[2]
    buf = io.BytesIO()
    Image.fromarray(_photo(64, 64, 1)).convert("CMYK").save(buf, "JPEG")
    with open(os.path.join(folder, victim), "wb") as f:
        f.write(buf.getvalue())
    jax = jax_load_folders([folder], [index_name], 32)
    mine = load_folders([folder], [index_name], 32, device="cpu")
    assert victim not in jax.file_names and mine.file_names == jax.file_names
    assert f"Could not read image {victim}" in capsys.readouterr().out
    bgr = load_folders([folder], [index_name], 32, channel_order="bgr",
                       device="cpu")
    jax_bgr = jax_load_folders([folder], [index_name], 32,
                               channel_order="bgr")
    assert victim in bgr.file_names and bgr.file_names == jax_bgr.file_names
    assert np.abs(bgr.images.astype(int) - jax_bgr.images).max() <= 1


def test_cut_and_progressive_files_kept_by_the_loader(tmp_path):
    """A progressive JPEG and a JPEG cut to 60% in an all-JPEG folder: JAX's
    native loader keeps both, and the port's decodes them to its pixels
    (decode_files on the native route, bit for bit)."""
    folder, index_name = _tree(tmp_path, 96)
    names = sorted(n for n in os.listdir(folder) if n.endswith(".jpg"))
    prog = F.progressive_recode(open(os.path.join(folder, names[0]),
                                     "rb").read())
    with open(os.path.join(folder, names[0]), "wb") as f:
        f.write(prog)
    data = open(os.path.join(folder, names[1]), "rb").read()
    with open(os.path.join(folder, names[1]), "wb") as f:
        f.write(data[:int(len(data) * 0.6)])
    paths = [os.path.join(folder, n) for n in names]
    native, ok = native_bulk_decode_resize(paths, 40, 1, prescale_min=80)
    assert ok.all()
    got = decode_files(paths, 40, prescale=True, device="cpu")
    for i, img in enumerate(got):
        assert np.array_equal(img, native[i]), names[i]


def _a9c_blobs():
    """name -> (JPEG in a mode of ROADMAP A9c, whether JAX decodes it):
    the frame marker of a baseline file changed to arithmetic coding
    (which native and cv2 decode, the Huffman data read as arithmetic
    codes until a bad one), lossless, hierarchical, and 12-bit precision
    (which neither reads)."""
    base = _cv2_jpeg(_photo(24, 24, 2), False)
    sof = base.index(b"\xff\xc0")

    def variant(marker=None, precision=None):
        b = bytearray(base)
        if marker:
            b[sof + 1] = marker
        if precision:
            b[sof + 4] = precision
        return bytes(b)

    return {"arithmetic": (variant(0xC9), True),
            "lossless": (variant(0xC3), False),
            "hierarchical": (variant(0xC5), False),
            "12-bit": (variant(precision=12), False)}


@pytest.mark.parametrize("route", ["native", "imread", "imdecode", "serve"])
def test_a9c_raises_only_where_jax_decodes(route):
    """An arithmetic-coded JPEG decodes on every route as JAX's decoder
    there does: native and serve as ``native_decode_resize_mem`` at the
    prescale, bit for bit; imread and imdecode as cv2 at full scale, bit
    for bit, then the native path's resize.  Lossless, hierarchical and
    12-bit ones are None on every route (neither reads them), as JAX's
    decode returns."""
    for name, (data, jax_decodes) in _a9c_blobs().items():
        native = native_decode_resize_mem(data, 16, 32)
        full = cv2.imdecode(np.frombuffer(data, np.uint8), 1)
        assert (native is not None) == (full is not None) == jax_decodes
        got = J.decode_blobs(
            [data], 16, route, 32 if route in ("native", "serve") else 0,
            device="cpu")
        if not jax_decodes:
            assert got == [None], name
        elif route in ("native", "serve"):
            assert np.array_equal(got[0], native), name
        else:
            assert np.array_equal(D.decode_image(data), full[:, :, ::-1])
            assert np.array_equal(got[0], D.resize_bilinear(
                full[:, :, ::-1], 16, 16)), name


def test_server_route_as_jax_decode_bytes(monkeypatch):
    """The serve route (JAX's decode_bytes): a cut JPEG takes the native
    prescale (JAX keeps it), a CMYK one cv2.imdecode at full scale, a
    bare-SOI file without the JPEG magic cv2.imdecode; with
    AIHAB_SERVE_DECODE=cv2 the cut one is None, as cv2.imdecode returns."""
    big = _cv2_jpeg(_photo(160, 160, 6), False)
    cut = big[:int(len(big) * 0.6)]
    cmyk = _adobe_files()["cmyk (1, 1)"]
    dim = 24
    got = J.decode_blobs([cut, cmyk], dim, "serve", 2 * dim, device="cpu")
    assert np.array_equal(got[0], native_decode_resize_mem(cut, dim, 2 * dim))
    assert np.array_equal(got[1], D.resize_bilinear(D.decode_image(cmyk),
                                                    dim, dim))
    imdecoded = J.decode_blobs([cut, cmyk], dim, "imdecode",
                                  device="cpu")
    assert imdecoded[0] is None and np.array_equal(imdecoded[1], got[1])


def test_fixture_recode_decodes_to_the_baseline(tmp_path):
    """The fixture tool's progressive re-code (libjpeg's default script,
    optimal tables) holds the baseline file's coefficients: the Python and
    C++ decoders give them back exactly, and cv2 and JAX's native path
    decode it to the baseline's pixels at every scale."""
    for i, (h, w, samp) in enumerate([(64, 96, "420"), (37, 53, "422"),
                                      (40, 40, "444")]):
        base = _cv2_jpeg(_photo(h, w, i), False, sampling=samp, quality=95)
        prog = F.progressive_recode(base)
        header = D.parse_jpeg(prog)
        assert header.progressive and len(header.scans) == 10
        ref = D.jpeg_coefficients(base)
        for a, b, c in zip(ref, D.jpeg_coefficients(prog, header),
                           J.coefficients(prog)):
            assert np.array_equal(a, b) and np.array_equal(a, c)
        assert np.array_equal(
            cv2.imdecode(np.frombuffer(prog, np.uint8), 1),
            cv2.imdecode(np.frombuffer(base, np.uint8), 1))
        for pm in (0, 16, 8):
            assert np.array_equal(native_decode_resize_mem(prog, 16, pm),
                                  native_decode_resize_mem(base, 16, pm))
    gray = cv2.imencode(".jpg", _photo(32, 48, 7)[:, :, 0])[1].tobytes()
    prog = F.progressive_recode(gray)
    assert np.array_equal(D.jpeg_coefficients(prog)[0],
                          D.jpeg_coefficients(gray)[0])
