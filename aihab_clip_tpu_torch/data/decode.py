"""Image decode and resize on the host, in numpy (the counterpart of
``cv2.imread`` + ``cv2.resize`` in ``aihab_clip_tpu/data/bulk_load.py:91-100``
and of the libjpeg decode + bilinear resize of its native path,
``native/image_pipeline.cpp``).  This module is the reference of the fast
decode (``ops/jpeg.py``): its header parser serves both, its Huffman decode
and pixel stage are what the C++ entropy decoder and the card's kernels are
held against.

  * **Baseline JPEG** (SOF0/SOF1, Huffman, 8-bit): libjpeg's integer "islow"
    IDCT (``jidctint.c``), h2v1/h1v2/h2v2 "fancy" (triangular) chroma
    upsampling with libjpeg's edge rows and biases, its fixed-point YCbCr ->
    RGB tables, restart markers, grayscale and Adobe/RGB JPEGs.  This is the
    arithmetic libjpeg-turbo runs (its SIMD kernels are bit-exact with these
    C routines), so the pixels are libjpeg's.
  * **DCT-domain prescale** (the native path's ``prescale_min``): a JPEG
    decodes at m/8, m in {1, 2, 4}, through libjpeg's reduced IDCTs
    (``jidctred.c``: 1x1, 2x2, 4x4), with ``jdmaster.c``'s per-component
    scaled sizes (chroma scaled up by its IDCT where the sampling factors
    allow, so a 4:2:0 photo needs no upsampling below m = 8) and
    ``jdsample.c``'s rule that fancy upsampling is off at m = 1.
  * **PNG**: zlib + the five scanline filters, bit depths 1-16 (16-bit keeps
    the high byte, as ``cv2.imread(IMREAD_COLOR)``), gray, RGB, palette,
    alpha dropped.
  * **BMP**: uncompressed (BI_RGB) 24 and 32 bit, bottom-up and top-down
    (32 bit drops its fourth byte, as ``cv2.imread`` does).
  * **EXIF orientation** (JPEG APP1) is applied as ``cv2.imread`` does.
  * **Resize**: bilinear with ``cv2.INTER_LINEAR``'s half-pixel centres in
    the fixed point of the native path (11-bit weights, 22-bit rounding),
    which equals that path bit for bit and cv2 within one level.

Progressive, arithmetic-coded, lossless, 12-bit and CMYK JPEGs, Adam7 PNGs
and compressed or palette BMPs raise ``NotImplementedError`` naming ROADMAP
A9b.  The Huffman decode here is pure Python (seconds per megapixel): the
reference, not the production path.
"""

from __future__ import annotations

import array
import dataclasses
import re
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# the pixels this module produces; part of the decoded-array cache key
DECODE_RULE = "aihab_clip_tpu_torch.decode/2:islow,jidctred,fancy,linear11"

_A9B = ("ROADMAP A9b (progressive, arithmetic, 12-bit and CMYK JPEGs, Adam7 "
        "PNGs, compressed BMPs)")


class DecodeError(ValueError):
    """The bytes are not a readable image (corrupt or truncated header)."""


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# zigzag position -> natural (row-major) index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    dtype=np.int64)
_ZZ = _ZIGZAG.tolist()

_SOF_UNSUPPORTED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic progressive",
    0xCB: "arithmetic lossless", 0xCD: "arithmetic differential",
    0xCE: "arithmetic differential progressive",
    0xCF: "arithmetic differential lossless"}

# the marker that ends an entropy-coded segment: 0xFF followed by anything
# but a stuffed zero, a fill byte or a restart marker
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")


def _check_huffman(counts: bytes, n_symbols: int) -> None:
    """Refuse a DHT table whose codes outrun its symbols or 16 bits."""
    code, k = 0, 0
    for length in range(1, 17):
        n = counts[length - 1]
        if k + n > n_symbols:
            raise DecodeError("Huffman table: more codes than symbols")
        if n and (code + n) << (16 - length) > 65536:
            raise DecodeError("Huffman table: code overflow")
        code, k = (code + n) << 1, k + n


def _build_lut(spec: bytes) -> List[int]:
    """A table spec (16 counts, then the symbols) -> a 16-bit lookup: next
    16 bits -> (code length << 8) | symbol (0: no code)."""
    counts, symbols = spec[:16], spec[16:]
    _check_huffman(counts, len(symbols))
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            lut[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return lut


def _parse_exif_orientation(payload: bytes) -> int:
    """APP1 'Exif\\0\\0' payload -> orientation tag 1-8 (1 when absent)."""
    tiff = payload[6:]
    if len(tiff) < 8:
        return 1
    if tiff[:2] == b"II":
        end = "<"
    elif tiff[:2] == b"MM":
        end = ">"
    else:
        return 1
    try:
        ifd = struct.unpack(end + "I", tiff[4:8])[0]
        (n,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
        for i in range(n):
            off = ifd + 2 + 12 * i
            tag, typ, cnt = struct.unpack(end + "HHI", tiff[off:off + 8])
            if tag == 0x0112 and typ == 3 and cnt >= 1:
                (val,) = struct.unpack(end + "H", tiff[off + 8:off + 10])
                return val if 1 <= val <= 8 else 1
    except struct.error:
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 -> the upright image (``cv2``'s ExifTransform:
    2 mirror, 3 rotate 180, 4 flip, 5 transpose, 6 transpose + mirror,
    7 transpose + rotate 180, 8 transpose + flip)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "coef", "dc", "ac")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


@dataclasses.dataclass
class JpegScan:
    """One scan: its components (indices into ``JpegHeader.comps``), their
    DC and AC table specs (16 counts, then the symbols), the entropy-coded
    bytes ``data[start:end]`` and the restart interval in force."""

    comps: List[int]
    dc: List[bytes]
    ac: List[bytes]
    start: int
    end: int
    restart: int


@dataclasses.dataclass
class JpegHeader:
    """What a baseline JPEG's markers say: the frame, the components
    (``_Component``: cid, sampling h and v, table tq; ``bw`` x ``bh``
    blocks, MCU-padded), quantization tables (int64 [8, 8], natural order),
    the scans, the EXIF orientation and the colour transform ("ycc", "rgb"
    or "gray")."""

    width: int
    height: int
    comps: List[_Component]
    qt: Dict[int, np.ndarray]
    scans: List[JpegScan]
    orientation: int
    color: str

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.comps)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.comps)


def _u16(data: bytes, i: int) -> int:
    return (data[i] << 8) | data[i + 1]


def jpeg_size(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from a JPEG's frame header, or None."""
    if data[:2] != b"\xff\xd8":
        return None
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = _u16(data, pos + 2)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 9 > len(data):
                return None
            return _u16(data, pos + 7), _u16(data, pos + 5)
        pos += 2 + length
    return None


def parse_jpeg(data: bytes) -> JpegHeader:
    """Walk a baseline JPEG's markers (the entropy-coded data is skipped,
    not decoded).  Raises ``DecodeError`` for a file that is no image (a
    segment cut short included) and ``NotImplementedError`` (A9b) for one
    this package does not decode."""
    try:
        return _parse_jpeg(data)
    except DecodeError:
        raise
    except (IndexError, ValueError) as e:   # a segment shorter than its kind
        raise DecodeError(f"corrupt JPEG marker segment ({e})") from e


def _parse_jpeg(data: bytes) -> JpegHeader:
    if data[:2] != b"\xff\xd8":
        raise DecodeError("not a JPEG (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    dc_specs: Dict[int, bytes] = {}
    ac_specs: Dict[int, bytes] = {}
    comps: List[_Component] = []
    scans: List[JpegScan] = []
    frame = None
    restart = 0
    orientation = 1
    saw_jfif = False
    adobe_transform = None
    pos = 2
    n = len(data)
    eoi = False
    while pos < n:
        if data[pos] != 0xFF:
            raise DecodeError(f"expected a marker at byte {pos}")
        if pos + 1 >= n:
            raise DecodeError("truncated marker")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:          # EOI
            eoi = True
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if pos + 4 > n:
            raise DecodeError("truncated marker segment")
        length = _u16(data, pos + 2)
        seg = data[pos + 4:pos + 2 + length]
        body_end = pos + 2 + length
        if marker == 0xE0 and seg[:5] == b"JFIF\x00":
            saw_jfif = True
        elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00":
            orientation = _parse_exif_orientation(seg)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDB:        # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8)
                    i += 65
                if len(vals) != 64:
                    raise DecodeError("truncated quantization table")
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals.astype(np.int64)
                qt[tq] = table.reshape(8, 8)
        elif marker == 0xC4:        # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                if len(counts) < 16:
                    raise DecodeError("truncated Huffman table")
                total = sum(counts)
                spec = seg[i + 1:i + 17 + total]
                _check_huffman(counts, len(spec) - 16)
                (ac_specs if tc else dc_specs)[th] = spec
                i += 17 + total
        elif marker == 0xDD:        # DRI
            restart = _u16(seg, 0)
        elif marker in (0xC0, 0xC1):
            if seg[0] != 8:
                raise NotImplementedError(
                    f"{seg[0]}-bit JPEG is not decoded: {_A9B}")
            height, width, nf = _u16(seg, 1), _u16(seg, 3), seg[5]
            if height == 0 or width == 0:
                raise DecodeError("JPEG frame with a zero dimension (DNL)")
            if nf not in (1, 3):
                raise NotImplementedError(
                    f"{nf}-component (CMYK/YCCK) JPEG is not decoded: {_A9B}")
            for c in range(nf):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                    raise DecodeError("bad sampling factors")
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            frame = (width, height)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v
        elif marker in _SOF_UNSUPPORTED:
            raise NotImplementedError(
                f"{_SOF_UNSUPPORTED[marker]} JPEG is not decoded: {_A9B}")
        elif marker == 0xDA:        # SOS
            if frame is None:
                raise DecodeError("scan before frame header")
            index = {c.cid: k for k, c in enumerate(comps)}
            ks, dcs, acs = [], [], []
            for s in range(seg[0]):
                cid, t = seg[1 + 2 * s], seg[2 + 2 * s]
                if cid not in index:
                    raise DecodeError("scan references a missing component")
                if (t >> 4) not in dc_specs or (t & 15) not in ac_specs:
                    raise DecodeError("scan references a missing table")
                ks.append(index[cid])
                dcs.append(dc_specs[t >> 4])
                acs.append(ac_specs[t & 15])
            m = _SCAN_END.search(data, body_end)
            end = m.start() if m else n
            scans.append(JpegScan(ks, dcs, acs, body_end, end, restart))
            pos = end
            continue
        pos = body_end
    if frame is None or not eoi or not scans:
        raise DecodeError("no frame header" if frame is None
                          else "no EOI marker (truncated)" if not eoi
                          else "no scan")
    if any(c.tq not in qt for c in comps):
        raise DecodeError("missing quantization table")
    if len(comps) == 1:
        color = "gray"
    elif saw_jfif:
        color = "ycc"
    elif adobe_transform is not None:
        color = "rgb" if adobe_transform == 0 else "ycc"
    else:
        color = ("rgb" if tuple(c.cid for c in comps) == (82, 71, 66)
                 else "ycc")
    return JpegHeader(frame[0], frame[1], comps, qt, scans, orientation, color)


def _scan_segments(data: bytes, pos: int) -> List[bytes]:
    """The entropy-coded data from ``pos``: unstuffed segments split at
    RSTn markers, up to the marker that ends the scan."""
    segments = []
    start = pos
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            segments.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return segments
        nxt = data[i + 1]
        if nxt == 0x00 or nxt == 0xFF:
            pos = i + (2 if nxt == 0x00 else 1)
            continue
        if 0xD0 <= nxt <= 0xD7:
            segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            start = pos = i + 2
            continue
        segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        return segments


def _decode_segment(seg: bytes, units, n_units: int) -> None:
    """Huffman-decode ``n_units`` MCUs from one restart segment.  ``units``
    lists per MCU block: (component, block-index function); each
    component's DC predictor restarts at 0 here."""
    # a block reads at most 1,665 bits (27 for DC, 26 per AC): the zero pad
    # covers the last block of a scan that ends early
    buf = seg + bytes(256)
    nbits = 8 * len(seg)
    pos = 0
    zz = _ZZ
    preds = {}
    for mcu in range(n_units):
        for comp, base in units(mcu):
            if pos > nbits:  # cv2.imread refuses a cut file too
                raise DecodeError("JPEG scan data ends early (truncated)")
            coef = comp.coef
            dc_lut, ac_lut = comp.dc, comp.ac
            p = pos >> 3
            w = ((buf[p] << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8)
                 | buf[p + 3]) << (pos & 7) & 0xFFFFFFFF
            e = dc_lut[w >> 16]
            if not e:
                raise DecodeError("bad Huffman code (DC)")
            ln = e >> 8
            s = e & 0xFF
            if s > 16:
                raise DecodeError("bad Huffman code (DC)")
            pos += ln
            diff = 0
            if s:
                if ln + s <= 25:
                    v = (w >> (32 - ln - s)) & ((1 << s) - 1)
                else:
                    p = pos >> 3
                    w2 = ((buf[p] << 24) | (buf[p + 1] << 16)
                          | (buf[p + 2] << 8) | buf[p + 3]) << (pos & 7) \
                        & 0xFFFFFFFF
                    v = w2 >> (32 - s)
                pos += s
                diff = v if v >> (s - 1) else v - (1 << s) + 1
            pred = preds.get(comp.cid, 0) + diff
            preds[comp.cid] = pred
            coef[base] = pred
            k = 1
            while k < 64:
                p = pos >> 3
                w = ((buf[p] << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8)
                     | buf[p + 3]) << (pos & 7) & 0xFFFFFFFF
                e = ac_lut[w >> 16]
                if not e:
                    raise DecodeError("bad Huffman code (AC)")
                ln = e >> 8
                rs = e & 0xFF
                s = rs & 15
                pos += ln
                if s:
                    k += rs >> 4
                    if ln + s <= 25:
                        v = (w >> (32 - ln - s)) & ((1 << s) - 1)
                    else:
                        p = pos >> 3
                        w2 = ((buf[p] << 24) | (buf[p + 1] << 16)
                              | (buf[p + 2] << 8) | buf[p + 3]) << (pos & 7) \
                            & 0xFFFFFFFF
                        v = w2 >> (32 - s)
                    pos += s
                    if k < 64:
                        coef[base + zz[k]] = (v if v >> (s - 1)
                                              else v - (1 << s) + 1)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break


def _decode_scan(scomps, header: JpegHeader, segments, restart):
    width, height = header.width, header.height
    hmax, vmax = header.hmax, header.vmax
    if len(scomps) == 1:
        c = scomps[0]
        cols = -(-(-(-width * c.h // hmax)) // 8)
        rows = -(-(-(-height * c.v // vmax)) // 8)
        total = cols * rows
        bw = c.bw

        def unit_fn(offset):
            def units(i):
                j = offset + i
                r, q = divmod(j, cols)
                return ((c, 64 * (r * bw + q)),)
            return units
    else:
        mcux = -(-width // (8 * hmax))
        mcuy = -(-height // (8 * vmax))
        total = mcux * mcuy
        layout = [(c, y, x) for c in scomps for y in range(c.v)
                  for x in range(c.h)]

        def unit_fn(offset):
            def units(i):
                my, mx = divmod(offset + i, mcux)
                return [(c, 64 * ((my * c.v + y) * c.bw + mx * c.h + x))
                        for c, y, x in layout]
            return units
    per = restart if restart else total
    done = 0
    for seg in segments:
        if done >= total:
            break
        k = min(per, total - done)
        _decode_segment(seg, unit_fn(done), k)
        done += k


def jpeg_coefficients(data: bytes,
                      header: Optional[JpegHeader] = None) -> List[np.ndarray]:
    """The quantized DCT coefficients of each component, int32 [bh * bw,
    64] in natural order (blocks row-major), by the pure-Python Huffman
    decode: the reference of ``csrc/jpeg_entropy.cpp``."""
    header = header or parse_jpeg(data)
    luts: Dict[bytes, List[int]] = {}
    for c in header.comps:
        c.coef = array.array("i", bytes(4 * 64 * c.bw * c.bh))
    for scan in header.scans:
        scomps = [header.comps[k] for k in scan.comps]
        for c, dc, ac in zip(scomps, scan.dc, scan.ac):
            for spec in (dc, ac):
                if spec not in luts:
                    luts[spec] = _build_lut(spec)
            c.dc, c.ac = luts[dc], luts[ac]
        _decode_scan(scomps, header, _scan_segments(data, scan.start),
                     scan.restart)
    return [np.frombuffer(c.coef, np.int32).reshape(-1, 64)
            for c in header.comps]


# jidctint.c and jidctred.c constants (CONST_BITS 13)
_F0_211 = 1730
_F0_298 = 2446
_F0_390 = 3196
_F0_509 = 4176
_F0_541 = 4433
_F0_601 = 4926
_F0_720 = 5906
_F0_765 = 6270
_F0_850 = 6967
_F0_899 = 7373
_F1_061 = 8697
_F1_175 = 9633
_F1_272 = 10426
_F1_451 = 11893
_F1_501 = 12299
_F1_847 = 15137
_F1_961 = 16069
_F2_053 = 16819
_F2_172 = 17799
_F2_562 = 20995
_F3_072 = 25172
_F3_624 = 29692


def _idct_1d(c):
    """One islow pass over the last axis of c [..., 8] (int64): the eight
    outputs before their descale."""
    z2, z3 = c[..., 2], c[..., 6]
    z1 = (z2 + z3) * _F0_541
    tmp2 = z1 + z3 * (-_F1_847)
    tmp3 = z1 + z2 * _F0_765
    tmp0 = (c[..., 0] + c[..., 4]) << 13
    tmp1 = (c[..., 0] - c[..., 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[..., 7], c[..., 5], c[..., 3], c[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0 = t0 * _F0_298
    t1 = t1 * _F2_053
    t2 = t2 * _F3_072
    t3 = t3 * _F1_501
    z1 = z1 * (-_F0_899)
    z2 = z2 * (-_F2_562)
    z3 = z3 * (-_F1_961) + z5
    z4 = z4 * (-_F0_390) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], -1)


def _idct4_1d(c):
    """One pass of ``jpeg_idct_4x4`` over the last axis of c [..., 8]
    (int64; index 4 is never read): four outputs before their descale."""
    tmp0 = c[..., 0] << 14
    tmp2 = c[..., 2] * _F1_847 + c[..., 6] * (-_F0_765)
    tmp10, tmp12 = tmp0 + tmp2, tmp0 - tmp2
    z1, z2, z3, z4 = c[..., 7], c[..., 5], c[..., 3], c[..., 1]
    odd0 = (z1 * (-_F0_211) + z2 * _F1_451 + z3 * (-_F2_172)
            + z4 * _F1_061)
    odd2 = (z1 * (-_F0_509) + z2 * (-_F0_601) + z3 * _F0_899
            + z4 * _F2_562)
    return np.stack([tmp10 + odd2, tmp12 + odd0, tmp12 - odd0,
                     tmp10 - odd2], -1)


def _idct2_1d(c):
    """One pass of ``jpeg_idct_2x2`` over the last axis of c [..., 8]
    (int64; reads indices 0, 1, 3, 5 and 7): two outputs before their
    descale."""
    tmp10 = c[..., 0] << 15
    odd = (c[..., 7] * (-_F0_720) + c[..., 5] * _F0_850
           + c[..., 3] * (-_F1_272) + c[..., 1] * _F3_624)
    return np.stack([tmp10 + odd, tmp10 - odd], -1)


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit (``prepare_range_limit_table``),
    indexed by (x & 1023): x + 128 clamped, with its wrap for wild x."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE = _idct_range_table()

# (1-D pass, pass-1 descale bits, pass-2 descale bits) of each scaled IDCT
_IDCT_PASSES = {8: (_idct_1d, 11, 18), 4: (_idct4_1d, 12, 19),
                2: (_idct2_1d, 13, 20)}


def idct_scaled(coef: np.ndarray, s: int = 8) -> np.ndarray:
    """Dequantized blocks [n, 8, 8] (row = vertical frequency) -> samples
    [n, s, s] uint8: libjpeg's ``jpeg_idct_islow`` (s = 8) or
    ``jpeg_idct_4x4`` / ``_2x2`` / ``_1x1`` (s = 4, 2, 1), bit for bit, in
    int64 (libjpeg's ``JLONG`` on LP64)."""
    c = coef.astype(np.int64)
    if s == 1:
        return _RANGE[((c[:, 0, 0] + 4) >> 3) & 1023].reshape(-1, 1, 1)
    one_d, d1, d2 = _IDCT_PASSES[s]
    # pass 1: columns (vertical), pass 2: rows
    ws = one_d(np.swapaxes(c, 1, 2))               # [n, col, s]
    ws = (ws + (1 << (d1 - 1))) >> d1
    out = one_d(np.swapaxes(ws, 1, 2))             # [n, s, s]
    out = (out + (1 << (d2 - 1))) >> d2
    return _RANGE[out & 1023]


def _upsample(plane: np.ndarray, hr: int, vr: int, mode: str) -> np.ndarray:
    """A component plane [h, w] uint8 expanded by (vr, hr) as libjpeg does
    (``jdsample.c``): ``mode`` is "h2v1", "h1v2" or "h2v2" (triangular, edge
    rows and columns replicated), "box" (replication) or "none"."""
    if mode == "none":
        return plane
    if mode == "box":
        return np.repeat(np.repeat(plane, vr, 0), hr, 1)
    x = plane.astype(np.int32)
    h, w = x.shape
    if mode == "h2v1":
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        out = np.empty((h, 2 * w), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if mode == "h1v2":
        up = np.concatenate([x[:1], x[:-1]], 0)
        down = np.concatenate([x[1:], x[-1:]], 0)
        out = np.empty((2 * h, w), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out.astype(np.uint8)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * h, 2 * w), np.int32)
    for r, nb in ((0, up), (1, down)):
        cs = 3 * x + nb                          # column sums
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        out[r::2, 0::2] = (3 * cs + left + 8) >> 4
        out[r::2, 1::2] = (3 * cs + right + 7) >> 4
    return out.astype(np.uint8)


@dataclasses.dataclass
class ComponentLayout:
    """How one component is rebuilt at scale m/8: its IDCT size ``s``, its
    plane cropped to ``dw`` x ``dh`` (of ``bw * s`` x ``bh * s``), then
    expanded by ``hr`` x ``vr`` with upsampling ``mode``."""

    s: int
    dw: int
    dh: int
    hr: int
    vr: int
    mode: str


def jpeg_layout(header: JpegHeader, m: int = 8):
    """The decode of ``header`` at scale m/8: (output width, height, one
    ``ComponentLayout`` per component).  Follows libjpeg: the output is
    ceil(size * m / 8) (``jdmaster.c``); each component's IDCT size starts
    at m and doubles while both sampling ratios stay divisible, so chroma
    is scaled up by its IDCT rather than upsampled; fancy upsampling is
    off at m = 1, and for h2v1 / h2v2 planes 2 or fewer samples wide
    (``jdsample.c``)."""
    hmax, vmax = header.hmax, header.vmax
    out_w = -(-header.width * m // 8)
    out_h = -(-header.height * m // 8)
    fancy = m > 1
    layouts = []
    for c in header.comps:
        s = m
        while (s < 8 and (hmax * m) % (c.h * s * 2) == 0
               and (vmax * m) % (c.v * s * 2) == 0):
            s *= 2
        dw = -(-header.width * c.h * s // (hmax * 8))
        dh = -(-header.height * c.v * s // (vmax * 8))
        h_in, v_in = c.h * s // m, c.v * s // m
        if hmax % h_in or vmax % v_in:
            raise DecodeError("fractional sampling ratio")
        hr, vr = hmax // h_in, vmax // v_in
        if hr == 1 and vr == 1:
            mode = "none"
        elif hr == 2 and vr == 1:
            mode = "h2v1" if fancy and dw > 2 else "box"
        elif hr == 1 and vr == 2 and fancy:
            mode = "h1v2"
        elif hr == 2 and vr == 2:
            mode = "h2v2" if fancy and dw > 2 else "box"
        else:
            mode = "box"
        layouts.append(ComponentLayout(s, dw, dh, hr, vr, mode))
    return out_w, out_h, layouts


def _ycc_tables():
    """libjpeg's ``build_ycc_rgb_table`` (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(f):
        return int(f * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert``: uint8 planes -> [h, w, 3] uint8."""
    yy = y.astype(np.int64)
    r = yy + _CR_R[cr]
    g = yy + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = yy + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def reconstruct_jpeg(header: JpegHeader, coefs: List[np.ndarray],
                     m: int = 8) -> np.ndarray:
    """Quantized coefficients (``jpeg_coefficients``) -> the upright RGB
    image [H', W', 3] uint8 at scale m/8: the IDCT, the crop, the upsampling,
    the colour transform and the EXIF orientation."""
    out_w, out_h, layouts = jpeg_layout(header, m)
    planes = []
    for c, lay, blocks in zip(header.comps, layouts, coefs):
        samples = idct_scaled(blocks.reshape(-1, 8, 8) * header.qt[c.tq],
                              lay.s)
        s = lay.s
        plane = samples.reshape(c.bh, c.bw, s, s).transpose(0, 2, 1, 3) \
            .reshape(c.bh * s, c.bw * s)[:lay.dh, :lay.dw]
        planes.append(_upsample(plane, lay.hr, lay.vr,
                                lay.mode)[:out_h, :out_w])
    if header.color == "gray":
        img = np.repeat(planes[0][:, :, None], 3, -1)
    elif header.color == "rgb":
        img = np.stack(planes, -1)
    else:
        img = ycc_to_rgb(planes[0], planes[1], planes[2])
    return apply_orientation(img, header.orientation)


def decode_jpeg(data: bytes, m: int = 8) -> np.ndarray:
    """Baseline JPEG bytes -> RGB [H', W', 3] uint8 at scale m/8 (m = 8:
    full size; see the module docstring)."""
    header = parse_jpeg(data)
    return reconstruct_jpeg(header, jpeg_coefficients(data, header), m)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _paeth_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = raw.astype(np.int32)
    pr = prior.astype(np.int32)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = pr[i]
        c = pr[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return out.astype(np.uint8)


def _avg_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = raw.astype(np.int32)
    pr = prior.astype(np.int32)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + pr[i]) >> 1)) & 255
    return out.astype(np.uint8)


def _sub_row(raw: np.ndarray, bpp: int) -> np.ndarray:
    out = raw.copy()
    for j in range(bpp):
        out[j::bpp] = np.cumsum(raw[j::bpp].astype(np.int64)) & 255
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> RGB [H, W, 3] uint8 (see the module docstring)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise DecodeError("not a PNG")
    pos = 8
    idat = []
    palette = None
    ihdr = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise DecodeError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise NotImplementedError(f"interlaced (Adam7) PNG is not decoded: "
                                  f"{_A9B}")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise DecodeError(f"PNG colour type {ctype}")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise DecodeError(f"PNG zlib: {exc}") from None
    bits = channels * depth
    stride = (width * bits + 7) // 8
    bpp = max(1, bits // 8)
    if raw.size < height * (stride + 1):
        raise DecodeError("truncated PNG data")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = _sub_row(line, bpp)
        elif ftype == 2:
            cur = ((line.astype(np.int32) + prior) & 255).astype(np.uint8)
        elif ftype == 3:
            cur = _avg_row(line, prior, bpp)
        elif ftype == 4:
            cur = _paeth_row(line, prior, bpp)
        else:
            raise DecodeError(f"PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    if depth == 16:
        samples = out.reshape(height, width * channels, 2)[..., 0]
    elif depth == 8:
        samples = out[:, :width * channels]
    else:
        per = 8 // depth
        shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
        vals = (out[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = vals.reshape(height, -1)[:, :width * channels]
        if ctype != 3:  # gray expands to 8 bits (png_set_expand_gray_1_2_4_to_8)
            samples = (samples.astype(np.int32) * 255
                       // ((1 << depth) - 1)).astype(np.uint8)
    px = samples.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise DecodeError("palette PNG without PLTE")
        return palette[np.minimum(px[..., 0], len(palette) - 1)]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, -1)
    return np.ascontiguousarray(px[..., :3])


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def decode_bmp(data: bytes) -> np.ndarray:
    """Uncompressed (BI_RGB) 24- or 32-bit BMP bytes -> RGB [H, W, 3] uint8;
    rows bottom-up (positive height) or top-down (negative)."""
    if data[:2] != b"BM" or len(data) < 30:
        raise DecodeError("not a BMP")
    offset, header_size = struct.unpack_from("<II", data, 10)
    if header_size == 12:
        raise NotImplementedError(f"OS/2 BMP header is not decoded: {_A9B}")
    if header_size < 40 or len(data) < 34:
        raise DecodeError("bad or truncated BMP header")
    width, height, _, bpp, compression = struct.unpack_from("<iiHHI", data,
                                                            18)
    if compression != 0 or bpp not in (24, 32):
        raise NotImplementedError(
            f"BMP with compression {compression} at {bpp} bits is not "
            f"decoded: {_A9B}")
    rows_n = abs(height)
    if width <= 0 or rows_n == 0:
        raise DecodeError("BMP with a zero dimension")
    stride = (width * bpp + 31) // 32 * 4
    if offset + stride * rows_n > len(data):
        raise DecodeError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * rows_n, offset).reshape(
        rows_n, stride)[:, :width * bpp // 8].reshape(rows_n, width, bpp // 8)
    img = rows[:, :, 2::-1]                         # BGR(X) -> RGB
    return np.ascontiguousarray(img if height < 0 else img[::-1])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def decode_image(data: bytes) -> np.ndarray:
    """Encoded bytes -> upright RGB [H, W, 3] uint8 (``cv2.imread``'s
    IMREAD_COLOR pixels, in RGB order)."""
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    try:
        if data[:8] == b"\x89PNG\r\n\x1a\n":
            return decode_png(data)
        if data[:2] == b"BM":
            return decode_bmp(data)
    except DecodeError:
        raise
    except (IndexError, ValueError, struct.error) as e:   # a cut chunk
        raise DecodeError(f"corrupt image ({e})") from e
    raise DecodeError("unknown image format")


def linear_taps(src: int, dst: int):
    """INTER_LINEAR taps of the native path: half-pixel centres, clamped
    indices, 11-bit weights -> (i0, i1, w0, w1), int64 [dst] each."""
    scale = src / dst
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    t = f - i0
    w1 = (t * 2048 + 0.5).astype(np.int64)
    return (np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1),
            2048 - w1, w1)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, C] uint8 -> [height, width, C] uint8: ``cv2.resize`` with
    ``INTER_LINEAR`` in the native path's fixed point (horizontal then
    vertical, 11-bit weights, one rounding at 22 bits)."""
    sh, sw = img.shape[:2]
    x0, x1, xw0, xw1 = linear_taps(sw, width)
    y0, y1, yw0, yw1 = linear_taps(sh, height)
    src = img.astype(np.int64)
    rows = np.unique(np.concatenate([y0, y1]))
    lut = np.zeros(sh, np.int64)
    lut[rows] = np.arange(len(rows))
    hz = src[rows][:, x0] * xw0[None, :, None] + src[rows][:, x1] \
        * xw1[None, :, None]
    v = hz[lut[y0]] * yw0[:, None, None] + hz[lut[y1]] * yw1[:, None, None]
    v = (v + (1 << 21)) >> 22
    return np.clip(v, 0, 255).astype(np.uint8)


def prescale_factor(size: Tuple[int, int], prescale_min: int) -> int:
    """The native path's DCT-domain scale m (of m/8) for a JPEG of ``size``
    (``native/image_pipeline.cpp`` decode_body): the smallest m in
    {1, 2, 4} keeping both dimensions >= ``prescale_min``, else 8 (and 8
    when ``prescale_min`` is 0)."""
    if prescale_min <= 0:
        return 8
    w, h = size
    for m in (1, 2, 4):
        if (w * m + 7) // 8 >= prescale_min and (h * m + 7) // 8 >= prescale_min:
            return m
    return 8


def decode_resize(path: str, resize_dim: int, channel_order: str = "rgb",
                  prescale: bool = False) -> Optional[np.ndarray]:
    """One file -> [resize_dim, resize_dim, 3] uint8 in ``channel_order``,
    or None when the file is not a readable image (as ``cv2.imread``
    returns None).  With ``prescale`` a JPEG decodes at the native path's
    DCT scale for ``prescale_min = 2 * resize_dim`` before the resize."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    size = jpeg_size(data) if prescale else None
    try:
        img = (decode_jpeg(data, prescale_factor(size, 2 * resize_dim))
               if size else decode_image(data))
    except DecodeError:
        return None
    img = resize_bilinear(img, resize_dim, resize_dim)
    if channel_order == "bgr":
        img = img[:, :, ::-1]
    return np.ascontiguousarray(img)
