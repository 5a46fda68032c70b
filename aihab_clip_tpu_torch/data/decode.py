"""Image decode and resize on the host, in numpy (the counterpart of
``cv2.imread`` + ``cv2.resize`` in ``aihab_clip_tpu/data/bulk_load.py:91-100``
and of the libjpeg decode + bilinear resize of its native path,
``native/image_pipeline.cpp``).  This module is the reference of the fast
decode (``ops/jpeg.py``): its header parser serves both, its Huffman decode
and pixel stage are what the C++ entropy decoder and the card's kernels are
held against.

  * **JPEG**, sequential (SOF0/SOF1/SOF9) and progressive (SOF2/SOF10),
    Huffman- or arithmetic-coded, 8-bit, 1, 3 or 4 components: libjpeg's
    Huffman decode (``jdhuff.c``, ``jdphuff.c``) and its QM arithmetic
    decode (``jdarith.c``: ITU-T T.81 Annex D, F.1.4.4 and G.1.3, with
    the conditioning of DAC markers), with their rules for data that runs
    out (a cut Huffman file decodes, the rest of its scan left as it is;
    a cut arithmetic one decodes every later MCU from zero bytes) and, for
    a cut progressive file, libjpeg's interblock smoothing (``jdcoefct.c``,
    libjpeg-turbo >= 2.1); the integer "islow" IDCT
    (``jidctint.c``), h2v1/h1v2/h2v2 "fancy" (triangular) chroma
    upsampling with libjpeg's edge rows and biases, its fixed-point YCbCr
    -> RGB tables, restart markers, grayscale and Adobe/RGB JPEGs; CMYK and
    YCCK (Adobe transform 0 or 2) through libjpeg's YCCK -> CMYK and cv2's
    CMYK -> BGR.  This is the arithmetic libjpeg-turbo runs (the IDCTs
    as its x86 SIMD forms hold them in int16 and int32 lanes,
    ``idct_scaled``), so the pixels are libjpeg's.
  * **DCT-domain prescale** (the native path's ``prescale_min``): a JPEG
    decodes at m/8, m in {1, 2, 4}, through libjpeg's reduced IDCTs
    (``jidctred.c``: 1x1, 2x2, 4x4), with ``jdmaster.c``'s per-component
    scaled sizes (chroma scaled up by its IDCT where the sampling factors
    allow, so a 4:2:0 photo needs no upsampling below m = 8) and
    ``jdsample.c``'s rule that fancy upsampling is off at m = 1.
  * **PNG**: zlib + the five scanline filters, bit depths 1-16 (16-bit keeps
    the high byte, as ``cv2.imread(IMREAD_COLOR)``), gray, RGB, palette,
    alpha dropped, plain or Adam7-interlaced.
  * **BMP**, as cv2's reader takes it: the Windows headers and OS/2's
    12-byte one, 1/4/8-bit palettes (RLE8 and RLE4 too), 16-bit (555, and
    565 by BI_BITFIELDS), 24-bit, 32-bit (BI_RGB or BI_BITFIELDS),
    bottom-up and top-down.
  * **EXIF orientation** (JPEG APP1) is applied as ``cv2.imread`` does.
  * **Resize**: bilinear with ``cv2.INTER_LINEAR``'s half-pixel centres in
    the fixed point of the native path (11-bit weights, 22-bit rounding),
    which equals that path bit for bit and cv2 within one level.

Lossless (SOF3, SOF11), 12-bit and hierarchical JPEGs are a
``DecodeError``: neither JAX's native libjpeg path nor cv2 reads them, so
they are None on every route.  The entropy decodes here are pure Python
(seconds per megapixel): the reference, not the production path.
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
DECODE_RULE = ("aihab_clip_tpu_torch.decode/4:islow,jidctred,fancy,linear11,"
               "progressive,smooth9,cut,cmyk,routes,arith")


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
# libjpeg's jpeg_natural_order with its 16 extra entries: a run that takes a
# corrupt scan's index past 63 writes coefficient 63
_ZZX = _ZZ + [63] * 16

# the frames decoded: marker -> (progressive, arithmetic-coded)
_SOF = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False),
        0xC9: (False, True), 0xCA: (True, True)}
# lossless frames (Huffman, arithmetic) and hierarchical (differential)
# ones: neither JAX's native libjpeg path nor cv2 5.0 reads them
_SOF_REFUSED = {0xC3: "lossless", 0xCB: "lossless",
                **{m: "hierarchical" for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE,
                                               0xCF)}}

# a stuffed 0xFF in entropy-coded data, after fill bytes; a marker (each
# pattern starts with a literal, which re scans for fast)
_STUFFED = re.compile(rb"\xff\xff*\x00")
_MARKER = re.compile(rb"\xff\xff*[^\x00\xff]")

# the markers libjpeg's read_markers refuses (reserved ones, JPG, DHP, EXP,
# JPGn, a second SOI)
_UNKNOWN_MARKERS = frozenset([*range(0x02, 0xC0), 0xC8, 0xD8, 0xDE, 0xDF,
                              *range(0xF0, 0xFE)])

# a lookup entry for bits that start no code: libjpeg reads 17 bits and
# takes symbol 0 (jdhuff.c jpeg_huff_decode)
_MISS = 17 << 8
# zero bytes after a restart segment: more than one MCU can read, so the MCU
# in which the data runs out decodes with zero bits
_PAD = 4096


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
    16 bits -> (code length << 8) | symbol (``_MISS``: no code)."""
    counts, symbols = spec[:16], spec[16:]
    _check_huffman(counts, len(symbols))
    lut = [_MISS] * 65536
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
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "wib", "hib", "coef",
                 "dc", "ac")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


@dataclasses.dataclass
class JpegScan:
    """One scan: its components (indices into ``JpegHeader.comps``), their
    DC and AC Huffman table specs (16 counts, then the symbols; ``b""``
    where the scan reads none, and in an arithmetic-coded frame), the
    entropy-coded bytes ``data[start:end]``, the restart interval in force
    and its spectral band ``ss``..``se`` and successive-approximation bits
    ``ah``, ``al`` (0, 63, 0, 0 in a sequential frame).  An
    arithmetic-coded scan has ``arith`` instead of table specs: per
    component its DC statistics table and that table's conditioning L and
    U, its AC statistics table and that table's Kx, as the DAC markers
    before the scan left them."""

    comps: List[int]
    dc: List[bytes]
    ac: List[bytes]
    start: int
    end: int
    restart: int
    ss: int = 0
    se: int = 63
    ah: int = 0
    al: int = 0
    arith: Optional[List[Tuple[int, int, int, int, int]]] = None


@dataclasses.dataclass
class JpegHeader:
    """What a JPEG's markers say: the frame, the components
    (``_Component``: cid, sampling h and v, table tq; ``bw`` x ``bh``
    blocks, MCU-padded, of which ``wib`` x ``hib`` hold the image),
    quantization tables (int64 [8, 8], natural order), the scans, the EXIF
    orientation, the colour transform ("ycc", "rgb", "gray", "cmyk" or
    "ycck"), whether the frame is progressive (SOF2, SOF10) and whether it
    is arithmetic-coded (SOF9, SOF10), whether what libjpeg reads for the
    image lies inside the data (``complete``: the data reaches its EOI
    marker, or a marker ends a one-scan sequential frame's scan; a cut
    file's does not), the bytes libjpeg's fake EOI adds to
    a scan cut in its header (``tail``, to append to the data) and whether
    a marker after a one-scan sequential frame's scan is one libjpeg
    refuses (``tail_error``: JAX's native path returns None, cv2 the
    image)."""

    width: int
    height: int
    comps: List[_Component]
    qt: Dict[int, np.ndarray]
    scans: List[JpegScan]
    orientation: int
    color: str
    progressive: bool = False
    complete: bool = True
    tail: bytes = b""
    arithmetic: bool = False
    tail_error: bool = False

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.comps)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.comps)

    @property
    def imcu_rows(self) -> int:
        return -(-self.height // (8 * self.vmax))


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
    """Walk a JPEG's markers (the entropy-coded data is skipped, not
    decoded).  Raises ``DecodeError`` for a file that libjpeg refuses (a
    segment cut short, no scan, a bad progression, ...) and for the modes
    neither JAX's native path nor cv2 reads (lossless, 12-bit,
    hierarchical).  A file cut inside its entropy-coded data, or missing
    its EOI, parses: libjpeg decodes it with the missing data as zeros."""
    try:
        return _parse_jpeg(data)
    except DecodeError:
        raise
    except (IndexError, ValueError) as e:   # a segment shorter than its kind
        raise DecodeError(f"corrupt JPEG marker segment ({e})") from e


def _dc_table(spec: bytes) -> bytes:
    """A table used for DC differences: libjpeg refuses symbols past 15."""
    if any(s > 15 for s in spec[16:]):
        raise DecodeError("Huffman table: DC symbol past 15")
    return spec


def _parse_jpeg(data: bytes) -> JpegHeader:
    if data[:2] != b"\xff\xd8":
        raise DecodeError("not a JPEG (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    dc_specs: Dict[int, bytes] = {}
    ac_specs: Dict[int, bytes] = {}
    comps: List[_Component] = []
    scans: List[JpegScan] = []
    frame = None
    progressive = arithmetic = False
    # DAC conditioning by table (jdmarker.c get_soi's defaults)
    dc_cond = {t: (0, 1) for t in range(16)}
    ac_cond = {t: 5 for t in range(16)}
    restart = 0
    orientation = 1
    saw_jfif = False
    adobe_transform = None
    pos = 2
    n = len(data)
    eoi = tail_error = False
    tail = b""
    # each component's quantization table as its first scan found it
    # (jdinput.c latch_quant_tables: a DQT after that changes nothing)
    latched: Dict[int, np.ndarray] = {}

    def latch(scan: JpegScan) -> None:
        for k in scan.comps:
            if k not in latched:
                if comps[k].tq not in qt:
                    raise DecodeError("missing quantization table")
                latched[k] = qt[comps[k].tq]

    try:
        while pos < n:
            if pos + 1 >= n:
                break                   # a byte cut from its marker
            if data[pos] != 0xFF or data[pos + 1] == 0:
                pos = _next_marker(data, pos)[0]   # libjpeg skips such bytes
                continue
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
            if marker in _UNKNOWN_MARKERS:
                raise DecodeError(f"unknown JPEG marker 0x{marker:02X}")
            if pos + 4 > n:
                if scans and (marker in (0xDC, 0xFE)
                              or 0xE0 <= marker <= 0xEF):
                    break               # libjpeg skips its garbage length
                raise DecodeError("truncated marker segment")
            length = _u16(data, pos + 2)
            body_end = pos + 2 + length
            if body_end > n or length < 2:
                part = data[pos + 4:]
                if (marker == 0xDA and frame is not None and not progressive
                        and length >= 2 and part):
                    # a sequential scan cut in its header: libjpeg reads the
                    # rest from its fake EOI (FF D9 FF D9 ...), which its band
                    # bytes take in (it only warns about them) and, in an
                    # arithmetic-coded frame, a table selector too (FF:
                    # statistics tables 15); a D9 left over is the scan's one
                    # byte
                    missing = length - 2 - len(part)
                    part += b"\xff\xd9" * (length // 2)
                    scans.append(_parse_sos(part[:length - 2], comps, dc_specs,
                                            ac_specs, False, restart, n,
                                            arithmetic and (dc_cond, ac_cond)))
                    latch(scans[-1])
                    tail = b"\xd9" * (missing % 2)
                    scans[-1].end = n + len(tail)
                    break
                if scans and _cut_after_scans(marker, part, length):
                    break
                raise DecodeError("truncated marker segment")
            seg = data[pos + 4:body_end]
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
                    if tq >= 4:         # libjpeg's JERR_DQT_INDEX
                        raise DecodeError(f"DQT table index {tq}")
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
                    tc, th = seg[i] & 0x10, seg[i] & 0xEF
                    if th >= 4:         # libjpeg's JERR_DHT_INDEX
                        raise DecodeError(f"DHT table index {seg[i]}")
                    counts = seg[i + 1:i + 17]
                    if len(counts) < 16:
                        raise DecodeError("truncated Huffman table")
                    total = sum(counts)
                    spec = seg[i + 1:i + 17 + total]
                    _check_huffman(counts, len(spec) - 16)
                    (ac_specs if tc else dc_specs)[th] = spec
                    i += 17 + total
            elif marker == 0xCC:        # DAC (jdmarker.c get_dac)
                if len(seg) % 2:
                    raise DecodeError("DAC segment of odd length")
                for i in range(0, len(seg), 2):
                    index, val = seg[i], seg[i + 1]
                    if index >= 32:
                        raise DecodeError(f"DAC table index {index}")
                    if index >= 16:
                        ac_cond[index - 16] = val
                    elif val & 15 > val >> 4:
                        raise DecodeError(f"DAC conditioning L > U ({val})")
                    else:
                        dc_cond[index] = (val & 15, val >> 4)
            elif marker == 0xDD:        # DRI
                if length != 4:
                    raise DecodeError("DRI segment of a bad length")
                restart = _u16(seg, 0)
            elif marker in _SOF:
                if frame is not None:
                    raise DecodeError("a second frame header")
                if seg[0] != 8:
                    raise DecodeError(f"{seg[0]}-bit JPEG")
                height, width, nf = _u16(seg, 1), _u16(seg, 3), seg[5]
                if height == 0 or width == 0:
                    raise DecodeError("JPEG frame with a zero dimension (DNL)")
                if nf not in (1, 3, 4):
                    raise DecodeError(f"{nf}-component JPEG")
                for c in range(nf):
                    cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                    if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                        raise DecodeError("bad sampling factors")
                    comps.append(_Component(cid, hv >> 4, hv & 15, tq))
                frame = (width, height)
                progressive, arithmetic = _SOF[marker]
                hmax = max(c.h for c in comps)
                vmax = max(c.v for c in comps)
                mcux = -(-width // (8 * hmax))
                mcuy = -(-height // (8 * vmax))
                for c in comps:
                    c.bw, c.bh = mcux * c.h, mcuy * c.v
                    c.wib = -(-(-(-width * c.h // hmax)) // 8)
                    c.hib = -(-(-(-height * c.v // vmax)) // 8)
            elif marker in _SOF_REFUSED:
                raise DecodeError(f"{_SOF_REFUSED[marker]} JPEG")
            elif marker == 0xDA:        # SOS
                if frame is None:
                    raise DecodeError("scan before frame header")
                scans.append(_parse_sos(seg, comps, dc_specs, ac_specs,
                                        progressive, restart, body_end,
                                        arithmetic and (dc_cond, ac_cond)))
                latch(scans[-1])
                scans[-1].end = _restart_walk(
                    data, body_end, _intervals(
                        _scan_mcus(width, height, comps, scans[-1].comps),
                        restart))[1]
                pos = scans[-1].end
                continue
            pos = body_end
    except (DecodeError, IndexError, ValueError):
        # libjpeg reads what follows a one-scan sequential frame's scan
        # only in jpeg_finish_decompress, whose error JAX's native path
        # takes as a failure and cv2 shrugs off: the image stands
        if not (scans and not progressive and pos >= scans[0].end
                and len(scans[0].comps) == len(comps)):
            raise
        tail_error = True
    if frame is None or not scans:
        raise DecodeError("no frame header" if frame is None else "no scan")
    # whether libjpeg's reading of what the image needs stays inside the
    # data: all of it in a progressive or multi-scan frame, read before any
    # output; a one-scan sequential frame's scan alone, if a marker ends it
    complete = eoi or (not progressive and scans[0].end < n
                       and len(scans[0].comps) == len(comps))
    tables: Dict[int, np.ndarray] = {}
    for k, c in enumerate(comps):
        table = latched.get(k, qt.get(c.tq))
        if table is None:
            raise DecodeError("missing quantization table")
        if c.tq in tables and tables[c.tq] is not table:
            c.tq = 4 + k     # its table redefined before another's first scan
        tables[c.tq] = table
    qt = tables
    if len(comps) == 1:
        color = "gray"
    elif len(comps) == 4:
        color = ("cmyk" if adobe_transform in (None, 0) else "ycck")
    elif saw_jfif:
        color = "ycc"
    elif adobe_transform is not None:
        color = "rgb" if adobe_transform == 0 else "ycc"
    else:
        color = ("rgb" if tuple(c.cid for c in comps) == (82, 71, 66)
                 else "ycc")
    return JpegHeader(frame[0], frame[1], comps, qt, scans, orientation,
                      color, progressive, complete, tail, arithmetic,
                      tail_error)


def _cut_after_scans(marker: int, seg: bytes, length: int) -> bool:
    """Whether libjpeg still decodes a file cut inside a marker segment
    that follows its scans: its source then reads fake EOI bytes (FF D9
    ...), which a skipped segment (APPn, COM, DNL), a DRI's interval, the
    symbols of a DHT's last table, the values of a DQT's last table or the
    value of a DAC's last entry take in, and the counts or index of a
    table, or any other segment, refuse."""
    if marker in (0xDC, 0xFE) or 0xE0 <= marker <= 0xEF:
        return True                 # skipped (DNL, COM, APPn)
    if marker == 0xDD:
        return length == 4          # the interval read from FF D9
    if marker == 0xDB:
        # the values of its last table, which nothing reads (a table is
        # latched at a component's first scan)
        i = 0
        while i < len(seg):
            if seg[i] & 15 >= 4:
                return False
            end = i + 1 + (128 if seg[i] >> 4 else 64)
            if end >= len(seg):
                return end == length - 2
            i = end
        return False
    if marker == 0xCC:
        # the value read is FF: a DC entry's L = U = 15, an AC entry's 255
        return (len(seg) == length - 3 and len(seg) % 2 == 1
                and all(seg[i] < 32 and (seg[i] >= 16 or seg[i + 1] & 15
                                         <= seg[i + 1] >> 4)
                        for i in range(0, len(seg) - 1, 2))
                and seg[-1] < 32)
    if marker != 0xC4:
        return False
    i = 0
    while i + 17 <= len(seg):
        if seg[i] & 0xEF >= 4 or sum(seg[i + 1:i + 17]) > 256:
            return False
        end = i + 17 + sum(seg[i + 1:i + 17])
        if end >= len(seg):
            return end == length - 2 and end > len(seg)
        i = end
    return False


def _scan_mcus(width: int, height: int, comps, ks) -> int:
    """The MCUs of a scan of components ``ks`` (``_scan_units``' count)."""
    if len(ks) == 1:
        c = comps[ks[0]]
        return c.wib * c.hib
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    return -(-width // (8 * hmax)) * -(-height // (8 * vmax))


def _next_marker(data: bytes, pos: int) -> Tuple[int, int]:
    """jdmarker.c next_marker from ``pos``: (where the marker's last 0xFF
    lies, its code), past stuffed zeros and fill bytes; past the data,
    libjpeg's fake EOI at ``len(data)``."""
    m = _MARKER.search(data, pos)
    return (m.end() - 2, data[m.end() - 1]) if m else (len(data), 0xD9)


def _intervals(total: int, restart: int) -> int:
    """The restart intervals of a scan of ``total`` MCUs."""
    return -(-total // restart) if restart else 1


def _restart_walk(data: bytes, start: int,
                  intervals: int) -> Tuple[List[Tuple[Optional[int], bool]],
                                           int]:
    """libjpeg's reading of a scan's restart markers (jdmarker.c
    read_restart_marker and jpeg_resync_to_restart), which no decode
    changes: a decoder reads no further than a marker, and at each
    interval's start the next marker is taken, a stray code below SOF0 or
    a restart before the one due skipped, the due one (or one too far
    off) read, and any other marker or a restart one or two ahead left
    unread.  Returns, per interval, where its data starts (None: a marker
    was left unread, so none) and whether the Huffman decoder starts
    afresh there (its ``insufficient_data`` cleared: the marker was read),
    and where the scan ends: the marker left after the last interval.
    ``_ArithSource.restart`` is the arithmetic decoder's side of it."""
    out: List[Tuple[Optional[int], bool]] = [(start, True)]
    pos, marker, want = start, 0, 0
    for _ in range(intervals - 1):
        if not marker:
            pos, marker = _next_marker(data, pos)
        while marker < 0xC0 or marker in (0xD0 + ((want - 1) & 7),
                                          0xD0 + ((want - 2) & 7)):
            pos, marker = _next_marker(data, pos + 2)
        if 0xD0 <= marker <= 0xD7 and marker not in (
                0xD0 + ((want + 1) & 7), 0xD0 + ((want + 2) & 7)):
            pos, marker = pos + 2, 0          # read: its interval's data
            out.append((pos, True))
        else:
            out.append((None, False))
        want = (want + 1) & 7
    return out, pos if marker else _next_marker(data, pos)[0]


def _parse_sos(seg, comps, dc_specs, ac_specs, progressive, restart,
               start, cond=None) -> JpegScan:
    """An SOS segment -> its ``JpegScan`` (end unset), with the checks of
    libjpeg's start_pass (jdhuff.c, jdphuff.c; jdarith.c's are the same
    on the progression).  ``cond``: an arithmetic-coded frame's DAC
    conditioning in force, (DC (L, U) by table, AC Kx by table); its scan
    reads statistics tables 0-15, which need no marker."""
    index = {c.cid: k for k, c in enumerate(comps)}
    ns = seg[0]
    if not 1 <= ns <= 4 or len(seg) != 2 * ns + 4:
        raise DecodeError("bad SOS segment")
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], \
        seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    if progressive:
        bad = (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
        if bad or (ah and al != ah - 1) or al > 13:
            raise DecodeError(f"bad progression (Ss {ss}, Se {se}, Ah {ah},"
                              f" Al {al})")
        need_dc, need_ac = ss == 0 and ah == 0, ss > 0
    else:
        ss, se, ah, al = 0, 63, 0, 0
        need_dc = need_ac = True
    ks, dcs, acs, arith = [], [], [], []
    for s in range(ns):
        cid, t = seg[1 + 2 * s], seg[2 + 2 * s]
        if cid not in index or index[cid] in ks:
            raise DecodeError("scan references a missing component")
        ks.append(index[cid])
        if cond:
            dcs.append(b"")
            acs.append(b"")
            arith.append((t >> 4, *cond[0][t >> 4], t & 15, cond[1][t & 15]))
            continue
        if (need_dc and (t >> 4) not in dc_specs) or \
                (need_ac and (t & 15) not in ac_specs):
            raise DecodeError("scan references a missing table")
        dcs.append(_dc_table(dc_specs[t >> 4]) if need_dc else b"")
        acs.append(ac_specs[t & 15] if need_ac else b"")
    return JpegScan(ks, dcs, acs, start, start, restart, ss, se, ah, al,
                    arith if cond else None)


def _segment(data: bytes, start: Optional[int]) -> bytes:
    """One restart interval's entropy-coded bytes from ``start`` (None:
    none) to the next marker, unstuffed as libjpeg's jpeg_fill_bit_buffer
    reads them: 0xFF bytes and then 0x00 are one 0xFF; the 0xFF bytes
    before the marker (or cut from one at the end of the data) none."""
    if start is None:
        return b""
    seg = data[start:_next_marker(data, start)[0]].rstrip(b"\xff")
    return _STUFFED.sub(b"\xff", seg)


def _decode_segment(seg: bytes, units, n_units: int) -> int:
    """Huffman-decode ``n_units`` MCUs of a sequential scan from one
    restart segment.  ``units`` lists per MCU block: (component, block
    index); each component's DC predictor restarts at 0 here.  Returns the
    index of the MCU that read past the segment's data (decoded with zero
    bits; the caller leaves every later one at zero, as jdhuff.c does), or
    -1."""
    buf = seg + bytes(_PAD)
    nbits = 8 * len(seg)
    pos = 0
    zz = _ZZX
    preds = {}
    for mcu in range(n_units):
        for comp, base in units(mcu):
            coef = comp.coef
            dc_lut, ac_lut = comp.dc, comp.ac
            p = pos >> 3
            w = ((buf[p] << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8)
                 | buf[p + 3]) << (pos & 7) & 0xFFFFFFFF
            e = dc_lut[w >> 16]
            ln = e >> 8
            s = e & 0xFF
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
                    coef[base + zz[k]] = (v if v >> (s - 1)
                                          else v - (1 << s) + 1)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
        if pos > nbits:
            return mcu
    return -1


def _wrap16(v: int) -> int:
    """A value stored into libjpeg's JCOEF (int16)."""
    return ((v + 32768) & 0xFFFF) - 32768


def _decode_progressive_segment(seg: bytes, units, n_units: int,
                                scan: JpegScan) -> int:
    """``_decode_segment`` for one scan of a progressive frame (jdphuff.c:
    DC first and refine, AC first with its EOB runs, AC refine with the
    correction bits of coefficients already non-zero): the same return."""
    buf = seg + bytes(_PAD)
    nbits = 8 * len(seg)
    pos = 0
    zz = _ZZX
    ss, se, al = scan.ss, scan.se, scan.al
    p1, m1 = 1 << al, -1 << al
    dc_first, dc_refine = ss == 0 and scan.ah == 0, ss == 0 and scan.ah > 0
    ac_first = ss > 0 and scan.ah == 0
    preds: Dict[int, int] = {}
    eobrun = 0

    def bits(n):
        nonlocal pos
        p = pos >> 3
        w = ((buf[p] << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8)
             | buf[p + 3]) << (pos & 7) & 0xFFFFFFFF
        pos += n
        return w >> (32 - n)

    def huff(lut):
        nonlocal pos
        p = pos >> 3
        w = ((buf[p] << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8)
             | buf[p + 3]) << (pos & 7) & 0xFFFFFFFF
        e = lut[w >> 16]
        pos += e >> 8
        return e & 0xFF

    def extend(v, s):
        return v if v >> (s - 1) else v - (1 << s) + 1

    def correct(coef, i):
        # a correction bit on a coefficient already non-zero
        if bits(1) and (coef[i] & p1) == 0:
            coef[i] = _wrap16(coef[i] + (p1 if coef[i] >= 0 else m1))

    for mcu in range(n_units):
        for comp, base in units(mcu):
            coef = comp.coef
            if dc_first:
                s = huff(comp.dc)
                diff = extend(bits(s), s) if s else 0
                pred = preds.get(comp.cid, 0) + diff
                preds[comp.cid] = pred
                coef[base] = _wrap16(pred << al)
            elif dc_refine:
                if bits(1):
                    coef[base] = _wrap16(coef[base] | p1)
            elif ac_first:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = huff(comp.ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        coef[base + zz[k]] = _wrap16(extend(bits(s), s)
                                                     << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits(r) if r else 0) - 1
                        break
                    k += 1
            else:                   # AC refine
                k = ss
                if eobrun == 0:
                    while k <= se:
                        rs = huff(comp.ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            s = p1 if bits(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + (bits(r) if r else 0)
                            break
                        while True:
                            i = base + zz[k]
                            if coef[i]:
                                correct(coef, i)
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                            if k > se:
                                break
                        if s:
                            coef[base + zz[k]] = s
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        i = base + zz[k]
                        if coef[i]:
                            correct(coef, i)
                        k += 1
                    eobrun -= 1
        if pos > nbits:
            return mcu
    return -1


def _scan_units(header: JpegHeader, scomps):
    """A scan's MCUs: (count, units per iMCU row, the function of an offset
    giving ``units`` for ``_decode_segment``).  A one-component scan walks
    the component's own ceil(w/8) x ceil(h/8) blocks, an interleaved one
    the MCU-padded grid."""
    if len(scomps) == 1:
        c = scomps[0]
        cols, bw = c.wib, c.bw

        def unit_fn(offset):
            def units(i):
                r, q = divmod(offset + i, cols)
                return ((c, 64 * (r * bw + q)),)
            return units
        return cols * c.hib, cols * c.v, unit_fn
    mcux = -(-header.width // (8 * header.hmax))
    mcuy = -(-header.height // (8 * header.vmax))
    layout = [(c, y, x) for c in scomps for y in range(c.v)
              for x in range(c.h)]

    def unit_fn(offset):
        def units(i):
            my, mx = divmod(offset + i, mcux)
            return [(c, 64 * ((my * c.v + y) * c.bw + mx * c.h + x))
                    for c, y, x in layout]
        return units
    return mcux * mcuy, mcux, unit_fn


def _decode_scan(header: JpegHeader, scan: JpegScan, scomps,
                 data: bytes) -> Optional[int]:
    """Decode one Huffman-coded scan's restart intervals (libjpeg's rules
    for data that runs out: the MCU that reads past an interval's data
    decodes with zero bits, every later MCU is left as it is until a
    restart marker is read; an interval whose marker was left unread has
    no data, ``_restart_walk``).  Returns the iMCU row of the first MCU
    that read past the data, or None."""
    total, per_row, unit_fn = _scan_units(header, scomps)
    decode = (_decode_segment if not header.progressive
              else lambda s, u, k: _decode_progressive_segment(s, u, k, scan))
    per = scan.restart if scan.restart else total
    walk = _restart_walk(data, scan.start, _intervals(total, scan.restart))[0]
    short = False
    first_bad = None
    for i, (start, afresh) in enumerate(walk):
        done = i * per
        k = min(per, total - done)
        short &= not afresh
        if not short:
            bad = decode(_segment(data, start), unit_fn(done), k)
            if bad >= 0:
                short = True
                if first_bad is None:
                    first_bad = (done + bad) // per_row
    return first_bad


def jpeg_coefficients(data: bytes, header: Optional[JpegHeader] = None,
                      smooth: Optional[str] = "2.1") -> List[np.ndarray]:
    """The quantized DCT coefficients of each component, int32 [bh * bw,
    64] in natural order (blocks row-major), by the pure-Python Huffman or
    arithmetic decode: the reference of ``csrc/jpeg_entropy.cpp``.  A
    progressive file whose low coefficients are not all known (a cut one)
    gets libjpeg's interblock smoothing, as its IDCT reads them:
    ``smooth`` names the libjpeg-turbo whose rows it takes ("2.1": JAX's
    native path, "3.1": cv2's; None: no smoothing)."""
    header = header or parse_jpeg(data)
    data += header.tail
    luts: Dict[bytes, List[int]] = {}
    for c in header.comps:
        c.coef = array.array("i", bytes(4 * 64 * c.bw * c.bh))
    last_good = header.imcu_rows
    for scan in header.scans:
        scomps = [header.comps[k] for k in scan.comps]
        if header.arithmetic:
            # jdarith.c never runs short of data, so libjpeg's smoothing
            # takes every iMCU row as decoded
            _arith_decode_scan(header, scan, scomps, data)
            continue
        for c, dc, ac in zip(scomps, scan.dc, scan.ac):
            for spec in (dc, ac):
                if spec and spec not in luts:
                    luts[spec] = _build_lut(spec)
            c.dc, c.ac = luts.get(dc), luts.get(ac)
        bad = _decode_scan(header, scan, scomps, data)
        last_good = header.imcu_rows if bad is None else bad
    coefs = [np.frombuffer(c.coef, np.int32).reshape(-1, 64)
             for c in header.comps]
    plan = smoothing_plan(header) if smooth else None
    if plan is not None:
        coefs = [smooth_blocks(header, k, coef, plan[k], last_good, smooth)
                 for k, coef in enumerate(coefs)]
    return coefs


# ---------------------------------------------------------------------------
# arithmetic decoding (libjpeg's jdarith.c)
# ---------------------------------------------------------------------------

# ITU-T T.81 Table D.2 as libjpeg's jaricom.c packs it: per state, Qe << 16
# | the next state after an MPS << 8 | whether an LPS switches the MPS << 7
# | the next state after an LPS; state 113 is the fixed estimate of 0.5
# (signs of AC values, DC refinement bits)
_ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
)
_FIXED = 113


class _ArithSource:
    """jdarith.c's QM decoder (``arith_decode``) over one restart
    interval's data from ``pos`` (None: none, a marker was left unread),
    with libjpeg's data source around it: 0xFF bytes and then 0x00 are a
    stuffed 0xFF; any marker ends the data and zero bytes follow; past the
    end of ``data`` the source reads libjpeg's fake EOI (FF D9 FF D9 ...),
    a marker too.  ``ct`` -1 marks an interval whose data went bad (a code
    past its range)."""

    def __init__(self, data: bytes, pos: Optional[int]):
        self.data, self.pos, self.n = data, pos, len(data)
        self.ended = pos is None
        self.c = self.a = 0
        self.ct = -16

    def byte(self) -> int:
        p = self.pos
        self.pos += 1
        if p < self.n:
            return self.data[p]
        return 0xD9 if (p - self.n) & 1 else 0xFF

    def decode(self, st, i: int) -> int:
        """One binary decision with the statistics bin ``st[i]``."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                d = 0
                if not self.ended:
                    d = self.byte()
                    if d == 0xFF:
                        d = self.byte()
                        while d == 0xFF:
                            d = self.byte()
                        if d == 0:
                            d = 0xFF
                        else:
                            self.ended, d = True, 0
                c = (c << 8) | d
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        e = _ARITAB[sv & 0x7F]
        qe = e >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
            else:
                st[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_decode_scan(header: JpegHeader, scan: JpegScan, scomps,
                       data: bytes) -> None:
    """Decode one arithmetic-coded scan (jdarith.c decode_mcu and, in a
    progressive frame, decode_mcu_DC_first / _DC_refine / _AC_first /
    _AC_refine) into the components' coefficients.  Each restart interval
    (``_restart_walk``) zeroes the scan's statistics and DC predictions
    and starts a decoder afresh; data that runs out decodes on from zero
    bytes, every MCU of the scan; a bad code (a magnitude past 15 bits, an
    index past the band) leaves every later MCU as it is up to the next
    restart."""
    total, _, unit_fn = _scan_units(header, scomps)
    walk = _restart_walk(data, scan.start, _intervals(total, scan.restart))[0]
    src = _ArithSource(data, scan.start)
    prog = header.progressive
    ss, se, al = scan.ss, scan.se, scan.al
    dc_first = not prog or (ss == 0 and scan.ah == 0)
    dc_refine = prog and ss == 0 and scan.ah > 0
    ac = not prog or ss > 0
    dc_stats = {t[0]: bytearray(64) for t in scan.arith}
    ac_stats = {t[3]: bytearray(256) for t in scan.arith}
    fixed = bytearray([_FIXED])
    slot = {id(c): j for j, c in enumerate(scomps)}
    last = [0] * len(scomps)
    ctx = [0] * len(scomps)
    zz = _ZZX
    p1, m1 = 1 << al, -1 << al
    units = unit_fn(0)

    def magnitude(st, i, x2):
        """Figures F.23 and F.24: |v| of a non-zero value and m, the top
        bit of its category (of |v| - 1), from the category's first bin
        ``st[i]``.  A DC value (``x2`` None) goes on from X1 = 20; an AC
        value tests ``st[i]`` again, then goes on from X2 = ``x2``.  Each
        category's magnitude bits take the bin 14 further on.  None: a
        category past 15 bits (a bad code)."""
        m = src.decode(st, i)
        if m and (x2 is None or src.decode(st, i)):
            if x2 is None:
                i = 20
            else:
                m, i = 2, x2
            while src.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    return None
                i += 1
        v, bit = m, m >> 1
        i += 14
        while bit:
            if src.decode(st, i):
                v |= bit
            bit >>= 1
        return v + 1, m

    def dc_diff(j, t):
        """Figure F.19 with the conditioning of F.1.4.4.1.2: the DC
        difference of a block of scan component j (None: a bad code)."""
        st = dc_stats[t[0]]
        s0 = ctx[j]
        if src.decode(st, s0) == 0:
            ctx[j] = 0
            return 0
        sign = src.decode(st, s0 + 1)
        got = magnitude(st, s0 + 2 + sign, None)
        if got is None:
            return None
        v, m = got
        if m < (1 << t[1]) >> 1:
            ctx[j] = 0
        elif m > (1 << t[2]) >> 1:
            ctx[j] = 12 + 4 * sign
        else:
            ctx[j] = 4 + 4 * sign
        return -v if sign else v

    def ac_band(coef, base, t, lo, hi):
        """Figure F.20: coefficients lo..hi, scaled by 2^Al (False: a bad
        code)."""
        st = ac_stats[t[3]]
        k = lo
        while k <= hi:
            i = 3 * (k - 1)
            if src.decode(st, i):
                break                            # EOB
            while src.decode(st, i + 1) == 0:
                i += 3
                k += 1
                if k > hi:
                    return False
            sign = src.decode(fixed, 0)
            got = magnitude(st, i + 2, 189 if k <= t[4] else 217)
            if got is None:
                return False
            coef[base + zz[k]] = _wrap16((-got[0] if sign else got[0]) << al)
            k += 1
        return True

    def ac_refine(coef, base, t):
        """Figure G.10's decoding: correction bits of coefficients already
        non-zero, new ones of +-1 << Al (False: a bad code)."""
        st = ac_stats[t[3]]
        kex = se
        while kex > 0 and not coef[base + zz[kex]]:
            kex -= 1
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if k > kex and src.decode(st, i):
                break                            # EOB
            while True:
                pos = base + zz[k]
                if coef[pos]:
                    if src.decode(st, i + 2):
                        coef[pos] = _wrap16(coef[pos]
                                            + (m1 if coef[pos] < 0 else p1))
                    break
                if src.decode(st, i + 1):
                    coef[pos] = m1 if src.decode(fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > se:
                    return False
            k += 1
        return True

    for mcu in range(total):
        if mcu and scan.restart and mcu % scan.restart == 0:
            src = _ArithSource(data, walk[mcu // scan.restart][0])
            for j, t in enumerate(scan.arith):
                if dc_first:
                    dc_stats[t[0]][:] = bytes(64)
                    last[j] = ctx[j] = 0
                if ac:
                    ac_stats[t[3]][:] = bytes(256)
        if src.ct == -1 and not dc_refine:
            continue
        for comp, base in units(mcu):
            j = slot[id(comp)]
            t = scan.arith[j]
            coef = comp.coef
            if dc_refine:
                if src.decode(fixed, 0):
                    coef[base] = _wrap16(coef[base] | p1)
                continue
            if dc_first:
                diff = dc_diff(j, t)
                if diff is None:
                    src.ct = -1
                    break
                last[j] = (last[j] + diff) & 0xFFFF
                coef[base] = _wrap16(last[j] << al)
            if ac:
                ok = (ac_band(coef, base, t, max(ss, 1), se) if scan.ah == 0
                      else ac_refine(coef, base, t))
                if not ok:
                    src.ct = -1
                    break


# ---------------------------------------------------------------------------
# progressive block smoothing (libjpeg-turbo's jdcoefct.c, 2.1 and later)
# ---------------------------------------------------------------------------

# natural positions of zigzag coefficients 1..9 (Q01 Q10 Q20 Q11 Q02 Q03
# Q12 Q21 Q30)
_SMOOTH_POS = _ZZ[1:10]
# 5 x 5 DC kernels (rows -2..2, columns -2..2) of each estimate: without
# DC interpolation (AC01..AC02) and with it (AC01..AC30, then the DC)
_K = np.array
_SMOOTH_PLAIN = [
    _K([[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7],
        [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]]),
    _K([[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0, 0, 0, 0, 0],
        [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]]),
    _K([[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
        [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]]),
    _K([[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0],
        [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]),
    _K([[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-1, 13, -24, 13, -1],
        [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]])]
_SMOOTH_DC = [
    _K([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
        [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]]),
    _K([[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0],
        [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]]),
    _K([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
        [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]]),
    _K([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
        [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]),
    _K([[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1],
        [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]]),
    _K([[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
        [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]]),
    _K([[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0],
        [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]]),
    _K([[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0],
        [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]]),
    _K([[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0],
        [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]])]
_SMOOTH_DC0 = _K([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                  [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                  [-2, -6, -8, -6, -2]])


def smoothing_plan(header: JpegHeader):
    """libjpeg's ``smoothing_ok`` for a progressive frame: per component,
    the accuracy bits (``coef_bits``) of zigzag coefficients 0..9 after
    the scans the file holds, and those before each component's last
    scan (-1 where there was none); or None where smoothing is off: a
    sequential frame, a component with no DC scan, a zero quantizer among
    the ten, or every component's coefficients 1..9 fully known (a
    complete file)."""
    if not header.progressive:
        return None
    nc = len(header.comps)
    bits = [[-1] * 64 for _ in range(nc)]
    prev = [[-1] * 10 for _ in range(nc)]
    for number, scan in enumerate(header.scans, 1):
        for k in scan.comps:
            for i in range(min(scan.ss, 1), max(scan.se, 9) + 1):
                if i < 10:
                    prev[k][i] = bits[k][i] if number > 1 else 0
            for i in range(scan.ss, scan.se + 1):
                bits[k][i] = scan.al
    if len(header.scans) < 2:
        prev = [[-1] * 10 for _ in range(nc)]
    useful = False
    for k, c in enumerate(header.comps):
        q = header.qt[c.tq].reshape(64)
        if q[0] == 0 or any(q[p] == 0 for p in _SMOOTH_POS) or bits[k][0] < 0:
            return None
        useful |= any(b != 0 for b in bits[k][1:10])
    return [(b[:10], p) for b, p in zip(bits, prev)] if useful else None


def _smooth_rows(c: _Component, rows: int, rule: str = "2.1"):
    """The rows decompress_smooth_data reads beside each block row y <
    ``c.hib``: (y - 2, y - 1, y, y + 1, y + 2) as libjpeg picks them, by
    iMCU rows (of ``c.v`` block rows; ``rows`` of them).  ``rule`` "2.1":
    libjpeg-turbo 2.1 (JAX's native path), whose rows two away fall back
    to the nearer one across the second and the second-to-last iMCU rows;
    "3.1": cv2's libjpeg-turbo 3.1, which clamps to the rows it holds
    (the padded grid but for the last iMCU row), two rows up only past
    the first iMCU row, or in the second where it holds more than one
    block row."""
    y = np.arange(c.hib)
    r, br = y // c.v, y % c.v
    last = rows - 1
    n = np.where(r < last, c.v, c.hib % c.v or c.v)
    if rule == "3.1":
        top = np.where(r == last, c.hib - 1, c.bh - 1)
        out = np.clip(y[:, None] + np.arange(-2, 3)[None, :], 0,
                      top[:, None])
        far = (br > 1) | (r > 1) | ((r == 1) & (n > 1))
        out[:, 0] = np.where(far, out[:, 0], out[:, 1])
        return out
    up = np.where((br > 0) | (r > 0), y - 1, y)
    up2 = np.where((br > 1) | (r > 1), y - 2, up)
    dn = np.where((br < n - 1) | (r < last), y + 1, y)
    dn2 = np.where((br < n - 2) | (r + 1 < last), y + 2, dn)
    return np.stack([up2, up, y, dn, dn2], -1)


def smooth_blocks(header: JpegHeader, k: int, coef: np.ndarray, plan,
                  last_good: int, rule: str = "2.1") -> np.ndarray:
    """Component ``k``'s coefficients [bh * bw, 64] after libjpeg's
    interblock smoothing (``decompress_smooth_data``): each of zigzag
    coefficients 1..9 that is zero and not fully known gets an estimate
    from the 5 x 5 DC neighbourhood, clamped below 2^Al; with no AC data at
    all the DC is interpolated too.  Block rows past the iMCU row
    ``last_good`` (where the last scan's data ran out) take the accuracy
    bits from before the component's last scan.  Only the image's own
    blocks change.  ``rule``: whose neighbour rows (``_smooth_rows``)."""
    c = header.comps[k]
    q = header.qt[c.tq].reshape(64).astype(np.int64)
    blocks = coef.reshape(c.bh, c.bw, 64).astype(np.int64)
    rows = _smooth_rows(c, header.imcu_rows, rule)
    cols = np.clip(np.arange(c.wib)[:, None] + np.arange(-2, 3)[None, :],
                   0, c.wib - 1)
    if c.wib == 2 and rule == "2.1":
        # libjpeg-turbo 2.1's first column sets only the register one to
        # its right, so two to the right stays the first column's DC
        cols = np.array([[0, 0, 0, 1, 0], [0, 0, 1, 0, 0]])
    dc = blocks[:, :, 0]
    # nb[i][j]: the DC at row offset i - 2, column offset j - 2
    nb = [[dc[rows[:, i]][:, cols[:, j]] for j in range(5)] for i in range(5)]
    out = blocks.copy()
    work = out[:c.hib, :c.wib]
    cur, prev = plan
    imcu = np.arange(c.hib) // c.v
    for bits, sel in ((cur, imcu <= last_good), (prev, imcu > last_good)):
        if not sel.any():
            continue
        w = work[sel]
        orig = blocks[:c.hib, :c.wib][sel]
        change_dc = all(b == -1 for b in bits[1:10])
        kernels = _SMOOTH_DC if change_dc else _SMOOTH_PLAIN

        def conv(kern):
            return sum(int(kern[i, j]) * nb[i][j][sel] for i in range(5)
                       for j in range(5) if kern[i, j])

        for i, kern in enumerate(kernels):
            al, pos = bits[i + 1], _SMOOTH_POS[i]
            if al == 0:
                continue
            num = q[0] * conv(kern)
            qk = int(q[pos])
            pred = ((qk << 7) + np.abs(num)) // (qk << 8)
            if al > 0:
                pred = np.minimum(pred, (1 << al) - 1)
            pred = np.where(num >= 0, pred, -pred)
            w[..., pos] = np.where(orig[..., pos] == 0, pred, orig[..., pos])
        if change_dc:
            num = q[0] * conv(_SMOOTH_DC0)
            q0 = int(q[0])
            pred = ((q0 << 7) + np.abs(num)) // (q0 << 8)
            w[..., 0] = np.where(num >= 0, pred, -pred)
        work[sel] = w
    return (((out + 32768) & 0xFFFF) - 32768).astype(np.int32) \
        .reshape(-1, 64)


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


def _w16(x):
    """x wrapped to int16, as a 16-bit SIMD lane holds it."""
    return ((x + 32768) & 0xFFFF) - 32768


def _w32(x):
    """x wrapped to int32, as a 32-bit SIMD lane holds it."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_1d(c):
    """One islow pass over the last axis of c [..., 8] (int64): the eight
    outputs before their descale.  The sums c0 +- c4, c7 + c3 and c5 + c1
    wrap at 16 bits, as libjpeg-turbo's SIMD islow forms them (``paddw``);
    everything else is exact, as its ``pmaddwd`` pairs are."""
    z2, z3 = c[..., 2], c[..., 6]
    z1 = (z2 + z3) * _F0_541
    tmp2 = z1 + z3 * (-_F1_847)
    tmp3 = z1 + z2 * _F0_765
    tmp0 = _w16(c[..., 0] + c[..., 4]) << 13
    tmp1 = _w16(c[..., 0] - c[..., 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[..., 7], c[..., 5], c[..., 3], c[..., 1]
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = _w16(t0 + t2), _w16(t1 + t3)
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
# the rows whose coefficients the SIMD islow and 4x4 test for zero: where
# all are zero in all eight columns, the first pass is the DC shifted
_FLAT_ROWS = {8: [1, 2, 3, 4, 5, 6, 7], 4: [1, 2, 3, 5, 6, 7]}


def idct_scaled(coef: np.ndarray, q: np.ndarray, s: int = 8) -> np.ndarray:
    """Quantized blocks [n, 8, 8] (row = vertical frequency) and their
    table ``q`` [8, 8] -> samples [n, s, s] uint8: libjpeg's
    ``jpeg_idct_islow`` (s = 8) or ``jpeg_idct_4x4`` / ``_2x2`` / ``_1x1``
    (s = 4, 2, 1), bit for bit with what libjpeg-turbo runs on x86: its
    SIMD IDCTs for s = 8, 4, 2 and its C 1x1 (libjpeg's wrapping range
    limit).  The SIMD forms dequantize into int16 lanes and sum in int32
    lanes; the first pass's outputs are saturated to int16 (but for the
    2x2's column 0, which stays in int32), and a block whose rows 1-7
    (the 4x4: 1-3 and 5-7) hold only zeros takes a shortcut there: each
    column's dequantized DC times 4, wrapped to int16.  The outputs are
    saturated to 0..255.  Exact in int64 otherwise, so on any photo's
    coefficients these are the C routines' pixels."""
    c = coef.astype(np.int64)
    dq = c * np.asarray(q, np.int64)
    if s == 1:
        return _RANGE[((dq[:, 0, 0] + 4) >> 3) & 1023].reshape(-1, 1, 1)
    dq = _w16(dq)
    one_d, d1, d2 = _IDCT_PASSES[s]
    # pass 1: columns (vertical), ws[:, x, r]
    ws = _w32(one_d(np.swapaxes(dq, 1, 2)) + (1 << (d1 - 1))) >> d1
    sat = ws[:, 1:] if s == 2 else ws
    sat[...] = np.clip(sat, -32768, 32767)
    if s in _FLAT_ROWS:
        flat = ~c[:, _FLAT_ROWS[s], :].any((1, 2))
        ws[flat] = _w16(dq[flat, 0, :, None] << 2)
    # pass 2: rows
    out = _w32(one_d(np.swapaxes(ws, 1, 2)) + (1 << (d2 - 1))) >> d2
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


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


def cmyk_to_rgb(c: np.ndarray, m: np.ndarray, y: np.ndarray,
                k: np.ndarray) -> np.ndarray:
    """cv2's CMYK -> BGR (``icvCvt_CMYK2BGR_8u_C4C3R``), in RGB order:
    uint8 planes -> [h, w, 3] uint8."""
    kk = k.astype(np.int64)

    def one(x):
        return kk - (((255 - x.astype(np.int64)) * kk) >> 8)

    return np.stack([one(c), one(m), one(y)], -1).astype(np.uint8)


def ycck_to_cmyk(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """libjpeg's ``ycck_cmyk_convert`` for the first three planes: 255
    minus the YCbCr -> RGB result, clamped (K passes through)."""
    rgb = ycc_to_rgb(y, cb, cr)
    return [255 - rgb[..., i] for i in range(3)]


def reconstruct_jpeg(header: JpegHeader, coefs: List[np.ndarray],
                     m: int = 8) -> np.ndarray:
    """Quantized coefficients (``jpeg_coefficients``) -> the upright RGB
    image [H', W', 3] uint8 at scale m/8: the IDCT, the crop, the upsampling,
    the colour transform and the EXIF orientation."""
    out_w, out_h, layouts = jpeg_layout(header, m)
    planes = []
    for c, lay, blocks in zip(header.comps, layouts, coefs):
        samples = idct_scaled(blocks.reshape(-1, 8, 8), header.qt[c.tq],
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
    elif header.color == "cmyk":
        img = cmyk_to_rgb(*planes)
    elif header.color == "ycck":
        img = cmyk_to_rgb(*ycck_to_cmyk(*planes[:3]), planes[3])
    else:
        img = ycc_to_rgb(planes[0], planes[1], planes[2])
    return apply_orientation(img, header.orientation)


def decode_jpeg(data: bytes, m: int = 8, smooth: str = "2.1") -> np.ndarray:
    """JPEG bytes -> RGB [H', W', 3] uint8 at scale m/8 (m = 8: full size;
    see the module docstring); ``smooth``: whose interblock smoothing a cut
    progressive file takes ("2.1": JAX's native path, "3.1": cv2's)."""
    header = parse_jpeg(data)
    return reconstruct_jpeg(header, jpeg_coefficients(data, header, smooth),
                            m)


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


# Adam7's passes: (x start, y start, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_rows(raw: np.ndarray, height: int, stride: int, bpp: int):
    """``height`` filtered scanlines of ``stride`` bytes from ``raw`` ->
    (unfiltered uint8 [height, stride], the bytes they took)."""
    need = height * (stride + 1)
    if raw.size < need:
        raise DecodeError("truncated PNG data")
    rows = raw[:need].reshape(height, stride + 1)
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
    return out, need


def _png_samples(rows: np.ndarray, width: int, channels: int, depth: int,
                 ctype: int) -> np.ndarray:
    """Unfiltered scanlines -> samples [h, width, channels] uint8: 16-bit
    keeps the high byte, 1/2/4-bit gray expands to 8 bits (a palette index
    stays an index)."""
    height = rows.shape[0]
    if depth == 16:
        samples = rows.reshape(height, -1, 2)[:, :width * channels, 0]
    elif depth == 8:
        samples = rows[:, :width * channels]
    else:
        per = 8 // depth
        shifts = (8 - depth - depth * np.arange(per)).astype(np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = vals.reshape(height, -1)[:, :width * channels]
        if ctype != 3:  # gray expands to 8 bits (png_set_expand_gray_1_2_4_to_8)
            samples = (samples.astype(np.int32) * 255
                       // ((1 << depth) - 1)).astype(np.uint8)
    return samples.reshape(height, width, channels)


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
        crc = data[pos + 8 + length:pos + 12 + length]
        pos += 12 + length
        if ctype in (b"IHDR", b"PLTE", b"IDAT", b"IEND") and crc != \
                struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF):
            raise DecodeError(f"PNG {ctype.decode()} chunk CRC")  # libpng's
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
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise DecodeError(f"PNG colour type {ctype}")
    if interlace not in (0, 1):
        raise DecodeError(f"PNG interlace method {interlace}")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise DecodeError(f"PNG zlib: {exc}") from None
    bits = channels * depth
    bpp = max(1, bits // 8)
    if not interlace:
        rows, _ = _png_rows(raw, height, (width * bits + 7) // 8, bpp)
        px = _png_samples(rows, width, channels, depth, ctype)
    else:
        px = np.zeros((height, width, channels), np.uint8)
        for x0, y0, dx, dy in _ADAM7:
            w = -(-(width - x0) // dx) if width > x0 else 0
            h = -(-(height - y0) // dy) if height > y0 else 0
            if w == 0 or h == 0:
                continue            # an empty pass holds no scanlines
            rows, used = _png_rows(raw, h, (w * bits + 7) // 8, bpp)
            raw = raw[used:]
            px[y0::dy, x0::dx] = _png_samples(rows, w, channels, depth,
                                              ctype)
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


class _BmpStream:
    """cv2's RBaseStream over the bytes: a read past the end raises (and
    cv2.imread returns None)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise DecodeError("truncated BMP data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def word(self) -> int:
        return int.from_bytes(self.take(2), "little")

    def dword(self) -> int:
        return int.from_bytes(self.take(4), "little", signed=True)


def _bmp_header(data: bytes):
    """cv2's ``BmpDecoder::readHeader``: (offset, width, height, bpp (15 for
    5-5-5 16-bit), compression, BGR palette [256, 3], palette length)."""
    st = _BmpStream(data, 10)
    offset, size = st.dword(), st.dword()
    palette = np.zeros((256, 3), np.uint8)
    if size >= 36:
        width, height = st.dword(), st.dword()
        bpp, comp = st.dword() >> 16, st.dword()
        if not 0 <= comp <= 3:
            raise DecodeError(f"BMP compression {comp}")
        st.take(12)
        clrused = st.dword()
        st.take(size - 36)
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == 0)
            or (bpp in (16, 32) and comp in (0, 3))
            or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
        if not ok:
            raise DecodeError(f"BMP of {bpp} bits, compression {comp}")
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise DecodeError("BMP palette size")
            n = clrused or 1 << bpp
            quads = np.frombuffer(st.take(4 * n), np.uint8).reshape(n, 4)
            palette[:n] = quads[:, :3]
        elif bpp == 16 and comp == 3:
            red, green, blue = st.dword(), st.dword(), st.dword()
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                raise DecodeError("BMP bit fields other than 555 and 565")
        elif bpp == 16:
            bpp = 15
    elif size == 12:                   # OS/2
        width, height = st.word(), st.word()
        bpp, comp = st.dword() >> 16, 0
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise DecodeError(f"OS/2 BMP of {bpp} bits")
        if bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(st.take(3 * n), np.uint8).reshape(
                n, 3)
    else:
        raise DecodeError(f"BMP header of {size} bytes")
    return offset, width, height, bpp, comp, palette


def _bmp_rle(st: _BmpStream, width: int, height: int, palette: np.ndarray,
             four: bool) -> np.ndarray:
    """cv2's RLE8 / RLE4 loops over file rows -> BGR [height * width, 3]:
    a run that would pass its row's end fails the file; end of line, end
    of bitmap and a delta fill with palette entry 0; RLE8's runs and
    deltas carry on over rows, RLE4's delta moves along the row only."""
    out = np.zeros((height * width, 3), np.uint8)
    data, line_end, y = 0, width, 0
    flag = 0

    def fill(count, color):
        # cv2's FillUniColor from ``data``: across rows, up to ``height``
        nonlocal data, line_end, y
        while True:
            end = min(data + count, line_end)
            count -= end - data
            if end > data:
                out[data:end] = color
            data = max(data, end)
            if data >= line_end:
                line_end += width
                data = line_end - width
                y += 1
                if y >= height:
                    break
            if count <= 0:
                break

    def row(src, count):
        nonlocal data
        if four:
            idx = np.stack([src >> 4, src & 15], -1).reshape(-1)[:count]
        else:
            idx = src[:count]
        out[data:data + count] = palette[idx]
        data += count

    while True:
        code = st.word()
        length, code = code & 255, code >> 8
        if length:                                   # encoded mode
            prev = y
            if data + length > line_end:
                raise DecodeError("BMP run past its row")
            if four:
                pair = palette[[code >> 4, code & 15]]
                out[data:data + length] = pair[np.arange(length) & 1]
                data += length
            else:
                fill(length, palette[code])
                flag = y - prev
                if y >= height:
                    break
        elif code > 2:                               # absolute mode
            prev = y
            if data + code > line_end:
                raise DecodeError("BMP run past its row")
            size = ((code + 1) // 2 + 1) & ~1 if four else (code + 1) & ~1
            row(np.frombuffer(st.take(size), np.uint8), code)
            flag = y - prev
        elif four:
            shift = line_end - data
            if code == 2:
                shift = st.byte()
                st.byte()
            fill(shift, palette[0])
            if y >= height:
                break
        else:
            shift, yshift = line_end - data, height - y
            if code or not flag or shift < width:
                if code == 2:
                    shift, yshift = st.byte(), st.byte()
                if code != 0:
                    shift += yshift * width
                if y >= height:
                    break
                fill(shift, palette[0])
                if y >= height:
                    break
            flag = 0
            if y >= height:
                break
    return out


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> RGB [H, W, 3] uint8 as ``cv2.imread(IMREAD_COLOR)``
    reads them (``BmpDecoder``): rows bottom-up (positive height) or
    top-down; 1/4/8-bit palettes (BGRX quads, OS/2's BGR triples),
    uncompressed or RLE8/RLE4; 16-bit as 5-5-5 or 5-6-5 shifted up
    without fill bits; 24-bit; 32-bit dropping its fourth byte whatever its
    bit fields.  What cv2 refuses is a ``DecodeError``."""
    if data[:2] != b"BM" or len(data) < 30:
        raise DecodeError("not a BMP")
    offset, width, height, bpp, comp, palette = _bmp_header(data)
    rows_n = abs(height)
    st = _BmpStream(data, offset)
    if comp in (1, 2):
        img = _bmp_rle(st, width, rows_n, palette, comp == 2)
        img = img.reshape(rows_n, width, 3)
    else:
        pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        raw = np.frombuffer(st.take(pitch * rows_n), np.uint8).reshape(
            rows_n, pitch)
        if bpp <= 8:
            per = 8 // bpp
            shifts = (8 - bpp - bpp * np.arange(per)).astype(np.uint8)
            idx = ((raw[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(
                rows_n, -1)[:, :width]
            img = palette[idx]
        elif bpp in (15, 16):
            t = raw[:, :2 * width].view("<u2").astype(np.int32)
            if bpp == 15:
                img = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8,
                                (t >> 7) & 0xF8], -1)
            else:
                img = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC,
                                (t >> 8) & 0xF8], -1)
            img = img.astype(np.uint8)
        else:
            img = raw[:, :width * bpp // 8].reshape(rows_n, width,
                                                     bpp // 8)[:, :, :3]
    img = img[:, :, ::-1]                            # BGR -> RGB
    return np.ascontiguousarray(img if height < 0 else img[::-1])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def decode_image(data: bytes) -> np.ndarray:
    """Encoded bytes -> upright RGB [H, W, 3] uint8 (``cv2.imread``'s
    IMREAD_COLOR pixels, in RGB order)."""
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, smooth="3.1")
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
    or None where JAX's decode returns None.  With ``prescale`` the file
    takes JAX's native path (a JPEG at the DCT scale for ``prescale_min =
    2 * resize_dim``; what libjpeg-turbo 2.1 cannot decode to RGB, or
    meets an error after, is None),
    else ``cv2.imread``'s."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    try:
        if prescale:
            header = parse_jpeg(data)
            if header.color not in ("ycc", "rgb", "gray") or \
                    header.tail_error:
                return None
            m = prescale_factor((header.width, header.height), 2 * resize_dim)
            img = reconstruct_jpeg(header, jpeg_coefficients(data, header), m)
        else:
            img = decode_image(data)
    except DecodeError:
        return None
    img = resize_bilinear(img, resize_dim, resize_dim)
    if channel_order == "bgr":
        img = img[:, :, ::-1]
    return np.ascontiguousarray(img)
