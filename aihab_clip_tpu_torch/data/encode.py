"""A small baseline JPEG encoder in numpy (the counterpart of
``cv2.imwrite(path, img)`` as ``aihab_clip_tpu/data/synthetic.py`` uses it):
libjpeg's defaults at quality 95 — its fixed-point RGB -> YCbCr, 4:2:0
chroma by libjpeg's h2v2 averaging (alternating bias 1, 2), the integer
"islow" forward DCT (``jfdctint.c``), quantization by the standard tables
scaled to the quality, the standard Huffman tables, a JFIF header, no
restart markers.  The machine that runs the card has no ``cv2``; the
synthetic CS tree is written with this."""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from .decode import _ZIGZAG

_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_STD_CHROMA_Q = np.full(64, 99, np.int64)
_STD_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# (counts of code lengths 1..16, symbols): JPEG Annex K.3 tables
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` + ``jpeg_add_quant_table`` with
    ``force_baseline``: natural-order table, entries in [1, 255]."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _code_table(spec):
    """(counts, symbols) -> {symbol: (code, length)} (canonical codes)."""
    counts, symbols = spec
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def rgb_to_ycc(img: np.ndarray) -> np.ndarray:
    """libjpeg's ``rgb_ycc_convert`` (SCALEBITS 16): [H, W, 3] uint8 RGB ->
    [3, H, W] int64 Y, Cb, Cr."""

    def fix(f):
        return int(f * (1 << 16) + 0.5)

    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    cbcr_off = (128 << 16) + half - 1
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + cbcr_off) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr_off) >> 16
    return np.stack([y, cb, cr])


def _fdct_1d(d, final: bool):
    """One islow forward pass over the last axis of d [..., 8] (int64)."""
    c13, p1 = 13, 2
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    sh = c13 + p1 if final else c13 - p1

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    out = [None] * 8
    if final:
        out[0] = descale(tmp10 + tmp11, p1)
        out[4] = descale(tmp10 - tmp11, p1)
    else:
        out[0] = (tmp10 + tmp11) << p1
        out[4] = (tmp10 - tmp11) << p1
    z1 = (tmp12 + tmp13) * 4433
    out[2] = descale(z1 + tmp13 * 6270, sh)
    out[6] = descale(z1 - tmp12 * 15137, sh)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5 = tmp4 * 2446, tmp5 * 16819
    tmp6, tmp7 = tmp6 * 25172, tmp7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[7] = descale(tmp4 + z1 + z3, sh)
    out[5] = descale(tmp5 + z2 + z4, sh)
    out[3] = descale(tmp6 + z2 + z3, sh)
    out[1] = descale(tmp7 + z1 + z4, sh)
    return np.stack(out, -1)


def fdct_quantize(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Samples [n, 8, 8] (0..255) -> quantized coefficients [n, 64] in
    natural order: ``jpeg_fdct_islow`` then libjpeg's rounding division by
    8 x the table."""
    d = blocks.astype(np.int64) - 128
    d = _fdct_1d(d, final=False)                      # rows
    d = _fdct_1d(np.swapaxes(d, 1, 2), final=True)    # columns
    coef = np.swapaxes(d, 1, 2).reshape(-1, 64)
    q = (qtable.astype(np.int64) << 3)[None, :]
    mag = (np.abs(coef) + (q >> 1)) // q
    return np.where(coef < 0, -mag, mag)


def _pad_edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = h - plane.shape[0], w - plane.shape[1]
    return np.pad(plane, ((0, max(ph, 0)), (0, max(pw, 0))), mode="edge")


def _h2v2_downsample(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """libjpeg's ``h2v2_downsample``: 2x2 means with bias 1, 2, 1, 2 ...
    along each output row, the input edge-replicated first."""
    p = _pad_edge(plane, 2 * out_h, 2 * out_w)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_w) % 2 == 0, 1, 2)[None, :]
    return (s + bias) >> 2


def _downsample(plane: np.ndarray, fh: int, fv: int, out_h: int,
                out_w: int) -> np.ndarray:
    """A chroma plane averaged over fh x fv: libjpeg's ``h2v2_downsample``
    and ``h2v1_downsample`` (bias 0, 1, 0, 1 ... along each row), else its
    ``int_downsample`` (the mean, rounded)."""
    if (fh, fv) == (2, 2):
        return _h2v2_downsample(plane, out_h, out_w)
    p = _pad_edge(plane, fv * out_h, fh * out_w)[:fv * out_h, :fh * out_w]
    s = p.reshape(out_h, fv, out_w, fh).sum((1, 3))
    if (fh, fv) == (2, 1):
        return (s + (np.arange(out_w) % 2)[None, :]) >> 1
    return (s + fh * fv // 2) // (fh * fv)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with ones
        return bytes(self.out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_jpeg(img: np.ndarray, quality: int = 95,
                sampling: Tuple[int, int] = (2, 2)) -> bytes:
    """RGB [H, W, 3] uint8 (or [H, W] gray) -> baseline JPEG bytes, 4:2:0
    for colour, as ``cv2.imwrite`` writes at its defaults.  ``sampling``
    gives the luma's (h, v) sampling factors over the chroma's (1, 1):
    (2, 1) is 4:2:2, (1, 1) 4:4:4, (1, 2) 4:4:0 (valid baseline files; the
    bytes are cv2's at 4:2:0 only)."""
    img = np.asarray(img, np.uint8)
    gray = img.ndim == 2
    height, width = img.shape[:2]
    if gray:
        planes = [img.astype(np.int64)]
        factors = [(1, 1)]
    else:
        planes = list(rgb_to_ycc(img))
        factors = [tuple(sampling), (1, 1), (1, 1)]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    luma_q = quality_table(_STD_LUMA_Q, quality)
    chroma_q = quality_table(_STD_CHROMA_Q, quality)
    tables = [(luma_q, _code_table(_DC_LUMA), _code_table(_AC_LUMA))]
    if not gray:
        tables.append((chroma_q, _code_table(_DC_CHROMA),
                       _code_table(_AC_CHROMA)))

    comps = []
    for ci, (plane, (h, v)) in enumerate(zip(planes, factors)):
        cw = -(-width * h // hmax)
        ch = -(-height * v // vmax)
        wb, hb = -(-cw // 8), -(-ch // 8)
        if (h, v) != (hmax, vmax):
            plane = _downsample(plane, hmax // h, vmax // v, ch, 8 * wb)
        plane = _pad_edge(plane, 8 * hb, 8 * wb)[:8 * hb, :8 * wb]
        blocks = plane.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3) \
            .reshape(-1, 8, 8)
        q = tables[min(ci, 1)][0]
        coef = fdct_quantize(blocks, q)[:, _ZIGZAG].reshape(hb, wb, 64)
        comps.append((h, v, wb, hb, coef.tolist(), min(ci, 1)))

    bw = _BitWriter()
    preds = [0] * len(comps)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (h, v, wb, hb, coef, ti) in enumerate(comps):
                _, dc_tab, ac_tab = tables[ti]
                for y in range(v):
                    for x in range(h):
                        by, bx = my * v + y, mx * h + x
                        if by < hb and bx < wb:
                            blk = coef[by][bx]
                        else:  # a dummy block: the previous DC, no AC
                            blk = [preds[ci]] + [0] * 63
                        _encode_block(bw, blk, preds[ci], dc_tab, ac_tab)
                        preds[ci] = blk[0]
    scan = bw.flush()

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for ti, (q, _, _) in enumerate(tables):
        out.append(_segment(0xDB, bytes([ti]) + bytes(
            q[_ZIGZAG].astype(np.uint8).tolist())))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") \
        + bytes([len(comps)])
    for ci, (h, v, *_rest, ti) in enumerate(comps):
        sof += bytes([ci + 1, (h << 4) | v, ti])
    out.append(_segment(0xC0, sof))
    specs = [(0x00, _DC_LUMA), (0x10, _AC_LUMA)]
    if not gray:
        specs += [(0x01, _DC_CHROMA), (0x11, _AC_CHROMA)]
    for tc_th, (counts, symbols) in specs:
        out.append(_segment(0xC4, bytes([tc_th] + counts + symbols)))
    sos = bytes([len(comps)])
    for ci, (*_rest, ti) in enumerate(comps):
        sos += bytes([ci + 1, (ti << 4) | ti])
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def _encode_block(bw: _BitWriter, blk: List[int], pred: int, dc_tab,
                  ac_tab) -> None:
    diff = blk[0] - pred
    mag = abs(diff)
    s = mag.bit_length()
    code, ln = dc_tab[s]
    bw.put(code, ln)
    if s:
        bw.put(diff if diff >= 0 else diff - 1 & ((1 << s) - 1), s)
    run = 0
    for k in range(1, 64):
        v = blk[k]
        if v == 0:
            run += 1
            continue
        while run > 15:
            code, ln = ac_tab[0xF0]
            bw.put(code, ln)
            run -= 16
        mag = abs(v)
        s = mag.bit_length()
        code, ln = ac_tab[(run << 4) | s]
        bw.put(code, ln)
        bw.put(v if v >= 0 else (v - 1) & ((1 << s) - 1), s)
        run = 0
    if run:
        code, ln = ac_tab[0x00]
        bw.put(code, ln)


def write_jpeg(path, img: np.ndarray, quality: int = 95) -> None:
    """Write RGB ``img`` to ``path`` as a baseline JPEG."""
    Path(path).write_bytes(encode_jpeg(img, quality))
