"""The fast JPEG decode: entropy decoding on the host in C++, pixels on the
card.

The JAX package decodes JPEGs with libjpeg on the host
(``native/image_pipeline.cpp:58-111``; no TPU kernel).  Here a batch of N
JPEGs decodes in three stages:

  1. ``data/decode.parse_jpeg`` reads each header (Python), and
     ``csrc/jpeg_entropy.cpp`` decodes the scans (Huffman or arithmetic
     coding, sequential or progressive; a cut file as libjpeg decodes it,
     with its interblock smoothing where a progressive one needs it), one
     photo a thread,
     into int16 coefficients in pinned memory: only those the chosen IDCT
     reads (64, 49, 25 or 1 a block).
  2. **J1** ``jpeg_idct`` (``csrc/jpeg_pixels.cu``): dequantize and IDCT
     every block of every photo at its component's scaled size (libjpeg's
     islow 8x8, or its reduced 4x4 / 2x2 / 1x1 of ``jidctred.c``, as
     libjpeg-turbo's SIMD forms run them) into the component planes: one
     launch for the batch, whatever the component count.
  3. **J2** ``jpeg_color_resize``: for each output pixel of [N, D, D, 3],
     the four taps of the native path's fixed-point bilinear resize, each
     through the EXIF orientation, the chroma upsampling (h2v1 / h1v2 /
     h2v2 fancy, or replication) and libjpeg's fixed-point YCbCr -> RGB:
     one launch for the batch.  Only the samples the resize reads are
     computed.  Its second instance ``jpeg_color_resize_cmyk`` takes the
     four-component photos: Adobe CMYK, or YCCK through libjpeg's YCCK ->
     CMYK, then cv2's CMYK -> BGR, in integers.

The kernels are integer arithmetic, bit for bit with ``data/decode.py``
(and so with libjpeg's pixels and the native path's resize).  Beside each
is its plain version, in int64 tensor ops per block and per output pixel:
the CPU runs it (a wrapper takes it only for tensors on the CPU), the tests
hold it against ``data/decode.py``, and ``chip_smoke.py`` holds the kernel
against it.  Launches are counted on each wrapper (``launch_counts``).

``decode_blobs`` routes encoded images as the JAX package does, by the
route of the caller (``ROUTES``): JAX's native libjpeg path, cv2's
``imread`` or ``imdecode``, or its server's native-then-cv2 order.

On the card, a call decodes on a CUDA stream of its own, so it never waits
behind a classify batch on the current stream, and uploads from pinned
staging.  The C++ library is built on first use by the host compiler
(``ops/_build.host_library``); if it cannot be built, decoding raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.decode import (DecodeError, JpegHeader, decode_image, jpeg_layout,
                           linear_taps, parse_jpeg, prescale_factor,
                           resize_bilinear, smoothing_plan)
from ._build import host_library, launch

# natural indices each IDCT size reads, in packed order (jidctred.c: the
# 4x4 never reads row or column 4; the 2x2 reads rows and columns 0, 1, 3,
# 5 and 7; the 1x1 the DC)
_KEEP4 = [r * 8 + c for r in (0, 1, 2, 3, 5, 6, 7) for c in (0, 1, 2, 3, 5, 6, 7)]
_KEEP2 = [r * 8 + c for r in (0, 1, 3, 5, 7) for c in (0, 1, 3, 5, 7)]
KEEP = {8: list(range(64)), 4: _KEEP4, 2: _KEEP2, 1: [0]}
# values a block takes in the upload: the 4x4's KEEP and a 50th, 1 where
# column 4 holds a non-zero in rows 1-3 or 5-7 (the SIMD 4x4's zero test
# reads it; ``pack_blocks``)
PACKED = {8: 64, 4: 50, 2: 25, 1: 1}

# J1's segment table: one row per (photo, component), int64
SEG_COEF, SEG_PLANE, SEG_BW, SEG_NB, SEG_S, SEG_QT, SEG_FIRST = range(7)
SEG_FIELDS = 8
# J2's photo table: one row per photo, int64; then 4 component slots
PH_OUT, PH_NCOMP, PH_COLOR, PH_ORIENT, PH_W, PH_H = range(6)
PH_SLOT, SLOT_FIELDS = 6, 7
PH_FIELDS = PH_SLOT + 4 * SLOT_FIELDS
SL_OFF, SL_STRIDE, SL_DW, SL_DH, SL_HR, SL_VR, SL_MODE = range(7)
MODES = {"none": 0, "box": 1, "h2v1": 2, "h1v2": 3, "h2v2": 4}
COLORS = {"ycc": 0, "rgb": 1, "gray": 2, "cmyk": 3, "ycck": 4}
# jpeg_entropy.cpp's scan descriptor, photo descriptor and table layout
_SCAN_SLOTS, _SLOT_FIELDS = 15, 9
_SCAN_FIELDS = _SCAN_SLOTS + 4 * _SLOT_FIELDS
_PI_SLOTS, _PI_FIELDS = 4, 37
_PHOTO_FIELDS = _PI_SLOTS + 4 * _PI_FIELDS
_TABLE_BYTES = 16 + 256
_STATUS = {4: "bad Huffman table", 5: "bad scan layout"}
# interblock smoothing rules of jpeg_entropy.cpp (data/decode.py's names)
_RULES = {None: 0, "2.1": 1, "3.1": 2}
# natural positions of zigzag coefficients 0..9 (the smoothing's quantizers)
_Q10 = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]


def _align(n: int, a: int = 8) -> int:
    return -(-n // a) * a


@dataclasses.dataclass
class Plan:
    """One batch's layout: the parsed photos (``index`` into the caller's
    blobs), the entropy decoder's scan table, photo descriptors and
    Huffman specs, the coefficient buffer's size, J1's segment table and
    quantization tables, the planes' size, J2's photo table and resize
    taps."""

    index: List[int]
    scans: np.ndarray
    photo_scans: np.ndarray
    photo_info: np.ndarray
    tables: np.ndarray
    coef_total: int
    segs: np.ndarray
    qtables: np.ndarray
    plane_total: int
    photos: np.ndarray
    taps_x: np.ndarray
    taps_y: np.ndarray
    unscanned: List[Tuple[int, int]]   # coefficient ranges no scan writes
    tails: List[bytes]                 # JpegHeader.tail of each photo


def _photo_info(h: JpegHeader, lays, comp_off, rule) -> np.ndarray:
    """jpeg_entropy.cpp's descriptor of a photo: whether it is progressive,
    its components, iMCU rows and smoothing rule (0: none, where
    ``smoothing_plan`` finds nothing to estimate), and per component its
    blocks, IDCT size, quantizers and accuracy bits."""
    row = np.zeros(_PHOTO_FIELDS, np.int64)
    plan = smoothing_plan(h) if rule is not None else None
    row[:_PI_SLOTS] = (h.progressive, len(h.comps), h.imcu_rows,
                       _RULES[rule] if plan is not None else 0)
    for k, (c, lay) in enumerate(zip(h.comps, lays)):
        f = _PI_SLOTS + k * _PI_FIELDS
        q = h.qt[c.tq].reshape(64)[_Q10]
        bits, prev = plan[k] if plan is not None else ([0] * 10, [0] * 10)
        row[f:f + _PI_FIELDS] = (c.bw, c.bh, c.wib, c.hib, c.v, comp_off[k],
                                 lay.s, *q, *bits, *prev)
    return row


def plan_batch(headers: Sequence[JpegHeader], scales: Sequence[int],
               dim: int, index: Optional[List[int]] = None,
               layouts: Optional[list] = None, rules=None) -> Plan:
    """Lay out the decode of ``headers`` at scales m/8 (``scales``) into
    [len(headers), dim, dim, 3]; ``layouts`` (one ``jpeg_layout`` result a
    photo) overrides the scales' own; ``rules`` (one a photo) names the
    interblock smoothing of a cut progressive photo ("2.1", the default:
    JAX's native path; "3.1": cv2's).  A scan slot carries its Huffman
    tables' indices into ``tables``, or in an arithmetic-coded photo its
    statistics tables and their conditioning (DC: table | L << 4 | U <<
    8; AC: table | Kx << 4)."""
    spec_ids: dict = {}
    scans, photo_scans, info = [], [0], []
    segs, photos, taps_x, taps_y, unscanned = [], [], [], [], []
    qts: dict = {}
    coef_total = plane_total = first = 0
    rules = rules if rules is not None else ["2.1"] * len(headers)
    for p, (h, m) in enumerate(zip(headers, scales)):
        out_w, out_h, lays = (jpeg_layout(h, m) if layouts is None
                              else layouts[p])
        comp_off = []
        row = np.zeros(PH_FIELDS, np.int64)
        row[[PH_OUT, PH_NCOMP, PH_COLOR, PH_ORIENT, PH_W, PH_H]] = (
            p, len(h.comps), COLORS[h.color], h.orientation, out_w, out_h)
        for k, (c, lay) in enumerate(zip(h.comps, lays)):
            nb = c.bw * c.bh
            qi = qts.setdefault((p, c.tq), len(qts))
            segs.append([coef_total, plane_total, c.bw, nb, lay.s, qi, first,
                         0])
            comp_off.append(coef_total)
            slot = PH_SLOT + k * SLOT_FIELDS
            row[slot:slot + SLOT_FIELDS] = (
                plane_total, c.bw * lay.s, lay.dw, lay.dh, lay.hr, lay.vr,
                MODES[lay.mode])
            first += nb
            coef_total += _align(nb * PACKED[lay.s])
            plane_total += _align(nb * lay.s * lay.s, 16)
        scanned = set()
        for scan in h.scans:
            d = np.zeros(_SCAN_FIELDS, np.int64)
            d[:_SCAN_SLOTS] = (p, scan.start, scan.end, scan.restart,
                               h.width, h.height, h.hmax, h.vmax,
                               len(scan.comps), scan.ss, scan.se, scan.ah,
                               scan.al, h.progressive, h.arithmetic)
            for j, (k, dc, ac) in enumerate(zip(scan.comps, scan.dc,
                                                scan.ac)):
                c, lay = h.comps[k], lays[k]
                if h.arithmetic:     # statistics tables and conditioning
                    dt, lo, hi, at, kx = scan.arith[j]
                    ids = [dt | lo << 4 | hi << 8, at | kx << 4]
                else:
                    ids = [spec_ids.setdefault(spec, len(spec_ids))
                           for spec in (dc, ac)]
                f = _SCAN_SLOTS + j * _SLOT_FIELDS
                d[f:f + _SLOT_FIELDS] = (c.h, c.v, c.bw, c.bh, comp_off[k],
                                         lay.s, *ids, k)
                scanned.add(k)
            scans.append(d)
        for k, c in enumerate(h.comps):
            if k not in scanned and not h.progressive:
                unscanned.append((comp_off[k], c.bw * c.bh
                                  * PACKED[lays[k].s]))
        photo_scans.append(len(scans))
        info.append(_photo_info(h, lays, comp_off, rules[p]))
        photos.append(row)
        oriented = (out_h, out_w) if h.orientation >= 5 else (out_w, out_h)
        for taps, src in ((taps_x, oriented[0]), (taps_y, oriented[1])):
            i0, i1, _, w1 = linear_taps(src, dim)
            taps.append(np.stack([i0, i1, w1], -1).astype(np.int32))
    tables = np.zeros((max(1, len(spec_ids)), _TABLE_BYTES), np.uint8)
    for spec, i in spec_ids.items():
        tables[i, :len(spec)] = np.frombuffer(spec, np.uint8)
    qtables = np.zeros((max(1, len(qts)), 64), np.uint16)
    for (p, tq), i in qts.items():
        qtables[i] = headers[p].qt[tq].reshape(64)
    return Plan(
        index=list(range(len(headers))) if index is None else index,
        scans=np.asarray(scans, np.int64).reshape(-1, _SCAN_FIELDS),
        photo_scans=np.asarray(photo_scans, np.int64),
        photo_info=np.asarray(info, np.int64).reshape(-1, _PHOTO_FIELDS),
        tables=tables, coef_total=coef_total,
        segs=np.asarray(segs, np.int64).reshape(-1, SEG_FIELDS),
        qtables=qtables, plane_total=plane_total,
        photos=np.asarray(photos, np.int64).reshape(-1, PH_FIELDS),
        taps_x=np.asarray(taps_x, np.int32).reshape(-1, dim, 3),
        taps_y=np.asarray(taps_y, np.int32).reshape(-1, dim, 3),
        unscanned=unscanned, tails=[h.tail for h in headers])


def entropy_decode(plan: Plan, blobs: Sequence[bytes], coef: torch.Tensor,
                   threads: int = 0) -> np.ndarray:
    """Entropy-decode the plan's photos (``blobs[plan.index[p]]``) into
    ``coef`` (int16, CPU, ``plan.coef_total``) with
    ``csrc/jpeg_entropy.cpp``; returns the status of each photo (0 = ok,
    else a key of ``_STATUS``)."""
    lib = host_library("jpeg_entropy")
    n = len(plan.index)
    if coef.dtype != torch.int16 or coef.device.type != "cpu" \
            or not coef.is_contiguous() or coef.numel() < plan.coef_total:
        raise ValueError("entropy_decode needs a contiguous int16 CPU buffer "
                         f"of {plan.coef_total} values")
    for off, size in plan.unscanned:
        coef[off:off + size].zero_()
    chosen = [blobs[i] + tail for i, tail in zip(plan.index, plan.tails)]
    ptrs = (ctypes.c_char_p * max(1, n))(*chosen)
    lens = np.asarray([len(b) for b in chosen] or [0], np.int64)
    status = np.zeros(max(1, n), np.int32)
    info = np.ascontiguousarray(plan.photo_info if n else
                                np.zeros((1, _PHOTO_FIELDS), np.int64))
    threads = threads or min(n, os.cpu_count() or 1)
    rc = lib.aihab_jpeg_entropy(
        ctypes.addressof(ptrs), lens.ctypes.data, plan.scans.ctypes.data,
        plan.photo_scans.ctypes.data, info.ctypes.data, n,
        plan.tables.ctypes.data, len(plan.tables), coef.data_ptr(),
        status.ctypes.data, threads)
    if rc != 0:
        raise RuntimeError("jpeg_entropy could not start its threads")
    return status[:n]


def coefficients(data: bytes, s: int = 8, rule: Optional[str] = "2.1"
                 ) -> List[np.ndarray]:
    """One JPEG's quantized coefficients by the C++ decoder, per component
    int16 [bh * bw, PACKED[s]]: at s = 8 all 64 in natural order, what
    ``data/decode.jpeg_coefficients(data, smooth=rule)`` gives; else
    those packed by ``pack_blocks``.  Raises ``DecodeError`` where that
    function does."""
    header = parse_jpeg(data)
    out_w, out_h, layouts = jpeg_layout(header, 8)
    layouts = [dataclasses.replace(lay, s=s) for lay in layouts]
    plan = plan_batch([header], [8], 1, layouts=[(out_w, out_h, layouts)],
                      rules=[rule])
    coef = torch.empty(max(1, plan.coef_total), dtype=torch.int16)
    status = int(entropy_decode(plan, [data], coef)[0])
    if status:
        raise DecodeError(_STATUS[status])
    return [coef[off:off + nb * PACKED[s]].view(nb, PACKED[s]).numpy().copy()
            for off, nb in plan.segs[:, [SEG_COEF, SEG_NB]].tolist()]


def arith_encode_scan(header: JpegHeader, coef: np.ndarray, offsets,
                      comps: Sequence[int], band: Tuple[int, int, int, int],
                      restart: int, conds, progressive: bool) -> bytes:
    """jcarith.c's coding of one scan of ``header``'s frame geometry by
    ``csrc/jpeg_entropy.cpp`` (``aihab_jpeg_arith_encode``): ``coef``
    int16, every component's [bh * bw, 64] blocks (natural order) from its
    ``offsets`` entry; the scan's component indices ``comps``, its ``band``
    (Ss, Se, Ah, Al) and restart interval, and per component (DC table, L,
    U, AC table, Kx) in ``conds``, in a ``progressive`` frame or not: the
    entropy-coded bytes, RSTn markers included.  The fixture tool's
    (``tools/jpeg_fixtures.arith_recode``); no decode calls it."""
    lib = host_library("jpeg_entropy")
    d = np.zeros(_SCAN_FIELDS, np.int64)
    d[:_SCAN_SLOTS] = (0, 0, 0, restart, header.width, header.height,
                       header.hmax, header.vmax, len(comps), *band,
                       progressive, True)
    for j, (k, (dt, lo, hi, at, kx)) in enumerate(zip(comps, conds)):
        c = header.comps[k]
        f = _SCAN_SLOTS + j * _SLOT_FIELDS
        d[f:f + _SLOT_FIELDS] = (c.h, c.v, c.bw, c.bh, offsets[k], 8,
                                 dt | lo << 4 | hi << 8, at | kx << 4, k)
    coef = np.ascontiguousarray(coef, np.int16)
    cap = 2 * coef.nbytes + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.aihab_jpeg_arith_encode(coef.ctypes.data, d.ctypes.data,
                                        out.ctypes.data, cap)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 4


def pack_blocks(blocks: np.ndarray, s: int) -> np.ndarray:
    """Quantized blocks [n, 64] (natural order) -> [n, PACKED[s]] as
    ``csrc/jpeg_entropy.cpp`` uploads them for the IDCT of size s."""
    out = np.zeros((len(blocks), PACKED[s]), blocks.dtype)
    out[:, :len(KEEP[s])] = blocks[:, KEEP[s]]
    if s == 4:
        out[:, 49] = blocks[:, [12, 20, 28, 44, 52, 60]].any(1)
    return out


# ---------------------------------------------------------------------------
# J1: dequantize + IDCT
# ---------------------------------------------------------------------------

# jidctint.c / jidctred.c constants (CONST_BITS 13)
_C = dict(f0_211=1730, f0_298=2446, f0_390=3196, f0_509=4176, f0_541=4433,
          f0_601=4926, f0_720=5906, f0_765=6270, f0_850=6967, f0_899=7373,
          f1_061=8697, f1_175=9633, f1_272=10426, f1_451=11893, f1_501=12299,
          f1_847=15137, f1_961=16069, f2_053=16819, f2_172=17799,
          f2_562=20995, f3_072=25172, f3_624=29692)


def _islow(c):
    """``jpeg_idct_islow``'s 1-D pass over the inputs c[0..7] (int64
    tensors): the 8 outputs before their descale; c0 +- c4, c7 + c3 and
    c5 + c1 wrap at 16 bits, as the SIMD form adds them."""
    k = _C
    z1 = (c[2] + c[6]) * k["f0_541"]
    tmp2 = z1 - c[6] * k["f1_847"]
    tmp3 = z1 + c[2] * k["f0_765"]
    tmp0 = _w16(c[0] + c[4]) * 8192
    tmp1 = _w16(c[0] - c[4]) * 8192
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    a0, a1, a2, a3 = c[7], c[5], c[3], c[1]
    z3, z4 = _w16(a0 + a2), _w16(a1 + a3)
    z5 = (z3 + z4) * k["f1_175"]
    z1 = -(a0 + a3) * k["f0_899"]
    z2 = -(a1 + a2) * k["f2_562"]
    z3 = -z3 * k["f1_961"] + z5
    z4 = -z4 * k["f0_390"] + z5
    o0 = a0 * k["f0_298"] + z1 + z3
    o1 = a1 * k["f2_053"] + z2 + z4
    o2 = a2 * k["f3_072"] + z2 + z3
    o3 = a3 * k["f1_501"] + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def _red4(c):
    """``jpeg_idct_4x4``'s 1-D pass (never reads c[4]): 4 outputs."""
    k = _C
    tmp0 = c[0] * 16384
    tmp2 = c[2] * k["f1_847"] - c[6] * k["f0_765"]
    t10, t12 = tmp0 + tmp2, tmp0 - tmp2
    z1, z2, z3, z4 = c[7], c[5], c[3], c[1]
    o0 = (-z1 * k["f0_211"] + z2 * k["f1_451"] - z3 * k["f2_172"]
          + z4 * k["f1_061"])
    o2 = (-z1 * k["f0_509"] - z2 * k["f0_601"] + z3 * k["f0_899"]
          + z4 * k["f2_562"])
    return [t10 + o2, t12 + o0, t12 - o0, t10 - o2]


def _red2(c):
    """``jpeg_idct_2x2``'s 1-D pass (reads c[0, 1, 3, 5, 7]): 2 outputs."""
    k = _C
    t10 = c[0] * 32768
    o = (-c[7] * k["f0_720"] + c[5] * k["f0_850"] - c[3] * k["f1_272"]
         + c[1] * k["f3_624"])
    return [t10 + o, t10 - o]


# (1-D pass, pass-1 descale bits, pass-2 descale bits)
_PASSES = {8: (_islow, 11, 18), 4: (_red4, 12, 19), 2: (_red2, 13, 20)}


def range_limit(x: torch.Tensor) -> torch.Tensor:
    """libjpeg's IDCT range limit on int64 x: (x + 128) clamped to
    [0, 255], with its table's wrap for wild x (index x & 1023): the C
    1x1 IDCT's."""
    i = x & 1023
    return torch.where(i < 128, i + 128, torch.where(
        i < 512, torch.full_like(i, 255), torch.where(
            i < 896, torch.zeros_like(i), i - 896))).to(torch.uint8)


def _w16(x: torch.Tensor) -> torch.Tensor:
    """x wrapped to int16, as a 16-bit SIMD lane holds it."""
    return ((x + 32768) & 0xFFFF) - 32768


def _w32(x: torch.Tensor) -> torch.Tensor:
    """x wrapped to int32, as a 32-bit SIMD lane holds it."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def idct_plain(c: torch.Tensor, q: torch.Tensor, s: int) -> torch.Tensor:
    """Packed quantized blocks [n, PACKED[s]] (``pack_blocks``) and their
    table's ``KEEP[s]`` entries ``q`` (int64) -> samples [n, s, s] uint8:
    J1's arithmetic per block, ``data/decode.idct_scaled``'s
    (libjpeg-turbo's SIMD IDCTs for s = 8, 4, 2: int16 inputs, int32 sums,
    the first pass saturated to int16 but for the 2x2's column 0, the
    shortcut of a block with no AC rows, saturated outputs; its C 1x1 for
    s = 1)."""
    n = c.shape[0]
    dq = c[:, :len(KEEP[s])] * q
    if s == 1:
        return range_limit((dq[:, 0] + 4) >> 3).view(n, 1, 1)
    full = torch.zeros(n, 64, dtype=torch.int64, device=c.device)
    full[:, KEEP[s]] = _w16(dq)
    full = full.view(n, 8, 8)
    one_d, d1, d2 = _PASSES[s]
    # pass 1 over the columns: ws[:, r, x] for the s outputs r
    rows = torch.stack([_w32(o + (1 << (d1 - 1))) >> d1
                        for o in one_d([full[:, r, :] for r in range(8)])], 1)
    sat = rows[:, :, 1:] if s == 2 else rows
    sat.clamp_(-32768, 32767)
    if s != 2:
        k = 8 if s == 8 else 7                  # packed row length
        flat = ~c[:, k:].any(1)                 # rows 1-7 (and the flag)
        rows[flat] = _w16(full[flat, 0, :] * 4).unsqueeze(1)
    # pass 2 over the s workspace rows: out[:, y, x]
    out = one_d([rows[:, :, x] for x in range(8)])         # s x [n, s]
    out = torch.stack([_w32(o + (1 << (d2 - 1))) >> d2 for o in out], 2)
    return (out.clamp(-128, 127) + 128).to(torch.uint8)


def jpeg_idct_plain(coef: torch.Tensor, qtables: torch.Tensor,
                    segs: torch.Tensor, planes: torch.Tensor) -> None:
    """Plain version of ``jpeg_idct`` (same arguments): per segment, the
    blocks' packed coefficients times the quantization table, the IDCT,
    and the s x s samples written into the block-padded plane."""
    for off, poff, bw, nb, s, qi, _, _ in segs.tolist():
        if nb == 0:
            continue
        k = PACKED[s]
        c = coef[off:off + nb * k].view(nb, k).long()
        q = qtables[qi].long()[KEEP[s]]
        samples = idct_plain(c, q, s)                      # [nb, s, s]
        bh = nb // bw
        plane = samples.view(bh, bw, s, s).permute(0, 2, 1, 3).reshape(-1)
        planes[poff:poff + plane.numel()] = plane


def jpeg_idct(coef: torch.Tensor, qtables: torch.Tensor, segs: torch.Tensor,
              planes: torch.Tensor) -> None:
    """J1: dequantize and IDCT every block of ``segs`` (int64 [n_seg,
    SEG_FIELDS]: coefficient offset, plane offset, blocks a row, blocks,
    IDCT size, table, first block) from ``coef`` (int16, packed) with
    ``qtables`` (uint16 [n, 64], natural order) into ``planes`` (uint8).
    Kernel on CUDA tensors, plain version on CPU tensors."""
    if not coef.is_cuda:
        return jpeg_idct_plain(coef, qtables, segs, planes)
    for t, dt in ((coef, torch.int16), (qtables, torch.uint16),
                  (segs, torch.int64), (planes, torch.uint8)):
        if t.dtype != dt or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"jpeg_idct expects contiguous CUDA {dt}")
    total = int(segs[:, SEG_NB].sum()) if len(segs) else 0
    if total == 0:
        return None
    launch("aihab_jpeg_idct", coef.device, coef.data_ptr(),
           qtables.data_ptr(), segs.data_ptr(), planes.data_ptr(), len(segs),
           total)
    jpeg_idct.launches += 1
    return None


# ---------------------------------------------------------------------------
# J2: upsample + colour + orientation + bilinear resize
# ---------------------------------------------------------------------------


def _sample(planes, slot, r, c):
    """Component ``slot`` (its J2 table fields) at unoriented output
    positions (r, c) (int64 tensors): its plane through its upsampling."""
    off, stride, dw, dh, hr, vr, mode = slot

    def at(y, x):
        return planes[off + y * stride + x].long()

    if mode == MODES["none"]:
        return at(r, c)
    if mode == MODES["box"]:
        return at(r // vr, c // hr)
    if mode == MODES["h2v1"]:
        x = c >> 1
        odd = (c & 1) == 1
        nb = torch.where(odd, (x + 1).clamp(max=dw - 1), (x - 1).clamp(min=0))
        return (3 * at(r, x) + at(r, nb) + torch.where(odd, 2, 1)) >> 2
    if mode == MODES["h1v2"]:
        y = r >> 1
        odd = (r & 1) == 1
        nb = torch.where(odd, (y + 1).clamp(max=dh - 1), (y - 1).clamp(min=0))
        return (3 * at(y, c) + at(nb, c) + torch.where(odd, 2, 1)) >> 2
    y, x = r >> 1, c >> 1
    ny = torch.where((r & 1) == 1, (y + 1).clamp(max=dh - 1),
                     (y - 1).clamp(min=0))
    oddc = (c & 1) == 1
    nx = torch.where(oddc, (x + 1).clamp(max=dw - 1), (x - 1).clamp(min=0))

    def cs(xx):
        return 3 * at(y, xx) + at(ny, xx)

    return (3 * cs(x) + cs(nx) + torch.where(oddc, 7, 8)) >> 4


def _ycc_rgb(y, cb, cr):
    """libjpeg's fixed-point YCbCr -> RGB (SCALEBITS 16), int64 planes ->
    [..., 3] clamped to 0..255."""
    cb, cr = cb - 128, cr - 128
    red = y + ((91881 * cr + 32768) >> 16)
    green = y + ((-22554 * cb - 46802 * cr + 32768) >> 16)
    blue = y + ((116130 * cb + 32768) >> 16)
    return torch.stack([red, green, blue], -1).clamp(0, 255)


def _rgb(planes, row, r, c):
    """The upright RGB pixel (int64 [..., 3]) at oriented positions (r, c)
    of the photo described by ``row`` (its J2 table fields)."""
    orient, out_w, out_h = row[PH_ORIENT], row[PH_W], row[PH_H]
    wo, ho = (out_h, out_w) if orient >= 5 else (out_w, out_h)
    r1 = ho - 1 - r if orient in (3, 4, 7, 8) else r
    c1 = wo - 1 - c if orient in (2, 3, 6, 7) else c
    ru, cu = (c1, r1) if orient >= 5 else (r1, c1)
    comps = [_sample(planes, row[PH_SLOT + k * SLOT_FIELDS:
                                 PH_SLOT + (k + 1) * SLOT_FIELDS], ru, cu)
             for k in range(row[PH_NCOMP])]
    color = row[PH_COLOR]
    if color == COLORS["gray"]:
        return torch.stack([comps[0]] * 3, -1)
    if color == COLORS["rgb"]:
        return torch.stack(comps, -1)
    if color == COLORS["ycc"]:
        return _ycc_rgb(*comps)
    cmy = (torch.stack(comps[:3], -1) if color == COLORS["cmyk"]
           else 255 - _ycc_rgb(*comps[:3]))   # libjpeg's YCCK -> CMYK
    k = comps[3][..., None]
    return k - (((255 - cmy) * k) >> 8)        # cv2's CMYK -> BGR


def jpeg_color_resize_plain(planes: torch.Tensor, photos: torch.Tensor,
                            taps_x: torch.Tensor, taps_y: torch.Tensor,
                            out: torch.Tensor) -> None:
    """Plain version of ``jpeg_color_resize`` and of its CMYK instance
    (same arguments): per photo, every output pixel as the 11-bit bilinear
    sum of its four taps, each an upright RGB pixel, rounded once at 22
    bits."""
    dim = out.shape[1]
    for p, row in enumerate(photos.tolist()):
        x0, x1, xw1 = taps_x[p].long().unbind(-1)
        y0, y1, yw1 = taps_y[p].long().unbind(-1)
        acc = torch.zeros(dim, dim, 3, dtype=torch.int64, device=out.device)
        for yy, wy in ((y0, 2048 - yw1), (y1, yw1)):
            for xx, wx in ((x0, 2048 - xw1), (x1, xw1)):
                px = _rgb(planes, row, yy[:, None].expand(dim, dim),
                          xx[None, :].expand(dim, dim))
                acc += px * (wy[:, None] * wx[None, :])[..., None]
        out[row[PH_OUT]] = ((acc + (1 << 21)) >> 22).clamp(0, 255) \
            .to(torch.uint8)


def _check_color_resize(name, planes, photos, taps_x, taps_y, out) -> None:
    dim = out.shape[1]
    for t, dt in ((planes, torch.uint8), (photos, torch.int64),
                  (taps_x, torch.int32), (taps_y, torch.int32),
                  (out, torch.uint8)):
        if t.dtype != dt or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name} expects contiguous CUDA {dt}")
    if out.dim() != 4 or out.shape[2] != dim or out.shape[3] != 3 \
            or taps_x.shape[1:] != (dim, 3) or taps_y.shape[1:] != (dim, 3):
        raise ValueError(f"{name}: out [N, D, D, 3], taps [n, D, 3]")


def jpeg_color_resize(planes: torch.Tensor, photos: torch.Tensor,
                      taps_x: torch.Tensor, taps_y: torch.Tensor,
                      out: torch.Tensor) -> None:
    """J2: ``out[photos[p, PH_OUT]]`` (uint8 [N, D, D, 3]) for every photo
    row of ``photos`` (int64 [n, PH_FIELDS]; gray, YCbCr or RGB) from its
    component planes in ``planes`` (uint8), through its resize taps
    ``taps_x`` / ``taps_y`` (int32 [n, D, 3]: i0, i1, w1).  Kernel on CUDA
    tensors, plain version on CPU tensors."""
    if not planes.is_cuda:
        return jpeg_color_resize_plain(planes, photos, taps_x, taps_y, out)
    _check_color_resize("jpeg_color_resize", planes, photos, taps_x, taps_y,
                        out)
    if len(photos) == 0:
        return None
    launch("aihab_jpeg_color_resize", planes.device, planes.data_ptr(),
           photos.data_ptr(), taps_x.data_ptr(), taps_y.data_ptr(),
           out.data_ptr(), len(photos), out.shape[1])
    jpeg_color_resize.launches += 1
    return None


def jpeg_color_resize_cmyk(planes: torch.Tensor, photos: torch.Tensor,
                           taps_x: torch.Tensor, taps_y: torch.Tensor,
                           out: torch.Tensor) -> None:
    """J2's four-component instance: as ``jpeg_color_resize`` for photo
    rows of colour "cmyk" or "ycck" (Adobe transform 0 or 2).  Kernel on
    CUDA tensors, plain version on CPU tensors."""
    if not planes.is_cuda:
        return jpeg_color_resize_plain(planes, photos, taps_x, taps_y, out)
    _check_color_resize("jpeg_color_resize_cmyk", planes, photos, taps_x,
                        taps_y, out)
    if len(photos) == 0:
        return None
    launch("aihab_jpeg_color_resize_cmyk", planes.device, planes.data_ptr(),
           photos.data_ptr(), taps_x.data_ptr(), taps_y.data_ptr(),
           out.data_ptr(), len(photos), out.shape[1])
    jpeg_color_resize_cmyk.launches += 1
    return None


# ---------------------------------------------------------------------------
# the batch entry point
# ---------------------------------------------------------------------------


def _decode_parsed(blobs, headers, dim: int, mins, rules, device, threads,
                   stream):
    """JPEG blobs and their parsed ``headers`` -> (uint8 [N, dim, dim, 3]
    in host memory, ok mask bool [N]): each decoded on ``device`` at the
    DCT scale for its ``mins`` entry (0: full size) with its interblock
    smoothing rule (``rules``), EXIF-oriented and resized, bit for bit
    with ``data/decode.py``.  A blob whose layout or Huffman tables are bad
    has ok False and zero pixels; one bad blob never fails the others.  On
    the card every step (upload, J1, J2, the copy back into pinned memory)
    runs on ``stream`` (a new one when None), never the current stream, so
    a decode does not wait behind its classify batches; the call returns
    when its work is done.  A caller that decodes often passes a stream it
    keeps: the caching allocator keeps device memory per stream."""
    n = len(blobs)
    good, index, scales, layouts, chosen = [], [], [], [], []
    for i, h in enumerate(headers):
        try:
            m = prescale_factor((h.width, h.height), mins[i])
            layout = jpeg_layout(h, m)
        except DecodeError:
            continue
        good.append(h)
        index.append(i)
        scales.append(m)
        layouts.append(layout)
        chosen.append(rules[i])
    ok = np.zeros(n, bool)
    if not good:
        return torch.zeros(n, dim, dim, 3, dtype=torch.uint8), ok
    plan = plan_batch(good, scales, dim, index, layouts, chosen)
    cuda = device.type == "cuda"
    coef = torch.empty(max(1, plan.coef_total), dtype=torch.int16,
                       pin_memory=cuda)
    status = entropy_decode(plan, blobs, coef, threads)
    ok[index] = status == 0
    if cuda:
        stream = stream or torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            pixels = _pixels(plan, coef, n, dim, device)
            out = torch.empty(pixels.shape, dtype=torch.uint8,
                              pin_memory=True)
            out.copy_(pixels, non_blocking=True)
        stream.synchronize()
    else:
        out = _pixels(plan, coef, n, dim, device)
    out[torch.from_numpy(~ok)] = 0
    return out, ok


# the routes of decode_blobs: JAX's native libjpeg path (the loader's
# all-JPEG RGB folders), cv2.imread (its other folders, its BGR loader and
# its server's file decode), cv2.imdecode (its server's bytes when native
# refuses them) and its server's bytes (native, then imdecode)
ROUTES = ("native", "imread", "imdecode", "serve")
_NATIVE_COLORS = ("ycc", "rgb", "gray")   # what libjpeg-turbo 2.1 -> RGBX takes


def _route(blob: bytes, route: str):
    """Where ``decode_blobs`` takes one blob on ``route``: ("jpeg", its
    header, prescaled, smoothing rule), ("other",) or ("none",) for a blob
    the route's decoder refuses."""
    if blob[:2] != b"\xff\xd8":
        return ("none",) if route == "native" else ("other",)
    try:
        h = parse_jpeg(blob)
    except DecodeError:
        return ("none",)
    native_ok = h.color in _NATIVE_COLORS and not h.tail_error
    if route == "native":
        return ("jpeg", h, True, "2.1") if native_ok else ("none",)
    if route == "serve" and native_ok and blob[:3] == b"\xff\xd8\xff":
        return ("jpeg", h, True, "2.1")
    if route in ("imdecode", "serve") and not h.complete:
        return ("none",)      # imdecode's source refuses to read past the end
    return ("jpeg", h, False, "3.1")


def decode_blobs(blobs: Sequence[bytes], dim: int, route: str,
                 prescale_min: int = 0, device="cuda", threads: int = 0,
                 stream=None, pool=None) -> List[Optional[np.ndarray]]:
    """Encoded images -> one RGB uint8 [dim, dim, 3] array or None a blob:
    the one place that routes a format, as the JAX package's decoder on
    ``route`` (``ROUTES``) would:

      * "native": JAX's native libjpeg path (``native_bulk_decode_resize``,
        its loader's all-JPEG RGB folders): a JPEG at the DCT scale for
        ``prescale_min``; what libjpeg-turbo 2.1 refuses to decode to RGB
        (CMYK/YCCK, bytes that are no JPEG, a marker it refuses after a
        one-scan sequential frame's scan) is None;
      * "imread": ``cv2.imread`` at full scale (its other folders, its BGR
        loader, its server's files): JPEGs (cut ones and CMYK/YCCK too),
        PNGs and BMPs;
      * "imdecode": ``cv2.imdecode`` at full scale: as "imread", but a
        JPEG cut short is None;
      * "serve": its server's ``decode_bytes``: a blob with the JPEG magic
        that the native path takes at the prescale, any other as
        "imdecode".

    JPEGs are Huffman- or arithmetic-coded, sequential or progressive, on
    every route; lossless, 12-bit and hierarchical ones are None, as
    neither libjpeg reads them.  A ``prescale_min`` on a route that
    decodes at full scale raises.  All JPEGs go through the fast decode in
    one call (``_decode_parsed``, on ``device`` and ``stream``; their
    headers parsed once, here); PNGs and BMPs through ``data/decode.py``
    at full scale and its bilinear resize, on ``pool`` (an executor) when
    given.  None marks a blob that the route does not read."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    if prescale_min and route not in ("native", "serve"):
        raise ValueError(f"route {route!r} decodes at full scale: "
                         f"prescale_min must be 0, not {prescale_min}")
    out: List[Optional[np.ndarray]] = [None] * len(blobs)
    jpegs, headers, others, mins, rules = [], [], [], [], []
    for i, blob in enumerate(blobs):
        how = _route(blob, route)
        if how[0] == "jpeg":
            jpegs.append(i)
            headers.append(how[1])
            mins.append(prescale_min if how[2] else 0)
            rules.append(how[3])
        elif how[0] == "other":
            others.append(i)
    if jpegs:
        images, ok = _decode_parsed(
            [blobs[i] for i in jpegs], headers, dim, mins, rules,
            torch.device(device), threads, stream)
        images = images.numpy()
        for j, i in enumerate(jpegs):
            if ok[j]:
                out[i] = images[j]

    def other(i):
        try:
            return resize_bilinear(decode_image(blobs[i]), dim, dim)
        except DecodeError:
            return None

    for i, img in zip(others, (pool.map if pool else map)(other, others)):
        out[i] = img
    return out


def _pixels(plan: Plan, coef: torch.Tensor, n: int, dim: int,
            device) -> torch.Tensor:
    """J1, then J2 over the photos of up to three components and its CMYK
    instance over the four-component ones (on the current stream)."""
    cuda = device.type == "cuda"
    photos = plan.photos.copy()
    photos[:, PH_OUT] = plan.index     # rows of the caller's batch

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device, non_blocking=cuda)

    coef_d = coef.to(device, non_blocking=cuda)
    planes = torch.empty(max(1, plan.plane_total), dtype=torch.uint8,
                         device=device)
    jpeg_idct(coef_d, put(plan.qtables), put(plan.segs), planes)
    out = (torch.zeros if len(plan.index) < n else torch.empty)(
        n, dim, dim, 3, dtype=torch.uint8, device=device)
    four = photos[:, PH_NCOMP] == 4
    for kernel, sel in ((jpeg_color_resize, ~four),
                        (jpeg_color_resize_cmyk, four)):
        if sel.any():
            kernel(planes, put(photos[sel]), put(plan.taps_x[sel]),
                   put(plan.taps_y[sel]), out)
    return out


COUNTED = (jpeg_idct, jpeg_color_resize, jpeg_color_resize_cmyk)
for _fn in COUNTED:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}
