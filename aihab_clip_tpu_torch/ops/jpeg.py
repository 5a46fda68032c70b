"""The fast JPEG decode: Huffman on the host in C++, pixels on the card.

The JAX package decodes JPEGs with libjpeg on the host
(``native/image_pipeline.cpp:58-111``; no TPU kernel).  Here a batch of N
JPEGs decodes in three stages:

  1. ``data/decode.parse_jpeg`` reads each header (Python), and
     ``csrc/jpeg_entropy.cpp`` Huffman-decodes the scans, one photo a
     thread, into int16 coefficients in pinned memory: only those the
     chosen IDCT reads (64, 49, 25 or 1 a block).
  2. **J1** ``jpeg_idct`` (``csrc/jpeg_pixels.cu``): dequantize and IDCT
     every block of every photo at its component's scaled size (libjpeg's
     islow 8x8, or its reduced 4x4 / 2x2 / 1x1 of ``jidctred.c``) into the
     component planes: one launch for the batch.
  3. **J2** ``jpeg_color_resize``: for each output pixel of [N, D, D, 3],
     the four taps of the native path's fixed-point bilinear resize, each
     through the EXIF orientation, the chroma upsampling (h2v1 / h1v2 /
     h2v2 fancy, or replication) and libjpeg's fixed-point YCbCr -> RGB:
     one launch for the batch.  Only the samples the resize reads are
     computed.

Both kernels are integer arithmetic, bit for bit with ``data/decode.py``
(and so with libjpeg's pixels and the native path's resize).  Beside each
is its plain version, in int64 tensor ops per block and per output pixel:
the CPU runs it (a wrapper takes it only for tensors on the CPU), the tests
hold it against ``data/decode.py``, and ``chip_smoke.py`` holds the kernel
against it.  Launches are counted on each wrapper (``launch_counts``).

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
                           resize_bilinear)
from ._build import host_library, launch

# natural indices each IDCT size reads, in packed order (jidctred.c: the
# 4x4 never reads row or column 4; the 2x2 reads rows and columns 0, 1, 3,
# 5 and 7; the 1x1 the DC)
_KEEP4 = [r * 8 + c for r in (0, 1, 2, 3, 5, 6, 7) for c in (0, 1, 2, 3, 5, 6, 7)]
_KEEP2 = [r * 8 + c for r in (0, 1, 3, 5, 7) for c in (0, 1, 3, 5, 7)]
KEEP = {8: list(range(64)), 4: _KEEP4, 2: _KEEP2, 1: [0]}
PACKED = {s: len(k) for s, k in KEEP.items()}

# J1's segment table: one row per (photo, component), int64
SEG_COEF, SEG_PLANE, SEG_BW, SEG_NB, SEG_S, SEG_QT, SEG_FIRST = range(7)
SEG_FIELDS = 8
# J2's photo table: one row per photo, int64; then 3 component slots
PH_OUT, PH_NCOMP, PH_COLOR, PH_ORIENT, PH_W, PH_H = range(6)
PH_SLOT, SLOT_FIELDS = 6, 7
PH_FIELDS = PH_SLOT + 3 * SLOT_FIELDS
SL_OFF, SL_STRIDE, SL_DW, SL_DH, SL_HR, SL_VR, SL_MODE = range(7)
MODES = {"none": 0, "box": 1, "h2v1": 2, "h1v2": 3, "h2v2": 4}
COLORS = {"ycc": 0, "rgb": 1, "gray": 2}
# jpeg_entropy.cpp's scan descriptor and table layout
_SCAN_SLOTS, _SLOT_FIELDS = 9, 8
_SCAN_FIELDS = _SCAN_SLOTS + 4 * _SLOT_FIELDS
_TABLE_BYTES = 16 + 256
_STATUS = {1: "JPEG scan data ends early (truncated)",
           2: "bad Huffman code (DC)", 3: "bad Huffman code (AC)",
           4: "bad Huffman table", 5: "bad scan layout"}


def _align(n: int, a: int = 8) -> int:
    return -(-n // a) * a


@dataclasses.dataclass
class Plan:
    """One batch's layout: the parsed photos (``index`` into the caller's
    blobs), the entropy decoder's scan table and Huffman specs, the
    coefficient buffer's size, J1's segment table and quantization tables,
    the planes' size, J2's photo table and resize taps."""

    index: List[int]
    scans: np.ndarray
    photo_scans: np.ndarray
    tables: np.ndarray
    coef_total: int
    segs: np.ndarray
    qtables: np.ndarray
    plane_total: int
    photos: np.ndarray
    taps_x: np.ndarray
    taps_y: np.ndarray
    unscanned: List[Tuple[int, int]]   # coefficient ranges no scan writes


def plan_batch(headers: Sequence[JpegHeader], scales: Sequence[int],
               dim: int, index: Optional[List[int]] = None,
               layouts: Optional[list] = None) -> Plan:
    """Lay out the decode of ``headers`` at scales m/8 (``scales``) into
    [len(headers), dim, dim, 3]; ``layouts`` (one ``jpeg_layout`` result a
    photo) overrides the scales' own."""
    spec_ids: dict = {}
    scans, photo_scans = [], [0]
    segs, photos, taps_x, taps_y, unscanned = [], [], [], [], []
    qts: dict = {}
    coef_total = plane_total = first = 0
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
                               len(scan.comps))
            for j, (k, dc, ac) in enumerate(zip(scan.comps, scan.dc,
                                                scan.ac)):
                c, lay = h.comps[k], lays[k]
                ids = [spec_ids.setdefault(spec, len(spec_ids))
                       for spec in (dc, ac)]
                f = _SCAN_SLOTS + j * _SLOT_FIELDS
                d[f:f + _SLOT_FIELDS] = (c.h, c.v, c.bw, c.bh, comp_off[k],
                                         lay.s, *ids)
                scanned.add(k)
            scans.append(d)
        for k, c in enumerate(h.comps):
            if k not in scanned:
                unscanned.append((comp_off[k], c.bw * c.bh
                                  * PACKED[lays[k].s]))
        photo_scans.append(len(scans))
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
        photo_scans=np.asarray(photo_scans, np.int64), tables=tables,
        coef_total=coef_total,
        segs=np.asarray(segs, np.int64).reshape(-1, SEG_FIELDS),
        qtables=qtables, plane_total=plane_total,
        photos=np.asarray(photos, np.int64).reshape(-1, PH_FIELDS),
        taps_x=np.asarray(taps_x, np.int32).reshape(-1, dim, 3),
        taps_y=np.asarray(taps_y, np.int32).reshape(-1, dim, 3),
        unscanned=unscanned)


def entropy_decode(plan: Plan, blobs: Sequence[bytes], coef: torch.Tensor,
                   threads: int = 0) -> np.ndarray:
    """Huffman-decode the plan's photos (``blobs[plan.index[p]]``) into
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
    chosen = [blobs[i] for i in plan.index]
    ptrs = (ctypes.c_char_p * max(1, n))(*chosen)
    lens = np.asarray([len(b) for b in chosen] or [0], np.int64)
    status = np.zeros(max(1, n), np.int32)
    threads = threads or min(n, os.cpu_count() or 1)
    rc = lib.aihab_jpeg_entropy(
        ctypes.addressof(ptrs), lens.ctypes.data, plan.scans.ctypes.data,
        plan.photo_scans.ctypes.data, n, plan.tables.ctypes.data,
        len(plan.tables), coef.data_ptr(), status.ctypes.data, threads)
    if rc != 0:
        raise RuntimeError("jpeg_entropy could not start its threads")
    return status[:n]


def coefficients(data: bytes, s: int = 8) -> List[np.ndarray]:
    """One JPEG's quantized coefficients by the C++ decoder, per component
    int16 [bh * bw, PACKED[s]]: at s = 8 all 64 in natural order, what
    ``data/decode.jpeg_coefficients`` gives; else its columns ``KEEP[s]``.
    Raises ``DecodeError`` where that function does."""
    header = parse_jpeg(data)
    out_w, out_h, layouts = jpeg_layout(header, 8)
    layouts = [dataclasses.replace(lay, s=s) for lay in layouts]
    plan = plan_batch([header], [8], 1, layouts=[(out_w, out_h, layouts)])
    coef = torch.empty(max(1, plan.coef_total), dtype=torch.int16)
    status = int(entropy_decode(plan, [data], coef)[0])
    if status:
        raise DecodeError(_STATUS[status])
    return [coef[off:off + nb * PACKED[s]].view(nb, PACKED[s]).numpy().copy()
            for off, nb in plan.segs[:, [SEG_COEF, SEG_NB]].tolist()]


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
    tensors): the 8 outputs before their descale."""
    k = _C
    z1 = (c[2] + c[6]) * k["f0_541"]
    tmp2 = z1 - c[6] * k["f1_847"]
    tmp3 = z1 + c[2] * k["f0_765"]
    tmp0 = (c[0] + c[4]) * 8192
    tmp1 = (c[0] - c[4]) * 8192
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    a0, a1, a2, a3 = c[7], c[5], c[3], c[1]
    z5 = (a0 + a2 + a1 + a3) * k["f1_175"]
    z1 = -(a0 + a3) * k["f0_899"]
    z2 = -(a1 + a2) * k["f2_562"]
    z3 = -(a0 + a2) * k["f1_961"] + z5
    z4 = -(a1 + a3) * k["f0_390"] + z5
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
    [0, 255], with its table's wrap for wild x (index x & 1023)."""
    i = x & 1023
    return torch.where(i < 128, i + 128, torch.where(
        i < 512, torch.full_like(i, 255), torch.where(
            i < 896, torch.zeros_like(i), i - 896))).to(torch.uint8)


def idct_plain(dq: torch.Tensor, s: int) -> torch.Tensor:
    """Dequantized packed blocks [n, PACKED[s]] (int64) -> samples [n, s, s]
    uint8: J1's arithmetic per block."""
    n = dq.shape[0]
    if s == 1:
        return range_limit((dq[:, 0] + 4) >> 3).view(n, 1, 1)
    full = torch.zeros(n, 64, dtype=torch.int64, device=dq.device)
    full[:, KEEP[s]] = dq
    full = full.view(n, 8, 8)
    one_d, d1, d2 = _PASSES[s]
    # pass 1 over the columns: ws[:, r, x] for the s outputs r
    ws = [(o + (1 << (d1 - 1))) >> d1
          for o in one_d([full[:, r, :] for r in range(8)])]
    # pass 2 over the s workspace rows: out[:, y, x]
    rows = torch.stack(ws, 1)                              # [n, s, 8]
    out = one_d([rows[:, :, x] for x in range(8)])         # s x [n, s]
    out = torch.stack([(o + (1 << (d2 - 1))) >> d2 for o in out], 2)
    return range_limit(out)


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
        samples = idct_plain(c * q, s)                     # [nb, s, s]
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
    if row[PH_COLOR] == COLORS["gray"]:
        return torch.stack([comps[0]] * 3, -1)
    if row[PH_COLOR] == COLORS["rgb"]:
        return torch.stack(comps, -1)
    y, cb, cr = comps[0], comps[1] - 128, comps[2] - 128
    red = y + ((91881 * cr + 32768) >> 16)
    green = y + ((-22554 * cb - 46802 * cr + 32768) >> 16)
    blue = y + ((116130 * cb + 32768) >> 16)
    return torch.stack([red, green, blue], -1).clamp(0, 255)


def jpeg_color_resize_plain(planes: torch.Tensor, photos: torch.Tensor,
                            taps_x: torch.Tensor, taps_y: torch.Tensor,
                            out: torch.Tensor) -> None:
    """Plain version of ``jpeg_color_resize`` (same arguments): per photo,
    every output pixel as the 11-bit bilinear sum of its four taps, each
    an upright RGB pixel, rounded once at 22 bits."""
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


def jpeg_color_resize(planes: torch.Tensor, photos: torch.Tensor,
                      taps_x: torch.Tensor, taps_y: torch.Tensor,
                      out: torch.Tensor) -> None:
    """J2: ``out[photos[p, PH_OUT]]`` (uint8 [N, D, D, 3]) for every photo
    row of ``photos`` (int64 [n, PH_FIELDS]) from its component planes in
    ``planes`` (uint8), through its resize taps ``taps_x`` / ``taps_y``
    (int32 [n, D, 3]: i0, i1, w1).  Kernel on CUDA tensors, plain version
    on CPU tensors."""
    if not planes.is_cuda:
        return jpeg_color_resize_plain(planes, photos, taps_x, taps_y, out)
    dim = out.shape[1]
    for t, dt in ((planes, torch.uint8), (photos, torch.int64),
                  (taps_x, torch.int32), (taps_y, torch.int32),
                  (out, torch.uint8)):
        if t.dtype != dt or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"jpeg_color_resize expects contiguous CUDA {dt}")
    if out.dim() != 4 or out.shape[2] != dim or out.shape[3] != 3 \
            or taps_x.shape[1:] != (dim, 3) or taps_y.shape[1:] != (dim, 3):
        raise ValueError("jpeg_color_resize: out [N, D, D, 3], taps [n, D, 3]")
    if len(photos) == 0:
        return None
    launch("aihab_jpeg_color_resize", planes.device, planes.data_ptr(),
           photos.data_ptr(), taps_x.data_ptr(), taps_y.data_ptr(),
           out.data_ptr(), len(photos), dim)
    jpeg_color_resize.launches += 1
    return None


# ---------------------------------------------------------------------------
# the batch entry point
# ---------------------------------------------------------------------------


def decode_resize_batch(blobs: Sequence[bytes], dim: int,
                        prescale_min: int = 0, device="cuda",
                        threads: int = 0, stream=None
                        ) -> Tuple[torch.Tensor, np.ndarray, Dict[int, str]]:
    """JPEG blobs -> (uint8 [N, dim, dim, 3] in host memory, ok mask bool
    [N], unsupported): each decoded on ``device`` at the native path's DCT
    scale for ``prescale_min`` (0: full size), EXIF-oriented and resized,
    bit for bit with ``data/decode.py``.  A blob that is no readable JPEG
    has ok False and zero pixels; so has one in a format this package does
    not decode (progressive, CMYK, ...: A9b), and ``unsupported`` maps its
    index to the reason.  One bad blob never fails the others.  On the
    card every step (upload, J1, J2, the copy back into pinned memory) runs
    on ``stream`` (a new one when None), never the current stream, so a
    decode does not wait behind its classify batches; the call returns when
    its work is done.  A caller that decodes often passes a stream it
    keeps: the caching allocator keeps device memory per stream."""
    device = torch.device(device)
    n = len(blobs)
    headers, index, scales, layouts = [], [], [], []
    unsupported: Dict[int, str] = {}
    for i, data in enumerate(blobs):
        try:
            h = parse_jpeg(data)
            m = prescale_factor((h.width, h.height), prescale_min)
            layout = jpeg_layout(h, m)
        except DecodeError:
            continue
        except NotImplementedError as e:
            unsupported[i] = str(e)
            continue
        headers.append(h)
        index.append(i)
        scales.append(m)
        layouts.append(layout)
    ok = np.zeros(n, bool)
    if not headers:
        return torch.zeros(n, dim, dim, 3, dtype=torch.uint8), ok, unsupported
    plan = plan_batch(headers, scales, dim, index, layouts)
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
    return out, ok, unsupported


def decode_blobs(blobs: Sequence[bytes], dim: int, prescale_min: int = 0,
                 device="cuda", threads: int = 0, stream=None, pool=None
                 ) -> Tuple[List[Optional[np.ndarray]], Dict[int, str]]:
    """Encoded images -> (one RGB uint8 [dim, dim, 3] array or None a blob,
    unsupported): the one place that routes a format.  JPEGs take
    ``decode_resize_batch`` in one call (at the DCT scale for
    ``prescale_min``); PNGs and BMPs ``data/decode.py`` at full scale and
    its bilinear resize, on ``pool`` (an executor) when given.  None marks
    a blob that is no readable image; ``unsupported`` maps the index of
    one in a format this package does not decode (A9b) to the reason, and
    its entry is None too."""
    out: List[Optional[np.ndarray]] = [None] * len(blobs)
    jpegs = [i for i, b in enumerate(blobs) if b[:2] == b"\xff\xd8"]
    others = [i for i, b in enumerate(blobs) if b[:2] != b"\xff\xd8"]
    unsupported: Dict[int, str] = {}
    if jpegs:
        images, ok, bad = decode_resize_batch(
            [blobs[i] for i in jpegs], dim, prescale_min, device, threads,
            stream)
        images = images.numpy()
        for j, i in enumerate(jpegs):
            if ok[j]:
                out[i] = images[j]
        unsupported.update((jpegs[j], why) for j, why in bad.items())

    def other(i):
        try:
            return resize_bilinear(decode_image(blobs[i]), dim, dim), None
        except DecodeError:
            return None, None
        except NotImplementedError as e:
            return None, str(e)

    for i, (img, why) in zip(others, (pool.map if pool else map)(other,
                                                                  others)):
        out[i] = img
        if why is not None:
            unsupported[i] = why
    return out, unsupported


def _pixels(plan: Plan, coef: torch.Tensor, n: int, dim: int,
            device) -> torch.Tensor:
    """J1 then J2 over the plan (on the current stream)."""
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
    jpeg_color_resize(planes, put(photos), put(plan.taps_x),
                      put(plan.taps_y), out)
    return out


COUNTED = (jpeg_idct, jpeg_color_resize)
for _fn in COUNTED:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}
