"""JPEG fixtures that nothing on the card's machine writes (it has neither
cv2 nor PIL): a tool for the tests and ``chip_smoke.py``, called by no entry
point of the package.

  * ``progressive_recode``: a baseline JPEG's quantized coefficients,
    losslessly re-coded as a progressive JPEG under libjpeg's default
    script (``jcparam.c`` ``jpeg_simple_progression``: a DC scan with one
    bit held back, spectral selection, successive approximation of the AC
    bands with their EOB runs and correction bits, the DC and AC
    refinements) with optimal Huffman tables per scan (``jchuff.c``
    ``jpeg_gen_optimal_table``), each table's DHT just before its scan.
    The decoders must give back the baseline file's coefficients exactly.
  * ``arith_recode``: a JPEG's coefficients arithmetic-coded (SOF9, or
    SOF10 under the same script) by the QM encoder of
    ``csrc/jpeg_entropy.cpp`` (libjpeg's ``jcarith.c``): the bytes libjpeg
    writes for them, DAC, DRI and SOS markers included.
  * ``encode_adobe``: an Adobe baseline JPEG of four components, CMYK
    (APP14 transform 0) or YCCK (transform 2, libjpeg's CMYK -> YCCK).

The entropy coding is vectorized in numpy (a 12 MP photo re-codes in
seconds): every code of a scan is an event with a sort key, the events are
ordered once and packed into bits in bulk.

    python -m aihab_clip_tpu_torch.tools.jpeg_fixtures recode in.jpg out.jpg
    python -m aihab_clip_tpu_torch.tools.jpeg_fixtures arith in.jpg out.jpg \
        [--progressive] [--restart MCUS]
    python -m aihab_clip_tpu_torch.tools.jpeg_fixtures ycck out.jpg --size 64x96
"""

from __future__ import annotations

import argparse
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data.decode import _ZIGZAG, parse_jpeg
from ..data.encode import (_STD_CHROMA_Q, _STD_LUMA_Q, _downsample, _pad_edge,
                           _segment, fdct_quantize, quality_table, rgb_to_ycc)

# sort keys: a block's events lie in [block * _ROW, (block + 1) * _ROW); a
# band position q in q * 8 + sub; a flush after the block at 64 * 8
_ROW = 65 * 8
_MAX_EOBRUN = 0x7FFF


def _bitlen(x: np.ndarray) -> np.ndarray:
    """Bits of |x| (0 for 0), int64."""
    a = np.abs(x).astype(np.int64)
    n = np.zeros_like(a)
    while a.any():
        n += a > 0
        a >>= 1
    return n


def _value_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The s appended bits of v: v itself if positive, else v - 1 (its
    ones' complement) masked."""
    v = v.astype(np.int64)
    return np.where(v >= 0, v, v - 1) & ((np.int64(1) << s) - 1)


class _Events:
    """A scan's codes: (sort key 1, sort key 2, table or -1 for raw bits,
    symbol, appended bits, their count)."""

    def __init__(self):
        self.parts: List[Tuple[np.ndarray, ...]] = []

    def add(self, k1, k2, table, sym, val, vlen) -> None:
        k1 = np.asarray(k1, np.int64).reshape(-1)
        n = len(k1)

        def full(x):
            return np.broadcast_to(np.asarray(x, np.int64), (n,)).copy()

        if n:
            self.parts.append((k1, full(k2), full(table), full(sym), full(val),
                               full(vlen)))

    def ordered(self):
        if not hasattr(self, "_ordered"):
            cols = [np.concatenate([p[i] for p in self.parts]) if self.parts
                    else np.zeros(0, np.int64) for i in range(6)]
            order = np.lexsort((cols[1], cols[0]))
            self._ordered = [c[order] for c in cols[2:]]
        return self._ordered


def gen_optimal_table(freq: np.ndarray) -> bytes:
    """libjpeg's ``jpeg_gen_optimal_table``: symbol counts [256] -> a DHT
    table spec (16 code-length counts, then the symbols)."""
    freq = [int(f) for f in freq] + [1]          # the reserved symbol 256
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = [j for length in range(1, 33) for j in range(256)
               if codesize[j] == length]
    return bytes(bits[1:17]) + bytes(symbols)


def _codes(spec: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """A table spec -> (code, length) by symbol, int64 [256] each."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 16
    for n in range(1, 17):
        for _ in range(spec[n - 1]):
            code[spec[k]], length[spec[k]] = c, n
            c += 1
            k += 1
        c <<= 1
    return code, length


def pack_bits(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes of ``lengths`` bits (each <= 32), MSB first -> entropy-coded
    bytes: the last byte padded with ones, every 0xFF stuffed with 0x00."""
    codes = codes.astype(np.uint64)
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    if total == 0:
        return b""
    pos = np.cumsum(lengths) - lengths
    word, off = pos >> 6, pos & 63
    end = off + lengths
    spill = np.maximum(end - 64, 0)
    first = (codes >> spill.astype(np.uint64)) << (
        64 - np.minimum(end, 64)).astype(np.uint64)
    words = np.zeros(total // 64 + 2, np.uint64)

    def scatter(idx, vals):
        starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
        words[idx[starts]] |= np.add.reduceat(vals, starts)

    scatter(word, first)
    over = spill > 0
    if over.any():
        s = spill[over].astype(np.uint64)
        second = (codes[over] & ((np.uint64(1) << s) - np.uint64(1))) << (
            np.uint64(64) - s)
        scatter(word[over] + 1, second)
    out = bytearray(words.astype(">u8").tobytes()[:(total + 7) // 8])
    if total % 8:
        out[-1] |= (1 << (8 - total % 8)) - 1
    return bytes(out).replace(b"\xff", b"\xff\x00")


def _encode(events: _Events, tables: Dict[int, bytes]) -> bytes:
    """The ordered events under ``tables`` (id -> spec) -> scan bytes."""
    table, sym, val, vlen = events.ordered()
    hcode = np.zeros(len(sym), np.int64)
    hlen = np.zeros(len(sym), np.int64)
    for t, spec in tables.items():
        code, length = _codes(spec)
        sel = table == t
        hcode[sel], hlen[sel] = code[sym[sel]], length[sym[sel]]
    if ((table >= 0) & (hlen == 0)).any():
        raise ValueError("a symbol without a code")
    return pack_bits((hcode << vlen) | val, hlen + vlen)


def _optimal_tables(events: _Events) -> Dict[int, bytes]:
    table, sym = events.ordered()[:2]
    return {int(t): gen_optimal_table(np.bincount(sym[table == t],
                                                  minlength=256))
            for t in np.unique(table[table >= 0])}


def _block_order(header, idx: Sequence[int]):
    """The blocks of a scan of components ``idx`` in coding order:
    (component, block row, block column) arrays; an interleaved scan walks
    the MCU-padded grid, a one-component scan its own blocks."""
    if len(idx) == 1:
        c = header.comps[idx[0]]
        r, q = np.divmod(np.arange(c.wib * c.hib), c.wib)
        return np.full(len(r), idx[0]), r, q
    hmax, vmax = header.hmax, header.vmax
    mcux = -(-header.width // (8 * hmax))
    mcuy = -(-header.height // (8 * vmax))
    my, mx = np.divmod(np.arange(mcux * mcuy), mcux)
    ks, rs, qs = [], [], []
    for k in idx:
        c = header.comps[k]
        for y in range(c.v):
            for x in range(c.h):
                ks.append(np.full(len(my), k))
                rs.append(my * c.v + y)
                qs.append(mx * c.h + x)
    # per MCU: the layout's blocks in order
    n = len(my)
    order = np.arange(n * len(ks)).reshape(len(ks), n).T.reshape(-1)
    return (np.concatenate(ks)[order], np.concatenate(rs)[order],
            np.concatenate(qs)[order])


def _dc_events(coefs, header, idx, al: int, refine: bool) -> _Events:
    """A DC scan: first (differences of coef >> al, table = component) or
    refine (bit al of each DC, raw)."""
    ks, rs, qs = _block_order(header, idx)
    dc = np.empty(len(ks), np.int64)
    for k in idx:
        sel = ks == k
        dc[sel] = coefs[k][rs[sel], qs[sel], 0]
    ev = _Events()
    order = np.arange(len(ks))
    if refine:
        ev.add(order, 0, -1, 0, (dc >> al) & 1, 1)
        return ev
    v = dc >> al
    diff = np.empty_like(v)
    for k in idx:
        sel = np.flatnonzero(ks == k)
        diff[sel] = np.diff(v[sel], prepend=0)
    s = _bitlen(diff)
    ev.add(order, 0, ks, s, _value_bits(diff, s), s)
    return ev


def _eobrun_events(ev, table, f, t, first_key, n_blocks, be_key=None):
    """The EOB runs of an AC scan: a run of blocks whose band ends in zeros
    (``t``) is coded before the first code of the next block with one
    (``f``, its key ``first_key``), after a block that fills it to 32767,
    or at the scan's end.  ``be_key`` (refine scans): its emission key for
    each block of the run, set here."""
    keys, runs = [], []
    run_of = np.full(n_blocks, -1, np.int64)
    eob = 0
    fl, tl, fk = f.tolist(), t.tolist(), first_key.tolist()
    for b in range(n_blocks):
        if fl[b] and eob:
            keys.append(fk[b])
            runs.append(eob)
            eob = 0
        if tl[b]:
            run_of[b] = len(runs)
            eob += 1
            if eob == _MAX_EOBRUN:
                keys.append(b * _ROW + 64 * 8)
                runs.append(eob)
                eob = 0
    if eob:
        keys.append(n_blocks * _ROW)
        runs.append(eob)
    keys, runs = np.asarray(keys, np.int64), np.asarray(runs, np.int64)
    r = _bitlen(runs) - 1
    ev.add(keys, 0, table, r << 4, runs & ((1 << r) - 1), r)
    if be_key is not None:
        sel = run_of >= 0
        be_key[sel] = keys[run_of[sel]]


def _ac_first_events(coef, c, k: int, ss: int, se: int, al: int) -> _Events:
    """An AC first scan of component ``k`` (its blocks [hib, wib, 64])."""
    band = coef[:c.hib, :c.wib].reshape(-1, 64)[:, _ZIGZAG[ss:se + 1]]
    mag = np.abs(band) >> al
    val = np.where(band < 0, -mag, mag)
    n, width = val.shape
    ev = _Events()
    b, j = np.nonzero(val)
    first = np.r_[True, b[1:] != b[:-1]] if len(b) else np.zeros(0, bool)
    prev = np.where(first, -1, np.r_[-1, j[:-1]])
    run = j - prev - 1
    zrl = run // 16
    s = _bitlen(val[b, j])
    key = b * _ROW + j * 8
    for z in range(1, 4):
        sel = zrl >= z
        ev.add(key[sel] + 1, z, k, 0xF0, 0, 0)
    ev.add(key + 2, 0, k, ((run % 16) << 4) | s, _value_bits(val[b, j], s), s)
    f = np.zeros(n, bool)
    f[b] = True
    last = np.full(n, -1)
    np.maximum.at(last, b, j)
    t = last < width - 1
    first_key = np.zeros(n, np.int64)
    first_key[b[first]] = key[first]
    _eobrun_events(ev, k, f, t, first_key, n)
    return ev


def _ac_refine_events(coef, c, k: int, ss: int, se: int, al: int) -> _Events:
    """An AC refine scan of component ``k``: each coefficient that becomes
    non-zero at bit ``al`` is a symbol of its zero run and sign; each one
    already non-zero a correction bit, sent after the next ZRL or symbol of
    its block, or after the EOB run that holds the block."""
    band = coef[:c.hib, :c.wib].reshape(-1, 64)[:, _ZIGZAG[ss:se + 1]]
    mag = np.abs(band) >> al
    n, width = mag.shape
    new, old, zero = mag == 1, mag > 1, mag == 0
    ev = _Events()
    cols = np.arange(width)
    eob = np.where(new.any(1), width - 1 - np.argmax(new[:, ::-1], 1), -1)
    # zeros before each position since the last new coefficient before it
    zc = np.cumsum(zero, 1) - zero                 # zeros strictly before j
    lastnew = np.maximum.accumulate(np.where(new, cols, -1), 1)
    lastnew_excl = np.concatenate([np.full((n, 1), -1), lastnew[:, :-1]], 1)
    base = np.where(lastnew_excl >= 0,
                    np.take_along_axis(zc, np.maximum(lastnew_excl, 0), 1)
                    + 1 * np.take_along_axis(zero, np.maximum(
                        lastnew_excl, 0), 1), 0)
    zrun = zc - base                               # zeros since that one
    # ZRLs at each non-zero position up to the block's last new one
    b, q = np.nonzero((new | old) & (cols[None, :] <= eob[:, None]))
    seg_start = np.r_[True, (b[1:] != b[:-1])
                      | (lastnew_excl[b[1:], q[1:]] != lastnew_excl[b[:-1],
                                                                     q[:-1]])]
    zq = zrun[b, q]
    zprev = np.where(seg_start, 0, np.r_[0, zq[:-1]])
    nzrl = zq // 16 - zprev // 16
    is_new = new[b, q]
    flush = (nzrl > 0) | is_new
    fkey = b * 64 + q                              # flush positions, sorted
    fb, fq, fz = b[flush], q[flush], nzrl[flush]
    key = b * _ROW + q * 8
    for z in range(1, 4):
        sel = nzrl >= z
        ev.add(key[sel] + (1 if z == 1 else 3), z, k, 0xF0, 0, 0)
    sign = (band[b, q] > 0).astype(np.int64)
    ev.add(key[is_new] + 4, 0, k, ((zq[is_new] % 16) << 4) | 1,
           sign[is_new], 1)
    # correction bits: to the next flush after them in the block, else BE
    ob, oq = np.nonzero(old)
    bit = mag[ob, oq] & 1
    at = np.searchsorted(fkey[flush], ob * 64 + oq, side="right")
    found = at < len(fb)
    found[found] &= fb[np.minimum(at, len(fb) - 1)][found] == ob[found]
    atf = np.minimum(at, max(len(fb) - 1, 0))
    if len(fb):
        sub = np.where(fz[atf] > 0, 2, 5)
        ev.add((ob * _ROW + fq[atf] * 8 + sub)[found], oq[found], -1, 0,
               bit[found], 1)
    f = np.zeros(n, bool)
    f[fb] = True
    first_key = np.zeros(n, np.int64)
    firsts = np.r_[True, fb[1:] != fb[:-1]] if len(fb) else np.zeros(0, bool)
    first_key[fb[firsts]] = fb[firsts] * _ROW + fq[firsts] * 8
    t = eob < width - 1
    be_key = np.zeros(n, np.int64)
    _eobrun_events(ev, k, f, t, first_key, n, be_key)
    trail = ~found
    ev.add(be_key[ob[trail]], 1 + ob[trail] * 64 + oq[trail], -1, 0,
           bit[trail], 1)
    return ev


def simple_progression(ncomp: int, ycc: bool):
    """libjpeg's ``jpeg_simple_progression`` scan script: (components, Ss,
    Se, Ah, Al) a scan."""
    if ycc and ncomp == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    comps = tuple(range(ncomp))
    dc = [comps] if ncomp <= 4 else [(k,) for k in comps]
    return ([(c, 0, 0, 0, 1) for c in dc]
            + [((k,), 1, 5, 0, 2) for k in comps]
            + [((k,), 6, 63, 0, 2) for k in comps]
            + [((k,), 1, 63, 2, 1) for k in comps]
            + [(c, 0, 0, 1, 0) for c in dc]
            + [((k,), 1, 63, 1, 0) for k in comps])


def _markers_before_frame(data: bytes) -> List[bytes]:
    """The JFIF, EXIF and Adobe segments and the DQTs of a JPEG, as they
    stand."""
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker in (0xE0, 0xE1, 0xEE, 0xDB):
            out.append(data[pos:pos + 2 + length])
        if marker == 0xDA:
            break
        pos += 2 + length
    return out


def progressive_recode(data: bytes, coefs: Sequence[np.ndarray] = None
                       ) -> bytes:
    """A baseline JPEG -> the same coefficients as a progressive JPEG under
    ``simple_progression`` with optimal tables.  ``coefs`` (per component
    [bh * bw, 64], natural order; by default the C++ decoder's) spares the
    decode."""
    header = parse_jpeg(data)
    if header.progressive or not header.complete:
        raise ValueError("progressive_recode takes a complete baseline JPEG")
    if coefs is None:
        from ..ops.jpeg import coefficients
        coefs = coefficients(data, 8, None)
    blocks = [np.asarray(co, np.int64).reshape(c.bh, c.bw, 64)
              for co, c in zip(coefs, header.comps)]
    out = [b"\xff\xd8", *_markers_before_frame(data)]
    sof = bytes([8]) + header.height.to_bytes(2, "big") \
        + header.width.to_bytes(2, "big") + bytes([len(header.comps)])
    for c in header.comps:
        sof += bytes([c.cid, (c.h << 4) | c.v, c.tq])
    out.append(_segment(0xC2, sof))
    for comps, ss, se, ah, al in simple_progression(
            len(header.comps), header.color == "ycc"):
        if ss == 0:
            ev = _dc_events(blocks, header, comps, al, ah > 0)
        else:
            k = comps[0]
            fn = _ac_refine_events if ah else _ac_first_events
            ev = fn(blocks[k], header.comps[k], k, ss, se, al)
        tables = _optimal_tables(ev)
        for t, spec in tables.items():
            out.append(_segment(0xC4, bytes([(0x10 if ss else 0) | t])
                                + spec))
        sos = bytes([len(comps)])
        for k in comps:
            t = k if k in tables else 0
            sos += bytes([header.comps[k].cid,
                          (t << 4 if ss == 0 else t)])
        out.append(_segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])))
        out.append(_encode(ev, tables))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _selectors(data: bytes, header) -> Dict[int, Tuple[int, int]]:
    """Component index -> (DC table, AC table) as the file's scans select
    them (the first scan that reads each)."""
    out: Dict[int, List[int]] = {}
    for scan in header.scans:
        pairs = scan.start - 2 * len(scan.comps) - 3   # SOS's (id, tables)
        for j, k in enumerate(scan.comps):
            t = data[pairs + 2 * j + 1]
            sel = out.setdefault(k, [None, None])
            if scan.ss == 0 and scan.ah == 0 and sel[0] is None:
                sel[0] = t >> 4
            if scan.se and sel[1] is None:
                sel[1] = t & 15
    return {k: (dc or 0, ac or 0) for k, (dc, ac) in out.items()}


def arith_recode(data: bytes, coefs: Sequence[np.ndarray] = None,
                 progressive: bool = False, restart: int = 0,
                 conditioning: Dict[int, Tuple[int, int, int]] = None
                 ) -> bytes:
    """A complete JPEG (Huffman- or arithmetic-coded, sequential or
    progressive) -> the same coefficients arithmetic-coded as libjpeg's
    compressor writes them
    (``jcarith.c``, ITU-T T.81 Annex D): SOF9, or with ``progressive``
    SOF10 under ``simple_progression``; each scan after its DAC, which
    lists every statistics table the scan reads with its
    ``conditioning`` ({table: (L, U, Kx)}; libjpeg's (0, 1, 5) for the
    others), the first after a DRI where ``restart`` (MCUs) is set.  The
    components keep the file's table selectors; the JFIF, EXIF, Adobe and
    DQT segments stand as they were.  ``coefs`` as ``progressive_recode``
    takes them."""
    from ..ops.jpeg import arith_encode_scan, coefficients

    header = parse_jpeg(data)
    if not header.complete:
        raise ValueError("arith_recode takes a complete JPEG")
    if coefs is None:
        coefs = coefficients(data, 8, None)
    flat = [np.asarray(co, np.int16).reshape(-1) for co in coefs]
    offsets = np.cumsum([0] + [len(f) for f in flat])[:-1].tolist()
    coef = np.concatenate(flat)
    cond = {t: (0, 1, 5) for t in range(16)}
    cond.update(conditioning or {})
    sel = _selectors(data, header)
    nc = len(header.comps)
    sof = bytes([8]) + header.height.to_bytes(2, "big") \
        + header.width.to_bytes(2, "big") + bytes([nc])
    for c in header.comps:
        sof += bytes([c.cid, (c.h << 4) | c.v, c.tq])
    out = [b"\xff\xd8", *_markers_before_frame(data),
           _segment(0xCA if progressive else 0xC9, sof)]
    script = (simple_progression(nc, header.color == "ycc") if progressive
              else [(tuple(range(nc)), 0, 63, 0, 0)])
    for i, (comps, ss, se, ah, al) in enumerate(script):
        dc_use = {sel[k][0] for k in comps} if ss == 0 and ah == 0 else set()
        ac_use = {sel[k][1] for k in comps} if se else set()
        dac = []
        for t in range(16):
            if t in dc_use:
                dac += [t, cond[t][0] | cond[t][1] << 4]
            if t in ac_use:
                dac += [t + 16, cond[t][2]]
        if dac:
            out.append(_segment(0xCC, bytes(dac)))
        if restart and i == 0:
            out.append(_segment(0xDD, restart.to_bytes(2, "big")))
        sos = bytes([len(comps)])
        for k in comps:
            td = sel[k][0] if ss == 0 and ah == 0 else 0
            ta = sel[k][1] if se else 0
            sos += bytes([header.comps[k].cid, (td << 4) | ta])
        out.append(_segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])))
        conds = [(sel[k][0], *cond[sel[k][0]][:2], sel[k][1],
                  cond[sel[k][1]][2]) for k in comps]
        out.append(arith_encode_scan(header, coef, offsets, comps,
                                     (ss, se, ah, al), restart, conds,
                                     progressive))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _baseline_events(blocks, header) -> _Events:
    """One interleaved sequential scan (``header``: the frame's geometry):
    per block its DC difference (table = component) and its AC run
    lengths, ZRLs and EOB (table 4 + component)."""
    idx = list(range(len(header.comps)))
    ev = _dc_events(blocks, header, idx, 0, False)
    ks, rs, qs = _block_order(header, idx)
    ac = np.empty((len(ks), 63), np.int64)
    for k in idx:
        sel = ks == k
        ac[sel] = blocks[k][rs[sel], qs[sel]][:, _ZIGZAG[1:]]
    b, j = np.nonzero(ac)
    first = np.r_[True, b[1:] != b[:-1]] if len(b) else np.zeros(0, bool)
    prev = np.where(first, -1, np.r_[-1, j[:-1]])
    run = j - prev - 1
    s = _bitlen(ac[b, j])
    key = b.astype(np.int64)
    for z in range(1, 4):
        sel = run // 16 >= z
        ev.add(key[sel], 1 + 4 * j[sel] + z - 1, 4 + ks[b[sel]], 0xF0, 0, 0)
    ev.add(key, 1 + 4 * j + 3, 4 + ks[b], ((run % 16) << 4) | s,
           _value_bits(ac[b, j], s), s)
    last = np.full(len(ks), -1)
    np.maximum.at(last, b, j)
    trail = np.flatnonzero(last < 62)
    ev.add(trail, 1000, 4 + ks[trail], 0x00, 0, 0)
    return ev


def encode_adobe(planes: Sequence[np.ndarray], transform: int,
                 quality: int = 90,
                 sampling: Tuple[int, int] = (1, 1)) -> bytes:
    """Four uint8 planes [H, W] -> an Adobe baseline JPEG: C, M, Y, K with
    transform 0, or (transform 2) libjpeg's YCCK of them: the YCbCr of
    (255 - C, 255 - M, 255 - Y), K passed through.  The first and last
    components take ``sampling`` (h, v) over the middle two's (1, 1)."""
    planes = [np.asarray(p, np.int64) for p in planes]
    height, width = planes[0].shape
    if transform == 2:
        rgb = np.stack([255 - p for p in planes[:3]], -1).astype(np.uint8)
        planes = [*rgb_to_ycc(rgb), planes[3]]
    elif transform != 0:
        raise ValueError("transform 0 (CMYK) or 2 (YCCK)")
    factors = [tuple(sampling), (1, 1), (1, 1), tuple(sampling)]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    qs = [quality_table(_STD_LUMA_Q, quality),
          quality_table(_STD_CHROMA_Q, quality)]
    blocks, sof = [], bytes([8]) + height.to_bytes(2, "big") \
        + width.to_bytes(2, "big") + bytes([4])
    for ci, (plane, (h, v)) in enumerate(zip(planes, factors)):
        cw, ch = -(-width * h // hmax), -(-height * v // vmax)
        bw, bh = mcux * h, mcuy * v
        if (h, v) != (hmax, vmax):
            plane = _downsample(plane, hmax // h, vmax // v, ch, cw)
        plane = _pad_edge(plane, 8 * bh, 8 * bw)[:8 * bh, :8 * bw]
        tq = 0 if ci in (0, 3) else 1
        coef = fdct_quantize(plane.reshape(bh, 8, bw, 8).transpose(
            0, 2, 1, 3).reshape(-1, 8, 8), qs[tq])
        blocks.append(coef.reshape(bh, bw, 64))
        sof += bytes([ci + 1, (h << 4) | v, tq])
    head = [b"\xff\xd8",
            _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform]))]
    for tq, q in enumerate(qs):
        head.append(_segment(0xDB, bytes([tq]) + bytes(
            q[_ZIGZAG].astype(np.uint8).tolist())))
    head.append(_segment(0xC0, sof))
    comps = [SimpleNamespace(h=h, v=v, bw=mcux * h, bh=mcuy * v)
             for h, v in factors]
    geometry = SimpleNamespace(width=width, height=height, hmax=hmax,
                               vmax=vmax, comps=comps)
    ev = _baseline_events(blocks, geometry)
    tables = _optimal_tables(ev)
    for t, spec in tables.items():
        head.append(_segment(0xC4, bytes([(0x10 | (t - 4)) if t >= 4
                                          else t]) + spec))
    sos = bytes([4])
    for ci in range(4):
        sos += bytes([ci + 1, (ci << 4) | ci])
    head.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    head.append(_encode(ev, tables))
    head.append(b"\xff\xd9")
    return b"".join(head)


def adobe_planes(height: int, width: int, seed: int = 0) -> List[np.ndarray]:
    """Four smooth uint8 planes with noise (a photo's C, M, Y, K)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        coarse = rng.normal(128, 60, (height // 8 + 2, width // 8 + 2))
        ys = np.linspace(0, coarse.shape[0] - 1.001, height)
        xs = np.linspace(0, coarse.shape[1] - 1.001, width)
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        p = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
             + coarse[y0 + 1][:, x0] * fy * (1 - fx)
             + coarse[y0][:, x0 + 1] * (1 - fy) * fx
             + coarse[y0 + 1][:, x0 + 1] * fy * fx)
        out.append(np.clip(p + rng.normal(0, 8, p.shape), 0, 255)
                   .astype(np.uint8))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    rc = sub.add_parser("recode", help="baseline -> progressive")
    rc.add_argument("src")
    rc.add_argument("dst")
    ar = sub.add_parser("arith", help="any complete JPEG -> arithmetic-coded")
    ar.add_argument("src")
    ar.add_argument("dst")
    ar.add_argument("--progressive", action="store_true", help="SOF10")
    ar.add_argument("--restart", type=int, default=0, help="MCUs")
    for name in ("cmyk", "ycck"):
        p = sub.add_parser(name, help=f"write an Adobe {name.upper()} JPEG")
        p.add_argument("dst")
        p.add_argument("--size", default="64x96", help="HxW")
        p.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cmd == "recode":
        Path(args.dst).write_bytes(progressive_recode(
            Path(args.src).read_bytes()))
    elif args.cmd == "arith":
        Path(args.dst).write_bytes(arith_recode(
            Path(args.src).read_bytes(), progressive=args.progressive,
            restart=args.restart))
    else:
        h, w = (int(v) for v in args.size.lower().split("x"))
        Path(args.dst).write_bytes(encode_adobe(
            adobe_planes(h, w, args.seed), 0 if args.cmd == "cmyk" else 2))


if __name__ == "__main__":
    main()
