"""Arithmetic-coded JPEGs (SOF9, SOF10; ROADMAP A9c) on every route of the
JAX package, against its decoders: the files in ``tests/golden/jpeg_arith``
were written by libjpeg's own compressor (``tests/make_arith_fixtures.py``).
Each decodes, whole, cut to 30% and 60% and without its EOI, as JAX's
native libjpeg path does (``native_decode_resize_mem``, bit for bit, with
and without the DCT prescale) and as cv2 does (``imread`` / ``imdecode``:
the full-scale pixels bit for bit, cv2.resize within one level); the C++
coefficients equal ``data/decode.py``'s pure-Python QM decode exactly; the
fixture tool's QM encoder (``arith_recode``) writes libjpeg's bytes.  Also
the DAC checks, stray and out-of-step markers in the data, a Huffman
stream marked SOF9, a loader folder, and the modes no libjpeg reads."""

import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from aihab_clip_tpu.native import (native_bulk_decode_resize,
                                   native_decode_resize_mem)

from aihab_clip_tpu_torch.data import decode as D
from aihab_clip_tpu_torch.data.bulk_load import decode_files
from aihab_clip_tpu_torch.data.encode import encode_jpeg
from aihab_clip_tpu_torch.ops import jpeg as J
from aihab_clip_tpu_torch.tools import jpeg_fixtures as F

GOLDEN = Path(__file__).resolve().parent / "golden" / "jpeg_arith"
MANIFEST = json.loads((GOLDEN / "MANIFEST.json").read_text())["files"]
NAMES = sorted(MANIFEST)
DIM = 32


def _blob(name: str) -> bytes:
    return (GOLDEN / name).read_bytes()


def _variants(data: bytes):
    """The file, cut to 30% and 60%, and without its EOI."""
    return {"whole": data, "cut30": data[:int(len(data) * 0.3)],
            "cut60": data[:int(len(data) * 0.6)], "no_eoi": data[:-2]}


def _native(data: bytes, pm: int):
    """JAX's native path, the EXIF orientation applied as the port does
    (the native path ignores it; ``test_torch_jpeg``'s
    ``test_exif_is_the_only_difference_from_native``)."""
    img = native_decode_resize_mem(data, DIM, pm)
    if img is None:
        return None
    try:
        return D.apply_orientation(img, D.parse_jpeg(data).orientation)
    except D.DecodeError:
        return img


def _cv2_full(data: bytes, route: str, tmp_path: Path):
    if route == "imdecode":
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    else:
        path = tmp_path / "x.jpg"
        path.write_bytes(data)
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if img is None else img[:, :, ::-1]


def _check_route(data: bytes, route: str, tmp_path: Path) -> None:
    """The port's route against JAX's decoder there."""
    pm = 2 * DIM if route in ("native", "serve") else 0
    got = J.decode_blobs([data], DIM, route, pm, device="cpu")[0]
    native = _native(data, pm)
    if route == "native" or (route == "serve" and native is not None):
        assert (got is None) == (native is None)
        if native is not None:
            assert np.array_equal(got, native)
        return
    full = _cv2_full(data, "imdecode" if route == "serve" else route,
                     tmp_path)
    assert (got is None) == (full is None)
    if full is not None:
        assert np.array_equal(D.decode_image(data), full)
        assert np.array_equal(got, D.resize_bilinear(full, DIM, DIM))
        near = cv2.resize(full, (DIM, DIM), interpolation=cv2.INTER_LINEAR)
        assert np.abs(got.astype(int) - near).max() <= 1


@pytest.mark.parametrize("route", J.ROUTES)
@pytest.mark.parametrize("name", NAMES)
def test_fixture_on_every_route(name, route, tmp_path):
    """Each libjpeg-written fixture, whole, cut and without its EOI, on
    each route: JAX's native path bit for bit (with the prescale on native
    and serve), cv2's pixels bit for bit at full scale (imread, imdecode,
    and serve where native refuses: CMYK and YCCK); a cut file is None on
    imdecode, as cv2.imdecode returns."""
    for kind, data in _variants(_blob(name)).items():
        try:
            _check_route(data, route, tmp_path)
        except AssertionError as e:
            raise AssertionError(f"{name} {kind} on {route}") from e


def test_reference_npz_is_what_jax_decodes():
    """``reference.npz`` (what the card is held against) is JAX's native
    path at 64 px without and with the prescale, and cv2's full scale."""
    ref = np.load(GOLDEN / "reference.npz")
    for name in NAMES:
        data, stem = _blob(name), name[:-4]
        plain = native_decode_resize_mem(data, 64, 0)
        pre = native_decode_resize_mem(data, 64, 128)
        assert (plain is None) == (f"{stem}/native64" not in ref)
        if plain is not None:
            assert np.array_equal(ref[f"{stem}/native64"], plain)
            assert np.array_equal(ref.get(f"{stem}/native64_pre",
                                          ref[f"{stem}/native64"]), pre)
        if f"{stem}/cv2" in ref:
            full = cv2.imdecode(np.frombuffer(data, np.uint8), 1)[:, :, ::-1]
            assert np.array_equal(ref[f"{stem}/cv2"], full)
            assert np.array_equal(D.decode_image(data), full)


@pytest.mark.parametrize("name", NAMES)
def test_cpp_coefficients_equal_python(name):
    """The C++ decoder's coefficients of each fixture, whole and cut, equal
    data/decode.py's exactly, packed for s = 8, 4, 2, 1 and under each
    smoothing rule (a cut SOF10 file is smoothed)."""
    for kind, data in _variants(_blob(name)).items():
        try:
            header = D.parse_jpeg(data)
        except D.DecodeError:
            assert native_decode_resize_mem(data, 16, 0) is None, kind
            continue
        assert header.arithmetic
        for rule in (None, "2.1", "3.1"):
            ref = D.jpeg_coefficients(data, header, rule)
            for s in (8, 4, 2, 1):
                got = J.coefficients(data, s, rule)
                for a, b in zip(ref, got):
                    assert np.array_equal(J.pack_blocks(
                        a.astype(np.int16), s), b), (kind, rule, s)


@pytest.mark.parametrize("name", NAMES)
def test_recode_writes_libjpegs_bytes(name):
    """``arith_recode`` of a fixture's own coefficients, with its
    progression, restart interval and conditioning, writes the bytes
    libjpeg's jcarith.c wrote, marker for marker."""
    m = MANIFEST[name]
    data = _blob(name)
    header = D.parse_jpeg(data)
    mcux = -(-header.width // (8 * header.hmax))
    restart = m["restart_interval"] or m["restart_in_rows"] * mcux
    cond = ({t: tuple(v) for t, v in enumerate(m["conditioning"])}
            if m["conditioning"] else None)
    assert F.arith_recode(data, progressive=m["sof"] == 10, restart=restart,
                          conditioning=cond) == data


def _photo(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(128, 60, (h // 4 + 2, w // 4 + 2, channels))
    x = cv2.resize(x.astype(np.float32), (w, h),
                   interpolation=cv2.INTER_CUBIC).reshape(h, w, channels)
    x += rng.normal(0, 10, x.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def _marked(data: bytes, marker: int) -> bytes:
    b = bytearray(data)
    b[b.index(b"\xff\xc0") + 1] = marker
    return bytes(b)


@pytest.mark.parametrize("rst", [0, 2])
def test_huffman_stream_marked_sof9(rst, tmp_path):
    """A baseline file with its frame marked SOF9: libjpeg reads the
    Huffman data as arithmetic codes until a bad code (a category past 15
    bits or an index past 63; JWRN_ARITH_BAD_CODE) and leaves the rest of
    the restart interval as it was; every route decodes it as JAX's does,
    and the C++ coefficients equal decode.py's."""
    img = _photo(48, 64, 3)
    data = _marked(cv2.imencode(".jpg", img[:, :, ::-1], [
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])[1].tobytes(), 0xC9)
    ref = D.jpeg_coefficients(data, smooth=None)
    for a, b in zip(ref, J.coefficients(data, 8, None)):
        assert np.array_equal(a, b)
    for route in J.ROUTES:
        _check_route(data, route, tmp_path)


def _dac(data: bytes, entries: bytes) -> bytes:
    """``data`` with its first DAC segment's entries replaced."""
    i = data.index(b"\xff\xcc")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    return (data[:i + 2] + (len(entries) + 2).to_bytes(2, "big") + entries
            + data[i + 2 + n:])


@pytest.mark.parametrize("entries,decodes", [
    (bytes([0, 0x52, 16, 10, 1, 0x31, 17, 20]), True),   # the fixture's own
    (bytes([0, 0x00, 16, 1]), True),                      # L = U = 0, Kx 1
    (bytes([0, 0xFF, 16, 0]), True),                      # L = U = 15, Kx 0
    (bytes([16, 255]), True),                             # Kx 255
    (bytes([5, 0x21, 21, 9]), True),                      # unused tables
    (bytes([0, 0x25]), False),                            # L 5 > U 2
    (bytes([32, 5]), False),                              # index 32
    (bytes([0, 0x10, 16]), False),                        # odd length
])
def test_dac_conditioning_and_checks(entries, decodes, tmp_path):
    """DAC markers set the conditioning the scans read (DC L and U, AC Kx
    by table), and libjpeg's get_dac refuses what it refuses (an index past
    31, L > U, an odd length): decoded as JAX's native path and cv2 decode
    it, or None on every route where they refuse it."""
    data = _dac(_blob("sof9_dac.jpg"), entries)
    assert (native_decode_resize_mem(data, DIM, 0) is not None) == decodes
    if not decodes:
        with pytest.raises(D.DecodeError):
            D.parse_jpeg(data)
    for route in J.ROUTES:
        _check_route(data, route, tmp_path)


def _rst_positions(data: bytes):
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


def _file(kind: str) -> bytes:
    """A fixture by name, or a Huffman JPEG written by cv2: "baseline",
    "progressive", "restart" (baseline, an interval of 2 MCUs) or
    "progressive restart" (intervals of one MCU)."""
    if kind.endswith(".jpg"):
        return _blob(kind)
    img = _photo(64, 96, 0)[:, :, ::-1]
    return cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(kind.startswith("progressive")),
        cv2.IMWRITE_JPEG_RST_INTERVAL,
        {"restart": 2, "progressive restart": 1}.get(kind, 0)])[1].tobytes()


@pytest.mark.parametrize("kind", ["sof9_restart2.jpg", "sof10_restart3.jpg",
                                  "restart", "progressive restart"])
def test_markers_in_the_data_as_libjpeg_resyncs(kind, tmp_path):
    """Restart markers damaged in the data: one turned into a stray code
    (skipped by jpeg_resync_to_restart), one renumbered (a restart out of
    step: read, or left unread with its interval decoded from zero
    bytes), one dropped, one after a fill byte; a DNL code in the data;
    garbage between two marker segments, which libjpeg skips; an unknown
    marker after the scans.  Arithmetic and Huffman coding alike, each as
    JAX's native path and cv2 decode it."""
    data = _file(kind)
    rsts = _rst_positions(data)
    cases = []
    for k, code in ((1, 0x92), (2, 0xD5), (3, 0xD0), (4, 0x05)):
        b = bytearray(data)
        b[rsts[k] + 1] = code
        cases.append(bytes(b))
    cases.append(data[:rsts[2]] + data[rsts[2] + 2:])
    cases.append(data[:rsts[5] - 1] + b"\xff" + data[rsts[5]:])
    cases.append(data[:rsts[6] - 2] + b"\xff\xdc" + data[rsts[6]:])
    sos = data.rindex(b"\xff\xda")
    cases.append(data[:sos] + b"\x12\x34\x00\xff\x00" + data[sos:])
    eoi = len(data) - 2
    cases.append(data[:eoi] + b"\xff\xf3\x00\x04ab" + data[eoi:])
    for i, case in enumerate(cases):
        for route in ("native", "imread"):
            try:
                _check_route(case, route, tmp_path)
            except AssertionError as e:
                raise AssertionError(f"case {i} on {route}") from e


def _trailing_cases(data: bytes):
    """``data`` with a segment after its scans (an unknown marker, a DHT
    of table index 0x27 or 0x1F, a second SOF, a short DQT, a DQT cut in
    its values, a new DQT, a DRI of a bad length, a DNL, a COM, a COM cut
    short), each with and without the EOI after it; and ``data`` without
    its EOI, without its last byte, and cut to 80%."""
    eoi = len(data) - 2
    cases = []
    for seg in (b"\xff\xf3\x00\x04ab", b"\xff\xc4\x00\x05\x27\x00\x00",
                b"\xff\xc4\x00\x05\x1f\x00\x00",
                b"\xff\xdd\x00\x05\x00\x01\x02",
                b"\xff\xdc\x00\x04\x00\x20",
                b"\xff\xc0\x00\x04ab", b"\xff\xdb\x00\x03\x77",
                b"\xff\xdb\x00\x43\x00\x01",
                b"\xff\xdb\x00\x43\x00" + bytes(range(1, 65)),
                b"\xff\xfe\x00\x05abc", b"\xff\xfe\x00\x25abc"):
        cases += [data[:eoi] + seg + data[eoi:], data[:eoi] + seg]
    return cases + [data[:-2], data[:-1], data[:int(len(data) * 0.8)]]


@pytest.mark.parametrize("kind", ["baseline", "progressive", "restart",
                                  "sof9_restart2.jpg", "sof9_gray_33x41.jpg",
                                  "sof10_420_96x64.jpg"])
def test_what_follows_the_scans(kind, tmp_path):
    """Segments after the scans, as each decoder meets them: libjpeg reads
    what follows a one-scan sequential frame's scan only when it finishes,
    where JAX's native path fails on an error and cv2 keeps the image,
    and cv2.imdecode minds a cut there no more; a progressive frame is
    read whole before any output, so both refuse it, and imdecode a cut.
    A table redefined after the scans changes nothing (libjpeg latches
    each component's at its first scan).  Huffman and arithmetic coding
    alike, on the native, imread and imdecode routes."""
    for i, case in enumerate(_trailing_cases(_file(kind))):
        for route in ("native", "imread", "imdecode"):
            try:
                _check_route(case, route, tmp_path)
            except AssertionError as e:
                raise AssertionError(f"case {i} on {route}") from e


@pytest.mark.parametrize("mode,marker,precision", [
    ("lossless", 0xC3, 8), ("arithmetic lossless", 0xCB, 8),
    ("12-bit", 0xC9, 12), ("hierarchical", 0xCD, 8)])
def test_modes_no_libjpeg_reads_are_none(mode, marker, precision):
    """Lossless (SOF3, SOF11), 12-bit (SOF9 at 12 bits) and hierarchical
    JPEGs: neither JAX's native path nor cv2 reads them, and every route
    returns None."""
    b = bytearray(_marked(encode_jpeg(_photo(24, 24, 1)), marker))
    b[b.index(bytes([0xFF, marker])) + 4] = precision
    data = bytes(b)
    assert native_decode_resize_mem(data, 16, 0) is None
    assert cv2.imdecode(np.frombuffer(data, np.uint8), 1) is None
    with pytest.raises(D.DecodeError):
        D.parse_jpeg(data)
    for route in J.ROUTES:
        pm = 32 if route in ("native", "serve") else 0
        assert J.decode_blobs([data], 16, route, pm, device="cpu") == [None]


def test_loader_folder_of_arithmetic_jpegs(tmp_path):
    """An all-JPEG folder holding arithmetic-coded files (SOF9, SOF10, one
    cut) beside a Huffman one: ``decode_files`` takes JAX's native route
    and equals ``native_bulk_decode_resize`` bit for bit, with the
    prescale."""
    names = ["sof9_420_96x64.jpg", "sof10_640x480.jpg", "sof9_gray_33x41.jpg",
             "sof10_restart3.jpg"]
    blobs = [_blob(n) for n in names]
    blobs[1] = blobs[1][:int(len(blobs[1]) * 0.6)]
    blobs.append(encode_jpeg(_photo(80, 96, 5)))
    paths = []
    for i, blob in enumerate(blobs):
        paths.append(str(tmp_path / f"{i}.jpg"))
        Path(paths[-1]).write_bytes(blob)
    native, ok = native_bulk_decode_resize(paths, 40, 1, prescale_min=80)
    assert ok.all()
    got = decode_files(paths, 40, prescale=True, device="cpu")
    for i, img in enumerate(got):
        assert np.array_equal(img, native[i]), i


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2 ** 16), size=st.tuples(st.integers(8, 40),
                                                       st.integers(8, 40)),
       sampling=st.sampled_from([(2, 2), (2, 1), (1, 1), None]),
       progressive=st.booleans(), restart=st.sampled_from([0, 1, 3]),
       cond=st.sampled_from([None, {0: (2, 5, 10), 1: (1, 3, 20)},
                             {0: (0, 0, 1), 1: (15, 15, 63)}]))
def test_arith_recode_decodes_to_the_baseline(seed, size, sampling,
                                              progressive, restart, cond):
    """The fixture tool's QM encoder over small seeded photos (4:2:0,
    4:2:2, 4:4:4, gray; sequential or progressive; restart intervals;
    conditioning): data/decode.py, the C++ decoder and cv2 decode the
    re-code to the baseline file's coefficients and pixels."""
    h, w = size
    img = _photo(h, w, seed) if sampling else _photo(h, w, seed)[:, :, 0]
    base = encode_jpeg(img, 90, sampling or (1, 1))
    coefs = D.jpeg_coefficients(base, smooth=None)
    data = F.arith_recode(base, progressive=progressive, restart=restart,
                          conditioning=cond)
    header = D.parse_jpeg(data)
    assert header.arithmetic and header.progressive == progressive
    for a, b, c in zip(coefs, D.jpeg_coefficients(data, smooth=None),
                       J.coefficients(data, 8, None)):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    full = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(full, cv2.imdecode(np.frombuffer(base, np.uint8),
                                             cv2.IMREAD_COLOR))
    assert np.array_equal(D.decode_image(data), full[:, :, ::-1])


def test_fixtures_are_small_and_described():
    """The fixture directory stays small, and its manifest names libjpeg
    and every file in it."""
    total = sum(p.stat().st_size for p in GOLDEN.iterdir())
    assert total < 400_000
    assert sorted(p.name for p in GOLDEN.glob("*.jpg")) == NAMES
    assert "libjpeg" in json.loads(
        (GOLDEN / "MANIFEST.json").read_text())["written_by"]
    assert os.path.exists(GOLDEN / "reference.npz")
