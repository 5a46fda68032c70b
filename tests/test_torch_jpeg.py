"""The fast JPEG decode (``ops/jpeg.py``, ``csrc/jpeg_entropy.cpp``) and the
DCT-domain prescale of ``data/decode.py`` on the CPU: the C++ Huffman
decoder's coefficients against the pure-Python one exactly; the whole fast
decode (C++ + the plain pixel stage) against ``data/decode.py`` and the JAX
package's native libjpeg path bit for bit, at full scale and at the scales
m = 1, 2 and 4 its prescale picks, and the unresized reduced decode against
``cv2.imdecode(IMREAD_REDUCED_*)``; the plain IDCTs against
``data/decode.py``'s int64 form under hypothesis; BMPs against
``cv2.imread``; cut and corrupt scans and cut headers as JAX's native
path decodes them; a missing compiler and a failed build raise."""

import io
import shutil
import struct

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from aihab_clip_tpu.native import (native_bulk_decode_resize,
                                   native_bulk_decode_resize_mem,
                                   native_decode_resize_mem)

from aihab_clip_tpu_torch.data import decode as D
from aihab_clip_tpu_torch.ops import _build
from aihab_clip_tpu_torch.ops import jpeg as J
from torch_jpeg_batch import decode_batch

SAMPLING = {"420": 0x221111, "422": 0x211111, "444": 0x111111, "440": 0x121111}
# m -> the cv2 flag that decodes at m/8
REDUCED = {1: cv2.IMREAD_REDUCED_COLOR_8, 2: cv2.IMREAD_REDUCED_COLOR_4,
           4: cv2.IMREAD_REDUCED_COLOR_2, 8: cv2.IMREAD_COLOR}


def _photo(h, w, seed=0):
    """A smooth image with noise: edges and flat areas, like a photo."""
    rng = np.random.default_rng(seed)
    x = rng.normal(128, 60, (h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    x += rng.normal(0, 10, x.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def _jpeg(img, quality=90, sampling="420", rst=0) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    return buf.tobytes()


def _gray(h, w, seed=0) -> bytes:
    return cv2.imencode(".jpg", cv2.cvtColor(_photo(h, w, seed),
                                             cv2.COLOR_BGR2GRAY))[1].tobytes()


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality,rst", [(50, 0), (95, 0), (95, 3)])
def test_entropy_coefficients_equal_python(sampling, quality, rst):
    """csrc/jpeg_entropy.cpp's coefficients are data/decode.py's, at full
    size (all 64) and packed for each reduced IDCT (its columns KEEP[s])."""
    for i, (h, w) in enumerate([(64, 64), (37, 53), (101, 77), (17, 3)]):
        data = _jpeg(_photo(h, w, i), quality, sampling, rst)
        ref = D.jpeg_coefficients(data)
        for s in (8, 4, 2, 1):
            got = J.coefficients(data, s)
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                assert a.dtype == np.int16
                assert np.array_equal(a, J.pack_blocks(b, s)), (h, w, s)


def test_entropy_gray_truncated_and_corrupt():
    """Gray files decode alike; a scan cut short (its EOI put back, so the
    header parses) or a scan with a corrupt code decodes in both decoders
    as libjpeg decodes it (the rest of a cut scan left at zero; bits that
    start no code read as symbol 0): the same coefficients, and the
    pixels of JAX's native path."""
    data = _gray(40, 52)
    assert np.array_equal(J.coefficients(data)[0],
                          D.jpeg_coefficients(data)[0])
    full = _jpeg(_photo(48, 64), 90)
    header = D.parse_jpeg(full)
    start = header.scans[0].start
    corrupt = full[:start + 5] + b"\xff\x00" * 20 + full[start + 45:]
    cuts = [full[:start + int((len(full) - start) * keep)] + b"\xff\xd9"
            for keep in (0.3, 0.6, 0.9)]
    for blob in cuts + [corrupt]:
        ref = D.jpeg_coefficients(blob)
        for a, b in zip(J.coefficients(blob), ref):
            assert np.array_equal(a, b)
        got, ok = decode_batch([blob], 32)
        assert ok.all()
        assert np.array_equal(got[0].numpy(),
                              native_decode_resize_mem(blob, 32, 0))
    assert not D.jpeg_coefficients(cuts[0])[0][-1].any()


def _non_interleaved(data: bytes, rst: int = 0) -> bytes:
    """``data`` (a cv2 JPEG with the standard tables) rewritten with one
    scan per component (baseline, non-interleaved): the same coefficients,
    blocks in each component's own raster order, restarts every ``rst``."""
    from aihab_clip_tpu_torch.data.encode import (_AC_CHROMA, _AC_LUMA,
                                                  _DC_CHROMA, _DC_LUMA,
                                                  _BitWriter, _code_table,
                                                  _encode_block, _segment)

    header = D.parse_jpeg(data)
    coefs = D.jpeg_coefficients(data, header)
    out = [data[:header.scans[0].start - 2 - 2 - (1 + 2 * len(
        header.comps)) - 3]]               # up to the SOS marker
    if rst:
        out.append(_segment(0xDD, rst.to_bytes(2, "big")))
    for k, (c, blocks) in enumerate(zip(header.comps, coefs)):
        t = min(k, 1)
        dc, ac = ((_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA))[t]
        out.append(_segment(0xC4, bytes([t] + dc[0] + dc[1])))
        out.append(_segment(0xC4, bytes([0x10 | t] + ac[0] + ac[1])))
        out.append(_segment(0xDA, bytes([1, c.cid, (t << 4) | t, 0, 63,
                                         0])))
        cols = -(-(-(-header.width * c.h // header.hmax)) // 8)
        rows = -(-(-(-header.height * c.v // header.vmax)) // 8)
        units = [blocks[r * c.bw + q][D._ZIGZAG].tolist()
                 for r in range(rows) for q in range(cols)]
        writer, pred, scan = _BitWriter(), 0, b""
        for i, blk in enumerate(units):
            if rst and i and i % rst == 0:
                scan += writer.flush() + bytes([0xFF, 0xD0 + (i // rst - 1)
                                                % 8])
                writer, pred = _BitWriter(), 0
            _encode_block(writer, blk, pred, _code_table(dc),
                          _code_table(ac))
            pred = blk[0]
        out.append(scan + writer.flush())
    return b"".join(out) + b"\xff\xd9"


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("rst", [0, 5])
def test_non_interleaved_scans(sampling, rst):
    """A baseline file with one scan per component (tables redefined
    between scans, restarts or not): the C++ and Python coefficients agree
    and equal the interleaved original's (but for the MCU padding blocks,
    which a component's own scan does not code); the pixels are
    cv2.imread's and the fast decode's are data/decode.py's, full and
    reduced."""
    data = _jpeg(_photo(61, 83), 85, sampling)
    multi = _non_interleaved(data, rst)
    header = D.parse_jpeg(multi)
    assert len(header.scans) == 3
    ref = D.jpeg_coefficients(multi, header)
    for c, a, b, orig in zip(header.comps, J.coefficients(multi), ref,
                             D.jpeg_coefficients(data)):
        assert np.array_equal(a, b)
        cols = -(-(-(-header.width * c.h // header.hmax)) // 8)
        rows = -(-(-(-header.height * c.v // header.vmax)) // 8)
        coded = b.reshape(c.bh, c.bw, 64)[:rows, :cols]
        assert np.array_equal(coded, orig.reshape(c.bh, c.bw, 64)[:rows,
                                                                  :cols])
    cv = cv2.imdecode(np.frombuffer(multi, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(D.decode_jpeg(multi), cv[:, :, ::-1])
    for pm in (0, 16):
        got, ok = decode_batch([multi], 12, "native", pm)
        m = D.prescale_factor((header.width, header.height), pm)
        assert ok.all() and np.array_equal(
            got[0].numpy(), D.resize_bilinear(D.decode_jpeg(multi, m), 12, 12))


@pytest.mark.parametrize("dim", [16, 48])
def test_fast_decode_full_scale_equals_decode_py_and_native(dim, tmp_path):
    """C++ + the plain pixel stage at full scale = data/decode.py's
    decode_resize = JAX's native_bulk_decode_resize(prescale_min=0), bit
    for bit, across samplings, restarts, gray and odd sizes; blobs that are
    no JPEG or are cut have ok False and zero pixels."""
    blobs, paths = [], []
    for i, samp in enumerate(sorted(SAMPLING)):
        for rst in (0, 2):
            blobs.append(_jpeg(_photo(37 + 9 * i, 53, i), 85, samp, rst))
    blobs.append(_gray(40, 52))
    for i, b in enumerate(blobs):
        paths.append(tmp_path / f"{i}.jpg")
        paths[-1].write_bytes(b)
    got, ok = decode_batch(blobs + [b"junk", blobs[0][:200]], dim)
    assert got.shape == (len(blobs) + 2, dim, dim, 3)
    assert ok.tolist() == [True] * len(blobs) + [False, False]
    assert not got[-2:].any()
    native, nok = native_bulk_decode_resize([str(p) for p in paths], dim, 2,
                                            prescale_min=0)
    assert nok.all()
    for i, p in enumerate(paths):
        mine = got[i].numpy()
        assert np.array_equal(mine, D.decode_resize(str(p), dim)), i
        assert np.array_equal(mine, native[i]), i


@pytest.mark.parametrize("sampling", sorted(SAMPLING) + ["gray"])
@pytest.mark.parametrize("dim,m", [(16, 1), (24, 2), (32, 2), (48, 4)])
def test_prescale_equals_native_and_cv2(sampling, dim, m, tmp_path):
    """At the native rule's m (prescale_min = 2 x dim) the fast decode, the
    numpy reference and JAX's native_decode_resize_mem and
    native_bulk_decode_resize agree bit for bit; the unresized reduced
    decode equals cv2.imdecode(IMREAD_REDUCED_*)."""
    h, w = (256, 320) if m != 4 else (200, 264)
    data = (_gray(h, w) if sampling == "gray"
            else _jpeg(_photo(h, w), 90, sampling))
    assert D.prescale_factor((w, h), 2 * dim) == m
    path = tmp_path / "p.jpg"
    path.write_bytes(data)
    got, ok = decode_batch([data], dim, "native", 2 * dim)
    assert ok.all()
    mine = got[0].numpy()
    assert np.array_equal(mine, native_decode_resize_mem(data, dim, 2 * dim))
    bulk, bok = native_bulk_decode_resize([str(path)], dim, 1,
                                          prescale_min=2 * dim)
    assert bok.all() and np.array_equal(mine, bulk[0])
    assert np.array_equal(mine, D.decode_resize(str(path), dim,
                                                prescale=True))
    reduced = D.decode_jpeg(data, m)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), REDUCED[m])[:, :, ::-1]
    assert reduced.shape == ref.shape == (-(-h * m // 8), -(-w * m // 8), 3)
    assert np.array_equal(reduced, ref)


def test_prescale_batch_mixes_scales_and_restarts():
    """One batch whose photos take m = 1, 2, 4 and 8 (restart markers in
    some) equals JAX's one-call native_bulk_decode_resize_mem."""
    blobs = [_jpeg(_photo(h, w, i), 80, samp, rst) for i, (h, w, samp, rst)
             in enumerate([(336, 448, "420", 0), (200, 160, "422", 4),
                           (100, 90, "444", 0), (40, 48, "440", 1),
                           (330, 250, "420", 7)])]
    got, ok = decode_batch(blobs, 20, "native", 40)
    ref, rok = native_bulk_decode_resize_mem(blobs, 20, prescale_min=40)
    assert ok.all() and rok.all()
    assert np.array_equal(got.numpy(), ref)
    assert sorted({D.prescale_factor(D.jpeg_size(b), 40) for b in blobs}) \
        == [1, 2, 4, 8]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_fast_decode_applies_exif_as_decode_py(orientation):
    """EXIF orientation (which cv2.imread applies and libjpeg does not)
    through J2's plain version equals data/decode.py's, full and reduced."""
    pil = Image.fromarray(_photo(120, 200))
    exif = pil.getexif()
    exif[0x0112] = orientation
    b = io.BytesIO()
    pil.save(b, "JPEG", quality=90, exif=exif.tobytes())
    data = b.getvalue()
    for dim, pm in ((24, 0), (24, 48), (40, 0)):
        got, ok = decode_batch([data], dim, "native", pm)
        m = D.prescale_factor(D.jpeg_size(data), pm)
        ref = D.resize_bilinear(D.decode_jpeg(data, m), dim, dim)
        assert ok.all() and np.array_equal(got[0].numpy(), ref)


# EXIF orientation o as an array transform of the upright-less pixels
_ORIENT = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
           6: lambda a: np.rot90(a, -1),
           7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),
           8: lambda a: np.rot90(a, 1)}


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_is_the_only_difference_from_native(orientation):
    """The JAX native path ignores EXIF orientation; this package applies
    it, as cv2.imread does.  The two outputs differ by exactly that
    transform (the resize commutes with it), at full scale and prescaled,
    on a photo that is not square."""
    pil = Image.fromarray(_photo(220, 300))
    exif = pil.getexif()
    exif[0x0112] = orientation
    b = io.BytesIO()
    pil.save(b, "JPEG", quality=90, exif=exif.tobytes())
    data = b.getvalue()
    for dim, pm in ((24, 0), (24, 48), (40, 80), (37, 0)):
        got, ok = decode_batch([data], dim, "native", pm)
        native = native_decode_resize_mem(data, dim, pm)
        mine = got[0].numpy()
        assert ok.all()
        assert np.array_equal(mine, _ORIENT[orientation](native))
        assert np.array_equal(mine, native) == (orientation == 1)


def _marked(data: bytes, marker: int = 0xC9) -> bytes:
    """``data`` with its frame marker changed: SOF9 reads its Huffman data
    as arithmetic codes (JAX's native path and cv2 decode it, up to a bad
    code), SOF3 marks it lossless (neither reads it)."""
    b = bytearray(data)
    b[b.index(b"\xff\xc0") + 1] = marker
    return bytes(b)


def test_fast_decode_refuses_what_decode_py_refuses():
    """A lossless JPEG is refused on its own while the good blob and an
    arithmetic-coded one beside it decode as decode.py and JAX's native
    path do; a batch of no good blob launches nothing."""
    arith = _marked(_jpeg(_photo(32, 32, 1)))
    good = _jpeg(_photo(32, 32))
    lossless = _marked(good, 0xC3)
    got, ok = decode_batch([good, arith, lossless], 16)
    assert ok.tolist() == [True, True, False] and not got[2].any()
    for i, blob in enumerate((good, arith)):
        assert np.array_equal(got[i].numpy(),
                              D.resize_bilinear(D.decode_jpeg(blob), 16, 16))
    assert np.array_equal(got[1].numpy(),
                          native_decode_resize_mem(arith, 16, 0))
    J.reset_launch_counts()
    decode_batch([lossless, b"junk"], 16)
    assert set(J.launch_counts().values()) == {0}


def _sof(data: bytes) -> int:
    return data.index(b"\xff\xc0")


def _bad_blobs():
    """Blobs that fail in the header or the layout, by kind."""
    base = _jpeg(_photo(40, 56), rst=2)
    sof = _sof(base)
    fractional = bytearray(base)
    fractional[sof + 11] = 0x32          # Y 3x2 beside Cb 1x1 ...
    fractional[sof + 14] = 0x21          # ... and Cb 2x1: a ratio of 3/2
    short_sof = bytearray(base)
    short_sof[sof + 2:sof + 4] = (8).to_bytes(2, "big")
    return {"cut in SOF": base[:sof + 8], "cut in DQT": base[:30],
            "cut in SOS": base[:base.index(b"\xff\xda") + 7],
            "cut in DRI": base[:base.index(b"\xff\xdd") + 5],
            "short SOF": bytes(short_sof), "fractional": bytes(fractional)}


def test_parse_jpeg_raises_decode_error_on_every_cut_header():
    """Every prefix of a JPEG's header (DQT, DHT, DRI, SOF, SOS cut
    anywhere), a segment shorter than its kind and a fractional sampling
    ratio are DecodeErrors where JAX's native path refuses them: a file
    that is no image, never an IndexError.  The prefixes it decodes (an SOS
    cut in its band bytes, which libjpeg only warns about) decode to its
    pixels."""
    base = _jpeg(_photo(40, 56), rst=2)
    scan = base.index(b"\xff\xda")
    for cut in range(scan + 14):
        native = native_decode_resize_mem(base[:cut], 16, 0)
        if native is None:
            with pytest.raises(D.DecodeError):
                D.parse_jpeg(base[:cut])
            continue
        assert cut >= scan + 11, cut
        got, ok = decode_batch([base[:cut]], 16)
        assert ok.all() and np.array_equal(got[0].numpy(), native)
    for name, blob in _bad_blobs().items():
        with pytest.raises(D.DecodeError):
            D.jpeg_layout(D.parse_jpeg(blob))
        assert _decodes_to_none(blob), name


def _decodes_to_none(blob) -> bool:
    try:
        D.decode_image(blob)
    except D.DecodeError:
        return True
    return False


def test_one_bad_blob_fails_alone():
    """Header-cut, short-segment, fractional-sampling and lossless JPEGs,
    garbage, a cut PNG and one whose IHDR no longer matches its CRC, mixed
    with good JPEGs (one progressive, one arithmetic-coded), a PNG and a
    BMP on the server's route: the good ones decode as data/decode.py (and
    the arithmetic-coded one as JAX's native path) does, the bad ones are
    None."""
    good = [_jpeg(_photo(48, 64, 1)), _jpeg(_photo(33, 41, 2), sampling="422"),
            cv2.imencode(".jpg", _photo(32, 32),
                         [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()]
    png = cv2.imencode(".png", _photo(30, 26, 3))[1].tobytes()
    bmp = cv2.imencode(".bmp", _photo(21, 19, 4))[1].tobytes()
    adam7 = bytearray(png)
    adam7[28] = 1                       # IHDR's interlace method
    arith = _marked(good[0])
    bad = list(_bad_blobs().values()) + [b"junk", png[:20],
                                        _marked(good[1], 0xC3)]
    blobs = [good[0], *bad[:3], arith, good[1], png, bytes(adam7), *bad[3:],
             bmp, good[2]]
    images = J.decode_blobs(blobs, 20, "serve", 40, device="cpu")
    for blob, img in zip(blobs, images):
        if blob == arith:
            assert np.array_equal(img, native_decode_resize_mem(blob, 20,
                                                                40))
        elif blob in good or blob in (png, bmp):
            m = D.prescale_factor(D.jpeg_size(blob), 40) \
                if blob in good else 8
            ref = D.resize_bilinear(
                D.decode_jpeg(blob, m) if blob in good
                else D.decode_image(blob), 20, 20)
            assert np.array_equal(img, ref)
        else:
            assert img is None


_EXTREME = st.sampled_from([-32768, -32767, -2047, -255, -1, 0, 1, 255, 2047,
                            32767])


@settings(max_examples=30, deadline=None)
@given(coef=st.lists(_EXTREME, min_size=64 * 6, max_size=64 * 6),
       table=st.lists(st.sampled_from([1, 2, 99, 255, 1000, 65535]),
                      min_size=64, max_size=64),
       s=st.sampled_from([8, 4, 2, 1]))
def test_plain_idct_matches_decode_py(coef, table, s):
    """J1's plain IDCTs on extreme blocks (int16 extremes, 16-bit tables)
    equal data/decode.py's int64 form (islow, jidctred 4x4 / 2x2 / 1x1)."""
    c = np.asarray(coef, np.int64).reshape(6, 64)
    q = np.asarray(table, np.int64)
    ref = D.idct_scaled(c.reshape(6, 8, 8), q.reshape(8, 8), s)
    got = J.idct_plain(torch.from_numpy(J.pack_blocks(c, s)),
                       torch.from_numpy(q[J.KEEP[s]]), s)
    assert np.array_equal(got.numpy(), ref)


def _bmp(img: np.ndarray, bpp: int, top_down: bool) -> bytes:
    """An uncompressed (BI_RGB) BMP of RGB ``img``."""
    h, w = img.shape[:2]
    px = img[:, :, ::-1]
    if bpp == 32:
        px = np.concatenate([px, np.full((h, w, 1), 7, np.uint8)], -1)
    stride = (w * bpp + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bpp // 8] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    pixels = rows.tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       0, len(pixels), 2835, 2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 14 + 40 + len(pixels), 0, 0, 54)
            + info + pixels)


@pytest.mark.parametrize("bpp", [24, 32])
@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("size", [(13, 17), (8, 8), (1, 5)])
def test_bmp_equals_cv2(bpp, top_down, size):
    img = _photo(*size)
    data = _bmp(img, bpp, top_down)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(D.decode_image(data), ref[:, :, ::-1])
    assert np.array_equal(D.decode_image(data), img)
    written = cv2.imencode(".bmp", img[:, :, ::-1])[1].tobytes()
    assert np.array_equal(D.decode_image(written), img)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build directory and library table of the test's own."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    return tmp_path


def test_host_build_raises_without_compiler(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-c++"))
    with pytest.raises(RuntimeError, match="compiler"):
        _build.host_library("jpeg_entropy")
    with pytest.raises(RuntimeError, match="compiler"):
        decode_batch([_jpeg(_photo(16, 16))], 8)


def test_host_build_failure_raises(fresh_build, monkeypatch):
    csrc = fresh_build / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    (csrc / "jpeg_entropy.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "_CSRC", csrc)
    with pytest.raises(RuntimeError, match="build failed"):
        _build.host_library("jpeg_entropy")
    assert not list((fresh_build / "build").glob("*.so"))


def test_host_library_is_keyed_by_source(fresh_build, monkeypatch):
    """The host library's name follows its source and flags, and the
    build renames a finished file into place."""
    csrc = fresh_build / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    first = _build._library_path("jpeg_entropy")
    lib = _build.host_library("jpeg_entropy")
    assert first.is_file() and lib.aihab_jpeg_packed_size(2) == 25
    assert [lib.aihab_jpeg_packed_size(s) for s in (8, 4, 2, 1)] == \
        [J.PACKED[s] for s in (8, 4, 2, 1)]
    with open(csrc / "jpeg_entropy.cpp", "a") as f:
        f.write("\n// edited\n")
    assert _build._library_path("jpeg_entropy") != first
