"""The port's zstd decoder (``ops/zstd.py``, ``csrc/zstd_decode.cpp``): the
C++ route and the plain Python one against libzstd (``zstandard``) at levels
-5, 1, 3, 19 and 22 (ultra), with and without content size and checksum,
single-segment and windowed frames, concatenated and skippable frames,
hypothesis-drawn bytes and float32 weights; the raw-block writer read by
libzstd; the refusals (bad input, a checksum mismatch, a dictionary); the
committed frames libzstd wrote (``tests/golden/jax_written/zstd``); and a
broken source failing its build."""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from aihab_clip_tpu_torch.ops import _build
from aihab_clip_tpu_torch.ops import zstd

GOLDEN = Path(__file__).resolve().parent / "golden" / "jax_written"
RNG = np.random.default_rng(0)
TEXT = "".join(f"plot {i} label L3-{i % 23} score {RNG.standard_normal():.5f}\n"
               for i in range(2500)).encode()
WEIGHTS = (RNG.standard_normal(40_000) * 0.02).astype(np.float32).tobytes()
DATAS = {"empty": b"", "one": b"x", "text": TEXT, "weights": WEIGHTS,
         "runs": bytes(RNG.integers(0, 3, 300_000).astype(np.uint8)),
         "mixed": (b"abcdefgh" * 900 + bytes(range(256))) * 40}


def _compress(data, level, checksum=True, size=True):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=size).compress(data)


@pytest.mark.parametrize("level", [-5, 1, 3, 19, 22])
@pytest.mark.parametrize("checksum,size", [(True, True), (False, False),
                                           (True, False)])
@pytest.mark.parametrize("name", sorted(DATAS))
def test_decompress_matches_libzstd(level, checksum, size, name):
    data = DATAS[name]
    frame = _compress(data, level, checksum, size)
    assert zstd.decompress(frame) == data
    if len(data) <= 20_000 or (level in (1, 22) and checksum and size):
        assert zstd.decompress_plain(frame) == data


@pytest.mark.parametrize("level", [1, 19])
def test_windowed_and_streamed_frames(level):
    """Frames written by the streaming API: no content size, a window
    descriptor (not single-segment), several blocks."""
    data = TEXT * 3 + WEIGHTS
    cobj = zstandard.ZstdCompressor(level=level,
                                    write_checksum=True).compressobj()
    frame = cobj.compress(data) + cobj.flush()
    assert not frame[4] & 0x20  # not single-segment: a window descriptor
    assert zstd.decompress(frame) == data
    assert zstd.decompress_plain(frame) == data


def test_concatenated_and_skippable_frames():
    a, b = TEXT[:5000], WEIGHTS[:7000]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"12345"
    stream = skip + _compress(a, 3) + skip + _compress(b, 19, False, False) \
        + zstd.compress_raw(a)
    assert zstd.decompress(stream) == a + b + a
    assert zstd.decompress_plain(stream) == a + b + a


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=3000), st.sampled_from([-5, 1, 3, 19]))
def test_hypothesis_bytes(data, level):
    frame = _compress(data, level)
    assert zstd.decompress(frame) == data
    assert zstd.decompress_plain(frame) == data


@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(-4, 4, width=32), max_size=600),
       st.sampled_from([1, 3, 19, 22]))
def test_hypothesis_float32_weights(values, level):
    data = np.asarray(values, np.float32).tobytes()
    frame = _compress(data, level)
    assert zstd.decompress(frame) == data
    assert zstd.decompress_plain(frame) == data


@pytest.mark.parametrize("n", [0, 1, 131071, 131072, 131073, 300_000])
def test_raw_frames_read_by_libzstd(n):
    data = bytes(RNG.integers(0, 256, n).astype(np.uint8))
    frame = zstd.compress_raw(data)
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=max(n, 1)) == data
    assert zstd.decompress(frame) == data
    assert zstd.decompress_plain(frame) == data
    plain = zstd.compress_raw(data, checksum=False)
    assert zstd.decompress(plain) == data


def test_xxh64():
    assert zstd.xxh64(b"") == zstd.xxh64_plain(b"") == 0xEF46DB3751D8E999
    for n in (1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = bytes(RNG.integers(0, 256, n).astype(np.uint8))
        assert zstd.xxh64(data) == zstd.xxh64_plain(data), n
        assert zstd.xxh64(data, 7) == zstd.xxh64_plain(data, 7), n


def _corrupt_cases():
    good = _compress(TEXT[:20000], 3)
    flipped = bytearray(good)
    flipped[len(good) // 2] ^= 0x40
    bad_sum = bytearray(good)
    bad_sum[-1] ^= 0xFF
    trained = zstandard.train_dictionary(
        2048, [TEXT[i:i + 300] for i in range(0, 60_000, 300)])
    dict_frame = zstandard.ZstdCompressor(dict_data=trained).compress(
        TEXT[:3000])
    assert trained.dict_id() != 0
    return {"magic": b"\x00" * 16, "cut": good[:len(good) // 2],
            "trailing": good + b"\x01\x02", "flipped": bytes(flipped),
            "checksum": bytes(bad_sum), "dictionary": dict_frame,
            "empty": b""}


@pytest.mark.parametrize("case", sorted(_corrupt_cases()))
def test_bad_input_raises(case):
    data = _corrupt_cases()[case]
    for fn in (zstd.decompress, zstd.decompress_plain):
        with pytest.raises(ValueError, match="chunk.zst") as err:
            fn(data, name="chunk.zst")
        if case == "checksum":
            assert "checksum" in str(err.value)
        if case == "dictionary":
            assert "dictionary" in str(err.value)


def test_committed_libzstd_frames():
    digests = json.loads((GOLDEN / "zstd.json").read_text())
    assert len(digests) == 20
    for name, digest in digests.items():
        frame = (GOLDEN / "zstd" / name).read_bytes()
        assert hashlib.sha256(zstd.decompress(frame)).hexdigest() == digest
        assert hashlib.sha256(
            zstd.decompress_plain(frame)).hexdigest() == digest


@pytest.mark.parametrize("source", ["zstd_decode", "blosc_lz4"])
def test_broken_codec_source_raises(source, tmp_path, monkeypatch):
    """A codec source that does not compile raises at its first use (no
    fallback to the plain codecs)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    (csrc / f"{source}.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="build failed"):
        if source == "zstd_decode":
            zstd.decompress(_compress(b"abc", 1))
        else:
            from aihab_clip_tpu_torch.ops import blosc
            blosc.compress(b"abcd" * 100, 4)
    assert not list((tmp_path / "build").glob("*.so"))
