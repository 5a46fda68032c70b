"""The zarr cache store under ``scheme://`` roots (``cache/array_store.py``
``ZarrStore``, ``cache/zarr.py``, ``cache/kvstore.py``) and its codecs
(``ops/blosc.py``, ``csrc/blosc_lz4.cpp``) against the JAX package's
``TensorStoreStore`` (tensorstore, c-blosc): every array JAX writes read bit
for bit (both codec routes), every array the port writes read by JAX bit for
bit with the same ``.zarray``, tensorstore's default chunk shapes, the other
compressors, the caches through a ``file://`` root both ways (sharded
included), the committed store JAX wrote, and the runners: JAX's writes the
ProLIP feature cache under ``file://``, the port's trains ProLIP from it."""

import copy
import json
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aihab_clip_tpu.cache import feature_cache as jax_fc
from aihab_clip_tpu.cache.array_store import TensorStoreStore
from aihab_clip_tpu.config import ConfigNode as JaxConfig
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.models.zoo import _save_config
from aihab_clip_tpu.runner import run as jax_run

from aihab_clip_tpu_torch.cache import feature_cache as fc
from aihab_clip_tpu_torch.cache import zarr
from aihab_clip_tpu_torch.cache.array_store import ZarrStore, open_store
from aihab_clip_tpu_torch.cache.kvstore import FileKvStore, open_kvstore
from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset
from aihab_clip_tpu_torch.ops import blosc
from aihab_clip_tpu_torch.runner import run

GOLDEN = Path(__file__).resolve().parent / "golden" / "jax_written"
RNG = np.random.default_rng(1)


def _bf16(shape, seed=0):
    a = np.asarray(jnp.asarray(np.random.default_rng(seed).standard_normal(
        shape), jnp.bfloat16))
    return a, torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


ARRAYS = {
    "f16": RNG.standard_normal((300, 70)).astype(np.float16),
    "f32": RNG.standard_normal((1100, 1000)).astype(np.float32),  # 2 chunks
    "f32_small": RNG.standard_normal((7,)).astype(np.float32),
    "f64": np.round(RNG.standard_normal(70_001)).astype(np.float64),
    "i64": np.arange(100_000, dtype=np.int64) * 3,
    "i16": (np.arange(200_000) % 97).astype(np.int16),
    "u8": (np.arange(700_003) % 13).astype(np.uint8),   # a short last block
    "u8_odd": (np.arange(1001) % 3).astype(np.uint8),   # no bit shuffle
    "u8_rand": RNG.integers(0, 256, 5000).astype(np.uint8),  # memcpyed
    "bool": RNG.random(5000) > 0.5,
    "empty": np.zeros((0, 5), np.float32),
    "zeros": np.zeros((10, 3), np.float32),
    "scalar": np.float32(3.25),
}


def _same(a, b):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(st.binary(max_size=4000) | st.builds(
    lambda n, k: bytes((np.arange(n) % max(k, 1)).astype(np.uint8)),
    st.integers(0, 5000), st.integers(1, 40)))
def test_lz4_encoders_agree_and_round_trip(data):
    import ctypes

    from aihab_clip_tpu_torch.ops._build import host_library

    lib = host_library("blosc_lz4")
    out = ctypes.create_string_buffer(len(data) + len(data) // 255 + 16)
    n = ctypes.c_longlong()
    lib.aihab_lz4_compress(data, len(data), out, ctypes.byref(n))
    enc = out.raw[:n.value]
    assert enc == blosc.lz4_encode_plain(data)
    assert blosc.lz4_decode_plain(enc, len(data)) == data
    back = ctypes.create_string_buffer(max(len(data), 1))
    assert lib.aihab_lz4_decompress(enc, len(enc), back, len(data)) == 0
    assert back.raw[:len(data)] == data


@pytest.mark.parametrize("typesize", [1, 2, 4, 8])
@pytest.mark.parametrize("n_items", [0, 5, 1000, 70_001])
def test_blosc_writers_agree_and_round_trip(typesize, n_items):
    data = (np.arange(n_items * typesize) % 29).astype(np.uint8).tobytes()
    frame = blosc.compress(data, typesize)
    assert frame == blosc.compress_plain(data, typesize)
    assert blosc.decompress(frame) == data
    assert blosc.decompress_plain(frame) == data


def test_blosc_bad_frames_raise():
    frame = blosc.compress(bytes(range(256)) * 100, 4)
    assert not blosc.header(frame)["flags"] & 0x2  # compressed blocks
    start = int.from_bytes(frame[16:20], "little")
    bad_size = bytearray(frame)
    bad_size[start:start + 4] = (1 << 30).to_bytes(4, "little")
    for bad in (frame[:len(frame) - 5], bytes(bad_size)):
        with pytest.raises(ValueError, match="c0/0.0"):
            blosc.decompress(bad, name="c0/0.0")
    with pytest.raises(ValueError, match="header"):
        blosc.decompress(b"\x02\x01", name="x")


# ---------------------------------------------------------------------------
# the store against TensorStoreStore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ARRAYS) + ["bf16"])
def test_store_reads_jax_and_jax_reads_store(name, tmp_path):
    if name == "bf16":
        ref, ours = _bf16((40, 33))
    else:
        ref = ours = ARRAYS[name]
    jax_store = TensorStoreStore(f"file://{tmp_path}/j")
    jax_store.save(name, ref)
    port = ZarrStore(f"file://{tmp_path}/j")
    got = port.load(name)
    if name == "bf16":
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(), ref.view(np.int16))
    else:
        assert _same(got, ref), name
    # every chunk through both codec routes
    kv = FileKvStore(tmp_path / "j")
    for key in kv.list(f"{name}/"):
        if not key.endswith(".zarray"):
            frame = kv.read(key)
            assert bytes(blosc.decompress(frame)) == \
                blosc.decompress_plain(frame), key
    # the port's write, read by JAX, with tensorstore's .zarray
    ZarrStore(f"file://{tmp_path}/p").save(name, ours)
    back = TensorStoreStore(f"file://{tmp_path}/p").load(name)
    assert _same(back, ref), name
    assert (tmp_path / "p" / name / ".zarray").read_bytes() == \
        (tmp_path / "j" / name / ".zarray").read_bytes()
    assert sorted(p.name for p in (tmp_path / "p" / name).iterdir()) == \
        sorted(p.name for p in (tmp_path / "j" / name).iterdir())


def test_store_interface_matches_jax(tmp_path):
    j = TensorStoreStore(f"file://{tmp_path}/j")
    p = open_store(f"file://{tmp_path}/p")
    for store in (j, p):
        store.ensure()
        store.save("f0.shard1", np.ones(3, np.float16))
        store.save("f0.shard0", np.zeros(3, np.float16))
        store.save("label", np.arange(3, dtype=np.int32))
        store.save("label", np.arange(4, dtype=np.int32))  # replaced
        store.write_json("manifest.json", {"n": 4})
        store.write_text("metadata.csv", "a,b\n1,2\n")
        store.prefetch("label")
    for store in (ZarrStore(f"file://{tmp_path}/j"), j, p):
        assert store.list_arrays("f0.shard") == ["f0.shard0", "f0.shard1"]
        assert store.exists("label") and not store.exists("f1")
        assert store.read_json("manifest.json") == {"n": 4}
        assert store.read_text("metadata.csv") == "a,b\n1,2\n"
        assert _same(store.load("label"), np.arange(4, dtype=np.int32))
    with pytest.raises(FileNotFoundError):
        p.load("f1")


def test_default_chunks_are_tensorstores():
    rng = np.random.default_rng(4)
    shapes = [tuple(int(x) for x in rng.choice(
        [0, 1, 3, 50, 300, 513, 1000, 1024, 2048, 100_000],
        size=rng.integers(1, 5))) for _ in range(150)]
    shapes += [(), (2049, 513), (300, 300, 300), (2 ** 21,), (10, 200_000)]
    for shape in shapes:
        t = ts.open({"driver": "zarr", "kvstore": "memory://"}, create=True,
                    dtype=np.float32, shape=shape).result()
        want = list(t.chunk_layout.read_chunk.shape) if shape else []
        assert zarr.default_chunks(shape) == want, shape


@pytest.mark.parametrize("compressor", [None, {"id": "zlib", "level": 3},
                                        zarr.ZSTD_1, zarr.BLOSC_LZ4])
@pytest.mark.parametrize("dtype", ["<f4", ">f4", ">i8", "|u1", "<u2"])
def test_zarr_compressors_and_byte_orders(compressor, dtype, tmp_path):
    a = (np.arange(3 * 1001) % 251).astype(dtype).reshape(3, 1001)
    kv = FileKvStore(tmp_path)
    zarr.write_array(kv, "a", a, compressor=compressor if compressor
                     else {"id": "zlib", "level": 1}, chunks=[2, 400])
    got = zarr.read_array(kv, "a")
    assert got.dtype == np.dtype(dtype) and np.array_equal(got, a)
    meta = json.loads(kv.read("a/.zarray"))
    if compressor is None:  # an uncompressed array, by hand
        meta["compressor"] = None
        for key in kv.list("a/"):
            if not key.endswith(".zarray"):
                kv.write(key, zlib.decompress(kv.read(key)))
        kv.write("a/.zarray", json.dumps(meta).encode())
    t = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/a/"},
                open=True).result()
    assert np.array_equal(t.read().result(), a)
    assert np.array_equal(zarr.read_array(kv, "a"), a)


def test_missing_chunks_read_as_fill(tmp_path):
    kv = FileKvStore(tmp_path)
    a = np.arange(40, dtype=np.float32).reshape(4, 10)
    zarr.write_array(kv, "a", a, chunks=[2, 5])
    (tmp_path / "a" / "1.1").unlink()
    got = zarr.read_array(kv, "a")
    want = a.copy()
    want[2:, 5:] = 0
    assert np.array_equal(got, want)
    meta = json.loads(kv.read("a/.zarray"))
    meta["fill_value"] = "NaN"
    kv.write("a/.zarray", json.dumps(meta).encode())
    assert np.isnan(zarr.read_array(kv, "a")[2:, 5:]).all()


def test_kvstores(tmp_path):
    kv = open_kvstore(f"file://{tmp_path}/r")
    kv.write("a/b/c", b"1")
    kv.write("a/d", [b"2", b"3"])
    assert kv.read("a/d") == b"23" and kv.read("nope") is None
    assert kv.list("a/") == ["a/b/c", "a/d"] and kv.list("a/b") == ["a/b/c"]
    assert kv.read_range("a/d", 1, 1) == b"3"
    assert not list((tmp_path / "r").rglob("*.tmp-*"))
    kv.delete_prefix("a/b/")
    assert kv.list() == ["a/d"]
    for scheme in ("gs", "s3", "http"):
        remote = open_kvstore(f"{scheme}://bucket/x")
        for op in (lambda: remote.read("k"), lambda: remote.write("k", b""),
                   lambda: remote.list(), lambda: remote.exists("k")):
            with pytest.raises(NotImplementedError,
                               match=f"{scheme}://.*A18c"):
                op()


def test_committed_tensorstore_store():
    """The store JAX wrote (``tests/make_jax_written_fixtures.py``), read
    bit for bit."""
    root = GOLDEN / "tensorstore_store"
    want = np.load(GOLDEN / "tensorstore_store.npz")
    store = open_store(f"file://{root}")
    names = store.read_json("manifest.json")["arrays"]
    assert sorted(names) == sorted(want.files)
    assert store.list_arrays("") == sorted(names)
    for name in names:
        got = store.load(name)
        if name == "bf16":
            got = got.view(torch.int16).numpy().view(np.uint16)
        assert _same(got, want[name]), name
    assert len(FileKvStore(root).list("u8/")) == 3  # two chunks


# ---------------------------------------------------------------------------
# the caches under file:// roots
# ---------------------------------------------------------------------------


def test_feature_cache_both_ways_under_file_root(tmp_path):
    feats = RNG.standard_normal((10, 6)).astype(np.float16)
    labels = RNG.integers(0, 4, 10).astype(np.int32)
    for writer, reader, name in ((jax_fc, fc, "j"), (fc, jax_fc, "p")):
        uri = f"file://{tmp_path}/{name}"
        writer.write_preprojection_cache(uri, lambda v: (feats + v, labels),
                                         aug_views=2, expected_n=10)
        assert reader.feature_cache_exists(uri, 2)
        views, lab = reader.read_preprojection_cache(uri, 2)
        assert np.array_equal(lab, labels)
        assert np.array_equal(np.asarray(views[1]), feats + 1)
        # the sharded layout
        uri2 = f"file://{tmp_path}/{name}_sharded"
        for k, rows in enumerate((slice(0, 5), slice(5, 10))):
            writer.write_preprojection_cache(
                uri2, lambda v, r=rows: (feats[r], labels[r]), aug_views=1,
                shard_index=k, shard_count=2)
        assert reader.feature_cache_exists_sharded(uri2, 1)
        views2, lab2 = reader.read_preprojection_cache(uri2, 1)
        assert np.array_equal(np.asarray(views2[0]), feats)
        assert np.array_equal(lab2, labels)


def test_runner_fits_prolip_from_jax_file_cache(tmp_path, monkeypatch):
    """JAX's runner writes the ProLIP feature cache under a ``file://`` root;
    the port's runner, on the same root and weights, trains ProLIP from it
    (it encodes nothing): the same cache arrays, the projector within the
    runners' ProLIP parity limit (1e-4), the same grid pick and accuracy."""
    monkeypatch.chdir(tmp_path)
    synth = make_synthetic_cs_dataset(tmp_path / "data", n_train_per_class=4,
                                      n_test_per_class=2, image_size=40)
    b = jax_load("random:Tiny", seed=3)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        b.params)
    zoo = tmp_path / "zoo" / "converted"
    zoo.mkdir(parents=True)
    save_params_npz(zoo / "Tiny.npz", params)
    _save_config(zoo / "Tiny.config.json", b.config)
    d = {
        "root_path": f"file://{tmp_path}/remote", "dataset": "synth",
        "seed": 1, "shots": 0, "subset_l3": [], "clip_backend": "openai",
        "backbone": "Tiny", "clip_cache_dir": str(tmp_path / "zoo"),
        "wandb_project": None, "use_hierarchical_prompts": False,
        "use_descriptive_prompts": False, "remat": False, "method": "ProLIP",
        "train_epoch": 4, "lr_v": 0.001, "lambda_v": 0.1,
        "lambda_funct_1_N": False, "lambda_funct_1_N2": False,
        "search_lr": True, "feat_batch_size": 0, "save_checkpoints": False,
        "save_features": True, "aug_views": 2,
        "finetune": {"enabled": True, "eval_l2": False,
                     "require_cached_features": True},
        "data": {
            "dataset_paths": synth["dataset_paths"],
            "index_file_names": synth["index_file_names"],
            "batch_size": 8, "shuffle": True, "num_workers": 0,
            "decode_prescale": False,
            "data_split": {"valid_split": 0.25, "split_seed": 42},
            "use_l2_label": False,
            "preprocessing": {"resize": 40, "resolution": 32,
                              "augmentations": {"random_crop": False,
                                                "rotation": False}}},
    }
    ref = jax_run(JaxConfig(copy.deepcopy(d)))["prolip"]
    cache = fc.feature_cache_dir(ConfigNode(d))
    assert str(cache).startswith("file://")
    before = {p: p.stat().st_mtime_ns
              for p in (tmp_path / "remote").rglob("*") if p.is_file()}
    dp = copy.deepcopy(d)
    dp["save_features"] = False
    mine = run(ConfigNode(dp), device="cpu")["prolip"]
    after = {p: p.stat().st_mtime_ns
             for p in (tmp_path / "remote").rglob("*") if p.is_file()}
    assert after == before  # read, not rewritten
    vj, lj = jax_fc.read_preprojection_cache(cache, 2)
    vp, lp = fc.read_preprojection_cache(cache, 2)
    assert np.array_equal(lj, lp)
    for a, c in zip(vj, vp):
        assert _same(np.asarray(a), c)
    wj = np.asarray(ref["projector"].weight, np.float64)
    wp = mine["projector"].weight.numpy().astype(np.float64)
    assert np.linalg.norm(wj - wp) / np.linalg.norm(wj) <= 1e-4
    assert (mine["lr"], mine["lambda"]) == (ref["lr"], ref["lambda"])
    assert mine["acc"] == ref["acc"]
