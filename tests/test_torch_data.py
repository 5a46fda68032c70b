"""The port's host data path against the JAX package, cv2 and scikit-learn:
JPEG/PNG decode (bit for bit against ``cv2.imread``: max|d| 0, tighter
than a bound of 2 levels, since it runs libjpeg's arithmetic), EXIF orientation, the
INTER_LINEAR resize (within 1 of ``cv2.resize``, bit for bit against the
JAX package's native resize), the JPEG encoder (the bytes ``cv2.imwrite``
writes), the CSV index, the stratified-group split (scikit-learn's and
JAX's indices), few-shot selection, ``build_loaders`` on a JAX-written
tree, the decoded-array cache, the DCT-domain prescale and BMPs (ROADMAP
A9), cut JPEGs as JAX's routes decode them, an arithmetic-coded JPEG
(ROADMAP A9c) and the JPEG modes no libjpeg reads."""

import io
import json
import os
import re
import shutil

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image
from sklearn.model_selection import StratifiedGroupKFold as SkSGKF

from aihab_clip_tpu.config import ConfigNode as JaxConfig
from aihab_clip_tpu.data import build_loaders as jax_build_loaders
from aihab_clip_tpu.data import load_folders as jax_load_folders
from aihab_clip_tpu.data import make_synthetic_cs_dataset as jax_make_synthetic
from aihab_clip_tpu.data.bulk_load import _decode_resize as jax_decode_resize
from aihab_clip_tpu.data.index import LabelIndex as JaxLabelIndex
from aihab_clip_tpu.data.splits import few_shot_indices as jax_few_shot
from aihab_clip_tpu.data.splits import selection_by_class as jax_selection
from aihab_clip_tpu.data.splits import stratified_group_split as jax_split
from aihab_clip_tpu.native import native_bulk_decode_resize

from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.data import (LabelIndex, StratifiedGroupKFold,
                                       build_loaders, few_shot_indices,
                                       load_folders, make_synthetic_cs_dataset,
                                       selection_by_class,
                                       stratified_group_split)
from aihab_clip_tpu_torch.data.bulk_load import decode_cache_key
from aihab_clip_tpu_torch.data.decode import (DecodeError, decode_image,
                                              decode_resize, resize_bilinear)
from aihab_clip_tpu_torch.data.encode import encode_jpeg
from aihab_clip_tpu_torch.data.index import _typed_column

RNG = np.random.default_rng(0)


def _photo(h, w, seed=0):
    """A smooth image with noise: edges and flat areas, like a photo."""
    rng = np.random.default_rng(seed)
    x = rng.normal(128, 60, (h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    x = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    x += rng.normal(0, 10, x.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]


SIZES = [(64, 64), (37, 53), (101, 77), (8, 8), (17, 3), (240, 320)]
SAMPLING = {"420": 0x221111, "422": 0x211111, "444": 0x111111, "440": 0x121111}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_decode_equals_cv2(size, sampling):
    """cv2-written JPEGs (quality 95 and 50, with and without restart
    markers) decode to cv2.imread's pixels exactly."""
    img = _photo(*size)
    for quality in (95, 50):
        for rst in (0, 3):
            ok, buf = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            data = buf.tobytes()
            got, ref = decode_image(data), _cv2_rgb(data)
            assert got.shape == ref.shape
            d = np.abs(got.astype(int) - ref.astype(int))
            assert d.max() == 0, (quality, rst, d.max(), d.mean())


def test_gray_and_rgb_jpegs_equal_cv2():
    img = _photo(40, 52)
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    assert np.array_equal(decode_image(buf.tobytes()), _cv2_rgb(buf.tobytes()))
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=90, subsampling=0)
    assert np.array_equal(decode_image(b.getvalue()), _cv2_rgb(b.getvalue()))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P", "1", "LA"])
@pytest.mark.parametrize("level", [0, 9])
def test_png_decode_bit_for_bit(mode, level):
    img = Image.fromarray(_photo(33, 47)).convert(mode)
    b = io.BytesIO()
    img.save(b, "PNG", compress_level=level)
    assert np.array_equal(decode_image(b.getvalue()), _cv2_rgb(b.getvalue()))


def test_png16_and_cv2_png_bit_for_bit():
    img = _photo(21, 30)
    deep = img.astype(np.uint16) * 257 + RNG.integers(0, 256, img.shape,
                                                      dtype=np.uint16)
    for arr in (img, deep):
        ok, buf = cv2.imencode(".png", arr)
        assert np.array_equal(decode_image(buf.tobytes()),
                              _cv2_rgb(buf.tobytes()))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_equals_cv2(orientation):
    pil = Image.fromarray(_photo(30, 50))
    exif = pil.getexif()
    exif[0x0112] = orientation
    b = io.BytesIO()
    pil.save(b, "JPEG", quality=95, exif=exif.tobytes())
    got, ref = decode_image(b.getvalue()), _cv2_rgb(b.getvalue())
    assert got.shape == ref.shape and np.array_equal(got, ref)


RESIZES = [(64, 64, 32), (64, 64, 48), (100, 80, 64), (37, 53, 256),
           (480, 640, 439), (300, 200, 224)]


@pytest.mark.parametrize("h,w,r", RESIZES)
def test_resize_within_one_of_cv2(h, w, r):
    img = RNG.integers(0, 256, (h, w, 3), dtype=np.uint8)
    d = np.abs(resize_bilinear(img, r, r).astype(int)
               - cv2.resize(img, (r, r)).astype(int))
    assert d.max() <= 1


def test_decode_resize_equals_jax_paths(tmp_path):
    """The JAX package's native path (libjpeg + its fixed-point bilinear)
    bit for bit; its cv2 path within one level (cv2's resize)."""
    paths = []
    for i, (h, w) in enumerate([(64, 64), (120, 90), (480, 640)]):
        p = tmp_path / f"{i}.jpg"
        cv2.imwrite(str(p), _photo(h, w, seed=i))
        paths.append(str(p))
    for r in (48, 64, 224):
        native = native_bulk_decode_resize(paths, r, 2, prescale_min=0)
        for i, p in enumerate(paths):
            mine = decode_resize(p, r)
            ref = jax_decode_resize(p, r, "rgb")
            assert np.abs(mine.astype(int) - ref.astype(int)).max() <= 1
            if native is not None:
                assert np.array_equal(mine, native[0][i])
            assert np.array_equal(decode_resize(p, r, "bgr"), mine[:, :, ::-1])


@pytest.mark.parametrize("size", [(64, 64), (37, 53), (8, 8), (17, 3),
                                  (120, 90)])
def test_encoder_writes_cv2_bytes(size):
    """The port's encoder writes the bytes cv2.imwrite writes (quality 95,
    4:2:0, standard tables); cv2 reads them back."""
    img = np.clip(RNG.normal(128, 50, size + (3,)), 0, 255).astype(np.uint8)
    mine = encode_jpeg(img)
    assert mine == cv2.imencode(".jpg", img[:, :, ::-1])[1].tobytes()
    assert encode_jpeg(img[:, :, 0]) == cv2.imencode(
        ".jpg", img[:, :, 0])[1].tobytes()
    back = _cv2_rgb(mine)
    assert back.shape == img.shape and np.abs(back.astype(int) - img).mean() < 40
    assert np.array_equal(decode_image(mine), back)


def test_refusals_name_a9(tmp_path):
    """The DCT-domain prescale and the formats of A9, A9b and A9c decode:
    the prescale equals the JAX native path's bit for bit, a BMP, a
    progressive, a CMYK and an arithmetic-coded JPEG, an Adam7 PNG and an
    RLE8 BMP cv2.imread's.  Lossless and 12-bit JPEGs, which neither JAX's
    native path nor cv2 reads, are no image, their errors naming the
    mode."""
    big = tmp_path / "big.jpg"
    cv2.imwrite(str(big), _photo(256, 256))
    native = native_bulk_decode_resize([str(big)], 64, 1, prescale_min=128)
    assert np.array_equal(decode_resize(str(big), 64, prescale=True),
                          native[0][0])
    # where the native rule keeps the full scale, prescale changes nothing
    assert np.array_equal(decode_resize(str(big), 100, prescale=True),
                          decode_resize(str(big), 100))
    ok, bmp = cv2.imencode(".bmp", _photo(31, 45))
    assert np.array_equal(decode_image(bmp.tobytes()), _cv2_rgb(bmp.tobytes()))
    ok, buf = cv2.imencode(".jpg", _photo(32, 32),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert np.array_equal(decode_image(buf.tobytes()), _cv2_rgb(buf.tobytes()))
    cmyk = io.BytesIO()
    Image.fromarray(_photo(16, 16)).convert("CMYK").save(cmyk, "JPEG")
    assert np.array_equal(decode_image(cmyk.getvalue()),
                          _cv2_rgb(cmyk.getvalue()))
    png = io.BytesIO()
    Image.fromarray(_photo(16, 16)).save(png, "PNG")
    adam7 = bytearray(png.getvalue())
    adam7[28] = 1                       # IHDR's interlace method
    with pytest.raises(DecodeError):    # its data is no Adam7 data
        decode_image(bytes(adam7))
    assert cv2.imdecode(np.frombuffer(bytes(adam7), np.uint8), 1) is None
    rle = bytearray(bmp.tobytes())
    rle[30:34] = (1).to_bytes(4, "little")   # BI_RLE8 at 24 bits
    with pytest.raises(DecodeError):
        decode_image(bytes(rle))
    assert cv2.imdecode(np.frombuffer(bytes(rle), np.uint8), 1) is None
    base = bytearray(encode_jpeg(_photo(16, 16)))
    sof = base.index(b"\xff\xc0")
    arith = bytearray(base)
    arith[sof + 1] = 0xC9
    assert np.array_equal(decode_image(bytes(arith)), _cv2_rgb(bytes(arith)))
    lossless = bytearray(base)
    lossless[sof + 1] = 0xC3
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    for blob, mode in ((lossless, "lossless"), (twelve, "12-bit")):
        with pytest.raises(DecodeError, match=mode):
            decode_image(bytes(blob))
        assert cv2.imdecode(np.frombuffer(bytes(blob), np.uint8), 1) is None
    with pytest.raises(DecodeError):
        decode_image(b"BM" + bytes(60))
    with pytest.raises(DecodeError):
        decode_image(b"not an image")
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0garbage")
    assert decode_resize(str(bad), 32) is None


@pytest.mark.parametrize("keep", [0.3, 0.6, 0.9, 0.999])
def test_truncated_jpeg_refused_as_cv2(tmp_path, keep):
    """A file cut inside its scan, or without its EOI marker, decodes as
    JAX decodes it: JAX's native path keeps it (libjpeg fills the missing
    data), and so does the port's native route, bit for bit; cv2.imread
    keeps it too, with the same pixels as data/decode.py's; only
    cv2.imdecode refuses it, which no JAX route calls on a JPEG that the
    native path takes."""
    data = encode_jpeg(_photo(64, 96))
    cut = data[:int(len(data) * keep)] if keep < 0.999 else data[:-2]
    p = tmp_path / "cut.jpg"
    p.write_bytes(cut)
    native = native_bulk_decode_resize([str(p)], 32, 1, prescale_min=0)
    assert native[1].all()
    assert np.array_equal(decode_resize(str(p), 32, prescale=True),
                          native[0][0])
    assert np.array_equal(decode_image(cut), cv2.imread(str(p))[:, :, ::-1])
    assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) is None
    assert np.array_equal(decode_resize(str(p), 32),
                          resize_bilinear(decode_image(cut), 32, 32))


CSV = (
    "file,BH_PLOT_DESC,BH_POLYDESC,ID\n"
    "A.jpg,Urban,Urban,7\n"
    "b.JPG,Boundary and Linear Features,Arable and Horticulture,8\n"
    "c.jpg,,Urban,9\n"
    "a.jpg,Urban,Urban,10\n"
    "d.jpg,Not a habitat,NA,11\n"
    "e.jpg,Boundary and Linear Features,,12\n"
    "f.jpg,NA,Urban,13\n")


@pytest.mark.parametrize("ids", ["7,8,9,10,11,12,13", "7,,9,10,11,12,13",
                                 "P1,P2,NA,P4,P5,P6,P7", "1.5,2,3,4,5,6,7"])
def test_label_index_equals_jax(tmp_path, ids):
    lines = CSV.strip().split("\n")
    vals = ids.split(",")
    body = [",".join(l.split(",")[:3] + [v]) for l, v in zip(lines[1:], vals)]
    p = tmp_path / "index.csv"
    p.write_text("\n".join([lines[0]] + body) + "\n")
    mine, ref = LabelIndex(p), JaxLabelIndex(p)
    assert len(mine) == len(ref)
    for name in ("a.jpg", "B.jpg", "c.jpg", "d.jpg", "e.jpg", "f.jpg", "x"):
        a, b = mine.lookup(name), ref.lookup(name)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.plot_label, a.plot_word_label, a.poly_label,
                    a.poly_word_label) == (b.plot_label, b.plot_word_label,
                                           b.poly_label, b.poly_word_label)
            assert str(a.plot_id) == str(b.plot_id)


@pytest.mark.parametrize("values", [
    ["1", "2", "3"], ["1", "", "3"], ["x", "NA", "y"], ["1.5", "2"],
    [" 1", "2"], ["True", "false"], ["007", "2"], ["1e3", "2"], ["", ""],
    ["a", "1"], ["-4", "+5"], ["inf", "1"]])
def test_csv_column_typing_equals_pandas(values):
    ref = pd.read_csv(io.StringIO("c\n" + "\n".join(values) + "\n"),
                      skip_blank_lines=False)["c"].tolist()
    mine = _typed_column(values)
    assert [str(v) for v in mine] == [str(v) for v in ref]


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       val_ratio=st.sampled_from([0.1, 0.2, 0.25, 0.34, 0.5]),
       n_groups=st.integers(6, 30), n_classes=st.integers(2, 6),
       layout_seed=st.integers(0, 1000))
def test_split_equals_sklearn_and_jax(seed, val_ratio, n_groups, n_classes,
                                      layout_seed):
    rng = np.random.default_rng(layout_seed)
    sizes = rng.integers(1, 6, n_groups)
    groups = np.repeat([f"G{i:03d}" for i in range(n_groups)], sizes)
    labels = rng.integers(0, n_classes, len(groups))
    n_splits = max(2, int(round(1.0 / val_ratio)))
    try:
        ref = jax_split(labels, groups, val_ratio, seed)
    except ValueError as exc:   # too few groups or members: the same refusal
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            stratified_group_split(labels, groups, val_ratio, seed)
        return
    mine = stratified_group_split(labels, groups, val_ratio, seed)
    assert all(np.array_equal(a, b) for a, b in zip(mine, ref))
    folds = list(StratifiedGroupKFold(n_splits, shuffle=True,
                                      random_state=seed).split(labels, labels,
                                                               groups))
    sk = list(SkSGKF(n_splits, shuffle=True, random_state=seed).split(
        labels, labels, groups))
    for (a_tr, a_te), (b_tr, b_te) in zip(folds, sk):
        assert np.array_equal(a_tr, b_tr) and np.array_equal(a_te, b_te)


def test_split_refusals_equal_sklearn():
    labels = np.array([0, 1, 0, 1])
    groups = np.array(["a", "b", "c", "d"])
    with pytest.raises(ValueError):
        stratified_group_split(labels, groups, 0.1, 0)
    with pytest.raises(ValueError):
        StratifiedGroupKFold(3, shuffle=False, random_state=1)
    train, val = stratified_group_split(labels, groups, 0.0, 0)
    assert len(train) == 4 and len(val) == 0


@pytest.mark.parametrize("shots", [1, 3, 8])
def test_few_shot_equals_jax(shots):
    labels = RNG.integers(0, 5, 40)
    mine = few_shot_indices(labels, shots, np.random.RandomState(7))
    ref = jax_few_shot(labels, shots, np.random.RandomState(7))
    assert np.array_equal(mine, ref)
    assert selection_by_class(mine, labels) == jax_selection(ref, labels)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_tree")
    return jax_make_synthetic(root, n_train_per_class=5, n_test_per_class=3,
                              image_size=48)


def test_synthetic_tree_equals_jax(jax_tree, tmp_path):
    mine = make_synthetic_cs_dataset(tmp_path, n_train_per_class=5,
                                     n_test_per_class=3, image_size=48)
    for split in ("train_dir", "test_dir"):
        files = sorted(os.listdir(jax_tree[split]))
        assert files == sorted(os.listdir(mine[split]))
        for f in files:
            with open(os.path.join(jax_tree[split], f), "rb") as a, \
                    open(os.path.join(mine[split], f), "rb") as b:
                assert a.read() == b.read(), f


def _data_cfg(tree, **kw):
    d = {"seed": 1, "shots": 0, "subset_l3": [],
         "data": {"dataset_paths": tree["dataset_paths"],
                  "index_file_names": tree["index_file_names"],
                  "batch_size": 8, "shuffle": True, "num_workers": 0,
                  "decode_prescale": False,
                  "data_split": {"valid_split": 0.25, "split_seed": 42},
                  "use_l2_label": False,
                  "preprocessing": {"resize": 40, "resolution": 32}}}
    d.update(kw)
    return d


@pytest.mark.parametrize("kw", [{}, {"shots": 2}, {"subset_l3": [
    "Urban", "Sea"]}], ids=["full", "shots", "subset"])
def test_build_loaders_equals_jax(jax_tree, kw):
    d = _data_cfg(jax_tree, **kw)
    mine = build_loaders(ConfigNode(d), device="cpu")
    ref = jax_build_loaders(JaxConfig(d))
    for split in ("train", "val", "test"):
        a, b = getattr(mine, split), getattr(ref, split)
        assert np.array_equal(a.indices, b.indices)
        assert np.array_equal(a.labels, b.labels)
        ba, bb = list(a.batches(epoch=1)), list(b.batches(epoch=1))
        assert [x.indices.tolist() for x in ba] == [x.indices.tolist()
                                                    for x in bb]
    for ds in ("train_dataset", "test_dataset"):
        a, b = getattr(mine, ds), getattr(ref, ds)
        assert a.file_names == b.file_names and a.plot_idx == b.plot_idx
        assert np.array_equal(a.l2_labels, b.l2_labels)
        # JAX's native decode is libjpeg with the same fixed-point resize
        d_img = np.abs(a.images.astype(int) - b.images.astype(int))
        assert d_img.max() <= 1 and d_img.mean() <= 0.25
    assert mine.info == ref.info


def test_decode_cache_round_trip_and_key(jax_tree, tmp_path):
    paths, names = jax_tree["dataset_paths"], jax_tree["index_file_names"]
    cache = tmp_path / "cache"
    jax_ds = jax_load_folders(paths, names, 40, cache_dir=str(cache),
                              prescale=False)
    jax_dirs = set(os.listdir(cache))
    first = load_folders(paths, names, 40, cache_dir=str(cache),
                         device="cpu")
    port_dirs = set(os.listdir(cache)) - jax_dirs
    assert len(port_dirs) == 1      # never read the JAX package's cache
    key = decode_cache_key(paths, names, 40, "rgb")
    assert port_dirs == {f"bulk_{key}"}
    meta = json.loads((cache / f"bulk_{key}" / "meta.json").read_text())
    assert meta["decode_rule"].startswith("aihab_clip_tpu_torch.decode/")
    # the second load reads the cache: same arrays, memory-mapped
    second = load_folders(paths, names, 40, cache_dir=str(cache),
                          device="cpu")
    assert isinstance(second.images, np.memmap)
    assert np.array_equal(first.images, second.images)
    assert first.file_names == second.file_names == jax_ds.file_names
    assert key != decode_cache_key(paths, names, 40, "bgr")
    shutil.rmtree(cache)


def test_loaders_decode_on_the_card_by_default(jax_tree, monkeypatch):
    """build_loaders and load_folders default to the card, as every entry
    point of the package does: without one they raise, naming
    device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_loaders(ConfigNode(_data_cfg(jax_tree)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_folders(jax_tree["dataset_paths"], jax_tree["index_file_names"],
                     40)


@pytest.fixture(scope="module")
def large_tree(tmp_path_factory):
    """Photos of 200 px, which the prescale for a resize of 40 decodes at
    m = 4."""
    root = tmp_path_factory.mktemp("large_tree")
    return jax_make_synthetic(root, n_train_per_class=1, n_test_per_class=1,
                              image_size=200)


def test_prescale_routes_match_jax_loader(large_tree):
    """With the prescale on, the RGB route equals JAX's native prescaled
    loader bit for bit, and the BGR route decodes at full scale as JAX's
    cv2 route does (within one level of cv2.resize)."""
    paths, names = large_tree["dataset_paths"], large_tree["index_file_names"]
    mine, ref = {}, {}
    for order in ("rgb", "bgr"):
        mine[order] = load_folders(paths, names, 40, order, prescale=True,
                                   device="cpu")
        ref[order] = jax_load_folders(paths, names, 40, order, prescale=True)
        assert mine[order].file_names == ref[order].file_names
    assert np.array_equal(mine["rgb"].images, ref["rgb"].images)
    assert np.abs(mine["bgr"].images.astype(int)
                  - ref["bgr"].images.astype(int)).max() <= 1
    full = load_folders(paths, names, 40, "rgb", device="cpu")
    assert np.array_equal(mine["bgr"].images[..., ::-1], full.images)
    assert not np.array_equal(mine["rgb"].images, full.images)


def test_loader_names_an_unsupported_file(jax_tree, tmp_path):
    """A labelled photo that only arithmetic coding sets apart (A9c, which
    JAX's native path decodes) loads as JAX's loader loads it: the same
    files, the same pixels bit for bit."""
    src = jax_tree["dataset_paths"][0]
    folder = tmp_path / os.path.basename(src)
    shutil.copytree(src, folder)
    name = jax_tree["index_file_names"][0]
    victim = load_folders([str(folder)], [name], 40,
                          device="cpu").file_names[1]
    arith = bytearray(encode_jpeg(_photo(48, 48)))
    arith[arith.index(b"\xff\xc0") + 1] = 0xC9
    (folder / victim).write_bytes(bytes(arith))
    assert native_bulk_decode_resize([str(folder / victim)], 40, 1)[1].all()
    mine = load_folders([str(folder)], [name], 40, device="cpu")
    ref = jax_load_folders([str(folder)], [name], 40)
    assert mine.file_names == ref.file_names and victim in mine.file_names
    assert np.array_equal(mine.images, ref.images)