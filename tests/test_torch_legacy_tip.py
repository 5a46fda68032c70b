"""The port's legacy loaders (``data/legacy.py``), its stratified
``train_test_split`` (``data/splits.py``) and Tip-Adapter
(``train/tip_adapter.py``) against the JAX package's
(``aihab_clip_tpu/data/legacy.py``, ``train/tip_adapter.py``) and
scikit-learn: the splits index for index, the loaders' views, Tip-Adapter's
cache, logits and grid search at 1e-5, the helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_train_test_split

from aihab_clip_tpu.data import make_synthetic_cs_dataset
from aihab_clip_tpu.data import legacy as jax_legacy
from aihab_clip_tpu.train import tip_adapter as jax_tip

from aihab_clip_tpu_torch.cache import write_preprojection_cache
from aihab_clip_tpu_torch.data import legacy
from aihab_clip_tpu_torch.data.splits import train_test_split
from aihab_clip_tpu_torch.train import tip_adapter as tip


@pytest.fixture(scope="module")
def synth_args(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy")
    synth = make_synthetic_cs_dataset(root, n_train_per_class=6,
                                      n_test_per_class=2, image_size=40)
    return {
        "dataset_paths": synth["dataset_paths"],
        "index_file_names": synth["index_file_names"],
        "batch_size": 8, "shuffle": True,
        "preprocessing": {"resize": 32},
        "data_split": {"valid_split": 0.25, "split_seed": 42,
                       "if_grouped": True, "num_fold": 3,
                       "first_cv_only": False},
    }


def test_legacy_crop_size():
    for preproc in ({"resize": 439, "augmentations": {"crop": "ratio"}},
                    {"augmentations": {"crop": 224}}, {"resize": 256}):
        assert legacy.legacy_crop_size(preproc) == \
            jax_legacy.legacy_crop_size(preproc)
    with pytest.raises(ValueError, match="crop_size"):
        legacy.legacy_crop_size({"augmentations": {"crop": 1.5}})


@pytest.mark.parametrize("grouped", [True, False])
def test_data_partition_matches_jax(synth_args, grouped):
    """Grouped K-fold (3 folds) and the stratified split, index for index,
    over the same decoded arrays."""
    args = {**synth_args, "data_split": dict(synth_args["data_split"],
                                             if_grouped=grouped)}
    ds, tr, va = legacy.data_partition(args, device="cpu")
    jds, jtr, jva = jax_legacy.data_partition(args)
    assert np.array_equal(ds.images, jds.images)
    assert np.array_equal(ds.labels, jds.labels)
    assert len(tr) == len(jtr) == (3 if grouped else 1)
    for a, b in zip(tr + va, jtr + jva):
        assert np.array_equal(a, b)
    for a, b in zip(tr, va):
        assert len(a) + len(b) == len(ds) and set(a).isdisjoint(b)


def test_loaders_match_jax(synth_args):
    pairs = legacy.cross_valid_loaders(synth_args, device="cpu")
    jpairs = jax_legacy.cross_valid_loaders(synth_args)
    assert len(pairs) == len(jpairs) == 3
    for (tr, va), (jtr, jva) in zip(pairs, jpairs):
        assert np.array_equal(tr.indices, jtr.indices) and tr.shuffle
        assert np.array_equal(va.indices, jva.indices) and not va.shuffle
        assert tr.num_samples + va.num_samples == 24
    tr, va = legacy.train_valid_loaders(synth_args, device="cpu")
    jtr, jva = jax_legacy.train_valid_loaders(synth_args)
    assert np.array_equal(tr.indices, jtr.indices)
    assert np.array_equal(va.indices, jva.indices)
    assert va.num_samples == 6    # 25% of 24
    b, jb = next(tr.batches()), next(jtr.batches())
    assert b.images.shape[1:] == (32, 32, 3)
    assert np.array_equal(b.images, jb.images)


@pytest.mark.parametrize("seed", range(6))
def test_train_test_split_matches_sklearn(seed):
    """The stratified split against scikit-learn's at fractions and counts,
    with ties in the class shares (broken by the seed's RandomState)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 200))
    y = rng.integers(0, int(rng.integers(2, 7)), n)
    y[:12] = np.arange(12) % 2      # every class has two members or more
    y = np.where(np.bincount(y)[y] < 2, 0, y)
    for test_size in (0.25, 0.1, 0.5, 9):
        want = sk_train_test_split(np.arange(n), test_size=test_size,
                                   stratify=y, random_state=seed)
        got = train_test_split(np.arange(n), test_size=test_size,
                               stratify=y, random_state=seed)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="stratify"):
        train_test_split(np.arange(n), test_size=0.25)
    with pytest.raises(ValueError, match="test_size"):
        train_test_split(np.arange(n), test_size=1.5, stratify=y)


def _tip_data(seed, c=4, d=16, n=40, b=30):
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((c, d)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
    labels = rng.integers(0, c, n)
    feats = protos[labels] + 0.3 * rng.standard_normal((n, d)).astype(
        np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    qlab = rng.integers(0, c, b)
    query = protos[qlab] + 0.5 * rng.standard_normal((b, d)).astype(
        np.float32)
    query /= np.linalg.norm(query, axis=-1, keepdims=True)
    views = [feats + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
             for _ in range(3)]
    return protos, labels, views, query, qlab


def test_tip_adapter_matches_jax():
    """The cache model (keys, values), the logits at two (beta, alpha) and
    the grid search's pick and accuracy, at 1e-5."""
    protos, labels, views, query, qlab = _tip_data(0)
    keys, values = tip.build_cache_model(lambda v: (views[v], labels), 3, 4,
                                         device="cpu")
    jkeys, jvalues = jax_tip.build_cache_model(lambda v: (views[v], labels),
                                               3, 4)
    np.testing.assert_allclose(keys.numpy(), np.asarray(jkeys), atol=1e-6)
    np.testing.assert_array_equal(values.numpy(), np.asarray(jvalues))
    w, q = torch.from_numpy(protos.T.copy()), torch.from_numpy(query)
    for beta, alpha in ((1.0, 1.0), (5.5, 0.3)):
        got = tip.tip_logits(q, keys, values, w, beta, alpha).numpy()
        ref = np.asarray(jax_tip.tip_logits(jnp.asarray(query), jkeys,
                                            jvalues, jnp.asarray(protos.T),
                                            beta, alpha))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    for step in ((5, 5), (40, 10)):
        got = tip.search_hp_tip(q, qlab, keys, values, w, search_step=step)
        ref = jax_tip.search_hp_tip(jnp.asarray(query), qlab, jkeys, jvalues,
                                    jnp.asarray(protos.T), search_step=step)
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_tip_cache_from_the_feature_cache(tmp_path):
    """The cache model read from the port's pre-projection feature cache
    (fp16 views) equals the one built on the same fp16 arrays."""
    _, labels, views, _, _ = _tip_data(1)
    write_preprojection_cache(tmp_path, lambda v: (views[v], labels), 3)
    keys, values = tip.cache_from_feature_cache(tmp_path, 3, 4,
                                                device="cpu")
    want = tip.build_cache_model(
        lambda v: (views[v].astype(np.float16), labels), 3, 4, device="cpu")
    assert torch.equal(keys, want[0]) and torch.equal(values, want[1])


def test_centroids_interval_and_probe_cache(tmp_path):
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((12, 8)).astype(np.float32)
    labels = np.repeat(np.arange(3), 4)
    for fn in ("compute_centroids", "compute_mean_centroids"):
        got = getattr(tip, fn)(torch.from_numpy(feats),
                               torch.from_numpy(labels), 4).numpy()
        ref = np.asarray(getattr(jax_tip, fn)(jnp.asarray(feats),
                                              jnp.asarray(labels), 4))
        np.testing.assert_allclose(got, ref, atol=1e-6)
    data = rng.random(7)
    np.testing.assert_allclose(tip.compute_confidence_interval(data),
                               jax_tip.compute_confidence_interval(data))
    f1, l1 = tip.pre_load_features(
        tmp_path, "val", encode_split=lambda: (torch.from_numpy(feats),
                                               labels), load_cached=False)
    f2, l2 = jax_tip.pre_load_features(tmp_path, "val")   # JAX reads it
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(l1, l2)
    with pytest.raises(FileNotFoundError):
        tip.pre_load_features(tmp_path, "test")


def test_tip_cache_defaults_to_the_card():
    """Without ``device`` the cache model is placed on the card; with no
    card present that raises instead of building it on the host."""
    _, labels, views, _, _ = _tip_data(0)
    if torch.cuda.is_available():
        keys, values = tip.build_cache_model(lambda v: (views[v], labels), 3,
                                             4)
        assert keys.is_cuda and values.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tip.build_cache_model(lambda v: (views[v], labels), 3, 4)
