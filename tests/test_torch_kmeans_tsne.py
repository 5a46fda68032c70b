"""The port's k-means (``ops/kmeans.py``) and PCA / t-SNE (``ops/tsne.py``)
against scikit-learn, which the JAX package's tools call
(``aihab_clip_tpu/tools/outlier_cleaning.py``, ``feat_vis.py``): k-means
from the same initial centres as ``KMeans(init=..., n_init=1)`` (centres
within 1e-5, equal labels), empty clusters relocated, the best of the
batched runs; PCA within 1e-4 of ``PCA(svd_solver="full")`` with its signs;
the t-SNE init within 1e-3 of scikit-learn's; P within 1e-6 of
``_joint_probabilities_nn``; one gradient within 1e-5 of
``_kl_divergence_bh(angle=0)``; and end to end at N = 600 against JAX's
``reduce_to_2d``: trustworthiness, 1-NN agreement and the KL."""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from sklearn.cluster import KMeans
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE, trustworthiness
from sklearn.manifold._t_sne import (_joint_probabilities_nn,
                                     _kl_divergence_bh)
from sklearn.manifold._utils import _binary_search_perplexity
from sklearn.neighbors import NearestNeighbors
from threadpoolctl import threadpool_limits

from aihab_clip_tpu.tools.feat_vis import reduce_to_2d as jax_reduce_to_2d

from aihab_clip_tpu_torch.ops import kmeans as K
from aihab_clip_tpu_torch.ops import tsne as T

PERPLEXITY = 30.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread and one OpenMP/BLAS thread (scikit-learn's t-SNE and
    k-means): the suite runs several workers at once, and the many small
    steps of t-SNE and k-means spin when their thread pools oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)


def _clusters(rng, n, d, k, spread=0.6, normalize=True):
    protos = rng.standard_normal((k, d))
    lab = rng.integers(0, k, n)
    x = protos[lab] + spread * rng.standard_normal((n, d))
    if normalize:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), lab


@pytest.mark.parametrize("n,d,k", [(15, 8, 2), (40, 16, 2), (60, 32, 3),
                                   (150, 64, 4), (250, 128, 5),
                                   (400, 512, 6)])
def test_kmeans_matches_sklearn_from_the_same_init(n, d, k):
    x, _ = _clusters(np.random.default_rng(n), n, d, k + 2)
    res = K.kmeans(torch.from_numpy(x), k, n_init=10,
                   generator=torch.Generator().manual_seed(0))
    assert res.init.shape == (10, k, d)
    for run in (0, 5):
        init = res.init[run].numpy()
        ref = KMeans(n_clusters=k, init=init, n_init=1, max_iter=100).fit(x)
        got = K.kmeans(torch.from_numpy(x), k, init=torch.from_numpy(init))
        np.testing.assert_allclose(got.centers.numpy(), ref.cluster_centers_,
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.labels.numpy(), ref.labels_)
        assert got.n_iter == ref.n_iter_
        assert got.inertia == pytest.approx(ref.inertia_, rel=1e-5)


def test_kmeans_plusplus_and_the_best_run():
    x, _ = _clusters(np.random.default_rng(1), 300, 32, 8)
    xt = torch.from_numpy(x)
    res = K.kmeans(xt, 6, n_init=10,
                   generator=torch.Generator().manual_seed(3))
    # every initial centre is a distinct data point (up to the centring's
    # rounding)
    for run in res.init:
        d = torch.cdist(run, xt, compute_mode="donot_use_mm_for_euclid_dist")
        assert float(d.min(1).values.max()) <= 1e-6
        assert len(set(d.argmin(1).tolist())) == 6
    # the result is the first run of least inertia
    best = int(torch.argmin(res.inertias))
    assert res.inertia == pytest.approx(float(res.inertias[best]))
    again = K.kmeans(xt, 6, n_init=10,
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.centers, res.centers)
    # sklearn's own k-means++ reaches an inertia within 1% of it
    ref = KMeans(n_clusters=6, random_state=0, n_init=10, max_iter=100).fit(x)
    assert res.inertia <= ref.inertia_ * 1.01


def test_kmeans_relocates_an_empty_cluster_as_sklearn():
    x, _ = _clusters(np.random.default_rng(2), 80, 16, 3)
    init = x[[0, 1, 2]].copy()
    init[2] = 50.0                      # no point is closest: empty at first
    ref = KMeans(n_clusters=3, init=init, n_init=1, max_iter=100).fit(x)
    got = K.kmeans(torch.from_numpy(x), 3, init=torch.from_numpy(init))
    np.testing.assert_allclose(got.centers.numpy(), ref.cluster_centers_,
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.labels.numpy(), ref.labels_)


def test_kmeans_refusals():
    with pytest.raises(ValueError, match="n_clusters"):
        K.kmeans(torch.zeros(3, 2), 4)
    with pytest.raises(TypeError):
        K.kmeans(torch.zeros(3, 2, dtype=torch.int64), 2)


@pytest.mark.parametrize("dim", [2, 10, 50])
def test_pca_matches_sklearn_full(dim):
    """Against scikit-learn's fp32 SVD on the fp32 data (the leading 10
    components; the trailing noise components lie within ~1e-3 of each
    other's variance, where an fp32 SVD mixes them) and its fp64 SVD on the
    same data as fp64 (all)."""
    x, _ = _clusters(np.random.default_rng(dim), 600, 128, 20, 0.7, False)
    got = T.pca(torch.from_numpy(x), dim)
    for data, lead in ((x, min(dim, 10)), (x.astype(np.float64), dim)):
        ref = PCA(n_components=dim, svd_solver="full").fit(data)
        proj = ref.transform(data)[:, :lead]
        err = (np.abs(got.projected.numpy()[:, :lead] - proj).max(0)
               / np.abs(proj).max(0))
        assert err.max() <= 1e-4, err
        np.testing.assert_array_equal(np.sign(got.components.numpy()[:lead]),
                                      np.sign(ref.components_[:lead]))


@pytest.fixture(scope="module")
def draw():
    """N = 600 points of 20 classes in 64 dimensions."""
    x, lab = _clusters(np.random.default_rng(0), 600, 64, 20, 0.7, False)
    return x, lab


def test_tsne_init_matches_sklearn(draw):
    x, _ = draw
    y = T.pca(torch.from_numpy(x), 2).projected
    got = (y / y[:, 0].std(unbiased=False) * 1e-4).numpy()
    # scikit-learn's TSNE init (its randomized PCA) and the exact one
    for solver, tol in (("auto", 1e-3), ("full", 1e-5)):
        ref = PCA(n_components=2, svd_solver=solver,
                  random_state=42).fit_transform(x).astype(np.float32)
        ref = ref / np.std(ref[:, 0]) * 1e-4
        assert np.abs(got - ref).max() / np.abs(ref).max() <= tol, solver


def _sklearn_p(x):
    k = min(len(x) - 1, int(3 * PERPLEXITY + 1))
    dist = NearestNeighbors(n_neighbors=k).fit(x).kneighbors_graph(
        mode="distance")
    dist.data **= 2
    return dist, _joint_probabilities_nn(dist, PERPLEXITY, 0)


def test_affinities_match_sklearn(draw):
    x, _ = draw
    dist, ref = _sklearn_p(x)
    p = T.affinities(torch.from_numpy(x), PERPLEXITY)
    got = csr_matrix((p.values.numpy(), (p.rows.numpy(), p.cols.numpy())),
                     shape=ref.shape)
    assert got.nnz == ref.nnz
    assert abs(got - ref).max() <= 1e-6
    assert abs(got - ref).max() / ref.max() <= 1e-4
    assert p.values.sum().item() == pytest.approx(1.0, abs=1e-12)
    # the binary search alone, on scikit-learn's own distances: rows equal
    # but for one whose entropy sits at the tolerance, where an exp one ulp
    # apart takes one more step
    dist.sort_indices()
    d = dist.data.reshape(len(x), -1).astype(np.float32)
    cond = T.binary_search_perplexity(torch.from_numpy(d), PERPLEXITY)
    diff = np.abs(cond.numpy() - _binary_search_perplexity(d, PERPLEXITY, 0))
    assert (diff.max(1) > 1e-9).sum() <= 1
    assert diff.max() <= 1e-5


def test_kl_gradient_matches_exact_barnes_hut(draw):
    x, _ = draw
    _, ref_p = _sklearn_p(x)
    p = T.affinities(torch.from_numpy(x), PERPLEXITY)
    y = np.random.default_rng(1).standard_normal((len(x), 2)).astype(
        np.float32) * 5
    err_ref, grad_ref = _kl_divergence_bh(y.ravel().copy(), ref_p, 1, len(x),
                                          2, angle=0.0)
    err, grad = T.kl_gradient(torch.from_numpy(y), p, p.values.float())
    grad = grad.numpy().ravel()
    assert np.linalg.norm(grad - grad_ref) / np.linalg.norm(grad_ref) <= 1e-5
    assert float(err) == pytest.approx(err_ref, rel=1e-4)


def _nn_agreement(y, lab, k=1):
    d = ((y[:, None] - y[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, 1)[:, :k]
    return float((lab[idx] == lab[:, None]).mean())


@pytest.fixture(scope="module")
def runs(draw):
    x, _ = draw
    port = T.tsne(torch.from_numpy(x), PERPLEXITY)
    jax_coords, method = jax_reduce_to_2d(x, "tsne", perplexity=PERPLEXITY)
    assert method == "tsne"
    sk = TSNE(n_components=2, perplexity=PERPLEXITY, random_state=42,
              init="pca")
    sk_coords = sk.fit_transform(x)
    np.testing.assert_array_equal(sk_coords, jax_coords)
    return port, jax_coords, sk.kl_divergence_


def test_tsne_end_to_end_against_jax(draw, runs):
    x, lab = draw
    port, jax_coords, sk_kl = runs
    y = port.embedding.numpy()
    assert y.shape == (600, 2) and np.isfinite(y).all()
    assert port.n_iter == 999
    tw, tw_ref = (trustworthiness(x, c, n_neighbors=10)
                  for c in (y, jax_coords))
    assert tw >= tw_ref - 0.02, (tw, tw_ref)
    assert abs(_nn_agreement(y, lab) - _nn_agreement(jax_coords, lab)) \
        <= 0.03
    assert port.kl_divergence == pytest.approx(sk_kl, rel=0.10)
    assert port.kl_divergence < port.kl_after_exaggeration


def test_knn_label_agreement(draw, runs):
    _, lab = draw
    port = runs[0]
    for y in (port.embedding, port.init):
        got = T.knn_label_agreement(y, torch.from_numpy(lab), k=10)
        assert got == pytest.approx(_nn_agreement(y.numpy(), lab, k=10))
    assert T.knn_label_agreement(port.embedding, torch.from_numpy(lab)) \
        >= T.knn_label_agreement(port.init, torch.from_numpy(lab))
