"""PCA and t-SNE on the card: together the counterpart of
``aihab_clip_tpu/tools/feat_vis.py``'s ``reduce_to_2d`` (which leaves the
work to scikit-learn on the host), in ``sklearn/manifold/_t_sne.py``'s
arithmetic for its default ``TSNE(method="barnes_hut", init="pca",
learning_rate="auto")``, with the gradient exact:

  * ``pca`` — the exact eigendecomposition of the fp64 covariance of the
    centred data, each component's largest-magnitude entry made positive
    (scikit-learn's ``svd_flip(u_based_decision=False)``);
  * the affinities P — the k = min(N - 1, floor(3 perplexity + 1)) nearest
    neighbours by squared euclidean distance (a chunked ``topk``, the kept
    distances recomputed exactly), the per-row binary search of the Gaussian
    precision to the perplexity in fp64 (``_binary_search_perplexity``:
    100 steps, tolerance 1e-5 on the entropy), symmetrised and normalised
    as ``_joint_probabilities_nn`` does;
  * the KL gradient — the attractive term over the sparse P, the repulsive
    term over all pairs, in row chunks of ``[chunk, N]``
    (``_kl_divergence_bh`` at ``angle=0``, scaled by 4);
  * the optimiser — ``_gradient_descent``: early exaggeration 12 for 250
    iterations at momentum 0.5, then momentum 0.8 to 1,000 (gains
    and update restarted), gains +0.2 / x0.8 floored at 0.01,
    ``learning_rate = max(N / 12 / 4, 50)``; every 50 iterations the KL and
    the gradient norm reach the host, for ``n_iter_without_progress`` and
    ``min_grad_norm``.

The t-SNE init is the PCA-2 projection scaled to a first-column standard
deviation of 1e-4, as scikit-learn's ``init="pca"``; with it no draw is
random.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .kmeans import fp32_matmuls

MACHINE_EPSILON = float(np.finfo(np.double).eps)
EPSILON_DBL = float(np.float32(1e-8))
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
BINARY_SEARCH_STEPS = 100
N_ITER_CHECK = 50
EXPLORATION_MAX_ITER = 250
EARLY_EXAGGERATION = 12.0
MIN_GAIN = 0.01
MAX_ITER, N_ITER_WITHOUT_PROGRESS, MIN_GRAD_NORM = 1000, 300, 1e-7
CHUNK = 1024              # rows of the [chunk, N] repulsion blocks
KNN_BLOCK = 1 << 23       # elements of one exact-distance block (fp64)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class PCAResult:
    projected: torch.Tensor      # [N, c] fp32
    components: torch.Tensor     # [c, D] fp64, signs flipped


def pca(x: torch.Tensor, n_components: int) -> PCAResult:
    """The exact PCA of x [N, D] on x's device (fp64 covariance, ``eigh``)."""
    xd = x.double()
    mean = xd.mean(0)
    xc = xd - mean
    cov = xc.T @ xc / max(x.shape[0] - 1, 1)
    evals, evecs = torch.linalg.eigh(cov)
    order = torch.argsort(evals, descending=True)[:n_components]
    comps = evecs[:, order].T.contiguous()
    big = comps.abs().argmax(1)
    signs = torch.sign(comps[torch.arange(len(comps), device=x.device), big])
    comps = comps * signs[:, None]
    return PCAResult((xc @ comps.T).float(), comps)


def knn_sqdist(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's k nearest other rows: (squared distances [N, k] fp32,
    indices [N, k]).  Candidates by the fp32 ``||a||^2 + ||b||^2 - 2 a.b``
    form; the kept distances are recomputed from the differences in fp64,
    then taken through fp32 as scikit-learn's euclidean distances are
    (``sqrt`` in fp32, squared in fp32)."""
    n = x.shape[0]
    xf = x.float()
    xx = (xf * xf).sum(1)
    dists, idxs = [], []
    rows_exact = max(1, KNN_BLOCK // max(1, k * x.shape[1]))
    fp32_matmuls()
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        d = xx[s:e, None] + xx[None] - 2.0 * (xf[s:e] @ xf.T)
        d[torch.arange(e - s, device=x.device),
          torch.arange(s, e, device=x.device)] = torch.inf
        idx = torch.topk(d, k, dim=1, largest=False).indices
        del d
        for a in range(s, e, rows_exact):
            b = min(e, a + rows_exact)
            diff = x[a:b, None, :].double() - x[idx[a - s:b - s]].double()
            dist = diff.pow(2).sum(-1).sqrt().float()
            dists.append(dist * dist)
        idxs.append(idx)
    return torch.cat(dists), torch.cat(idxs)


def binary_search_perplexity(sqdist: torch.Tensor, perplexity: float
                             ) -> torch.Tensor:
    """Conditional P [N, k] fp64: every row's Gaussian precision found by
    scikit-learn's binary search, all rows at once."""
    d = sqdist.double()
    n = d.shape[0]
    desired = float(np.log(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -torch.inf)
    hi = torch.full_like(beta, torch.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    out = torch.zeros_like(d)
    for step in range(BINARY_SEARCH_STEPS):
        p = torch.exp(-d * beta[:, None])
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, EPSILON_DBL), s)
        p = p / s[:, None]
        entropy = torch.log(s) + beta * (d * p).sum(1)
        diff = entropy - desired
        out = torch.where(done[:, None], out, p)
        done = done | (diff.abs() <= PERPLEXITY_TOLERANCE)
        up = diff > 0.0
        new_beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0))
        lo = torch.where(done | ~up, lo, beta)
        hi = torch.where(done | up, hi, beta)
        beta = torch.where(done, beta, new_beta)
        if step % 10 == 9 and bool(done.all()):
            break
    return out


@dataclasses.dataclass
class Affinities:
    rows: torch.Tensor     # [nnz] int64, sorted by (row, col)
    cols: torch.Tensor     # [nnz] int64
    values: torch.Tensor   # [nnz] fp64, summing to 1


def joint_probabilities(cond_p: torch.Tensor, idx: torch.Tensor
                        ) -> Affinities:
    """P + P^T over the kNN graph, normalised (``_joint_probabilities_nn``)."""
    n, k = idx.shape
    rows = torch.arange(n, device=idx.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    vals = cond_p.reshape(-1)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat([rows, cols]), torch.cat([cols, rows])]),
        torch.cat([vals, vals]), (n, n), check_invariants=True).coalesce()
    values = coo.values()
    values = values / values.sum().clamp_min(MACHINE_EPSILON)
    ij = coo.indices()
    return Affinities(ij[0], ij[1], values)


def affinities(x: torch.Tensor, perplexity: float) -> Affinities:
    """x [N, D] -> the joint P of scikit-learn's Barnes-Hut t-SNE."""
    n = x.shape[0]
    k = min(n - 1, int(3.0 * perplexity + 1))
    sqdist, idx = knn_sqdist(x, k)
    return joint_probabilities(binary_search_perplexity(sqdist, perplexity),
                               idx)


def kl_gradient(y: torch.Tensor, p: Affinities, p_values32: torch.Tensor,
                compute_error: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(KL(P || Q) as a device scalar or None, its gradient [N, 2]) at the
    embedding y [N, 2] fp32: ``_kl_divergence_bh`` at ``angle=0``."""
    n = y.shape[0]
    yx, yy = y[:, 0].contiguous(), y[:, 1].contiguous()
    neg = torch.empty_like(y)
    sum_q = torch.zeros((), dtype=torch.float64, device=y.device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        dx = y[s:e, 0:1] - yx
        dy = y[s:e, 1:2] - yy
        q = dx * dx
        q.addcmul_(dy, dy).add_(1.0).reciprocal_()
        q[:, s:e].fill_diagonal_(0.0)
        sum_q += q.sum(dtype=torch.float64)
        q.mul_(q)
        neg[s:e, 0] = (q * dx).sum(1)
        neg[s:e, 1] = (q * dy).sum(1)
        del dx, dy, q
    d = y.index_select(0, p.rows) - y.index_select(0, p.cols)
    qij = 1.0 / (1.0 + (d * d).sum(1))
    pos = torch.zeros_like(y).index_add_(0, p.rows,
                                         (p_values32 * qij)[:, None] * d)
    grad = 4.0 * (pos - neg / sum_q.float())
    error = None
    if compute_error:
        qn = (qij.double() / sum_q).float()
        pv = p_values32
        error = (pv * torch.log(pv.clamp_min(FLOAT32_TINY)
                                / qn.clamp_min(FLOAT32_TINY))).sum(
            dtype=torch.float64)
    return error, grad


def _gradient_descent(y, p, p_values32, it, max_iter, momentum,
                      learning_rate, n_iter_without_progress):
    """scikit-learn's ``_gradient_descent``; returns (y, error, i)."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        err, grad = kl_gradient(y, p, p_values32,
                                compute_error=check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min(MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if err is not None:
            error = float(err)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return y, error, i


@dataclasses.dataclass
class TSNEResult:
    embedding: torch.Tensor          # [N, 2] fp32
    init: torch.Tensor               # [N, 2] the scaled PCA-2 start
    kl_divergence: float             # final, as ``TSNE.kl_divergence_``
    kl_exaggerated: float            # after 250 iterations, P x 12
    kl_after_exaggeration: float     # the same embedding against P itself
    n_iter: int
    seconds: Dict[str, float]


def tsne(x: torch.Tensor, perplexity: float = 30.0) -> TSNEResult:
    """A 2-D t-SNE of x [N, D] on x's device (``TSNE(n_components=2,
    perplexity, init="pca", learning_rate="auto")``)."""
    n = x.shape[0]
    if not 0 < perplexity < n:
        raise ValueError(f"perplexity ({perplexity}) must lie in (0, {n})")
    dev = x.device
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    p = affinities(x, perplexity)
    p32 = p.values.float()
    sync(dev)
    seconds["affinities"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    y0 = pca(x, 2).projected
    y0 = y0 / y0[:, 0].std(unbiased=False) * 1e-4
    sync(dev)
    seconds["pca_init"] = time.perf_counter() - t0
    lr = max(n / EARLY_EXAGGERATION / 4, 50.0)
    t0 = time.perf_counter()
    y, kl_x, it = _gradient_descent(
        y0, p, (p.values * EARLY_EXAGGERATION).float(), 0,
        EXPLORATION_MAX_ITER, 0.5, lr, EXPLORATION_MAX_ITER)
    kl_mid = float(kl_gradient(y, p, p32)[0])
    y, kl, it = _gradient_descent(y, p, p32, it + 1, MAX_ITER, 0.8, lr,
                                  N_ITER_WITHOUT_PROGRESS)
    sync(dev)
    seconds["iterations"] = time.perf_counter() - t0
    return TSNEResult(y, y0, kl, kl_x, kl_mid, it, seconds)


def knn_label_agreement(y: torch.Tensor, labels: torch.Tensor,
                        k: int = 10) -> float:
    """The share of each point's k nearest others (euclidean, in y) that
    carry its label, over all points; on y's device."""
    n = y.shape[0]
    yf = y.float()
    hits = torch.zeros((), dtype=torch.float64, device=y.device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        d = torch.cdist(yf[s:e], yf, compute_mode="donot_use_mm_for_euclid_dist")
        d[torch.arange(e - s, device=y.device),
          torch.arange(s, e, device=y.device)] = torch.inf
        idx = torch.topk(d, k, dim=1, largest=False).indices
        hits += (labels[idx] == labels[s:e, None]).sum(dtype=torch.float64)
    return float(hits) / (n * k)
