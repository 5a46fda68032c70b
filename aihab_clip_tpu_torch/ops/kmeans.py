"""k-means on the card: the counterpart of ``sklearn.cluster.KMeans(
n_clusters, random_state, n_init, max_iter)`` as
``aihab_clip_tpu/tools/outlier_cleaning.py`` calls it, in
``sklearn/cluster/_kmeans.py``'s arithmetic (Lloyd, dense input):

  * the data are centred on their mean first and the mean added back to the
    centres at the end; ``tol`` is scaled by the mean per-feature variance;
  * greedy k-means++ initialisation with ``2 + floor(ln k)`` local trials;
  * Lloyd iterations in fp32 (TF32 off): labels by ``argmin ||c||^2 -
    2 x.c`` (the first centre on ties), centres by per-cluster sums, an
    empty cluster relocated to the point farthest from its centre; a run
    stops when its labels repeat (strict convergence) or its squared centre
    shift sums to ``<= tol``; a run stopped otherwise reassigns its labels
    to its final centres;
  * of the ``n_init`` runs the first one with the least inertia, unless a
    later run with less inertia is the same clustering up to a permutation.

The ``n_init`` runs go as one batched tensor ``[n_init, k, D]``.  The
random draws (the first centre, the trial points) come from a CPU
``torch.Generator`` and are moved to the data's device, so a run from the
same seed draws the same numbers on the card and on the CPU; the stream is
not numpy's, so the centres are not scikit-learn's for the same seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


TOL = 1e-4   # KMeans' default, relative to the mean per-feature variance


def fp32_matmuls() -> None:
    """fp32 matmuls on the card (TF32 off), as the port's other fp32 paths
    set them."""
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass
class KMeansResult:
    centers: torch.Tensor        # [k, D] of the best run
    labels: torch.Tensor         # [n] int64
    inertia: float
    n_iter: int
    init: torch.Tensor           # [n_init, k, D] every run's initial centres
    inertias: torch.Tensor       # [n_init] fp32


def _sq_dist_to(x: torch.Tensor, xx: torch.Tensor,
                pts: torch.Tensor) -> torch.Tensor:
    """||pts - x||^2 for pts [R, T, D] against x [n, D] -> [R, T, n]."""
    pp = (pts * pts).sum(-1, keepdim=True)
    return (pp + xx - 2.0 * torch.matmul(pts, x.T)).clamp_min(0.0)


def kmeans_plusplus(x: torch.Tensor, n_clusters: int, n_runs: int,
                    generator: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ (scikit-learn's ``_kmeans_plusplus``) for ``n_runs``
    runs at once: x [n, D] -> initial centres [n_runs, k, D]."""
    n = x.shape[0]
    dev = x.device
    trials = 2 + int(math.log(n_clusters))
    first = torch.randint(n, (n_runs,), generator=generator).to(dev)
    u = torch.rand(n_runs, max(n_clusters - 1, 1), trials,
                   generator=generator, dtype=torch.float64).to(dev)
    xx = (x * x).sum(-1)
    idx = torch.empty(n_runs, n_clusters, dtype=torch.long, device=dev)
    idx[:, 0] = first
    closest = _sq_dist_to(x, xx, x[first][:, None])[:, 0]          # [R, n]
    pot = closest.double().sum(-1)                                  # [R]
    runs = torch.arange(n_runs, device=dev)
    for c in range(1, n_clusters):
        cum = torch.cumsum(closest.double(), -1)
        cand = torch.searchsorted(cum, u[:, c - 1] * pot[:, None])
        cand = cand.clamp_max(n - 1)                                # [R, T]
        d = torch.minimum(closest[:, None], _sq_dist_to(x, xx, x[cand]))
        cand_pot = d.double().sum(-1)                               # [R, T]
        best = cand_pot.argmin(-1)
        pot = cand_pot[runs, best]
        closest = d[runs, best]
        idx[:, c] = cand[runs, best]
    return x[idx]


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Labels [R, n]: argmin_j ||c_j||^2 - 2 x.c_j (the first on ties)."""
    cc = (centers * centers).sum(-1)                                # [R, k]
    d = cc[:, None, :] - 2.0 * torch.matmul(x, centers.transpose(1, 2))
    return d.argmin(-1)


def _update(x: torch.Tensor, labels: torch.Tensor, centers_old: torch.Tensor
            ) -> torch.Tensor:
    """One M-step for every run, empty clusters relocated as scikit-learn's
    ``_relocate_empty_clusters_dense`` does."""
    r, k, dim = centers_old.shape
    flat = (labels + torch.arange(r, device=x.device)[:, None] * k).reshape(-1)
    sums = torch.zeros(r * k, dim, dtype=x.dtype, device=x.device)
    sums.index_add_(0, flat, x.repeat(r, 1))
    sums = sums.reshape(r, k, dim)
    counts = torch.bincount(flat, minlength=r * k).reshape(r, k).to(x.dtype)
    empty = counts == 0
    if bool(empty.any()):
        for run in torch.nonzero(empty.any(-1)).flatten().tolist():
            lab = labels[run]
            dist = ((x - centers_old[run][lab]) ** 2).sum(-1)
            if float(dist.max()) == 0.0:
                continue
            ids = torch.nonzero(empty[run]).flatten().tolist()
            far = torch.topk(dist, len(ids)).indices.tolist()
            for new_id, f in zip(ids, far):
                old_id = int(lab[f])
                sums[run, old_id] -= x[f]
                sums[run, new_id] = x[f]
                counts[run, new_id] = 1.0
                counts[run, old_id] -= 1.0
    heaviest = counts.argmax(-1)                                    # [R]
    avg = sums / counts.clamp_min(1.0)[..., None]
    fallback = avg[torch.arange(r, device=x.device), heaviest][:, None]
    return torch.where((counts > 0)[..., None], avg, fallback)


def _inertia(x: torch.Tensor, centers: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Sum of squared distances to the assigned centre, per run [R]."""
    return torch.stack([((x - c[lab]) ** 2).sum()
                        for c, lab in zip(centers, labels)])


def _same_clustering(a: torch.Tensor, b: torch.Tensor, k: int) -> bool:
    """Labels equal up to a permutation of the cluster ids."""
    table = torch.bincount(a * k + b, minlength=k * k).reshape(k, k) > 0
    return bool((table.sum(0) <= 1).all() and (table.sum(1) <= 1).all())


def kmeans(x: torch.Tensor, n_clusters: int, n_init: int = 10,
           max_iter: int = 100, generator: Optional[torch.Generator] = None,
           init: Optional[torch.Tensor] = None) -> KMeansResult:
    """k-means of fp32 x [n, D] on x's device.  ``init`` ([k, D] or
    [runs, k, D]) gives the initial centres and then no k-means++ runs;
    else ``n_init`` k-means++ runs draw from ``generator`` (a CPU
    generator; seeded 0 when None)."""
    if x.ndim != 2 or not x.is_floating_point():
        raise TypeError(f"want float [n, D] data, got {x.dtype} "
                        f"{tuple(x.shape)}")
    n, k = x.shape[0], int(n_clusters)
    if not 1 <= k <= n:
        raise ValueError(f"n_clusters={k} must lie in [1, {n}]")
    x = x.float()
    fp32_matmuls()
    mean = x.mean(0)
    tol_abs = float(x.var(0, unbiased=False).mean()) * TOL
    xc = x - mean
    if init is not None:
        start = init.to(x.device, torch.float32).reshape(-1, k, x.shape[1])
        start = start - mean
    else:
        gen = generator or torch.Generator().manual_seed(0)
        start = kmeans_plusplus(xc, k, int(n_init), gen)
    runs = start.shape[0]
    centers = start.clone()
    labels = torch.full((runs, n), -1, dtype=torch.long, device=x.device)
    active = torch.ones(runs, dtype=torch.bool, device=x.device)
    strict = torch.zeros_like(active)
    n_iter = torch.full((runs,), max_iter, dtype=torch.long,
                        device=x.device)
    for i in range(max_iter):
        new_labels = _assign(xc, centers)
        new_centers = _update(xc, new_labels, centers)
        shift = ((new_centers - centers) ** 2).sum((1, 2))
        same = (new_labels == labels).all(-1)
        stop = active & (same | (shift <= tol_abs))
        centers = torch.where(active[:, None, None], new_centers, centers)
        labels = torch.where(active[:, None], new_labels, labels)
        strict |= active & same
        n_iter = torch.where(stop, i + 1, n_iter)
        active &= ~stop
        if not bool(active.any()):
            break
    relabel = _assign(xc, centers)
    labels = torch.where(strict[:, None], labels, relabel)
    inertias = _inertia(xc, centers, labels)
    best = 0
    for run in range(1, runs):
        if bool(inertias[run] < inertias[best]) and not _same_clustering(
                labels[run], labels[best], k):
            best = run
    return KMeansResult(centers=centers[best] + mean, labels=labels[best],
                        inertia=float(inertias[best]),
                        n_iter=int(n_iter[best]), init=start + mean,
                        inertias=inertias)
