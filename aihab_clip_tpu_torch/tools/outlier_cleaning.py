"""Embedding-geometry outlier scoring over a cached embedding split
(counterpart of ``aihab_clip_tpu/tools/outlier_cleaning.py``):

  * ``SingleCentroidScorer`` — per-class normalized centroid; cosine
    distance scores with per-class rank and bottom-5% flag;
  * ``MultiPrototypeScorer`` — per-class spherical k-means (K by the class-
    size heuristic n<20->1, <100->3, <200->4, <300->5, else 6, with a
    min-samples-per-prototype safety cap) scoring distance to the nearest
    true-class prototype and the cross-class best-similarity margin;
  * ``select_outliers`` / ``materialize_clean_split``.

The arithmetic runs on the scorer's device (default the card): the
normalisation, the class centroids (one ``index_add_``), the per-class
k-means (``ops.kmeans``, its draws from a CPU generator seeded with
``random_state`` for each class, as JAX gives each class's ``KMeans`` the
same ``random_state``) and the ``[N, total_protos]`` similarity product.
The ranks, quantiles and the sort run on the host (``tools.table``).
Metadata is the ``{column: values}`` dict of
``cache.load_embedding_cache`` (or a ``Table``); the output tables carry
JAX's column contracts, row order, warnings and errors.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..backend import resolve_device
from ..ops.kmeans import fp32_matmuls, kmeans
from .table import Table

EPS = 1e-12

CENTROID_COLUMNS = [
    "file_name", "ground_truth_num_label", "ground_truth_word_label",
    "ground_truth_L2_num_label", "sim_to_centroid", "outlier_score",
    "class_size", "rank_in_class", "pct_rank_in_class", "is_bottom_5pct",
]

PROTO_COLUMNS = [
    "file_name", "ground_truth_num_label", "ground_truth_word_label",
    "ground_truth_L2_num_label", "sim_to_prototype", "outlier_score",
    "class_size", "k_per_class", "rank_in_class", "pct_rank_in_class",
    "is_bottom_5pct", "margin_to_other_class",
]

SORT_BY = (["outlier_score", "ground_truth_num_label", "file_name"],
           [False, True, True])


def heuristic_k(n: int) -> int:
    """Class-size -> number of prototype modes (reference heuristic)."""
    if n < 20:
        return 1
    if n < 100:
        return 3
    if n < 200:
        return 4
    if n < 300:
        return 5
    return 6


def _normalize(x: torch.Tensor) -> torch.Tensor:
    norms = x.norm(dim=-1, keepdim=True)
    if not bool(torch.isfinite(norms).all()):
        raise ValueError("Non-finite embedding norms found (NaN/Inf).")
    return x / norms.clamp_min(EPS)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """A mean vector over max(||v||, EPS)."""
    return v / v.norm(dim=-1, keepdim=True).clamp_min(EPS)


@dataclasses.dataclass
class CentroidResult:
    centroids: Dict[int, np.ndarray]
    class_counts: Dict[int, int]
    dim: int


@dataclasses.dataclass
class MultiPrototypeResult:
    prototypes: Dict[int, np.ndarray]       # label -> [K, dim]
    class_counts: Dict[int, int]
    prototype_counts: Dict[int, List[int]]
    k_per_class: Dict[int, int]
    dim: int


class SingleCentroidScorer:
    def __init__(self, embeddings, labels, metadata,
                 normalize_tol: float = 1e-3, device=None):
        self.device = resolve_device(device)
        embeddings = np.asarray(embeddings, np.float32)
        labels = np.asarray(labels).astype(int)
        meta = metadata if isinstance(metadata, Table) else Table(metadata)
        if embeddings.shape[0] != labels.shape[0]:
            raise ValueError("embeddings/labels row mismatch")
        if len(meta) != embeddings.shape[0]:
            raise ValueError("metadata/embeddings row mismatch")
        if not np.isfinite(embeddings).all():
            raise ValueError("Non-finite embeddings found (NaN/Inf).")
        self.embeddings = embeddings
        self.labels = labels
        self.metadata = meta
        self.dim = embeddings.shape[1]
        self.normalize_tol = normalize_tol
        self._emb = torch.from_numpy(embeddings).to(self.device)
        self._labels = torch.from_numpy(labels).to(self.device)
        self._normalized: Optional[torch.Tensor] = None
        self._centroids: Optional[CentroidResult] = None

    def _get_normalized(self) -> torch.Tensor:
        if self._normalized is None:
            dev = (self._emb.norm(dim=-1) - 1.0).abs().max().item()
            if dev > self.normalize_tol:
                print(f"[warn] Unnormalized embeddings detected "
                      f"(max |norm-1|={dev:.3e}); normalizing.")
                self._normalized = _normalize(self._emb)
            else:
                self._normalized = self._emb
        return self._normalized

    def compute_centroids(self) -> CentroidResult:
        if self._centroids is not None:
            return self._centroids
        emb = self._get_normalized()
        uniq, inverse, counts = torch.unique(self._labels, return_inverse=True,
                                             return_counts=True)
        uniq, counts = uniq.tolist(), counts.tolist()
        sums = torch.zeros(len(uniq), self.dim, device=self.device)
        sums.index_add_(0, inverse, emb)
        means = _unit(sums / torch.tensor(counts, dtype=torch.float32,
                                          device=self.device)[:, None])
        finite = torch.isfinite(means).all(-1).tolist()
        for label, ok in zip(uniq, finite):
            if not ok:
                raise ValueError(f"Non-finite centroid for class {label}")
        host = means.cpu().numpy()
        self._centroids = CentroidResult(
            {int(l): host[i] for i, l in enumerate(uniq)},
            {int(l): int(c) for l, c in zip(uniq, counts)}, self.dim)
        return self._centroids

    def _base_frame(self) -> Table:
        scores = self.metadata.copy()
        scores["ground_truth_num_label"] = self.labels.astype(np.int64)
        for col, default in (("ground_truth_word_label", ""),
                             ("ground_truth_L2_num_label", -1),
                             ("file_name", "")):
            if col not in scores:
                scores[col] = np.asarray(default)
        return scores

    @staticmethod
    def _rank_and_flag(scores: Table, sim_col: str) -> Table:
        scores["rank_in_class"] = scores.group_rank_first(
            "ground_truth_num_label", "outlier_score")
        scores["pct_rank_in_class"] = (scores["rank_in_class"]
                                       / scores["class_size"])
        p05 = scores.group_quantile("ground_truth_num_label", sim_col, 0.05)
        scores["is_bottom_5pct"] = scores[sim_col].astype(np.float64) <= p05
        return scores

    def score_centroid_distance(
            self, centroids: Optional[CentroidResult] = None) -> Table:
        cres = centroids or self.compute_centroids()
        if cres.dim != self.dim:
            raise ValueError(
                f"Centroid dim mismatch: expected {self.dim}, got {cres.dim}")
        emb = self._get_normalized()
        missing = sorted(set(np.unique(self.labels).tolist())
                         - set(cres.centroids))
        if missing:
            raise ValueError(f"Missing centroid(s) for label(s): {missing}")
        uniq = sorted(cres.centroids)
        table = torch.from_numpy(np.stack(
            [np.asarray(cres.centroids[l], np.float32) for l in uniq])
        ).to(self.device)
        slot = torch.from_numpy(np.searchsorted(uniq, self.labels)
                                ).to(self.device)
        sim = (emb * table[slot]).sum(-1).cpu().numpy()

        scores = self._base_frame()
        scores["sim_to_centroid"] = sim
        scores["outlier_score"] = 1.0 - sim
        scores["class_size"] = scores.map("ground_truth_num_label",
                                          cres.class_counts)
        scores = self._rank_and_flag(scores, "sim_to_centroid")
        return scores.select(CENTROID_COLUMNS).sort_values(*SORT_BY)


class MultiPrototypeScorer(SingleCentroidScorer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._prototypes: Optional[MultiPrototypeResult] = None
        self.kmeans_runs: Dict[int, object] = {}

    def compute_prototypes(
        self, k_mode: str = "heuristic", k_fixed: int = 2, k_max: int = 4,
        min_samples_per_proto: int = 15, random_state: int = 0,
        n_init: int = 10, max_iter: int = 100,
    ) -> MultiPrototypeResult:
        """Per-class prototypes; each class's k-means result (initial
        centres included) is kept in ``kmeans_runs``."""
        if k_mode not in {"heuristic", "fixed"}:
            raise ValueError(f"Unsupported k_mode '{k_mode}'.")
        emb = self._get_normalized()
        prototypes: Dict[int, np.ndarray] = {}
        class_counts: Dict[int, int] = {}
        proto_counts: Dict[int, List[int]] = {}
        k_per_class: Dict[int, int] = {}
        self.kmeans_runs = {}

        fp32_matmuls()
        for label in np.unique(self.labels).tolist():
            x_c = emb[self._labels == label]
            n_c = x_c.shape[0]
            class_counts[label] = n_c
            base_k = (heuristic_k(n_c) if k_mode == "heuristic"
                      else int(k_fixed))
            k_c = max(1, min(base_k, int(k_max), n_c,
                             max(1, n_c // int(min_samples_per_proto))))

            if k_c == 1:
                prototypes[label] = _unit(x_c.mean(0, keepdim=True)
                                          ).cpu().numpy()
                proto_counts[label] = [n_c]
                k_per_class[label] = 1
                continue

            run = kmeans(x_c, k_c, n_init=int(n_init),
                         max_iter=int(max_iter),
                         generator=torch.Generator().manual_seed(
                             int(random_state)))
            self.kmeans_runs[label] = run
            centers = _normalize(run.centers)
            assign = (x_c @ centers.T).argmax(1)
            prototypes[label] = centers.cpu().numpy()
            proto_counts[label] = torch.bincount(
                assign, minlength=k_c).tolist()
            k_per_class[label] = k_c

        self._prototypes = MultiPrototypeResult(
            prototypes, class_counts, proto_counts, k_per_class, self.dim)
        return self._prototypes

    def score_prototype_distance(
            self, prototypes: Optional[MultiPrototypeResult] = None) -> Table:
        pres = prototypes or self._prototypes or self.compute_prototypes()
        emb = self._get_normalized()
        uniq = np.unique(self.labels)

        # similarity to every class's prototypes in one block matmul
        all_protos = torch.from_numpy(np.concatenate(
            [np.asarray(pres.prototypes[int(l)], np.float32) for l in uniq],
            0)).to(self.device)
        owner = torch.from_numpy(np.concatenate([
            np.full(len(pres.prototypes[int(l)]), int(l)) for l in uniq])
        ).to(self.device)
        sims = emb @ all_protos.T                          # [N, total_protos]
        own = owner[None, :] == self._labels[:, None]
        neg_inf = torch.tensor(-torch.inf, device=self.device)
        sim_to_prototype = torch.where(own, sims, neg_inf).max(1).values
        if len(uniq) > 1:
            sim_other = torch.where(~own, sims, neg_inf).max(1).values
            margin = (sim_to_prototype - sim_other).cpu().numpy()
        else:
            margin = np.full(len(self.labels), np.nan, np.float32)
        sim_to_prototype = sim_to_prototype.cpu().numpy()

        scores = self._base_frame()
        scores["sim_to_prototype"] = sim_to_prototype
        scores["outlier_score"] = 1.0 - sim_to_prototype
        scores["class_size"] = scores.map("ground_truth_num_label",
                                          pres.class_counts)
        scores["k_per_class"] = scores.map("ground_truth_num_label",
                                           pres.k_per_class)
        scores = self._rank_and_flag(scores, "sim_to_prototype")
        scores["margin_to_other_class"] = margin
        return scores.select(PROTO_COLUMNS).sort_values(*SORT_BY)


def select_outliers(
    scores: Table,
    mode: str = "bottom_pct",
    pct: float = 0.05,
    threshold: Optional[float] = None,
    margin_threshold: Optional[float] = None,
) -> Table:
    """Select rows to drop.  Modes:
      * 'bottom_pct'  — worst ``pct`` per class by outlier score;
      * 'threshold'   — outlier_score > threshold;
      * 'margin'      — margin_to_other_class < margin_threshold
                        (multi-prototype scores only).
    """
    if mode == "bottom_pct":
        return scores.filter(scores["pct_rank_in_class"] <= pct)
    if mode == "threshold":
        if threshold is None:
            raise ValueError("mode='threshold' requires threshold")
        return scores.filter(scores["outlier_score"] > threshold)
    if mode == "margin":
        if margin_threshold is None:
            raise ValueError("mode='margin' requires margin_threshold")
        if "margin_to_other_class" not in scores:
            raise ValueError("margin mode requires multi-prototype scores")
        return scores.filter(scores["margin_to_other_class"]
                             .astype(np.float64) < margin_threshold)
    raise ValueError(f"Unsupported selection mode '{mode}'")


def materialize_clean_split(
    scores_or_selected: Table,
    src_dir: Path,
    dst_dir: Path,
    index_file_name: str,
    copy: bool = True,
) -> Dict[str, int]:
    """Write a cleaned dataset folder: copy (or link) every image NOT in the
    selected-outlier set and a filtered index CSV."""
    src_dir, dst_dir = Path(src_dir), Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    drop = {str(v).lower() for v in scores_or_selected["file_name"].tolist()}

    index = Table.read_csv(src_dir / index_file_name)
    keep = [str(v).lower() not in drop for v in index["file"].tolist()]
    index.filter(keep).to_csv(dst_dir / index_file_name)

    kept = dropped = 0
    for f in sorted(src_dir.iterdir()):
        if not f.is_file() or f.name == index_file_name:
            continue
        if f.suffix.lower() not in (".jpg", ".jpeg", ".png", ".bmp"):
            continue
        if f.name.lower() in drop:
            dropped += 1
            continue
        target = dst_dir / f.name
        if copy:
            shutil.copy2(f, target)
        else:
            if not target.exists():
                target.symlink_to(f.resolve())
        kept += 1
    return {"kept": kept, "dropped": dropped}
