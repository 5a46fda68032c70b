"""Dataset partitioning (counterpart of ``aihab_clip_tpu/data/splits.py``):
the stratified-group validation split and the seeded few-shot selection.

  * ``stratified_group_split``: all photos of a survey plot stay together
    while the class balance is approximately kept; the first fold of
    ``StratifiedGroupKFold(n_splits=max(2, round(1/val_ratio)),
    shuffle=True, random_state=seed)``.  ``StratifiedGroupKFold`` here is
    the package's own, drawing from ``np.random.RandomState(seed)`` in
    scikit-learn's (1.9) order — one shuffle of the groups, a stable sort
    by the std of each group's class counts, the greedy fold choice — so
    it returns scikit-learn's indices;
  * ``few_shot_indices``: ``shots`` per class with the JAX package's
    ``RandomState.choice`` call pattern;
  * ``train_test_split``: scikit-learn's (1.9) stratified
    ``train_test_split`` (``StratifiedShuffleSplit``'s first split: the
    approximate mode of the multivariate hypergeometric per class, ties
    broken by ``RandomState.choice``, a permutation per class, then the two
    sets permuted), the same indices for the same (labels, sizes, seed); the
    legacy loaders' split (``data/legacy.py``).
"""

from __future__ import annotations

import warnings
from collections import defaultdict
from math import ceil
from typing import Dict, Iterator, Tuple

import numpy as np


def _random_state(rs) -> np.random.RandomState:
    """scikit-learn's ``check_random_state``: None is numpy's global
    RandomState, a RandomState is itself, a seed a new RandomState."""
    if rs is None:
        return np.random.mtrand._rand
    if isinstance(rs, np.random.RandomState):
        return rs
    return np.random.RandomState(rs)


class StratifiedGroupKFold:
    """``sklearn.model_selection.StratifiedGroupKFold`` (1.9): the same
    folds for the same (y, groups, n_splits, shuffle, random_state)."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False,
                 random_state=None):
        if int(n_splits) < 2:
            raise ValueError(f"n_splits={n_splits} must be at least 2")
        if not shuffle and random_state is not None:
            raise ValueError("Setting a random_state has no effect since "
                             "shuffle is False.")
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def _rng(self) -> np.random.RandomState:
        return _random_state(self.random_state)

    def _iter_test_indices(self, y, groups) -> Iterator[list]:
        rng = self._rng()
        y = np.asarray(y)
        if y.ndim != 1 or (y.dtype.kind == "f" and np.any(y != np.round(y))):
            raise ValueError("Supported target types are: ('binary', "
                             "'multiclass').")
        _, y_inv, y_cnt = np.unique(y, return_inverse=True,
                                    return_counts=True)
        if np.all(self.n_splits > y_cnt):
            raise ValueError(
                "n_splits=%d cannot be greater than the"
                " number of members in each class." % (self.n_splits))
        n_smallest_class = np.min(y_cnt)
        if self.n_splits > n_smallest_class:
            warnings.warn(
                "The least populated class in y has only %d"
                " members, which is less than n_splits=%d."
                % (n_smallest_class, self.n_splits), UserWarning)
        n_classes = len(y_cnt)

        _, groups_inv, groups_cnt = np.unique(groups, return_inverse=True,
                                              return_counts=True)
        n_groups = len(groups_cnt)
        if self.n_splits > n_groups:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                f"greater than the number of groups: {n_groups}.")

        y_counts_per_group = np.zeros((len(groups_cnt), n_classes))
        for class_idx, group_idx in zip(y_inv, groups_inv):
            y_counts_per_group[group_idx, class_idx] += 1

        y_counts_per_fold = np.zeros((self.n_splits, n_classes))
        groups_per_fold = defaultdict(set)

        if self.shuffle:
            perm = np.arange(len(groups_cnt))
            rng.shuffle(perm)
            y_counts_per_group = y_counts_per_group[perm]
            inv_perm = np.empty_like(perm)
            inv_perm[perm] = np.arange(perm.size)
            groups_inv = inv_perm[groups_inv]

        # stable sort: groups of equal spread keep the shuffled order
        sorted_groups_idx = np.argsort(-np.std(y_counts_per_group, axis=1),
                                       kind="stable")
        for group_idx in sorted_groups_idx:
            group_y_counts = y_counts_per_group[group_idx]
            best_fold = self._find_best_fold(y_counts_per_fold, y_cnt,
                                             group_y_counts)
            y_counts_per_fold[best_fold] += group_y_counts
            groups_per_fold[best_fold].add(group_idx)

        for i in range(self.n_splits):
            yield [idx for idx, group_idx in enumerate(groups_inv)
                   if group_idx in groups_per_fold[i]]

    def _find_best_fold(self, y_counts_per_fold, y_cnt, group_y_counts):
        best_fold = None
        min_eval = np.inf
        min_samples_in_fold = np.inf
        for i in range(self.n_splits):
            y_counts_per_fold[i] += group_y_counts
            std_per_class = np.std(y_counts_per_fold / y_cnt.reshape(1, -1),
                                   axis=0)
            y_counts_per_fold[i] -= group_y_counts
            fold_eval = np.mean(std_per_class)
            samples_in_fold = np.sum(y_counts_per_fold[i])
            is_current_fold_better = fold_eval < min_eval or (
                np.isclose(fold_eval, min_eval)
                and samples_in_fold < min_samples_in_fold)
            if is_current_fold_better:
                min_eval = fold_eval
                min_samples_in_fold = samples_in_fold
                best_fold = i
        return best_fold

    def split(self, X, y, groups) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n_samples = len(X)
        if len(y) != n_samples or len(groups) != n_samples:
            raise ValueError("X, y and groups differ in length")
        if self.n_splits > n_samples:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} "
                f"greater than the number of samples: n_samples={n_samples}.")
        indices = np.arange(n_samples)
        for test in self._iter_test_indices(y, groups):
            mask = np.zeros(n_samples, dtype=bool)
            mask[test] = True
            yield indices[~mask], indices[mask]


def stratified_group_split(labels: np.ndarray, groups: np.ndarray,
                           val_ratio: float,
                           seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (train_idx, val_idx)."""
    labels = np.asarray(labels)
    groups = np.asarray(groups)
    if val_ratio <= 0:
        return (np.arange(len(labels), dtype=np.int64),
                np.array([], dtype=np.int64))
    n_splits = max(2, int(round(1.0 / val_ratio)))
    sgkf = StratifiedGroupKFold(n_splits=n_splits, shuffle=True,
                                random_state=seed)
    train_idx, val_idx = next(sgkf.split(labels, labels, groups=groups))
    return train_idx.astype(np.int64), val_idx.astype(np.int64)


def few_shot_indices(labels: np.ndarray, shots: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """Sample ``shots`` indices per class (with replacement only when a
    class has fewer than ``shots`` samples)."""
    labels = np.asarray(labels)
    sel = []
    for c in np.unique(labels):
        idx_c = np.where(labels == c)[0]
        replace = len(idx_c) < shots
        sel.extend(rng.choice(idx_c, size=shots, replace=replace).tolist())
    return np.asarray(sel, dtype=np.int64)


def selection_by_class(sel: np.ndarray, labels: np.ndarray) -> Dict[int, list]:
    """Map class id -> selected absolute indices (for inspection output)."""
    out: Dict[int, list] = {}
    for c in np.unique(labels):
        out[int(c)] = sel[labels[sel] == c].tolist()
    return out


def _split_sizes(n_samples: int, test_size) -> Tuple[int, int]:
    """(n_train, n_test) of scikit-learn's ``_validate_shuffle_split`` with
    no train_size: a float test size is a fraction rounded up, an int a
    count; the rest trains."""
    kind = np.asarray(test_size).dtype.kind
    if kind not in ("i", "f") or (kind == "i" and not 0 < test_size < n_samples) \
            or (kind == "f" and not 0 < test_size < 1):
        raise ValueError(
            f"test_size={test_size} should be either positive and smaller than"
            f" the number of samples {n_samples} or a float in the (0, 1) "
            "range")
    n_test = ceil(test_size * n_samples) if kind == "f" else int(test_size)
    if n_samples - n_test == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size}"
                         " and train_size=None, the resulting train set will "
                         "be empty.")
    return n_samples - n_test, n_test


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's ``_approximate_mode``: the floored share of
    ``n_draws`` per class, the rest added by largest remainder, ties broken
    by ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def train_test_split(array, *, test_size=0.25, random_state=None,
                     stratify=None):
    """scikit-learn's ``train_test_split(array, test_size=...,
    stratify=labels, random_state=seed)`` (shuffled, stratified; the test
    size a fraction or a count): returns [array[train], array[test]] with
    its indices."""
    if stratify is None:
        raise ValueError("only the stratified split is carried: pass "
                         "stratify=labels")
    array = np.asarray(array)
    y = np.asarray(stratify)
    n_samples = len(array)
    if len(y) != n_samples:
        raise ValueError("array and stratify differ in length")
    n_train, n_test = _split_sizes(n_samples, test_size)
    classes, y_indices, class_counts = np.unique(y, return_inverse=True,
                                                 return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is "
            "too few. The minimum number of groups for any class cannot be "
            f"less than 2. Classes with too few members are: "
            f"{classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or "
                         f"equal to the number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = _random_state(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    train, test = rng.permutation(train), rng.permutation(test)
    return [array[train], array[test]]
