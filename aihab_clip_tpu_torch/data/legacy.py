"""Legacy loader paths (counterpart of ``aihab_clip_tpu/data/legacy.py``):
K-fold cross-validation and simple train/valid splits over the bulk-loaded
arrays, the reference's aihab-legacy loader factories.

  * ``legacy_crop_size``     — the 'ratio' rule: crop = 0.875 * resize;
  * ``data_partition``       — bulk load + grouped K-fold or stratified
                               split index lists;
  * ``cross_valid_loaders``  — one (train, valid) ``SplitView`` pair a fold;
  * ``train_valid_loaders``  — one stratified split pair.

The splits are the package's own ``StratifiedGroupKFold`` and
``train_test_split`` (``data/splits.py``), which return scikit-learn's (1.9)
indices; scikit-learn itself is not needed.  The photos decode on ``device``
(``bulk_load.load_folders``: the card by default, ``"cpu"`` on the CPU).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .bulk_load import ImageArrayDataset, load_folders
from .pipeline import SplitView
from .splits import StratifiedGroupKFold, train_test_split


def legacy_crop_size(preproc: dict) -> int:
    """The aihab 'ratio' rule: crop = 0.875 * resize."""
    crop = preproc.get("augmentations", {}).get("crop", 384)
    if crop == "ratio":
        return int(preproc["resize"] * 0.875)
    if isinstance(crop, int):
        return crop
    raise ValueError(
        "Invalid value for 'crop_size'. It must be an integer or the string "
        "'ratio'.")


def data_partition(args: dict, device=None
                   ) -> Tuple[ImageArrayDataset, List[np.ndarray],
                              List[np.ndarray]]:
    """Bulk load + split index lists (grouped K-fold or stratified)."""
    ds = load_folders(args["dataset_paths"], args["index_file_names"],
                      args["preprocessing"].get("resize", 256), device=device)
    split = args.get("data_split", {})

    train_idx_list, valid_idx_list = [], []
    if split.get("if_grouped", False):
        n_splits = max(2, int(split.get("num_fold", 2)))
        sgk = StratifiedGroupKFold(n_splits=n_splits, shuffle=True,
                                   random_state=split.get("split_seed", 0))
        groups = np.asarray([str(p) for p in ds.plot_idx])
        for tr, va in sgk.split(ds.images, ds.labels, groups=groups):
            train_idx_list.append(tr)
            valid_idx_list.append(va)
            if split.get("first_cv_only", True):
                break
    else:
        tr, va = train_test_split(
            np.arange(len(ds)), test_size=split["valid_split"],
            stratify=ds.labels, random_state=split.get("split_seed", 0))
        train_idx_list.append(tr)
        valid_idx_list.append(va)
    return ds, train_idx_list, valid_idx_list


def _views(args: dict, ds, tr, va) -> Tuple[SplitView, SplitView]:
    batch_size = int(args.get("batch_size", 16))
    use_l2 = bool(args.get("use_l2_label", False))
    return (SplitView(ds, tr, batch_size,
                      shuffle=bool(args.get("shuffle", True)),
                      use_l2_label=use_l2),
            SplitView(ds, va, batch_size, shuffle=False, use_l2_label=use_l2))


def cross_valid_loaders(args: dict, device=None
                        ) -> List[Tuple[SplitView, SplitView]]:
    """All K folds as (train, valid) SplitView pairs."""
    split = dict(args.get("data_split", {}), if_grouped=True,
                 first_cv_only=False)
    args = {**args, "data_split": split}
    ds, train_list, valid_list = data_partition(args, device=device)
    return [_views(args, ds, tr, va) for tr, va in zip(train_list,
                                                       valid_list)]


def train_valid_loaders(args: dict, device=None
                        ) -> Tuple[SplitView, SplitView]:
    """Single stratified (non-grouped) train/valid pair."""
    args = {**args, "data_split": dict(args.get("data_split", {}),
                                       if_grouped=False)}
    ds, train_list, valid_list = data_partition(args, device=device)
    return _views(args, ds, train_list[0], valid_list[0])
