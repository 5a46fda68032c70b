"""The train/val/test views of a config (counterpart of
``aihab_clip_tpu/data/loaders.py``): bulk load -> subset filter -> splits ->
few-shot -> SplitViews.  Test folders are derived by the ``_train`` ->
``_test`` path rule unless configured explicitly; indices, labels and file
order equal the JAX package's for the same config."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..taxonomy import l3_values_to_ids
from .bulk_load import load_folders
from .pipeline import ImageArrayDataset, SplitView
from .splits import few_shot_indices, selection_by_class, stratified_group_split


def derive_test_paths(train_paths: List[str]) -> List[str]:
    return [p.replace("_train", "_test") for p in train_paths]


@dataclasses.dataclass
class LoaderBundle:
    train: SplitView
    val: SplitView
    test: SplitView
    info: Dict
    train_dataset: ImageArrayDataset
    test_dataset: ImageArrayDataset


def _as_list(v):
    if v is None:
        return None
    return [v] if isinstance(v, str) else list(v)


def _subset_filter(ds: ImageArrayDataset, ids: List[int]) -> ImageArrayDataset:
    return ds.select(np.where(np.isin(ds.labels, ids))[0])


def build_loaders(cfg, channel_order: Optional[str] = None,
                  device=None) -> LoaderBundle:
    """The config's splits; JPEGs decode through the fast decode on
    ``device`` (the runner's; the card by default)."""
    data_cfg = cfg["data"]
    resize = int(data_cfg["preprocessing"].get("resize", 256))
    channel_order = channel_order or str(data_cfg.get("channel_order", "rgb"))
    cache_dir = data_cfg.get("decode_cache_dir", None)
    num_workers = int(data_cfg.get("num_workers", 0))
    # the JAX native path's DCT-domain decode, on by default there
    prescale = bool(data_cfg.get("decode_prescale", True))

    subset_l3 = cfg.get("subset_l3", []) or []
    if isinstance(subset_l3, (str, int)):
        subset_l3 = [subset_l3]
    subset_l3_names, subset_l3_ids = l3_values_to_ids(subset_l3)
    use_subset = len(subset_l3_ids) > 0

    train_paths = _as_list(data_cfg["dataset_paths"])
    index_names = _as_list(data_cfg["index_file_names"])
    ds_tr = load_folders(train_paths, index_names, resize, channel_order,
                         num_workers, cache_dir, verbose=False,
                         prescale=prescale, device=device)

    test_paths = _as_list(data_cfg.get("test_dataset_paths", None)) or \
        derive_test_paths(train_paths)
    test_index = _as_list(data_cfg.get("test_index_file_names", None)) \
        or index_names
    if len(test_paths) != len(test_index):
        raise ValueError(
            f"Mismatch: test_dataset_paths has {len(test_paths)} entries but "
            f"test_index_file_names has {len(test_index)}.")
    ds_te = load_folders(test_paths, test_index, resize, channel_order,
                         num_workers, cache_dir, verbose=False,
                         prescale=prescale, device=device)

    if use_subset:
        ds_tr = _subset_filter(ds_tr, subset_l3_ids)
        ds_te = _subset_filter(ds_te, subset_l3_ids)

    seed = int(cfg.get("seed", 1))
    rng = np.random.RandomState(seed)
    split_cfg = data_cfg.get("data_split", {})
    val_ratio = float(split_cfg.get("valid_split", 0.1))
    val_seed = int(split_cfg.get("split_seed", seed))
    train_pool_idx, val_idx = stratified_group_split(
        ds_tr.labels, np.asarray([str(p) for p in ds_tr.plot_idx]),
        val_ratio, val_seed)

    shots = int(cfg.get("shots", 0) or 0)
    if shots > 0:
        rel_sel = few_shot_indices(ds_tr.labels[train_pool_idx], shots, rng)
        sel_tr = train_pool_idx[rel_sel]
    else:
        sel_tr = train_pool_idx

    batch_size = int(data_cfg["batch_size"])
    # eval has no optimizer state beside it: 0 = the train batch size
    eval_bs = int(data_cfg.get("eval_batch_size", 0) or 0) or batch_size
    shuffle = bool(data_cfg.get("shuffle", True))
    use_l2 = bool(data_cfg.get("use_l2_label", False))

    train = SplitView(ds_tr, sel_tr, batch_size, shuffle=shuffle,
                      use_l2_label=use_l2, seed=seed)
    val = SplitView(ds_tr, val_idx, eval_bs, shuffle=False,
                    use_l2_label=use_l2, seed=seed)
    test = SplitView(ds_te, np.arange(len(ds_te)), eval_bs, shuffle=False,
                     use_l2_label=use_l2, seed=seed)

    info = {
        "is_few_shot": shots > 0,
        "shots": shots,
        "train_size": int(len(sel_tr)),
        "train_batches": len(train),
        "val_size": int(len(val_idx)),
        "val_batches": len(val),
        "val_split": val_ratio,
        "selection_by_class": (selection_by_class(sel_tr, ds_tr.labels)
                               if shots > 0 else None),
        "subset_enabled": use_subset,
        "subset_l3": subset_l3,
        "subset_l3_ids": subset_l3_ids,
        "subset_l3_names": subset_l3_names,
    }
    if use_subset:
        print(f"dataloader subset: l3={subset_l3} l3_ids={subset_l3_ids} "
              f"l3_names={subset_l3_names}")
    return LoaderBundle(train=train, val=val, test=test, info=info,
                        train_dataset=ds_tr, test_dataset=ds_te)
