#!/usr/bin/env python
"""Example: reproduce the stratified-group validation split (counterpart of
the root ``examples/split_data.py``).

Bulk-loads a CS-format dataset (JPEGs decoded on ``--device``, the card by
default; it raises without one unless ``--device cpu``), performs the
grouped stratified split (photos of one survey plot never straddle
train/val), and reports class balance per side:

    python -m aihab_clip_tpu_torch.examples.split_data [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..backend import resolve_device
from ..data import (load_folders, make_synthetic_cs_dataset,
                    stratified_group_split)
from ..taxonomy import REASSIGN_LABEL_NAME_L3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = resolve_device(p.parse_args(argv).device)

    data_dir = Path("./data/synth_cs_train")
    if not data_dir.is_dir():
        print("generating synthetic dataset ...")
        make_synthetic_cs_dataset("./data", name="synth_cs",
                                  n_train_per_class=8)

    ds = load_folders([str(data_dir)], ["index.csv"], resize_dim=32,
                      device=device)
    print(f"loaded {len(ds)} images, {len(set(map(str, ds.plot_idx)))} plots, "
          f"{len(np.unique(ds.labels))} classes")

    groups = np.asarray([str(p) for p in ds.plot_idx])
    train_idx, val_idx = stratified_group_split(ds.labels, groups,
                                                val_ratio=0.2, seed=42)
    print(f"train {len(train_idx)} / val {len(val_idx)}")
    if not set(groups[train_idx]).isdisjoint(groups[val_idx]):
        raise RuntimeError("grouped split must keep plots together")

    print("\nper-class counts (train / val):")
    for c in np.unique(ds.labels):
        name = REASSIGN_LABEL_NAME_L3[int(c)]
        n_tr = int((ds.labels[train_idx] == c).sum())
        n_va = int((ds.labels[val_idx] == c).sum())
        print(f"  {name:40s} {n_tr:4d} / {n_va:3d}")


if __name__ == "__main__":
    main()
