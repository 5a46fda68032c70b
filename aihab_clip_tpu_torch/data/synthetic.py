"""Synthetic CS-format dataset generator (counterpart of
``aihab_clip_tpu/data/synthetic.py``): the same tree, file names, pixels
(``np.random.RandomState(seed)`` draws), CSV columns, boundary rows and
unlabelled file.  The JPEGs come from ``data/encode.py``, which writes the
bytes ``cv2.imwrite`` writes at its defaults; the CSV is written as
``DataFrame.to_csv(index=False)`` writes it."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..taxonomy import BOUNDARY_PLOT_LABEL, CS_CLASSNAMES
from .encode import write_jpeg

CSV_COLUMNS = ("file", "BH_PLOT_DESC", "BH_POLYDESC", "ID")


def make_synthetic_cs_dataset(root: str | Path, name: str = "synth_cs",
                              classes: Optional[Sequence[str]] = None,
                              n_train_per_class: int = 6,
                              n_test_per_class: int = 3,
                              image_size: int = 64, seed: int = 0,
                              index_file_name: str = "index.csv",
                              with_boundary_rows: bool = True) -> dict:
    """Create ``<root>/<name>_train`` and ``<root>/<name>_test``: per class
    a distinct mean colour plus N(0, 25) noise, 3 survey plots per class,
    the last photo of each class on a boundary plot (its polygon label
    holds the class), one unlabelled row and file.  Returns the paths for
    the data config block."""
    rng = np.random.RandomState(seed)
    classes = list(classes or CS_CLASSNAMES[:4])
    root = Path(root)

    def class_color(ci: int) -> np.ndarray:
        phase = 2 * np.pi * ci / max(len(classes), 1)
        return np.array([128 + 100 * np.sin(phase),
                         128 + 100 * np.sin(phase + 2.1),
                         128 + 100 * np.sin(phase + 4.2)])

    def write_split(split: str, n_per_class: int) -> Path:
        folder = root / f"{name}_{split}"
        folder.mkdir(parents=True, exist_ok=True)
        rows = []
        for ci, cname in enumerate(classes):
            for j in range(n_per_class):
                fname = f"{split}_{ci:02d}_{j:03d}.jpg"
                img = class_color(ci)[None, None, :] + rng.normal(
                    0, 25, size=(image_size, image_size, 3))
                write_jpeg(folder / fname,
                           np.clip(img, 0, 255).astype(np.uint8))
                plot_id = f"PLOT{ci:02d}_{j % 3:02d}"  # 3 plots per class
                boundary = with_boundary_rows and j == n_per_class - 1
                rows.append((fname, BOUNDARY_PLOT_LABEL if boundary
                             else cname, cname, plot_id))
        blank = f"{split}_unlabeled.jpg"
        write_jpeg(folder / blank,
                   np.zeros((image_size, image_size, 3), np.uint8))
        rows.append((blank, "", "", "PLOTX"))
        with open(folder / index_file_name, "w", newline="",
                  encoding="utf-8") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(CSV_COLUMNS)
            writer.writerows(rows)
        return folder

    train_dir = write_split("train", n_train_per_class)
    test_dir = write_split("test", n_test_per_class)
    return {
        "train_dir": str(train_dir),
        "test_dir": str(test_dir),
        "index_file_name": index_file_name,
        "classes": classes,
        "dataset_paths": [str(train_dir)],
        "index_file_names": [index_file_name],
    }
