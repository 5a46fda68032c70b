"""Experiment logging (counterpart of ``aihab_clip_tpu/utils/logging.py``):
W&B when the ``wandb`` package imports, otherwise every payload is one JSON
line on stdout and appended to ``<run_dir>/log.jsonl``; tables (lists of
row dicts) and the confusion matrix are CSV files under the run directory,
and the confusion matrix is also drawn as JAX's two heatmaps (raw and
row-normalised) where ``matplotlib`` and ``seaborn`` import.  ``wandb``,
``matplotlib`` and ``seaborn`` are imported only behind a guard, at use:
without them the logger carries on as JAX's does."""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

MODES = ("auto", "wandb", "stdout", "off")


def _import_wandb():
    try:
        import wandb
    except ImportError:
        return None
    return wandb


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    return v


class RunLogger:
    """``mode``: 'auto' (W&B when ``wandb`` imports and a project is set),
    'wandb' (W&B when ``wandb`` imports, the stdout logger otherwise),
    'stdout', 'off'."""

    def __init__(self, project: Optional[str], run_name: str,
                 config: Optional[Dict] = None, mode: str = "auto",
                 run_dir: Optional[str] = None):
        if mode not in MODES:
            raise ValueError(f"logger mode {mode!r} not in {MODES}")
        self.run_name = run_name
        self.run_dir = Path(run_dir or f"runs/{run_name}_{int(time.time())}")
        self._mode = mode
        self._wandb = None
        self._wandb_run = None
        if mode == "wandb" or (mode == "auto" and project):
            self._wandb = _import_wandb()
        if self._wandb is not None:
            self._wandb_run = self._wandb.init(
                project=project, name=run_name,
                config=dict(config) if config is not None else {})
        elif mode != "off":
            self.run_dir.mkdir(parents=True, exist_ok=True)
            if config is not None:
                (self.run_dir / "config.json").write_text(json.dumps(
                    {k: _jsonable(v) for k, v in dict(config).items()},
                    default=str, indent=2))

    def log(self, payload: Dict[str, Any]) -> None:
        if self._mode == "off":
            return
        if self._wandb_run is not None:
            self._wandb_run.log(payload)
            return
        line = json.dumps({k: _jsonable(v) for k, v in payload.items()},
                          default=str)
        print(f"[log] {line}")
        with (self.run_dir / "log.jsonl").open("a") as f:
            f.write(line + "\n")

    def log_table(self, name: str, rows: List[Dict[str, Any]]) -> None:
        """``rows``: one dict per row, every row with the same keys."""
        if self._mode == "off" or not rows:
            return
        if self._wandb_run is not None:
            cols = list(rows[0])
            self._wandb_run.log({name: self._wandb.Table(
                columns=cols, data=[[r[c] for c in cols] for r in rows])})
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        path = self.run_dir / f"{name.replace(' ', '_')}.csv"
        with path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]),
                                    lineterminator="\n")
            writer.writeheader()
            writer.writerows(rows)
        print(f"[log] table '{name}' -> {path}")

    def log_confusion_matrix(self, cm: np.ndarray, label_list) -> None:
        """The confusion matrix as a table (true label, then one column
        per predicted label) and JAX's two heatmaps."""
        if self._mode == "off" or cm is None:
            return
        rows = [{"true_label": label_list[i],
                 **{label_list[j]: int(cm[i][j])
                    for j in range(len(label_list))}}
                for i in range(len(label_list))]
        self.log_table("confusion_matrix", rows)
        try:
            self._draw_cm(np.asarray(cm), label_list)
        except Exception as exc:  # no matplotlib/seaborn, backend issues
            print(f"[log] cm plot skipped: {exc}")

    def _draw_cm(self, cm: np.ndarray, label_list) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns

        def plot(matrix, normalized: bool):
            title = "Confusion Matrix L3" + (" (Normalized)" if normalized
                                             else "")
            fig = plt.figure(figsize=(15, 12))
            if normalized:
                annot = np.vectorize(
                    lambda x: "0" if x == 0 else f"{x:.2f}")(matrix)
                sns.heatmap(matrix, annot=annot, fmt="", cmap="Blues",
                            xticklabels=label_list, yticklabels=label_list)
            else:
                sns.heatmap(matrix, annot=matrix.astype(int), fmt="d",
                            cmap="Blues", xticklabels=label_list,
                            yticklabels=label_list)
            plt.xlabel("Predicted")
            plt.ylabel("True")
            plt.title(title)
            plt.tight_layout()
            if self._wandb_run is not None:
                self._wandb_run.log(
                    {"Confusion Matrix": self._wandb.Image(fig)})
            else:
                fname = ("confusion_matrix_norm.png" if normalized
                         else "confusion_matrix.png")
                fig.savefig(self.run_dir / fname, dpi=80)
                print(f"[log] cm heatmap -> {self.run_dir / fname}")
            plt.close(fig)

        plot(cm, normalized=False)
        row_sums = cm.sum(axis=1, keepdims=True).astype(np.float64)
        row_sums[row_sums == 0] = 1
        plot(cm / row_sums, normalized=True)

    def finish(self) -> None:
        if self._wandb_run is not None:
            self._wandb_run.finish()
