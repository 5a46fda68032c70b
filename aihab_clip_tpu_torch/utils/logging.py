"""Experiment logging (counterpart of ``aihab_clip_tpu/utils/logging.py``)
in its ``stdout`` and ``off`` modes: every payload is one JSON line on
stdout and appended to ``<run_dir>/log.jsonl``; tables (lists of row dicts)
and the confusion matrix are CSV files under the run directory.  ``auto``
is ``stdout``; ``wandb`` raises, since the W&B logger (and the confusion
matrix heatmaps) are ROADMAP A10."""

from __future__ import annotations

import csv
import importlib.util
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

MODES = ("auto", "wandb", "stdout", "off")


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    return v


class RunLogger:
    """``mode``: 'auto' (= 'stdout'), 'stdout', 'off'; 'wandb' raises."""

    def __init__(self, project: Optional[str], run_name: str,
                 config: Optional[Dict] = None, mode: str = "auto",
                 run_dir: Optional[str] = None):
        if mode not in MODES:
            raise ValueError(f"logger mode {mode!r} not in {MODES}")
        if mode == "wandb":
            have = importlib.util.find_spec("wandb") is not None
            raise NotImplementedError(
                "the W&B logger is not ported (wandb is "
                f"{'installed' if have else 'not installed'}): ROADMAP A10; "
                "use --logger stdout")
        self.run_name = run_name
        self.run_dir = Path(run_dir or f"runs/{run_name}_{int(time.time())}")
        self._mode = "stdout" if mode == "auto" else mode
        if self._mode != "off":
            self.run_dir.mkdir(parents=True, exist_ok=True)
            if config is not None:
                (self.run_dir / "config.json").write_text(json.dumps(
                    {k: _jsonable(v) for k, v in dict(config).items()},
                    default=str, indent=2))

    def log(self, payload: Dict[str, Any]) -> None:
        if self._mode == "off":
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
        path = self.run_dir / f"{name.replace(' ', '_')}.csv"
        with path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]),
                                    lineterminator="\n")
            writer.writeheader()
            writer.writerows(rows)
        print(f"[log] table '{name}' -> {path}")

    def log_confusion_matrix(self, cm: np.ndarray, label_list) -> None:
        """The confusion matrix as a table (true label, then one column
        per predicted label)."""
        if self._mode == "off" or cm is None:
            return
        rows = [{"true_label": label_list[i],
                 **{label_list[j]: int(cm[i][j])
                    for j in range(len(label_list))}}
                for i in range(len(label_list))]
        self.log_table("confusion_matrix", rows)

    def finish(self) -> None:
        pass
