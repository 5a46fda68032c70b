"""Per-sample classification tracking (counterpart of
``aihab_clip_tpu/train/tracker.py``): each evaluated sample with its top-3
predictions and probabilities and its metadata, split into misclassified
and correctly classified records, exportable as DataFrames."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..taxonomy import REASSIGN_LABEL_NAME_L3


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class ClassificationTracker:
    def __init__(self, label_names: Optional[Dict[int, str]] = None):
        self.label_names = label_names or REASSIGN_LABEL_NAME_L3
        self.misclassified: List[dict] = []
        self.accurate_classified: List[dict] = []

    def track_batch(self, logits: np.ndarray, labels: np.ndarray,
                    valid: np.ndarray, metadata_rows: Sequence[dict]) -> None:
        """logits [B, C]; labels/valid [B]; metadata_rows for the valid rows
        in order."""
        logits = np.asarray(logits)
        probs = _softmax(logits)
        k = min(3, logits.shape[-1])
        top3 = np.argsort(-logits, axis=-1)[:, :k]
        preds = top3[:, 0]
        meta_iter = iter(metadata_rows)
        for i in range(len(labels)):
            if not valid[i]:
                continue
            meta = next(meta_iter, {})
            rec = {
                "file_name": meta.get("file_name", ""),
                "ground_truth_num_label": int(labels[i]),
                "ground_truth_word_label": meta.get("plot_word_label", ""),
                "predicted_label": int(preds[i]),
                "predicted_word_label": self.label_names.get(
                    int(preds[i]), str(int(preds[i]))),
                "top3_predictions": [
                    {"label": int(top3[i, j]),
                     "probability": float(probs[i, top3[i, j]])}
                    for j in range(k)],
                "dataset": meta.get("image_source", ""),
            }
            if preds[i] != labels[i]:
                self.misclassified.append(rec)
            else:
                self.accurate_classified.append(rec)

    @staticmethod
    def _flatten(records: List[dict]):
        import pandas as pd

        rows = []
        for rec in records:
            row = {k: v for k, v in rec.items() if k != "top3_predictions"}
            for j, entry in enumerate(rec["top3_predictions"], 1):
                row[f"top3_label_{j}"] = entry["label"]
                row[f"top3_prob_{j}"] = entry["probability"]
            rows.append(row)
        return pd.DataFrame(rows)

    def to_dataframes(self):
        """(misclassified_df, correct_df), None where empty."""
        mis = self._flatten(self.misclassified) if self.misclassified else None
        cor = (self._flatten(self.accurate_classified)
               if self.accurate_classified else None)
        return mis, cor

    def save_classification(self, logger=None) -> None:
        """Log the tables through the experiment logger (``log_table``)."""
        mis, cor = self.to_dataframes()
        if logger is not None:
            if mis is not None:
                logger.log_table("Misclassifications", mis)
            if cor is not None:
                logger.log_table("Corclassifications", cor)
        if mis is None:
            print("No misclassified samples")
        if cor is None:
            print("No correctly classified samples")
