"""Device-resident classification metrics (counterpart of
``aihab_clip_tpu/ops/metrics.py:29-235``).

Everything but top-k reduces from one [C, C] confusion matrix, so an
evaluation accumulates that matrix and a few scalars on the device, with no
host sync per batch.  Contracts:
  * weighted F1: per-class F1 weighted by true-class support; classes with
    zero precision + recall contribute 0;
  * MCC: (c*s - sum_k p_k t_k) / sqrt((s^2 - sum p_k^2)(s^2 - sum t_k^2)),
    0 when the denominator is 0, in float64 (the JAX package's x64 branch:
    s^2 passes 2^24 at ~4,100 samples);
  * top-k: correct when the target is among the k highest logits.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch


def confusion_matrix(preds: torch.Tensor, targets: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """[C, C] int64 confusion matrix, rows = true class, cols = predicted."""
    idx = targets.long() * num_classes + preds.long()
    flat = torch.zeros(num_classes * num_classes, dtype=torch.int64,
                       device=preds.device)
    flat.scatter_add_(0, idx, torch.ones_like(idx))
    return flat.reshape(num_classes, num_classes)


def topk_correct(logits: torch.Tensor, targets: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Number of samples whose target is within the top-k logits."""
    top = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    return (top == targets[:, None]).any(-1).sum()


def accuracy_from_cm(cm: torch.Tensor) -> torch.Tensor:
    total = cm.sum()
    return torch.where(total > 0, cm.trace() / total.clamp_min(1), 0.0)


def weighted_f1_from_cm(cm: torch.Tensor) -> torch.Tensor:
    cm = cm.float()
    tp = cm.diagonal()
    support = cm.sum(1)                   # true counts per class
    denom = support + cm.sum(0)           # = 2tp + fp + fn
    f1 = torch.where(denom > 0, 2.0 * tp / denom.clamp_min(1e-12), 0.0)
    total = support.sum()
    return torch.where(total > 0, (f1 * support).sum() / total.clamp_min(1),
                       0.0)


def mcc_from_cm(cm: torch.Tensor) -> torch.Tensor:
    cm = cm.double()
    t, p = cm.sum(1), cm.sum(0)
    c, s = cm.trace(), cm.sum()
    cov_ytyp = c * s - t @ p
    cov_ypyp = s * s - p @ p
    cov_ytyt = s * s - t @ t
    denom = cov_ytyt.sqrt() * cov_ypyp.sqrt()
    return torch.where(denom > 0, cov_ytyp / denom.clamp_min(1e-12), 0.0)


class MetricState(NamedTuple):
    """Accumulated evaluation state (tensors on the device)."""

    cm: torch.Tensor            # [C, C] int64
    correct_topk: torch.Tensor  # [len(ks)] int64
    loss_sum: torch.Tensor      # fp32 scalar (sum of batch mean losses)
    batches: torch.Tensor       # int64
    seen: torch.Tensor          # int64


def init_metric_state(num_classes: int, ks: Sequence[int] = (1, 3),
                      device=None) -> MetricState:
    z = torch.zeros((), dtype=torch.int64, device=device)
    return MetricState(
        cm=torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=device),
        correct_topk=torch.zeros(len(ks), dtype=torch.int64, device=device),
        loss_sum=torch.zeros((), dtype=torch.float32, device=device),
        batches=z, seen=z)


def update_metric_state(state: MetricState, logits: torch.Tensor,
                        targets: torch.Tensor,
                        loss: Optional[torch.Tensor] = None,
                        ks: Sequence[int] = (1, 3),
                        valid_mask: Optional[torch.Tensor] = None
                        ) -> MetricState:
    """Accumulate one batch; ``valid_mask`` excludes padding rows (their
    (0, 0) confusion entries are counted and then subtracted, so no
    dynamic shape forces a host sync)."""
    num_classes = state.cm.shape[0]
    targets = targets.long()
    if valid_mask is None:
        valid_mask = torch.ones_like(targets, dtype=torch.bool)
    n_valid = valid_mask.long().sum()
    preds = logits.argmax(-1)
    cm_batch = confusion_matrix(torch.where(valid_mask, preds, 0),
                                torch.where(valid_mask, targets, 0),
                                num_classes)
    cm_batch[0, 0] -= (~valid_mask).long().sum()
    hits = []
    for k in ks:
        top = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
        hits.append(((top == targets[:, None]).any(-1) & valid_mask).sum())
    return MetricState(
        cm=state.cm + cm_batch,
        correct_topk=state.correct_topk + torch.stack(hits),
        loss_sum=state.loss_sum + (loss if loss is not None else 0.0),
        batches=state.batches + (n_valid > 0).long(),
        seen=state.seen + n_valid)


def compute_metrics(state: MetricState,
                    ks: Sequence[int] = (1, 3)) -> Dict[str, torch.Tensor]:
    seen = state.seen.clamp_min(1)
    out = {"loss": state.loss_sum / state.batches.clamp_min(1),
           "f1": weighted_f1_from_cm(state.cm),
           "mcc": mcc_from_cm(state.cm),
           "cm": state.cm}
    for i, k in enumerate(ks):
        out[f"top{k}"] = state.correct_topk[i] / seen
    return out


# ---------------------------------------------------------------------------
# L2 taxonomy roll-up
# ---------------------------------------------------------------------------


def map_l3_to_l2(values: torch.Tensor, l3_to_l2: torch.Tensor) -> torch.Tensor:
    """L2 ids of L3 ids (targets or argmax predictions)."""
    return l3_to_l2[values.long()]


def aggregate_logits_to_l2(logits_l3: torch.Tensor, l3_to_l2: torch.Tensor,
                           num_l2: int, reduce: str = "mean") -> torch.Tensor:
    """Group L3 logits into L2 logits: "sum" totals the subclass evidence,
    "mean" removes the per-L2 count bias, "logsumexp" approximates the log
    of the summed probabilities."""
    if reduce not in {"sum", "mean", "logsumexp"}:
        raise ValueError(f"Unsupported reduce='{reduce}'. Expected one of: "
                         "sum, mean, logsumexp.")
    group = torch.nn.functional.one_hot(
        l3_to_l2.long(), num_l2).to(logits_l3.dtype)           # [L3, L2]
    if reduce == "logsumexp":
        masked = torch.where(group.T[None] > 0, logits_l3[:, None, :],
                             float("-inf"))                      # [B, L2, L3]
        return torch.logsumexp(masked, -1)
    summed = logits_l3 @ group
    if reduce == "mean":
        summed = summed / group.sum(0).clamp_min(1.0)
    return summed


class L2MetricsAccumulator:
    """L2 metrics from L3 logits/targets.  mode "argmax" maps the L3 argmax
    to L2 (top-1 only); mode "logits" aggregates L3 logits into L2 logits
    (top-k).  ``compute()`` returns {top1[, top3], f1, mcc, cm}."""

    def __init__(self, l3_to_l2, num_l2: int, reduce: str = "mean",
                 topk: Sequence[int] = (1, 3), mode: str = "argmax",
                 return_confusion_matrix: bool = False, device=None):
        if mode not in {"argmax", "logits"}:
            raise ValueError(f"Unsupported mode='{mode}'.")
        self.l3_to_l2 = torch.as_tensor(np.asarray(l3_to_l2), device=device,
                                        dtype=torch.int64)
        self.num_l2 = int(num_l2)
        self.reduce = reduce
        self.mode = mode
        self.topk = (1,) if mode == "argmax" else tuple(int(k) for k in topk)
        self.return_confusion_matrix = return_confusion_matrix
        self.state = init_metric_state(self.num_l2, self.topk, device)

    def update(self, logits_l3, targets_l3, valid_mask=None) -> None:
        logits_l3 = torch.as_tensor(logits_l3, device=self.l3_to_l2.device)
        targets_l2 = map_l3_to_l2(
            torch.as_tensor(targets_l3, device=self.l3_to_l2.device),
            self.l3_to_l2)
        if self.mode == "argmax":
            preds_l2 = map_l3_to_l2(logits_l3.argmax(-1), self.l3_to_l2)
            l2_logits = torch.nn.functional.one_hot(
                preds_l2, self.num_l2).float()
        else:
            l2_logits = aggregate_logits_to_l2(logits_l3, self.l3_to_l2,
                                               self.num_l2, self.reduce)
        if valid_mask is not None:
            valid_mask = torch.as_tensor(valid_mask,
                                         device=self.l3_to_l2.device)
        self.state = update_metric_state(self.state, l2_logits, targets_l2,
                                         ks=self.topk, valid_mask=valid_mask)

    def compute(self) -> Dict[str, float]:
        m = compute_metrics(self.state, ks=self.topk)
        out: Dict[str, float] = {f"top{k}": float(m[f"top{k}"])
                                 for k in self.topk}
        out["f1"] = float(m["f1"])
        out["mcc"] = float(m["mcc"])
        out["cm"] = (m["cm"].cpu().numpy() if self.return_confusion_matrix
                     else None)
        return out
