"""Evaluation: zero-shot classification and fine-tune validation
(counterpart of ``aihab_clip_tpu/train/evaluate.py:29-208``).

Per batch on the device: eval transform -> the fastest image encode for the
device (``encode_image_fastest``: K5/K4 for SigLIP on the card, the
canonical module on the CPU) -> ``100 * normalize(f) @ T`` -> masked
cross-entropy -> the metric state, which stays on the device until the end
of the split.  Returns loss, top1, top3, weighted F1, MCC, the optional
confusion matrix and L2 roll-up, and fills an optional tracker.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..data.pipeline import SplitView
from ..ops import metrics as M
from ..ops.preprocess import eval_transform, normalize_stats_for
from .tracker import ClassificationTracker


def masked_ce_metrics(logits, labels, valid):
    """Masked cross-entropy and (correct, n_valid): the one definition of
    the classification objective's tail, shared by the train step and the
    evaluation."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    n_valid = valid.float().sum().clamp_min(1.0)
    loss = torch.where(valid, nll, 0.0).sum() / n_valid
    correct = ((logits.argmax(-1) == labels) & valid).sum()
    return loss, (correct, n_valid)


@torch.inference_mode()
def evaluate(model, view: SplitView, text_weights: torch.Tensor,
             resolution: int, num_classes: int,
             compute_dtype=torch.float32,
             return_confusion_matrix: bool = False,
             l2_eval_ctx: Optional[Dict] = None,
             tracker: Optional[ClassificationTracker] = None,
             packed=None) -> Dict[str, Any]:
    """Evaluate a split on the model's device.  Returns {loss, top1, top3,
    f1, mcc, cm (optional), l2 (optional)}.  ``packed`` is the kernels'
    weight pack (``pack_fastest``), built here for a tower on the card when
    not given."""
    from ..models.fast_vit import encode_image_fastest, pack_fastest

    config = model.config
    dev = model.logit_scale.device
    if packed is None and dev.type == "cuda":
        packed = pack_fastest(model, config, compute_dtype)
    mean, std = normalize_stats_for(config)
    state = M.init_metric_state(num_classes, device=dev)
    l2_acc = None
    if l2_eval_ctx is not None:
        l2_acc = M.L2MetricsAccumulator(
            l3_to_l2=l2_eval_ctx["l3_to_l2"], num_l2=l2_eval_ctx["num_l2"],
            reduce=l2_eval_ctx.get("reduce", "mean"),
            topk=l2_eval_ctx.get("topk", (1, 3)),
            mode=l2_eval_ctx.get("mode", "argmax"),
            return_confusion_matrix=l2_eval_ctx.get(
                "return_confusion_matrix", False), device=dev)

    for batch in view.batches():
        imgs = torch.from_numpy(batch.images).to(dev)
        labels = torch.from_numpy(batch.labels).to(dev)
        valid = torch.from_numpy(batch.valid).to(dev)
        x = eval_transform(imgs, resolution, dtype=compute_dtype, mean=mean,
                           std=std)
        _, feats = encode_image_fastest(model, x, config, project=True,
                                        packed=packed)
        feats = feats.float()
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        logits = 100.0 * feats @ text_weights
        loss, _ = masked_ce_metrics(logits, labels, valid)
        state = M.update_metric_state(state, logits, labels, loss=loss,
                                      valid_mask=valid)
        if l2_acc is not None:
            l2_acc.update(logits, labels, valid_mask=valid)
        if tracker is not None:
            tracker.track_batch(logits.cpu().numpy(), batch.labels,
                                batch.valid, view.metadata_rows(batch.indices))

    m = M.compute_metrics(state)
    return {
        "loss": float(m["loss"]),
        "top1": float(m["top1"]),
        "top3": float(m["top3"]),
        "f1": float(m["f1"]),
        "mcc": float(m["mcc"]),
        "cm": m["cm"].cpu().numpy() if return_confusion_matrix else None,
        "l2": l2_acc.compute() if l2_acc is not None else None,
    }
