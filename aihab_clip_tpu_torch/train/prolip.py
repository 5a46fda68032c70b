"""ProLIP pieces (counterpart of ``aihab_clip_tpu/train/prolip.py``).  Only
the learning-rate schedule the PEFT loop shares is here; the ProLIP
trainer comes with a later slice."""

from __future__ import annotations

import math


def cosine_lr(base_lr: float, epoch: int, total_epochs: int) -> float:
    """torch CosineAnnealingLR with eta_min=0, stepped per epoch."""
    if total_epochs <= 0:
        return base_lr
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / total_epochs))
