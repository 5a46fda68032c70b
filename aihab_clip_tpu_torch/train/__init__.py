from .evaluate import evaluate, masked_ce_metrics
from .peft import PEFTConfig, build_lock_mask, finetune, trainable_report
from .tracker import ClassificationTracker

__all__ = ["ClassificationTracker", "PEFTConfig", "build_lock_mask",
           "evaluate", "finetune", "masked_ce_metrics", "trainable_report"]
