from .checkpointing import (checkpoint_path, latest_checkpoint,
                            load_checkpoint, load_params_into, load_projector,
                            save_checkpoint, save_projector,
                            wait_for_async_saves)
from .logging import RunLogger
from .profiling import StepTimer, annotate, device_memory_stats, trace

__all__ = [
    "RunLogger",
    "StepTimer",
    "annotate",
    "checkpoint_path",
    "device_memory_stats",
    "latest_checkpoint",
    "load_checkpoint",
    "load_params_into",
    "load_projector",
    "save_checkpoint",
    "save_projector",
    "trace",
    "wait_for_async_saves",
]
