from .checkpointing import load_projector, save_projector
from .logging import RunLogger

__all__ = ["RunLogger", "load_projector", "save_projector"]
