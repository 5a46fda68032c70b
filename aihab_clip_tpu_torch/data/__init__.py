from .pipeline import Batch, ImageArrayDataset, SplitView

__all__ = ["Batch", "ImageArrayDataset", "SplitView"]
