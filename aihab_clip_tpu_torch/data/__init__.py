from .bulk_load import load_folder, load_folders
from .index import ImageRecord, LabelIndex
from .loaders import LoaderBundle, build_loaders, derive_test_paths
from .pipeline import Batch, ImageArrayDataset, SplitView
from .splits import (StratifiedGroupKFold, few_shot_indices,
                     selection_by_class, stratified_group_split)
from .synthetic import make_synthetic_cs_dataset

__all__ = [
    "Batch",
    "ImageArrayDataset",
    "ImageRecord",
    "LabelIndex",
    "LoaderBundle",
    "SplitView",
    "StratifiedGroupKFold",
    "build_loaders",
    "derive_test_paths",
    "few_shot_indices",
    "load_folder",
    "load_folders",
    "make_synthetic_cs_dataset",
    "selection_by_class",
    "stratified_group_split",
]
