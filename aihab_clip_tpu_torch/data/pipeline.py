"""Host-side batching (counterpart of ``aihab_clip_tpu/data/pipeline.py``
and the ``ImageArrayDataset`` of ``data/bulk_load.py:36-64``).

The dataset is one [N, R, R, 3] uint8 array in RAM plus aligned metadata
columns, as ``data/bulk_load.py`` builds it.  Batches are fixed-shape: the trailing partial batch is padded and carries
a validity mask that the loss and metric code honour.  Shuffling is
host-side with the JAX package's generator and seed
(``RandomState((seed * 100003 + epoch) % 2**31)``), so both packages visit
the same batches in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass
class ImageArrayDataset:
    """Images + aligned metadata columns."""

    images: np.ndarray              # [N, R, R, 3] uint8
    labels: np.ndarray              # [N] int64 (reassigned L3 ids)
    l2_labels: np.ndarray           # [N] int64
    poly_labels: np.ndarray         # [N] int64 (-1 when absent)
    plot_word_labels: List[str]
    poly_word_labels: List[str]
    file_names: List[str]
    plot_idx: List[object]
    image_sources: List[str]

    def __len__(self) -> int:
        return len(self.labels)

    def select(self, idx: np.ndarray) -> "ImageArrayDataset":
        idx = np.asarray(idx)
        return ImageArrayDataset(
            images=self.images[idx],
            labels=self.labels[idx],
            l2_labels=self.l2_labels[idx],
            poly_labels=self.poly_labels[idx],
            plot_word_labels=[self.plot_word_labels[i] for i in idx],
            poly_word_labels=[self.poly_word_labels[i] for i in idx],
            file_names=[self.file_names[i] for i in idx],
            plot_idx=[self.plot_idx[i] for i in idx],
            image_sources=[self.image_sources[i] for i in idx],
        )

    def concat(self, other: "ImageArrayDataset") -> "ImageArrayDataset":
        return ImageArrayDataset(
            images=np.concatenate([self.images, other.images], 0),
            labels=np.concatenate([self.labels, other.labels], 0),
            l2_labels=np.concatenate([self.l2_labels, other.l2_labels], 0),
            poly_labels=np.concatenate([self.poly_labels, other.poly_labels], 0),
            plot_word_labels=self.plot_word_labels + other.plot_word_labels,
            poly_word_labels=self.poly_word_labels + other.poly_word_labels,
            file_names=self.file_names + other.file_names,
            plot_idx=self.plot_idx + other.plot_idx,
            image_sources=self.image_sources + other.image_sources,
        )

    def metadata_row(self, i: int) -> dict:
        return {
            "l2_label": int(self.l2_labels[i]),
            "poly_label": int(self.poly_labels[i]),
            "plot_word_label": self.plot_word_labels[i],
            "poly_word_label": self.poly_word_labels[i],
            "file_name": self.file_names[i],
            "plot_idx": self.plot_idx[i],
            "image_source": self.image_sources[i],
        }


@dataclasses.dataclass
class Batch:
    images: np.ndarray         # [B, R, R, 3] uint8 (padded)
    labels: np.ndarray         # [B] int32 (padded with 0)
    valid: np.ndarray          # [B] bool
    indices: np.ndarray        # [B] int64 absolute dataset indices (-1 pad)

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


class SplitView:
    """A view over an ImageArrayDataset restricted to selected indices,
    yielding fixed-shape padded batches."""

    def __init__(self, dataset: ImageArrayDataset, indices: np.ndarray,
                 batch_size: int, shuffle: bool = False,
                 use_l2_label: bool = False, seed: int = 0,
                 drop_remainder: bool = False):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.use_l2_label = use_l2_label
        self.seed = int(seed)
        self.drop_remainder = drop_remainder

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        return len(self.indices)

    @property
    def labels(self) -> np.ndarray:
        src = self.dataset.l2_labels if self.use_l2_label else self.dataset.labels
        return src[self.indices]

    def batches(self, epoch: int = 0) -> Iterator[Batch]:
        order = self.indices
        if self.shuffle:
            rng = np.random.RandomState((self.seed * 100003 + epoch) % (2 ** 31))
            order = order[rng.permutation(len(order))]
        labels_src = (self.dataset.l2_labels if self.use_l2_label
                      else self.dataset.labels)
        bs = self.batch_size
        n = len(order)
        stop = (n // bs) * bs if self.drop_remainder else n
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            k = len(idx)
            if k < bs:  # pad the trailing batch to the fixed shape
                images = np.concatenate(
                    [self.dataset.images[idx],
                     np.zeros((bs - k,) + self.dataset.images.shape[1:],
                              self.dataset.images.dtype)], 0)
                labels = np.concatenate([labels_src[idx],
                                         np.zeros(bs - k, np.int64)], 0)
                valid = np.concatenate([np.ones(k, bool), np.zeros(bs - k, bool)])
                indices = np.concatenate([idx, np.full(bs - k, -1, np.int64)])
            else:
                images = self.dataset.images[idx]
                labels = labels_src[idx]
                valid = np.ones(bs, bool)
                indices = idx
            yield Batch(images=np.ascontiguousarray(images),
                        labels=labels.astype(np.int32),
                        valid=valid, indices=indices)

    def metadata_rows(self, indices: np.ndarray) -> List[dict]:
        return [self.dataset.metadata_row(int(i)) for i in indices if i >= 0]
