"""Cache array storage (counterpart of ``aihab_clip_tpu/cache/array_store.py``).

``LocalNpyStore`` keeps arrays as ``<root>/<name>.npy`` and JSON/text as
plain files — the JAX package's on-disk layout, so either package reads a
cache the other wrote.  A remote root (anything with ``://``, the JAX
package's ``TensorStoreStore`` over ``gs://`` ...) raises: the remote
store is ROADMAP A18.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Union

import numpy as np

_MADV_WILLNEED = 2


def _fast_load_npy(path: Path) -> np.ndarray:
    """Read a ``.npy`` into a fresh array via mmap + readahead + copy (the
    JAX package's reader); ``np.load`` for anything non-plain."""
    try:
        arr = np.load(path, mmap_mode="r")
    except ValueError:  # pickled / non-plain payloads cannot be mmap'd
        return np.load(path, allow_pickle=False)
    try:
        arr._mmap.madvise(_MADV_WILLNEED)
    except (AttributeError, OSError):
        pass
    return np.array(arr)


class LocalNpyStore:
    """Arrays as ``<root>/<name>.npy``; JSON as plain files."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)

    def ensure(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)

    def save(self, name: str, arr) -> str:
        self.ensure()
        path = self.root / f"{name}.npy"
        np.save(path, arr)
        return str(path)

    def load(self, name: str, mmap: bool = False):
        path = self.root / f"{name}.npy"
        if not mmap:
            return _fast_load_npy(path)
        arr = np.load(path, mmap_mode="r")
        try:
            arr._mmap.madvise(_MADV_WILLNEED)
        except (AttributeError, OSError):
            pass
        return arr

    def prefetch(self, name: str) -> None:
        """Hint the kernel to start reading the array file (non-blocking)."""
        try:
            fd = os.open(str(self.root / f"{name}.npy"), os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
            finally:
                os.close(fd)
        except (AttributeError, OSError):
            pass

    def exists(self, name: str) -> bool:
        return (self.root / f"{name}.npy").is_file()

    def list_arrays(self, prefix: str) -> List[str]:
        return sorted(p.stem for p in self.root.glob(f"{prefix}*.npy"))

    def write_text(self, name: str, text: str) -> None:
        self.ensure()
        (self.root / name).write_text(text)

    def read_text(self, name: str) -> str:
        return (self.root / name).read_text()

    def write_json(self, name: str, obj) -> None:
        self.write_text(name, json.dumps(obj, indent=2))

    def read_json(self, name: str):
        return json.loads(self.read_text(name))


def is_remote_root(root: Union[str, Path]) -> bool:
    return "://" in str(root)


def open_store(root: Union[str, Path]) -> LocalNpyStore:
    if is_remote_root(root):
        raise NotImplementedError(
            f"cache root {root}: remote (TensorStore) cache roots are not "
            "ported: ROADMAP A18")
    return LocalNpyStore(root)


def join_cache_path(root: Union[str, Path], *parts: str):
    """Path joining that preserves URI roots (``Path`` mangles ``//``)."""
    if is_remote_root(root):
        return "/".join([str(root).rstrip("/"), *parts])
    return Path(root).joinpath(*parts)
