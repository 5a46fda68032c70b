"""Cache array storage (counterpart of ``aihab_clip_tpu/cache/array_store.py``).

Two stores behind one interface, in the JAX package's layouts, so either
package reads a cache the other wrote:

  * ``LocalNpyStore`` keeps arrays as ``<root>/<name>.npy`` and JSON/text as
    plain files;
  * ``ZarrStore`` (JAX's ``TensorStoreStore``) keeps them as zarr v2 arrays
    under ``<root>/<name>/`` (``cache/zarr.py``: blosc/LZ4 chunks in
    tensorstore's default chunk shape, the ``.zarray`` tensorstore writes)
    over a kvstore (``cache/kvstore.py``).

``open_store(root)`` picks ``ZarrStore`` for any ``scheme://`` root and
``LocalNpyStore`` otherwise.  ``file://`` roots read and write; ``gs://``,
``s3://`` and other schemes open, and raise ``NotImplementedError`` naming
ROADMAP A18c at their first read or write.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Union

import numpy as np

from . import zarr
from .kvstore import open_kvstore

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


class ZarrStore:
    """Arrays as zarr v2 under ``<root>/<name>/``; text and JSON as keys of
    the kvstore (the JAX package's ``TensorStoreStore``)."""

    def __init__(self, root_uri: str):
        self.root = root_uri if root_uri.endswith("/") else root_uri + "/"
        self.kv = open_kvstore(self.root)

    def ensure(self) -> None:  # kvstores have no directories
        pass

    def prefetch(self, name: str) -> None:
        """Nothing to hint: a load reads its chunks whole."""

    def save(self, name: str, arr) -> str:
        """Replace ``name`` (its old chunks go first, as tensorstore's
        ``delete_existing``) with ``arr``."""
        self.kv.delete_prefix(f"{name}/")
        zarr.write_array(self.kv, name, arr)
        return f"{self.root}{name}/"

    def load(self, name: str, mmap: bool = False):
        try:
            return zarr.read_array(self.kv, name)
        except KeyError:
            raise FileNotFoundError(
                f"no cache array '{name}' in {self.root}") from None

    def exists(self, name: str) -> bool:
        """False only when the array is absent: any other failure (an
        unreachable root) raises, so a cache is never taken for missing and
        written over."""
        return self.kv.exists(f"{name}/.zarray")

    def list_arrays(self, prefix: str) -> List[str]:
        return sorted(k[:-len("/.zarray")] for k in self.kv.list(prefix)
                      if k.endswith("/.zarray"))

    def write_text(self, name: str, text: str) -> None:
        self.kv.write(name, text.encode())

    def read_text(self, name: str) -> str:
        data = self.kv.read(name)
        if data is None:
            raise FileNotFoundError(f"no {name} in {self.root}")
        return data.decode()

    def write_json(self, name: str, obj) -> None:
        self.write_text(name, json.dumps(obj, indent=2))

    def read_json(self, name: str):
        return json.loads(self.read_text(name))


Store = Union[LocalNpyStore, ZarrStore]


def is_remote_root(root: Union[str, Path]) -> bool:
    return "://" in str(root)


def open_store(root: Union[str, Path]) -> Store:
    if is_remote_root(root):
        return ZarrStore(str(root))
    return LocalNpyStore(root)


def join_cache_path(root: Union[str, Path], *parts: str):
    """Path joining that preserves URI roots (``Path`` mangles ``//``)."""
    if is_remote_root(root):
        return "/".join([str(root).rstrip("/"), *parts])
    return Path(root).joinpath(*parts)
