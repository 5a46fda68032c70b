"""Key-value stores under a cache or checkpoint root (the part of
tensorstore's kvstores the port needs).

``open_kvstore(root)`` takes a plain path or a ``file://`` URI and returns a
``FileKvStore``: keys are ``/``-separated paths under the root, ``read``
gives the value (None when the key is absent), ``write`` goes to a
temporary file in the key's directory that is renamed into place (a reader
never sees half a value), ``list`` gives every key under a prefix.

Any other scheme (``gs://``, ``s3://``, ...) opens as an ``UnsupportedKvStore``
whose first read or write raises ``NotImplementedError`` naming the scheme
and ROADMAP A18c: those kvstores need a network and a cloud client, which
the card's machine has neither of.  Opening one does not raise, so
``open_store`` and ``join_cache_path`` dispatch a remote root as the JAX
package's do.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import List, Optional, Union
from urllib.parse import unquote


def split_uri(root: Union[str, Path]):
    """(scheme or None, the rest): ``file:///a/b`` -> ("file", "/a/b")."""
    root = str(root)
    if "://" not in root:
        return None, root
    scheme, rest = root.split("://", 1)
    return scheme.lower(), rest


class FileKvStore:
    """Keys as files under a local directory."""

    def __init__(self, root: Union[str, Path]):
        scheme, rest = split_uri(root)
        if scheme not in (None, "file"):
            raise ValueError(f"{root}: not a file root")
        self.root = Path(unquote(rest) if scheme else rest)

    def _path(self, key: str) -> Path:
        key = key.lstrip("/")
        if any(part in ("", ".", "..") for part in key.split("/")):
            raise ValueError(f"bad key {key!r}")
        return self.root / key

    def read(self, key: str) -> Optional[bytes]:
        try:
            return self._path(key).read_bytes()
        except (FileNotFoundError, NotADirectoryError, IsADirectoryError):
            return None

    def read_range(self, key: str, offset: int, length: int) -> bytes:
        with open(self._path(key), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{self._path(key)}: {length} bytes at "
                             f"{offset} run past the end of the file")
        return data

    def write(self, key: str, value) -> None:
        """``value``: bytes, or a list of buffers written one after
        another."""
        path = self._path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}-"
                             f"{threading.get_ident()}")
        with open(tmp, "wb") as f:
            for part in value if isinstance(value, list) else [value]:
                f.write(part)
        os.replace(tmp, path)

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def list(self, prefix: str = "") -> List[str]:
        """Every key that starts with ``prefix``, sorted."""
        if not self.root.is_dir():
            return []
        # walk only the directory the prefix names
        head = prefix.rsplit("/", 1)[0] if "/" in prefix else ""
        base = self.root / head if head else self.root
        if not base.is_dir():
            return []
        keys = []
        for dirpath, _, files in os.walk(base):
            rel = Path(dirpath).relative_to(self.root).as_posix()
            for name in files:
                if ".tmp-" in name:
                    continue
                key = name if rel == "." else f"{rel}/{name}"
                if key.startswith(prefix):
                    keys.append(key)
        return sorted(keys)

    def delete_prefix(self, prefix: str) -> None:
        for key in self.list(prefix):
            self._path(key).unlink()


class UnsupportedKvStore:
    """A root whose scheme the port cannot reach: every operation raises."""

    def __init__(self, root: str):
        self.root = str(root)
        self.scheme = split_uri(root)[0]

    def _refuse(self, *_, **__):
        raise NotImplementedError(
            f"{self.root}: the {self.scheme}:// kvstore is not ported (it "
            "needs a network and a cloud client): ROADMAP A18c. Use a local "
            "path or a file:// root")

    read = read_range = write = exists = list = delete_prefix = _refuse


def open_kvstore(root: Union[str, Path]):
    scheme, _ = split_uri(root)
    if scheme in (None, "file"):
        return FileKvStore(root)
    return UnsupportedKvStore(str(root))
