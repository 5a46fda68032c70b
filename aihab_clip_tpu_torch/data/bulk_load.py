"""Bulk image loading: decode + resize every labelled image into one uint8
array held in RAM (counterpart of ``aihab_clip_tpu/data/bulk_load.py``).

The files of a folder are taken in sorted order, the ``CORRUPT_IMAGES`` are
skipped and unlabelled files are not decoded.  Each folder decodes on the
route the JAX loader takes for it (``folder_route``): an RGB folder whose
labelled files all end in .jpg/.jpeg goes to JAX's native libjpeg path
(``native.py:183-184``; the DCT-domain prescale ``prescale_min = 2 *
resize_dim`` when ``prescale`` is set, JAX ``data/bulk_load.py:133-150``; a
file libjpeg-turbo 2.1 cannot decode to RGB is dropped with its warning),
any other folder to ``cv2.imread`` at full scale (JAX
``data/bulk_load.py:90-100, 153-156``).  Files are read and decoded a chunk
at a time through ``ops/jpeg.decode_blobs``: JPEGs by the fast decode (the
C++ entropy decode on the host, J1 and J2 on ``device``), PNGs and BMPs by
``data/decode.py`` on a thread pool.  The loader emits RGB; with
``channel_order='bgr'`` it reproduces the reference's swapped channels.  An
optional on-disk cache of the decoded arrays (``decode_cache_dir``) has the
JAX package's layout, but its key carries this package's decode rule
(``decode.DECODE_RULE``) and the prescale, so a cache that the JAX package
wrote with its own decoder is never read here, nor this package's there.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..taxonomy import CORRUPT_IMAGES, convert_to_coarse_label
from .decode import DECODE_RULE
from .index import LabelIndex
from .pipeline import ImageArrayDataset

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
# files read and decoded together: bounds the raw bytes held at once and
# the pinned coefficient staging (a 12 MP 4:2:0 photo is 18 M coefficients
# at full scale)
JPEG_CHUNK = 16


def folder_route(names: Sequence[str], channel_order: str = "rgb") -> str:
    """The JAX loader's route for a folder's labelled files: "native" for
    an RGB load of files that all end in .jpg/.jpeg (tested by name, as
    ``native_bulk_decode_resize`` does), else "imread"."""
    if channel_order == "rgb" and names and all(
            n.lower().endswith((".jpg", ".jpeg")) for n in names):
        return "native"
    return "imread"


def decode_files(paths: Sequence[str], resize_dim: int,
                 channel_order: str = "rgb", prescale: bool = False,
                 num_workers: int = 0, device=None
                 ) -> List[Optional[np.ndarray]]:
    """Files -> one [resize_dim, resize_dim, 3] uint8 array in
    ``channel_order`` each, or None for a file that is missing or that the
    route does not read.  The route is the JAX loader's for these files
    as one folder (``folder_route``); the prescale applies on the native
    route only.  ``JPEG_CHUNK`` files at a
    time are read on a thread pool and decoded by ``ops/jpeg.decode_blobs``
    (JPEGs on ``device``, the card by default), so one chunk's bytes is
    held at a time."""
    import torch

    from ..backend import resolve_device
    from ..ops.jpeg import decode_blobs

    device = resolve_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    workers = num_workers if num_workers > 0 else min(32, os.cpu_count() or 4)
    route = folder_route([os.path.basename(p) for p in paths], channel_order)
    prescale_min = 2 * resize_dim if prescale and route == "native" else 0

    def read(path):
        try:
            return Path(path).read_bytes()
        except OSError:
            return b""

    out: List[Optional[np.ndarray]] = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for start in range(0, len(paths), JPEG_CHUNK):
            chunk = paths[start:start + JPEG_CHUNK]
            images = decode_blobs(
                list(pool.map(read, chunk)), resize_dim, route, prescale_min,
                device, workers, stream, pool)
            out.extend(None if img is None else np.ascontiguousarray(
                img[:, :, ::-1] if channel_order == "bgr" else img)
                for img in images)
    return out


def load_folder(folder_path: str | Path, index_file_name: str,
                resize_dim: int, channel_order: str = "rgb",
                num_workers: int = 0, verbose: bool = False,
                prescale: bool = False, device=None) -> ImageArrayDataset:
    """Load every labelled, non-corrupt image in a folder into RAM, on the
    route the JAX loader takes for the folder (``folder_route``; JPEGs
    through the fast decode on ``device``, the card by default;
    ``prescale``: the JAX native path's DCT-domain decode)."""
    folder = Path(folder_path)
    index = LabelIndex(folder / index_file_name, verbose=verbose)
    image_files = sorted(
        f for f in os.listdir(folder)
        if f.lower().endswith(_IMAGE_EXTS) and f not in CORRUPT_IMAGES)

    todo: List[Tuple[str, object]] = []
    for f in image_files:
        rec = index.lookup(f)
        if rec is not None and rec.plot_label is not None:
            todo.append((f, rec))
        elif verbose:
            print(f"Image {f} not found or has no BH PLOT")

    decoded = decode_files([str(folder / f) for f, _ in todo], resize_dim,
                           channel_order, prescale, num_workers, device)

    images, labels, l2_labels, poly_labels = [], [], [], []
    plot_word_labels, poly_word_labels = [], []
    file_names, plot_idx = [], []
    for (f, rec), img in zip(todo, decoded):
        if img is None:
            print(f"Warning: Could not read image {f}")
            continue
        images.append(img)
        labels.append(rec.plot_label)
        l2_labels.append(convert_to_coarse_label(rec.plot_word_label))
        poly_labels.append(rec.poly_label if rec.poly_label is not None else -1)
        plot_word_labels.append(rec.plot_word_label)
        poly_word_labels.append(rec.poly_word_label)
        file_names.append(f)
        plot_idx.append(rec.plot_id)

    n = len(images)
    images_arr = (np.stack(images, 0) if n else
                  np.zeros((0, resize_dim, resize_dim, 3), np.uint8))
    return ImageArrayDataset(
        images=images_arr,
        labels=np.asarray(labels, np.int64),
        l2_labels=np.asarray(l2_labels, np.int64),
        poly_labels=np.asarray(poly_labels, np.int64),
        plot_word_labels=plot_word_labels,
        poly_word_labels=poly_word_labels,
        file_names=file_names,
        plot_idx=plot_idx,
        image_sources=[str(folder)] * n,
    )


def decode_cache_key(folder_paths: Sequence[str],
                     index_file_names: Sequence[str], resize_dim: int,
                     channel_order: str, prescale: bool = False) -> str:
    """The decoded-array cache key: the folders, their image listings and
    index CSVs' (size, mtime), the resize, the channel order, this
    package's decode rule and the prescale."""
    content = []
    for folder, idx_name in zip(folder_paths, index_file_names):
        fp = Path(folder)
        content.append(sorted(
            f.name for f in fp.iterdir()
            if f.suffix.lower() in _IMAGE_EXTS) if fp.is_dir() else [])
        ip = fp / idx_name
        st = ip.stat() if ip.is_file() else None
        content.append([st.st_size, st.st_mtime_ns] if st else None)
    return hashlib.sha1(json.dumps(
        [list(map(str, folder_paths)), list(index_file_names), resize_dim,
         channel_order, DECODE_RULE, bool(prescale), content]).encode()
    ).hexdigest()[:16]


def load_folders(folder_paths: Sequence[str],
                 index_file_names: Sequence[str], resize_dim: int,
                 channel_order: str = "rgb", num_workers: int = 0,
                 cache_dir: Optional[str] = None, verbose: bool = False,
                 prescale: bool = False, device=None) -> ImageArrayDataset:
    """Load + merge several folders (JPEGs decoded on ``device``, the card
    by default); optional decoded-array disk cache."""
    if len(folder_paths) != len(index_file_names):
        raise ValueError("folder_paths and index_file_names length mismatch")
    cpath = None
    if cache_dir is not None:
        key = decode_cache_key(folder_paths, index_file_names, resize_dim,
                               channel_order, prescale)
        cpath = Path(cache_dir) / f"bulk_{key}"
        if (cpath / "images.npy").is_file():
            return _load_cache(cpath)

    ds: Optional[ImageArrayDataset] = None
    for folder, idx_name in zip(folder_paths, index_file_names):
        part = load_folder(folder, idx_name, resize_dim, channel_order,
                           num_workers, verbose, prescale=prescale,
                           device=device)
        ds = part if ds is None else ds.concat(part)
    assert ds is not None

    if cpath is not None:
        _save_cache(cpath, ds)
    return ds


def _save_cache(cpath: Path, ds: ImageArrayDataset) -> None:
    cpath.mkdir(parents=True, exist_ok=True)
    np.save(cpath / "images.npy", ds.images)
    np.save(cpath / "labels.npy", ds.labels)
    np.save(cpath / "l2_labels.npy", ds.l2_labels)
    np.save(cpath / "poly_labels.npy", ds.poly_labels)
    meta = {
        "plot_word_labels": ds.plot_word_labels,
        "poly_word_labels": ds.poly_word_labels,
        "file_names": ds.file_names,
        "plot_idx": [p if isinstance(p, (int, str)) else str(p)
                     for p in (int(p) if isinstance(p, np.integer) else p
                               for p in ds.plot_idx)],
        "image_sources": ds.image_sources,
        "decode_rule": DECODE_RULE,
    }
    (cpath / "meta.json").write_text(json.dumps(meta))


def _load_cache(cpath: Path) -> ImageArrayDataset:
    meta = json.loads((cpath / "meta.json").read_text())
    return ImageArrayDataset(
        images=np.load(cpath / "images.npy", mmap_mode="r"),
        labels=np.load(cpath / "labels.npy"),
        l2_labels=np.load(cpath / "l2_labels.npy"),
        poly_labels=np.load(cpath / "poly_labels.npy"),
        plot_word_labels=meta["plot_word_labels"],
        poly_word_labels=meta["poly_word_labels"],
        file_names=meta["file_names"],
        plot_idx=meta["plot_idx"],
        image_sources=meta["image_sources"],
    )
