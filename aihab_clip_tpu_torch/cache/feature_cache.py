"""Pre-projection feature cache (counterpart of
``aihab_clip_tpu/cache/feature_cache.py``), the same layout:

    <root>/features_<backbone>_<dataset>/<shots>_shot/seed<seed>/
        f{v}.npy      per-view pre-projection features   [N, pre_dim] fp16
        label.npy     labels (written once)              [N] int32
        manifest.json shapes / dtype / views / write rate

Each view ``v`` is one augmentation pass of the train split in
deterministic split order, so every ``f{v}`` aligns with the one label
file.  ``cache_features_from_loader`` encodes a batch as the config's
train augment (``aug_impl``: ``fast_train_transform``, or the exact
``train_transform``; its draws from a ``torch.Generator`` seeded per (seed,
view, batch): other crops and angles than JAX's ``fold_in`` keys)
-> ``encode_image_fastest`` (on the card: K1 per block over a pack built
once; a ModifiedResNet's folded convs, ``width * 32`` wide: 2,048 at RN50)
-> fp16 on the device.  The JAX writer's lag-1 fetch is dropped: the
features of a view stay on the device and come to the host in one copy at
the view's end, so the host's gather and upload of the next batch already
run while the card computes.

Multi-process shards (``shard_count > 1``, by default the process group's
size, ``shard_index`` its rank): each process encodes a deterministic,
disjoint shard of the split (``parallel.distributed.process_shard_indices``,
JAX's permutation) and writes ``f{v}.shard{k}``, ``label.shard{k}`` and
``manifest.shard{k}.json``, the JAX package's layout; the readers merge
shards in order (JAX's shard sets too).  The runner waits on a barrier
before anyone reads.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .array_store import join_cache_path, open_store

CacheDir = Union[str, Path]


def canonical_backbone_name(backbone: str) -> str:
    """Backbone name -> cache folder name (the reference's scheme)."""
    if not backbone:
        return "unknown"
    if backbone == "ViT-B/16":
        return "ViTB16"
    if backbone == "ViT-B/32":
        return "ViTB32"
    name = backbone.replace("hf-hub:", "hf-hub_")
    return name.replace("/", "_").replace(" ", "_").replace(":", "_")


def resolve_model_name(cfg, default_backend: str = "openai",
                       default_backbone: str = "RN50") -> str:
    """Config -> canonical model name, shared by the feature cache, the
    embedding cache and checkpoint naming."""
    backend = str(cfg.get("clip_backend", default_backend)).lower()
    if backend == "openclip":
        raw = cfg.get("open_clip_model", cfg.get("backbone", default_backbone))
    else:
        raw = cfg.get("backbone", default_backbone)
    return canonical_backbone_name(str(raw))


def feature_cache_dir(cfg) -> CacheDir:
    root = cfg.get("root_path", "./")
    backbone = resolve_model_name(cfg)
    dataset = cfg.get("dataset", "cs")
    shots = int(cfg.get("shots", 0) or 0)
    seed = int(cfg.get("seed", 1) or 1)
    return join_cache_path(root, f"features_{backbone}_{dataset}",
                           f"{shots}_shot", f"seed{seed}")


def feature_cache_exists(cache_dir: CacheDir, aug_views: int) -> bool:
    store = open_store(cache_dir)
    if not store.exists("label"):
        return False
    return all(store.exists(f"f{v}") for v in range(aug_views))


def write_preprojection_cache(
        cache_dir: CacheDir,
        encode_view: Callable[[int], Tuple[np.ndarray, np.ndarray]],
        aug_views: int, expected_n: Optional[int] = None,
        feature_dtype=np.float16, shard_index: Optional[int] = None,
        shard_count: Optional[int] = None) -> Dict:
    """Write the cache: ``encode_view(v)`` returns (features [N, D],
    labels [N]) for view ``v``.  Each view is reloaded and checked (shape,
    rows against labels, expected count) and ``manifest.json`` records it;
    with ``shard_index`` every name takes ``.shard{k}``."""
    store = open_store(cache_dir)
    store.ensure()
    suffix = "" if shard_index is None else f".shard{shard_index}"
    manifest: Dict = {"views": [], "aug_views": aug_views,
                      "shard_index": shard_index,
                      "shard_count": shard_count}
    t0 = time.perf_counter()
    total_bytes = 0
    labels_ref: Optional[np.ndarray] = None
    for v in range(aug_views):
        feats, labels = encode_view(v)
        if feats.dtype != feature_dtype:
            feats = np.asarray(feats, dtype=feature_dtype)
        labels = np.asarray(labels, dtype=np.int32)
        fpath = store.save(f"f{v}{suffix}", feats)
        total_bytes += feats.nbytes
        if v == 0:
            labels_ref = labels
            lpath = store.save(f"label{suffix}", labels)
            total_bytes += labels.nbytes
            print(f"[cache] labels -> {lpath} "
                  f"shape={labels.shape} unique={len(np.unique(labels))}")
        loaded = store.load(f"f{v}{suffix}", mmap=True)
        ok_shape = loaded.shape == feats.shape
        ok_count = feats.shape[0] == labels_ref.shape[0]
        ok_expected = expected_n is None or feats.shape[0] == expected_n
        print(f"[cache] view {v} -> {fpath} shape={feats.shape} "
              f"dtype={feats.dtype} reload_ok={ok_shape} "
              f"rows_match_labels={ok_count} rows_match_expected={ok_expected}")
        if not (ok_shape and ok_count and ok_expected):
            raise RuntimeError(
                f"Feature cache validation failed for view {v}: "
                f"reload_ok={ok_shape} rows_match_labels={ok_count} "
                f"rows_match_expected={ok_expected} "
                f"(got {feats.shape[0]} rows, expected {expected_n})")
        manifest["views"].append({"file": f"f{v}{suffix}",
                                  "shape": list(feats.shape),
                                  "dtype": str(feats.dtype)})
    dt = time.perf_counter() - t0
    manifest.update({
        "n": int(labels_ref.shape[0]),
        "dim": int(manifest["views"][0]["shape"][1]),
        "write_seconds": dt,
        "write_gbps": total_bytes / max(dt, 1e-9) / 1e9,
    })
    store.write_json(f"manifest{suffix}.json", manifest)
    print("\nFeature caching complete.")
    return manifest


def _shard_names(store, stem: str) -> List[str]:
    names = [n for n in store.list_arrays(f"{stem}.shard")
             if n.startswith(f"{stem}.shard")]
    return sorted(names, key=lambda n: int(n.split("shard")[-1]))


def _load_maybe_sharded(store, stem: str, mmap: bool = False):
    """One array, or its shards (``{stem}.shard{k}``) concatenated in
    order; an incomplete shard set raises."""
    if store.exists(stem):
        return store.load(stem, mmap=mmap)
    shards = _shard_names(store, stem)
    if not shards:
        raise FileNotFoundError(f"no cache array '{stem}' in {store.root}")
    idx = [int(n.split("shard")[-1]) for n in shards]
    if idx != list(range(len(idx))):
        raise RuntimeError(
            f"cache '{stem}' has non-contiguous shards {idx} in "
            f"{store.root} — a writer shard is missing or still running")
    expected = None
    for k in idx:
        try:
            expected = store.read_json(f"manifest.shard{k}.json").get(
                "shard_count")
            if expected:
                break
        except (OSError, ValueError):
            continue
    if expected and len(idx) != int(expected):
        raise RuntimeError(
            f"cache '{stem}' has {len(idx)} shards but the writer fleet "
            f"had {expected} processes")
    return np.concatenate([store.load(n) for n in shards], axis=0)


def read_preprojection_cache(cache_dir: CacheDir, aug_views: int,
                             max_label: Optional[int] = None,
                             mmap: bool = True
                             ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Cached views + labels; rows whose label is >= ``max_label`` are
    dropped.  Reads single-file and sharded views alike."""
    store = open_store(cache_dir)
    for v in range(aug_views):
        for nm in [f"f{v}"] + _shard_names(store, f"f{v}"):
            store.prefetch(nm)
    labels = np.asarray(_load_maybe_sharded(store, "label"))
    keep = None
    if max_label is not None and (labels >= max_label).any():
        keep = np.where(labels < max_label)[0]
        labels = labels[keep]
    views = []
    for v in range(aug_views):
        arr = _load_maybe_sharded(store, f"f{v}", mmap=mmap)
        views.append(np.asarray(arr) if keep is None else np.asarray(arr[keep]))
    return views, labels


def feature_cache_exists_sharded(cache_dir: CacheDir, aug_views: int) -> bool:
    """Like ``feature_cache_exists`` but accepts per-process shard layouts."""
    store = open_store(cache_dir)
    if not (store.exists("label") or _shard_names(store, "label")):
        return False
    return all(store.exists(f"f{v}") or _shard_names(store, f"f{v}")
               for v in range(aug_views))


def view_generator(seed: int, view: int, batch: int) -> torch.Generator:
    """The augmentation draws of one cached batch: a distinct stream per
    (seed, view, batch), as JAX folds the view and batch into its key."""
    return torch.Generator().manual_seed(
        ((seed * 100003 + view) * 1000003 + batch) % (2 ** 63))


def augmentation_settings(cfg) -> Dict:
    """The train augmentation of the config: crop mode, flip, rotation."""
    aug = cfg["data"]["preprocessing"].get("augmentations", {}) or {}
    crop = ("bottom" if aug.get("bottom_crop", False)
            else "random" if aug.get("random_crop", False) else "center")
    return {"crop_mode": crop, "flip": bool(aug.get("flip", False)),
            "rotation": bool(aug.get("rotation", False))}


def cache_features_from_loader(cfg, model, train_view, resolution: int,
                               info: Dict, compute_dtype=torch.bfloat16,
                               shard_index: Optional[int] = None,
                               shard_count: Optional[int] = None,
                               packed=None) -> Dict:
    """Run the train split through the frozen encoder once per view (see
    the module docstring) and write the cache.  ``model`` lives on its
    device; ``packed`` is ``pack_fastest``'s pack, built here on the card
    when not given.  ``shard_count`` (default the process group's size)
    > 1 writes shard ``shard_index`` (default this rank) alone."""
    from ..data.pipeline import SplitView
    from ..models.fast_vit import encode_image_fastest, pack_fastest
    from ..ops.preprocess import normalize_stats_for
    from ..train.peft import train_augment

    from ..parallel.distributed import (process_shard_indices, rank,
                                        world_size)

    config = model.config
    dev = model.logit_scale.device
    nmean, nstd = normalize_stats_for(config)
    cache_dir = feature_cache_dir(cfg)
    aug_views = int(cfg.get("aug_views", 1) or 1)
    seed = int(cfg.get("seed", 1) or 1)
    aug = augmentation_settings(cfg)
    aug_fn = train_augment(cfg.get("aug_impl", "fast"))
    cache_view = SplitView(train_view.dataset, train_view.indices,
                           train_view.batch_size, shuffle=False,
                           use_l2_label=train_view.use_l2_label)
    shard_count = int(world_size() if shard_count is None else shard_count)
    expected_n = info.get("train_size")
    if shard_count > 1:
        shard_index = int(rank() if shard_index is None else shard_index)
        pos = process_shard_indices(cache_view.num_samples, seed=seed,
                                    process_index=shard_index,
                                    process_count=shard_count)
        cache_view = SplitView(cache_view.dataset, cache_view.indices[pos],
                               cache_view.batch_size, shuffle=False,
                               use_l2_label=cache_view.use_l2_label)
        expected_n = cache_view.num_samples
    else:
        shard_index = None
    print("\n==== Feature Caching (pre-projection) ====")
    print({"cache_dir": str(cache_dir), "aug_views": aug_views,
           "expected_train_size": info.get("train_size"),
           "shard": (None if shard_index is None
                     else f"{shard_index}/{shard_count}"),
           "crop_mode": aug["crop_mode"]})
    if packed is None and dev.type == "cuda":
        packed = pack_fastest(model, config, compute_dtype)

    @torch.inference_mode()
    def encode_view(v: int):
        feats, labels = [], []
        for bi, batch in enumerate(cache_view.batches()):
            images = torch.from_numpy(batch.images).to(dev)
            x = aug_fn(images, view_generator(seed, v, bi), resolution,
                       dtype=compute_dtype, mean=nmean, std=nstd, **aug)
            pre = encode_image_fastest(model, x, config, packed=packed)
            valid = torch.from_numpy(batch.valid).to(dev)
            feats.append(pre.to(torch.float16)[valid])
            labels.append(batch.labels[batch.valid])
        return (torch.cat(feats).cpu().numpy(),
                np.concatenate(labels, 0))

    return write_preprojection_cache(
        cache_dir, encode_view, aug_views, expected_n=expected_n,
        shard_index=shard_index,
        shard_count=shard_count if shard_count > 1 else None)
