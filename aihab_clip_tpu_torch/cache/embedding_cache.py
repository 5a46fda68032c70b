"""Post-projection embedding cache (counterpart of
``aihab_clip_tpu/cache/embedding_cache.py``), the same layout:

    <cache_embeddings_dir>/<backbone>_<dataset>/<split>/seed<seed>/
        embeddings.npy   [N, dim] fp32 (optionally L2-normalized)
        labels.npy       [N] int32
        metadata.csv     file_name, ground-truth L3 num/word label, L2 label
        meta.json        timestamp, split, dims, normalization, checkpoint

The split is encoded by ``eval_transform`` -> ``encode_image_fastest`` (the
block kernels on the card) in the model's compute dtype; the CSV is written
with the ``csv`` module as ``DataFrame.to_csv(index=False)`` writes it.
"""

from __future__ import annotations

import csv
import io
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..data.index import parse_csv_columns
from .array_store import is_remote_root, join_cache_path, open_store
from .feature_cache import resolve_model_name

CacheDir = Union[str, Path]

METADATA_COLUMNS = [
    "file_name",
    "ground_truth_num_label",
    "ground_truth_word_label",
    "ground_truth_L2_num_label",
]


def embedding_cache_dir(cfg, split: str) -> CacheDir:
    root = cfg.get("root_path", "./")
    ft_cfg = cfg.get("finetune", {})
    out_root = ft_cfg.get("cache_embeddings_dir", "feat_cache_vis")
    if is_remote_root(out_root):
        pass  # an absolute URI wins
    elif is_remote_root(root):
        out_root = join_cache_path(root, str(out_root))
    elif not Path(out_root).is_absolute():
        out_root = Path(root) / out_root
    backbone = resolve_model_name(cfg)
    dataset = cfg.get("dataset", "cs")
    seed = int(cfg.get("seed", 1) or 1)
    return join_cache_path(out_root, f"{backbone}_{dataset}",
                           str(split).lower(), f"seed{seed}")


@torch.inference_mode()
def cache_embeddings(cfg, model, view, resolution: int, split: str = "test",
                     checkpoint_path: Optional[str] = None,
                     compute_dtype=torch.float32) -> CacheDir:
    """Encode a split with the (fine-tuned) model and persist embeddings,
    labels and metadata.  ``model`` lives on its device."""
    from ..models.fast_vit import encode_image_fastest, pack_fastest
    from ..ops.preprocess import eval_transform, normalize_stats_for

    config = model.config
    dev = model.logit_scale.device
    nmean, nstd = normalize_stats_for(config)
    do_normalize = bool(cfg.get("finetune", {}).get(
        "cache_embeddings_normalize", True))
    cache_dir = embedding_cache_dir(cfg, split)
    store = open_store(cache_dir)
    store.ensure()
    packed = (pack_fastest(model, config, compute_dtype)
              if dev.type == "cuda" else None)

    feats, labels, rows = [], [], []
    for batch in view.batches():
        x = eval_transform(torch.from_numpy(batch.images).to(dev), resolution,
                           dtype=compute_dtype, mean=nmean, std=nstd)
        _, post = encode_image_fastest(model, x, config, project=True,
                                       packed=packed)
        post = post.float()
        if do_normalize:
            post = post / post.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        feats.append(post[torch.from_numpy(batch.valid).to(dev)])
        labels.append(batch.labels[batch.valid])
        for meta, lbl in zip(view.metadata_rows(batch.indices),
                             batch.labels[batch.valid]):
            rows.append([meta.get("file_name", ""), int(lbl),
                         meta.get("plot_word_label", ""),
                         meta.get("l2_label", -1)])

    feats_all = torch.cat(feats).cpu().numpy().astype(np.float32)
    labels_all = np.concatenate(labels, 0).astype(np.int32)
    store.save("embeddings", feats_all)
    store.save("labels", labels_all)
    text = io.StringIO()
    writer = csv.writer(text, lineterminator="\n")
    writer.writerow(METADATA_COLUMNS)
    writer.writerows(rows)
    store.write_text("metadata.csv", text.getvalue())
    info = {
        "timestamp": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        "split": str(split),
        "normalized": do_normalize,
        "num_samples": int(feats_all.shape[0]),
        "dim": int(feats_all.shape[1]),
        "checkpoint_path": str(checkpoint_path) if checkpoint_path else None,
        "cache_dir": str(cache_dir),
    }
    store.write_json("meta.json", info)
    print("\n==== Embedding Cache ====")
    print({k: info[k] for k in ("cache_dir", "num_samples", "dim",
                                "normalized")})
    return cache_dir


def load_embedding_cache(cache_dir: CacheDir) -> Dict:
    """Strict load with row/label cross-checks.  ``metadata`` is {column:
    values}, typed as ``pd.read_csv`` types them."""
    store = open_store(cache_dir)
    emb = np.asarray(store.load("embeddings"))
    labels = np.asarray(store.load("labels"))
    meta = parse_csv_columns(store.read_text("metadata.csv"))
    info = store.read_json("meta.json")
    n_meta = len(next(iter(meta.values()))) if meta else 0
    if emb.shape[0] != labels.shape[0]:
        raise ValueError(
            f"embeddings rows ({emb.shape[0]}) != labels rows ({labels.shape[0]})")
    if n_meta != emb.shape[0]:
        raise ValueError(
            f"metadata rows ({n_meta}) != embeddings rows ({emb.shape[0]})")
    if "ground_truth_num_label" in meta and not np.array_equal(
            np.asarray(meta["ground_truth_num_label"]), labels):
        raise ValueError("metadata labels disagree with labels.npy")
    return {"embeddings": emb, "labels": labels, "metadata": meta,
            "info": info}
