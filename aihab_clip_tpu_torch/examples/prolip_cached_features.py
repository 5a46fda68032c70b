#!/usr/bin/env python
"""Example: ProLIP from cached features, step by step (counterpart of the
root ``examples/prolip_cached_features.py``).

Loads a pre-projection feature cache, trains the projector, and evaluates
on the test split, showing each stage explicitly; on ``--device`` (the
card by default; it raises without one unless ``--device cpu``).

Run after generating the synthetic dataset + cache:
    python -c "from aihab_clip_tpu_torch.data import \\
               make_synthetic_cs_dataset as m; m('./data', name='synth_cs')"
    python -m aihab_clip_tpu_torch --base_config configs/base.yaml \\
        --dataset_config configs/synthetic_smoke.yaml --device cpu --opts \\
        clip_backend openai backbone random:Tiny search_lr False \\
        save_features True aug_views 3 train_epoch 1
    python -m aihab_clip_tpu_torch.examples.prolip_cached_features \\
        --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..backend import resolve_device
from ..cache import (feature_cache_dir, feature_cache_exists,
                     read_preprojection_cache)
from ..config import load_configs
from ..data import build_loaders
from ..models.fast_vit import encode_image_fastest, pack_fastest
from ..ops.preprocess import eval_transform, normalize_stats_for
from ..runner import init_clip_and_text_head
from ..train.prolip import ProjectorSpec, projector_accuracy, train_projector


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = resolve_device(p.parse_args(argv).device)

    cfg = load_configs("configs/base.yaml", "configs/synthetic_smoke.yaml")
    cfg.clip_backend = "openai"
    cfg.backbone = "random:Tiny"
    cfg.aug_views = 3

    # 1) model + text head
    bundle = init_clip_and_text_head(cfg, device)
    print(f"model: {bundle['backbone_name']} ({bundle['source']}), "
          f"text head {tuple(bundle['text_weights'].shape)}")

    # 2) cached features
    cache_dir = feature_cache_dir(cfg)
    if not feature_cache_exists(cache_dir, cfg.aug_views):
        raise SystemExit(f"cache missing at {cache_dir}; see module docstring")
    views, labels = read_preprojection_cache(cache_dir, cfg.aug_views,
                                             max_label=20)
    print(f"cache: {len(views)} views of {views[0].shape} + labels "
          f"{labels.shape} from {cache_dir}")

    # 3) projector init from the model's own visual projection
    model = bundle["model"]
    init = ProjectorSpec.from_clip_model(model)
    tw = bundle["text_weights"].float()
    acc0 = projector_accuracy(init, views[0], labels, tw)
    print(f"pre-training (zero-shot projector) train-view acc: {acc0:.2f}%")

    # 4) train
    proj, stats = train_projector(views, labels, tw, init, lr=1e-3, lam=0.1,
                                  epochs=10, device=device)
    acc1 = projector_accuracy(proj, views[0], labels, tw)
    print(f"post-training train-view acc: {acc1:.2f}% "
          f"(final loss {stats['final_loss']:.4f})")

    # 5) test evaluation through the encoder (the block kernels on the card)
    loaders = build_loaders(cfg, device=device)
    config = model.config
    dtype = bundle["compute_dtype"]
    packed = pack_fastest(model, config, dtype) if device.type == "cuda" \
        else None
    mean, std = normalize_stats_for(config)
    feats, labs = [], []
    with torch.inference_mode():
        for batch in loaders.test.batches():
            x = eval_transform(torch.from_numpy(batch.images).to(device),
                               bundle["resolution"], dtype=dtype, mean=mean,
                               std=std)
            pre = encode_image_fastest(model, x, config, packed=packed)
            feats.append(pre.float()[torch.from_numpy(batch.valid)
                                     .to(device)].cpu().numpy())
            labs.append(batch.labels[batch.valid])
    acc_test = projector_accuracy(proj, np.concatenate(feats),
                                  np.concatenate(labs), tw)
    print(f"test accuracy: {acc_test:.2f}%")
    return {"acc0": acc0, "acc1": acc1, "acc_test": acc_test}


if __name__ == "__main__":
    main()
