"""The ViT-B/16 train steps against their references over several data
draws, on one card.

    python -m aihab_clip_tpu_torch.tools.step_spread [--draws 8]
    python -m aihab_clip_tpu_torch.tools.step_spread --path train [--draws 8]

``--path peft`` (the default): the default fine-tune on the offline
fallback tower, as ``chip_smoke.py`` drives it (``random:ViT-B/16`` from
seed 0, batch 16 at 224 from 439x439 uint8, random crop + rotation,
tune_text, unlocked_groups 11, text unlocked_layers 1, the default fused
prefix of 2 blocks).  For each draw d
the batch's images and labels come from numpy seed d and the augmentation
from ``step_generator(d, 0, 0)``; one step's loss and flattened trainable
gradient are taken with the K1 prefix, with the prefix's kernel plain, with
the fp32 canonical tower (no prefix), and with the int8 prefix (K14).  Prints
one JSON line per draw with the loss relative |d| and the gradient cosine of
the kernels' step against the plain one (``plain``) and the fp32 one
(``fp32``), and of the int8-prefix step against the bf16-prefix one
(``int8_prefix``); then a summary line with the largest loss reading and the
smallest cosine of each pair.  These readings set ``chip_smoke.py``'s
``VIT_STEP_GATES``.

``--path train``: path (b), ``vit_encode_train`` as ``chip_smoke.py`` drives
it (its 6e): every visual parameter of ``random:ViT-B/16`` (seed 0)
trainable, batch 16 of 224x224 uint8, a cross-entropy of 100 x cosine
logits against a random 20-class head; for each draw d the images, labels
and head come from numpy seed d.  One forward + backward's loss and
per-parameter gradients are taken with K17, with K17 plain and with the
fp32 canonical tower.  Prints one JSON line per draw with the loss relative
|d|, the least per-parameter gradient cosine and the whole gradient's
cosine of the K17 step against the plain one (``plain``) and the fp32 one
(``fp32``), then a summary line (largest loss reading, smallest cosines).
These readings set ``chip_smoke.py``'s ``TRAIN_GATES``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from unittest import mock

import numpy as np

B, DECODE, UNLOCKED = 16, 439, 11
TRAIN_B, TRAIN_RES, CLASSES = 16, 224, 20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--path", choices=("peft", "train"), default="peft")
    args = ap.parse_args()
    if args.path == "train":
        train_spread(args.draws)
    else:
        peft_spread(args.draws)


def train_spread(draws: int) -> None:
    import torch
    import torch.nn.functional as F

    from aihab_clip_tpu_torch.models import fast_vit
    from aihab_clip_tpu_torch.models.zoo import load
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops.preprocess import normalize

    dev = torch.device("cuda")
    model = load("random:ViT-B/16", dtype=torch.bfloat16, device=dev).model
    cfg = model.config
    params = list(model.visual.named_parameters())
    for _, p in params:
        p.requires_grad_(True)

    def step(encode, x, labels, head):
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(
            100.0 * F.normalize(encode(x).float(), dim=-1) @ head, labels)
        loss.backward()
        return loss.item(), [p.grad.float().flatten() for _, p in params]

    def fast(x):
        return fast_vit.vit_encode_train(model, x, cfg, project=True)[1]

    def canonical(x):
        return model.encode_image(x, project=True)[1]

    def pair(got, ref):
        (lk, gk), (lr, gr) = got, ref
        per = [F.cosine_similarity(a, b, dim=0).item() for a, b in zip(gk, gr)]
        return dict(loss_rel=abs(lk - lr) / abs(lr), grad_cos_min=min(per),
                    grad_cos=F.cosine_similarity(torch.cat(gk), torch.cat(gr),
                                                 dim=0).item())

    rows = []
    for d in range(draws):
        rng = np.random.default_rng(d)
        shape = (TRAIN_B, TRAIN_RES, TRAIN_RES, 3)
        u8 = torch.from_numpy(rng.integers(0, 256, shape,
                                           dtype=np.uint8)).to(dev)
        labels = torch.from_numpy(rng.integers(0, CLASSES, TRAIN_B)).to(dev)
        head = F.normalize(torch.from_numpy(rng.standard_normal(
            (cfg.embed_dim, CLASSES)).astype(np.float32)), dim=0).to(dev)
        x32 = normalize(u8, dtype=torch.float32)
        xb = x32.to(torch.bfloat16)
        kern = step(fast, xb, labels, head)
        with mock.patch.object(fast_vit, "mlp_block_train",
                               bk.mlp_block_train_plain):
            plain = step(fast, xb, labels, head)
        vis_dt = model.visual.dtype
        model.visual.dtype = torch.float32
        try:
            fp32 = step(canonical, x32, labels, head)
        finally:
            model.visual.dtype = vis_dt
        row = dict(draw=d, loss=kern[0], plain=pair(kern, plain),
                   fp32=pair(kern, fp32))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {name: dict(loss_rel_max=max(r[name]["loss_rel"] for r in rows),
                          grad_cos_min=min(r[name]["grad_cos_min"]
                                           for r in rows))
               for name in ("plain", "fp32")}
    print(json.dumps({"summary": summary, "path": "train", "draws": draws,
                      "card": torch.cuda.get_device_name(0)}))


def peft_spread(draws: int) -> None:
    import torch

    from aihab_clip_tpu_torch.models import build_text_head, fast_vit
    from aihab_clip_tpu_torch.models.zoo import load
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.train.peft import (
        PEFTConfig, _build_loss_fn, _pack_prefix, _quantize_prefix,
        build_lock_mask, peft_fused_prefix_len, step_generator)

    dev = torch.device("cuda")
    model = load("random:ViT-B/16", dtype=torch.bfloat16, device=dev).model
    mcfg = model.config
    n_prefix = peft_fused_prefix_len(mcfg, UNLOCKED, dev)
    prompts, tpc = gen_prompts(use_hierarchy=True, use_descriptive=True)
    tokens = build_text_head(model, prompts, 20, tpc)["prompt_tokens"]
    cfg = PEFTConfig(resolution=mcfg.image_resolution, num_classes=20,
                     lr=5e-5, epochs=1, crop_mode="random", rotation=True,
                     tune_text=True, num_templates=tpc,
                     compute_dtype=torch.bfloat16)
    mask = build_lock_mask(model, mcfg.vision_layers, mcfg.transformer_layers,
                           unlocked_groups=UNLOCKED, tune_text=True,
                           unlocked_text_layers=1)
    trainable = [p for n, p in model.named_parameters() if mask[n]]
    cfg_p = dataclasses.replace(cfg, fused_prefix=n_prefix)
    cfg8 = dataclasses.replace(cfg_p, prefix_quant=True)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                fused_prefix=0)
    pprefix, qprefix = _pack_prefix(model, cfg_p), _quantize_prefix(model,
                                                                     cfg8)

    def step(c, pp, batch, gen_seed):
        model.zero_grad(set_to_none=True)
        loss, _ = _build_loss_fn(model, c, None, tokens)(
            *batch, step_generator(gen_seed, 0, 0), pp)
        loss.backward()
        grad = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).float().flatten()
                          for p in trainable])
        return loss.item(), grad

    def fp32_step(batch, gen_seed):
        dts = model.visual.dtype, model.text.dtype
        model.visual.dtype = model.text.dtype = torch.float32
        try:
            return step(cfg32, None, batch, gen_seed)
        finally:
            model.visual.dtype, model.text.dtype = dts

    def pair(got, ref):
        (lk, gk), (lr, gr) = got, ref
        return dict(loss_rel=abs(lk - lr) / abs(lr), grad_cos=torch.nn.functional
                    .cosine_similarity(gk, gr, dim=0).item())

    rows = []
    for d in range(draws):
        rng = np.random.default_rng(d)
        labels = rng.integers(0, 20, B)
        images = rng.integers(0, 256, (B, DECODE, DECODE, 3), dtype=np.uint8)
        batch = (torch.from_numpy(images).to(dev),
                 torch.from_numpy(labels).to(dev),
                 torch.ones(B, dtype=torch.bool, device=dev))
        kern = step(cfg_p, pprefix, batch, d)
        with mock.patch.object(fast_vit, "full_block_fused",
                               bk.full_block_fused_plain):
            plain = step(cfg_p, pprefix, batch, d)
        row = dict(draw=d, loss=kern[0], plain=pair(kern, plain),
                   fp32=pair(kern, fp32_step(batch, d)),
                   int8_prefix=pair(step(cfg8, qprefix, batch, d), kern))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {name: dict(loss_rel_max=max(r[name]["loss_rel"] for r in rows),
                          grad_cos_min=min(r[name]["grad_cos"] for r in rows))
               for name in ("plain", "fp32", "int8_prefix")}
    print(json.dumps({"summary": summary, "path": "peft", "draws": draws,
                      "card": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
