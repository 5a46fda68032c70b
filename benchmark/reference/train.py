"""The fine-tune step in plain float32: the train augment, the vision tower
with its frozen bottom blocks, the text head recomputed from the text tower
every step, the cross-entropy of ``100 * cos`` logits, Adam.

Which parameters train follows open_clip's group locking: the vision tower
is groups 0 (the stem), 1..L (the blocks) and L+1 (``ln_post`` and the head:
``proj`` or the MAP head), the text tower 0 (the embeddings and SigLIP's
dense ``head``), 1..L (the blocks), L+1 (``ln_final`` and CLIP's
``text_projection``); the last ``unlocked_groups`` vision groups train, and
with ``tune_text`` the last ``unlocked_text_layers`` text groups.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import towers
from .augment import augment


def _group(path: List[str], layers: int, head_names) -> int:
    if path[0] == "transformer":
        return 1 + int(path[2])
    if path[0] in head_names:
        return layers + 1
    return 0


def trainable(names, cfg: dict, unlocked_groups: int, tune_text: bool,
              unlocked_text_layers: int) -> List[str]:
    lv = cfg["vision"]["num_hidden_layers"]
    lt = cfg["text"]["num_hidden_layers"]
    out = []
    for name in names:
        top, *path = name.split(".")
        if top == "visual":
            g = _group(path, lv, ("ln_post", "proj", "attnpool"))
            ok = g >= lv + 2 - unlocked_groups
        elif top == "text":
            g = _group(path, lt, ("ln_final", "text_projection"))
            ok = tune_text and g >= lt + 2 - unlocked_text_layers
        else:
            ok = False
        if ok:
            out.append(name)
    return out


def frozen_blocks(cfg: dict, unlocked_groups: int) -> int:
    lv = cfg["vision"]["num_hidden_layers"]
    return max(0, min(lv, lv + 1 - unlocked_groups))


def train_steps(cfg: dict, params: Dict[str, torch.Tensor], batches,
                generators, tokens, n_classes: int, per_class: int,
                settings: dict) -> dict:
    """Run ``len(batches)`` steps from ``params`` (float32, or
    ``towers.Lowered`` for the control, ``towers.Bf16`` in bfloat16);
    returns each step's loss, each trainable leaf's first gradient (on the
    host) and its norm, each leaf's change norm after the last step, and
    how many elements the first step moved by less than half the learning
    rate.  ``batches`` are (uint8 images, labels) on the device."""
    towers.full_fp32()
    names = trainable(params, cfg, settings["unlocked_groups"],
                      settings["tune_text"], settings["unlocked_text_layers"])
    base = dict(params.items())          # the stored tensors, not reads
    raw = {n: p.clone().requires_grad_(True) if n in names else p
           for n, p in base.items()}
    leaves = params.like(raw) if hasattr(params, "like") else raw
    opt = torch.optim.Adam([raw[n] for n in names], lr=settings["lr"],
                           betas=(0.9, 0.999), eps=1e-8)
    n_frozen = frozen_blocks(cfg, settings["unlocked_groups"])
    mean, std = towers.pixel_stats(cfg)
    res = cfg["vision"]["image_size"]
    losses, grads = [], {}
    for step, ((images, labels), gen) in enumerate(zip(batches, generators)):
        x = augment(images, gen, res, mean, std)
        with torch.no_grad():
            h = towers.image_features(x, leaves, cfg, stop=n_frozen)
        emb = towers.image_features(x, leaves, cfg, start=n_frozen, tokens=h)
        head = towers.text_head(tokens, leaves, cfg, n_classes, per_class)
        loss = F.cross_entropy(towers.classify_logits(emb, head),
                               labels.long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if step == 0:
            grads = {n: raw[n].grad.detach().cpu() for n in names}
        opt.step()
        if step == 0:
            small = sum(int(((raw[n].detach() - base[n]).abs()
                             < settings["lr"] / 2).sum()) for n in names)
        losses.append(float(loss.detach()))
    change = {n: float((raw[n].detach() - base[n]).norm()) for n in names}
    return {"losses": losses, "grads": grads,
            "first_grad": {n: float(g.norm()) for n, g in grads.items()},
            "change": change, "trainable": names, "frozen_blocks": n_frozen,
            "first_small": small}
