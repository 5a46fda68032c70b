"""Pipeline-parallel PEFT train step (counterpart of
``aihab_clip_tpu/train/pipeline_peft.py``).

The visual transformer blocks run pipeline-parallel over the ``stage``
axis (``parallel/pipeline.py``): each stage rank holds its group of blocks
as trainable [layers_per_stage, ...] parameters, microbatches stream
through the GPipe schedule, and the backward runs it in reverse.  Compose
with data parallelism through ``make_pipeline_mesh(n_stages,
data_parallel=d)``.

Freezing works as in JAX: every stage runs its whole group, so the lock
mask is applied to the stacked gradients.  Adam (``weight_decay=0``) on an
always-zero gradient keeps its moments at zero and moves nothing, so the
masked layers stay bit-identical.  The trainable head (``ln_post`` and
``proj``) is the model's own; the stem and the text tower stay frozen (the
text head is recomputed, with no gradient to take, under ``tune_text``).
The objective is the PEFT step's own (``peft._build_loss_fn``) with the
pipelined encode in place of the tower's.  The
optimizer is built over the trainable tensors, so the step takes them
when it is built and updates them in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..parallel.pipeline import (STAGE_AXIS, pipeline_encode,
                                 place_stage_params, stack_stage_params)
from .peft import PEFTConfig, _build_loss_fn

HEAD_LEAVES = ("ln_post", "proj")


def stacked_layer_mask(n_layers: int, n_stages: int,
                       unlocked_layers: int) -> torch.Tensor:
    """[stages, layers_per_stage] bool: True for the last
    ``unlocked_layers`` global layers (open_clip's ``lock_image_tower``
    order)."""
    per = n_layers // n_stages
    gidx = np.arange(n_layers).reshape(n_stages, per)
    return torch.from_numpy(gidx >= (n_layers - unlocked_layers))


def split_head_params(model) -> Dict[str, torch.nn.Parameter]:
    """The trainable non-block visual leaves (``ln_post`` and the
    projection), the model's own parameters by name below ``visual``."""
    return {n: p for n, p in model.visual.named_parameters()
            if n.split(".")[0] in HEAD_LEAVES}


def init_pipeline_trainable(model, ccfg, mesh, *,
                            train_head: bool = True) -> Dict[str, Any]:
    """The stacked blocks of this rank's stage (``place_stage_params``)
    and, with ``train_head``, the head leaves; the model's parameters are
    frozen but for the head."""
    n_stages = mesh.shape[STAGE_AXIS]
    blocks = place_stage_params(
        mesh, stack_stage_params(model, ccfg.vision_layers, n_stages))
    model.requires_grad_(False)
    out: Dict[str, Any] = {"blocks": blocks}
    if train_head:
        out["head"] = split_head_params(model)
        for p in out["head"].values():
            p.requires_grad_(True)
    return out


def make_pipeline_train_step(model, cfg: PEFTConfig,
                             text_weights: Optional[torch.Tensor],
                             prompt_tokens: Optional[torch.Tensor], mesh, *,
                             num_microbatches: int, unlocked_layers: int,
                             trainable: Dict[str, Any]):
    """Returns (opt, step): Adam (optax's defaults, no weight decay) over
    ``trainable`` (``init_pipeline_trainable``), and ``step(images_u8,
    labels, valid, generator, lr) -> {loss, correct, n_valid}``, the same
    contract as ``peft.make_train_step``'s.  Every rank passes the global
    batch and the same generator; the loss is the global batch's."""
    ccfg = model.config
    n_stages = mesh.shape[STAGE_AXIS]
    mask = stacked_layer_mask(ccfg.vision_layers, n_stages,
                              unlocked_layers)[mesh.coords[STAGE_AXIS]]
    mask = mask.to(mesh.device)
    params = list(trainable["blocks"].values()) + list(
        trainable.get("head", {}).values())
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0)

    def encode(x):
        return pipeline_encode(model, trainable["blocks"], x, ccfg, mesh,
                               num_microbatches=num_microbatches,
                               project=True, dtype=cfg.compute_dtype)[1]

    loss_fn = _build_loss_fn(model, cfg, text_weights, prompt_tokens,
                             encode=encode)

    def step(images_u8, labels, valid, generator, lr):
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss, (correct, n_valid) = loss_fn(images_u8, labels, valid,
                                           generator)
        loss.backward()
        with torch.no_grad():
            for leaf in trainable["blocks"].values():
                if leaf.grad is not None:
                    leaf.grad.mul_(mask.view(-1, *(1,) * (leaf.ndim - 1))
                                   .to(leaf.grad.dtype))
        opt.step()
        return {"loss": loss.detach(), "correct": correct, "n_valid": n_valid}

    return opt, step
