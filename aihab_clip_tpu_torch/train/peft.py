"""PEFT: partial-unfreeze fine-tuning of a CLIP (ViT, ModifiedResNet or
ConvNeXt) or SigLIP tower (counterpart of ``aihab_clip_tpu/train/peft.py:
54-475, 561-1076``).

  * freezing follows open_clip's ``lock_image_tower(unlocked_groups)`` /
    ``lock_text_tower(unlocked_layers)``: groups are [stem] + resblocks (a
    ConvNeXt's blocks in depth order, each stage's downsample with its first
    block; a ModifiedResNet's four stages) + [head] and the last n unlock;
    a frozen BatchNorm's ``mean`` and ``var`` never train, at any depth
    (``PARITY.md``).  ``build_lock_mask`` maps the
    port's parameter names to that mask and sets ``requires_grad``, so
    autograd builds no graph below the earliest trainable layer.  SigLIP's
    text ``head`` Dense counts as group 0 (only ``ln_final``/
    ``text_projection`` are the text head, ``peft.py:98-105``), so at
    ``unlocked_text_layers=1`` only ``text.ln_final`` trains; the port
    keeps that;
  * a train step: the device-side augmentation (``ops/fast_warp``), the
    image encode (with a frozen prefix: for SigLIP ``siglip_encode_hybrid``,
    K5/K4 for the prefix, or with ``prefix_quant`` the int8 kernels
    K13/K9/K10, the canonical blocks with the fused attention kernel K6
    forward and backward for the rest; for a CLIP ViT ``vit_encode_hybrid``,
    K1 for the prefix, or with ``prefix_quant`` the int8 block K14, the
    canonical blocks for the rest; for a ConvNeXt ``convnext_encode_hybrid``,
    K7 for the prefix, with or without ``prefix_quant`` as in JAX, the
    canonical blocks for the rest; a ModifiedResNet runs its canonical
    module, with no scan and no fused prefix), fp32 L2 normalisation,
    the in-step text-head recompute when ``tune_text``, masked CE of
    ``100 * f @ T`` (``logit_scale`` is ignored, as in the reference), then
    Adam (optax's defaults: betas 0.9/0.999, eps 1e-8) over fp32 master
    parameters;
  * a cosine learning rate stepped per epoch, periodic validation
    (``val_interval``) and the final test through ``evaluate``.

The rest of JAX's finetune (``peft.py:477-1076``):
  * LoRA (``lora_rank`` > 0, ``train/lora.py``): the base tower wholly
    frozen, rank-r adapters train, every read of the weights (the step,
    ``evaluate``'s kernel pack, re-packed at each eval, the text head, the
    returned ``params``, checkpoints) sees W_eff; the fused prefix is off;
  * the scanned encodes (``scan_blocks``, ``scan_remat``);
  * the epoch regimes (``device_dataset``: the host loop, the split staged
    on the device, or chunks uploaded on a side stream), step for step the
    same training;
  * ``checkpoint_fn``, ``resume_from`` (bit for bit), graceful SIGTERM /
    SIGINT, ``profile_dir`` and a ``StepTimer``.

Under a ``mesh`` (``parallel.make_mesh``: ranks of ``torch.distributed``)
every rank draws the global batch and its augmentation alike, encodes its
rows of the data axis, divides its masked cross-entropy sum by the GLOBAL
valid count (JAX's ``masked_ce_metrics`` sees the whole batch; a mean per
rank averaged would be wrong whenever the shards hold different valid
counts, as at a padded last batch), and the gradients are summed over the
data axis.  A model axis > 1 cuts the blocks' qkv/``c_fc``/``out_proj``/
``c_proj`` by JAX's TP rules (``parallel/tensor.py``'s block forward; LoRA
refuses it, the fused prefix is off); ``fsdp`` also cuts every parameter
over the data axis (gathered for the step, gradients reduce-scattered,
Adam moments sharded; the fused prefix is off).  Under pure DP the fused
prefix runs the kernels per rank on its rows (JAX's ``_shard_mapped_
prefix``).  The ``device_dataset`` regimes are off under a mesh.
Checkpoints hold whole parameters and Adam moments, so a run resumes at
any world size.

The port trains the model's parameters in place (JAX returns new arrays).
Augmentation draws come from a ``torch.Generator`` seeded per (seed, epoch,
step), so they differ from ``jax.random``'s; the batch order is the JAX
package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..data.pipeline import SplitView
from ..models.siglip import SigLIPConfig
from ..models.text_head import compute_text_weights
from ..parallel import comm
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, batch_sharding
from ..parallel.tensor import tensor_parallel_blocks, tp_local
from .evaluate import evaluate, masked_ce_metrics
from .prolip import cosine_lr
from .tracker import ClassificationTracker

# ---------------------------------------------------------------------------
# Lock masks (open_clip lock_image_tower / lock_text_tower semantics)
# ---------------------------------------------------------------------------


def _vit_group_of(path: Tuple[str, ...], num_layers: int) -> int:
    """Group of a visual-tower parameter (path below ``visual``): 0 = stem
    (conv1, class/positional embedding, ln_pre), 1..L = resblocks, L+1 =
    head (ln_post, proj, SigLIP's attnpool)."""
    if path[0] == "transformer":                # transformer.resblocks.<i>
        return 1 + int(path[2])
    if path[0] in ("ln_post", "proj", "attnpool"):
        return num_layers + 1
    return 0


def _convnext_group_of(path: Tuple[str, ...], depths: Tuple[int, ...]) -> int:
    """Group of a ConvNeXt-tower parameter (``peft.py:80-95``): 0 = stem,
    1..sum(depths) = blocks in depth order (a stage's downsample belongs to
    its first block's group), the last = head (head_norm + projection)."""
    name = path[0]
    if name.startswith("stage"):                 # stage<s>_block<b>
        s, b = name[len("stage"):].split("_block")
        return 1 + sum(depths[:int(s)]) + int(b)
    if name.startswith(("down_norm_", "down_conv_")):
        return 1 + sum(depths[:int(name.rsplit("_", 1)[-1])])
    if name.startswith("head_"):
        return 1 + sum(depths)
    return 0                                     # stem_conv / stem_norm


def _rn_group_of(path: Tuple[str, ...]) -> int:
    """Group of a ModifiedResNet parameter (``peft.py:66-77``): 0 = stem
    (conv1-3, bn1-3), 1..4 = the stages (``layer<s>_<b>``), 5 = the
    attention pool."""
    if path[0].startswith("layer"):
        return int(path[0][len("layer"):].split("_")[0])
    if path[0] == "attnpool":
        return 5
    return 0


def _is_convnext(config) -> bool:
    return getattr(config, "tower", "vit") == "convnext"


def _visual_blocks(config) -> int:
    """L: the tower's block count (a ConvNeXt's or ResNet's over all its
    stages)."""
    return (config.vision_layers if config.is_vit
            else sum(config.vision_layers))


def _text_group_of(path: Tuple[str, ...], num_layers: int) -> int:
    """0 = embeddings (and SigLIP's ``head`` Dense), 1..L = resblocks, L+1
    = head (ln_final, text_projection)."""
    if path[0] == "transformer":
        return 1 + int(path[2])
    if path[0] in ("ln_final", "text_projection"):
        return num_layers + 1
    return 0


def build_lock_mask(model: torch.nn.Module, vision_layers,
                    text_layers: int, unlocked_groups: int = 0,
                    tune_text: bool = False,
                    unlocked_text_layers: int = 0) -> Dict[str, bool]:
    """{parameter name: trainable} for a ViT-family, ModifiedResNet or
    ConvNeXt model (``vision_layers`` its stage depths), and each
    parameter's ``requires_grad`` set to match.  ``unlocked_groups``
    unlocks the last n visual groups (0 = vision frozen; a ModifiedResNet
    has 6); ``unlocked_text_layers`` the last n text groups when
    ``tune_text`` (the text tower is frozen otherwise);
    ``logit_scale``/``logit_bias`` and BatchNorm statistics stay frozen."""
    tower = getattr(model.config, "tower", "vit")
    if tower == "convnext":
        depths = tuple(vision_layers)
        n_vis = sum(depths) + 2
    else:
        n_vis = 6 if tower == "rn" else vision_layers + 2
    n_txt = text_layers + 2
    mask = {}
    for name, param in model.named_parameters():
        top, *path = name.split(".")
        if path and path[-1] in ("mean", "var"):
            # FrozenBatchNorm statistics: inference statistics, not weights
            trainable = False
        elif top == "visual":
            if tower == "convnext":
                group = _convnext_group_of(tuple(path), depths)
            elif tower == "rn":
                group = _rn_group_of(tuple(path))
            else:
                group = _vit_group_of(tuple(path), vision_layers)
            trainable = group >= n_vis - unlocked_groups
        elif top == "text":
            trainable = tune_text and _text_group_of(
                tuple(path), text_layers) >= n_txt - unlocked_text_layers
        else:
            trainable = False
        mask[name] = trainable
        param.requires_grad_(trainable)
    return mask


def trainable_report(mask: Dict[str, bool]) -> Dict[str, Any]:
    """Trainable vs frozen parameter counts (the reference's printout)."""
    trainable = [n for n, v in mask.items() if v]
    by_top: Dict[str, int] = {}
    for name in trainable:
        parts = name.split(".")
        top = ".".join(parts[:2]) if len(parts) > 1 else name
        by_top[top] = by_top.get(top, 0) + 1
    return {
        "num_trainable": len(trainable),
        "num_frozen": len(mask) - len(trainable),
        "fraction_trainable": len(trainable) / max(len(mask), 1),
        "by_top_module": by_top,
        "trainable_sample": trainable[:10],
        "trainable_visual": [n for n in trainable if n.startswith("visual")][:10],
        "trainable_text": [n for n in trainable if n.startswith("text")][:10],
    }


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PEFTConfig:
    resolution: int
    num_classes: int
    lr: float
    epochs: int
    crop_mode: str = "random"
    flip: bool = False
    rotation: bool = False
    # the train augment: "fast" = the matmul-formulated warp
    # (ops/fast_warp.fast_train_transform), "exact" = the per-image gather
    # (ops/preprocess.train_transform)
    aug_impl: str = "fast"
    tune_text: bool = False
    num_templates: int = 1
    compute_dtype: Any = torch.float32
    val_interval: int = 0
    # False = the host loop (a batch copied to the device per step); True =
    # the train split's uint8 images and labels staged on the device once,
    # each step's batch gathered there; "chunked" = the split in chunks of
    # ``device_chunk_bytes``, the next uploaded from pinned memory on a side
    # stream while the current one trains.  All three are step for step the
    # same training (the same batches, generators and order)
    device_dataset: Any = False
    device_chunk_bytes: int = 1 << 30
    checkpoint_interval: int = 0   # checkpoint_fn every N epochs (0 = off)
    # frozen-prefix fused forward: the bottom N frozen visual blocks run
    # through the forward-only block kernels in the train step (SigLIP
    # K5/K4, CLIP ViT K1, ConvNeXt K7).  -1 = auto
    # (``peft_fused_prefix_len``), 0 = off (canonical modules), > 0 =
    # explicit block count
    fused_prefix: int = -1
    # int8 frozen prefix (with fused_prefix > 0): the prefix blocks run the
    # int8 kernels (SigLIP K13 -> K9 -> K10, CLIP ViT K14) on weights
    # quantized once per run; opt-in (``finetune.fused_prefix_quant``), the
    # suffix then trains on int8-noise features.  A ConvNeXt has no int8
    # prefix (``peft.py:280-281``): its bf16 prefix runs
    prefix_quant: bool = False
    # the scanned canonical encode (SigLIP and CLIP ViT towers; with the
    # fused prefix off; the text encode is the module's, which is JAX's
    # scanned text encode's math); scan_remat checkpoints each scanned
    # block (JAX's default)
    scan_blocks: bool = False
    scan_remat: bool = True
    # LoRA (rank > 0): the whole base tower freezes and rank-r adapters on
    # the attention (and with lora_mlp the MLP) weights train; W_eff = W +
    # (alpha / r) A @ B is merged each step (``train/lora.py``)
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_mlp: bool = False


def peft_fused_prefix_len(config, unlocked_groups: int, device, mesh=None,
                          batch_size: Optional[int] = None) -> int:
    """How many bottom visual blocks are frozen under ``unlocked_groups``
    and run through the forward-only kernels (``fast_vit.py:624-671``): 0
    off the card (JAX: off the TPU), for SigLIP towers of width <= 1024
    (a wash on the TPU), and under a ``mesh`` with a sharded-weight axis
    (any axis but ``data`` > 1) or a ``batch_size`` the data axis does not
    divide (a pure-DP mesh runs the prefix per rank on its rows);
    otherwise L + 1 - unlocked_groups, clipped to [0, L], L the block
    count (a ConvNeXt's over all stages).  At ``unlocked_groups=11``:
    SO400M 17, ViT-B/16 2, ConvNeXt base_w 26."""
    if resolve_device(device).type != "cuda" or not (
            config.is_vit or _is_convnext(config)):
        return 0
    if mesh is not None:
        if any(v != 1 for k, v in mesh.shape.items() if k != DATA_AXIS):
            return 0
        if batch_size is None or batch_size % mesh.shape[DATA_AXIS]:
            return 0
    if isinstance(config, SigLIPConfig) and config.vision_width <= 1024:
        return 0
    layers = _visual_blocks(config)
    return max(0, min(layers, layers + 1 - unlocked_groups))


def _pack_prefix(model, cfg: PEFTConfig):
    """The hybrid prefix's weight pack (SigLIP: K5/K4, CLIP ViT: K1,
    ConvNeXt: K7) for the bottom ``fused_prefix`` blocks, built once per run
    (the frozen weights never change); None with the int8 prefix, which a
    ConvNeXt does not have."""
    if cfg.fused_prefix <= 0 or (cfg.prefix_quant
                                 and not _is_convnext(model.config)):
        return None
    if isinstance(model.config, SigLIPConfig):
        from ..models.fast_siglip import pack_siglip_fast_params

        return pack_siglip_fast_params(model, model.config, cfg.compute_dtype,
                                       stop=cfg.fused_prefix, hybrid=True)
    from ..models.fast_vit import pack_fastest

    return pack_fastest(model, model.config, cfg.compute_dtype,
                        stop=cfg.fused_prefix)


def _quantize_prefix(model, cfg: PEFTConfig):
    """The int8 frozen prefix (``peft.py:273-299``): {resblocks_i: qblock}
    for the bottom ``fused_prefix`` blocks, quantized once per run
    (SigLIP: ``quantize_siglip_block`` with the hybrid head grouping; CLIP
    ViT: ``quantize_vit_block``); None when the int8 prefix is off, and for
    a ConvNeXt, whose bf16 prefix runs (``peft.py:280-281``)."""
    if (cfg.fused_prefix <= 0 or not cfg.prefix_quant
            or _is_convnext(model.config)):
        return None
    blocks = model.visual.transformer.resblocks
    if isinstance(model.config, SigLIPConfig):
        from ..models.fast_siglip import siglip_attn_groups
        from ..models.quant_siglip import quantize_siglip_block

        n_groups = siglip_attn_groups(model.config, hybrid=True)
        return {f"resblocks_{i}": quantize_siglip_block(
            blocks[i], model.config.vision_heads, n_groups)
            for i in range(cfg.fused_prefix)}
    from ..models.quant_vit import quantize_vit_block

    return {f"resblocks_{i}": quantize_vit_block(blocks[i])
            for i in range(cfg.fused_prefix)}


def _encode_projected(model, cfg: PEFTConfig, x, pprefix=None,
                      tp: bool = False):
    """The train step's image encode: the frozen-prefix hybrid when
    ``fused_prefix`` > 0 (``siglip_encode_hybrid``, ``vit_encode_hybrid``
    or ``convnext_encode_hybrid``), the scanned canonical encode with
    ``scan_blocks`` (SigLIP and CLIP ViT towers), the canonical module
    otherwise.  ``pprefix`` is the run's prefix (``_pack_prefix``, or
    ``_quantize_prefix`` with ``prefix_quant``), built here when absent.
    Under tensor parallelism (``tp``) the blocks run their tensor-parallel
    forward in the module, ``scan_blocks`` as its ``remat`` setting."""
    if tp:
        from ..models.layers import remat_blocks

        with remat_blocks(model.visual, cfg.scan_blocks and cfg.scan_remat):
            return model.encode_image(x, project=True)
    if cfg.fused_prefix <= 0:
        if cfg.scan_blocks and isinstance(model.config, SigLIPConfig):
            from ..models.fast_siglip import siglip_encode_scan

            return siglip_encode_scan(model, x, model.config, project=True,
                                      dtype=cfg.compute_dtype,
                                      remat=cfg.scan_remat)
        if cfg.scan_blocks and model.config.is_vit:
            from ..models.fast_vit import vit_encode_scan

            return vit_encode_scan(model, x, model.config, project=True,
                                   dtype=cfg.compute_dtype,
                                   remat=cfg.scan_remat)
        return model.encode_image(x, project=True)
    if _is_convnext(model.config):
        from ..models.fast_convnext import convnext_encode_hybrid

        return convnext_encode_hybrid(model, x, model.config,
                                      cfg.fused_prefix, project=True,
                                      dtype=cfg.compute_dtype,
                                      packed_prefix=pprefix)
    if isinstance(model.config, SigLIPConfig):
        from ..models.fast_siglip import siglip_encode_hybrid as hybrid
    else:
        from ..models.fast_vit import vit_encode_hybrid as hybrid
    if cfg.prefix_quant:
        return hybrid(model, x, model.config, cfg.fused_prefix, project=True,
                      dtype=cfg.compute_dtype,
                      qprefix=pprefix or _quantize_prefix(model, cfg))
    return hybrid(model, x, model.config, cfg.fused_prefix, project=True,
                  dtype=cfg.compute_dtype, packed_prefix=pprefix)


def train_augment(aug_impl: str):
    """The train augment of ``aug_impl`` (JAX ``peft.py:394-395``, ``feature_
    cache.py:283-285``): "fast", the matmul-formulated warp, else the exact
    per-image gather; both take (images_u8, generator, resolution, ...)."""
    from ..ops.fast_warp import fast_train_transform
    from ..ops.preprocess import train_transform

    return fast_train_transform if str(aug_impl) == "fast" else train_transform


def _build_loss_fn(model, cfg: PEFTConfig,
                   text_weights: Optional[torch.Tensor],
                   prompt_tokens: Optional[torch.Tensor], mesh=None,
                   encode=None):
    """The PEFT objective: augment -> encode -> L2-normalise in fp32 ->
    (recomputed) text head -> masked CE.  ``loss_fn(images_u8, labels,
    valid, generator, pprefix=None) -> (loss, (correct, n_valid))``.
    Under a ``mesh`` the batch and the draws are the global ones on every
    rank; the rank encodes its rows of the data axis and its loss is its
    part of the global batch's (the sum over the data axis is the loss).
    ``encode(x) -> projected features`` replaces the step's own encode
    (the pipeline step's, over the global batch)."""
    from ..ops.preprocess import normalize_stats_for

    nmean, nstd = normalize_stats_for(model.config)
    aug_fn = train_augment(cfg.aug_impl)

    def loss_fn(images_u8, labels, valid, generator, pprefix=None):
        x = aug_fn(images_u8, generator, cfg.resolution,
                   crop_mode=cfg.crop_mode, flip=cfg.flip,
                   rotation=cfg.rotation, dtype=cfg.compute_dtype,
                   mean=nmean, std=nstd)
        count = None
        if mesh is not None:
            count = valid.float().sum().clamp_min(1.0)
            rows = batch_sharding(mesh).rows(x.shape[0])
            x, labels, valid = x[rows], labels[rows], valid[rows]
        if encode is not None:
            feats = encode(x)
        else:
            _, feats = _encode_projected(
                model, cfg, x, pprefix,
                tp=mesh is not None and mesh.shape.get(MODEL_AXIS, 1) > 1)
        feats = feats.float()
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if cfg.tune_text:
            w = compute_text_weights(model, prompt_tokens, cfg.num_classes,
                                     cfg.num_templates)
        else:
            w = text_weights
        return masked_ce_metrics(100.0 * feats @ w, labels, valid,
                                 count=count)

    return loss_fn


def _merged(model, cfg: PEFTConfig, adapters):
    """The context every read of the weights goes through: the LoRA
    merge (``W_eff``) when adapters train, nothing otherwise."""
    if adapters is None:
        return contextlib.nullcontext(model)
    from .lora import lora_applied

    return lora_applied(model, adapters, cfg.lora_alpha)


@contextlib.contextmanager
def _read(model, cfg: PEFTConfig, mesh, sharding, adapters,
          control: bool = False):
    """The context the step and the evaluation read the weights through:
    the LoRA merge (``_merged``) of a model that is not sharded; of a
    sharded one, its gather (``Sharding.gathered``: the tensor-parallel
    blocks' weights as their shards, every block's FSDP shards gathered
    and its adapters merged by the block as it runs, the rest whole and
    merged now; the text tower left as its shards when the step does not
    recompute the text head) with the tensor-parallel forward of every
    block the rules cut on a model axis > 1.  ``control``
    (``_make_train_step``'s): every weight it reads gathered whole and
    merged now, and the replicated forward in place of the
    tensor-parallel one."""
    if sharding is None:
        with _merged(model, cfg, adapters):
            yield model
        return
    tp = not control and mesh.shape.get(MODEL_AXIS, 1) > 1
    unread = () if cfg.tune_text else ("text.",)
    with sharding.gathered(model, tp_local if tp else None,
                           per_block=not control, adapters=adapters,
                           alpha=cfg.lora_alpha, unread=unread), \
            tensor_parallel_blocks(model, mesh if tp else None):
        yield model


def make_train_step(model, cfg: PEFTConfig,
                    text_weights: Optional[torch.Tensor],
                    prompt_tokens: Optional[torch.Tensor], adapters=None,
                    mesh=None, sharding=None):
    """Returns (opt, step): ``torch.optim.Adam`` over the parameters that
    require a gradient (with ``adapters``, over the LoRA A and B tensors
    alone), and ``step(images_u8, labels, valid, generator, lr,
    pprefix=None) -> {loss, correct, n_valid}`` (device tensors; no host
    sync), which updates those tensors in place.  Under a ``mesh`` every
    rank passes the global batch; the gradients not reduce-scattered by
    the ``sharding`` (``parallel.shard_params``) are summed over the data
    axis, and the metrics are the global batch's.  Under FSDP each block
    of every tower gathers its weights (and merges its LoRA adapters) as
    it runs, and under TP the blocks run as shards."""
    return _make_train_step(model, cfg, text_weights, prompt_tokens,
                            adapters, mesh, sharding, control=False)


def _make_train_step(model, cfg: PEFTConfig, text_weights, prompt_tokens,
                     adapters, mesh, sharding, control: bool):
    """``make_train_step``; ``control`` builds the control that
    ``chip_smoke.py`` and the tests measure the per-block gather and the
    tensor-parallel shards against: a sharded model's weights gathered
    whole for the step, and a replicated forward (no tensor-parallel
    blocks; ``_read``)."""
    if adapters is None:
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    else:
        named = [(f"{n}.{k}", ab[k]) for n, ab in adapters.items()
                 for k in ("a", "b")]
    params = [p for _, p in named]
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    loss_fn = _build_loss_fn(model, cfg, text_weights, prompt_tokens, mesh)
    summed = [p for n, p in named
              if sharding is None or not sharding.data_sharded(n)]

    def step(images_u8, labels, valid, generator, lr, pprefix=None):
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        with _read(model, cfg, mesh, sharding, adapters, control):
            loss, (correct, n_valid) = loss_fn(images_u8, labels, valid,
                                               generator, pprefix)
        loss.backward()
        if mesh is not None:
            comm.all_reduce_grads_(summed, mesh, DATA_AXIS)
        opt.step()
        loss = loss.detach()
        if mesh is not None:
            both = comm.all_reduce_(torch.stack([loss.float(),
                                                 correct.float()]),
                                    mesh, DATA_AXIS)
            loss, correct = both[0], both[1].to(correct.dtype)
        return {"loss": loss, "correct": correct, "n_valid": n_valid}

    return opt, step


def step_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The augmentation generator of one step (a distinct stream per
    (seed, epoch, step), as JAX folds the epoch and step into its key)."""
    return torch.Generator().manual_seed(
        ((seed * 100003 + epoch) * 1000003 + step) % (2 ** 63))


# ---------------------------------------------------------------------------
# The epoch regimes: where a step's batch comes from
# ---------------------------------------------------------------------------


def _epoch_batch_indices(view: SplitView, epoch: int):
    """The host-side batch order of ``SplitView.batches(epoch)`` as padded
    index/valid arrays [steps, B] (relative to the view's selection; pad
    entries 0 and False), JAX's table for its epoch scan."""
    order = np.arange(view.num_samples)
    if view.shuffle:
        rng = np.random.RandomState((view.seed * 100003 + epoch) % (2 ** 31))
        order = order[rng.permutation(len(order))]
    bs = view.batch_size
    steps = (len(order) + bs - 1) // bs
    idx = np.zeros((steps, bs), np.int32)
    valid = np.zeros((steps, bs), bool)
    for s in range(steps):
        chunk = order[s * bs:(s + 1) * bs]
        idx[s, :len(chunk)] = chunk
        valid[s, :len(chunk)] = True
    return idx, valid


def upload(array: np.ndarray, dev, stream=None) -> torch.Tensor:
    """A host -> device copy of the train split's data; with ``stream`` (a
    card), the copy leaves pinned memory without blocking, on that
    stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if stream is None:
        return t.to(dev)
    with torch.cuda.stream(stream):
        return t.pin_memory().to(dev, non_blocking=True)


class _Feed:
    """Where a step's batch comes from; every host -> device copy of the
    split's data (images, labels, the batch tables) is counted in
    ``uploads``, so a caller can show that a regime copies nothing per
    step (``report['split_uploads']``)."""

    uploads = 0

    def _upload(self, array, stream=None) -> torch.Tensor:
        self.uploads += 1
        return upload(array, self.dev, stream)


class _HostFeed(_Feed):
    """The host loop: each step's padded batch copied to the device."""

    def __init__(self, view: SplitView, dev):
        self.view, self.dev = view, dev

    def epoch(self, epoch: int):
        for batch in self.view.batches(epoch=epoch):
            yield (self._upload(batch.images), self._upload(batch.labels),
                   self._upload(batch.valid), batch.n_valid)


class _StagedFeed(_Feed):
    """``device_dataset=True``: the split's uint8 images and labels on the
    device once, one zero row after them for the pad entries (the host
    loop pads with zeros), added on the device so the host holds the split
    once; per epoch the batch table goes up once, and each step gathers
    its batch on the device."""

    def __init__(self, view: SplitView, dev):
        self.view, self.dev = view, dev
        self.pad = len(view.indices)
        self.images = self._padded(view.dataset.images[view.indices])
        self.labels = self._padded(view.labels.astype(np.int32))

    def _padded(self, array: np.ndarray) -> torch.Tensor:
        # n + 1 rows on the device, the split copied into the first n
        self.uploads += 1
        src = torch.from_numpy(np.ascontiguousarray(array))
        t = src.new_empty((len(src) + 1,) + src.shape[1:], device=self.dev)
        t[:-1].copy_(src)
        t[-1].zero_()
        return t

    def epoch(self, epoch: int):
        idx, valid = _epoch_batch_indices(self.view, epoch)
        table = np.where(valid, idx, self.pad).astype(np.int64)
        idx_d, valid_d = self._upload(table), self._upload(valid)
        for s in range(len(table)):
            yield (self.images.index_select(0, idx_d[s]),
                   self.labels.index_select(0, idx_d[s]), valid_d[s],
                   int(valid[s].sum()))


class _ChunkedFeed(_Feed):
    """``device_dataset='chunked'``: the epoch's batches in chunks of
    ``chunk_bytes`` of images, gathered on the host in batch order (pad
    rows zero) and uploaded whole; on a card the next chunk's copy leaves
    pinned memory on a side stream while the current chunk trains, and the
    compute stream waits on its event before the first use."""

    def __init__(self, view: SplitView, dev, chunk_bytes: int):
        self.view, self.dev = view, dev
        per_sample = int(np.prod(view.dataset.images.shape[1:]))
        self.chunk_steps = max(1, int(chunk_bytes)
                               // (per_sample * view.batch_size))
        self.labels = view.labels.astype(np.int32)
        self.stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                       else None)
        self.chunks_staged = 0

    def _stage(self, idx, valid, s0: int, s1: int):
        rel = idx[s0:s1].reshape(-1)
        ok = valid[s0:s1].reshape(-1)
        imgs = self.view.dataset.images[self.view.indices[rel]]
        imgs[~ok] = 0
        labs = np.where(ok, self.labels[rel], 0).astype(np.int32)
        staged = (self._upload(imgs, self.stream),
                  self._upload(labs, self.stream),
                  self._upload(valid[s0:s1], self.stream))
        event = None
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record(self.stream)
        self.chunks_staged += 1
        return staged, event

    def epoch(self, epoch: int):
        idx, valid = _epoch_batch_indices(self.view, epoch)
        steps, bs = idx.shape
        bounds = [(s0, min(s0 + self.chunk_steps, steps))
                  for s0 in range(0, steps, self.chunk_steps)]
        nxt = self._stage(idx, valid, *bounds[0])
        for c, (s0, s1) in enumerate(bounds):
            (imgs, labs, val), event = nxt
            if event is not None:
                main = torch.cuda.current_stream(self.dev)
                main.wait_event(event)
                for t in (imgs, labs, val):
                    t.record_stream(main)
            for s in range(s1 - s0):
                yield (imgs[s * bs:(s + 1) * bs], labs[s * bs:(s + 1) * bs],
                       val[s], int(valid[s0 + s].sum()))
                if s == 0 and c + 1 < len(bounds):
                    # the next chunk's gather and copy while this one trains
                    nxt = self._stage(idx, valid, *bounds[c + 1])


def _feed(cfg: PEFTConfig, view: SplitView, dev):
    mode = cfg.device_dataset
    if isinstance(mode, str) and mode.lower() == "chunked":
        return _ChunkedFeed(view, dev, cfg.device_chunk_bytes)
    if mode:
        return _StagedFeed(view, dev)
    return _HostFeed(view, dev)


# ---------------------------------------------------------------------------
# The fine-tune loop
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _graceful_signals(flag: Dict[str, Any]):
    """On SIGTERM/SIGINT set ``flag["set"]`` (the loop finishes the epoch,
    checkpoints and returns).  Handlers are installed on the main thread
    only, and the previous ones restored on exit."""
    prev = {}
    if threading.current_thread() is threading.main_thread():
        def on_signal(signum, frame):
            flag["set"] = True
            print(f"[peft] signal {signum}: finishing the current epoch, "
                  "then checkpointing and exiting")

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, on_signal)
        except (ValueError, OSError):
            pass
    try:
        yield
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def finetune(model, train_view: SplitView, val_view: Optional[SplitView],
             test_view: Optional[SplitView], cfg: PEFTConfig,
             text_weights: Optional[torch.Tensor] = None,
             prompt_tokens: Optional[torch.Tensor] = None,
             unlocked_groups: int = 1, unlocked_text_layers: int = 0,
             seed: int = 0, l2_eval_ctx: Optional[Dict] = None,
             return_confusion_matrix: bool = True, track_test: bool = True,
             logger=None, verbose: bool = True,
             profile_dir: Optional[str] = None, checkpoint_fn=None,
             resume_from=None, mesh=None, fsdp: bool = False,
             device="cuda") -> Dict[str, Any]:
    """Run the PEFT loop on ``device`` (default the card; raises without
    one unless ``device="cpu"``), where the model must already live.
    Returns {val, test, params, opt_state, tracker, report, mask,
    adapters, interrupted_at_epoch}: ``params`` are the trained parameters
    by name (the model's own tensors; with LoRA, new W_eff tensors for the
    adapted weights, the model's base weights left as they were).

    ``checkpoint_fn(params, opt_state, epoch)`` runs every
    ``cfg.checkpoint_interval`` epochs (not after the last) and after an
    interrupted epoch; ``resume_from`` (a checkpoint directory) restores
    the parameters, the Adam state and the absolute epoch, and the run
    continues bit for bit as if it had not stopped.  A SIGTERM or SIGINT
    finishes the current epoch, checkpoints and returns with
    ``interrupted_at_epoch``.  ``profile_dir`` traces the first epoch's
    first 5 steps (``torch.profiler``, a Chrome trace).

    ``mesh`` (``parallel.make_mesh``, this rank's device the model's) runs
    the steps and the evaluations over the process group (see the module
    docstring): every rank calls ``finetune`` with the same views, and the
    ``checkpoint_fn`` runs on every rank with whole parameters and Adam
    moments (a caller writes on one).  ``fsdp`` (with a mesh) also shards
    the parameters and the Adam moments over the data axis.  The model
    holds whole parameters again when ``finetune`` returns."""
    dev = resolve_device(device)
    on = model.logit_scale.device
    if on.type != dev.type or dev.index not in (None, on.index):
        raise ValueError(f"the model is on {on}, not on {dev}")
    dev = on
    if fsdp and mesh is None:
        raise ValueError("fsdp=True requires a mesh")
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    tp = mesh is not None and mesh.shape.get(MODEL_AXIS, 1) > 1
    if mesh is not None and mesh.device != dev:
        raise ValueError(f"the mesh's device is {mesh.device}, the model "
                         f"is on {dev}")
    ccfg = model.config
    lora = cfg.lora_rank > 0
    if lora:
        if resume_from is not None:
            raise ValueError("finetune.resume is not supported with LoRA "
                             "(checkpoints store merged weights, not "
                             "adapters); restart the adapter run instead")
        if tp:
            raise ValueError("LoRA does not compose with tensor parallelism "
                             "(adapter deltas are replicated; base kernels "
                             "would be column/row-sharded)")
        # the adapters sit on every block: no frozen prefix
        cfg = dataclasses.replace(cfg, fused_prefix=0, prefix_quant=False)
    if fsdp and cfg.fused_prefix != 0:
        if verbose:
            print("[peft] fused_prefix disabled under fsdp (the fused prefix "
                  "assumes replicated weights)")
        cfg = dataclasses.replace(cfg, fused_prefix=0)
    n_blocks = _visual_blocks(ccfg)
    mask = build_lock_mask(model, ccfg.vision_layers, ccfg.transformer_layers,
                           unlocked_groups=0 if lora else unlocked_groups,
                           tune_text=cfg.tune_text and not lora,
                           unlocked_text_layers=unlocked_text_layers)
    if cfg.fused_prefix < 0:
        cfg = dataclasses.replace(cfg, fused_prefix=peft_fused_prefix_len(
            ccfg, unlocked_groups, dev, mesh=mesh,
            batch_size=train_view.batch_size))
        int8 = cfg.prefix_quant and not _is_convnext(ccfg)
        if verbose and cfg.fused_prefix:
            print(f"[peft] fused frozen-prefix forward: bottom "
                  f"{cfg.fused_prefix}/{n_blocks} visual blocks run the "
                  f"forward-only {'int8 ' if int8 else ''}block kernels"
                  + (" (prefix_quant: a ConvNeXt has no int8 prefix, the "
                     "bf16 prefix runs, as in JAX)"
                     if cfg.prefix_quant and not int8 else "")
                  + (" (per rank, on its rows of the data axis)"
                     if mesh is not None else ""))
    elif cfg.fused_prefix > 0:
        if tp:
            raise ValueError("finetune.fused_prefix > 0 needs replicated "
                             "weights: not under tensor parallelism")
        if not (ccfg.is_vit or _is_convnext(ccfg)):
            raise ValueError(
                "finetune.fused_prefix > 0 requires a ViT-family or "
                "ConvNeXt vision tower (the RN tower has no fused-prefix "
                "hybrid)")
        # every prefix block must be frozen: no gradient reaches it
        max_prefix = max(0, n_blocks + 1 - unlocked_groups)
        if cfg.fused_prefix > max_prefix:
            raise ValueError(
                f"finetune.fused_prefix={cfg.fused_prefix} exceeds the frozen "
                f"bottom depth ({max_prefix} blocks at unlocked_groups="
                f"{unlocked_groups}); the prefix must be entirely frozen")
    report = trainable_report(mask)
    adapters = None
    if lora:
        from .lora import lora_init, lora_param_count

        towers = ("visual", "text") if cfg.tune_text else ("visual",)
        adapters = lora_init(model, cfg.lora_rank,
                             torch.Generator().manual_seed(seed + 7919),
                             towers=towers, include_mlp=cfg.lora_mlp)
        report.update({
            "method": "lora", "lora_rank": cfg.lora_rank,
            "lora_alpha": cfg.lora_alpha,
            "num_adapted_kernels": len(adapters),
            "num_trainable": 2 * len(adapters),
            "lora_params": lora_param_count(adapters)})
        if verbose:
            print(f"LoRA r={cfg.lora_rank} alpha={cfg.lora_alpha}: "
                  f"{len(adapters)} adapted kernels, "
                  f"{report['lora_params']:,} trainable params "
                  "(base tower fully frozen)")
    elif verbose:
        print(f"Trainable params: {report['num_trainable']} "
              f"({report['fraction_trainable']:.1%})")
        print(f"Frozen params   : {report['num_frozen']}")
        for top, cnt in sorted(report["by_top_module"].items()):
            print(f"  {top}: {cnt} params")
    if cfg.tune_text and prompt_tokens is None:
        raise ValueError("tune_text=True requires prompt_tokens")
    if not cfg.tune_text and text_weights is None:
        raise ValueError("tune_text=False requires precomputed text_weights")

    start_epoch, restored = 0, None
    if resume_from is not None:
        from ..utils.checkpointing import load_checkpoint, load_params_into

        restored = load_checkpoint(resume_from)
        load_params_into(model, restored["params"])
        start_epoch = int(restored["meta"].get("epoch", 0))
        if verbose:
            print(f"[resume] restored epoch {start_epoch} (params"
                  f"{' + opt state' if 'opt_state' in restored else ''}) "
                  f"from {resume_from}")
    sharding = None
    if mesh is not None:
        from ..parallel.mesh import replicated, shard_params

        # every rank starts from rank 0's weights (and adapters), then
        # keeps its shards
        replicated(mesh, *[p.detach() for p in model.parameters()], *(
            t for ab in (adapters or {}).values() for t in ab.values()))
        if tp or fsdp:
            sharding = shard_params(mesh, model, fsdp=fsdp)
        if verbose:
            print(f"[parallel] finetune on mesh {mesh.describe()}"
                  + (", fsdp" if fsdp else ""))
        if cfg.device_dataset:
            if verbose:
                print("[peft] device_dataset disabled under a mesh "
                      "(per-step loop instead)")
            cfg = dataclasses.replace(cfg, device_dataset=False)
    opt, step = make_train_step(model, cfg, text_weights, prompt_tokens,
                                adapters, mesh=mesh, sharding=sharding)
    names = ([n for n, p in model.named_parameters() if p.requires_grad]
             if adapters is None else None)
    # the parameter of each Adam index, named in the checkpoints
    opt_names = names if adapters is None else [
        f"{n}.{k}" for n, ab in adapters.items() for k in ("a", "b")]
    if restored is not None and "opt_state" in restored:
        from ..utils.checkpointing import adam_state_for

        full_sd = adam_state_for(restored["opt_state"], opt_names,
                                 opt.state_dict())
        opt.load_state_dict(full_sd if sharding is None
                            else sharding.local_opt_state(full_sd, names,
                                                          dev))
    # the frozen prefix's weights, packed (or quantized) once per run,
    # after a resume (the frozen weights never change while training)
    pprefix = _quantize_prefix(model, cfg) or _pack_prefix(model, cfg)

    def opt_state():
        from ..utils.checkpointing import with_param_names

        return with_param_names(
            opt.state_dict() if sharding is None or lora
            else sharding.full_opt_state(opt, names), opt_names)

    def current_text_weights():
        if cfg.tune_text:
            with torch.inference_mode():
                return compute_text_weights(model, prompt_tokens,
                                            cfg.num_classes,
                                            cfg.num_templates)
        return text_weights

    def run_eval(view, **kw):
        # evaluate packs the kernels' weights at each call: with LoRA the
        # pack (and the text head) is W_eff's; a sharded model's blocks
        # gather theirs one at a time (the canonical module encodes)
        with torch.no_grad(), _read(model, cfg, mesh, sharding, adapters):
            return evaluate(model, view, current_text_weights(),
                            cfg.resolution, cfg.num_classes,
                            compute_dtype=cfg.compute_dtype, mesh=mesh,
                            sharded_weights=sharding is not None, **kw)

    def current_params():
        if lora:
            from .lora import merged_params

            with (contextlib.nullcontext() if sharding is None
                  else sharding.gathered(model)):
                return merged_params(model, adapters, cfg.lora_alpha)
        if sharding is not None:
            return sharding.full_state(model)
        return {n: p.detach() for n, p in model.named_parameters()}

    feed = _feed(cfg, train_view, dev)
    timer = None
    interrupted = {"set": False, "epoch": None}
    if verbose:
        print("\nStart Training procedure")
    val_metrics = None
    with _graceful_signals(interrupted):
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            lr_e = cosine_lr(cfg.lr, epoch, cfg.epochs)
            prof = None
            if epoch == start_epoch:
                from ..utils.profiling import StepTimer

                timer = StepTimer()
                if profile_dir is not None:
                    from ..utils.profiling import trace

                    prof = trace(profile_dir)
                    prof.__enter__()
            step_metrics = []
            for bi, (imgs, labs, valid, n_valid) in enumerate(
                    feed.epoch(epoch)):
                with torch.profiler.record_function("train_step"):
                    step_metrics.append(step(
                        imgs, labs, valid, step_generator(seed, epoch, bi),
                        lr_e, pprefix))
                timer.tick(items=n_valid)
                if prof is not None and bi >= 4:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    prof.__exit__(None, None, None)
                    prof = None
                    if verbose:
                        print(f"[profile] trace (5 steps) -> {profile_dir}")
            if prof is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof.__exit__(None, None, None)
            run_batches = len(step_metrics)
            run_loss = correct = seen = 0.0
            if step_metrics:   # one host sync per epoch
                sums = torch.stack([torch.stack([
                    m["loss"], m["correct"].float(), m["n_valid"]])
                    for m in step_metrics]).sum(0).tolist()
                run_loss, correct, seen = sums
            if verbose:
                print(f"Train Epoch: {epoch + 1} / {cfg.epochs}  "
                      f"Acc: {correct / max(seen, 1):.4f} "
                      f"({int(correct)}/{int(seen)}), "
                      f"Avg Loss: {run_loss / max(run_batches, 1):.4f}, "
                      f"LR: {lr_e:.2e}, {time.perf_counter() - t0:.1f}s",
                      flush=True)
            if logger is not None:
                logger.log({"epoch": epoch + 1,
                            "train_loss": run_loss / max(run_batches, 1),
                            "train_acc": correct / max(seen, 1), "lr": lr_e})

            do_val = ((cfg.val_interval
                       and (epoch + 1) % cfg.val_interval == 0)
                      or (epoch + 1) == cfg.epochs)
            if do_val and val_view is not None and val_view.num_samples > 0:
                val_metrics = run_eval(val_view, l2_eval_ctx=l2_eval_ctx)
                if verbose:
                    print(f"[val epoch {epoch + 1}] "
                          f"loss={val_metrics['loss']:.4f}, "
                          f"top1_acc={val_metrics['top1']:.4f}, "
                          f"top3_acc={val_metrics['top3']:.4f}, "
                          f"f1={val_metrics['f1']:.4f}, "
                          f"mcc={val_metrics['mcc']:.4f}")
                if logger is not None:
                    logger.log({f"val_{k}": v for k, v in val_metrics.items()
                                if isinstance(v, (int, float))})

            periodic = bool(cfg.checkpoint_interval
                            and (epoch + 1) % cfg.checkpoint_interval == 0)
            if (checkpoint_fn is not None and periodic
                    and (epoch + 1) < cfg.epochs):
                checkpoint_fn(current_params(), opt_state(), epoch + 1)
            if mesh is not None:   # a signal to one rank stops them all
                interrupted["set"] = comm.any_rank(interrupted["set"], mesh)
            if interrupted["set"]:
                interrupted["epoch"] = epoch + 1
                if checkpoint_fn is not None and not periodic:
                    checkpoint_fn(current_params(), opt_state(), epoch + 1)
                if verbose:
                    print(f"[peft] interrupted after epoch {epoch + 1}; "
                          "resume with finetune.resume: true", flush=True)
                break

    test_metrics = None
    tracker = ClassificationTracker() if track_test else None
    if test_view is not None and test_view.num_samples > 0:
        test_metrics = run_eval(
            test_view, return_confusion_matrix=return_confusion_matrix,
            l2_eval_ctx=l2_eval_ctx, tracker=tracker)
        if verbose:
            print(f"[test] loss={test_metrics['loss']:.4f}, "
                  f"top1_acc={test_metrics['top1']:.4f}, "
                  f"top3_acc={test_metrics['top3']:.4f}, "
                  f"f1={test_metrics['f1']:.4f}, mcc={test_metrics['mcc']:.4f}")
    elif verbose:
        print("[test] skipped (no test split)")
    if timer is not None:
        report["first_epoch_throughput"] = timer.summary()
    report["split_uploads"] = feed.uploads
    final_opt = opt_state()
    if sharding is not None:
        sharding.unshard_(model)
        sharding = None
    return {
        "val": val_metrics,
        "test": test_metrics,
        "params": current_params(),
        "opt_state": final_opt,
        "tracker": tracker,
        "report": report,
        "mask": mask,
        "adapters": ({n: {k: t.detach() for k, t in ab.items()}
                      for n, ab in adapters.items()} if lora else None),
        "interrupted_at_epoch": interrupted["epoch"],
    }
