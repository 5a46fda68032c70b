"""PEFT: partial-unfreeze fine-tuning of a CLIP (ViT or ConvNeXt) or SigLIP
tower (counterpart of ``aihab_clip_tpu/train/peft.py:54-475, 561-1076``).

  * freezing follows open_clip's ``lock_image_tower(unlocked_groups)`` /
    ``lock_text_tower(unlocked_layers)``: groups are [stem] + resblocks (a
    ConvNeXt's blocks in depth order, each stage's downsample with its first
    block) + [head] and the last n unlock.  ``build_lock_mask`` maps the
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
    canonical blocks for the rest), fp32 L2 normalisation,
    the in-step text-head recompute when ``tune_text``, masked CE of
    ``100 * f @ T`` (``logit_scale`` is ignored, as in the reference), then
    Adam (optax's defaults: betas 0.9/0.999, eps 1e-8) over fp32 master
    parameters;
  * a cosine learning rate stepped per epoch, periodic validation
    (``val_interval``) and the final test through ``evaluate``.

The port trains the model's parameters in place (JAX returns new arrays).
Augmentation draws come from a ``torch.Generator`` seeded per (seed, epoch,
step), so they differ from ``jax.random``'s; the batch order is the JAX
package's.  Options of the JAX finetune that this package does not carry yet
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..backend import resolve_device
from ..data.pipeline import SplitView
from ..models.siglip import SigLIPConfig
from ..models.text_head import compute_text_weights
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


def _is_convnext(config) -> bool:
    return getattr(config, "tower", "vit") == "convnext"


def _visual_blocks(config) -> int:
    """L: the tower's block count (a ConvNeXt's over all its stages)."""
    return (sum(config.vision_layers) if _is_convnext(config)
            else config.vision_layers)


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
    """{parameter name: trainable} for a ViT-family or ConvNeXt model
    (``vision_layers`` its stage depths), and each parameter's
    ``requires_grad`` set to match.  ``unlocked_groups`` unlocks the last n
    visual groups (0 = vision frozen); ``unlocked_text_layers`` the last n
    text groups when ``tune_text`` (the text tower is frozen otherwise);
    ``logit_scale``/``logit_bias`` stay frozen (the loss does not use
    them)."""
    convnext = _is_convnext(model.config)
    if convnext:
        depths = tuple(vision_layers)
        n_vis = sum(depths) + 2
    else:
        n_vis = vision_layers + 2
    n_txt = text_layers + 2
    mask = {}
    for name, param in model.named_parameters():
        top, *path = name.split(".")
        if top == "visual":
            group = (_convnext_group_of(tuple(path), depths) if convnext
                     else _vit_group_of(tuple(path), vision_layers))
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
    tune_text: bool = False
    num_templates: int = 1
    compute_dtype: Any = torch.float32
    val_interval: int = 0
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
    # options of the JAX finetune that raise here until their slice
    device_dataset: Any = False
    scan_blocks: bool = False
    lora_rank: int = 0


# the ROADMAP item that brings each option of the JAX finetune not ported yet
_UNPORTED = {
    "lora_rank": "LoRA adapters (train/lora.py), ROADMAP A10",
    "scan_blocks": "the scanned encode (siglip_encode_scan), ROADMAP A10",
    "device_dataset": "the epoch scan / chunked regimes, ROADMAP A10",
    "mesh": "parallelism, ROADMAP A13",
    "fsdp": "parallelism, ROADMAP A13",
    "resume_from": "checkpointing, ROADMAP A10",
    "checkpoint_fn": "checkpointing, ROADMAP A10",
    "profile_dir": "profiling (utils/profiling.py), ROADMAP A10",
}


def _check_unported(cfg: PEFTConfig, **options) -> None:
    requested = dict(options, lora_rank=cfg.lora_rank > 0,
                     scan_blocks=cfg.scan_blocks,
                     device_dataset=cfg.device_dataset)
    for name, value in requested.items():
        if value:
            raise NotImplementedError(
                f"finetune {name}={value!r} is not ported: {_UNPORTED[name]}")


def peft_fused_prefix_len(config, unlocked_groups: int, device) -> int:
    """How many bottom visual blocks are frozen under ``unlocked_groups``
    and run through the forward-only kernels (``fast_vit.py:624-671``): 0
    off the card (JAX: off the TPU) and for SigLIP towers of width <= 1024
    (a wash on the TPU); otherwise L + 1 - unlocked_groups, clipped to
    [0, L], L the block count (a ConvNeXt's over all stages).  At
    ``unlocked_groups=11``: SO400M 17, ViT-B/16 2, ConvNeXt base_w 26."""
    if resolve_device(device).type != "cuda" or not (
            config.is_vit or _is_convnext(config)):
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


def _encode_projected(model, cfg: PEFTConfig, x, pprefix=None):
    """The train step's image encode: the frozen-prefix hybrid when
    ``fused_prefix`` > 0 (``siglip_encode_hybrid``, ``vit_encode_hybrid``
    or ``convnext_encode_hybrid``), the canonical module otherwise.
    ``pprefix`` is the run's prefix (``_pack_prefix``, or
    ``_quantize_prefix`` with ``prefix_quant``), built here when absent."""
    if cfg.fused_prefix <= 0:
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


def _build_loss_fn(model, cfg: PEFTConfig,
                   text_weights: Optional[torch.Tensor],
                   prompt_tokens: Optional[torch.Tensor]):
    """The PEFT objective: augment -> encode -> L2-normalise in fp32 ->
    (recomputed) text head -> masked CE.  ``loss_fn(images_u8, labels,
    valid, generator, pprefix=None) -> (loss, (correct, n_valid))``."""
    from ..ops.fast_warp import fast_train_transform
    from ..ops.preprocess import normalize_stats_for

    nmean, nstd = normalize_stats_for(model.config)

    def loss_fn(images_u8, labels, valid, generator, pprefix=None):
        x = fast_train_transform(images_u8, generator, cfg.resolution,
                                 crop_mode=cfg.crop_mode, flip=cfg.flip,
                                 rotation=cfg.rotation,
                                 dtype=cfg.compute_dtype, mean=nmean,
                                 std=nstd)
        _, feats = _encode_projected(model, cfg, x, pprefix)
        feats = feats.float()
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if cfg.tune_text:
            w = compute_text_weights(model, prompt_tokens, cfg.num_classes,
                                     cfg.num_templates)
        else:
            w = text_weights
        return masked_ce_metrics(100.0 * feats @ w, labels, valid)

    return loss_fn


def make_train_step(model, cfg: PEFTConfig,
                    text_weights: Optional[torch.Tensor],
                    prompt_tokens: Optional[torch.Tensor]):
    """Returns (opt, step): ``torch.optim.Adam`` over the parameters that
    require a gradient, and ``step(images_u8, labels, valid, generator, lr,
    pprefix=None) -> {loss, correct, n_valid}`` (device tensors; no host
    sync), which updates the model's trainable parameters in place."""
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    loss_fn = _build_loss_fn(model, cfg, text_weights, prompt_tokens)

    def step(images_u8, labels, valid, generator, lr, pprefix=None):
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss, (correct, n_valid) = loss_fn(images_u8, labels, valid,
                                           generator, pprefix)
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), "correct": correct, "n_valid": n_valid}

    return opt, step


def step_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The augmentation generator of one step (a distinct stream per
    (seed, epoch, step), as JAX folds the epoch and step into its key)."""
    return torch.Generator().manual_seed(
        ((seed * 100003 + epoch) * 1000003 + step) % (2 ** 63))


# ---------------------------------------------------------------------------
# The fine-tune loop
# ---------------------------------------------------------------------------


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
    Returns {val, test, params, tracker, report, mask}: ``params`` are the
    trained parameters by name (the model's own tensors)."""
    _check_unported(cfg, profile_dir=profile_dir, checkpoint_fn=checkpoint_fn,
                    resume_from=resume_from, mesh=mesh, fsdp=fsdp)
    dev = resolve_device(device)
    on = model.logit_scale.device
    if on.type != dev.type or dev.index not in (None, on.index):
        raise ValueError(f"the model is on {on}, not on {dev}")
    dev = on
    ccfg = model.config
    if not (ccfg.is_vit or _is_convnext(ccfg)):
        raise NotImplementedError("PEFT of ResNet towers is not ported: "
                                  "ROADMAP A11")
    n_blocks = _visual_blocks(ccfg)
    mask = build_lock_mask(model, ccfg.vision_layers, ccfg.transformer_layers,
                           unlocked_groups=unlocked_groups,
                           tune_text=cfg.tune_text,
                           unlocked_text_layers=unlocked_text_layers)
    if cfg.fused_prefix < 0:
        cfg = dataclasses.replace(cfg, fused_prefix=peft_fused_prefix_len(
            ccfg, unlocked_groups, dev))
        int8 = cfg.prefix_quant and not _is_convnext(ccfg)
        if verbose and cfg.fused_prefix:
            print(f"[peft] fused frozen-prefix forward: bottom "
                  f"{cfg.fused_prefix}/{n_blocks} visual blocks run the "
                  f"forward-only {'int8 ' if int8 else ''}block kernels"
                  + (" (prefix_quant: a ConvNeXt has no int8 prefix, the "
                     "bf16 prefix runs, as in JAX)"
                     if cfg.prefix_quant and not int8 else ""))
    elif cfg.fused_prefix > 0:
        # every prefix block must be frozen: no gradient reaches it
        max_prefix = max(0, n_blocks + 1 - unlocked_groups)
        if cfg.fused_prefix > max_prefix:
            raise ValueError(
                f"finetune.fused_prefix={cfg.fused_prefix} exceeds the frozen "
                f"bottom depth ({max_prefix} blocks at unlocked_groups="
                f"{unlocked_groups}); the prefix must be entirely frozen")
    report = trainable_report(mask)
    if verbose:
        print(f"Trainable params: {report['num_trainable']} "
              f"({report['fraction_trainable']:.1%})")
        print(f"Frozen params   : {report['num_frozen']}")
        for top, cnt in sorted(report["by_top_module"].items()):
            print(f"  {top}: {cnt} params")
    if cfg.tune_text and prompt_tokens is None:
        raise ValueError("tune_text=True requires prompt_tokens")
    if not cfg.tune_text and text_weights is None:
        raise ValueError("tune_text=False requires precomputed text_weights")

    opt, step = make_train_step(model, cfg, text_weights, prompt_tokens)
    # the frozen prefix's weights, packed (or quantized) once per run
    pprefix = _quantize_prefix(model, cfg) or _pack_prefix(model, cfg)

    def current_text_weights():
        if cfg.tune_text:
            with torch.inference_mode():
                return compute_text_weights(model, prompt_tokens,
                                            cfg.num_classes,
                                            cfg.num_templates)
        return text_weights

    def run_eval(view, **kw):
        return evaluate(model, view, current_text_weights(), cfg.resolution,
                        cfg.num_classes, compute_dtype=cfg.compute_dtype,
                        **kw)

    if verbose:
        print("\nStart Training procedure")
    val_metrics = None
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        lr_e = cosine_lr(cfg.lr, epoch, cfg.epochs)
        step_metrics = []
        for bi, batch in enumerate(train_view.batches(epoch=epoch)):
            step_metrics.append(step(
                torch.from_numpy(batch.images).to(dev),
                torch.from_numpy(batch.labels).to(dev),
                torch.from_numpy(batch.valid).to(dev),
                step_generator(seed, epoch, bi), lr_e, pprefix))
        run_batches = len(step_metrics)
        run_loss = correct = seen = 0.0
        if step_metrics:   # one host sync per epoch
            sums = torch.stack([torch.stack([m["loss"], m["correct"].float(),
                                             m["n_valid"]])
                                for m in step_metrics]).sum(0).tolist()
            run_loss, correct, seen = sums
        if verbose:
            print(f"Train Epoch: {epoch + 1} / {cfg.epochs}  "
                  f"Acc: {correct / max(seen, 1):.4f} "
                  f"({int(correct)}/{int(seen)}), "
                  f"Avg Loss: {run_loss / max(run_batches, 1):.4f}, "
                  f"LR: {lr_e:.2e}, {time.perf_counter() - t0:.1f}s")
        if logger is not None:
            logger.log({"epoch": epoch + 1,
                        "train_loss": run_loss / max(run_batches, 1),
                        "train_acc": correct / max(seen, 1), "lr": lr_e})

        do_val = ((cfg.val_interval and (epoch + 1) % cfg.val_interval == 0)
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
    return {
        "val": val_metrics,
        "test": test_metrics,
        "params": {n: p.detach() for n, p in model.named_parameters()},
        "opt_state": opt.state_dict(),
        "tracker": tracker,
        "report": report,
        "mask": mask,
    }
