"""Top-level run orchestration (counterpart of ``aihab_clip_tpu/runner.py``):
config -> model + text head -> loaders -> (inspect | feature cache | ProLIP
| PEFT) -> metrics and logging.  The library core behind
``python -m aihab_clip_tpu_torch``.

  * ``clip_backend: openai``   -> ProLIP on the pre-projection feature cache;
  * ``clip_backend: openclip`` -> PEFT (``train.peft.finetune``).

A model that does not load (no file, cache, snapshot or download) falls
back to random weights of ``fallback_arch`` with a warning (zero-egress
machines), as in JAX, except ``random:`` names and SigLIP names without a
snapshot (random weights only with ``allow_random_weights``), which raise.
A ModifiedResNet checkpoint or zoo name (RN50 is the openai backend's
default ``backbone``) loads as any other.  Every stage runs on ``device`` (default the card): in bf16 there,
where the image encodes go through ``encode_image_fastest`` (K1 per block
for a CLIP ViT, the BatchNorm-folded convs for a ResNet, the pack built
once), and in fp32 on the CPU, where the canonical module runs.  Model checkpoints (``utils/checkpointing.py``): the
params-only warm start (``finetune.checkpoint``: a path or ``latest``),
``finetune.resume``, ``eval_only`` from a checkpoint, periodic async saves
(``checkpoint_interval``), the final ``save_model`` (with LoRA also
``lora_adapters.npz``) and ``cache_embeddings_checkpoint``.

Parallelism (``parallel.enabled``: true, false or auto, a mesh when the
process group has more than one rank; ``model_parallel``, ``fsdp``): the
PEFT steps and evaluations run over a (data, model) mesh of the
``torch.distributed`` ranks (``python -m torch.distributed.run
--nproc_per_node N -m aihab_clip_tpu_torch ...``; ``__main__`` initialises
the process group); ``parallel.enabled: true`` without a process group
raises.  Under ``fsdp`` each transformer block gathers its weights as it
runs (and again in the backward), so a rank holds its shards and one
block's whole weights; LoRA and ``scan_blocks`` read every weight whole
for the step.  The feature cache is written in per-rank shards
(``cache_shard_index``/``cache_shard_count`` override them) behind a
barrier, and rank 0 alone writes checkpoints, adapters and the embedding
cache.
"""

from __future__ import annotations

import contextlib
import random
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from .backend import resolve_device
from .cache import (cache_embeddings, cache_features_from_loader,
                    feature_cache_dir, feature_cache_exists_sharded,
                    read_preprojection_cache)
from .data import SplitView, build_loaders, load_folders
from .models import SigLIPAssetsMissingError, build_text_head
from .models import load as load_model
from .taxonomy import CS_CLASSNAMES, NUM_L2, REASSIGN_LABEL_NAME_L3, l3_to_l2_array
from .templates import CS_TEMPLATES, gen_prompts
from .train.evaluate import evaluate
from .train.peft import PEFTConfig, finetune
from .train.prolip import (ProjectorSpec, evaluate_multi_testsets,
                           grid_search, projector_accuracy, resolve_lambda,
                           train_projector)
from .train.tracker import ClassificationTracker
from .utils import (RunLogger, latest_checkpoint, load_checkpoint,
                    load_params_into, save_checkpoint, save_projector,
                    wait_for_async_saves)


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def compute_dtype_for(device) -> torch.dtype:
    """bf16 on the card (the block kernels' dtype), fp32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def init_clip_and_text_head(cfg, device="cuda") -> Dict[str, Any]:
    """Load the model on ``device`` and build the CS text head.  Returns
    {backend, backbone_name, model, config, source, resolution,
    text_weights, text_weights_before, prompt_tokens, num_templates,
    example_prompts, num_classes, compute_dtype}."""
    dev = resolve_device(device)
    dtype = compute_dtype_for(dev)
    backend = str(cfg.get("clip_backend", "openai")).lower()
    remat = bool(cfg.get("remat", False))
    if backend == "openclip":
        backbone = cfg.get("open_clip_model", cfg.get("backbone", "ViT-B/16"))
        pretrained = cfg.get("open_clip_pretrained", None)
        if pretrained not in (None, "", "openai"):
            print(f"[warn] open_clip_pretrained='{pretrained}' is not "
                  "available in this build; loading the zoo weights for "
                  f"'{backbone}' instead")
        prompts, tpc = gen_prompts(
            use_hierarchy=bool(cfg.get("use_hierarchical_prompts", True)),
            use_descriptive=bool(cfg.get("use_descriptive_prompts", True)))
    else:
        backbone = cfg.get("backbone", "RN50")
        prompts = None
        tpc = len(CS_TEMPLATES)

    try:
        bundle = load_model(
            backbone, dtype=dtype, device=dev,
            cache_dir=cfg.get("clip_cache_dir", None), remat=remat,
            allow_random_fallback=bool(cfg.get("allow_random_weights",
                                               False)))
    except SigLIPAssetsMissingError:
        # SigLIP text encoding without the snapshot's tokenizer would give
        # wrong token ids
        raise
    except Exception as exc:  # zero-egress fallback
        if str(backbone).startswith("random:"):
            raise
        arch = cfg.get("fallback_arch", "ViT-B/16")
        print(f"[warn] could not load weights for '{backbone}' ({exc}); "
              f"falling back to random-init {arch}")
        bundle = load_model(f"random:{arch}", dtype=dtype, device=dev,
                            remat=remat)

    if prompts is None:
        prompts = [t.format(c.replace("_", " "))
                   for c in CS_CLASSNAMES for t in CS_TEMPLATES]
    num_classes = len(CS_CLASSNAMES)
    head = build_text_head(bundle.model, prompts, num_classes, tpc,
                           tokenize_fn=bundle.tokenize_fn)
    # out of inference mode: the PEFT step takes these into autograd
    head = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in head.items()}
    ei = CS_CLASSNAMES.index("Improved Grassland")
    pp = cfg.get("data", {}).get("preprocessing", {})
    return {
        "backend": backend,
        "backbone_name": str(backbone),
        "model": bundle.model,
        "config": bundle.config,
        "source": bundle.source,
        # openclip backends default to the model's native resolution;
        # otherwise the dataset config's resolution wins
        "resolution": (
            int(bundle.config.image_resolution)
            if backend == "openclip" and bool(cfg.get("use_model_preprocess",
                                                      True))
            else int(pp.get("resolution", bundle.config.image_resolution))),
        "text_weights": head["text_weights"],
        "text_weights_before": head["text_weights_before"],
        "prompt_tokens": head["prompt_tokens"],
        "num_templates": tpc,
        "example_prompts": prompts[ei * tpc:(ei + 1) * tpc],
        "num_classes": num_classes,
        "compute_dtype": dtype,
    }


def inspect(cfg, bundle, loaders, max_show: int = 4) -> None:
    """Inspection output (``--inspect_only``): config, pipeline, batches,
    few-shot selection, text-head summary."""
    print("\n==== Loaded Config ====")
    print(cfg)
    pp = cfg.get("data", {}).get("preprocessing", {})
    aug = pp.get("augmentations", {})
    print("\n==== Transform pipeline (device-side) ====")
    crop = ("bottom" if aug.get("bottom_crop") else
            "random_resized(scale 0.5-1.0)" if aug.get("random_crop")
            else "resize+center")
    print(f"train: fused affine warp [crop={crop}, flip={bool(aug.get('flip'))}, "
          f"rotation(±30°)={bool(aug.get('rotation'))}] -> bicubic sample "
          f"@{bundle['resolution']} -> CLIP normalize")
    print(f"eval : bicubic AA resize -> center crop @{bundle['resolution']} "
          f"-> CLIP normalize")

    info = loaders.info
    print("\n==== Train Batch Sample ====")
    batch = next(loaders.train.batches())
    print(f"images: {batch.images.shape}  dtype={batch.images.dtype}")
    shown = batch.labels[batch.valid][:max_show].tolist()
    print(f"labels: {shown}")
    print(f"label names: {[REASSIGN_LABEL_NAME_L3[int(y)] for y in shown]}")
    print("\n==== Loader Sizes ====")
    print(f"train size: {info['train_size']}  num_batches: {info['train_batches']}")
    print(f"validation size: {info['val_size']}  num_batches: {info['val_batches']}")
    if info.get("is_few_shot"):
        print(f"few-shot mode: {info['shots']} per class")
        print("selected indices by class (absolute indices into train array):")
        for cls_id in sorted(info.get("selection_by_class") or {}):
            print(f"  class {cls_id}: {info['selection_by_class'][cls_id]}")
    print("\n==== Test Batch Sample ====")
    batch_te = next(loaders.test.batches())
    print(f"images: {batch_te.images.shape}  dtype={batch_te.images.dtype}")
    shown_te = batch_te.labels[batch_te.valid][:max_show].tolist()
    print(f"labels: {shown_te}")
    print(f"label names: {[REASSIGN_LABEL_NAME_L3[int(y)] for y in shown_te]}")

    dev = bundle["model"].logit_scale.device
    print("\n==== CLIP Init & Text Head ====")
    print({"backend": bundle["backend"], "backbone": bundle["backbone_name"],
           "weights_source": bundle["source"], "platform": dev.type,
           "devices": torch.cuda.device_count() if dev.type == "cuda" else 1})
    print("\nText head summary:")
    tw, twb = bundle["text_weights"], bundle["text_weights_before"]
    print({"num_classes": bundle["num_classes"],
           "num_templates": bundle["num_templates"],
           "text_weights.shape": tuple(tw.shape),
           "text_weights_before.shape":
               tuple(twb.shape) if twb is not None else None,
           "dtype": str(tw.dtype)})
    print("sample class: Improved Grassland")
    print("sample prompts (all templates for class):", bundle["example_prompts"])


def _l2_eval_ctx(cfg, num_classes: int) -> Optional[Dict]:
    ft_cfg = cfg.get("finetune", {})
    if not bool(ft_cfg.get("eval_l2", False)):
        return None
    if cfg.get("subset_l3", []) or []:
        print("[warn] L2 eval disabled because subset_l3 is set.")
        return None
    table = l3_to_l2_array()
    if len(table) != num_classes:
        print("[warn] L2 eval disabled due to L3 mapping size mismatch.")
        return None
    mode = str(ft_cfg.get("l2_eval_mode", "argmax")).lower()
    return {"l3_to_l2": table, "num_l2": NUM_L2, "reduce": "mean",
            "topk": (1,) if mode == "argmax" else (1, 3), "mode": mode,
            "return_confusion_matrix": False}


def _resolve_device_dataset(cfg, loaders, dev):
    """``device_dataset``: true | false | 'chunked' | 'auto'.  'auto'
    (``runner.py:256-277``) keeps the host loop on the CPU and on the card
    stages the train split on the device when its uint8 images take at
    most 4 GiB, else streams it in chunks."""
    setting = cfg.get("device_dataset", "auto")
    if isinstance(setting, bool):
        return setting
    s = str(setting).lower()
    if s == "chunked":
        return "chunked"
    if s != "auto":
        return False
    if dev.type != "cuda":
        return False
    train_bytes = (loaders.train.num_samples
                   * int(np.prod(loaders.train.dataset.images.shape[1:])))
    return True if train_bytes <= 4 * 1024 ** 3 else "chunked"


def _resolve_fused_prefix(setting) -> int:
    """``finetune.fused_prefix``: 'auto' (-1, resolved in ``finetune``),
    'off'/false/0, or an explicit frozen bottom-block count."""
    if isinstance(setting, bool):
        return -1 if setting else 0
    s = str(setting).lower()
    if s == "auto":
        return -1
    if s in ("off", "false", "none"):
        return 0
    return int(setting)


def _build_mesh(cfg, dev):
    """The (data, model) mesh of the PEFT and evaluation paths, or None:
    ``parallel.enabled`` true, false or auto (a mesh when the process
    group has more than one rank); ``parallel.model_parallel`` the TP
    degree.  true without a process group raises."""
    from .parallel.distributed import is_initialized, world_size
    from .parallel.mesh import make_mesh

    par = cfg.get("parallel", {}) or {}
    enabled = par.get("enabled", "auto")
    n = world_size()
    use = enabled if isinstance(enabled, bool) else n > 1
    if not use:
        return None
    if not is_initialized():
        raise RuntimeError(
            "parallel.enabled: true needs a torch.distributed process "
            "group: launch with python -m torch.distributed.run "
            "--nproc_per_node N -m aihab_clip_tpu_torch ...")
    mesh = make_mesh(model_parallel=int(par.get("model_parallel", 1)),
                     device=dev)
    print(f"[parallel] mesh {mesh.describe()}")
    return mesh


def _cache_shard_kwargs(cfg) -> Dict[str, Optional[int]]:
    """The cache shard overrides (default: the rank and the world size
    inside the writer)."""
    si = cfg.get("cache_shard_index", None)
    sc = cfg.get("cache_shard_count", None)
    return {"shard_index": None if si is None else int(si),
            "shard_count": None if sc is None else int(sc)}


def _cache_write_barrier() -> None:
    """Every rank writes only its own cache shard: wait for all before
    anyone reads (the sharded reader refuses an incomplete shard set, the
    barrier avoids the race)."""
    from .parallel.distributed import world_size

    if world_size() > 1:
        torch.distributed.barrier()


def _writer() -> bool:
    """Rank 0 (or the only process) writes the run's files."""
    from .parallel.distributed import rank

    return rank() == 0


def _split_view(loaders, split: str):
    return {"train": loaders.train, "val": loaders.val,
            "test": loaders.test}.get(split, loaders.test)


def _maybe_restore_checkpoint(cfg, bundle) -> Optional[str]:
    """The params-only warm start from ``finetune.checkpoint`` (a path or
    ``latest``) into the bundle's model; returns the path restored."""
    ckpt = cfg.get("finetune", {}).get("checkpoint", None)
    if not ckpt:
        return None
    path = latest_checkpoint(cfg) if str(ckpt) == "latest" else Path(ckpt)
    if path is None:
        print("[ckpt] no checkpoint found to restore")
        return None
    load_params_into(bundle["model"], load_checkpoint(path)["params"])
    print(f"[ckpt] restored params from {path}")
    return str(path)


def run_peft(cfg, bundle, loaders, logger=None, config_file: str = "cfg"
             ) -> Dict[str, Any]:
    """The fine-tune through ``train.peft.finetune`` (partial unfreeze or
    LoRA), with the checkpoint branches of ``runner.py:295-464``."""
    ft_cfg = cfg.get("finetune", {})
    aug = cfg["data"]["preprocessing"].get("augmentations", {})
    model = bundle["model"]
    dev = model.logit_scale.device
    dtype = bundle["compute_dtype"]
    mesh = _build_mesh(cfg, dev)
    fsdp = mesh is not None and bool(
        (cfg.get("parallel", {}) or {}).get("fsdp", False))
    l2_ctx = _l2_eval_ctx(cfg, bundle["num_classes"])

    # resume: the parameters, the optimizer state and the epoch, restored
    # inside finetune; otherwise finetune.checkpoint is a params-only start
    resume_from = restored_from = None
    if bool(ft_cfg.get("resume", False)):
        ckpt = ft_cfg.get("checkpoint", None) or "latest"
        resume_from = (latest_checkpoint(cfg) if str(ckpt) == "latest"
                       else Path(ckpt))
        if resume_from is None:
            print("[resume] no checkpoint found; starting fresh")
    else:
        restored_from = _maybe_restore_checkpoint(cfg, bundle)

    if bool(ft_cfg.get("eval_only", False)):
        if resume_from is not None:
            # resume + eval_only: evaluate the checkpoint
            load_params_into(model, load_checkpoint(resume_from)["params"])
            restored_from = str(resume_from)
            print(f"[eval_only] restored params from {resume_from}")
        tracker = ClassificationTracker()
        test = evaluate(model, loaders.test, bundle["text_weights"],
                        bundle["resolution"], bundle["num_classes"],
                        compute_dtype=dtype, return_confusion_matrix=True,
                        l2_eval_ctx=l2_ctx, tracker=tracker, mesh=mesh)
        print(f"[eval_only] top1={test['top1']:.4f} top3={test['top3']:.4f} "
              f"f1={test['f1']:.4f} mcc={test['mcc']:.4f}")
        if logger is not None:
            tracker.save_classification(logger)
        if bool(ft_cfg.get("cache_embeddings", False)) and _writer():
            split = str(ft_cfg.get("cache_embeddings_split", "test")).lower()
            cache_embeddings(cfg, model, _split_view(loaders, split),
                             bundle["resolution"], split=split,
                             checkpoint_path=restored_from,
                             compute_dtype=dtype)
        return {"val": None, "test": test,
                "params": {n: p.detach() for n, p in model.named_parameters()},
                "opt_state": None, "tracker": tracker, "report": None,
                "mask": None}

    pcfg = PEFTConfig(
        resolution=bundle["resolution"],
        num_classes=bundle["num_classes"],
        lr=float(cfg.get("lr_v", 5e-5)),
        epochs=int(cfg.get("train_epoch", 1)),
        crop_mode=("bottom" if aug.get("bottom_crop") else
                   "random" if aug.get("random_crop") else "center"),
        flip=bool(aug.get("flip", False)),
        rotation=bool(aug.get("rotation", False)),
        aug_impl=str(cfg.get("aug_impl", "fast")),
        tune_text=bool(ft_cfg.get("tune_text", False)),
        num_templates=bundle["num_templates"],
        compute_dtype=dtype,
        val_interval=int(ft_cfg.get("val_interval", 0)),
        fused_prefix=_resolve_fused_prefix(ft_cfg.get("fused_prefix", "auto")),
        prefix_quant=bool(ft_cfg.get("fused_prefix_quant", False)),
        device_dataset=_resolve_device_dataset(cfg, loaders, dev),
        checkpoint_interval=int(ft_cfg.get("checkpoint_interval", 0)),
        scan_blocks=bool(ft_cfg.get("scan_blocks", False)),
        scan_remat=bool(ft_cfg.get("scan_remat", True)),
        lora_rank=int(ft_cfg.get("lora_rank", 0)),
        lora_alpha=float(ft_cfg.get("lora_alpha", 16.0)),
        lora_mlp=bool(ft_cfg.get("lora_mlp", False)),
    )
    save_model = bool(ft_cfg.get("save_model", False))
    checkpoint_fn = None
    if pcfg.checkpoint_interval and save_model:
        def checkpoint_fn(par, opt_state, epoch):
            # the host copy happens here; the disk write overlaps the next
            # epochs (waited for after training); every rank gathered the
            # whole state, rank 0 writes it
            if not _writer():
                return
            try:
                p = save_checkpoint(cfg, par, opt_state, epoch=epoch,
                                    async_save=True)
                print(f"[ckpt] epoch {epoch} -> {p} (async)", flush=True)
            except Exception as exc:
                print(f"[ckpt] periodic save failed: {exc}")

    t0 = time.perf_counter()
    out = finetune(
        model, loaders.train, loaders.val, loaders.test, pcfg,
        text_weights=bundle["text_weights"],
        prompt_tokens=bundle["prompt_tokens"],
        unlocked_groups=int(ft_cfg.get("unlocked_groups", 1)),
        unlocked_text_layers=int(ft_cfg.get("unlocked_layers", 1)),
        seed=int(cfg.get("seed", 1)), l2_eval_ctx=l2_ctx, logger=logger,
        checkpoint_fn=checkpoint_fn, resume_from=resume_from, mesh=mesh,
        fsdp=fsdp, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["seconds"] = time.perf_counter() - t0
    if checkpoint_fn is not None:
        wait_for_async_saves()

    saved_path = None
    interrupted = out.get("interrupted_at_epoch")
    # a run interrupted before its last epoch saves the epoch it reached
    # (checkpoint_fn already did, when wired): JAX saves it under the
    # configured epoch count, which a resume would take as finished
    if interrupted == pcfg.epochs:
        interrupted = None
    if save_model and _writer() and not (interrupted
                                         and checkpoint_fn is not None):
        try:
            saved_path = save_checkpoint(cfg, out["params"], out["opt_state"],
                                         epoch=interrupted or pcfg.epochs)
            print(f"[ckpt] saved -> {saved_path}")
        except Exception as exc:
            print(f"[ckpt] save failed: {exc}")
    if save_model and out.get("adapters") and _writer():
        # LoRA: the adapters alone reproduce the run from the base weights,
        # in JAX's file format (lora_adapters.npz, its keys and layouts)
        from .models.convert import port_adapters_to_flax

        try:
            adir = (Path(str(saved_path)).parent if saved_path
                    else Path(str(ft_cfg.get("save_model_dir",
                                             "./model_ckpt"))))
            adir.mkdir(parents=True, exist_ok=True)
            apath = adir / "lora_adapters.npz"
            np.savez(apath, **port_adapters_to_flax(out["adapters"]))
            out["adapters_path"] = str(apath)
            print(f"[ckpt] LoRA adapters -> {apath}")
        except Exception as exc:
            print(f"[ckpt] adapter save failed: {exc}")
    out["checkpoint_path"] = str(saved_path) if saved_path else None

    if bool(ft_cfg.get("cache_embeddings", False)) and _writer():
        split = str(ft_cfg.get("cache_embeddings_split", "test")).lower()
        view = _split_view(loaders, split)
        if view is None or view.num_samples == 0:
            print(f"[warn] cache_embeddings requested but split '{split}' "
                  "is empty.")
        else:
            from .train.lora import lora_applied

            adapters = out.get("adapters")
            with (lora_applied(model, adapters, pcfg.lora_alpha)
                  if adapters else contextlib.nullcontext()):
                cache_embeddings(cfg, model, view, bundle["resolution"],
                                 split=split, checkpoint_path=saved_path,
                                 compute_dtype=dtype)
    if out["tracker"] is not None and logger is not None:
        out["tracker"].save_classification(logger)
    if (out["test"] is not None and out["test"].get("cm") is not None
            and logger is not None):
        logger.log_confusion_matrix(out["test"]["cm"], CS_CLASSNAMES)
    return out


def _refuse_poisoned_cache(bundle) -> None:
    """The feature cache is keyed by the REQUESTED backbone, so features
    from fallback random weights would poison it for every later run with
    working weights: refuse."""
    if (str(bundle.get("source", "")) == "random"
            and not str(bundle.get("backbone_name", "")).startswith(
                "random:")):
        raise RuntimeError(
            f"refusing to write a feature cache for "
            f"'{bundle.get('backbone_name')}' from fallback RANDOM weights "
            "(the cache is keyed by the requested backbone; later runs "
            "with real weights would silently consume random features). "
            "Fix the weight load or use an explicit 'random:' backbone.")


def _write_feature_cache(cfg, bundle, loaders, packed=None) -> Dict:
    _refuse_poisoned_cache(bundle)
    manifest = cache_features_from_loader(
        cfg, bundle["model"], loaders.train, bundle["resolution"],
        loaders.info, compute_dtype=bundle["compute_dtype"], packed=packed,
        **_cache_shard_kwargs(cfg))
    _cache_write_barrier()
    return manifest


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_prolip(cfg, bundle, loaders, logger=None, config_file: str = "cfg"
               ) -> Dict[str, Any]:
    """ProLIP projector tuning on the cached pre-projection features.
    Returns {loss, acc, lr, lambda, projector, stats, extra, val_feats,
    val_labels, grid_accs, test_feats, test_labels, timings}."""
    from .models.fast_vit import encode_image_fastest, pack_fastest
    from .ops.preprocess import eval_transform, normalize_stats_for

    model = bundle["model"]
    config = model.config
    dev = model.logit_scale.device
    dtype = bundle["compute_dtype"]
    text_weights = bundle["text_weights"].float()
    num_classes = bundle["num_classes"]
    resolution = bundle["resolution"]
    shots = int(cfg.get("shots", 0) or 0)
    seed = int(cfg.get("seed", 1) or 1)
    aug_views = int(cfg.get("aug_views", 1) or 1)
    timings: Dict[str, float] = {}
    # the tower's weights in the kernels' layout, built once for the path
    pack = pack_fastest(model, config, dtype) if dev.type == "cuda" else None

    cache_dir = feature_cache_dir(cfg)
    if not feature_cache_exists_sharded(cache_dir, aug_views):
        if cfg.get("finetune", {}).get("require_cached_features", True):
            raise FileNotFoundError(
                f"Cached features not found in {cache_dir}; run with "
                f"save_features=True first.")
        print(f"[warn] Cached features missing in {cache_dir}; generating now.")
        _write_feature_cache(cfg, bundle, loaders, packed=pack)

    views, labels = read_preprojection_cache(cache_dir, aug_views,
                                             max_label=num_classes)
    init_spec = ProjectorSpec.from_clip_model(model)
    nmean, nstd = normalize_stats_for(config)

    @torch.inference_mode()
    def encode_split(view):
        feats, labs = [], []
        for batch in view.batches():
            x = eval_transform(torch.from_numpy(batch.images).to(dev),
                               resolution, dtype=dtype, mean=nmean, std=nstd)
            pre = encode_image_fastest(model, x, config, packed=pack)
            feats.append(pre.float()[torch.from_numpy(batch.valid).to(dev)])
            labs.append(batch.labels[batch.valid])
        return torch.cat(feats).cpu().numpy(), np.concatenate(labs, 0)

    epochs = int(cfg.get("train_epoch", 5))
    feat_bs = int(cfg.get("feat_batch_size", 0) or 0)
    val_feats = val_labels = grid_accs = None
    if bool(cfg.get("search_lr", False)):
        t0 = time.perf_counter()
        val_feats, val_labels = encode_split(loaders.val)
        timings["val_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lr_v, lambda_v, best_acc, grid_accs = grid_search(
            views, labels, text_weights, init_spec, val_feats, val_labels,
            epochs, device=dev, return_accs=True)
        _sync(dev)
        timings["grid_search_s"] = time.perf_counter() - t0
        print(f"Search completed ===> lr: {lr_v}, lambda: {lambda_v} "
              f"(val acc {best_acc:.4f})")
        out_path = (Path("results_lr") / config_file /
                    f"{cfg.get('dataset', 'cs')}{shots}_shot_lr.txt")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with out_path.open("a", encoding="utf-8") as f:
            f.write(f"{lr_v}, {lambda_v}\n")
    else:
        lr_v = float(cfg.get("lr_v", 5e-5))
        lambda_v = resolve_lambda(cfg, shots)
        print(f"Search completed ===> lr: {lr_v}, lambda: {lambda_v}")

    t0 = time.perf_counter()
    proj, stats = train_projector(views, labels, text_weights, init_spec,
                                  lr_v, lambda_v, epochs,
                                  feat_batch_size=feat_bs, device=dev)
    _sync(dev)
    timings["train_projector_s"] = time.perf_counter() - t0
    print(f"Total time = {timings['train_projector_s']:.4f}")

    if bool(cfg.get("save_checkpoints", False)):
        save_path = (Path("trained_models") / config_file /
                     str(cfg.get("dataset", "cs")) / f"{shots}_shot" /
                     f"{cfg.get('dataset', 'cs')}_seed{seed}.npz")
        save_projector(save_path, proj.weight, proj.bias,
                       meta={"lr": lr_v, "lambda": lambda_v,
                             "epochs": epochs, "seed": seed})
        print(f"[ckpt] projector saved -> {save_path}")

    print("\nStart evaluation on test set")
    t0 = time.perf_counter()
    test_feats, test_labels = encode_split(loaders.test)
    timings["test_encode_s"] = time.perf_counter() - t0
    timings["test_images"] = float(len(test_labels))
    acc_test = projector_accuracy(proj, test_feats, test_labels, text_weights)

    extra_results = {}
    extra = cfg.get("extra_testsets", None) or {}
    if extra:
        extra_views = {}
        for name, spec in extra.items():
            ds_extra = load_folders(
                spec["dataset_paths"], spec["index_file_names"],
                int(cfg["data"]["preprocessing"].get("resize", 256)),
                channel_order=str(cfg["data"].get("channel_order", "rgb")),
                prescale=bool(cfg["data"].get("decode_prescale", True)),
                device=dev)
            extra_views[name] = SplitView(ds_extra, np.arange(len(ds_extra)),
                                          int(cfg["data"]["batch_size"]))
        extra_results = evaluate_multi_testsets(
            proj, encode_split, extra_views, {}, text_weights)
        for name, acc in extra_results.items():
            print(f"[extra testset {name}] acc={acc:.4f}")

    if logger is not None:
        logger.log({"acc": acc_test, **{f"acc_{k}": v
                                        for k, v in extra_results.items()}})
    return {"loss": stats.get("final_loss"), "acc": acc_test, "lr": lr_v,
            "lambda": lambda_v, "projector": proj, "stats": stats,
            "extra": extra_results, "val_feats": val_feats,
            "val_labels": val_labels, "grid_accs": grid_accs,
            "test_feats": test_feats, "test_labels": test_labels,
            "timings": timings}


def run(cfg, inspect_only: bool = False, config_file: str = "cfg",
        logger_mode: str = "auto", run_name: Optional[str] = None,
        device="cuda") -> Dict[str, Any]:
    """The full pipeline on ``device`` (default the card; raises without
    one unless ``device="cpu"``).  Returns {bundle, loaders, timings, and
    prolip or peft}."""
    dev = resolve_device(device)
    set_seed(int(cfg.get("seed", 1)))
    backend = str(cfg.get("clip_backend", "openai")).lower()
    timings: Dict[str, float] = {}

    logger = None
    if cfg.get("finetune", {}).get("enabled", False) \
            and cfg.get("wandb_project", None):
        if run_name is None:
            run_name = (f"{cfg.get('dataset', 'ds')}_"
                        f"shots{cfg.get('shots', 0)}_"
                        f"seed{cfg.get('seed', 1)}_"
                        f"{cfg.get('backbone', 'clip')}_"
                        f"{cfg.get('train_epoch', 0)}eps_proj")
        logger = RunLogger(cfg.get("wandb_project"), run_name, config=cfg,
                           mode=logger_mode)

    bundle = init_clip_and_text_head(cfg, dev)
    t0 = time.perf_counter()
    loaders = build_loaders(cfg, device=dev)
    timings["build_loaders_s"] = time.perf_counter() - t0
    inspect(cfg, bundle, loaders)

    result: Dict[str, Any] = {"bundle": bundle, "loaders": loaders,
                              "timings": timings}
    if inspect_only:
        print("\nInspection-only run; skipping caching and training.")
        if logger:
            logger.finish()
        return result

    if bool(cfg.get("save_features", False)):
        t0 = time.perf_counter()
        _write_feature_cache(cfg, bundle, loaders)
        timings["cache_write_s"] = time.perf_counter() - t0
        timings["cache_write_images"] = float(
            loaders.train.num_samples * int(cfg.get("aug_views", 1) or 1))

    ft_cfg = cfg.get("finetune", {})
    do_finetune = ft_cfg.get("enabled", False)
    if do_finetune and backend == "openclip":
        out = run_peft(cfg, bundle, loaders, logger, config_file)
        result["peft"] = out
        if out["test"] is not None:
            t = out["test"]
            print("\n==== OpenCLIP Finetune results ====")
            print(f"Loss: {t['loss']}, Top-1 Accuracy: {t['top1']}, "
                  f"Top-3 Accuracy: {t['top3']}, F1 (weighted): {t['f1']}, "
                  f"MCC: {t['mcc']}")
            if logger is not None:
                logger.log({"top1_acc": t["top1"], "top3_acc": t["top3"],
                            "f1": t["f1"], "mcc": t["mcc"], "loss": t["loss"]})
    elif do_finetune and backend == "openai":
        out = run_prolip(cfg, bundle, loaders, logger, config_file)
        result["prolip"] = out
        timings.update(out["timings"])
        print("\n==== ProLIP results ====")
        print(f"Loss: {out['loss']}, Accuracy: {out['acc']}")
    else:
        print("\nFinetune disabled (finetune.enabled=False).")
        # embeddings of a saved checkpoint, without training
        ckpt = ft_cfg.get("cache_embeddings_checkpoint", None)
        if bool(ft_cfg.get("cache_embeddings", False)) and ckpt:
            model = bundle["model"]
            load_params_into(model, load_checkpoint(ckpt)["params"])
            split = str(ft_cfg.get("cache_embeddings_split", "test")).lower()
            cache_embeddings(cfg, model, _split_view(loaders, split),
                             bundle["resolution"], split=split,
                             checkpoint_path=str(ckpt),
                             compute_dtype=bundle["compute_dtype"])

    if logger is not None:
        logger.finish()
    return result
