"""One rank of the port's multi-rank CPU tests (``tests/test_torch_
parallel*.py``): run as ``python tests/torch_parallel_worker.py <case>
<workdir>`` under a launcher's environment, it joins a gloo process group, runs
``CASES[case]`` over the inputs the test wrote to ``<workdir>/inputs.pt``
and saves its results to ``<workdir>/<case>_<rank>.pt``.  It imports
nothing but ``aihab_clip_tpu_torch`` (and torch, numpy).

``launch`` starts the ranks as subprocesses with a hard timeout: on expiry
or on any rank's failure every rank is killed (each in a process group of
its own) and the test fails with the ranks' output.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def launch(case: str, world: int, workdir, timeout: float = 120.0):
    """Run ``case`` on ``world`` ranks (``parallel.distributed.
    spawn_ranks``: a free port, a hard timeout, every rank killed on a
    failure); returns each rank's results."""
    import torch

    from aihab_clip_tpu_torch.parallel.distributed import spawn_ranks

    workdir = Path(workdir)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    try:
        spawn_ranks([__file__, case, str(workdir)], world, timeout, env=env,
                    cwd=str(workdir))
    except RuntimeError as exc:
        raise AssertionError(str(exc)) from None
    return [torch.load(workdir / f"{case}_{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the cases (run inside a rank)
# ---------------------------------------------------------------------------


def _inputs(workdir):
    import torch

    return torch.load(Path(workdir) / "inputs.pt", weights_only=False)


def _model(inp, tower=None):
    """The tests' CLIP tower, or ``inp["towers"][tower]``'s (its config
    dict and state dict; SigLIP's config has ``text_width``)."""
    from aihab_clip_tpu_torch.models import (CLIPConfig, CLIPModel,
                                             SigLIPConfig, SigLIPModel)

    config, sd = ((inp["config"], inp["state_dict"]) if tower is None
                  else inp["towers"][tower])
    if "text_width" in config:
        model = SigLIPModel(SigLIPConfig(**config))
    else:
        model = CLIPModel(CLIPConfig(**config))
    model.load_state_dict(sd)
    return model.eval()


def _peft_cfg(inp, **kw):
    import torch

    from aihab_clip_tpu_torch.train.peft import PEFTConfig

    base = dict(resolution=inp["resolution"], num_classes=inp["num_classes"],
                lr=inp["lr"], epochs=1, crop_mode="center",
                tune_text=inp["tune_text"],
                num_templates=inp["num_templates"],
                compute_dtype=torch.float32, fused_prefix=0)
    base.update(kw)
    return PEFTConfig(**base)


def _batch(inp):
    import torch

    return tuple(torch.from_numpy(inp[k])
                 for k in ("images", "labels", "valid"))


def _step(inp, mesh=None, fsdp=False, tower=None, control=False,
          **cfg_kw):
    """One PEFT step on a fresh model (``dryrun_multichip.parallel_step``;
    ``tower`` one of ``inp["towers"]``, its prompt tokens and unlock
    depth; ``control``: every weight gathered whole, the replicated
    forward): {loss, correct, grads, params} (whole tensors, the trainable
    ones by name) and every parameter's local shape."""
    from aihab_clip_tpu_torch.tools.dryrun_multichip import _parallel_step
    from aihab_clip_tpu_torch.train.peft import (build_lock_mask,
                                                 step_generator)

    model = _model(inp, tower)
    c = model.config
    tokens = inp["prompt_tokens"] if tower is None \
        else inp["tower_tokens"][tower]
    unlocked = inp["unlocked_groups"] if tower is None \
        else inp["tower_unlocked"][tower]
    build_lock_mask(model, c.vision_layers,
                    getattr(c, "transformer_layers", None)
                    or getattr(c, "text_layers", None),
                    unlocked_groups=unlocked, tune_text=inp["tune_text"],
                    unlocked_text_layers=inp["unlocked_text_layers"])
    out = _parallel_step(model, _peft_cfg(inp, **cfg_kw),
                         inp["text_weights"], tokens, _batch(inp),
                         step_generator(0, 0, 0), mesh, fsdp, None, None,
                         control)
    return {"loss": out["loss"], "correct": out["correct"],
            "grads": out["grads"], "params": out["params"],
            "local_shapes": {n: tuple(p.shape)
                             for n, p in model.named_parameters()}}


def lora_adapters(model):
    """The LoRA steps' adapters (rank 2, attention; B drawn at N(0, 0.05),
    away from zero, so A's gradient is not 0), drawn alike by every rank
    and by the test."""
    import torch

    from aihab_clip_tpu_torch.train.lora import lora_init

    adapters = lora_init(model, 2, torch.Generator().manual_seed(7))
    with torch.no_grad():
        for ab in adapters.values():
            ab["b"].normal_(0, 0.05, generator=torch.Generator().manual_seed(8))
    return adapters


def _lora_step(inp, mesh=None, fsdp=False, control=False):
    """One LoRA step (``lora_adapters``; the base frozen, with ``fsdp``
    sharded; ``control`` as ``_step``'s): {loss, grads, params} of the
    adapters."""
    from aihab_clip_tpu_torch.tools.dryrun_multichip import _parallel_step
    from aihab_clip_tpu_torch.train.peft import step_generator

    model = _model(inp)
    model.requires_grad_(False)
    adapters = lora_adapters(model)
    out = _parallel_step(model, _peft_cfg(inp, lora_rank=2,
                                          tune_text=False),
                         inp["text_weights"], None, _batch(inp),
                         step_generator(0, 0, 0), mesh, fsdp, adapters, None,
                         control)
    return {k: out[k] for k in ("loss", "correct", "grads", "params")}


@contextlib.contextmanager
def _fsdp_kept():
    """Around an FSDP step: {"gathered": how many gathers of the tower
    blocks' weights ran (``Sharding.full`` of a block's parameter, and
    with LoRA each W_eff merged from them), "kept": how many whole weights
    of a block autograd kept for the backward outside a checkpoint (saved
    tensors on the storage of a gathered one still alive), "live_blocks":
    the most blocks whose whole weights were alive at once}."""
    import re
    import weakref

    import torch

    from aihab_clip_tpu_torch.parallel import mesh as pmesh
    from aihab_clip_tpu_torch.train import lora as plora

    block = re.compile(r"^(.*(?:resblocks\.\d+|stage\d+_block\d+|"
                       r"layer\d+_\d+))\.")
    alive, stats = [], {"gathered": 0, "kept": 0, "live_blocks": 0}

    def record(name, t):
        m = block.match(name)
        if m is None:
            return
        alive[:] = [(b, r) for b, r in alive if r() is not None]
        alive.append((m.group(1), weakref.ref(t)))
        stats["gathered"] += 1
        stats["live_blocks"] = max(stats["live_blocks"],
                                   len({b for b, _ in alive}))

    full, merge = pmesh.Sharding.full, plora.lora_merge

    def recorded_full(self, name, local, *args, **kw):
        t = full(self, name, local, *args, **kw)
        record(name, t)
        return t

    def recorded_merge(params, adapters, alpha):
        out = merge(params, adapters, alpha)
        for name in adapters:
            record(name, out[name])
        return out

    def pack(t):
        ptrs = {r().untyped_storage().data_ptr() for _, r in alive
                if r() is not None}
        stats["kept"] += t.untyped_storage().data_ptr() in ptrs
        return t

    pmesh.Sharding.full, plora.lora_merge = recorded_full, recorded_merge
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            yield stats
    finally:
        pmesh.Sharding.full, plora.lora_merge = full, merge


def case_steps(rank, world, workdir):
    """Single-rank, DP, FSDP and (data x) model 2 steps of the same global
    batch: tp on 2 ranks, dp 2 x tp 2 and FSDP composed with it on 4."""
    import torch

    from aihab_clip_tpu_torch.parallel.mesh import make_mesh

    inp = _inputs(workdir)
    tp = "tp" if world == 2 else "dp_tp"
    dp = make_mesh(device="cpu")
    kept = {}
    with _fsdp_kept() as kept["per_block"]:
        fsdp = _step(inp, dp, fsdp=True)
    out = {"single": _step(inp) if rank == 0 else None,
           "dp": _step(inp, dp), "fsdp": fsdp,
           tp: _step(inp, make_mesh(model_parallel=2, device="cpu")),
           "scan_" + tp: _step(inp, make_mesh(model_parallel=2,
                                              device="cpu"),
                               scan_blocks=True, scan_remat=True)}
    if world == 4:
        out["fsdp_tp"] = _step(inp, make_mesh(model_parallel=2,
                                              device="cpu"), fsdp=True)
    else:
        out["lora_single"] = _lora_step(inp) if rank == 0 else None
        out["lora_dp"] = _lora_step(inp, dp)
        # FSDP per block (what autograd keeps recorded) and its
        # whole-gather control: LoRA, the scanned encodes (with and
        # without remat; their control is the module's, ``fsdp_whole``),
        # ConvNeXt and RN
        arms = (("lora", _lora_step, True),
                ("scan", functools.partial(_step, scan_blocks=True,
                                           scan_remat=False), False),
                ("convnext", functools.partial(_step, tower="convnext"),
                 True),
                ("rn", functools.partial(_step, tower="rn"), True))
        for kind, step, control in arms:
            with _fsdp_kept() as kept[kind]:
                out[f"{kind}_fsdp"] = step(inp, dp, fsdp=True)
            if control:
                out[f"{kind}_fsdp_whole"] = step(inp, dp, fsdp=True,
                                                 control=True)
        out["scan_remat_fsdp"] = _step(inp, dp, fsdp=True, scan_blocks=True,
                                       scan_remat=True)
        out["fsdp_whole"] = _step(inp, dp, fsdp=True, control=True)
        out["tp_whole"] = _step(inp, make_mesh(model_parallel=2,
                                               device="cpu"),
                                control=True)
        for tower in ("convnext", "rn"):
            out[f"{tower}_single"] = (_step(inp, tower=tower) if rank == 0
                                      else None)
        # SigLIP's towers and MAP head as tensor-parallel shards
        out["siglip_single"] = (_step(inp, tower="siglip") if rank == 0
                                else None)
        out["siglip_tp"] = _step(inp, make_mesh(model_parallel=2,
                                                device="cpu"),
                                 tower="siglip")
        out["fsdp_kept"] = kept
    torch.save(out, Path(workdir) / f"steps_{rank}.pt")


def _pipe_model(inp):
    from aihab_clip_tpu_torch.models import CLIPConfig, CLIPModel

    model = CLIPModel(CLIPConfig(**inp["pipe_config"]))
    model.load_state_dict(inp["pipe_state_dict"])
    return model.eval()


def _pipe_encode(inp, model, mesh, n_micro, grads: bool):
    """pipeline_encode of the global images (fp32) and, with ``grads``,
    the gradients of sum(pre^2) by the stacked layout."""
    import torch

    from aihab_clip_tpu_torch.parallel.pipeline import (
        STAGE_AXIS, pipeline_encode, place_stage_params, stack_stage_params)

    c = model.config
    n_stages = mesh.shape[STAGE_AXIS]
    stage = place_stage_params(mesh, stack_stage_params(
        model, c.vision_layers, n_stages))
    x = torch.from_numpy(inp["pipe_images"]).requires_grad_(grads)
    pre, post = pipeline_encode(model, stage, x, c, mesh,
                                num_microbatches=n_micro, project=True,
                                dtype=torch.float32)
    out = {"pre": pre.detach(), "post": post.detach()}
    if grads:
        pre.float().pow(2).sum().backward()
        out["g_x"] = x.grad
        out["g_stage"] = {k: v.grad for k, v in stage.items()}
        out["stage"] = mesh.coords[STAGE_AXIS]
    return out


def _pipe_step(inp, mesh, n_micro):
    """One pipeline PEFT step: {loss, correct, blocks (this stage's, after
    the step), head}."""
    import torch

    from aihab_clip_tpu_torch.train.peft import step_generator
    from aihab_clip_tpu_torch.train.pipeline_peft import (
        init_pipeline_trainable, make_pipeline_train_step)

    model = _pipe_model(inp)
    c = model.config
    cfg = _peft_cfg(inp, resolution=c.image_resolution,
                    num_classes=inp["pipe_classes"], crop_mode="center",
                    tune_text=False, num_templates=1)
    trainable = init_pipeline_trainable(model, c, mesh)
    _, step = make_pipeline_train_step(
        model, cfg, inp["pipe_text_weights"], None, mesh,
        num_microbatches=n_micro, unlocked_layers=inp["pipe_unlocked"],
        trainable=trainable)
    m = step(torch.from_numpy(inp["pipe_u8"]),
             torch.from_numpy(inp["pipe_labels"]),
             torch.ones(len(inp["pipe_labels"]), dtype=torch.bool),
             step_generator(0, 0, 0), inp["lr"])
    return {"loss": float(m["loss"]), "correct": int(m["correct"]),
            "blocks": {k: v.detach().clone()
                       for k, v in trainable["blocks"].items()},
            "head": {k: v.detach().clone()
                     for k, v in trainable["head"].items()}}


def case_pipeline(rank, world, workdir):
    """pipeline_encode on a (stage,) mesh of every rank at 2 and 4
    microbatches (forward; gradients at 2), the pipeline train step; on 4
    ranks the composed (data 2, stage 2) layout."""
    import torch

    from aihab_clip_tpu_torch.parallel.pipeline import make_pipeline_mesh

    inp = _inputs(workdir)
    model = _pipe_model(inp)
    out = {}
    if world == 2:
        mesh = make_pipeline_mesh(2, device="cpu")
        out["m2"] = _pipe_encode(inp, model, mesh, 2, grads=True)
        out["m4"] = _pipe_encode(inp, model, mesh, 4, grads=False)
        out["step"] = _pipe_step(inp, mesh, 2)
    else:
        mesh = make_pipeline_mesh(2, data_parallel=2, device="cpu")
        out["dp_pp"] = _pipe_encode(inp, model, mesh, 2, grads=True)
        out["dp_step"] = _pipe_step(inp, mesh, 2)
    torch.save(out, Path(workdir) / f"pipeline_{rank}.pt")


def _view(inp, key="eval", **kw):
    from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView

    images, labels = inp[f"{key}_images"], inp[f"{key}_labels"]
    n = len(labels)
    ds = ImageArrayDataset(
        images=images, labels=labels, l2_labels=np.zeros(n, np.int64),
        poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
        poly_word_labels=[""] * n,
        file_names=[f"img_{i}.jpg" for i in range(n)],
        plot_idx=list(range(n)), image_sources=["synthetic"] * n)
    return SplitView(ds, np.arange(n), inp[f"{key}_batch"], **kw)


def case_mesh(rank, world, workdir):
    """The mesh's layout and collectives: coordinates and groups, the
    batch shard, ``make_global_batch``, ``replicated``, the head-aligned
    gather and its reduce-scatter, ``gather_param``'s two backwards."""
    import torch

    from aihab_clip_tpu_torch.parallel import comm
    from aihab_clip_tpu_torch.parallel.distributed import make_global_batch
    from aihab_clip_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                    replicated, shard_batch)

    mesh = make_mesh(model_parallel=2 if world == 4 else 1, device="cpu")
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    local = shard_batch(mesh, x)
    t = torch.full((3,), float(rank))
    replicated(mesh, t)
    qkv = torch.arange(12, dtype=torch.float32) + 100 * mesh.coords["data"]
    piece = comm.own_piece(qkv, mesh, "data", 0, groups=3)
    whole = comm.all_gather_cat(piece, mesh, "data", 0, groups=3)
    summed = comm.reduce_scatter_dim(torch.ones(12) * (rank + 1), mesh,
                                     "data", 0, groups=3)
    leaf = piece.clone().requires_grad_(True)
    (comm.gather_param(leaf, mesh, "data", 0, groups=3) * 2).sum().backward()
    keep = piece.clone().requires_grad_(True)
    (comm.gather_param(keep, mesh, "data", 0, groups=3,
                       reduce_grad=False) * 2).sum().backward()
    torch.save({"shape": mesh.shape, "coords": mesh.coords,
                "ranks": {a: mesh.axis_ranks(a) for a in mesh.shape},
                "rows": batch_sharding(mesh).rows(8), "local": local,
                "global": make_global_batch(mesh, local), "replicated": t,
                "piece": piece, "whole": whole, "summed": summed,
                "grad_reduced": leaf.grad, "grad_kept": keep.grad},
               Path(workdir) / f"mesh_{rank}.pt")


def _prefix_step(inp, tower, mesh=None):
    """One step of a tower's frozen-prefix hybrid (explicit fused_prefix:
    the kernels' plain versions on the CPU), per rank under DP."""
    import torch

    from aihab_clip_tpu_torch.models import load
    from aihab_clip_tpu_torch.train.peft import (_pack_prefix,
                                                 build_lock_mask,
                                                 make_train_step,
                                                 step_generator)

    model = load(tower, device="cpu", seed=3).model
    c = model.config
    layers = (c.vision_layers if c.is_vit else sum(c.vision_layers))
    mask = build_lock_mask(model, c.vision_layers, c.transformer_layers,
                           unlocked_groups=2)
    cfg = _peft_cfg(inp, resolution=c.image_resolution, tune_text=False,
                    num_templates=1, fused_prefix=layers - 1)
    _, step = make_train_step(model, cfg, inp["prefix_text_weights"][tower],
                              None, mesh=mesh)
    m = step(torch.from_numpy(inp["images"]), torch.from_numpy(inp["labels"]),
             torch.from_numpy(inp["valid"]), step_generator(0, 0, 0),
             inp["lr"], _pack_prefix(model, cfg))
    return {"loss": float(m["loss"]), "correct": int(m["correct"]),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if mask[n]},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters() if mask[n]}}


def case_prefix(rank, world, workdir):
    """The SigLIP (K5/K4) and ConvNeXt (K7) frozen prefixes under DP, per
    rank on its rows, against the single rank."""
    import torch

    from aihab_clip_tpu_torch.parallel.mesh import make_mesh

    inp = _inputs(workdir)
    mesh = make_mesh(device="cpu")
    out = {t: {"dp": _prefix_step(inp, t, mesh),
               "single": _prefix_step(inp, t) if rank == 0 else None}
           for t in inp["prefix_towers"]}
    torch.save(out, Path(workdir) / f"prefix_{rank}.pt")


def case_eval(rank, world, workdir):
    """``evaluate`` of one split: single rank, DP, TP (model 2) and FSDP
    (each block gathering its weights as it runs, the canonical module)."""
    import torch

    from aihab_clip_tpu_torch.parallel.mesh import make_mesh, shard_params
    from aihab_clip_tpu_torch.parallel.tensor import tp_local
    from aihab_clip_tpu_torch.train.evaluate import evaluate

    inp = _inputs(workdir)
    view = _view(inp)

    def run(mesh=None, fsdp=False):
        model = _model(inp)
        kw = dict(return_confusion_matrix=True)
        if mesh is None:
            return evaluate(model, view, inp["text_weights"],
                            inp["resolution"], inp["num_classes"], **kw)
        tp = mesh.shape["model"] > 1
        sharding = shard_params(mesh, model, fsdp=fsdp) if tp or fsdp \
            else None
        # FSDP's eval reads the blocks one at a time, as the epoch's does
        ctx = (sharding.gathered(model, tp_local if tp else None,
                                 per_block=fsdp)
               if sharding is not None else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            return evaluate(model, view, inp["text_weights"],
                            inp["resolution"], inp["num_classes"],
                            mesh=mesh, sharded_weights=tp or fsdp, **kw)

    out = {"single": run() if rank == 0 else None,
           "dp": run(make_mesh(device="cpu")),
           "tp": run(make_mesh(model_parallel=2, device="cpu")),
           "fsdp": run(make_mesh(device="cpu"), fsdp=True)}
    # the block-kernel encode under DP (the kernels' plain versions here)
    from aihab_clip_tpu_torch.models.fast_vit import (
        pack_fastest, vit_encode_block_fused,
        vit_encode_block_fused_sharded)
    from aihab_clip_tpu_torch.ops.preprocess import eval_transform

    model = _model(inp)
    packed = pack_fastest(model, model.config, torch.float32)
    x = eval_transform(torch.from_numpy(inp["eval_images"][:8]), 32)
    with torch.no_grad():
        out["fused_sharded"] = vit_encode_block_fused_sharded(
            packed, x, model.config, make_mesh(device="cpu"), project=True)
        out["fused"] = vit_encode_block_fused(packed, x, model.config,
                                              project=True)
    torch.save(out, Path(workdir) / f"eval_{rank}.pt")


def case_cache(rank, world, workdir):
    """The feature cache written in per-rank shards (shard index and count
    by default the rank and world size) and read back merged by rank 0
    after a barrier."""
    import torch
    import torch.distributed as dist

    from aihab_clip_tpu_torch.cache import (cache_features_from_loader,
                                            feature_cache_dir,
                                            read_preprojection_cache)

    inp = _inputs(workdir)
    cfg = dict(inp["cache_cfg"], root_path=str(Path(workdir) / "sharded"))
    model = _model(inp)
    view = _view(inp, "cache")
    manifest = cache_features_from_loader(
        cfg, model, view, inp["resolution"],
        {"train_size": view.num_samples}, compute_dtype=torch.float32)
    dist.barrier()
    views, labels = read_preprojection_cache(feature_cache_dir(cfg),
                                             cfg["aug_views"], mmap=False)
    torch.save({"manifest": manifest, "views": views, "labels": labels,
                "dir": str(feature_cache_dir(cfg))},
               Path(workdir) / f"cache_{rank}.pt")


def case_runner(rank, world, workdir):
    """``python -m aihab_clip_tpu_torch`` with ``parallel.enabled: true``
    on every rank (the PEFT run and its test evaluation over the mesh)."""
    import torch

    from aihab_clip_tpu_torch.config import ConfigNode
    from aihab_clip_tpu_torch.runner import run

    inp = _inputs(workdir)
    cfg = ConfigNode(copy.deepcopy(inp["runner_cfg"]))
    os.chdir(workdir)
    out = run(cfg, device="cpu")["peft"]
    torch.save({"test": out["test"], "params": out["params"],
                "opt_state": out["opt_state"]},
               Path(workdir) / f"runner_{rank}.pt")


def case_resume(rank, world, workdir):
    """An FSDP finetune of 2 epochs checkpointing after the first (rank 0
    writes the whole state), then fresh models resuming from it at the
    same world size: the final parameters of both."""
    import torch

    from aihab_clip_tpu_torch.parallel.mesh import make_mesh
    from aihab_clip_tpu_torch.train.peft import finetune
    from aihab_clip_tpu_torch.utils.checkpointing import save_checkpoint

    inp = _inputs(workdir)
    ckpt_cfg = {"root_path": str(workdir), "open_clip_model": "tiny",
                "clip_backend": "openclip",
                "finetune": {"save_model_dir": "ckpt"}}
    saved = {}

    def checkpoint_fn(params, opt_state, epoch):
        if rank == 0:
            saved[epoch] = str(save_checkpoint(ckpt_cfg, params, opt_state,
                                               epoch=epoch))

    def train(resume_from=None):
        model = _model(inp)
        cfg = _peft_cfg(inp, epochs=2, checkpoint_interval=1)
        view = _view(inp, "train", shuffle=True, seed=3)
        return finetune(model, view, None, None, cfg,
                        text_weights=inp["text_weights"],
                        prompt_tokens=inp["prompt_tokens"],
                        unlocked_groups=inp["unlocked_groups"],
                        unlocked_text_layers=inp["unlocked_text_layers"],
                        seed=5, mesh=make_mesh(device="cpu"), fsdp=True,
                        checkpoint_fn=checkpoint_fn, resume_from=resume_from,
                        verbose=False, device="cpu")

    full = train()
    path = [saved.get(1)]
    import torch.distributed as dist

    dist.broadcast_object_list(path, 0)
    resumed = train(resume_from=path[0])
    torch.save({"full": full["params"], "resumed": resumed["params"],
                "opt_state": full["opt_state"], "ckpt": path[0]},
               Path(workdir) / f"resume_{rank}.pt")


def main() -> None:
    case, workdir = sys.argv[1:3]
    rank, world = os.environ["RANK"], os.environ["WORLD_SIZE"]
    import torch

    torch.set_num_threads(1)
    from aihab_clip_tpu_torch.parallel.distributed import (
        initialize_distributed, shutdown_distributed)

    initialize_distributed(device="cpu", timeout_s=90.0)
    try:
        CASES[case](int(rank), int(world), workdir)
    finally:
        shutdown_distributed()


CASES = {"steps": case_steps, "pipeline": case_pipeline, "eval": case_eval,
         "cache": case_cache, "runner": case_runner, "resume": case_resume,
         "mesh": case_mesh, "prefix": case_prefix}

if __name__ == "__main__":
    main()
