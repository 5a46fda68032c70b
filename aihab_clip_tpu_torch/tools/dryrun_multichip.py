"""The multi-rank dry run (counterpart of ``__graft_entry__.dryrun_multichip``):
over ``WORLD_SIZE`` ranks at tiny sizes (CLIP width 128, 2 blocks, 32 px),
one of each parallel path, each checked against its reference:

  * a PEFT step on a (data, model) mesh (model 2 when the world is even
    and at least 4, as in JAX; tune_text, random crop, flip, rotation)
    against the single-rank step's loss;
  * a sharded evaluation of the same batch;
  * the FSDP step against the data-parallel one;
  * the ``scan_blocks`` step against the canonical one;
  * a LoRA step on the data axis;
  * a GPipe pipeline step over a (data, stage) mesh (4 stages from 4
    ranks, else 2).

    python -m torch.distributed.run --nproc_per_node N \\
        -m aihab_clip_tpu_torch.tools.dryrun_multichip [--device cpu]
    python -m aihab_clip_tpu_torch.tools.dryrun_multichip --nproc N \\
        [--device cpu] [--timeout 300]

The second form starts the N ranks itself (``spawn_ranks``: a hard
timeout, every rank killed when one fails).  On the card each rank takes
``cuda:{LOCAL_RANK}`` over NCCL; ``--one_device`` puts every rank on the
first card, over gloo (NCCL refuses two ranks on one device).
Rank 0 prints one ``[dryrun_multichip] ok`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2,
            vision_width=128, vision_patch_size=8, context_length=77,
            vocab_size=49408, transformer_width=128, transformer_heads=2,
            transformer_layers=2)


def parallel_step(model, cfg, text_weights, prompt_tokens, batch,
                  generator, mesh=None, fsdp: bool = False, adapters=None,
                  pprefix=None):
    """One PEFT step of ``model`` on the global ``batch`` (images_u8,
    labels, valid) under ``mesh`` (None: the single-rank step): the model
    cut by ``shard_params`` when the mesh's model axis has more than one
    rank or with ``fsdp``, the step ``make_train_step``'s.  Returns {loss,
    correct, grads, params, step, sharding}: ``grads`` and ``params``
    (after the step) whole, new tensors by name, of what the step trains
    (the adapters' ``<name>.a``/``<name>.b`` with ``adapters``); ``step``
    takes further steps.  The dry run, ``chip_smoke.py`` and the tests
    hold each parallel path against the single rank through it."""
    return _parallel_step(model, cfg, text_weights, prompt_tokens, batch,
                          generator, mesh, fsdp, adapters, pprefix,
                          control=False)


def _parallel_step(model, cfg, text_weights, prompt_tokens, batch,
                   generator, mesh, fsdp, adapters, pprefix, control: bool):
    """``parallel_step``; ``control``: the step of
    ``peft._make_train_step``'s control (every weight gathered whole, the
    replicated forward), which ``chip_smoke.py`` and the tests measure the
    per-block gather and the tensor-parallel shards against."""
    from ..parallel.mesh import MODEL_AXIS, shard_params
    from ..train.peft import _make_train_step

    sharding = None
    if mesh is not None and (fsdp or mesh.shape[MODEL_AXIS] > 1):
        sharding = shard_params(mesh, model, fsdp=fsdp)
    _, step = _make_train_step(model, cfg, text_weights, prompt_tokens,
                               adapters, mesh, sharding, control)
    m = step(*batch, generator, cfg.lr, pprefix)
    if adapters is None:
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    else:
        named = [(f"{n}.{k}", ab[k]) for n, ab in adapters.items()
                 for k in ("a", "b")]

    def whole(name, t):
        return (t.clone() if sharding is None or name not in sharding.cuts
                else sharding.full(name, t))

    with torch.no_grad():
        grads = {n: whole(n, p.grad) for n, p in named}
        params = {n: whole(n, p.detach()) for n, p in named}
    return dict(loss=float(m["loss"]), correct=int(m["correct"]),
                grads=grads, params=params, step=step, sharding=sharding)


def _close(a: float, b: float, what: str, tol: float) -> None:
    if not abs(a - b) < tol * max(1.0, abs(b)):
        raise AssertionError(f"{what}: loss {a} != {b}")


def dryrun(device) -> str:
    """One of each parallel path on this rank (every rank calls it);
    returns rank 0's summary line."""
    from ..data import ImageArrayDataset, SplitView
    from ..models import CLIPConfig, build_text_head, load
    from ..parallel.distributed import world_size
    from ..parallel.mesh import make_mesh
    from ..parallel.pipeline import make_pipeline_mesh
    from ..templates import gen_prompts
    from ..train.evaluate import evaluate
    from ..train.lora import lora_init
    from ..train.peft import PEFTConfig, build_lock_mask, step_generator
    from ..train.pipeline_peft import (init_pipeline_trainable,
                                       make_pipeline_train_step)

    n = world_size()
    mp = 2 if n % 2 == 0 and n >= 4 else 1
    # the card computes in bf16 (its kernels take no fp32 weights); a
    # bf16 step's loss spreads to 6e-3 between paths (chip_smoke.py's
    # VIT_STEP_GATES["plain"]), an fp32 one within JAX's 1e-3
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    tol = 6e-3 if device.type == "cuda" else 1e-3
    prompts, tpc = gen_prompts(use_hierarchy=True, use_descriptive=True)
    cfg = PEFTConfig(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                     crop_mode="random", flip=True, rotation=True,
                     tune_text=True, num_templates=tpc, fused_prefix=0,
                     compute_dtype=dtype)
    rng = np.random.default_rng(0)
    bsz = n * 2
    images = rng.integers(0, 256, (bsz, 48, 48, 3), dtype=np.uint8)
    labels = rng.integers(0, 20, bsz).astype(np.int32)
    batch = tuple(torch.from_numpy(a).to(device) for a in (
        images, labels, np.ones(bsz, bool)))

    def fresh():
        return load("random:dryrun", device=device, seed=0,
                    random_cfg=CLIPConfig(**TINY)).model

    model = fresh()
    # out of inference mode: the steps take these into autograd
    head = {k: v.clone() if torch.is_tensor(v) else v
            for k, v in build_text_head(model, prompts, 20, tpc).items()}

    def step_loss(c, mesh=None, fsdp=False, adapters=None, m=None):
        m = m or fresh()
        if adapters is None:
            build_lock_mask(m, TINY["vision_layers"],
                            TINY["transformer_layers"], unlocked_groups=2,
                            tune_text=True, unlocked_text_layers=1)
        else:
            m.requires_grad_(False)
        loss = parallel_step(m, c, head["text_weights"],
                             head["prompt_tokens"], batch,
                             step_generator(0, 0, 0), mesh, fsdp,
                             adapters)["loss"]
        if not np.isfinite(loss):
            raise AssertionError("non-finite loss")
        return loss

    mesh = make_mesh(model_parallel=mp, device=device)
    single = step_loss(cfg)
    loss = step_loss(cfg, mesh)
    _close(loss, single, "dp x tp step vs the single-rank step", tol)

    n_img = len(labels)
    ds = ImageArrayDataset(
        images=images, labels=labels.astype(np.int64),
        l2_labels=np.zeros(n_img, np.int64),
        poly_labels=np.full(n_img, -1, np.int64),
        plot_word_labels=[""] * n_img, poly_word_labels=[""] * n_img,
        file_names=[f"{i}.jpg" for i in range(n_img)],
        plot_idx=list(range(n_img)), image_sources=["synthetic"] * n_img)
    with torch.no_grad():
        metrics = evaluate(model, SplitView(ds, np.arange(n_img), bsz),
                           head["text_weights"], 32, 20,
                           compute_dtype=dtype, mesh=make_mesh(device=device))
    if not np.isfinite(metrics["top1"]):
        raise AssertionError("sharded eval: non-finite top1")

    dp_mesh = make_mesh(device=device)
    dp_loss = step_loss(cfg, dp_mesh)
    _close(step_loss(cfg, dp_mesh, fsdp=True), dp_loss, "fsdp vs dp step",
           tol)
    _close(step_loss(dataclasses.replace(cfg, scan_blocks=True), mesh),
           loss, "scan_blocks vs canonical step", tol)

    lcfg = dataclasses.replace(cfg, lora_rank=2, tune_text=False,
                               rotation=False)
    lm = fresh()
    adapters = lora_init(lm, 2, torch.Generator().manual_seed(7))
    step_loss(lcfg, dp_mesh, adapters=adapters, m=lm)

    n_stages = 4 if n >= 4 else 2
    pp_dp = max(1, n // n_stages)
    pp_cfg = CLIPConfig(**dict(TINY, vision_layers=n_stages * 2))
    pp_model = load("random:dryrun-pp", device=device, seed=1,
                    random_cfg=pp_cfg).model
    pp_mesh = make_pipeline_mesh(n_stages, data_parallel=pp_dp,
                                 device=device)
    trainable = init_pipeline_trainable(pp_model, pp_cfg, pp_mesh)
    pp_peft = dataclasses.replace(cfg, tune_text=False, rotation=False)
    _, pp_step = make_pipeline_train_step(
        pp_model, pp_peft, head["text_weights"], None, pp_mesh,
        num_microbatches=2 * pp_dp, unlocked_layers=n_stages,
        trainable=trainable)
    pp_b = 4 * pp_dp
    pp_loss = float(pp_step(
        torch.from_numpy(images[:pp_b]).to(device),
        torch.from_numpy(labels[:pp_b]).to(device),
        torch.ones(pp_b, dtype=torch.bool, device=device),
        step_generator(3, 0, 0), cfg.lr)["loss"])
    if not np.isfinite(pp_loss):
        raise AssertionError("pipeline step: non-finite loss")
    return (f"[dryrun_multichip] ok: {n} ranks, mesh={mesh.shape}, "
            f"loss={loss:.4f} (single-rank, fsdp + scan_blocks match, lora "
            f"step ok); pipeline train step ok on {pp_mesh.shape} "
            f"(loss={pp_loss:.4f})")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dryrun_multichip")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--nproc", type=int, default=0,
                   help="start this many ranks here (default: run as one "
                        "rank of a launcher)")
    p.add_argument("--one_device", action="store_true",
                   help="every rank on the first card, over gloo (NCCL "
                        "refuses two ranks on one device)")
    p.add_argument("--timeout", type=float, default=300.0)
    args = p.parse_args(argv)
    from ..backend import resolve_device
    from ..parallel.distributed import (initialize_distributed,
                                        local_device, rank,
                                        shutdown_distributed, spawn_ranks)

    resolve_device(args.device)
    if args.nproc:
        rest = [a for a in (argv if argv is not None else sys.argv[1:])]
        i = rest.index("--nproc")
        del rest[i:i + 2]
        outs = spawn_ranks(["-m", "aihab_clip_tpu_torch.tools."
                            "dryrun_multichip", *rest], args.nproc,
                           args.timeout, one_device=args.one_device)
        print(outs[0], end="")
        return
    dev = local_device(args.device)
    initialize_distributed(device=dev,
                           backend="gloo" if args.one_device else None)
    try:
        torch.manual_seed(0)
        line = dryrun(dev)
        if rank() == 0:
            print(line, flush=True)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
