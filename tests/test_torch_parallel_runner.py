"""The port's multi-process paths around the trainer, on gloo CPU ranks:
the feature cache written in per-rank shards and read back merged (against
the unsharded write, and against a shard set the JAX package wrote), the
runner with ``parallel.enabled: true`` on 2 ranks against one process,
an FSDP checkpoint written at 2 ranks resumed at 2 (bit for bit with the
run that did not stop) and at 1, the launcher's timeout, the dry run
over 2 and 4 ranks (its own launcher and ``torch.distributed.run``), and
the refusals.

Tolerances: the cache is deterministic here (centre crop, no flip or
rotation), so the merged rows equal the unsharded write's bit for bit;
against JAX's features fp16 storage within 2e-3 (fp32 towers that round
apart).  Runs of more than one step compare within the JAX suite's
loss tolerance (rel 1e-4) and Adam's bound per step (|d| <= 2 lr per
step)."""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from aihab_clip_tpu.cache import feature_cache as jax_fc
from aihab_clip_tpu.data.bulk_load import ImageArrayDataset as JaxDS
from aihab_clip_tpu.data.pipeline import SplitView as JaxView
from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
from aihab_clip_tpu.models import load as jax_load

import torch_parallel_worker as worker
from aihab_clip_tpu_torch.cache import (cache_features_from_loader,
                                        feature_cache_dir,
                                        read_preprojection_cache)
from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset
from aihab_clip_tpu_torch.models.convert import flax_params_to_state_dict
from aihab_clip_tpu_torch.parallel.distributed import (process_shard_indices,
                                                       spawn_ranks)
from aihab_clip_tpu_torch.runner import run
from aihab_clip_tpu_torch.train.peft import PEFTConfig, finetune
from aihab_clip_tpu_torch.utils.checkpointing import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2,
            vision_width=128, vision_patch_size=8, context_length=77,
            vocab_size=49408, transformer_width=128, transformer_heads=2,
            transformer_layers=2)
LR, LAUNCH_S = 1e-3, 150
CACHE_CFG = {"dataset": "synth", "seed": 1, "shots": 0, "aug_views": 2,
             "aug_impl": "fast", "backbone": "tiny", "clip_backend": "openai",
             "data": {"preprocessing": {"augmentations": {
                 "bottom_crop": False, "random_crop": False, "flip": False,
                 "rotation": False}}}}


@pytest.fixture(scope="module")
def bundle():
    b = jax_load("random:dryrun", random_cfg=JaxCLIPConfig(**TINY), seed=0)
    rng = np.random.default_rng(4)
    return b.model, jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        b.params)


@pytest.fixture(scope="module")
def inputs(bundle):
    rng = np.random.default_rng(2)
    _, params = bundle
    from aihab_clip_tpu_torch.models import CLIPConfig, CLIPModel

    model = CLIPModel(CLIPConfig(**TINY))
    model.load_state_dict(flax_params_to_state_dict(params))
    w = rng.standard_normal((TINY["embed_dim"], 20)).astype(np.float32)
    return dict(
        config=TINY, state_dict=model.state_dict(), resolution=32,
        num_classes=20, lr=LR, tune_text=False, num_templates=1,
        unlocked_groups=2, unlocked_text_layers=0,
        text_weights=torch.from_numpy(w / np.linalg.norm(w, axis=0)),
        prompt_tokens=None, cache_cfg=CACHE_CFG,
        cache_images=rng.integers(0, 256, (11, 48, 48, 3), dtype=np.uint8),
        cache_labels=rng.integers(0, 20, 11).astype(np.int64),
        cache_batch=4,
        train_images=rng.integers(0, 256, (12, 48, 48, 3), dtype=np.uint8),
        train_labels=rng.integers(0, 20, 12).astype(np.int64),
        train_batch=4)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("runner2")
    torch.save(inputs, workdir / "inputs.pt")
    return workdir, {case: worker.launch(case, 2, workdir, LAUNCH_S)
                     for case in ("cache", "resume")}


# ---------------------------------------------------------------------------
# the sharded feature cache
# ---------------------------------------------------------------------------


def test_sharded_cache_merges_to_the_unsharded_write(ranks, inputs,
                                                     tmp_path):
    workdir, out = ranks
    cfg = dict(CACHE_CFG, root_path=str(tmp_path))
    model = worker._model(inputs)
    view = worker._view(inputs, "cache")
    cache_features_from_loader(cfg, model, view, 32, {"train_size": 11},
                               compute_dtype=torch.float32, shard_count=1)
    ref_views, ref_labels = read_preprojection_cache(feature_cache_dir(cfg),
                                                     2, mmap=False)
    # the shards hold the positions process_shard_indices gives each rank
    order = np.concatenate([process_shard_indices(11, seed=1,
                                                  process_index=k,
                                                  process_count=2)
                            for k in range(2)])
    for r in range(2):
        got = out["cache"][r]
        assert got["manifest"]["shard_index"] == r
        assert got["manifest"]["shard_count"] == 2
        np.testing.assert_array_equal(got["labels"], ref_labels[order])
        for a, b in zip(got["views"], ref_views):
            assert a.dtype == np.float16
            np.testing.assert_array_equal(a, b[order])
    names = sorted(p.name for p in Path(out["cache"][0]["dir"]).iterdir())
    assert names == ["f0.shard0.npy", "f0.shard1.npy", "f1.shard0.npy",
                     "f1.shard1.npy", "label.shard0.npy", "label.shard1.npy",
                     "manifest.shard0.json", "manifest.shard1.json"]


def test_sharded_cache_matches_the_jax_shard_set(ranks, inputs, bundle,
                                                 tmp_path):
    workdir, out = ranks
    model, params = bundle
    n = len(inputs["cache_labels"])
    ds = JaxDS(images=inputs["cache_images"], labels=inputs["cache_labels"],
               l2_labels=np.zeros(n, np.int64),
               poly_labels=np.full(n, -1, np.int64),
               plot_word_labels=[""] * n, poly_word_labels=[""] * n,
               file_names=[f"img_{i}.jpg" for i in range(n)],
               plot_idx=list(range(n)), image_sources=["synthetic"] * n)
    cfg = dict(CACHE_CFG, root_path=str(tmp_path))
    import jax.numpy as jnp

    for k in range(2):
        jax_fc.cache_features_from_loader(
            cfg, model, params, JaxView(ds, np.arange(n), 4), 32,
            {"train_size": n}, compute_dtype=jnp.float32, shard_index=k,
            shard_count=2)
    jdir = Path(jax_fc.feature_cache_dir(cfg))
    pdir = Path(out["cache"][0]["dir"])
    assert sorted(p.name for p in jdir.iterdir()) == sorted(
        p.name for p in pdir.iterdir())
    for k in range(2):
        mine = json.loads((pdir / f"manifest.shard{k}.json").read_text())
        ref = json.loads((jdir / f"manifest.shard{k}.json").read_text())
        for key in ("aug_views", "shard_index", "shard_count", "n", "dim"):
            assert mine[key] == ref[key], key
        np.testing.assert_array_equal(np.load(pdir / f"label.shard{k}.npy"),
                                      np.load(jdir / f"label.shard{k}.npy"))
    # the port reads JAX's shard set as JAX does
    views, labels = read_preprojection_cache(jdir, 2, mmap=False)
    jviews, jlabels = jax_fc.read_preprojection_cache(jdir, 2)
    np.testing.assert_array_equal(labels, jlabels)
    for a, b, c in zip(views, jviews, out["cache"][0]["views"]):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_allclose(c.astype(np.float32),
                                   a.astype(np.float32), atol=2e-3)


# ---------------------------------------------------------------------------
# resume across world sizes
# ---------------------------------------------------------------------------


def _close_run(got, ref, steps):
    for name, t in ref.items():
        diff = (got[name].float() - t.float()).abs().max().item()
        assert diff <= 2 * LR * steps, (name, diff)


def test_fsdp_checkpoint_resumes_at_two_ranks_bit_for_bit(ranks):
    _, out = ranks
    for r in range(2):
        full, resumed = out["resume"][r]["full"], out["resume"][r]["resumed"]
        assert set(full) == set(resumed)
        for name, t in full.items():
            assert torch.equal(t, resumed[name]), name
    for name, t in out["resume"][0]["full"].items():
        assert torch.equal(t, out["resume"][1]["full"][name]), name


def test_fsdp_checkpoint_resumes_at_one_rank(ranks, inputs):
    """The checkpoint holds whole parameters and Adam moments whatever the
    world size; one process resumes it and finishes the run as the two
    ranks did (within Adam's bound for its 3 steps)."""
    _, out = ranks
    ckpt = out["resume"][0]["ckpt"]
    restored = load_checkpoint(ckpt)
    model = worker._model(inputs)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for name, t in restored["params"].items():
        assert tuple(t.shape) == shapes[name], name
    names = [n for n in restored["params"]]
    state = restored["opt_state"]["state"]
    assert state, "no Adam state in the checkpoint"
    for st in state.values():
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape
        assert tuple(st["exp_avg"].shape) in shapes.values()
    assert len(names) == len(shapes)
    cfg = PEFTConfig(resolution=32, num_classes=20, lr=LR, epochs=2,
                     crop_mode="center", fused_prefix=0,
                     checkpoint_interval=1)
    res = finetune(model, worker._view(inputs, "train", shuffle=True, seed=3),
                   None, None, cfg, text_weights=inputs["text_weights"],
                   unlocked_groups=2, seed=5, resume_from=ckpt,
                   verbose=False, device="cpu")
    _close_run(res["params"], out["resume"][0]["full"], steps=3)


# ---------------------------------------------------------------------------
# the runner on 2 ranks
# ---------------------------------------------------------------------------


def _runner_cfg(synth, root):
    return {
        "root_path": str(root), "dataset": "synth", "seed": 1, "shots": 0,
        "subset_l3": [], "clip_backend": "openclip",
        "open_clip_model": "random:Tiny", "use_model_preprocess": False,
        "wandb_project": None, "use_hierarchical_prompts": False,
        "use_descriptive_prompts": False, "remat": False, "train_epoch": 2,
        "lr_v": LR, "save_features": False, "aug_views": 1,
        "parallel": {"enabled": True, "model_parallel": 1, "fsdp": False},
        "finetune": {
            "enabled": True, "tune_text": False, "unlocked_groups": 2,
            "unlocked_layers": 1, "val_interval": 0, "eval_l2": True,
            "l2_eval_mode": "argmax", "save_model": False,
            "cache_embeddings": False},
        "data": {
            "dataset_paths": synth["dataset_paths"],
            "index_file_names": synth["index_file_names"],
            "batch_size": 8, "shuffle": True, "num_workers": 0,
            "decode_prescale": False,
            "data_split": {"valid_split": 0.25, "split_seed": 42},
            "use_l2_label": False,
            "preprocessing": {
                "resize": 48, "resolution": 32,
                "augmentations": {"bottom_crop": False, "random_crop": True,
                                  "flip": True, "rotation": True}}}}


def test_runner_parallel_enabled_on_two_ranks(tmp_path, monkeypatch):
    synth = make_synthetic_cs_dataset(tmp_path / "tree", n_train_per_class=5,
                                      n_test_per_class=3, image_size=48)
    cfg = _runner_cfg(synth, tmp_path)
    torch.save({"runner_cfg": cfg}, tmp_path / "inputs.pt")
    got = worker.launch("runner", 2, tmp_path, LAUNCH_S)
    monkeypatch.chdir(tmp_path)
    one = dict(cfg, parallel={"enabled": False})
    res = run(ConfigNode(one), device="cpu")
    ref = res["peft"]
    steps = 2 * -(-res["loaders"].train.num_samples // 8)
    for r in range(2):
        test = got[r]["test"]
        np.testing.assert_array_equal(test["cm"], ref["test"]["cm"])
        assert test["loss"] == pytest.approx(ref["test"]["loss"], rel=1e-4)
        _close_run(got[r]["params"], ref["params"], steps)
    with pytest.raises(RuntimeError, match="process group"):
        run(ConfigNode(dict(cfg, parallel={"enabled": True})), device="cpu")


# ---------------------------------------------------------------------------
# the launcher, the dry run, the refusals
# ---------------------------------------------------------------------------


def test_a_hung_rank_fails_within_the_timeout(tmp_path):
    """A rank stuck at a gloo barrier (its peer never arrives) fails the
    launch at its timeout, and every rank is killed."""
    script = tmp_path / "hang.py"
    script.write_text(
        "import os, time, torch.distributed as dist\n"
        "dist.init_process_group('gloo', rank=int(os.environ['RANK']),\n"
        "                        world_size=int(os.environ['WORLD_SIZE']))\n"
        "if os.environ['RANK'] == '1':\n"
        "    time.sleep(600)\n"
        "dist.barrier()\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out after 8s"):
        spawn_ranks([str(script)], 2, 8.0)
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("launcher,nproc", [
    ("own", 2), ("own", 4), ("torch.distributed.run", 2)])
def test_dryrun_multichip(launcher, nproc, tmp_path):
    env = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    tool = ["-m", "aihab_clip_tpu_torch.tools.dryrun_multichip",
            "--device", "cpu"]
    cmd = ([sys.executable, *tool, "--nproc", str(nproc), "--timeout", "120"]
           if launcher == "own" else
           [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
            str(nproc), "--master_port", str(worker_free_port()), *tool])
    proc = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("[dryrun_multichip] ok")]
    assert len(line) == 1, proc.stdout
    assert f"{nproc} ranks" in line[0]
    if nproc == 4:
        assert "'model': 2" in line[0] and "{'stage': 4}" in line[0]


def worker_free_port():
    from aihab_clip_tpu_torch.parallel.distributed import free_port

    return free_port()


def test_refusals(inputs):
    model = worker._model(inputs)
    cfg = PEFTConfig(resolution=32, num_classes=20, lr=LR, epochs=1)
    with pytest.raises(ValueError, match="fsdp=True requires a mesh"):
        finetune(model, worker._view(inputs, "train"), None, None, cfg,
                 text_weights=inputs["text_weights"], fsdp=True,
                 device="cpu", verbose=False)
    from aihab_clip_tpu_torch.parallel.mesh import make_mesh
    from aihab_clip_tpu_torch.parallel.pipeline import make_pipeline_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_pipeline_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="one device each"):
        make_mesh(devices=[0, 1], device="cpu")
