"""The port's runner and CLI on the CPU (``device="cpu"``), mirroring
``tests/test_runner_smoke.py``: inspect-only, ProLIP with cache generation
and reuse, the missing cache, PEFT with its embedding cache, the refusals
that name their ROADMAP items; ``python -m aihab_clip_tpu_torch`` on the
synthetic tree; and one parity case: both packages' runners on the same
tree and the same Tiny weights (the JAX package's converted-npz cache, read
by both zoos), augmentation off, give cached features within 5e-4 rel L2,
the same projector within 1e-4 and the same test accuracy."""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from aihab_clip_tpu.cache import load_embedding_cache as jax_load_embeddings
from aihab_clip_tpu.config import ConfigNode as JaxConfig
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.models.zoo import _save_config
from aihab_clip_tpu.runner import run as jax_run

from aihab_clip_tpu_torch.cache import (embedding_cache_dir, feature_cache_dir,
                                        load_embedding_cache,
                                        read_preprojection_cache)
from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset
from aihab_clip_tpu_torch.ops import preprocess
from aihab_clip_tpu_torch.runner import run

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    return make_synthetic_cs_dataset(root, n_train_per_class=5,
                                     n_test_per_class=3, image_size=48)


def _cfg_dict(synth, root):
    return {
        "root_path": str(root), "dataset": "synth", "seed": 1, "shots": 0,
        "subset_l3": [], "clip_backend": "openai", "backbone": "random:Tiny",
        "wandb_project": None, "use_hierarchical_prompts": False,
        "use_descriptive_prompts": False, "remat": False, "method": "ProLIP",
        "train_epoch": 3, "lr_v": 0.001, "lambda_v": 0.1,
        "lambda_funct_1_N": False, "lambda_funct_1_N2": False,
        "search_lr": False, "feat_batch_size": 0, "save_checkpoints": False,
        "save_features": False, "aug_views": 2,
        "finetune": {
            "enabled": True, "tune_text": False, "unlocked_groups": 1,
            "unlocked_layers": 1, "val_interval": 0, "eval_l2": True,
            "l2_eval_mode": "argmax", "require_cached_features": True,
            "save_model": False, "cache_embeddings": False},
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
                                  "flip": False, "rotation": True}}},
    }


@pytest.fixture()
def base_cfg(synth, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # results_lr/, runs/ land here
    return ConfigNode(_cfg_dict(synth, tmp_path))


def test_inspect_only(base_cfg, capsys):
    result = run(base_cfg, inspect_only=True, device="cpu")
    out = capsys.readouterr().out
    for part in ("Loaded Config", "Text head summary", "Train Batch Sample",
                 "'platform': 'cpu'"):
        assert part in out
    assert "prolip" not in result and result["timings"]["build_loaders_s"] > 0


def test_prolip_pipeline_with_cache_generation(base_cfg):
    cfg = base_cfg.clone()
    cfg.save_features = True
    cfg.search_lr = True
    cfg.save_checkpoints = True
    result = run(cfg, device="cpu")
    out = result["prolip"]
    assert 0.0 <= out["acc"] <= 100.0 and out["loss"] is not None
    assert len(out["grid_accs"]) == 49
    assert Path("results_lr/cfg/synth0_shot_lr.txt").is_file()
    assert Path("trained_models/cfg/synth/0_shot/synth_seed1.npz").is_file()
    views, labels = read_preprojection_cache(feature_cache_dir(cfg), 2)
    assert len(views) == 2 and views[0].dtype == np.float16
    assert views[0].shape == (result["loaders"].train.num_samples, 64)
    assert not np.array_equal(views[0], views[1])   # two augmentation draws
    # a second run reuses the cache (require_cached_features)
    cfg2 = cfg.clone()
    cfg2.save_features = False
    result2 = run(cfg2, device="cpu")
    assert result2["prolip"]["acc"] == pytest.approx(out["acc"], abs=1e-6)


def test_prolip_missing_cache_raises(base_cfg):
    cfg = base_cfg.clone()
    cfg.seed = 99   # a different cache dir
    with pytest.raises(FileNotFoundError, match="save_features=True"):
        run(cfg, device="cpu")


def test_peft_pipeline(base_cfg, tmp_path):
    cfg = base_cfg.clone()
    cfg.clip_backend = "openclip"
    cfg.open_clip_model = "random:Tiny"
    cfg.use_model_preprocess = False
    cfg.train_epoch = 1
    cfg.wandb_project = "p"
    cfg.finetune.cache_embeddings = True
    cfg.finetune.cache_embeddings_split = "test"
    cfg.finetune.cache_embeddings_dir = str(tmp_path / "emb")
    result = run(cfg, device="cpu", logger_mode="stdout")
    t = result["peft"]["test"]
    assert t is not None and 0.0 <= t["top1"] <= 1.0 and np.isfinite(t["loss"])
    n_test = result["loaders"].test.num_samples
    cache_dir = embedding_cache_dir(cfg, "test")
    mine = load_embedding_cache(cache_dir)
    ref = jax_load_embeddings(cache_dir)   # the JAX package reads it too
    assert mine["embeddings"].shape == (n_test, 32)
    assert np.array_equal(mine["embeddings"], ref["embeddings"])
    assert list(ref["metadata"]["file_name"]) == mine["metadata"]["file_name"]
    assert any(Path("runs").iterdir())


UNPORTED = [
    ({"aug_impl": "exact"}, "A7"),
    ({"parallel": {"enabled": True}}, "A13"),
]
# the items of UNPORTED ported since (A7b: the exact train augment; A13:
# parallelism, which without a process group refuses parallel.enabled:
# true): their branch now runs
PORTED_SINCE = {"A7", "A13"}


@pytest.mark.parametrize("opts,item", UNPORTED, ids=lambda o: str(o)[:40])
def test_unported_branches_raise(base_cfg, opts, item, monkeypatch):
    """A branch still waiting for its ROADMAP item raises naming it; one
    ported since runs: ``aug_impl: exact`` trains the PEFT run through
    ``ops/preprocess.train_transform`` at the run's crop and rotation."""
    cfg = base_cfg.clone()
    cfg.clip_backend = "openclip"
    cfg.open_clip_model = "random:Tiny"
    for key, value in opts.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    if item not in PORTED_SINCE:
        with pytest.raises(NotImplementedError, match=item):
            run(cfg, device="cpu")
        return
    if item == "A13":
        # one process: the mesh needs a torch.distributed process group
        # (the 2-rank run: tests/test_torch_parallel_runner.py)
        with pytest.raises(RuntimeError, match="process group"):
            run(cfg, device="cpu")
        return
    calls = []
    real = preprocess.train_transform

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(preprocess, "train_transform", spy)
    result = run(cfg, device="cpu")
    steps = -(-result["loaders"].train.num_samples // 8) * cfg.train_epoch
    assert len(calls) == steps
    assert calls[0]["crop_mode"] == "random" and calls[0]["rotation"]
    test = result["peft"]["test"]
    assert np.isfinite(test["loss"]) and 0.0 <= test["top1"] <= 1.0


def _peft_cfg(base_cfg, **finetune):
    cfg = base_cfg.clone()
    cfg.clip_backend = "openclip"
    cfg.open_clip_model = "random:Tiny"
    cfg.use_model_preprocess = False
    cfg.train_epoch = 2
    for key, value in finetune.items():
        cfg.finetune[key] = value
    return cfg


def test_peft_remat_equals_plain(base_cfg):
    """``remat: true`` checkpoints every block: the same run, bit for bit
    (``aihab_clip_tpu/runner.py:94``'s ``load(remat=)``)."""
    plain = run(_peft_cfg(base_cfg), device="cpu")
    cfg = _peft_cfg(base_cfg)
    cfg.remat = True
    rem = run(cfg, device="cpu")
    assert all(blk.remat for blk in
               rem["bundle"]["model"].visual.transformer.resblocks)
    assert plain["peft"]["test"]["loss"] == rem["peft"]["test"]["loss"]
    for name, t in plain["peft"]["params"].items():
        assert torch.equal(t, rem["peft"]["params"][name]), name


def test_peft_lora_saves_jax_adapters(base_cfg, tmp_path):
    """A LoRA run through the runner (``finetune.lora_rank``, ``lora_mlp``,
    ``save_model``): the final checkpoint holds W_eff, the base weights
    stay, and ``lora_adapters.npz`` beside it has JAX's keys (the JAX
    package's target paths for the same tower, ``/a`` and ``/b``) and
    layouts; the embedding cache is W_eff's."""
    from aihab_clip_tpu.models.zoo import load as jax_load
    from aihab_clip_tpu.train.lora import lora_target_paths

    from aihab_clip_tpu_torch.train.lora import merged_params
    from aihab_clip_tpu_torch.utils import load_checkpoint

    cfg = _peft_cfg(base_cfg, lora_rank=4, lora_mlp=True, save_model=True,
                    save_model_dir=str(tmp_path / "ck"),
                    cache_embeddings=True,
                    cache_embeddings_dir=str(tmp_path / "emb"))
    out = run(cfg, device="cpu")["peft"]
    assert out["report"]["method"] == "lora"
    npz = np.load(out["adapters_path"])
    ref = lora_target_paths(jax_load("random:Tiny").params,
                            include_mlp=True)
    assert sorted(npz.files) == sorted(f"{'/'.join(p)}/{leaf}" for p in ref
                                       for leaf in ("a", "b"))
    assert npz["visual/transformer/resblocks_0/attn/in_proj/kernel/a"].shape \
        == (64, 4)
    saved = load_checkpoint(out["checkpoint_path"])["params"]
    for name, t in out["params"].items():
        assert torch.equal(saved[name], t), name
    fresh = run(_peft_cfg(base_cfg, enabled=False, cache_embeddings=False),
                device="cpu")["bundle"]["model"]
    merged = merged_params(fresh, out["adapters"], 16.0)
    for name, t in merged.items():
        assert torch.equal(t, out["params"][name]), name
    emb = load_embedding_cache(embedding_cache_dir(cfg, "test"))
    assert emb["info"]["checkpoint_path"] == out["checkpoint_path"]


def test_cache_refusals(base_cfg):
    cfg = base_cfg.clone()
    cfg.save_features = True
    cfg.cache_shard_count = 2
    # one process writes shard 0 of 2 (A13, JAX's rule); the read refuses
    # the incomplete shard set
    with pytest.raises(RuntimeError, match="writer fleet had 2"):
        run(cfg, device="cpu")
    cfg = base_cfg.clone()
    cfg.save_features = True
    cfg.backbone = "Tiny"          # no converted checkpoint: random fallback
    cfg.fallback_arch = "Tiny"
    with pytest.raises(RuntimeError, match="refusing to write a feature cache"):
        run(cfg, device="cpu")
    cfg = base_cfg.clone()
    cfg.root_path = "gs://bucket/prefix"
    with pytest.raises(NotImplementedError, match="A18c"):
        run(cfg, device="cpu")


def _cli(tmp_path, synth, *extra, more_opts=()):
    opts = ["data.dataset_paths", repr(synth["dataset_paths"]),
            "data.index_file_names", repr(synth["index_file_names"]),
            "data.data_split.valid_split", "0.25",
            "data.preprocessing.resize", "48",
            "data.preprocessing.resolution", "32",
            "clip_backend", "openai", "backbone", "random:Tiny",
            "save_features", "True", "aug_views", "2", "search_lr", "True",
            "train_epoch", "2", "wandb_project", "None",
            "root_path", str(tmp_path), *more_opts]
    cmd = [sys.executable, "-m", "aihab_clip_tpu_torch", "--base_config",
           "configs/base.yaml", "--dataset_config", "configs/cs.yaml",
           *extra, "--opts", *opts]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)


def test_cli_runs_prolip_on_the_cpu(tmp_path, synth):
    proc = _cli(tmp_path, synth, "--device", "cpu", "--logger", "off")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Search completed ===> lr:" in proc.stdout
    assert "==== ProLIP results ====" in proc.stdout
    assert (tmp_path / "features_random_Tiny_cs" / "0_shot" / "seed1"
            / "f1.npy").is_file()


def test_cli_runs_the_exact_augment(tmp_path, synth):
    """``python -m aihab_clip_tpu_torch`` with ``aug_impl exact``: the
    feature cache of the ProLIP run, then a PEFT run, both through the
    per-image gather augment."""
    proc = _cli(tmp_path, synth, "--device", "cpu", "--logger", "off",
                more_opts=["aug_impl", "exact"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "==== ProLIP results ====" in proc.stdout
    views = [np.load(tmp_path / "features_random_Tiny_cs" / "0_shot"
                     / "seed1" / f"f{v}.npy") for v in range(2)]
    assert np.isfinite(views[0].astype(np.float32)).all()
    assert not np.array_equal(views[0], views[1])
    proc = _cli(tmp_path, synth, "--device", "cpu", "--logger", "off",
                more_opts=["aug_impl", "exact", "clip_backend", "openclip",
                           "open_clip_model", "random:Tiny",
                           "use_model_preprocess", "False"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def test_cli_without_a_card_raises(tmp_path, synth):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    proc = _cli(tmp_path, synth)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_run_prolip_parity_with_jax(synth, tmp_path, monkeypatch):
    """Both runners on the same Tiny weights, center crop and no rotation:
    cached features within 5e-4 rel L2 (fp16 on disk), the projector within
    1e-4, the same grid pick and the same test accuracy."""
    _prolip_parity(synth, tmp_path, monkeypatch, "fast")


def test_run_prolip_parity_with_jax_exact_augment(synth, tmp_path,
                                                  monkeypatch):
    """The same with ``aug_impl: exact``: both caches written through the
    per-image gather augment (``train_transform``; a center crop draws
    nothing, so both packages warp with the same maps), at the same
    limits."""
    _prolip_parity(synth, tmp_path, monkeypatch, "exact")


def _prolip_parity(synth, tmp_path, monkeypatch, aug_impl):
    monkeypatch.chdir(tmp_path)
    b = jax_load("random:Tiny", seed=3)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        b.params)
    zoo = tmp_path / "zoo" / "converted"
    zoo.mkdir(parents=True)
    save_params_npz(zoo / "Tiny.npz", params)
    _save_config(zoo / "Tiny.config.json", b.config)
    d = _cfg_dict(synth, tmp_path)
    d.update(backbone="Tiny", clip_cache_dir=str(tmp_path / "zoo"),
             save_features=True, search_lr=True, train_epoch=4,
             aug_impl=aug_impl)
    d["finetune"]["eval_l2"] = False
    d["data"]["preprocessing"]["augmentations"].update(random_crop=False,
                                                       rotation=False)
    dj, dp = copy.deepcopy(d), copy.deepcopy(d)
    dj["root_path"], dp["root_path"] = str(tmp_path / "j"), str(tmp_path / "p")
    ref = jax_run(JaxConfig(dj))["prolip"]
    mine = run(ConfigNode(dp), device="cpu")["prolip"]
    vj, lj = read_preprojection_cache(feature_cache_dir(ConfigNode(dj)), 2)
    vp, lp = read_preprojection_cache(feature_cache_dir(ConfigNode(dp)), 2)
    assert np.array_equal(lj, lp)
    for a, c in zip(vj, vp):
        a, c = a.astype(np.float64), c.astype(np.float64)
        assert np.linalg.norm(a - c) / np.linalg.norm(a) <= 5e-4
    wj = np.asarray(ref["projector"].weight, np.float64)
    wp = mine["projector"].weight.numpy().astype(np.float64)
    assert np.linalg.norm(wj - wp) / np.linalg.norm(wj) <= 1e-4
    assert (mine["lr"], mine["lambda"]) == (ref["lr"], ref["lambda"])
    assert mine["acc"] == ref["acc"]
