"""The port's model checkpoints (``utils/checkpointing.py``), resume and
graceful SIGTERM in ``finetune``, and the runner's checkpoint branches, as
``tests/test_checkpoint_resume.py`` holds the JAX package: round trips
(also async), ``latest_checkpoint``'s rules, periodic checkpoints and a
SIGTERM raised in epoch 2 both resumed bit for bit against an uninterrupted
run, the CLI interrupted by a real SIGTERM and resumed, and the runner's
``resume``, ``checkpoint``, ``eval_only`` and
``cache_embeddings_checkpoint``."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from aihab_clip_tpu.config import ConfigNode as JaxConfig
from aihab_clip_tpu.utils import save_checkpoint as jax_save_checkpoint

from aihab_clip_tpu_torch.cache import embedding_cache_dir, load_embedding_cache
from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.data import build_loaders, make_synthetic_cs_dataset
from aihab_clip_tpu_torch.models import build_text_head, load
from aihab_clip_tpu_torch.runner import run
from aihab_clip_tpu_torch.templates import gen_prompts
from aihab_clip_tpu_torch.train.peft import PEFTConfig, finetune
from aihab_clip_tpu_torch.utils import (checkpoint_path, latest_checkpoint,
                                        load_checkpoint, save_checkpoint,
                                        wait_for_async_saves)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return make_synthetic_cs_dataset(root, n_train_per_class=4,
                                     n_test_per_class=2, image_size=40)


def _cfg(synth, tmp_path, **over):
    cfg = ConfigNode({
        "root_path": str(tmp_path),
        "dataset": "synth", "seed": 1, "shots": 0, "subset_l3": [],
        "clip_backend": "openclip", "open_clip_model": "random:Tiny",
        "backbone": "random:Tiny", "wandb_project": None,
        "use_hierarchical_prompts": False, "use_descriptive_prompts": False,
        "use_model_preprocess": False,
        "remat": False, "train_epoch": 1, "lr_v": 0.001,
        "lambda_v": 0.1, "lambda_funct_1_N": False, "lambda_funct_1_N2": False,
        "search_lr": False, "feat_batch_size": 0, "save_checkpoints": False,
        "save_features": False, "aug_views": 1, "device_dataset": "auto",
        "finetune": {
            "enabled": True, "tune_text": False, "unlocked_groups": 1,
            "unlocked_layers": 1, "val_interval": 0, "eval_l2": False,
            "eval_only": False, "checkpoint": None, "resume": False,
            "checkpoint_interval": 0, "require_cached_features": True,
            "save_model": True, "save_model_dir": str(tmp_path / "model_ckpt"),
            "save_optimizer": True, "cache_embeddings": False,
            "cache_embeddings_split": "test",
            "cache_embeddings_dir": str(tmp_path / "emb"),
            "cache_embeddings_checkpoint": None,
        },
        "data": {
            "dataset_paths": synth["dataset_paths"],
            "index_file_names": synth["index_file_names"],
            "batch_size": 8, "shuffle": True, "num_workers": 0,
            "data_split": {"valid_split": 0.25, "split_seed": 42},
            "use_l2_label": False,
            "preprocessing": {"resize": 40, "resolution": 32,
                              "augmentations": {"random_crop": False}},
        },
    })
    for k, v in over.items():
        cfg[k] = v
    return cfg


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------


def _ck_cfg(tmp_path, model="ViT-B/16"):
    return ConfigNode({"root_path": str(tmp_path), "clip_backend": "openai",
                       "backbone": model, "finetune": {"save_model_dir": "ck"}})


def test_save_load_roundtrip_and_meta_match_jax(tmp_path):
    cfg = _ck_cfg(tmp_path)
    params = {"a.w": torch.ones(3, 3), "b": torch.zeros(2)}
    opt = torch.optim.Adam([torch.nn.Parameter(torch.ones(2))])
    path = save_checkpoint(cfg, params, opt.state_dict(), epoch=5)
    assert path == checkpoint_path(cfg, 5, path.name.rsplit("_", 2)[-2] + "_"
                                   + path.name.rsplit("_", 1)[-1]).resolve()
    assert path.name.startswith("ViTB16_5_")
    assert latest_checkpoint(cfg) == path
    restored = load_checkpoint(path)
    assert torch.equal(restored["params"]["a.w"], torch.ones(3, 3))
    assert restored["opt_state"]["param_groups"][0]["betas"] == (0.9, 0.999)
    assert restored["meta"]["epoch"] == 5
    assert sorted(p.name for p in path.iterdir()) == ["meta.json", "state"]
    # JAX's meta.json keys, by its own writer on the same config
    jcfg = JaxConfig({"root_path": str(tmp_path / "j"),
                      "clip_backend": "openai", "backbone": "ViT-B/16",
                      "finetune": {"save_model_dir": "ck"}})
    jpath = jax_save_checkpoint(jcfg, {"w": np.ones(2, np.float32)}, None, 5)
    ref = json.loads((jpath / "meta.json").read_text())
    meta = json.loads((path / "meta.json").read_text())
    assert meta.keys() == ref.keys()
    assert jpath.name.split("_")[:2] == path.name.split("_")[:2]
    # finetune.save_optimizer: false keeps the params alone
    cfg.finetune.save_optimizer = False
    p2 = save_checkpoint(cfg, params, opt.state_dict(), epoch=6)
    assert "opt_state" not in load_checkpoint(p2)
    assert json.loads((p2 / "meta.json").read_text())["has_opt_state"] is False


def test_async_save_copies_before_it_returns(tmp_path):
    """The host copy happens in the foreground: tensors changed after the
    call returns do not reach the file."""
    cfg = _ck_cfg(tmp_path)
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    snapshot = params["w"].clone()
    path = save_checkpoint(cfg, params, None, epoch=3, async_save=True)
    params["w"] += 1000.0
    wait_for_async_saves()
    restored = load_checkpoint(path)
    assert torch.equal(restored["params"]["w"], snapshot)
    assert restored["meta"]["epoch"] == 3


def test_latest_checkpoint_rules(tmp_path):
    """The newest by (timestamp, epoch); a directory whose ``state/`` never
    committed is skipped, and so is a longer model name sharing the
    prefix."""
    cfg = _ck_cfg(tmp_path, "random:Tiny")
    assert latest_checkpoint(cfg) is None
    ck = tmp_path / "ck"
    save_checkpoint(cfg, {"w": torch.ones(1)}, None, epoch=1)
    two = save_checkpoint(cfg, {"w": torch.ones(1)}, None, epoch=2)
    assert latest_checkpoint(cfg) == two
    uncommitted = ck / "random_Tiny_9_29991231_23"
    uncommitted.mkdir()
    (uncommitted / "meta.json").write_text("{}")
    (uncommitted / "state.tmp-1-2").mkdir()
    shadow = ck / "random_Tiny-Big_7_29991231_23"
    (shadow / "state").mkdir(parents=True)
    (shadow / "meta.json").write_text("{}")
    assert latest_checkpoint(cfg) == two
    with pytest.raises(FileNotFoundError, match="committed"):
        load_checkpoint(uncommitted)
    newer = ck / "random_Tiny_3_29991231_23"
    (newer / "state").mkdir(parents=True)
    (newer / "meta.json").write_text("{}")
    assert latest_checkpoint(cfg) == newer


# ---------------------------------------------------------------------------
# resume and SIGTERM in finetune
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(synth, tmp_path_factory):
    cfg = _cfg(synth, tmp_path_factory.mktemp("tiny"))
    loaders = build_loaders(cfg, device="cpu")
    bundle = load("random:Tiny", device="cpu")
    prompts, tpc = gen_prompts(use_hierarchy=False, use_descriptive=False)
    head = build_text_head(bundle.model, prompts, 20, tpc)
    start = {n: p.detach().clone() for n, p in bundle.model.named_parameters()}
    return cfg, loaders, bundle.model, head["text_weights"].clone(), start


def _fresh(model, start):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(start[n])
    return model


def _pcfg(epochs, interval=0, **kw):
    return PEFTConfig(resolution=32, num_classes=20, lr=2e-3, epochs=epochs,
                      crop_mode="random", flip=True,
                      checkpoint_interval=interval, **kw)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("regime", [False, True, "chunked"])
def test_periodic_checkpoint_and_resume_continuity(tiny, tmp_path, regime):
    """4 epochs uninterrupted = 4 epochs with a checkpoint at epoch 2,
    resumed from it: the parameters and the Adam state bit for bit (the
    shuffle, the augmentation generators and the schedule index the
    absolute epoch)."""
    cfg, loaders, model, tw, start = tiny
    cfg = cfg.clone()
    cfg.root_path = str(tmp_path)
    kw = dict(text_weights=tw, unlocked_groups=2, seed=0, verbose=False,
              track_test=False, device="cpu")
    opts = dict(device_dataset=regime, device_chunk_bytes=40 * 40 * 3 * 16)
    full = finetune(_fresh(model, start), loaders.train, None, None,
                    _pcfg(4, **opts), **kw)
    full = ({k: v.clone() for k, v in full["params"].items()},
            full["opt_state"])
    saved = {}

    def ckpt_fn(par, opt_state, epoch):
        saved.setdefault("epochs", []).append(epoch)
        saved["path"] = save_checkpoint(cfg, par, opt_state, epoch=epoch)

    finetune(_fresh(model, start), loaders.train, None, None,
             _pcfg(4, interval=2, **opts), checkpoint_fn=ckpt_fn, **kw)
    assert saved["epochs"] == [2]
    assert load_checkpoint(saved["path"])["meta"]["epoch"] == 2
    resumed = finetune(_fresh(model, start), loaders.train, None, None,
                       _pcfg(4, **opts), resume_from=saved["path"], **kw)
    _same(full[0], resumed["params"])
    for i, st in full[1]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], resumed["opt_state"]["state"][i][key])


def test_sigterm_graceful_interrupt_and_resume(tiny, tmp_path):
    """SIGTERM raised from the epoch-2 logger hook (the main thread):
    the epoch finishes, the checkpoint is written, ``interrupted_at_epoch``
    is 2; the resume completes bit for bit with the uninterrupted run, and
    the previous handlers are back."""
    cfg, loaders, model, tw, start = tiny
    cfg = cfg.clone()
    cfg.root_path = str(tmp_path)
    kw = dict(text_weights=tw, unlocked_groups=2, seed=0, verbose=False,
              track_test=False, device="cpu")
    full = finetune(_fresh(model, start), loaders.train, None, None,
                    _pcfg(4), **kw)
    full = {k: v.clone() for k, v in full["params"].items()}

    class TermAtEpoch:
        def log(self, d):
            if d.get("epoch") == 2:
                signal.raise_signal(signal.SIGTERM)

    saved = {}

    def ckpt_fn(par, opt_state, epoch):
        saved["path"] = save_checkpoint(cfg, par, opt_state, epoch=epoch)
        saved["epoch"] = epoch

    before = signal.getsignal(signal.SIGTERM)
    out = finetune(_fresh(model, start), loaders.train, None, None,
                   _pcfg(4), checkpoint_fn=ckpt_fn, logger=TermAtEpoch(),
                   **kw)
    assert signal.getsignal(signal.SIGTERM) is before
    assert out["interrupted_at_epoch"] == 2 and saved["epoch"] == 2
    resumed = finetune(_fresh(model, start), loaders.train, None, None,
                       _pcfg(4), resume_from=saved["path"], **kw)
    assert resumed["interrupted_at_epoch"] is None
    _same(full, resumed["params"])


def test_signal_handlers_only_on_the_main_thread(tiny):
    """Off the main thread no handler is installed (and nothing fails)."""
    cfg, loaders, model, tw, start = tiny
    seen = {}

    def body():
        seen["out"] = finetune(_fresh(model, start), loaders.train, None,
                               None, _pcfg(1), text_weights=tw, seed=0,
                               verbose=False, track_test=False, device="cpu")

    before = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert seen["out"]["interrupted_at_epoch"] is None
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# the runner's branches
# ---------------------------------------------------------------------------


def test_runner_save_eval_only_and_warm_start(synth, tmp_path, monkeypatch):
    """save_model writes the final checkpoint; eval_only from it (and from
    ``latest``) reproduces the trained test metrics; finetune.checkpoint
    warm-starts a run from it; cache_embeddings_checkpoint encodes with
    its weights and records its path."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(synth, tmp_path, train_epoch=2)
    cfg.finetune.cache_embeddings = True
    trained = run(cfg, device="cpu", logger_mode="off")["peft"]
    ck = latest_checkpoint(cfg)
    assert ck is not None and trained["checkpoint_path"] == str(ck)
    assert load_checkpoint(ck)["meta"]["epoch"] == 2
    emb_trained = load_embedding_cache(embedding_cache_dir(cfg, "test"))
    assert emb_trained["info"]["checkpoint_path"] == str(ck)

    for ref in ("latest", str(ck)):
        cfg2 = _cfg(synth, tmp_path)
        cfg2.finetune.eval_only = True
        cfg2.finetune.checkpoint = ref
        cfg2.finetune.save_model = False
        ev = run(cfg2, device="cpu", logger_mode="off")["peft"]
        for key in ("top1", "f1", "loss"):
            assert ev["test"][key] == pytest.approx(trained["test"][key],
                                                    abs=1e-6)
        _same(trained["params"], ev["params"])

    # resume + eval_only evaluates the checkpoint too
    cfg3 = _cfg(synth, tmp_path)
    cfg3.finetune.eval_only = True
    cfg3.finetune.resume = True
    ev = run(cfg3, device="cpu", logger_mode="off")["peft"]
    assert ev["test"]["top1"] == pytest.approx(trained["test"]["top1"])

    # the embedding cache of a checkpoint, without training
    cfg4 = _cfg(synth, tmp_path)
    cfg4.finetune.enabled = False
    cfg4.finetune.cache_embeddings = True
    cfg4.finetune.cache_embeddings_checkpoint = str(ck)
    cfg4.finetune.cache_embeddings_dir = str(tmp_path / "emb2")
    run(cfg4, device="cpu", logger_mode="off")
    emb = load_embedding_cache(embedding_cache_dir(cfg4, "test"))
    np.testing.assert_allclose(emb["embeddings"], emb_trained["embeddings"],
                               atol=1e-6)
    assert emb["info"]["checkpoint_path"] == str(ck)

    # a params-only warm start: training continues from the checkpoint's
    # weights with a fresh optimizer (the result differs from both)
    cfg5 = _cfg(synth, tmp_path)
    cfg5.finetune.checkpoint = str(ck)
    cfg5.finetune.save_model = False
    warm = run(cfg5, device="cpu", logger_mode="off")["peft"]
    assert any(not torch.equal(warm["params"][n], trained["params"][n])
               for n in trained["params"])


def test_runner_resume_flag(synth, tmp_path, monkeypatch):
    """checkpoint_interval 1 writes async epoch checkpoints (waited for
    after training) and the final one; a second run with resume=true picks
    the latest and its result equals the first run's; with no checkpoint
    it starts fresh."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(synth, tmp_path, train_epoch=3)
    cfg.finetune.checkpoint_interval = 1
    first = run(cfg, device="cpu", logger_mode="off")["peft"]
    names = sorted(p.name.split("_")[2] for p in
                   (tmp_path / "model_ckpt").iterdir())
    assert names == ["1", "2", "3"]
    cfg2 = _cfg(synth, tmp_path, train_epoch=3)
    cfg2.finetune.resume = True
    cfg2.finetune.save_model = False
    again = run(cfg2, device="cpu", logger_mode="off")["peft"]
    _same(first["params"], again["params"])
    cfg3 = _cfg(synth, tmp_path / "none", train_epoch=1)
    cfg3.finetune.resume = True
    cfg3.finetune.save_model = False
    out = run(cfg3, device="cpu", logger_mode="off")["peft"]
    assert out["test"] is not None


def test_cli_sigterm_then_resume(synth, tmp_path):
    """``python -m aihab_clip_tpu_torch`` on the CPU: SIGTERM after its
    first ``Train Epoch`` line; it exits 0 with the checkpoint of the epoch
    it stopped after (and no final one under the configured epoch count); a
    second run with ``finetune.resume True`` finishes, bit for bit with an
    uninterrupted run's checkpoint."""
    opts = ["data.dataset_paths", repr(synth["dataset_paths"]),
            "data.index_file_names", repr(synth["index_file_names"]),
            "data.data_split.valid_split", "0.25",
            "data.preprocessing.resize", "40",
            "data.preprocessing.resolution", "32",
            "clip_backend", "openclip", "open_clip_model", "random:Tiny",
            "use_model_preprocess", "False", "train_epoch", "3",
            "wandb_project", "None", "finetune.save_model", "True",
            "finetune.checkpoint_interval", "1",
            "finetune.cache_embeddings", "False"]

    def cmd(root, *extra):
        return [sys.executable, "-m", "aihab_clip_tpu_torch", "--base_config",
                "configs/base.yaml", "--dataset_config", "configs/cs.yaml",
                "--device", "cpu", "--logger", "off", "--opts", *opts,
                "root_path", str(root), *extra]

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    full_root, int_root = tmp_path / "full", tmp_path / "int"
    subprocess.run(cmd(full_root), cwd=tmp_path, env=env, check=True,
                   capture_output=True, timeout=600)
    proc = subprocess.Popen(cmd(int_root), cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("Train Epoch: 1 /"):
            proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=600) == 0, "".join(lines)[-3000:]
    # the signal lands after epoch 1's line; on a loaded host the run may
    # have passed epoch 1's check before it arrives, and stops after epoch 2
    stopped = re.findall(r"interrupted after epoch (\d)", "".join(lines))
    assert stopped and stopped[0] in ("1", "2"), "".join(lines)[-3000:]
    ckdir = int_root / "model_ckpt"
    assert sorted(p.name.split("_")[2] for p in ckdir.iterdir()) == [
        str(e) for e in range(1, int(stopped[0]) + 1)]
    proc = subprocess.run(cmd(int_root, "finetune.resume", "True"),
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"[resume] restored epoch {stopped[0]}" in proc.stdout

    def final(root):
        path = max((root / "model_ckpt").iterdir(),
                   key=lambda p: int(p.name.split("_")[2]))
        return load_checkpoint(path)["params"]

    _same(final(full_root), final(int_root))


@pytest.mark.parametrize("stop_at", [1, 2])
def test_runner_sigterm_keeps_the_epoch_reached(synth, tmp_path, monkeypatch,
                                                stop_at):
    """A SIGTERM in epoch ``stop_at`` of 2 with ``checkpoint_interval 1``
    and ``save_model``: before the last epoch the run keeps the epoch-1
    checkpoint alone (no final one under the configured count, which a
    resume would take as finished); in the last epoch the run is complete
    and the final checkpoint is written."""
    from aihab_clip_tpu_torch import runner

    monkeypatch.chdir(tmp_path)
    orig = runner.finetune

    class TermAt:
        def log(self, d):
            if d.get("epoch") == stop_at:
                signal.raise_signal(signal.SIGTERM)

    def finetune_with_signal(*args, **kw):
        kw["logger"] = TermAt()
        return orig(*args, **kw)

    monkeypatch.setattr(runner, "finetune", finetune_with_signal)
    cfg = _cfg(synth, tmp_path, train_epoch=2)
    cfg.finetune.checkpoint_interval = 1
    out = run(cfg, device="cpu", logger_mode="off")["peft"]
    assert out["interrupted_at_epoch"] == stop_at
    epochs = sorted(p.name.split("_")[2] for p in
                    (tmp_path / "model_ckpt").iterdir())
    assert epochs == (["1"] if stop_at == 1 else ["1", "2"])
    assert (out["checkpoint_path"] is None) == (stop_at == 1)
