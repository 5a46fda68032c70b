"""The port's feature cache, projector checkpoints and ProLIP trainer
against the JAX package: the cache layout names, caches and projector
``.npz`` written by either package read by the other bit for bit,
``train_projector`` (full batch, chunked, 3 views) within 1e-5 rel L2 of
JAX's on the same features and weights with the same accuracy, the grid
search's pick and its 49 validation accuracies, ``ProjectorSpec``'s cases,
the optax-form Adam, and the run logger's modes."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from aihab_clip_tpu.cache import embedding_cache as jax_emb
from aihab_clip_tpu.cache import feature_cache as jax_fc
from aihab_clip_tpu.config import ConfigNode as JaxConfig
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.train import prolip as jax_prolip
from aihab_clip_tpu.utils import checkpointing as jax_ckpt

from aihab_clip_tpu_torch.cache import array_store, embedding_cache
from aihab_clip_tpu_torch.cache import feature_cache as fc
from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.models import CLIPConfig, CLIPModel
from aihab_clip_tpu_torch.models import zoo
from aihab_clip_tpu_torch.models.convert import (flax_params_to_state_dict,
                                                 state_dict_to_flax_params)
from aihab_clip_tpu_torch.train import prolip
from aihab_clip_tpu_torch.utils import RunLogger, load_projector, save_projector

RNG = np.random.default_rng(0)
PRE, EMB, C = 48, 24, 6

CFGS = [
    {"clip_backend": "openai", "backbone": "ViT-B/16", "dataset": "cs",
     "seed": 1, "shots": 0},
    {"clip_backend": "openai", "backbone": "random:Tiny", "dataset": "synth",
     "seed": 3, "shots": 16, "root_path": "/tmp/r"},
    {"clip_backend": "openclip",
     "open_clip_model": "hf-hub:timm/ViT-SO400M-16-SigLIP2-384",
     "dataset": "cs", "seed": 2, "shots": 4,
     "finetune": {"cache_embeddings_dir": "vis"}},
    {"clip_backend": "openclip", "backbone": "ViT-B/32", "dataset": "cs",
     "finetune": {"cache_embeddings_dir": "/abs/vis"}},
]


@pytest.mark.parametrize("d", CFGS, ids=lambda d: str(d.get(
    "backbone", d.get("open_clip_model"))))
def test_layout_names_equal_jax(d):
    mine, ref = ConfigNode(d), JaxConfig(d)
    assert str(fc.feature_cache_dir(mine)) == str(jax_fc.feature_cache_dir(ref))
    for split in ("train", "test"):
        assert str(embedding_cache.embedding_cache_dir(mine, split)) == \
            str(jax_emb.embedding_cache_dir(ref, split))
    for name in ("ViT-B/16", "ViT-B/32", "hf-hub:timm/x y:z", "", "RN50"):
        assert fc.canonical_backbone_name(name) == \
            jax_fc.canonical_backbone_name(name)


def _views(n=40, v=3):
    return ([RNG.standard_normal((n, PRE)).astype(np.float16)
             for _ in range(v)], RNG.integers(0, C, n).astype(np.int32))


def test_feature_cache_both_ways(tmp_path):
    views, labels = _views()

    def encode_view(v):
        return views[v], labels

    jax_fc.write_preprojection_cache(tmp_path / "j", encode_view, 3)
    fc.write_preprojection_cache(tmp_path / "p", encode_view, 3)
    for d in ("j", "p"):
        for reader in (fc.read_preprojection_cache,
                       jax_fc.read_preprojection_cache):
            got, lab = reader(tmp_path / d, 3, max_label=C - 1)
            keep = labels < C - 1
            assert np.array_equal(lab, labels[keep])
            for a, b in zip(got, views):
                assert a.dtype == np.float16 and np.array_equal(a, b[keep])
        assert fc.feature_cache_exists_sharded(tmp_path / d, 3)
        assert not fc.feature_cache_exists(tmp_path / d, 4)
    # a multi-host layout the JAX package wrote (two shards) reads here too
    for k, sl in enumerate((slice(0, 25), slice(25, 40))):
        jax_fc.write_preprojection_cache(
            tmp_path / "s", lambda v, sl=sl: (views[v][sl], labels[sl]), 3,
            shard_index=k, shard_count=2)
    got, lab = fc.read_preprojection_cache(tmp_path / "s", 3)
    assert np.array_equal(lab, labels)
    assert all(np.array_equal(a, b) for a, b in zip(got, views))
    manifest = json.loads((tmp_path / "p" / "manifest.json").read_text())
    assert manifest["n"] == 40 and manifest["dim"] == PRE


def test_projector_npz_both_ways(tmp_path):
    w = RNG.standard_normal((PRE, EMB)).astype(np.float32)
    b = RNG.standard_normal(EMB).astype(np.float32)
    save_projector(tmp_path / "p.npz", torch.from_numpy(w),
                   torch.from_numpy(b), meta={"lr": 1e-3})
    jax_ckpt.save_projector(tmp_path / "j.npz", jnp.asarray(w), None,
                            meta={"lr": 1e-3})
    jw, jb = jax_ckpt.load_projector(tmp_path / "p.npz")
    assert np.array_equal(jw, w) and np.array_equal(jb, b)
    pw, pb = load_projector(tmp_path / "j.npz")
    assert np.array_equal(pw, w) and pb is None
    assert json.loads((tmp_path / "p.json").read_text()) == {"lr": 1e-3}


def test_remote_root_raises_a18(tmp_path):
    """A ``scheme://`` root opens the zarr store, as JAX's ``open_store``
    opens its ``TensorStoreStore``; ``gs://`` raises at its first read or
    write, naming A18c (no network, no cloud client)."""
    from aihab_clip_tpu.cache import array_store as jax_store

    for root in (tmp_path, f"file://{tmp_path}", "gs://bucket/prefix",
                 "s3://bucket/prefix"):
        ours, ref = array_store.open_store(root), jax_store.open_store(root)
        assert isinstance(ours, array_store.ZarrStore) == isinstance(
            ref, jax_store.TensorStoreStore), root
        assert isinstance(ours, array_store.LocalNpyStore) == isinstance(
            ref, jax_store.LocalNpyStore), root
    assert array_store.join_cache_path("gs://b/", "x", "y") == \
        jax_store.join_cache_path("gs://b/", "x", "y") == "gs://b/x/y"
    remote = array_store.open_store("gs://bucket/prefix")
    for io in (lambda: remote.exists("f0"), lambda: remote.load("f0"),
               lambda: remote.save("f0", np.zeros(2)),
               lambda: remote.write_json("m.json", {}),
               lambda: remote.list_arrays("f")):
        with pytest.raises(NotImplementedError, match="A18c"):
            io()


def _problem(n=40, views=3, seed=0):
    rng = np.random.default_rng(seed)
    vs = [rng.standard_normal((n, PRE)).astype(np.float32) for _ in range(views)]
    labels = rng.integers(0, C, n).astype(np.int32)
    tw = rng.standard_normal((EMB, C)).astype(np.float32)
    tw /= np.linalg.norm(tw, axis=0, keepdims=True)
    w0 = (rng.standard_normal((PRE, EMB)) / np.sqrt(PRE)).astype(np.float32)
    return vs, labels, tw, w0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("feat_bs,views,bias", [
    (0, 3, False), (16, 3, False), (0, 1, True), (12, 2, True)],
    ids=["full-3v", "chunked-3v", "full-bias", "chunked-bias"])
def test_train_projector_equals_jax(feat_bs, views, bias):
    vs, labels, tw, w0 = _problem(views=views)
    b0 = RNG.standard_normal(EMB).astype(np.float32) * 0.1 if bias else None
    mine, stats = prolip.train_projector(
        vs, labels, torch.from_numpy(tw),
        prolip.ProjectorSpec(torch.from_numpy(w0),
                             None if b0 is None else torch.from_numpy(b0)),
        1e-2, 0.1, 6, feat_batch_size=feat_bs, verbose=False, device="cpu")
    ref, ref_stats = jax_prolip.train_projector(
        vs, labels, jnp.asarray(tw),
        jax_prolip.ProjectorSpec(jnp.asarray(w0),
                                 None if b0 is None else jnp.asarray(b0)),
        1e-2, 0.1, 6, feat_batch_size=feat_bs, verbose=False)
    # 1e-5 rel L2: two fp32 Adams in the same arithmetic, summation orders
    # apart
    assert _rel(mine.weight.numpy(), ref.weight) <= 1e-5
    assert [s["acc"] for s in stats["epochs"]] == \
        [s["acc"] for s in ref_stats["epochs"]]
    # the losses within 1e-4 relative: the logits are 100 x cosines, so an
    # fp32 rounding of a feature moves a large CE by ~1e-5 of itself
    for a, b in zip(stats["epochs"], ref_stats["epochs"]):
        assert a["ce"] == pytest.approx(b["ce"], rel=1e-4)
        assert a["mse"] == pytest.approx(b["mse"], rel=1e-4, abs=1e-9)
    assert stats["final_loss"] == pytest.approx(ref_stats["final_loss"],
                                                rel=1e-4)
    test_x = np.random.default_rng(5).standard_normal((30, PRE)).astype(np.float32)
    test_y = np.random.default_rng(6).integers(0, C, 30)
    assert prolip.projector_accuracy(mine, test_x, test_y, tw) == \
        jax_prolip.projector_accuracy(ref, test_x, test_y, jnp.asarray(tw))


def test_grid_search_equals_jax(capsys):
    """The pick and the 49 validation accuracies of JAX's vmapped grid (read
    from its printed lines, 4 decimals)."""
    vs, labels, tw, w0 = _problem(n=36, views=2, seed=1)
    vf = np.random.default_rng(2).standard_normal((24, PRE)).astype(np.float32)
    vl = np.random.default_rng(3).integers(0, C, 24)
    spec = prolip.ProjectorSpec(torch.from_numpy(w0), None)
    lr, lam, acc, accs = prolip.grid_search(
        vs, labels, tw, spec, vf, vl, 4, verbose=False, device="cpu",
        return_accs=True)
    assert len(accs) == 49
    capsys.readouterr()
    ref = jax_prolip.grid_search(
        vs, labels, jnp.asarray(tw),
        jax_prolip.ProjectorSpec(jnp.asarray(w0), None), vf, vl, 4,
        verbose=True)
    ref_accs = [float(line.rsplit("=", 1)[1])
                for line in capsys.readouterr().out.splitlines()
                if "val_acc=" in line]
    assert (lr, lam) == ref[:2] and acc == pytest.approx(ref[2], abs=1e-4)
    np.testing.assert_allclose(accs, ref_accs, atol=1e-4)


def test_grid_train_equals_train_projector():
    """A pair of the batched grid equals ``train_projector`` with it."""
    vs, labels, tw, w0 = _problem(n=30, views=3, seed=4)
    spec = prolip.ProjectorSpec(torch.from_numpy(w0), None)
    ws = prolip.grid_train(vs, labels, torch.from_numpy(tw), spec,
                           [1e-2, 1e-4], [0.1, 0.0], 5, device="cpu")
    for k, (lr, lam) in enumerate(((1e-2, 0.1), (1e-4, 0.0))):
        one, _ = prolip.train_projector(vs, labels, torch.from_numpy(tw),
                                        spec, lr, lam, 5, verbose=False)
        assert _rel(ws[k].numpy(), one.weight.numpy()) <= 1e-6


def test_adam_equals_optax():
    w = RNG.standard_normal((8, 5)).astype(np.float32)
    opt = optax.adam(learning_rate=1e-2, eps=1e-4)
    state = opt.init(jnp.asarray(w))
    jw = jnp.asarray(w)
    mine = prolip.Adam(torch.from_numpy(w))
    tw = torch.from_numpy(w)
    for _ in range(5):
        g = RNG.standard_normal(w.shape).astype(np.float32)
        upd, state = opt.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        tw = mine.step(tw, torch.from_numpy(g), 1e-2)
    # the moments are equal bit for bit; the parameters within 1e-6: XLA's
    # CPU code rounds the fused sqrt/divide of an update (~1e-2 here) about
    # 1e-5 of itself apart from torch's
    assert np.array_equal(mine.mu.numpy(), np.asarray(state[0].mu))
    assert np.array_equal(mine.nu.numpy(), np.asarray(state[0].nu))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


TINY_CONVNEXT_LINEAR = "TinyConvNeXt"


def test_projector_spec_cases():
    b = jax_load("random:Tiny", seed=1)
    model = CLIPModel(CLIPConfig(**dataclasses.asdict(b.config)))
    model.load_state_dict(flax_params_to_state_dict(b.params))
    spec = prolip.ProjectorSpec.from_clip_model(model)
    ref = jax_prolip.ProjectorSpec.from_clip_params(b.params, True)
    assert ref.bias is None and spec.bias is None
    assert np.array_equal(spec.weight.numpy(), np.asarray(ref.weight))
    # a linear-head ConvNeXt: head_proj's kernel trains, its bias stays
    cx = jax_load(f"random:{TINY_CONVNEXT_LINEAR}", seed=1)
    cmodel = CLIPModel(CLIPConfig(**dataclasses.asdict(cx.config)))
    cmodel.load_state_dict(flax_params_to_state_dict(cx.params))
    spec = prolip.ProjectorSpec.from_clip_model(cmodel)
    ref = jax_prolip.ProjectorSpec.from_clip_params(cx.params, False)
    assert np.array_equal(spec.weight.numpy(), np.asarray(ref.weight))
    assert np.array_equal(spec.bias.numpy(), np.asarray(ref.bias))
    cmodel.visual.proj = "mlp"
    with pytest.raises(ValueError, match="MLP-head"):
        prolip.ProjectorSpec.from_clip_model(cmodel)

    # a ModifiedResNet: the attention pool's c_proj, its bias frozen (the
    # port's random draw carried into JAX's layout)
    rmodel = zoo.load("random:TinyRN", device="cpu", seed=1).model
    rparams = traverse_util.unflatten_dict(
        state_dict_to_flax_params(rmodel.state_dict()), sep="/")
    spec = prolip.ProjectorSpec.from_clip_model(rmodel)
    ref = jax_prolip.ProjectorSpec.from_clip_params(rparams, False)
    assert spec.weight.shape == (256, 32)
    assert np.array_equal(spec.weight.numpy(), np.asarray(ref.weight))
    assert np.array_equal(spec.bias.numpy(), np.asarray(ref.bias))


@pytest.mark.parametrize("flags,shots", [
    ({}, 4), ({"lambda_funct_1_N": True}, 4), ({"lambda_funct_1_N2": True}, 4),
    ({"lambda_funct_1_N": True}, 0), ({"lambda_v": 0.5}, 8)])
def test_schedules_equal_jax(flags, shots):
    assert prolip.resolve_lambda(ConfigNode(flags), shots) == \
        jax_prolip.resolve_lambda(JaxConfig(flags), shots)
    for v in (1, 3, 300):
        assert [prolip.view_for_epoch(e, v) for e in range(7)] == \
            [jax_prolip.view_for_epoch(e, v) for e in range(7)]
    for e in range(6):
        assert prolip.cosine_lr(1e-3, e, 5) == jax_prolip.cosine_lr(1e-3, e, 5)


def test_run_logger_modes(tmp_path, capsys, monkeypatch):
    log = RunLogger("p", "r", config={"a": np.float32(1.5)}, mode="stdout",
                    run_dir=str(tmp_path / "s"))
    log.log({"acc": np.float64(0.5)})
    log.log_table("Some table", [{"x": 1, "y": "a"}, {"x": 2, "y": "b"}])
    log.log_confusion_matrix(np.array([[1, 2], [0, 3]]), ["u", "v"])
    assert (tmp_path / "s" / "log.jsonl").read_text().strip() == '{"acc": 0.5}'
    assert (tmp_path / "s" / "Some_table.csv").read_text() == "x,y\n1,a\n2,b\n"
    assert (tmp_path / "s" / "confusion_matrix.csv").read_text() == \
        "true_label,u,v\nu,1,2\nv,0,3\n"
    assert json.loads((tmp_path / "s" / "config.json").read_text()) == {"a": 1.5}
    RunLogger("p", "r", mode="auto", run_dir=str(tmp_path / "a")).log({"x": 1})
    assert (tmp_path / "a" / "log.jsonl").is_file()
    off = RunLogger("p", "r", mode="off", run_dir=str(tmp_path / "o"))
    off.log({"x": 1})
    assert not (tmp_path / "o").exists()
    # 'wandb' without the wandb package: the stdout logger, as JAX's
    monkeypatch.setitem(sys.modules, "wandb", None)
    wb = RunLogger("p", "r", mode="wandb", run_dir=str(tmp_path / "w"))
    wb.log({"x": 1})
    assert (tmp_path / "w" / "log.jsonl").read_text() == '{"x": 1}\n'
    wb.finish()
