"""The ModifiedResNet towers' training paths in the port against the JAX
package on the same ``TinyRN`` weights (BatchNorm statistics randomized):
the lock masks at every unlock depth (BatchNorm ``mean``/``var`` never
trainable), one PEFT step's loss and gradients against ``jax.grad``, a CPU
``finetune`` and its refusals, LoRA on an RN config, ProLIP's ``c_proj``
projector on the tower's cached features against JAX's trainer, and the
runner's openai path (feature cache + ProLIP) on ``random:TinyRN``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from aihab_clip_tpu.models import CLIPModel as JaxCLIPModel
from aihab_clip_tpu.models import build_text_head as jax_text_head
from aihab_clip_tpu.models import clip as jax_clip
from aihab_clip_tpu.train import lora as jax_lora
from aihab_clip_tpu.train import peft as jax_peft
from aihab_clip_tpu.train import prolip as jax_prolip

from aihab_clip_tpu_torch.cache import (feature_cache_dir,
                                        read_preprojection_cache)
from aihab_clip_tpu_torch.config import ConfigNode
from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
from aihab_clip_tpu_torch.models.convert import _convert_key, flatten_params
from aihab_clip_tpu_torch.runner import run
from aihab_clip_tpu_torch.templates import gen_prompts
from aihab_clip_tpu_torch.train import lora, peft, prolip

from test_torch_peft import _dataset
from test_torch_resnet import _jax_encode, port_model, tiny_rn_params

CFG = jax_clip.CLIP_ARCHS["TinyRN"]


@pytest.fixture(scope="module")
def tiny():
    """(JAX's TinyRN CLIPModel, params with random BN statistics, the
    port's model on the same weights)."""
    params = tiny_rn_params(5)
    return JaxCLIPModel(CFG), params, port_model(params, CFG)


def _port_names(keys):
    return {_convert_key(k, np.zeros((1, 1, 1, 1)))[0] for k in keys}


@pytest.mark.parametrize("unlocked_groups", range(7))
@pytest.mark.parametrize("text", [(False, 0), (True, 1)])
def test_lock_mask_matches_jax(tiny, unlocked_groups, text):
    """Groups stem / 4 stages / attnpool, key for key with JAX's mask
    (``peft.py:129-157``, as its ``finetune`` calls it for an RN tower),
    and no BatchNorm statistic trainable at any depth."""
    _, params, model = tiny
    tune_text, text_layers = text
    ref = jax_peft.build_lock_mask(
        params, 0, CFG.transformer_layers, unlocked_groups=unlocked_groups,
        tune_text=tune_text, unlocked_text_layers=text_layers, is_vit=False,
        tower="rn")
    flat = {"/".join(k): bool(v)
            for k, v in traverse_util.flatten_dict(ref).items()}
    try:
        mask = peft.build_lock_mask(
            model, CFG.vision_layers, CFG.transformer_layers,
            unlocked_groups=unlocked_groups, tune_text=tune_text,
            unlocked_text_layers=text_layers)
        assert set(mask) == _port_names(flat)
        trainable = {n for n, v in mask.items() if v}
        assert trainable == _port_names(k for k, v in flat.items() if v)
        assert not any(n.endswith((".mean", ".var")) for n in trainable)
        stages = {n.split(".")[1] for n in trainable
                  if n.startswith("visual.")}
        want = ({"conv1", "conv2", "conv3", "bn1", "bn2", "bn3"}
                if unlocked_groups == 6 else set()) | {
            f"layer{s}_0" for s in range(max(1, 6 - unlocked_groups), 5)} | (
            {"attnpool"} if unlocked_groups else set())
        assert stages == want
        for name, param in model.named_parameters():
            assert param.requires_grad == mask[name]
    finally:
        for name, param in model.named_parameters():
            param.requires_grad_(name.rsplit(".", 1)[-1] not in ("mean",
                                                                 "var"))


def _head(jmodel, params):
    prompts, tpc = gen_prompts(use_hierarchy=False, use_descriptive=False)
    return jax_text_head(jmodel, params, prompts, 20, tpc), tpc


@pytest.mark.parametrize("tune_text", [False, True])
def test_step_loss_and_gradients_match_jax(tiny, tune_text):
    """``_build_loss_fn`` on the RN tower (center crop, fp32, the canonical
    module) against JAX's under ``jax.value_and_grad`` at unlocked_groups
    2: the loss at 1e-5, every trainable gradient (attnpool, stage 4 and,
    with ``tune_text``, the text head) at 1e-4; no gradient reaches a
    frozen leaf."""
    jmodel, params, model = tiny
    head, tpc = _head(jmodel, params)
    rng = np.random.default_rng(17)
    images = rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.integers(0, 20, 8).astype(np.int32)
    valid = np.array([True] * 6 + [False] * 2)
    base = dict(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                crop_mode="center", tune_text=tune_text, num_templates=tpc)
    kw = dict(unlocked_groups=2, tune_text=tune_text, unlocked_text_layers=1)
    mask = jax_peft.build_lock_mask(params, 0, 2, is_vit=False, tower="rn",
                                    **kw)
    trainable, frozen = jax_peft.partition_params(params, mask)
    loss_fn = jax_peft._build_loss_fn(
        jmodel, jax_peft.PEFTConfig(fused_prefix=0, **base),
        head["text_weights"], head["prompt_tokens"])
    (ref_loss, (ref_correct, _)), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable, frozen, jnp.asarray(images),
                               jnp.asarray(labels), jnp.asarray(valid),
                               jax.random.key(0))
    ref_grads = dict(_convert_key(k, g)
                     for k, g in flatten_params(ref_grads).items())
    try:
        port_mask = peft.build_lock_mask(model, CFG.vision_layers, 2, **kw)
        assert {n for n, v in port_mask.items() if v} == set(ref_grads)
        fn = peft._build_loss_fn(
            model, peft.PEFTConfig(**base),
            torch.from_numpy(np.array(head["text_weights"])),
            torch.from_numpy(np.array(head["prompt_tokens"])))
        model.zero_grad(set_to_none=True)
        loss, (correct, n_valid) = fn(
            torch.from_numpy(images), torch.from_numpy(labels),
            torch.from_numpy(valid), torch.Generator().manual_seed(0))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5,
                                   atol=1e-5)
        assert int(correct) == int(ref_correct) and float(n_valid) == 6.0
        for name, param in model.named_parameters():
            if port_mask[name]:
                np.testing.assert_allclose(param.grad.numpy(),
                                           ref_grads[name], atol=1e-4,
                                           rtol=1e-4, err_msg=name)
            else:
                assert param.grad is None, name
    finally:
        model.zero_grad(set_to_none=True)
        for name, param in model.named_parameters():
            param.requires_grad_(name.rsplit(".", 1)[-1] not in ("mean",
                                                                 "var"))


def test_finetune_runs_and_refuses_a_prefix(monkeypatch):
    """``finetune`` on an RN tower runs the canonical module (no fused
    prefix on the CPU or the card, as JAX's on the TPU): frozen leaves,
    BatchNorm statistics included, stay bit-identical and trained ones
    move; an explicit ``fused_prefix`` raises the ``ValueError`` JAX's
    check words."""
    from aihab_clip_tpu.models import fast_vit as jax_fast_vit

    model = port_model(tiny_rn_params(9), CFG)
    assert peft.peft_fused_prefix_len(model.config, 2, "cpu") == 0
    with monkeypatch.context() as mp:
        mp.setattr(jax_fast_vit, "dispatch_backend", lambda: "tpu")
        mp.setattr(peft, "resolve_device", lambda device: torch.device("cuda"))
        for u in (0, 2, 6):
            assert peft.peft_fused_prefix_len(model.config, u, "cuda") == \
                jax_fast_vit.peft_fused_prefix_len(CFG, u) == 0
    ds = _dataset(ImageArrayDataset, n=12)
    weights = torch.nn.functional.normalize(
        torch.randn(32, 20, generator=torch.Generator().manual_seed(28)),
        dim=0)
    cfg = peft.PEFTConfig(resolution=32, num_classes=20, lr=1e-3, epochs=2,
                          crop_mode="center")
    with pytest.raises(ValueError, match="the RN tower has no fused-prefix"):
        peft.finetune(model, SplitView(ds, np.arange(8), 4), None, None,
                      dataclasses.replace(cfg, fused_prefix=1),
                      text_weights=weights, unlocked_groups=2, device="cpu",
                      verbose=False)
    # JAX computes the frozen depth from the stage tuple first, so its
    # ValueError is never reached there (departure D4)
    from aihab_clip_tpu.data.bulk_load import ImageArrayDataset as JaxDataset
    from aihab_clip_tpu.data.pipeline import SplitView as JaxView

    with pytest.raises(TypeError, match="tuple"):
        jax_peft.finetune(
            JaxCLIPModel(CFG), tiny_rn_params(9),
            JaxView(_dataset(JaxDataset, n=12), np.arange(8), 4), None, None,
            jax_peft.PEFTConfig(resolution=32, num_classes=20, lr=1e-3,
                                epochs=2, crop_mode="center", fused_prefix=1),
            text_weights=jnp.asarray(weights.numpy()), unlocked_groups=2,
            verbose=False)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = peft.finetune(model, SplitView(ds, np.arange(8), 4), None,
                        SplitView(ds, np.arange(8, 12), 4), cfg,
                        text_weights=weights, unlocked_groups=3,
                        device="cpu", verbose=False)
    moved = set()
    for name, trainable in out["mask"].items():
        if not torch.equal(start[name], out["params"][name]):
            assert trainable, name
            moved.add(name.split(".")[1])
    assert moved == {"layer3_0", "layer4_0", "attnpool"}
    assert out["report"]["num_trainable"] == sum(out["mask"].values())
    assert np.isfinite(out["test"]["loss"])


def test_lora_on_rn_adapts_the_text_tower_only(tiny):
    """LoRA targets transformer blocks: on an RN config the visual tower
    alone has none and raises JAX's ``ValueError``; with the text tower
    every target is a text block's, the same as JAX's."""
    _, params, model = tiny
    gen = torch.Generator().manual_seed(1)
    with pytest.raises(ValueError, match="no LoRA target kernels found"):
        lora.lora_init(model, 4, gen, towers=("visual",))
    with pytest.raises(ValueError, match="no LoRA target kernels found"):
        jax_lora.lora_init(params, 4, jax.random.key(1), towers=("visual",))
    got = lora.lora_target_paths(model, towers=("visual", "text"),
                                 include_mlp=True)
    ref = jax_lora.lora_target_paths(params, towers=("visual", "text"),
                                     include_mlp=True)
    assert got == [_convert_key("/".join(p), np.zeros((1, 1)))[0]
                   for p in ref]
    assert got and all(n.startswith("text.transformer.") for n in got)


def test_prolip_on_rn_features_matches_jax(tiny):
    """ProLIP on the tower's own pre-projection features: the port's
    canonical encode against JAX's (5e-5 / 1e-4), then ``train_projector``
    from the ``c_proj`` spec (weight trained, bias frozen) on the same
    cached views against JAX's trainer, at test_torch_cache_prolip.py's
    tolerances (rel L2 1e-5, the same accuracies, losses within 1e-4)."""
    jmodel, params, model = tiny
    rng = np.random.default_rng(21)
    views = [rng.standard_normal((12, 32, 32, 3)).astype(np.float32)
             for _ in range(2)]
    with torch.no_grad():
        feats = [model.encode_image(torch.from_numpy(v)).numpy()
                 for v in views]
    jfeats = [np.asarray(_jax_encode(jmodel, params, v, False))
              for v in views]
    for f, j in zip(feats, jfeats):
        assert f.shape == (12, 256)
        np.testing.assert_allclose(f, j, atol=5e-5, rtol=1e-4)
    labels = rng.integers(0, 6, 12).astype(np.int32)
    tw = rng.standard_normal((32, 6)).astype(np.float32)
    tw /= np.linalg.norm(tw, axis=0, keepdims=True)
    spec = prolip.ProjectorSpec.from_clip_model(model)
    jspec = jax_prolip.ProjectorSpec.from_clip_params(params, False)
    mine, stats = prolip.train_projector(feats, labels, torch.from_numpy(tw),
                                         spec, 1e-2, 0.1, 5, verbose=False,
                                         device="cpu")
    ref, ref_stats = jax_prolip.train_projector(feats, labels, jnp.asarray(tw),
                                                jspec, 1e-2, 0.1, 5,
                                                verbose=False)
    w, rw = mine.weight.numpy().astype(np.float64), np.asarray(ref.weight,
                                                                np.float64)
    assert np.linalg.norm(w - rw) / np.linalg.norm(rw) <= 1e-5
    assert torch.equal(mine.bias, spec.bias)
    assert [s["acc"] for s in stats["epochs"]] == \
        [s["acc"] for s in ref_stats["epochs"]]
    for a, b in zip(stats["epochs"], ref_stats["epochs"]):
        assert a["ce"] == pytest.approx(b["ce"], rel=1e-4)


def test_runner_caches_features_and_fits_prolip_on_rn(tmp_path, monkeypatch):
    """The runner's openai path on ``random:TinyRN``: the feature cache
    holds 256-wide fp16 views of the train split, and ProLIP trains the
    attention pool's ``c_proj`` on them."""
    from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset

    from test_torch_runner import _cfg_dict

    synth = make_synthetic_cs_dataset(tmp_path / "data", n_train_per_class=5,
                                      n_test_per_class=3, image_size=48)
    monkeypatch.chdir(tmp_path)
    d = _cfg_dict(synth, tmp_path)
    d.update(backbone="random:TinyRN", save_features=True, train_epoch=3)
    cfg = ConfigNode(d)
    result = run(cfg, device="cpu")
    assert result["bundle"]["config"].tower == "rn"
    views, labels = read_preprojection_cache(feature_cache_dir(cfg), 2)
    n = result["loaders"].train.num_samples
    assert all(v.shape == (n, 256) and v.dtype == np.float16 for v in views)
    assert len(labels) == n
    out = result["prolip"]
    assert out["projector"].weight.shape == (256, 32)
    assert out["projector"].bias is not None
    assert 0.0 <= out["acc"] <= 100.0 and np.isfinite(out["loss"])
