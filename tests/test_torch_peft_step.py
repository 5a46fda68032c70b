"""The port's PEFT train step against the JAX package on the same weights:
the frozen-prefix hybrid encode (``siglip_encode_hybrid``) and its
gradients, its head grouping and ranged pack, and the train objective's
loss and gradients (``_build_loss_fn``).  The fine-tune loop:
``tests/test_torch_peft.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.models import fast_siglip as jax_fast
from aihab_clip_tpu.models import siglip as jax_siglip
from aihab_clip_tpu.train import peft as jax_peft

from aihab_clip_tpu_torch.models import SigLIPConfig, fast_siglip
from aihab_clip_tpu_torch.models.convert import _convert_key, flatten_params
from aihab_clip_tpu_torch.train import peft

from test_torch_peft import _head, _noisy, _port_model, siglip_tiny  # noqa: F401

# a head_dim-72 SigLIP tower: SO400M's head width at a test size
HEAD72 = dict(embed_dim=144, image_resolution=48, patch_size=8,
              vision_width=144, vision_layers=3, vision_heads=2,
              vision_mlp_dim=344, context_length=16, vocab_size=49408,
              text_width=144, text_layers=2, text_heads=2, text_mlp_dim=344)


@pytest.fixture(scope="module")
def head72():
    jcfg = jax_siglip.SigLIPConfig(**HEAD72)
    jmodel = jax_siglip.SigLIPModel(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(3), jnp.zeros((1, 48, 48, 3)),
                                  jnp.zeros((1, 16), jnp.int32))["params"]
    params = _noisy(params, 4)
    images = np.random.default_rng(5).standard_normal(
        (2, 48, 48, 3)).astype(np.float32)
    return jcfg, params, _port_model(params, SigLIPConfig(**HEAD72)), images


def test_hybrid_encode_and_gradients_match_jax(head72):
    """Blocks [0, 2) through the K5/K4 plain versions without a graph (JAX:
    interpret-mode Pallas behind ``stop_gradient``), block 2 and the MAP
    head under autograd; the suffix's gradients of a scalar loss against
    ``jax.grad``, and no gradient reaches the prefix."""
    jcfg, params, model, images = head72
    cfg = SigLIPConfig(**HEAD72)
    r = np.random.default_rng(6).standard_normal((2, 144)).astype(np.float32)

    def jax_loss(p):
        pooled, _ = jax_fast.siglip_encode_hybrid(
            p, jnp.asarray(images), jcfg, 2, project=True, dtype=jnp.float32,
            interpret=True)
        return jnp.sum(pooled * r), pooled

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    model.zero_grad(set_to_none=True)
    pooled, same = fast_siglip.siglip_encode_hybrid(
        model, torch.from_numpy(images), cfg, 2, project=True,
        dtype=torch.float32)
    assert same is pooled
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(ref),
                               atol=5e-4, rtol=5e-4)
    (pooled * torch.from_numpy(r)).sum().backward()
    named = dict(model.named_parameters())
    for key, g in flatten_params(grads).items():
        name, g = _convert_key(key, g)
        suffix = name.startswith(("visual.transformer.resblocks.2.",
                                  "visual.ln_post", "visual.attnpool"))
        if suffix:
            np.testing.assert_allclose(named[name].grad.numpy(), g,
                                       atol=1e-4, rtol=1e-4, err_msg=name)
        else:
            assert named[name].grad is None, name
            assert not np.any(g), name


def test_hybrid_without_prefix_is_the_canonical_tower(head72):
    jcfg, params, model, images = head72
    x = torch.from_numpy(images)
    with torch.no_grad():
        hybrid = fast_siglip.siglip_encode_hybrid(
            model, x, SigLIPConfig(**HEAD72), 0, dtype=torch.float32)
        canon = model.encode_image(x)
    torch.testing.assert_close(hybrid, canon, rtol=1e-5, atol=1e-5)


def test_hybrid_grouping_matches_jax(monkeypatch):
    monkeypatch.delenv("AIHAB_SIGLIP_HPG", raising=False)
    for name in ("ViT-SO400M-16-SigLIP2-384", "ViT-B-16-SigLIP-224",
                 "SigLIP-Tiny"):
        cfg = jax_siglip.SIGLIP_ARCHS[name]
        port_cfg = SigLIPConfig(**dataclasses.asdict(cfg))
        for hybrid in (False, True):
            assert fast_siglip.siglip_attn_groups(port_cfg, hybrid) == \
                jax_fast.siglip_attn_groups(cfg, hybrid)


def test_ranged_pack_matches_jax(head72):
    jcfg, params, model, _ = head72
    ref = jax_fast.pack_siglip_fast_params(params, jcfg, jnp.float32,
                                           start=1, stop=3, hybrid=True)
    packed = fast_siglip.pack_siglip_fast_params(
        model, SigLIPConfig(**HEAD72), torch.float32, start=1, stop=3,
        hybrid=True)
    assert packed["start"] == 1 and len(packed["blocks"]) == 2
    for i, blk in zip((1, 2), packed["blocks"]):
        rb = ref[f"resblocks_{i}"]
        np.testing.assert_array_equal(
            blk["wqkv_g"].numpy(),
            np.asarray(rb["wqkv_g"]).transpose(1, 0, 2).reshape(144, -1))
        np.testing.assert_array_equal(blk["wout_g"].numpy(),
                                      np.asarray(rb["wout_g"]))


# ---------------------------------------------------------------------------
# the train objective
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tune_text", [False, True])
def test_loss_and_gradients_match_jax(siglip_tiny, tune_text):
    """``_build_loss_fn`` (center crop, fp32) against JAX's under
    ``jax.value_and_grad``: the loss at 1e-5, every trainable gradient at
    1e-4, with the fused prefix off and on (the JAX side runs the canonical
    module)."""
    b, params, model = siglip_tiny
    head, tpc = _head(b, params)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.integers(0, 20, 8).astype(np.int32)
    valid = np.array([True] * 6 + [False] * 2)
    base = dict(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                crop_mode="center", tune_text=tune_text, num_templates=tpc)
    kw = dict(unlocked_groups=2, tune_text=tune_text, unlocked_text_layers=1)
    mask = jax_peft.build_lock_mask(b.params, 2, 2, **kw)
    trainable, frozen = jax_peft.partition_params(params, mask)
    loss_fn = jax_peft._build_loss_fn(
        b.model, jax_peft.PEFTConfig(fused_prefix=0, **base),
        head["text_weights"], head["prompt_tokens"])
    (ref_loss, (ref_correct, _)), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable, frozen, jnp.asarray(images),
                               jnp.asarray(labels), jnp.asarray(valid),
                               jax.random.key(0))
    ref_grads = dict(_convert_key(k, g)
                     for k, g in flatten_params(ref_grads).items())
    port_mask = peft.build_lock_mask(model, 2, 2, **kw)
    assert {n for n, v in port_mask.items() if v} == set(ref_grads)
    for fused_prefix in (0, 1):
        cfg = peft.PEFTConfig(fused_prefix=fused_prefix, **base)
        fn = peft._build_loss_fn(model, cfg,
                                 torch.from_numpy(np.asarray(
                                     head["text_weights"])),
                                 torch.from_numpy(np.asarray(
                                     head["prompt_tokens"])))
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
