"""The port's fused ViT encode against the JAX fused encode (Pallas in
interpret mode) on carried weights, on the merged and the two-kernel
paths, plus the dispatch plan and the weight pack; the per-op encode
``vit_encode_fast`` (K16) against JAX's for quick_gelu and gelu towers; and
the ``AIHAB_NO_GELU_POLY`` opt-out (``tests/test_fast_vit.py:438-505``) in
the plan, the block stack and the int8 route."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aihab_clip_tpu.models import CLIPConfig as JaxConfig
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.models import fast_vit as jax_fast_vit
from aihab_clip_tpu.models.fast_vit import \
    vit_encode_block_fused as jax_encode
from aihab_clip_tpu.models.quant_vit import _kernel_act as jax_kernel_act

from aihab_clip_tpu_torch.models import CLIP_ARCHS, CLIPConfig, CLIPModel
from aihab_clip_tpu_torch.models import fast_vit
from aihab_clip_tpu_torch.models import quant_vit as qv
from aihab_clip_tpu_torch.models.convert import (flax_params_to_state_dict,
                                                 load_params_npz)

TINY = dict(embed_dim=32, image_resolution=32, vision_layers=3,
            vision_width=128, vision_patch_size=8, context_length=77,
            vocab_size=49408, transformer_width=64, transformer_heads=1,
            transformer_layers=1)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    bundle = jax_load("random:torch-fastvit", random_cfg=JaxConfig(**TINY),
                      seed=11)
    path = tmp_path_factory.mktemp("fastvit") / "params.npz"
    save_params_npz(path, bundle.params)
    cfg = CLIPConfig(**TINY)
    model = CLIPModel(cfg)
    model.load_state_dict(flax_params_to_state_dict(load_params_npz(path)))
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    return bundle, model.eval(), cfg, x


@pytest.mark.parametrize("merge_blocks", ["auto", "off"])
def test_block_fused_encode_matches_jax(carried, merge_blocks):
    bundle, model, cfg, x = carried
    ref_pre, ref_post = jax_encode(bundle.params, jnp.asarray(x), bundle.config,
                                   project=True, dtype=jnp.float32,
                                   merge_blocks=merge_blocks, interpret=True)
    packed = fast_vit.pack_fastest(model, cfg, torch.float32)
    with torch.no_grad():
        pre, post = fast_vit.vit_encode_block_fused(
            packed, torch.from_numpy(x), cfg, project=True,
            merge_blocks=merge_blocks)
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post), atol=5e-4,
                               rtol=5e-4)


def test_encode_fastest_on_cpu_is_the_canonical_module(carried):
    _, model, cfg, x = carried
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fast = fast_vit.encode_image_fastest(model, xt, cfg, project=True)
        canon = model.encode_image(xt, project=True)
    for a, b in zip(fast, canon):
        assert torch.equal(a, b)


def test_pack_is_kernel_layout(carried):
    _, model, cfg, _ = carried
    packed = fast_vit.pack_fastest(model, cfg, torch.bfloat16)
    blk = packed["blocks"][1]
    src = model.visual.transformer.resblocks[1]
    assert blk["w_qkv"].dtype == torch.bfloat16 and blk["w_qkv"].is_contiguous()
    assert torch.equal(blk["w_qkv"], src.attn.in_proj_weight.detach().T.bfloat16())
    assert torch.equal(blk["w_fc"], src.mlp.c_fc.weight.detach().T.bfloat16())
    assert blk["b_fc"].dtype == torch.float32
    assert len(packed["blocks"]) == cfg.vision_layers


def test_plan_from_h100_facts():
    vitb = CLIP_ARCHS["ViT-B/16"]
    plan = fast_vit._fused_block_plan(vitb)
    assert plan["merge"] and plan["heads"] == 12 and plan["act"] == "quick_gelu"
    assert not fast_vit._fused_block_plan(vitb, "off")["merge"]
    # ViT-L's weights exceed the TPU's VMEM budget; nothing here splits
    vitl = fast_vit._fused_block_plan(CLIP_ARCHS["ViT-L/14@336px"])
    assert vitl["merge"] and not vitl["attn_split"] and not vitl["mlp_chunks"]
    gelu = dataclasses.replace(vitb, act="gelu")
    assert fast_vit._fused_block_plan(gelu)["act"] == "gelu_poly"


def test_unported_branches_raise(carried):
    """JAX's split branches, ported: K5 over head groups (``attn_split``)
    (one group of both heads, and two groups of one head) and K4 over
    hidden chunks (``mlp_chunks``), each against JAX's
    ``_apply_fused_blocks`` on the same plan at the fp32 block tolerance
    (2e-4; JAX pads S to 16 there, the port does not); the per-op MLP
    branch (``mlp_whole`` off, K16) runs and matches JAX's too."""
    bundle, model, cfg, x = carried
    packed = fast_vit.pack_fastest(model, cfg, torch.float32)
    plan = fast_vit._fused_block_plan(cfg)
    tokens = np.random.default_rng(1).standard_normal(
        (2, 17, cfg.vision_width)).astype(np.float32)
    jbase = jax_fast_vit._fused_block_plan(bundle.config, jnp.float32)
    assert plan["heads"] == 2
    for split in ({"attn_split": True, "n_groups": 1},
                  {"attn_split": True, "n_groups": 2},
                  {"mlp_whole": False, "mlp_chunks": 2}):
        ref = jax_fast_vit._apply_fused_blocks(
            bundle.params["visual"], jnp.asarray(tokens), bundle.config,
            jnp.float32, start=0, stop=2,
            plan={**jbase, "merge": False, **split}, interpret=True)
        with torch.no_grad():
            got = fast_vit._apply_fused_blocks(
                packed, torch.from_numpy(tokens),
                {**plan, "merge": False, **split}, start=0, stop=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                                   rtol=2e-4)
    jplan = {**jbase, "merge": False, "mlp_whole": False, "mlp_chunks": 0}
    ref = jax_fast_vit._apply_fused_blocks(
        bundle.params["visual"], jnp.asarray(tokens), bundle.config,
        jnp.float32, start=0, stop=2, plan=jplan, interpret=True)
    with torch.no_grad():
        got = fast_vit._apply_fused_blocks(
            packed, torch.from_numpy(tokens),
            {**plan, "merge": False, "mlp_whole": False}, start=0, stop=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_vit_encode_fast_matches_jax(carried, act):
    """The per-op encode (2 ln_matmul + 2 matmul_residual per block, plain
    attention) against JAX's ``vit_encode_fast`` at 5e-5/1e-4; a gelu tower
    differs from a quick_gelu one (``tests/test_fast_vit.py:387-410``)."""
    bundle, model, cfg, x = carried
    jcfg = dataclasses.replace(bundle.config, act=act)
    pcfg = dataclasses.replace(cfg, act=act)
    ref_pre, ref_post = jax_fast_vit.vit_encode_fast(
        bundle.params, jnp.asarray(x), jcfg, project=True, dtype=jnp.float32)
    packed = fast_vit.pack_fastest(model, pcfg, torch.float32)
    with torch.no_grad():
        pre, post = fast_vit.vit_encode_fast(packed, torch.from_numpy(x),
                                             pcfg, project=True)
        other = fast_vit.vit_encode_fast(
            packed, torch.from_numpy(x), dataclasses.replace(
                cfg, act="gelu" if act == "quick_gelu" else "quick_gelu"))
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post), atol=5e-5,
                               rtol=1e-4)
    assert (pre - other).abs().max().item() > 1e-4


def _gelu_configs():
    """The wide gelu tower of ``tests/test_fast_vit.py:444`` in both
    packages, and ViT-B/16 with exact gelu (open_clip's ViT-B-16 shape;
    the zoo maps that name onto the QuickGELU ViT-B/16, as JAX's does)."""
    wide = dict(embed_dim=512, image_resolution=224, vision_layers=32,
                vision_width=1280, vision_patch_size=14, context_length=77,
                vocab_size=49408, transformer_width=1024,
                transformer_heads=16, transformer_layers=24, act="gelu")
    vitb = dataclasses.asdict(dataclasses.replace(CLIP_ARCHS["ViT-B/16"],
                                                  act="gelu"))
    return [(CLIPConfig(**c), JaxConfig(**c)) for c in (wide, vitb)]


def test_gelu_plan_honours_the_opt_out(monkeypatch):
    """C2: ``AIHAB_NO_GELU_POLY``, read at each call, keeps exact gelu and
    turns the kernel MLP off, with JAX's plan's fields
    (``tests/test_fast_vit.py:438-470``)."""
    for cfg, jcfg in _gelu_configs():
        assert fast_vit._fused_block_plan(cfg)["act"] == "gelu_poly"
        assert fast_vit._fused_block_plan(cfg)["merge"]
        monkeypatch.setenv("AIHAB_NO_GELU_POLY", "1")
        plan = fast_vit._fused_block_plan(cfg)
        ref = jax_fast_vit._fused_block_plan(jcfg, jnp.bfloat16)
        for key in ("act", "merge", "mlp_whole", "mlp_chunks", "heads",
                    "width"):
            assert plan[key] == ref[key], key
        assert plan["act"] == "gelu" and not plan["mlp_whole"]
        monkeypatch.delenv("AIHAB_NO_GELU_POLY")
    qcfg = dataclasses.replace(_gelu_configs()[0][0], act="quick_gelu")
    monkeypatch.setenv("AIHAB_NO_GELU_POLY", "1")
    qplan = fast_vit._fused_block_plan(qcfg)
    assert qplan["act"] == "quick_gelu" and qplan["merge"]


def test_block_fused_encode_under_the_opt_out_matches_jax(carried,
                                                          monkeypatch):
    """A gelu tower under ``AIHAB_NO_GELU_POLY=1``: K2 + ``ln_matmul``
    (exact gelu, plain) + ``matmul_residual`` per block, against JAX's
    interpret-mode encode under the same variable; it differs from the
    gelu_poly encode by no more than the gelu_poly error."""
    bundle, model, cfg, x = carried
    jcfg = dataclasses.replace(bundle.config, act="gelu")
    pcfg = dataclasses.replace(cfg, act="gelu")
    packed = fast_vit.pack_fastest(model, pcfg, torch.float32)
    with torch.no_grad():
        poly = fast_vit.vit_encode_block_fused(packed, torch.from_numpy(x),
                                               pcfg)
    monkeypatch.setenv("AIHAB_NO_GELU_POLY", "1")
    ref = jax_encode(bundle.params, jnp.asarray(x), jcfg, dtype=jnp.float32,
                     interpret=True)
    with torch.no_grad():
        got = fast_vit.vit_encode_block_fused(packed, torch.from_numpy(x),
                                              pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=5e-4)
    assert 0 < (got - poly).abs().max().item() < 1e-3


def test_int8_act_honours_the_opt_out(monkeypatch):
    """C2 in the int8 route (``tests/test_fast_vit.py:493-505``): exact gelu
    under the opt-out is JAX's XLA route, which is not ported and raises."""
    cfg, jcfg = _gelu_configs()[1]
    assert qv._kernel_act(cfg) == jax_kernel_act(jcfg) == "gelu_poly"
    monkeypatch.setenv("AIHAB_NO_GELU_POLY", "1")
    assert qv._kernel_act(cfg) == jax_kernel_act(jcfg) == "gelu"
    with pytest.raises(NotImplementedError, match="xla"):
        qv.int8_block_plan(cfg)
    with pytest.raises(NotImplementedError, match="xla"):
        qv.vit_encode_int8({}, torch.zeros(1, 224, 224, 3), cfg)
    assert qv._kernel_act(dataclasses.replace(cfg, act="quick_gelu")) == \
        "quick_gelu"
