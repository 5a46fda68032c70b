"""The port's fused ViT encode against the JAX fused encode (Pallas in
interpret mode) on carried weights, on the merged and the two-kernel
paths, plus the dispatch plan and the weight pack."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aihab_clip_tpu.models import CLIPConfig as JaxConfig
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.models.fast_vit import \
    vit_encode_block_fused as jax_encode

from aihab_clip_tpu_torch.models import CLIP_ARCHS, CLIPConfig, CLIPModel
from aihab_clip_tpu_torch.models import fast_vit
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
    _, model, cfg, x = carried
    packed = fast_vit.pack_fastest(model, cfg, torch.float32)
    xt = torch.zeros(1, 5, cfg.vision_width)
    plan = fast_vit._fused_block_plan(cfg)
    for key, val, name in (("attn_split", True, "K5"),
                           ("mlp_whole", False, "K16")):
        with pytest.raises(NotImplementedError, match=name):
            fast_vit._apply_fused_blocks(packed, xt, {**plan, key: val},
                                         start=0, stop=1)
    with pytest.raises(NotImplementedError, match="K4"):
        fast_vit._apply_fused_blocks(
            packed, xt, {**plan, "mlp_whole": False, "mlp_chunks": 2},
            start=0, stop=1)
