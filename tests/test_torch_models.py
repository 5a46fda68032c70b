"""The port's CLIP model against the recorded torch goldens and against the
JAX ``CLIPModel`` on the same weights, carried over by the weight carry."""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aihab_clip_tpu.models import CLIPConfig as JaxConfig
from aihab_clip_tpu.models import CLIPModel as JaxModel
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models.convert import save_params_npz

from aihab_clip_tpu_torch.models import CLIPConfig, CLIPModel, load
from aihab_clip_tpu_torch.models.convert import (flax_params_to_state_dict,
                                                 load_params_npz)
from aihab_clip_tpu_torch.tokenizer import tokenize

GOLDEN = pathlib.Path(__file__).parent / "golden"
SMALL = dict(embed_dim=32, image_resolution=32, vision_layers=2,
             vision_width=128, vision_patch_size=8, context_length=77,
             vocab_size=49408, transformer_width=64, transformer_heads=2,
             transformer_layers=2)
PROMPTS = ["a habitat photo of Bog", "a habitat photo of Urban.",
           "a habitat photo of Sea, open marine water to the horizon"]


def _carried_model(params_npz, cfg):
    model = CLIPModel(cfg)
    model.load_state_dict(flax_params_to_state_dict(load_params_npz(params_npz)))
    return model.eval()


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN / "vit_golden.npz")
    cfg_d = json.loads(str(data["config"]))
    model = _carried_model(GOLDEN / "vit_params.npz", CLIPConfig(**cfg_d))
    return model, data


def test_golden_image_features(golden):
    model, data = golden
    images = torch.from_numpy(np.transpose(data["images"], (0, 2, 3, 1)).copy())
    with torch.no_grad():
        out = model.encode_image(images)
    np.testing.assert_allclose(out.numpy(), data["image_features"],
                               atol=5e-5, rtol=1e-4)


def test_golden_text_features(golden):
    model, data = golden
    with torch.no_grad():
        pre, post = model.encode_text(torch.from_numpy(data["tokens"]))
    np.testing.assert_allclose(pre.numpy(), data["text_pre"], atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(post.numpy(), data["text_post"], atol=5e-5,
                               rtol=1e-4)


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    cfg = JaxConfig(**SMALL)
    bundle = jax_load("random:torch-parity", random_cfg=cfg, seed=3)
    path = tmp_path_factory.mktemp("carry") / "params.npz"
    save_params_npz(path, bundle.params)
    return bundle, _carried_model(path, CLIPConfig(**SMALL))


def test_matches_jax_encode_image(jax_and_port):
    bundle, model = jax_and_port
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref_pre, ref_post = bundle.model.apply(
        {"params": bundle.params}, jnp.asarray(x),
        method=JaxModel.encode_image, project=True)
    with torch.no_grad():
        pre, post = model.encode_image(torch.from_numpy(x), project=True)
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post), atol=5e-5,
                               rtol=1e-4)


def test_matches_jax_encode_text(jax_and_port):
    bundle, model = jax_and_port
    tokens = tokenize(PROMPTS)
    ref_pre, ref_post = bundle.model.apply(
        {"params": bundle.params}, jnp.asarray(tokens),
        method=JaxModel.encode_text)
    with torch.no_grad():
        pre, post = model.encode_text(torch.from_numpy(tokens))
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post), atol=5e-5,
                               rtol=1e-4)


def test_state_dict_layout_is_carried_exactly(jax_and_port):
    bundle, model = jax_and_port
    sd = model.state_dict()
    blk = bundle.params["visual"]["transformer"]["resblocks_1"]
    np.testing.assert_array_equal(
        sd["visual.transformer.resblocks.1.attn.in_proj_weight"].numpy(),
        np.asarray(blk["attn"]["in_proj"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["visual.conv1.weight"].numpy(),
        np.asarray(bundle.params["visual"]["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["text.token_embedding.weight"].numpy(),
        np.asarray(bundle.params["text"]["token_embedding"]))


def test_random_load_is_seeded():
    a = load("random:Tiny", device="cpu", seed=1).model.state_dict()
    b = load("random:Tiny", device="cpu", seed=1).model.state_dict()
    c = load("random:Tiny", device="cpu", seed=2).model.state_dict()
    key = "visual.transformer.resblocks.0.mlp.c_fc.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    w = a[key]
    assert abs(w.std().item() - 64 ** -0.5) < 0.02   # 1/sqrt(fan_in)
    assert torch.equal(a["visual.ln_pre.weight"], torch.ones(64))
