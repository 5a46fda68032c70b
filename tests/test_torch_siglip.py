"""The port's SigLIP against the JAX package on the same weights, carried
over by the weight carry: the config registry and tag grid, the zoo's name
resolution, the canonical towers, the fast encode through the K5/K4 plain
versions (JAX: Pallas in interpret mode), the pack, and the classifier
engine."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aihab_clip_tpu.models.zoo as jax_zoo
from aihab_clip_tpu.models import fast_siglip as jax_fast
from aihab_clip_tpu.models import siglip as jax_siglip
from aihab_clip_tpu.ops.preprocess import \
    normalize_stats_for as jax_normalize_stats_for
from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine

import aihab_clip_tpu_torch.models.zoo as zoo
from aihab_clip_tpu_torch.models import fast_siglip, fast_vit, siglip
from aihab_clip_tpu_torch.models.convert import flax_params_to_state_dict
from aihab_clip_tpu_torch.ops.preprocess import normalize_stats_for
from aihab_clip_tpu_torch.serving import ClassifierEngine
from aihab_clip_tpu_torch.tokenizer import tokenize

# SigLIP-Tiny (head_dim 32) and a head_dim-72 tower whose hidden width is
# no multiple of 128 (SO400M's head width at a test size)
HEAD72 = dict(embed_dim=144, image_resolution=48, patch_size=8,
              vision_width=144, vision_layers=2, vision_heads=2,
              vision_mlp_dim=344, context_length=16, vocab_size=49408,
              text_width=144, text_layers=2, text_heads=2, text_mlp_dim=344)
CONFIGS = {"SigLIP-Tiny": dataclasses.asdict(
    jax_siglip.SIGLIP_ARCHS["SigLIP-Tiny"]), "head72": HEAD72}
PROMPTS = ["a habitat photo of Bog", "a habitat photo of Urban.",
           "a habitat photo of Sea, open marine water to the horizon"]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def carried(request):
    """(JAX model, JAX params, port model, config dict, images): JAX init
    plus seeded noise, so no bias is zero and no LN scale is one."""
    cfg_d = CONFIGS[request.param]
    jcfg = jax_siglip.SigLIPConfig(**cfg_d)
    jmodel = jax_siglip.SigLIPModel(jcfg)
    res = jcfg.image_resolution
    params = jmodel.init(jax.random.key(7), jnp.zeros((1, res, res, 3)),
                         jnp.zeros((1, jcfg.context_length), jnp.int32))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params["params"])
    model = siglip.SigLIPModel(siglip.SigLIPConfig(**cfg_d))
    model.load_state_dict(flax_params_to_state_dict(params))
    images = rng.standard_normal((3, res, res, 3)).astype(np.float32)
    return jmodel, params, model.eval(), cfg_d, images


def test_encode_image_matches_jax(carried):
    jmodel, params, model, _, images = carried
    ref_pre, ref_post = jmodel.apply({"params": params}, jnp.asarray(images),
                                     method=type(jmodel).encode_image,
                                     project=True)
    with torch.no_grad():
        pre, post = model.encode_image(torch.from_numpy(images), project=True)
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post), atol=5e-5,
                               rtol=1e-4)


def test_encode_text_matches_jax(carried):
    jmodel, params, model, cfg_d, _ = carried
    tokens = tokenize(PROMPTS, context_length=cfg_d["context_length"],
                      truncate=True)
    ref_pre, ref_post = jmodel.apply({"params": params}, jnp.asarray(tokens),
                                     method=type(jmodel).encode_text)
    with torch.no_grad():
        pre, post = model.encode_text(torch.from_numpy(tokens))
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(post.numpy(), np.asarray(ref_post), atol=5e-5,
                               rtol=1e-4)


def test_pairwise_logits_match_jax(carried):
    jmodel, params, model, cfg_d, images = carried
    tokens = tokenize(PROMPTS, context_length=cfg_d["context_length"],
                      truncate=True)
    ref = jmodel.apply({"params": params}, jnp.asarray(images),
                       jnp.asarray(tokens))
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(tokens))
    assert out.shape == (3, len(PROMPTS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=1e-4)


def test_state_dict_is_carried_exactly(carried):
    _, params, model, _, _ = carried
    sd = model.state_dict()
    blk = params["visual"]["transformer"]["resblocks_1"]
    np.testing.assert_array_equal(
        sd["visual.transformer.resblocks.1.attn.k_proj.weight"].numpy(),
        np.asarray(blk["attn"]["k_proj"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["visual.attnpool.probe"].numpy(),
        np.asarray(params["visual"]["attnpool"]["probe"]))
    np.testing.assert_array_equal(
        sd["visual.conv1.weight"].numpy(),
        np.asarray(params["visual"]["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["text.head.weight"].numpy(),
                                  np.asarray(params["text"]["head"]["kernel"]).T)
    assert sd["logit_bias"].item() == pytest.approx(
        float(params["logit_bias"]))


def test_fast_encode_matches_jax(carried):
    """The fast path (K5 -> K4 per block, plain versions on the CPU)
    against the JAX fast path with the Pallas kernels in interpret mode."""
    _, params, model, cfg_d, images = carried
    jcfg = jax_siglip.SigLIPConfig(**cfg_d)
    ref = jax_fast.siglip_encode_fast(params, jnp.asarray(images), jcfg,
                                      dtype=jnp.float32, interpret=True)
    cfg = siglip.SigLIPConfig(**cfg_d)
    packed = fast_vit.pack_fastest(model, cfg, torch.float32)
    with torch.no_grad():
        pre, post = fast_siglip.siglip_encode_fast(
            model, torch.from_numpy(images), cfg, project=True, packed=packed)
    assert torch.equal(pre, post)
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref), atol=5e-4,
                               rtol=5e-4)


def test_pack_matches_jax(carried):
    _, params, model, cfg_d, _ = carried
    jcfg = jax_siglip.SigLIPConfig(**cfg_d)
    ref = jax_fast.pack_siglip_fast_params(params, jcfg, jnp.float32)
    packed = fast_siglip.pack_siglip_fast_params(
        model, siglip.SigLIPConfig(**cfg_d), torch.float32)
    w = cfg_d["vision_width"]
    for i, blk in enumerate(packed["blocks"]):
        rb = ref[f"resblocks_{i}"]
        assert packed["n_groups"] == rb["wqkv_g"].shape[0]
        np.testing.assert_array_equal(
            blk["wqkv_g"].numpy(),
            np.asarray(rb["wqkv_g"]).transpose(1, 0, 2).reshape(w, -1))
        np.testing.assert_array_equal(blk["b_qkv_g"].numpy(),
                                      np.asarray(rb["b_qkv_g"]))
        np.testing.assert_array_equal(blk["wout_g"].numpy(),
                                      np.asarray(rb["wout_g"]))


def test_encode_fastest_on_cpu_is_the_canonical_module(carried):
    _, _, model, cfg_d, images = carried
    cfg = siglip.SigLIPConfig(**cfg_d)
    x = torch.from_numpy(images)
    with torch.no_grad():
        fast = fast_vit.encode_image_fastest(model, x, cfg, project=True)
        canon = model.encode_image(x, project=True)
    for a, b in zip(fast, canon):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(jax_siglip.SIGLIP_ARCHS))
def test_registry_matches_jax(name):
    assert dataclasses.asdict(siglip.SIGLIP_ARCHS[name]) == \
        dataclasses.asdict(jax_siglip.SIGLIP_ARCHS[name])


TAGS = [f"ViT-{size}-{patch}-SigLIP{two}{res}"
        for size in ("B", "L", "SO400M") for patch in (14, 16)
        for two in ("", "2") for res in ("", "-224", "-256", "-378", "-384",
                                         "-512")] + ["ViT-H-14-SigLIP",
                                                     "ViT-B/16"]


def test_config_for_name_matches_jax_across_the_tag_grid():
    for tag in TAGS:
        mine = siglip.siglip_config_for_name(tag)
        ref = jax_siglip.siglip_config_for_name(tag)
        assert (mine is None) == (ref is None), tag
        if ref is not None:
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), tag


@pytest.mark.parametrize("name", [
    "random:ViT-SO400M-16-SigLIP2-384", "hf-hub:timm/ViT-SO400M-16-SigLIP2-384",
    "random:SigLIP-Tiny", "ViT-L-16-SigLIP-384", "hf-hub:timm/ViT-B-16-SigLIP",
    "hf-hub:google/siglip-gopt-16-256", "ViT-B/16"])
def test_arch_resolution_matches_jax(name):
    """Name -> (arch, config), without building a model."""
    arch, cfg = zoo._siglip_arch_for(name)
    ref_arch, ref_cfg = jax_zoo._siglip_arch_for(name)
    assert arch == ref_arch
    assert (cfg is None) == (ref_cfg is None)
    if ref_cfg is not None:
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert zoo.is_siglip_name(name) == (ref_cfg is not None)


def test_so400m_resolves_to_the_full_width_config():
    _, cfg = zoo._siglip_arch_for("random:ViT-SO400M-16-SigLIP2-384")
    assert (cfg.vision_width, cfg.vision_layers, cfg.vision_heads,
            cfg.vision_mlp_dim, cfg.image_resolution, cfg.patch_size) == \
        (1152, 27, 16, 4304, 384, 16)
    assert cfg.vision_width // cfg.vision_heads == 72
    assert fast_siglip.siglip_attn_groups(cfg) == 8
    assert fast_siglip._siglip_mlp_chunks(cfg, torch.bfloat16) == 2


@pytest.mark.parametrize("name", ["ViT-SO400M-16-SigLIP2-384",
                                  "ViT-B-16-SigLIP-224", "SigLIP-Tiny"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grouping_and_chunks_match_jax(name, dtype, monkeypatch):
    monkeypatch.delenv("AIHAB_SIGLIP_HPG", raising=False)
    cfg = siglip.SIGLIP_ARCHS[name]
    jcfg = jax_siglip.SIGLIP_ARCHS[name]
    assert fast_siglip.siglip_attn_groups(cfg) == \
        jax_fast.siglip_attn_groups(jcfg)
    assert fast_siglip._siglip_mlp_chunks(cfg, getattr(torch, dtype)) == \
        jax_fast._siglip_mlp_chunks(jcfg, getattr(jnp, dtype))


def test_snapshot_names_raise_assets_missing():
    name = "hf-hub:timm/ViT-SO400M-16-SigLIP2-384"
    with pytest.raises(zoo.SigLIPAssetsMissingError, match="random:"):
        zoo.load(name, device="cpu")
    with pytest.raises(zoo.SigLIPAssetsMissingError):
        ClassifierEngine(model=name, device="cpu", verbose=False)


def test_siglip_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.load("random:SigLIP-Tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClassifierEngine(model="random:SigLIP-Tiny", verbose=False)


def test_normalize_stats_for_siglip():
    cfg = siglip.SIGLIP_ARCHS["ViT-SO400M-16-SigLIP2-384"]
    assert normalize_stats_for(cfg) == ((0.5,) * 3, (0.5,) * 3)
    assert normalize_stats_for(cfg) == jax_normalize_stats_for(
        jax_siglip.SIGLIP_ARCHS["ViT-SO400M-16-SigLIP2-384"])


def test_random_siglip_load_is_seeded():
    a = zoo.load("random:SigLIP-Tiny", device="cpu", seed=1)
    b = zoo.load("random:SigLIP-Tiny", device="cpu", seed=1)
    c = zoo.load("random:SigLIP-Tiny", device="cpu", seed=2)
    assert isinstance(a.model, siglip.SigLIPModel) and a.source == "random"
    key = "visual.transformer.resblocks.0.mlp.c_fc.weight"
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert torch.equal(sa[key], sb[key]) and not torch.equal(sa[key], sc[key])
    assert abs(sa[key].std().item() - 64 ** -0.5) < 0.02   # 1/sqrt(fan_in)
    assert torch.equal(sa["visual.ln_post.weight"], torch.ones(64))
    assert torch.equal(sa["visual.conv1.bias"], torch.zeros(64))
    assert sa["logit_scale"].item() == 1.0


@pytest.fixture(scope="module")
def engines():
    """The JAX engine on random:SigLIP-Tiny and the port's engine on the
    same weights: the port's random init is replaced by the carry."""
    ref = JaxEngine(model="random:SigLIP-Tiny", batch_size=4, flat=True,
                    verbose=False)
    sd = flax_params_to_state_dict(ref.bundle.params)
    mp = pytest.MonkeyPatch()
    mp.setattr(zoo, "init_siglip_random_",
               lambda model, generator: model.load_state_dict(sd))
    try:
        port = ClassifierEngine(model="random:SigLIP-Tiny", batch_size=4,
                                flat=True, verbose=False, device="cpu")
    finally:
        mp.undo()
    return ref, port


def test_engine_matches_jax(engines):
    ref, port = engines
    assert isinstance(port.bundle.config, siglip.SigLIPConfig)
    assert (port.decode_dim, port.bucket_sizes) == (ref.decode_dim,
                                                    ref.bucket_sizes)
    np.testing.assert_allclose(port._text_weights.numpy(),
                               np.asarray(ref._text_weights), atol=1e-5)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3),
                                             dtype=np.uint8)
    want = ref.classify_batch(imgs)
    got = port.classify_batch(imgs)
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_engine_decodes_at_least_224():
    cfg = siglip.SIGLIP_ARCHS["ViT-SO400M-16-SigLIP2-384"]
    assert max(cfg.image_resolution, 224) == 384
    tiny = ClassifierEngine(model="random:SigLIP-Tiny", batch_size=2,
                            flat=True, verbose=False, device="cpu")
    assert tiny.decode_dim == 224 and tiny.resolution == 32
    assert tiny.bundle.tokenize_fn is None
