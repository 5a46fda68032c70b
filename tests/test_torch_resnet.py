"""The ModifiedResNet CLIP towers of the port against the recorded torch
goldens and the JAX package on the same weights (``TinyRN`` sizes, numpy
draws, BatchNorm statistics randomized as in ``tests/test_fast_resnet.py``
so the fold does work): the canonical tower, the BatchNorm-folded encode
in fp32 and bf16, the OpenAI-layout converter and the shapes for every RN
row, the JAX-layout cache both ways, the zoo's ``random:`` rows, the
encode dispatch, and the bf16 engine and ``PredictServer`` against JAX's.
The training paths: ``tests/test_torch_resnet_train.py``."""

import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import aihab_clip_tpu.models.zoo as jax_zoo
from aihab_clip_tpu.models import CLIPModel as JaxCLIPModel
from aihab_clip_tpu.models import clip as jax_clip
from aihab_clip_tpu.models.convert import load_params_npz as jax_load_npz
from aihab_clip_tpu.models.convert import save_params_npz as jax_save_npz
from aihab_clip_tpu.models.convert import \
    torch_state_dict_to_params as jax_convert
from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine
from aihab_clip_tpu.serving import PredictServer as JaxServer

import aihab_clip_tpu_torch.models.zoo as zoo
import chip_smoke
from aihab_clip_tpu_torch.models import CLIP_ARCHS, CLIPConfig, CLIPModel
from aihab_clip_tpu_torch.models import fast_vit
from aihab_clip_tpu_torch.models.clip import config_from_state_dict_shapes
from aihab_clip_tpu_torch.models.convert import (flatten_params,
                                                 flax_params_to_state_dict,
                                                 load_params_npz,
                                                 save_params_npz,
                                                 state_dict_to_flax_params,
                                                 torch_state_dict_to_port)
from aihab_clip_tpu_torch.models.fast_resnet import (fold_resnet_bn,
                                                     resnet_encode_folded)
from aihab_clip_tpu_torch.serving import ClassifierEngine, PredictServer

GOLDEN = pathlib.Path(__file__).parent / "golden"
RN_ROWS = ["RN50", "RN101", "RN50x4", "RN50x16", "RN50x64", "TinyRN"]


def randomize_bn(params, seed):
    """A JAX RN parameter tree with every FrozenBatchNorm's statistics,
    scale and bias redrawn (numpy, ``seed``), as tests/test_fast_resnet.py
    draws them, and every other leaf moved by 0.02 N(0, 1)."""
    rng = np.random.default_rng(seed)
    flat = flatten_params(params)
    for key in sorted(flat):
        v, leaf = flat[key], key.rsplit("/", 1)[-1]
        bn = f"{key.rsplit('/', 1)[0]}/mean" in flat
        if leaf == "mean":
            flat[key] = (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
        elif leaf in ("var", "scale") and bn:
            flat[key] = (0.5 + rng.random(v.shape)).astype(np.float32)
        elif leaf == "bias" and bn:
            flat[key] = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        else:
            flat[key] = v + 0.02 * rng.standard_normal(v.shape).astype(
                np.float32)
    return traverse_util.unflatten_dict(flat, sep="/")


def port_model(params, config):
    model = CLIPModel(CLIPConfig(**dataclasses.asdict(config)))
    model.load_state_dict(flax_params_to_state_dict(params))
    return model.eval()


def tiny_rn_params(seed):
    """JAX's TinyRN tree: the port's ``random:TinyRN`` draw carried into
    JAX's layout, then ``randomize_bn`` (JAX's own random init runs its
    flax init eagerly, ~30 s on the CPU)."""
    sd = zoo.load("random:TinyRN", device="cpu", seed=seed).model.state_dict()
    return randomize_bn(traverse_util.unflatten_dict(
        state_dict_to_flax_params(sd), sep="/"), seed + 4)


@pytest.fixture(scope="module")
def tiny():
    """(JAX's TinyRN CLIPModel, its params with random BN statistics, the
    port's model on the same weights)."""
    cfg = jax_clip.CLIP_ARCHS["TinyRN"]
    params = tiny_rn_params(3)
    return JaxCLIPModel(cfg), params, port_model(params, cfg)


def _images(seed, n=3, res=32):
    return np.random.default_rng(seed).standard_normal(
        (n, res, res, 3)).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(0, 3))
def _jax_encode_jit(jmodel, params, x, project):
    return jmodel.apply({"params": params}, x,
                        method=JaxCLIPModel.encode_image, project=project)


def _jax_encode(jmodel, params, x, project):
    return _jax_encode_jit(jmodel, params, jnp.asarray(x), project)


# ---- the canonical tower ---------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN / "rn_golden.npz")
    cfg_d = json.loads(str(data["config"]))
    cfg_d["vision_layers"] = tuple(cfg_d["vision_layers"])
    model = CLIPModel(CLIPConfig(**cfg_d))
    model.load_state_dict(flax_params_to_state_dict(
        load_params_npz(GOLDEN / "rn_params.npz")))
    return model.eval(), data


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


@pytest.mark.parametrize("project", [False, True])
def test_tower_matches_jax(tiny, project):
    b, params, model = tiny
    x = _images(0)
    ref = _jax_encode(b, params, x, project)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(x), project=project)
    for g, r in zip(got if project else (got,), ref if project else (ref,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5,
                                   rtol=1e-4)


def test_tower_layout_and_frozen_statistics(tiny):
    """The names JAX's tree carries, a 256-wide pre-projection feature, BN
    statistics that never require a gradient, and channels-last
    activations through the stages."""
    _, params, model = tiny
    names = set(flax_params_to_state_dict(params))
    assert names == set(dict(model.named_parameters()))
    for name, p in model.named_parameters():
        assert p.requires_grad == (name.rsplit(".", 1)[-1]
                                   not in ("mean", "var")), name
    assert model.config.vision_preproj_dim == 256
    assert model.config.vision_heads == 4
    seen = []
    hook = model.visual.layer2_0.register_forward_hook(
        lambda m, i, o: seen.append(o.is_contiguous(
            memory_format=torch.channels_last)))
    with torch.no_grad():
        model.encode_image(torch.from_numpy(_images(1)))
    hook.remove()
    assert seen == [True]


# ---- the folded encode -----------------------------------------------------

def test_folded_matches_canonical(tiny):
    """fp32 fold against the canonical module at 2e-4 (JAX
    test_fast_resnet.py:58-60); the tree holds fp32 biases and
    channels-last kernels."""
    _, _, model = tiny
    x = torch.from_numpy(_images(2, n=2))
    folded = fold_resnet_bn(model, torch.float32)
    k = folded["layer2_0"]["downsample_conv"]
    assert k["bias"].dtype == torch.float32 and k["weight"].is_contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        ref_pre, ref_proj = model.encode_image(x, project=True)
        pre, proj = resnet_encode_folded(folded, x, model.config,
                                         project=True)
    np.testing.assert_allclose(pre.numpy(), ref_pre.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(proj.numpy(), ref_proj.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_folded_bf16_close(tiny):
    """The bf16 fold (kernels bf16, biases fp32) tracks the fp32 canonical
    tower within relative 0.08 and cosine 0.999 (JAX
    test_fast_resnet.py:79-83)."""
    _, _, model = tiny
    x = torch.from_numpy(_images(2, n=2))
    folded = fold_resnet_bn(model, torch.bfloat16)
    assert folded["conv1"]["weight"].dtype == torch.bfloat16
    assert folded["conv1"]["bias"].dtype == torch.float32
    with torch.no_grad():
        ref = model.encode_image(x).numpy()
        got = resnet_encode_folded(folded, x, model.config).float().numpy()
    assert (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max() < 0.08
    cos = (ref * got).sum(-1) / (np.linalg.norm(ref, axis=-1)
                                 * np.linalg.norm(got, axis=-1))
    assert cos.min() > 0.999


def test_encode_dispatch(tiny):
    """``pack_fastest`` builds the folded tree; ``encode_image_fastest``
    runs the canonical module on the CPU, as JAX's does off the TPU."""
    _, _, model = tiny
    packed = fast_vit.pack_fastest(model, model.config, torch.float32)
    assert set(packed) == {"folded_rn"}
    assert set(packed["folded_rn"]) == {
        "dtype", "conv1", "conv2", "conv3", "layer1_0", "layer2_0",
        "layer3_0", "layer4_0", "attnpool"}
    x = torch.from_numpy(_images(3))
    with torch.no_grad():
        got = fast_vit.encode_image_fastest(model, x, model.config,
                                            project=True, packed=packed)
        want = model.encode_image(x, project=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---- weights: the converter, the shapes, the cache --------------------------

# the (key, axis) pairs whose sizes carry a CLIPConfig
# (config_from_state_dict_shapes)
_CARRY = {("visual.layer1.0.conv1.weight", 0), ("text_projection", 1),
          ("visual.attnpool.positional_embedding", 0),
          ("positional_embedding", 0), ("token_embedding.weight", 0),
          ("ln_final.weight", 0), ("transformer.resblocks.0.mlp.c_fc.weight",
                                   0)}


def _keys_only_state_dict(cfg):
    """An OpenAI-layout state dict of ``cfg`` with every key of the
    published layout, each tensor of its rank but of size 1 on every axis
    that carries no config fact, filled with its own index."""
    with torch.device("meta"):
        meta = CLIPModel(cfg).state_dict()
    out = {}
    for i, (k, v) in enumerate(chip_smoke.openai_state_dict(meta).items()):
        if v.dtype == torch.int64:
            out[k] = v
            continue
        shape = tuple(d if (k, a) in _CARRY else 1
                      for a, d in enumerate(v.shape))
        out[k] = torch.full(shape, float(i))
    return out


@pytest.mark.parametrize("arch", RN_ROWS)
def test_rn_rows_convert_as_jax(arch):
    """Every RN row: the row equals JAX's (heads ``width * 32 // 64``); the
    config from the published layout's shapes equals the row and JAX's;
    the converter maps every key of that layout (num_batches_tracked
    dropped) to the port's module names, with the names and layouts JAX's
    converter gives."""
    cfg = CLIP_ARCHS[arch]
    jcfg = jax_clip.CLIP_ARCHS[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.vision_heads == cfg.vision_width * 32 // 64 == \
        jcfg.vision_heads
    sd = _keys_only_state_dict(cfg)
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    assert config_from_state_dict_shapes(shapes) == cfg
    assert dataclasses.asdict(jax_clip.config_from_state_dict_shapes(
        shapes)) == dataclasses.asdict(cfg)
    pcfg, port = torch_state_dict_to_port(sd)
    _, params = jax_convert({k: v.clone() for k, v in sd.items()})
    assert pcfg == cfg
    want = flax_params_to_state_dict(params)
    assert port.keys() == want.keys()
    assert all(torch.equal(port[k], want[k]) for k in want)
    with torch.device("meta"):
        assert set(port) == set(CLIPModel(cfg).state_dict())


@pytest.mark.parametrize("half", [False, True])
def test_openai_state_dict_converts_bit_for_bit(tiny, half):
    """TinyRN in OpenAI's layout (fp32, or fp16 with int64
    num_batches_tracked): the port's state dict equals
    ``flax_params_to_state_dict`` of JAX's converted tree bit for bit, and
    ``state_dict_to_flax_params`` gives JAX's tree back."""
    _, params, model = tiny
    sd = chip_smoke.openai_state_dict(model.state_dict())
    if half:
        sd = {k: v.half() if v.is_floating_point() else v
              for k, v in sd.items()}
    assert sum(k.endswith("num_batches_tracked") for k in sd) == 19
    cfg, port = torch_state_dict_to_port(sd)
    jcfg, jparams = jax_convert({k: v.clone() for k, v in sd.items()})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = flax_params_to_state_dict(jparams)
    assert port.keys() == want.keys()
    assert all(torch.equal(port[k], want[k]) for k in want)
    back, jflat = state_dict_to_flax_params(port), flatten_params(jparams)
    assert back.keys() == jflat.keys()
    assert all(np.array_equal(back[k], jflat[k]) for k in jflat)


@pytest.mark.parametrize("key,words", [
    ("visual.bn1.scale", "Unhandled stem bn key: visual.bn1.scale"),
    ("visual.layer1.0.bn2.foo", "Unhandled block bn key"),
    ("visual.layer1.0.downsample.2.weight", "Unhandled downsample key"),
    ("visual.layer1.0.downsample.1.bar", "Unhandled downsample bn key"),
    ("visual.layer1.0.relu.weight", "Unhandled block key"),
    ("visual.attnpool.extra", "Unhandled attnpool key"),
    ("visual.head.weight", "Unhandled ResNet visual key")])
def test_unknown_rn_keys_raise_as_jax(tiny, key, words):
    sd = chip_smoke.openai_state_dict(tiny[2].state_dict())
    sd[key] = torch.ones(2)
    with pytest.raises(KeyError, match=words):
        torch_state_dict_to_port(sd)
    with pytest.raises(KeyError, match=words):
        jax_convert(sd)


def test_cache_read_and_applied_by_jax(tiny, tmp_path):
    """The port's JAX-layout npz (``save_params_npz`` of
    ``state_dict_to_flax_params``) read by JAX's ``load_params_npz`` and
    applied by JAX's ``CLIPModel``: JAX's tree bit for bit and the port's
    features; JAX's npz read back by the port the same."""
    b, params, model = tiny
    path = tmp_path / "rn.npz"
    save_params_npz(path, state_dict_to_flax_params(model.state_dict()))
    jparams = jax_load_npz(path)
    got, want = flatten_params(jparams), flatten_params(params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    x = _images(4)
    pre, proj = _jax_encode(b, jparams, x, True)
    with torch.no_grad():
        mpre, mproj = model.encode_image(torch.from_numpy(x), project=True)
    np.testing.assert_allclose(np.asarray(pre), mpre.numpy(), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(proj), mproj.numpy(), atol=5e-5,
                               rtol=1e-4)
    jpath = tmp_path / "jax.npz"
    jax_save_npz(jpath, params)
    back = flax_params_to_state_dict(load_params_npz(jpath))
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_random_rows_load():
    """``random:TinyRN`` and ``random:RN50`` build working towers at JAX's
    BatchNorm init (scale 1, bias 0, mean 0, var 1); RN50's
    pre-projection feature is 2,048 wide."""
    tiny_b = zoo.load("random:TinyRN", device="cpu", seed=1)
    vis = tiny_b.model.visual
    assert tiny_b.source == "random" and tiny_b.config == CLIP_ARCHS["TinyRN"]
    for bn in (vis.bn1, vis.layer3_0.downsample_bn):
        assert bn.weight.eq(1).all() and bn.bias.eq(0).all()
        assert bn.mean.eq(0).all() and bn.var.eq(1).all()
    pos = vis.attnpool.positional_embedding
    assert 0.5 < pos.std().item() * 256 ** 0.5 < 1.5
    rn50 = zoo.load("random:RN50", device="cpu", seed=1)
    with torch.no_grad():
        pre, proj = rn50.model.encode_image(
            torch.from_numpy(_images(5, n=1, res=224)), project=True)
    assert pre.shape == (1, 2048) and proj.shape == (1, 1024)
    assert torch.isfinite(pre).all() and torch.isfinite(proj).all()


# ---- serving ---------------------------------------------------------------

ENGINE = "torch-rn-engine"


@pytest.fixture(scope="module")
def engines(tiny, tmp_path_factory):
    """JAX's CPU engine and the port's on the tiny weights, which the JAX
    package writes to its converted cache."""
    jmodel, params, _ = tiny
    root = tmp_path_factory.mktemp("rn_cache")
    npz = jax_zoo._npz_cache_path(ENGINE, root)
    npz.parent.mkdir(parents=True)
    jax_save_npz(npz, params)
    jax_zoo._save_config(jax_zoo._config_cache_path(ENGINE, root),
                         jmodel.config)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_zoo, "default_cache_root", lambda: root)
    mp.setattr(zoo, "default_cache_root", lambda: root)
    try:
        yield (JaxEngine(model=ENGINE, batch_size=4, flat=True,
                         verbose=False),
               ClassifierEngine(model=ENGINE, batch_size=4, flat=True,
                                verbose=False, device="cpu"))
        with pytest.raises(ValueError, match="requires a ViT/SigLIP/ConvNeXt"):
            JaxEngine(model=ENGINE, quantize="int8", verbose=False)
        with pytest.raises(ValueError, match="requires a ViT/SigLIP/ConvNeXt"):
            ClassifierEngine(model=ENGINE, quantize="int8", verbose=False,
                             device="cpu")
    finally:
        mp.undo()


def test_engine_matches_jax(engines):
    """The engine (the fp32 canonical tower on the CPU) against JAX's on
    the same uint8 batch, each its own preprocessing: the same top-1 and
    probabilities within 1e-4."""
    ref, port = engines
    imgs = np.random.default_rng(33).integers(0, 256, (6, 224, 224, 3),
                                              dtype=np.uint8)
    want = np.concatenate([ref.classify_batch(imgs[:4]),
                           ref.classify_batch(imgs[4:])])
    got = np.concatenate([port.classify_batch(imgs[:4]),
                          port.classify_batch(imgs[4:])])
    assert got.shape == (6, 20)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_server_answers_as_jax(engines):
    """JAX's ``PredictServer`` and the port's over the two engines: a raw
    JPEG and a binary batch, the same top-k labels and probabilities
    within 1e-4."""
    from test_torch_serving import (_encode, _photo, _request,
                                    _same_predictions)

    from aihab_clip_tpu_torch.serving import encode_binary_batch

    ref, port = engines
    servers = (JaxServer(ref, port=0, max_wait_ms=20.0, verbose=False),
               PredictServer(port, port=0, max_wait_ms=20.0, verbose=False))
    for srv in servers:
        srv.serve_background()
    try:
        photo = _encode(_photo(300, 400, 4))
        for req in (("POST", "/predict", photo, "image/jpeg"),
                    ("POST", "/predict", encode_binary_batch(
                        [photo, _encode(_photo(224, 224, 5))]),
                     "application/x-aihab-batch")):
            (cj, pj), (cp, pp) = (_request(s.server_port, *req)
                                  for s in servers)
            assert cj == cp == 200
            _same_predictions(pp["predictions"], pj["predictions"])
    finally:
        for srv in servers:
            srv.stop()
