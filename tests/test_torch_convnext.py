"""The ConvNeXt-CLIP slice of the port against the JAX package on the same
weights: the weight carry (4-D conv kernels, layer scales, the npz cache the
JAX package writes); the tower on ``TinyConvNeXt`` and on a small ``mlp``
head tower; the plain versions of K7 ``convnext_mlp_block`` and K15
``quant_convnext_mlp_block`` against the Pallas kernels in interpret mode;
the gelu_poly forms; ``quantize_convnext_mlp`` bit for bit; the fused and
int8 encodes; the PEFT hybrid encode with its gradients, the lock groups,
one train loss; and the bf16 and int8 engines.  JAX initialises every layer
scale gamma to 1e-6, which makes each block an identity to within rounding,
so every tower here has its gammas redrawn, the same numpy draw on both
sides.  The CUDA kernels against their plain versions on a card:
``tests/test_torch_cuda.py``."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import aihab_clip_tpu.models.zoo as jax_zoo
from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
from aihab_clip_tpu.models import CLIPModel as JaxCLIPModel
from aihab_clip_tpu.models import fast_convnext as jax_fc
from aihab_clip_tpu.models import fast_vit as jax_fast_vit
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.ops import block_kernel as jax_bk
from aihab_clip_tpu.ops import quant as jax_quant
from aihab_clip_tpu.ops import quant_matmul as jax_qm
from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine
from aihab_clip_tpu.train import peft as jax_peft

import aihab_clip_tpu_torch.models.zoo as zoo
from aihab_clip_tpu_torch.models import CLIP_ARCHS, CLIPConfig, CLIPModel
from aihab_clip_tpu_torch.models import fast_convnext as fc
from aihab_clip_tpu_torch.models.convert import _convert_key, flatten_params
from aihab_clip_tpu_torch.models.convnext import (convnext_config_for_name,
                                                  convnext_config_from_shapes)
from aihab_clip_tpu_torch.ops import block_kernel as bk
from aihab_clip_tpu_torch.ops import quant_matmul as qm
from aihab_clip_tpu_torch.serving import ClassifierEngine
from aihab_clip_tpu_torch.train import peft

from test_torch_peft import _head, _noisy, _port_model

TINY = dataclasses.asdict(CLIP_ARCHS["TinyConvNeXt"])
# the mlp head (the _d variants) at depths (2, 2, 3, 2)
MLP = dict(TINY, vision_layers=(2, 2, 3, 2), vision_proj="mlp")
# the tower gates of tests/test_torch_quant_vit.py: per-image cosine and
# max|d| over max|ref|
GATES = {"float32": (0.9999, 5e-3), "bfloat16": (0.9999, 2 ** -6)}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread, so the CPU's fp32 sums (and the int8 codes
    rounded from them) do not depend on the machine's core count; JAX's
    default gelu_poly form."""
    monkeypatch.delenv("AIHAB_ERF_IMPL", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return n


def _redraw_gamma(params, seed, scale=0.3):
    """Every ``gamma`` leaf drawn anew from a numpy seed (N(0, scale))."""
    n = _rng(seed)
    flat = traverse_util.flatten_dict(params)
    for key in sorted(flat):
        if key[-1] == "gamma":
            flat[key] = n(*np.shape(flat[key]), scale=scale)
    return traverse_util.unflatten_dict(flat)


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    model = JaxCLIPModel(jcfg)
    return model, jax.jit(model.init)


def _jax_params(jcfg, seed):
    """The JAX model of ``jcfg`` and its initial parameters (one jitted
    ``init`` per config: op by op it takes seconds more)."""
    model, init = _jax_init(jcfg)
    params = init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)),
                  jnp.zeros((1, 77), jnp.int32))["params"]
    return model, params


def _tower(cfg_dict, seed):
    """(JAX config, a JAX bundle, noisy params with redrawn gammas, the port
    model on them)."""
    jcfg = JaxCLIPConfig(**cfg_dict)
    model, params = _jax_params(jcfg, seed)
    params = _redraw_gamma(_noisy(params, seed + 1), seed + 2)
    b = SimpleNamespace(model=model, config=jcfg)
    return jcfg, b, params, _port_model(params, CLIPConfig(**cfg_dict))


@pytest.fixture(scope="module")
def tiny():
    return _tower(TINY, 3)


@pytest.fixture(scope="module")
def mlp_tower():
    return _tower(MLP, 5)


def _images(seed, n=2):
    return _rng(seed)(n, 32, 32, 3)


def _jax_encode(b, params, x, **kw):
    return b.model.apply({"params": params}, jnp.asarray(x),
                         method=type(b.model).encode_image, **kw)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


def _close_tower(got, ref, dtype="float32"):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    cos_min, max_rel = GATES[dtype]
    assert _cos(got, ref).min() >= cos_min
    assert np.abs(got - ref).max() <= max_rel * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the carry, the tower, the zoo
# ---------------------------------------------------------------------------


def test_carry_keeps_conv_kernel_axes():
    """Every 4-D flax kernel is HWIO -> OIHW: an asymmetric stem kernel, a
    downsample kernel and a depthwise kernel land with H and W in place."""
    for key, shape in (("visual/stem_conv/kernel", (4, 4, 3, 16)),
                       ("visual/down_conv_1/kernel", (2, 2, 16, 32)),
                       ("visual/stage0_block0/dwconv/kernel", (7, 7, 1, 16))):
        k = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        name, w = _convert_key(key, k)
        assert name == key.replace("/", ".").replace("kernel", "weight")
        assert w.shape == (shape[3], shape[2], shape[0], shape[1])
        np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))
        assert not np.array_equal(w, k.transpose(3, 2, 1, 0))
    assert _convert_key("visual/stage0_block0/gamma", np.ones(3))[0] == \
        "visual.stage0_block0.gamma"
    assert _convert_key("visual/head_norm/scale", np.ones(3))[0] == \
        "visual.head_norm.weight"


def test_stem_matches_jax(tiny):
    """The stem conv on an asymmetric kernel (seeded noise) against JAX's
    NHWC/HWIO conv: a swap of H and W would move every output."""
    _, _, params, model = tiny
    x = _images(20)
    ref = jax_fc._stem(params["visual"], jnp.asarray(x))
    with torch.no_grad():
        got = model.visual.stem(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("which", ["tiny", "mlp_tower"])
def test_tower_matches_jax(which, request):
    """``CLIPModel.encode_image`` against JAX's ``ConvNeXtVisionTower`` at the
    goldens' 5e-5/1e-4, pre-projection and projected."""
    _, b, params, model = request.getfixturevalue(which)
    x = _images(21, 3)
    ref_pre, ref_proj = _jax_encode(b, params, x, project=True)
    with torch.no_grad():
        pre, proj = model.encode_image(torch.from_numpy(x), project=True)
    assert pre.shape == (3, model.config.vision_preproj_dim)
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(proj.numpy(), np.asarray(ref_proj), atol=5e-5,
                               rtol=1e-4)


def test_zoo_loads_the_jax_npz_cache(tiny, tmp_path):
    """A ConvNeXt tree the JAX package wrote to its converted cache loads in
    the port's zoo and encodes as JAX does."""
    jcfg, b, params, _ = tiny
    name = "laion/CLIP-convnext_base_w-cache-test"
    npz = jax_zoo._npz_cache_path(name, tmp_path)
    npz.parent.mkdir(parents=True)
    save_params_npz(npz, params)
    jax_zoo._save_config(jax_zoo._config_cache_path(name, tmp_path), jcfg)
    bundle = zoo.load(name, device="cpu", cache_dir=str(tmp_path))
    assert bundle.source == "npz-cache"
    assert bundle.config == CLIPConfig(**TINY)
    x = _images(21, 3)
    with torch.no_grad():
        _, proj = bundle.model.encode_image(torch.from_numpy(x), project=True)
    np.testing.assert_allclose(proj.numpy(),
                               np.asarray(_jax_encode(b, params, x,
                                                      project=True)[1]),
                               atol=5e-5, rtol=1e-4)


def test_grid_and_random_load():
    """The tag grid parses as JAX's, ``random:convnext_*`` resolves, and a
    random tower's layer scales are drawn at ``CONVNEXT_GAMMA_STD``."""
    from aihab_clip_tpu.models.convnext import \
        convnext_config_for_name as jax_for_name

    for tag in ("convnext_base_w", "laion/CLIP-convnext_large_d_320.x",
                "convnext_xxlarge", "ViT-B/16"):
        ref = jax_for_name(tag)
        got = convnext_config_for_name(tag)
        assert (got is None if ref is None else
                dataclasses.asdict(got) == dataclasses.asdict(ref))
    with pytest.raises(ValueError, match="Unrecognized ConvNeXt"):
        convnext_config_for_name("convnext_tiny_z")
    base_w = CLIP_ARCHS["convnext_base_w"]
    assert (base_w.vision_layers, base_w.vision_width, base_w.embed_dim,
            base_w.image_resolution, base_w.vision_preproj_dim) == \
        ((3, 3, 27, 3), 128, 640, 256, 1024)
    bundle = zoo.load("random:TinyConvNeXt", device="cpu", seed=1)
    gammas = torch.cat([p.flatten() for n, p in
                        bundle.model.named_parameters()
                        if n.endswith(".gamma")])
    assert 0.05 < gammas.std().item() < 0.2
    assert bundle.model.visual.stem_norm.weight.eq(1).all()
    # vision_tower "rn" selects the ModifiedResNet
    rn = CLIPModel(dataclasses.replace(
        CLIP_ARCHS["TinyConvNeXt"], vision_tower="rn", act="quick_gelu"))
    assert type(rn.visual).__name__ == "ModifiedResNet"
    assert rn.visual.attnpool.c_proj.weight.shape == (32, 16 * 32)


def test_config_from_shapes():
    shapes = {"visual.trunk.stem.0.weight": (128, 3, 4, 4),
              "visual.head.proj.weight": (640, 1024),
              "ln_final.weight": (640,), "token_embedding.weight": (49408,
                                                                    640)}
    for s, depth in enumerate((3, 3, 27, 3)):
        for i in range(depth):
            shapes[f"visual.trunk.stages.{s}.blocks.{i}.gamma"] = (1,)
    for i in range(12):
        shapes[f"transformer.resblocks.{i}.ln_1.weight"] = (640,)
    assert convnext_config_from_shapes(shapes) == CLIP_ARCHS["convnext_base_w"]


# ---------------------------------------------------------------------------
# the gelu_poly forms, K7 and K15
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["sig5", "sig", "rational", "cheb"])
def test_gelu_forms_match_jax(impl, monkeypatch):
    """Each ``AIHAB_ERF_IMPL`` form of gelu_poly against JAX's ``_act_f32``
    under the same setting, and the kernels' code of that form."""
    monkeypatch.setenv("AIHAB_ERF_IMPL", impl)
    h = np.linspace(-30, 30, 8001, dtype=np.float32)
    ref = np.asarray(jax_bk._act_f32(jnp.asarray(h), "gelu_poly"))
    got = bk.act_f32(torch.from_numpy(h), "gelu_poly").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    assert bk.act_code("gelu_poly") == bk.GELU_FORMS[impl]
    assert bk.act_code("gelu_tanh") == bk.ACTS["gelu_tanh"]


def test_gelu_form_is_validated(monkeypatch):
    monkeypatch.setenv("AIHAB_ERF_IMPL", "erf")
    with pytest.raises(ValueError, match="AIHAB_ERF_IMPL"):
        jax_bk._act_f32(jnp.zeros(2), "gelu_poly")
    with pytest.raises(ValueError, match="AIHAB_ERF_IMPL"):
        bk.act_f32(torch.zeros(2), "gelu_poly")


def _mlp_args(seed, m, c=128):
    """y, res, LN, w1, b1, w2, b2, gamma of a ConvNeXt block (fp32)."""
    n = _rng(seed)
    return [n(m, c, scale=2.0), n(m, c), 1 + n(c, scale=0.1), n(c, scale=0.1),
            n(c, 4 * c, scale=c ** -0.5), n(4 * c, scale=0.1),
            n(4 * c, c, scale=(4 * c) ** -0.5), n(c, scale=0.1),
            n(c, scale=0.3)]


def _close_kernel(got, ref, dtype, fp32_tol):
    """fp32 within ``fp32_tol``; bf16 within 2 bf16 ulps of max|ref|."""
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    tol = fp32_tol if dtype == "float32" else 2 * 2 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks", [1, 2])
@pytest.mark.parametrize("m", [96, 200])
def test_convnext_mlp_block_plain_matches_pallas(m, n_chunks, dtype):
    """K7 over M rows (no multiple of 128 at 200), y and the residual apart,
    the hidden dim in one or two chunks, weights in y's dtype."""
    args = _mlp_args(1, m)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cast = {0, 1, 4, 6}          # y, res, w1, w2 in y's dtype
    jargs = [jnp.asarray(a, jdt if i in cast else jnp.float32)
             for i, a in enumerate(args)]
    targs = [torch.from_numpy(a).to(tdt if i in cast else torch.float32)
             for i, a in enumerate(args)]
    ref = jax_bk.convnext_mlp_block(*jargs, n_chunks=n_chunks, interpret=True)
    bk.reset_launch_counts()
    out = bk.convnext_mlp_block(*targs, n_chunks=n_chunks, tile_m=64)
    assert out.dtype == tdt and out.shape == (m, 128)
    assert bk.launch_counts()["convnext_mlp_block"] == 0
    _close_kernel(out, np.asarray(ref, np.float32), dtype, 2e-4)


def test_convnext_mlp_block_argument_checks():
    targs = [torch.from_numpy(a) for a in _mlp_args(2, 8)]
    with pytest.raises(ValueError, match="does not divide"):
        bk.convnext_mlp_block(*targs, n_chunks=3)
    with pytest.raises(ValueError, match="activation"):
        bk.convnext_mlp_block(*targs, act="none")
    auto = bk.convnext_mlp_block(*targs)
    torch.testing.assert_close(auto, bk.convnext_mlp_block_plain(
        *targs, n_chunks=1), rtol=0, atol=0)


def _quant_args(seed, m, c=128):
    """K15's operands: y, res, LN, int8 fc1 (w8, scale), b1, int8 fc2, b2,
    gamma (JAX's quantization of fp32 draws)."""
    y, res, ln_s, ln_b, w1, b1, w2, b2, gamma = _mlp_args(seed, m, c)
    w1_8, s1 = (np.asarray(t) for t in jax_quant.quantize_weight(w1))
    w2_8, s2 = (np.asarray(t) for t in jax_quant.quantize_weight(w2))
    return [y, res, ln_s, ln_b, w1_8, s1, b1, w2_8, s2, b2, gamma]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [96, 200])
def test_quant_convnext_mlp_block_plain_matches_pallas(m, dtype):
    """K15: LN eps 1e-6 on y, the hidden row requantized whole, res + (part +
    b2) * gamma; fp32 within 1e-5 (the int8 codes equal), bf16 within 2 bf16
    ulps of max|ref|."""
    args = _quant_args(3, m)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_qm.quant_convnext_mlp_block(
        jnp.asarray(args[0], jdt), jnp.asarray(args[1], jdt),
        *(jnp.asarray(a) for a in args[2:]), interpret=True)
    out = qm.quant_convnext_mlp_block(
        torch.from_numpy(args[0]).to(tdt), torch.from_numpy(args[1]).to(tdt),
        *(torch.from_numpy(a) for a in args[2:]), tile_m=64)
    assert out.dtype == tdt and out.shape == (m, 128)
    _close_kernel(out, np.asarray(ref, np.float32), dtype, 1e-5)


def test_gamma_epilogues_sum_in_order():
    """The gamma epilogues: ``gemm_residual`` res + (a @ w + b) * gamma, and
    ``int8_gemm`` (groups 1) the same on the dequantized product, exactly;
    the int8 gamma refuses groups and residual-first."""
    n = _rng(4)
    a, w, b, g, r = (torch.from_numpy(t) for t in (
        n(16, 32), n(32, 24), n(24), n(24), n(16, 24)))
    got = bk.gemm_residual(a, w, b, r, gamma=g)
    assert torch.equal(got, r + (a @ w + b) * g)
    rng = np.random.default_rng(5)
    a8 = torch.from_numpy(rng.integers(-127, 128, (16, 64), dtype=np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (24, 64), dtype=np.int8))
    sa, ws = torch.rand(16, 1) * 1e-2, torch.rand(24) * 1e-2
    part = (a8.double() @ wt.double().t()).float() * (sa * ws)
    got = qm.int8_gemm(a8, sa, wt, ws, b, residual=r, out_dtype=torch.float32,
                       gamma=g)
    assert torch.equal(got, r + (part + b) * g)


# ---------------------------------------------------------------------------
# the encodes
# ---------------------------------------------------------------------------


def test_quantized_mlp_bit_identical(tiny):
    """``quantize_convnext_mlp``: every code and scale equals JAX's; the
    codes live K-major, as the kernels read them."""
    jcfg, _, params, model = tiny
    ref = jax_fc.quantize_convnext_mlp(params, jcfg)
    got = fc.quantize_convnext_mlp(model, CLIPConfig(**TINY))
    assert set(got) == set(ref) == {f"stage{s}_block0" for s in range(4)}
    for blk, fcs in ref.items():
        for name, leaves in fcs.items():
            for key in ("w8", "scale"):
                np.testing.assert_array_equal(got[blk][name][key].numpy(),
                                              np.asarray(leaves[key]))
            assert got[blk][name]["w8"].t().is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_encode_matches_jax(tiny, int8, dtype):
    """``convnext_encode_fused`` over the plain K7 (or K15 with ``qmlp``)
    against JAX's over interpret-mode Pallas: K7 in fp32 at 5e-4, the rest
    at the int8 tower gates (``GATES``)."""
    jcfg, _, params, model = tiny
    cfg = CLIPConfig(**TINY)
    x = _images(23, 3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_fc.convnext_encode_fused(
        params, jnp.asarray(x), jcfg, project=True, dtype=jdt,
        qmlp=jax_fc.quantize_convnext_mlp(params, jcfg) if int8 else None,
        interpret=True)
    packed = fc.pack_convnext(model, cfg, tdt, mlp=not int8)
    assert ("w1" in packed["blocks"][0]) != int8
    qmlp = fc.quantize_convnext_mlp(model, cfg) if int8 else None
    with torch.no_grad():
        pre, proj = fc.convnext_encode_fused(packed, torch.from_numpy(x), cfg,
                                             project=True, qmlp=qmlp)
    assert pre.dtype == tdt and proj.shape == (3, 32)
    if dtype == "float32" and not int8:
        for got, want in ((pre, ref[0]), (proj, ref[1])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=5e-4, rtol=5e-4)
    else:
        _close_tower(pre.float(), ref[0], dtype)
        _close_tower(proj.float(), ref[1], dtype)
    with pytest.raises(NotImplementedError, match="banded"):
        fc.convnext_encode_fused(packed, torch.from_numpy(x), cfg, dwmat={})


@pytest.mark.parametrize("n_prefix", [0, 1, 2, 4])
def test_hybrid_encode_and_gradients_match_jax(tiny, n_prefix):
    """``convnext_encode_hybrid`` at n_prefix 0, 1, half and all: the
    projected features at 5e-4 against JAX's (interpret-mode Pallas behind
    ``stop_gradient``), the suffix's gradients of a scalar loss against
    ``jax.grad`` at 1e-4, and none reaching the prefix (a stage's
    downsample with its first block) or the stem."""
    jcfg, _, params, model = tiny
    cfg = CLIPConfig(**TINY)
    x = _images(24)
    r = _rng(25)(2, 32)

    def jax_loss(p):
        _, proj = jax_fc.convnext_encode_hybrid(
            p, jnp.asarray(x), jcfg, n_prefix, project=True,
            dtype=jnp.float32, interpret=True)
        return jnp.sum(proj * r), proj

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    model.zero_grad(set_to_none=True)
    _, proj = fc.convnext_encode_hybrid(model, torch.from_numpy(x), cfg,
                                        n_prefix, project=True,
                                        dtype=torch.float32)
    np.testing.assert_allclose(proj.detach().numpy(), np.asarray(ref),
                               atol=5e-4, rtol=5e-4)
    (proj * torch.from_numpy(r)).sum().backward()
    named = dict(model.named_parameters())
    suffix = tuple(f"visual.stage{s}_block0." for s in range(n_prefix, 4)) \
        + tuple(f"visual.down_{k}_{s}." for s in range(max(n_prefix, 1), 4)
                for k in ("norm", "conv")) + ("visual.head_",)
    if n_prefix == 0:
        suffix += ("visual.stem_",)
    for key, g in flatten_params(grads).items():
        name, g = _convert_key(key, g)
        if not name.startswith("visual."):
            continue
        if name.startswith(suffix):
            np.testing.assert_allclose(named[name].grad.numpy(), g,
                                       atol=1e-4, rtol=1e-4, err_msg=name)
        else:
            assert named[name].grad is None, name
            assert not np.any(g), name
    model.zero_grad(set_to_none=True)


def test_prefix_pack_and_encode_dispatch(tiny):
    """The ranged pack holds the prefix's blocks and the downsamples of the
    stages they open; ``pack_fastest``/``encode_image_fastest`` take the
    ConvNeXt path (the canonical module on the CPU)."""
    from aihab_clip_tpu_torch.models import fast_vit

    _, _, _, model = tiny
    cfg = CLIPConfig(**TINY)
    full = fast_vit.pack_fastest(model, cfg, torch.float32)
    prefix = fast_vit.pack_fastest(model, cfg, torch.float32, stop=2)
    assert len(full["blocks"]) == 4 and sorted(full["down"]) == [1, 2, 3]
    assert len(prefix["blocks"]) == 2 and sorted(prefix["down"]) == [1]
    for key, t in prefix["blocks"][1].items():
        a = t if isinstance(t, tuple) else (t,)
        for u, v in zip(a, full["blocks"][1][key] if isinstance(t, tuple)
                        else (full["blocks"][1][key],)):
            assert torch.equal(u, v), key
    x = torch.from_numpy(_images(26))
    with torch.no_grad():
        got = fast_vit.encode_image_fastest(model, x, cfg, project=True,
                                            packed=full)
        ref = model.encode_image(x, project=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="blocks"):
        fc.convnext_encode_fused(prefix, x, cfg)


# ---------------------------------------------------------------------------
# PEFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unlocked_groups", [0, 1, 2, 5, 6])
@pytest.mark.parametrize("text", [(False, 0), (True, 1)])
def test_lock_mask_matches_jax(tiny, unlocked_groups, text):
    """ConvNeXt lock groups (stem, the 4 blocks in depth order with each
    stage's downsample, head) name for name, at 0, 1, 2, L+1 and L+2."""
    jcfg, b, params, model = tiny
    tune_text, text_layers = text
    ref = jax_peft.build_lock_mask(
        params, jcfg.vision_layers, jcfg.transformer_layers,
        unlocked_groups=unlocked_groups, tune_text=tune_text,
        unlocked_text_layers=text_layers, is_vit=False, tower="convnext")
    flat = {_convert_key("/".join(k), np.zeros((1, 1, 1, 1)))[0]: bool(v)
            for k, v in traverse_util.flatten_dict(ref).items()}
    mask = peft.build_lock_mask(model, jcfg.vision_layers,
                                jcfg.transformer_layers,
                                unlocked_groups=unlocked_groups,
                                tune_text=tune_text,
                                unlocked_text_layers=text_layers)
    assert mask == flat
    for name, param in model.named_parameters():
        assert param.requires_grad == mask[name]
        param.requires_grad_(True)


def test_fused_prefix_length_matches_jax_on_the_accelerator(monkeypatch):
    """Auto prefix on the card equals JAX's on the TPU (L = sum(depths)):
    26 of 36 base_w blocks at unlocked_groups 11; 0 off the card."""
    from aihab_clip_tpu.models import CLIP_ARCHS as JAX_ARCHS

    monkeypatch.setattr(jax_fast_vit, "dispatch_backend", lambda: "tpu")
    monkeypatch.setattr(peft, "resolve_device",
                        lambda device: torch.device("cuda"))
    for tag in ("convnext_base_w", "convnext_xxlarge", "TinyConvNeXt"):
        for u in (1, 11, 26, 37, 40):
            assert peft.peft_fused_prefix_len(CLIP_ARCHS[tag], u, "cuda") == \
                jax_fast_vit.peft_fused_prefix_len(JAX_ARCHS[tag], u)
    assert peft.peft_fused_prefix_len(CLIP_ARCHS["convnext_base_w"], 11,
                                      "cuda") == 26
    monkeypatch.undo()
    assert peft.peft_fused_prefix_len(CLIP_ARCHS["convnext_base_w"], 11,
                                      "cpu") == 0


@pytest.mark.parametrize("prefix_quant", [False, True])
def test_convnext_prefix_loss_matches_jax(tiny, prefix_quant):
    """One train loss with a fused prefix of 2 (center crop, fp32) against
    JAX's at 1e-4; with ``prefix_quant`` both run the bf16-kernel prefix (no
    int8 ConvNeXt prefix, ``peft.py:280-281``)."""
    jcfg, b, params, model = tiny
    head, tpc = _head(b, params)
    rng = np.random.default_rng(27)
    images = rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.integers(0, 20, 8).astype(np.int32)
    valid = np.array([True] * 7 + [False])
    base = dict(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                crop_mode="center", num_templates=tpc, fused_prefix=2,
                prefix_quant=prefix_quant)
    mask = jax_peft.build_lock_mask(params, jcfg.vision_layers, 2,
                                    unlocked_groups=3, is_vit=False,
                                    tower="convnext")
    trainable, frozen = jax_peft.partition_params(params, mask)
    jcfg_peft = jax_peft.PEFTConfig(**base)
    jq = jax_peft._quantize_prefix(b.model, jcfg_peft, frozen)
    assert jq is None
    loss_fn = jax_peft._build_loss_fn(b.model, jcfg_peft,
                                      head["text_weights"],
                                      head["prompt_tokens"])
    ref_loss, _ = loss_fn(trainable, frozen, jnp.asarray(images),
                          jnp.asarray(labels), jnp.asarray(valid),
                          jax.random.key(0), jq)
    peft.build_lock_mask(model, jcfg.vision_layers, 2, unlocked_groups=3)
    cfg = peft.PEFTConfig(**base)
    assert peft._quantize_prefix(model, cfg) is None
    pprefix = peft._pack_prefix(model, cfg)
    assert len(pprefix["blocks"]) == 2
    fn = peft._build_loss_fn(
        model, cfg, torch.from_numpy(np.asarray(head["text_weights"])), None)
    with torch.no_grad():
        loss, _ = fn(torch.from_numpy(images), torch.from_numpy(labels),
                     torch.from_numpy(valid), torch.Generator().manual_seed(0),
                     pprefix)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4,
                               atol=1e-4)
    for p in model.parameters():
        p.requires_grad_(True)


def test_convnext_finetune_runs(mlp_tower):
    """``finetune`` trains a ConvNeXt on the CPU with an explicit prefix
    (plain K7) and ``prefix_quant`` (the bf16 prefix): frozen leaves stay
    bit-identical, trained ones move; a prefix past the frozen depth
    raises."""
    from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView

    from test_torch_peft import _dataset

    _, _, _, model = mlp_tower
    ds = _dataset(ImageArrayDataset, n=12)
    weights = torch.nn.functional.normalize(
        torch.randn(32, 20, generator=torch.Generator().manual_seed(28)),
        dim=0)
    cfg = peft.PEFTConfig(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                          crop_mode="center", fused_prefix=5,
                          prefix_quant=True)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    try:
        with pytest.raises(ValueError, match="frozen bottom depth"):
            peft.finetune(model, SplitView(ds, np.arange(8), 4), None, None,
                          cfg, text_weights=weights, unlocked_groups=6,
                          device="cpu", verbose=False)
        out = peft.finetune(model, SplitView(ds, np.arange(8), 4), None,
                            SplitView(ds, np.arange(8, 12), 4), cfg,
                            text_weights=weights, unlocked_groups=5,
                            device="cpu", verbose=False)
        moved = 0
        for name, trainable in out["mask"].items():
            same = torch.equal(start[name], out["params"][name])
            assert same or trainable, name
            moved += not same
        assert moved > 0 and np.isfinite(out["test"]["loss"])
    finally:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
                p.requires_grad_(True)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

ENGINE = "torch-convnext_base_w-engine"


def _engines(params, jcfg, root, quantize):
    """The JAX engine and the port's on ``params``, which the JAX package
    writes to its converted cache under ``root``."""
    npz = jax_zoo._npz_cache_path(ENGINE, root)
    npz.parent.mkdir(parents=True)
    save_params_npz(npz, params)
    jax_zoo._save_config(jax_zoo._config_cache_path(ENGINE, root), jcfg)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_zoo, "default_cache_root", lambda: root)
    mp.setattr(zoo, "default_cache_root", lambda: root)
    try:
        return (JaxEngine(model=ENGINE, batch_size=4, flat=True,
                          quantize=quantize, verbose=False),
                ClassifierEngine(model=ENGINE, batch_size=4, flat=True,
                                 quantize=quantize, verbose=False,
                                 device="cpu"))
    finally:
        mp.undo()


def _classify_both(ref, port):
    imgs = np.random.default_rng(33).integers(0, 256, (6, 224, 224, 3),
                                              dtype=np.uint8)
    want = np.concatenate([ref.classify_batch(imgs[:4]),
                           ref.classify_batch(imgs[4:])])
    got = np.concatenate([port.classify_batch(imgs[:4]),
                          port.classify_batch(imgs[4:])])
    assert got.shape == (6, 20)
    return got, want


def test_convnext_engine_matches_jax(tiny, tmp_path):
    """The bf16 engine (the fp32 canonical tower on the CPU) against JAX's
    CPU engine on the same weights and images, end to end (each side its own
    preprocessing), at 1e-4."""
    jcfg, _, params, _ = tiny
    ref, port = _engines(params, jcfg, tmp_path, "none")
    got, want = _classify_both(ref, port)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", [30, 31, 32])
def test_int8_convnext_engine_matches_jax(seed, tmp_path):
    """The int8 engine (the plain K15, fp32 convs) against JAX's CPU int8
    engine (its interpret-mode kernel, fp32) over three model draws.

    On the port's own normalised images, the port's probabilities against
    JAX's encode under JAX's head: the same codes, within 1e-5.

    End to end, each side on its own preprocessing: its ~1e-6 differences
    can flip an int8 code.  Over model seeds 30-37 and image seeds 33-35
    (``tools_dev/int8_convnext_engine_spread.py``) max|dprob| read 6.4e-7 to
    5.2e-3, with no top-1 class different in the 24 draws: the same top-1
    class and max|dprob| <= 1e-2."""
    from aihab_clip_tpu_torch.ops.preprocess import (eval_transform,
                                                     normalize_stats_for)

    jcfg = JaxCLIPConfig(**TINY)
    params = _redraw_gamma(_jax_params(jcfg, seed)[1], seed)
    ref, port = _engines(params, jcfg, tmp_path, "int8")
    assert port.quantize == "int8"
    assert set(port._qparams) == {f"stage{s}_block0" for s in range(4)}
    assert "w1" not in port._packed["blocks"][0]
    imgs = np.random.default_rng(34).integers(0, 256, (3, 224, 224, 3),
                                              dtype=np.uint8)
    mean, std = normalize_stats_for(port.bundle.config)
    x = eval_transform(torch.from_numpy(imgs), port.resolution,
                       dtype=torch.float32, mean=mean, std=std)
    feats = jax_fc.convnext_encode_fused(
        ref._weights[0], jnp.asarray(x.numpy()), ref.bundle.config,
        project=True, qmlp=ref._weights[1], interpret=True)[1]
    feats = feats / jnp.linalg.norm(feats, axis=-1, keepdims=True)
    kernel_route = np.asarray(jax.nn.softmax(
        100.0 * feats @ ref._text_weights, axis=-1))
    np.testing.assert_allclose(port.classify(torch.from_numpy(imgs)).numpy(),
                               kernel_route, rtol=0, atol=1e-5)
    got, want = _classify_both(ref, port)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
