"""The int8 CLIP ViT path of the port against the JAX package on the same
weights: the quantized weights bit for bit; the plain versions of K12, K11
and K14 (``ops/quant_matmul.py``) against the Pallas kernels in interpret
mode; the int8 tower (``models/quant_vit.py``) with its block plans; the
PEFT hybrid encode ``vit_encode_hybrid`` (bf16 prefix over K1 and the int8
prefix over K14) with its gradients; one ``prefix_quant`` train loss; and
the int8 engine.  The CUDA kernels against their plain versions on a card:
``tests/test_torch_cuda.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aihab_clip_tpu.models.zoo as jax_zoo
from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
from aihab_clip_tpu.models import fast_vit as jax_fast_vit
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models import quant_vit as jax_qv
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.ops import quant as jax_quant
from aihab_clip_tpu.ops import quant_matmul as jax_qm
from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine
from aihab_clip_tpu.train import peft as jax_peft

import aihab_clip_tpu_torch.models.zoo as zoo
from aihab_clip_tpu_torch.models import CLIPConfig, fast_vit
from aihab_clip_tpu_torch.models import quant_vit as qv
from aihab_clip_tpu_torch.models.convert import _convert_key, flatten_params
from aihab_clip_tpu_torch.ops import quant_matmul as qm
from aihab_clip_tpu_torch.serving import ClassifierEngine
from aihab_clip_tpu_torch.train import peft

from test_torch_peft import _head, _noisy, _port_model

# two heads of 64 (ViT-B's head width), a 512-wide MLP, S = 17 at 32 px
TOWER = dict(embed_dim=64, image_resolution=32, vision_layers=2,
             vision_width=128, vision_patch_size=8, context_length=77,
             vocab_size=49408, transformer_width=64, transformer_heads=1,
             transformer_layers=1)
# the tower gates of tests/test_torch_quant_siglip.py: per-image cosine and
# max|d| over max|ref|
GATES = {"float32": (0.9999, 5e-3), "bfloat16": (0.9999, 2 ** -6)}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread, so the CPU's fp32 sums (and the int8 codes
    rounded from them) do not depend on the machine's core count; JAX's
    default gelu_poly form."""
    monkeypatch.delenv("AIHAB_ERF_IMPL", raising=False)
    monkeypatch.delenv("AIHAB_NO_GELU_POLY", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return n


def _weights(n, k, cols):
    w8, ws = jax_quant.quantize_weight(jnp.asarray(n(k, cols, scale=k ** -0.5)))
    return np.asarray(w8), np.asarray(ws)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _block_args(seed, w, hidden):
    """K14's weights in JAX's order after x: in_proj, out_proj, LN1, c_fc,
    c_proj, LN2 (int8 weights, fp32 scales and biases)."""
    n = _rng(seed)
    wq, sq = _weights(n, w, 3 * w)
    wo, so = _weights(n, w, w)
    w1, s1 = _weights(n, w, hidden)
    w2, s2 = _weights(n, hidden, w)
    return [wq, sq, n(3 * w, scale=0.1), wo, so, n(w, scale=0.1),
            1 + n(w, scale=0.1), n(w, scale=0.1), w1, s1, n(hidden, scale=0.1),
            w2, s2, n(w, scale=0.1), 1 + n(w, scale=0.1), n(w, scale=0.1)]


def _close_kernel(got, ref, dtype):
    """fp32: max|d| <= 1e-5 (measured <= 9.6e-7: the two sides' fp32 LN
    reductions and gelu_tanh differ in the last bit).  bf16: max|d| within 2
    bf16 ulps of the largest output, 2 * 2^-8 * max|ref|, the bf16 gate of
    ``tests/test_torch_quant.py``'s K13 case.  In bf16 such a last-bit
    difference can put an fp32 value on the other side of an int8 rounding
    boundary: the flipped code moves its row by one code step times a
    weight (measured in K14 at S=50 with gelu_tanh: 1.95e-2 against the
    limit of 4.15e-2; elsewhere 0)."""
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2 * 2 ** -8 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# K12, K11, K14: plain versions vs interpret-mode Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,padded", [(17, False), (50, False), (48, True)])
def test_quant_attn_block_fused_plain_matches_pallas(s, padded, dtype):
    """K12 at S = 17 and 50 (no multiple of 16: JAX pads, the port masks
    nothing past S), and 37 real tokens in a 48 pad with ``padded_io``."""
    n = _rng(1)
    heads, w = 2, 128
    x = n(2, s, w)
    args = _block_args(2, w, 4 * w)[:8]
    kw = dict(padded_io=True, seq_len=37) if padded else {}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_qm.quant_attn_block_fused(
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in args), heads,
        interpret=True, **kw)
    out = qm.quant_attn_block_fused(torch.from_numpy(x).to(tdt), *_t(*args),
                                    heads, **kw)
    assert out.dtype == tdt and out.shape == x.shape
    valid = slice(0, 37 if padded else s)
    _close_kernel(out[:, valid], np.asarray(ref, np.float32)[:, valid], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,eps", [("quick_gelu", 1e-5), ("gelu_tanh", 1e-6),
                                     ("gelu_poly", 1e-5)])
def test_quant_mlp_block_fused_plain_matches_pallas(act, eps, dtype):
    """K11 over 50 rows, the hidden row (512) requantized whole."""
    n = _rng(3)
    w, hidden = 128, 512
    x = n(50, w, scale=2.0)
    args = _block_args(4, w, hidden)
    mlp = args[8:]                   # c_fc, c_proj, LN2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_qm.quant_mlp_block_fused(
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in mlp), act=act,
        ln_eps=eps, interpret=True)
    out = qm.quant_mlp_block_fused(torch.from_numpy(x).to(tdt), *_t(*mlp),
                                   act=act, ln_eps=eps, tile_m=64)
    assert out.dtype == tdt and out.shape == x.shape
    _close_kernel(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_chunks", [1, 2])
@pytest.mark.parametrize("s,act", [(17, "quick_gelu"), (50, "gelu_tanh")])
def test_quant_full_block_fused_plain_matches_pallas(s, act, mlp_chunks,
                                                     dtype):
    """K14: the mid-block residual in fp32, the hidden row requantized per
    chunk, and c_proj summed as (y1 + b2) + the chunk partials."""
    n = _rng(5)
    heads, w = 2, 128
    x = n(2, s, w)
    args = _block_args(6, w, 4 * w)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_qm.quant_full_block_fused(
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in args), heads,
        mlp_chunks=mlp_chunks, act=act, interpret=True)
    out = qm.quant_full_block_fused(torch.from_numpy(x).to(tdt), *_t(*args),
                                    heads, mlp_chunks=mlp_chunks, act=act)
    assert out.dtype == tdt and out.shape == x.shape
    _close_kernel(out, ref, dtype)


@pytest.mark.parametrize("kernel", ["K12", "K13", "K14"])
@pytest.mark.parametrize("head_dim", [88, 104])
def test_int8_blocks_at_wide_head_dims_match_pallas(head_dim, kernel):
    """K12, K13 (2 groups of 2 heads: 176- and 208-wide groups padded to
    192 and 224) and K14 (gelu_poly, MLP in the tower's ratio) over heads of
    ViT-g/14's 88 and ViT-bigG/14's 104 at S = 17, in fp32, against the
    Pallas kernels in interpret mode: K12 and K14 within ``_close_kernel``
    (measured max|d| <= 7.2e-7); K13 at the tower gates, as
    ``test_int8_tower_plans`` holds it.  K13 rounds q, k, v and P to bf16
    whatever x's dtype (its TPU kernel's casts, ``quant_matmul.py:586``),
    so where torch's and XLA's fp32 score sums differ in their last bit a
    P lands on the other side of a bf16 rounding and the requantized
    attention moves by a code (measured at 88: 3 of 34 rows, max|d|
    1.56e-3; at 104 none)."""
    n = _rng(40 + head_dim)
    heads = 4 if kernel == "K13" else 2
    w = heads * head_dim
    x = n(2, 17, w)
    args = _block_args(41, w, {88: 768, 104: 1024}[head_dim] * w // (
        2 * head_dim))
    if kernel == "K12":
        ref = jax_qm.quant_attn_block_fused(
            jnp.asarray(x), *(jnp.asarray(a) for a in args[:8]), heads,
            interpret=True)
        out = qm.quant_attn_block_fused(torch.from_numpy(x), *_t(*args[:8]),
                                        heads)
    elif kernel == "K14":
        ref = jax_qm.quant_full_block_fused(
            jnp.asarray(x), *(jnp.asarray(a) for a in args), heads,
            act="gelu_poly", interpret=True)
        out = qm.quant_full_block_fused(torch.from_numpy(x), *_t(*args),
                                        heads, act="gelu_poly")
    else:
        jw = [jnp.asarray(a) for a in args[:8]]
        jg = jax_qm.regroup_attn_weights(jw[0], jw[1], jw[2], jw[3], heads, 2)
        ref = jax_qm.quant_attn_block_split(
            jnp.asarray(x), *jg, jw[4], jw[5], jw[6], jw[7], heads, 2,
            interpret=True)
        tw = _t(*args[:8])
        wg, sg, bg, og = qm.regroup_attn_weights(tw[0], tw[1], tw[2], tw[3],
                                                 heads, 2)
        wg, og = qm.int8_attn_weights(wg, og)
        assert qm._out_operand(og).shape == (w, 2 * qm._group_pad(
            2 * head_dim))
        out = qm.quant_attn_block_split(torch.from_numpy(x), wg, sg, bg, og,
                                        tw[4], tw[5], tw[6], tw[7], heads, 2)
        assert out.shape == x.shape
        _close_tower(out.reshape(-1, w).numpy(),
                     np.asarray(ref).reshape(-1, w))
        return
    assert out.shape == x.shape
    _close_kernel(out, ref, "float32")


def test_quant_full_block_fused_images_per_program():
    """The TPU kernel's images per program (1, 2, 8) give one output in JAX,
    and the port, which ignores it, gives that output too."""
    n = _rng(7)
    x = n(8, 17, 128)
    args = _block_args(8, 128, 512)
    refs = [np.asarray(jax_qm.quant_full_block_fused(
        jnp.asarray(x), *(jnp.asarray(a) for a in args), 2, interpret=True,
        images_per_program=g)) for g in (1, 2, 8)]
    for ref in refs[1:]:
        np.testing.assert_array_equal(ref, refs[0])
    for g in (1, 2, 8):
        out = qm.quant_full_block_fused(torch.from_numpy(x), *_t(*args), 2,
                                        images_per_program=g)
        _close_kernel(out, refs[0], "float32")


def test_residual_first_int8_gemm_order():
    """``residual_first`` sums (r + b) + part_0 + part_1 in fp32, the other
    modes (part_0 + b) + r: the plain version keeps each order exactly."""
    rng = np.random.default_rng(9)
    a8 = torch.from_numpy(rng.integers(-127, 128, (16, 64), dtype=np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (24, 64), dtype=np.int8))
    sa = torch.rand(16, 2) * 1e-2
    ws, b, r = torch.rand(24) * 1e-2, torch.randn(24), torch.randn(16, 24)
    got = qm.int8_gemm(a8, sa, wt, ws, b, residual=r, out_dtype=torch.float32,
                       groups=2, residual_first=True)
    parts = [(a8[:, i * 32:(i + 1) * 32].double()
              @ wt[:, i * 32:(i + 1) * 32].double().t()).float()
             * (sa[:, i:i + 1] * ws) for i in range(2)]
    assert torch.equal(got, ((r + b) + parts[0]) + parts[1])
    other = qm.int8_gemm(a8, sa, wt, ws, b, residual=r,
                         out_dtype=torch.float32, groups=2)
    assert torch.equal(other, ((parts[0] + b) + r) + parts[1])


def test_full_block_argument_checks():
    args = _t(*_block_args(10, 128, 512))
    x = torch.zeros(1, 5, 128)
    with pytest.raises(ValueError, match="does not divide hidden"):
        qm.quant_full_block_fused(x, *args, 2, mlp_chunks=3)
    with pytest.raises(ValueError, match="unknown activation"):
        qm.quant_mlp_block_fused(x[0], *args[8:], act="relu")
    with pytest.raises(ValueError, match="requires seq_len"):
        qm.quant_attn_block_fused(x, *args[:8], 2, padded_io=True)


# ---------------------------------------------------------------------------
# the int8 tower
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tower():
    """(JAX config, noisy JAX params, port model, images)."""
    jcfg = JaxCLIPConfig(**TOWER)
    b = jax_load("random:quant-vit", random_cfg=jcfg, seed=11)
    params = _noisy(b.params, 12)
    model = _port_model(params, CLIPConfig(**TOWER))
    images = np.random.default_rng(13).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    return jcfg, params, model, images


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b,
                                                                         axis=-1)


def _close_tower(got, ref, dtype="float32"):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    cos_min, max_rel = GATES[dtype]
    assert _cos(got, ref).min() >= cos_min
    assert np.abs(got - ref).max() <= max_rel * np.abs(ref).max()


def test_quantized_params_bit_identical(tower):
    """Every int8 code and scale of ``quantize_vit_params`` equals the JAX
    package's on the carried fp32 weights; the rest passes through."""
    jcfg, params, model, _ = tower
    ref = jax_qv.quantize_vit_params(params, jcfg)
    got = qv.quantize_vit_params(model, CLIPConfig(**TOWER))
    assert set(got) == set(ref)
    for key in ("w8", "scale"):
        np.testing.assert_array_equal(got["conv1"][key].numpy(),
                                      np.asarray(ref["conv1"][key]))
    for key in ("class_embedding", "positional_embedding", "proj"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for ln in ("ln_pre", "ln_post"):
        for key in ("scale", "bias"):
            np.testing.assert_array_equal(got[ln][key].numpy(),
                                          np.asarray(ref[ln][key]))
    for i in range(2):
        g, r = (t["transformer"][f"resblocks_{i}"] for t in (got, ref))
        assert set(g) == set(r)
        for name, leaves in r.items():
            assert set(g[name]) == set(leaves), name
            for key, want in leaves.items():
                np.testing.assert_array_equal(g[name][key].numpy(),
                                              np.asarray(want),
                                              err_msg=f"{i} {name}/{key}")
        # the int8 weights live K-major: the kernels read them in place
        assert g["mlp/c_proj"]["w8"].t().is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_tower_matches_jax(tower, dtype):
    """``vit_encode_int8`` through the plain K8 and K14 against JAX's kernel
    path in interpret mode (``GATES``), and against JAX's ``impl="xla"``
    reference at cosine >= 0.99 (``tests/test_quant.py``)."""
    jcfg, params, model, images = tower
    cfg = CLIPConfig(**TOWER)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq = jax_qv.quantize_vit_params(params, jcfg)
    ref = jax_qv.vit_encode_int8(jq, jnp.asarray(images), jcfg, dtype=jdt,
                                 impl="pallas", interpret=True, project=True)
    xla = jax_qv.vit_encode_int8(jq, jnp.asarray(images), jcfg, dtype=jdt,
                                 impl="xla")
    qm.reset_launch_counts()
    with torch.no_grad():
        pre, proj = qv.vit_encode_int8(qv.quantize_vit_params(model, cfg),
                                       torch.from_numpy(images), cfg,
                                       dtype=tdt, project=True)
    assert pre.dtype == tdt and proj.shape == (3, 64)
    assert not any(qm.launch_counts().values())
    _close_tower(pre.float().numpy(), ref[0], dtype)
    _close_tower(proj.float().numpy(), ref[1], dtype)
    assert _cos(pre.float().numpy(), xla).min() >= 0.99


def test_int8_tower_plans(tower):
    """``merge_blocks="off"`` (K12 + K11) agrees with K14 in fp32 up to the
    order of c_proj's fp32 sum; the explicit plan with K13 (two groups) and
    the chained K9 -> K10 MLP (two slices) agrees with JAX's composition of
    the same kernels in interpret mode at the tower gates (measured: one row
    with a flipped int8 code, max|d| 4.4e-3; every other output within
    1e-5)."""
    jcfg, params, model, images = tower
    cfg = CLIPConfig(**TOWER)
    qp = qv.quantize_vit_params(model, cfg)
    x = torch.from_numpy(images)
    with torch.no_grad():
        merged = qv.vit_encode_int8(qp, x, cfg, dtype=torch.float32)
        off = qv.vit_encode_int8(qp, x, cfg, dtype=torch.float32,
                                 merge_blocks="off")
        tokens = qv.vit_patchify_int8(qp, x, cfg, torch.float32)
        plan = dict(qv.int8_block_plan(cfg, "off"), attn_groups=2,
                    mlp="chained", mlp_chunks=2)
        got = qv.apply_int8_vit_blocks(qp["transformer"], tokens, cfg,
                                       start=0, stop=1, plan=plan)
    np.testing.assert_allclose(off.numpy(), merged.numpy(), atol=1e-5,
                               rtol=0)
    blk = jax_qv.quantize_vit_params(params, jcfg)["transformer"][
        "resblocks_0"]
    ip, op = blk["attn/in_proj"], blk["attn/out_proj"]
    wg, sg, bg, og = jax_qm.regroup_attn_weights(ip["w8"], ip["scale"],
                                                 ip["bias"], op["w8"], 2, 2)
    xj = jax_qm.quant_attn_block_split(
        jnp.asarray(tokens.numpy()), wg, sg, bg, og, op["scale"], op["bias"],
        blk["ln_1"]["scale"], blk["ln_1"]["bias"], 2, 2, interpret=True)
    ref = jax_qv._chained_int8_mlp(
        xj.reshape(-1, 128), blk["mlp/c_fc"], blk["mlp/c_proj"],
        blk["ln_2"]["scale"], blk["ln_2"]["bias"], act="quick_gelu", n_ch=2,
        interpret=True)
    _close_tower(got.reshape(-1, 128).numpy(), ref)
    with pytest.raises(ValueError, match="merge_blocks"):
        qv.int8_block_plan(cfg, "on")


def test_int8_tower_refuses_other_routes(tower):
    _, _, model, images = tower
    cfg = CLIPConfig(**TOWER)
    for impl in ("xla", "chained"):
        with pytest.raises(NotImplementedError, match="pallas"):
            qv.vit_encode_int8({}, torch.from_numpy(images), cfg, impl=impl)
    assert qv._kernel_act(dataclasses.replace(cfg, act="gelu")) == "gelu_poly"


# ---------------------------------------------------------------------------
# the PEFT hybrid encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8_prefix", [False, True])
def test_hybrid_encode_and_gradients_match_jax(tower, int8_prefix):
    """Block 0 through the plain K1 (or K14 with ``qprefix``) without a
    graph (JAX: interpret-mode Pallas behind ``stop_gradient``), block 1,
    ``ln_post`` and ``proj`` under autograd; the projected features at
    5e-4, the suffix's gradients of a scalar loss against ``jax.grad`` at
    1e-4, and no gradient reaches the prefix or the stem."""
    jcfg, params, model, images = tower
    cfg = CLIPConfig(**TOWER)
    r = np.random.default_rng(14).standard_normal((3, 64)).astype(np.float32)
    jq = ({"resblocks_0": jax_qv.quantize_vit_block(
        params["visual"]["transformer"]["resblocks_0"])}
        if int8_prefix else None)

    def jax_loss(p):
        _, proj = jax_fast_vit.vit_encode_hybrid(
            p, jnp.asarray(images), jcfg, 1, project=True, dtype=jnp.float32,
            interpret=True, qprefix=jq)
        return jnp.sum(proj * r), proj

    (_, ref), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    qprefix = ({"resblocks_0": qv.quantize_vit_block(
        model.visual.transformer.resblocks[0])} if int8_prefix else None)
    model.zero_grad(set_to_none=True)
    _, proj = fast_vit.vit_encode_hybrid(model, torch.from_numpy(images), cfg,
                                         1, project=True, dtype=torch.float32,
                                         qprefix=qprefix)
    np.testing.assert_allclose(proj.detach().numpy(), np.asarray(ref),
                               atol=5e-4, rtol=5e-4)
    (proj * torch.from_numpy(r)).sum().backward()
    named = dict(model.named_parameters())
    for key, g in flatten_params(grads).items():
        name, g = _convert_key(key, g)
        if not name.startswith("visual."):
            continue
        if name.startswith(("visual.transformer.resblocks.1.",
                            "visual.ln_post", "visual.proj")):
            np.testing.assert_allclose(named[name].grad.numpy(), g,
                                       atol=1e-4, rtol=1e-4, err_msg=name)
        else:
            assert named[name].grad is None, name
            assert not np.any(g), name
    model.zero_grad(set_to_none=True)


def test_hybrid_without_prefix_is_the_canonical_tower(tower):
    _, _, model, images = tower
    x = torch.from_numpy(images)
    cfg = CLIPConfig(**TOWER)
    with torch.no_grad():
        hybrid = fast_vit.vit_encode_hybrid(model, x, cfg, 0, project=True,
                                            dtype=torch.float32)
        canon = model.encode_image(x, project=True)
    for a, b in zip(hybrid, canon):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_ranged_pack_holds_the_prefix(tower):
    _, _, model, _ = tower
    cfg = CLIPConfig(**TOWER)
    full = fast_vit.pack_fastest(model, cfg, torch.float32)
    prefix = fast_vit.pack_fastest(model, cfg, torch.float32, stop=1)
    assert len(full["blocks"]) == 2 and len(prefix["blocks"]) == 1
    for key, t in prefix["blocks"][0].items():
        assert torch.equal(t, full["blocks"][0][key]), key


@pytest.mark.parametrize("prefix_quant", [False, True])
def test_clip_prefix_loss_matches_jax(tower, prefix_quant):
    """One train loss of a CLIP ViT with a fused prefix of 1 (center crop,
    fp32), bf16 prefix or ``prefix_quant``, against JAX's with its
    ``_quantize_prefix`` at 1e-4."""
    jcfg, params, model, _ = tower
    b = jax_load("random:quant-vit", random_cfg=jcfg, seed=11)
    head, tpc = _head(b, params)
    rng = np.random.default_rng(15)
    images = rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    labels = rng.integers(0, 20, 8).astype(np.int32)
    valid = np.array([True] * 7 + [False])
    base = dict(resolution=32, num_classes=20, lr=1e-3, epochs=1,
                crop_mode="center", num_templates=tpc, fused_prefix=1,
                prefix_quant=prefix_quant)
    mask = jax_peft.build_lock_mask(b.params, 2, 1, unlocked_groups=2)
    trainable, frozen = jax_peft.partition_params(params, mask)
    jcfg_peft = jax_peft.PEFTConfig(**base)
    jq = jax_peft._quantize_prefix(b.model, jcfg_peft, frozen)
    loss_fn = jax_peft._build_loss_fn(b.model, jcfg_peft,
                                      head["text_weights"],
                                      head["prompt_tokens"])
    ref_loss, _ = loss_fn(trainable, frozen, jnp.asarray(images),
                          jnp.asarray(labels), jnp.asarray(valid),
                          jax.random.key(0), jq)
    peft.build_lock_mask(model, 2, 1, unlocked_groups=2)
    cfg = peft.PEFTConfig(**base)
    pprefix = (peft._quantize_prefix(model, cfg) if prefix_quant
               else peft._pack_prefix(model, cfg))
    if prefix_quant:
        assert list(pprefix) == ["resblocks_0"]
        assert set(pprefix["resblocks_0"]) == set(jq["resblocks_0"])
        assert peft._pack_prefix(model, cfg) is None
    else:
        assert len(pprefix["blocks"]) == 1
        assert peft._quantize_prefix(model, cfg) is None
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


# ---------------------------------------------------------------------------
# the int8 engine
# ---------------------------------------------------------------------------

ENGINE = "torch-quant-vit"


@pytest.fixture(scope="module", params=[16, 17, 18])
def engines(request, tmp_path_factory):
    """The JAX int8 engine and the port's on one model (seeded by the
    parameter) written to the converted cache by the JAX package."""
    root = tmp_path_factory.mktemp("cache")
    bundle = jax_zoo.load("random:" + ENGINE,
                          random_cfg=JaxCLIPConfig(**TOWER),
                          seed=request.param)
    npz = jax_zoo._npz_cache_path(ENGINE, root)
    npz.parent.mkdir(parents=True)
    save_params_npz(npz, bundle.params)
    jax_zoo._save_config(jax_zoo._config_cache_path(ENGINE, root),
                         bundle.config)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_zoo, "default_cache_root", lambda: root)
    mp.setattr(zoo, "default_cache_root", lambda: root)
    try:
        ref = JaxEngine(model=ENGINE, batch_size=4, flat=True,
                        quantize="int8", verbose=False)
        port = ClassifierEngine(model=ENGINE, batch_size=4, flat=True,
                                quantize="int8", verbose=False, device="cpu")
    finally:
        mp.undo()
    return ref, port


def test_int8_vit_engine_matches_jax(engines):
    """Two comparisons with the JAX engine on the same weights.

    On the port's own normalised images, the port's probabilities against
    JAX's int8 encode on its kernel route (``impl="pallas"``, interpret
    mode) under JAX's head: the same codes (measured max|dprob| <= 1.4e-6
    over the three seeds; limit 1e-5).

    End to end against the JAX CPU engine, which runs its ``impl="xla"``
    int8 reference (bf16 LN outputs quantized, bf16 residuals, its own
    attention) on its own preprocessing: fp32 preprocessing differences of
    ~1e-6 flip bf16 roundings and then int8 codes, and a logit of 100 * cos
    magnifies them.  Over model seeds 16-23 and image seeds 18-20 at this
    width (``tools_dev/int8_vit_engine_spread.py``) the readings were max|dprob| 1.9e-4 to 4.9e-2, and the top-1
    class differed on 2 of 6 images in one of the 24 draws (0 in the
    others); the criterion of
    ``test_torch_quant_serving.test_int8_engine_matches_jax`` (top-1 equal,
    2e-2) held in 14 of them.  So this part is a smoke check, at
    max|dprob| <= 0.1 with at most 2 of 6 top-1 classes different."""
    from aihab_clip_tpu_torch.ops.preprocess import (eval_transform,
                                                     normalize_stats_for)

    ref, port = engines
    assert port.quantize == "int8" and port._packed is None
    assert set(port._qparams["transformer"]["resblocks_0"]) == {
        "attn/in_proj", "attn/out_proj", "mlp/c_fc", "mlp/c_proj", "ln_1",
        "ln_2"}
    imgs = np.random.default_rng(18).integers(0, 256, (6, 224, 224, 3),
                                              dtype=np.uint8)
    mean, std = normalize_stats_for(port.bundle.config)
    x = eval_transform(torch.from_numpy(imgs), port.resolution,
                       dtype=torch.float32, mean=mean, std=std)
    feats = jax_qv.vit_encode_int8(
        ref._weights, jnp.asarray(x.numpy()), ref.bundle.config,
        project=True, impl="pallas", interpret=True)[1].astype(jnp.float32)
    feats = feats / jnp.linalg.norm(feats, axis=-1, keepdims=True)
    kernel_route = np.asarray(jax.nn.softmax(
        100.0 * feats @ ref._text_weights, axis=-1))
    got = port.classify(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, kernel_route, rtol=0, atol=1e-5)

    want = np.concatenate([ref.classify_batch(imgs[:4]),
                           ref.classify_batch(imgs[4:])])
    got = np.concatenate([port.classify_batch(imgs[:4]),
                          port.classify_batch(imgs[4:])])
    assert got.shape == (6, 20)
    assert (got.argmax(-1) != want.argmax(-1)).sum() <= 2
    assert np.abs(got - want).max() <= 0.1
