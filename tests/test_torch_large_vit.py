"""The LAION ViT-H/14, ViT-g/14 and ViT-bigG/14 towers in the port against
the JAX package: their table rows field by field; open_clip's dashed names
resolved as JAX resolves them; the plain attention at head_dim 88 and 104;
narrow towers that keep those head widths (2 heads of 88 or 104, 2 layers,
28 px at patch 14, MLPs in the towers' ratios) on carried weights through
the default block route (K1), the two-kernel halves and JAX's split route
(K5 + K4), the int8 tower (K8 at K = 588, K14) and JAX's int8 route (K13 +
the chained K9 -> K10); K8's zero padding of K; and, for the full-size
configurations, the explicit plans ``chip_smoke.py`` runs against JAX's
plan and gates (plan functions only, no full-size tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.models import CLIP_ARCHS as JAX_ARCHS
from aihab_clip_tpu.models import CLIPConfig as JaxConfig
from aihab_clip_tpu.models import CLIPModel as JaxModel
from aihab_clip_tpu.models import fast_vit as jax_fast_vit
from aihab_clip_tpu.models import load as jax_load
from aihab_clip_tpu.models import quant_vit as jax_qv
from aihab_clip_tpu.models.zoo import _normalize_openclip_name as jax_norm
from aihab_clip_tpu.ops import attention as jax_att
from aihab_clip_tpu.ops import quant as jax_quant
from aihab_clip_tpu.ops import quant_matmul as jax_qm

import chip_smoke
from aihab_clip_tpu_torch.models import CLIP_ARCHS, CLIPConfig, fast_vit
from aihab_clip_tpu_torch.models import quant_vit as qv
from aihab_clip_tpu_torch.models import zoo
from aihab_clip_tpu_torch.ops import block_kernel as bk
from aihab_clip_tpu_torch.ops import quant_matmul as qm

from test_torch_peft import _noisy, _port_model

LARGE = ("ViT-H/14", "ViT-g/14", "ViT-bigG/14")
# narrow towers with ViT-g/14's and ViT-bigG/14's head widths and MLP ratios
# (6144 / 1408 = 768 / 176, 8192 / 1664 = 1024 / 208)
NARROW = {
    "g": dict(embed_dim=32, image_resolution=28, vision_layers=2,
              vision_width=176, vision_patch_size=14, context_length=77,
              vocab_size=49408, transformer_width=64, transformer_heads=1,
              transformer_layers=1, vision_mlp_dim=768,
              vision_heads_override=2, act="gelu"),
    "bigG": dict(embed_dim=32, image_resolution=28, vision_layers=2,
                 vision_width=208, vision_patch_size=14, context_length=77,
                 vocab_size=49408, transformer_width=64, transformer_heads=1,
                 transformer_layers=1, vision_mlp_dim=1024,
                 vision_heads_override=2, act="gelu"),
}
# each narrow tower's K4 chunks: its full-size tower's (JAX_ROUTES)
NARROW_CHUNKS = {"g": 3, "bigG": 8}
# the int8 tower gates of tests/test_torch_quant_vit.py: per-image cosine
# and max|d| over max|ref|
INT8_GATE = (0.9999, 5e-3)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread (the int8 codes round from fp32 sums whose order
    follows the thread count) and JAX's default gelu_poly form."""
    monkeypatch.delenv("AIHAB_ERF_IMPL", raising=False)
    monkeypatch.delenv("AIHAB_NO_GELU_POLY", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(NARROW))
def narrow(request):
    """(name, JAX bundle, its params with noise, port model, port config,
    images)."""
    kw = NARROW[request.param]
    b = jax_load(f"random:narrow-{request.param}", random_cfg=JaxConfig(**kw),
                 seed=21)
    params = _noisy(b.params, 22)
    cfg = CLIPConfig(**kw)
    model = _port_model(params, cfg)
    images = np.random.default_rng(23).standard_normal(
        (3, 28, 28, 3)).astype(np.float32)
    return request.param, b, params, model, cfg, images


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


def _close_int8(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert _cos(got, ref).min() >= INT8_GATE[0]
    assert np.abs(got - ref).max() <= INT8_GATE[1] * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the table and the names
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", LARGE)
def test_rows_match_jax(name):
    """Each tower's row equals JAX's field by field; the port builds it
    (shapes only, on the meta device) with JAX's heads and MLP width."""
    got, want = dataclasses.asdict(CLIP_ARCHS[name]), dataclasses.asdict(
        JAX_ARCHS[name])
    assert got == want
    cfg = CLIP_ARCHS[name]
    with torch.device("meta"):
        model = zoo.CLIPModel(cfg)
    blk = model.visual.transformer.resblocks[0]
    assert len(model.visual.transformer.resblocks) == cfg.vision_layers
    assert blk.mlp.c_fc.weight.shape == (cfg.vision_mlp_dim
                                         or 4 * cfg.vision_width,
                                         cfg.vision_width)
    assert cfg.vision_width // cfg.vision_heads in bk.HEAD_DIMS
    assert cfg.vision_heads == JAX_ARCHS[name].vision_heads


# the names of tests/test_zoo_archs.py::test_openclip_dashed_name_normalization
# and the LAION towers' open_clip names
DASHED = ["ViT-B-16", "ViT-B-32", "ViT-L-14", "ViT-L-14-336",
          "random:ViT-B-16", "RN50", "random:Tiny",
          "hf-hub:timm/ViT-SO400M-16-SigLIP2-384",
          "ViT-SO400M-16-SigLIP2-384", "ViT-H-14", "ViT-g-14", "ViT-bigG-14",
          "random:ViT-bigG-14", "ViT-L-14-336px", "ViT-B-16-SigLIP"]


def test_dashed_names_resolve_as_jax():
    """C3: the port maps every name as JAX does, onto rows equal to JAX's
    (QuickGELU for the OpenAI towers, exact gelu for the LAION ones), and
    its table has no row JAX's lacks among the ViTs."""
    for name in DASHED:
        got = zoo._normalize_openclip_name(name)
        assert got == jax_norm(name), name
        key = got.split(":", 1)[-1]
        if key != name.split(":", 1)[-1]:
            assert dataclasses.asdict(CLIP_ARCHS[key]) == \
                dataclasses.asdict(JAX_ARCHS[key]), name
    acts = {n: CLIP_ARCHS[zoo._normalize_openclip_name(n)].act
            for n in ("ViT-B-16", "ViT-B-32", "ViT-L-14", "ViT-L-14-336",
                      "ViT-H-14", "ViT-g-14", "ViT-bigG-14")}
    assert acts == {"ViT-B-16": "quick_gelu", "ViT-B-32": "quick_gelu",
                    "ViT-L-14": "quick_gelu", "ViT-L-14-336": "quick_gelu",
                    "ViT-H-14": "gelu", "ViT-g-14": "gelu",
                    "ViT-bigG-14": "gelu"}
    vits = {k for k, c in CLIP_ARCHS.items() if c.tower == "vit"}
    assert vits <= set(JAX_ARCHS)


def test_load_by_dashed_name_is_the_openai_tower():
    """``load("random:ViT-B-16")`` is JAX's QuickGELU ViT-B/16, under the
    normalised name, and draws the weights ``random:ViT-B/16`` draws."""
    a = zoo.load("random:ViT-B-16", device="cpu", seed=0)
    assert a.config.act == "quick_gelu"
    assert a.config == CLIP_ARCHS["ViT-B/16"] and a.name == "random:ViT-B/16"
    b = zoo.load("random:ViT-B/16", device="cpu", seed=0)
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    for key in ("visual.conv1.weight", "visual.transformer.resblocks.11.mlp."
                "c_proj.weight"):
        assert torch.equal(pa[key], pb[key])


# ---------------------------------------------------------------------------
# the attention at head_dim 88 and 104
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalize_p", [False, True])
@pytest.mark.parametrize("d", [88, 104])
def test_plain_attention_at_wide_head_dims(d, normalize_p):
    """``attention_plain`` (either rounding point of P: in fp32 both are the
    one softmax) at S = 70 over 2 heads against JAX's attention kernel in
    interpret mode and its XLA form, at K6's fp32 tolerance (2e-5)."""
    heads, s = 2, 70
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, s, heads * d)).astype(np.float32)
               for _ in range(3))
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
    out = bk.attention_plain(qkv, heads, normalize_p=normalize_p).numpy()
    ref = jax_att._pallas_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), heads, interpret=True)
    xla = jax_att._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), heads)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(xla), atol=2e-5)


# ---------------------------------------------------------------------------
# the narrow towers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("merge_blocks", ["auto", "off"])
def test_tower_matches_jax(narrow, merge_blocks):
    """``vit_encode_block_fused`` (K1, or K2 + K3) against JAX's fused
    encode in interpret mode, and the canonical module against JAX's
    module, at the fused-tower tolerance (5e-4)."""
    _, b, params, model, cfg, images = narrow
    x = jnp.asarray(images)
    ref = jax_fast_vit.vit_encode_block_fused(
        params, x, b.config, project=True, dtype=jnp.float32,
        merge_blocks=merge_blocks, interpret=True)
    mod = b.model.apply({"params": params}, x,
                        method=JaxModel.encode_image, project=True)
    packed = fast_vit.pack_fastest(model, cfg, torch.float32)
    with torch.no_grad():
        got = fast_vit.vit_encode_block_fused(
            packed, torch.from_numpy(images), cfg, project=True,
            merge_blocks=merge_blocks)
        canon = model.encode_image(torch.from_numpy(images), project=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4,
                                   rtol=5e-4)
    for g, r in zip(canon, mod):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4,
                                   rtol=5e-4)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_split_route_matches_jax(narrow, n_groups):
    """JAX's split route, ported: ``split_block_plan`` (K5 over one group
    of both heads or two groups of one head, K4 over the full tower's chunk
    count) against JAX's ``_apply_fused_blocks`` on the same plan, at the
    fp32 block tolerance (2e-4) per block stack; the tower composed over it
    (embed, blocks, ln_post, proj) against the K1 encode."""
    name, b, params, model, cfg, images = narrow
    plan = fast_vit.split_block_plan(cfg, n_groups, NARROW_CHUNKS[name])
    jplan = {**jax_fast_vit._fused_block_plan(b.config, jnp.float32),
             "merge": False, "attn_split": True, "n_groups": n_groups,
             "mlp_whole": False, "mlp_chunks": NARROW_CHUNKS[name]}
    packed = fast_vit.pack_fastest(model, cfg, torch.float32)
    tokens = np.random.default_rng(24).standard_normal(
        (2, 5, cfg.vision_width)).astype(np.float32)
    ref = jax_fast_vit._apply_fused_blocks(
        params["visual"], jnp.asarray(tokens), b.config, jnp.float32,
        start=0, stop=2, plan=jplan, interpret=True)
    bk.reset_launch_counts()
    with torch.no_grad():
        got = fast_vit._apply_fused_blocks(packed, torch.from_numpy(tokens),
                                           plan, start=0, stop=2)
        x = fast_vit._apply_fused_blocks(
            packed, fast_vit._vit_embed(packed, torch.from_numpy(images),
                                        cfg), plan, start=0, stop=2)
        whole = fast_vit._ln(x[:, 0, :], *packed["ln_post"]) @ packed["proj"]
        k1 = fast_vit.vit_encode_block_fused(
            packed, torch.from_numpy(images), cfg, project=True)[1]
    assert not any(bk.launch_counts().values())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(whole.numpy(), k1.numpy(), atol=5e-4,
                               rtol=5e-4)
    with pytest.raises(ValueError, match="divide"):
        fast_vit.split_block_plan(cfg, 3, 1)


def test_int8_tower_matches_jax(narrow):
    """``vit_encode_int8`` (K8 at K = 14 * 14 * 3 = 588, zero-padded to
    592, then K14 per block) against JAX's kernel route in interpret mode,
    at the int8 tower gates; the quantized weights bit for bit."""
    _, b, params, model, cfg, images = narrow
    jq = jax_qv.quantize_vit_params(params, b.config)
    ref = jax_qv.vit_encode_int8(jq, jnp.asarray(images), b.config,
                                 dtype=jnp.float32, impl="pallas",
                                 interpret=True, project=True)
    qp = qv.quantize_vit_params(model, cfg)
    np.testing.assert_array_equal(qp["conv1"]["w8"].numpy(),
                                  np.asarray(jq["conv1"]["w8"]))
    assert qp["conv1"]["w8"].stride() == (1, 592)
    with torch.no_grad():
        got = qv.vit_encode_int8(qp, torch.from_numpy(images), cfg,
                                 dtype=torch.float32, project=True)
    for g, r in zip(got, ref):
        _close_int8(g.numpy(), r)


def test_int8_split_route_matches_jax(narrow):
    """JAX's int8 route for the wide towers (``split_int8_plan``: K13 over
    head groups, the chained K9 -> K10 over 2 hidden slices), per block
    against JAX's composition of the same kernels in interpret mode, at the
    int8 tower gates."""
    _, b, params, model, cfg, images = narrow
    qp = qv.quantize_vit_params(model, cfg)
    plan = qv.split_int8_plan(cfg, 2, 2)
    assert plan["attn_groups"] == 2 and plan["mlp"] == "chained"
    w = cfg.vision_width
    with torch.no_grad():
        tokens = qv.vit_patchify_int8(qp, torch.from_numpy(images), cfg,
                                      torch.float32)
        got = qv.apply_int8_vit_blocks(qp["transformer"], tokens, cfg,
                                       start=0, stop=2, plan=plan)
    x = jnp.asarray(tokens.numpy())
    jq = jax_qv.quantize_vit_params(params, b.config)["transformer"]
    for i in range(2):
        blk = jq[f"resblocks_{i}"]
        ip, op = blk["attn/in_proj"], blk["attn/out_proj"]
        wg, sg, bg, og = jax_qm.regroup_attn_weights(
            ip["w8"], ip["scale"], ip["bias"], op["w8"], 2, 2)
        x = jax_qm.quant_attn_block_split(
            x, wg, sg, bg, og, op["scale"], op["bias"], blk["ln_1"]["scale"],
            blk["ln_1"]["bias"], 2, 2, interpret=True)
        x = jax_qv._chained_int8_mlp(
            x.reshape(-1, w), blk["mlp/c_fc"], blk["mlp/c_proj"],
            blk["ln_2"]["scale"], blk["ln_2"]["bias"], act="gelu_poly",
            n_ch=2, interpret=True).reshape(x.shape)
    _close_int8(got.reshape(-1, w).numpy(), np.asarray(x).reshape(-1, w))
    with pytest.raises(ValueError, match="divide"):
        qv.split_int8_plan(cfg, 3, 2)


# ---------------------------------------------------------------------------
# K8 at K = 588
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1024, 1664])
def test_k8_padded_operands_give_the_plain_result(width):
    """C4: the patch-14 im2col (K = 588) at ViT-L/14's and ViT-bigG/14's
    widths.  The weight's K-major storage carries zero columns 588-591, the
    codes get zeros there (row_quant's group_pad), the scales stay the max
    over the 588 real values: K8 equals the unpadded plain product exactly,
    and JAX's kernel in interpret mode within the fp32 kernel tolerance of
    tests/test_torch_quant_vit.py (1e-5)."""
    rng = np.random.default_rng(width)
    k = 14 * 14 * 3
    x = rng.standard_normal((40, k)).astype(np.float32)
    w8, ws = (np.asarray(a) for a in jax_quant.quantize_weight(
        jnp.asarray(rng.standard_normal((k, width)).astype(np.float32)
                    * k ** -0.5)))
    bias = np.zeros(width, np.float32)
    wv = qm.int8_weight(torch.from_numpy(w8))
    assert wv.shape == (k, width) and wv.stride() == (1, 592)
    op = qm._kmajor(wv, pad_k=True)
    assert op.shape == (width, 592) and op.data_ptr() == wv.data_ptr()
    assert torch.equal(op[:, :k], torch.from_numpy(w8).t())
    assert not op[:, k:].any()
    a8, sa = qm.row_quant(torch.from_numpy(x), group_pad=592)
    assert a8.shape == (40, 592) and not a8[:, k:].any()
    u8, su = qm.row_quant_plain(torch.from_numpy(x))
    assert torch.equal(a8[:, :k], u8) and torch.equal(sa, su)
    got = qm.quant_matmul_fused(torch.from_numpy(x), wv, torch.from_numpy(ws),
                                torch.from_numpy(bias))
    plain = qm.int8_gemm_plain(u8, su, torch.from_numpy(w8).t(),
                               torch.from_numpy(ws), torch.from_numpy(bias),
                               out_dtype=torch.float32)
    assert torch.equal(got, plain)
    ref = jax_qm.quant_matmul_fused(jnp.asarray(x), jnp.asarray(w8),
                                    jnp.asarray(ws), jnp.asarray(bias),
                                    interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_kmajor_pads_only_for_k8():
    """A K-slice (588 of 592 rows) of a wider K-major weight: its padded
    operand is a view whose columns 588-591 hold the wider weight's values,
    which K8's zero codes there cancel, so the product is the unpadded one;
    every other caller gets the [N, 588] copy, which ``int8_gemm`` refuses
    on the card rather than read those columns."""
    rng = np.random.default_rng(588)
    k, n = 588, 96
    wide = torch.from_numpy(rng.integers(-127, 128, (592, n), dtype=np.int8))
    view = qm.int8_weight(wide)[:k]
    assert view.stride() == (1, 592)
    op = qm._kmajor(view, pad_k=True)
    assert op.shape == (n, 592) and op.data_ptr() == view.data_ptr()
    assert torch.equal(op, wide.t()) and op[:, k:].any()
    copy = qm._kmajor(view)
    assert copy.shape == (n, k) and torch.equal(copy, wide[:k].t())
    x = torch.from_numpy(rng.standard_normal((24, k)).astype(np.float32))
    ws = torch.from_numpy(rng.random(n).astype(np.float32) + 0.5)
    bias = torch.zeros(n)
    a8, sa = qm.row_quant(x, group_pad=592)
    u8, su = qm.row_quant_plain(x)
    got = qm.int8_gemm_plain(a8, sa, op, ws, bias, out_dtype=torch.float32)
    want = qm.int8_gemm_plain(u8, su, copy, ws, bias,
                              out_dtype=torch.float32)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the full-size plans (plan functions only)
# ---------------------------------------------------------------------------


def _jax_int8_gates(cfg: JaxConfig, monkeypatch):
    """What JAX's ``apply_int8_vit_blocks`` runs for one block of ``cfg`` at
    S = 257: its kernels are replaced by recorders, so its own gates decide
    without a full-size product.  Returns (K14 merged, K13 groups or 0, MLP
    kind, slices)."""
    seen = {}
    w = cfg.vision_width
    hidden = cfg.vision_mlp_dim or 4 * w

    def rec(key):
        def fn(x, *args, **kw):
            seen[key] = True
            return x
        return fn

    def chained(x2, *args, n_ch, **kw):
        seen["chained"] = n_ch
        return x2

    monkeypatch.setattr(jax_qm, "quant_full_block_fused", rec("full"))
    monkeypatch.setattr(jax_qm, "quant_attn_block_fused", rec("fused"))
    monkeypatch.setattr(jax_qm, "quant_attn_block_split",
                        lambda x, *a, **kw: (seen.update(split=a[9]), x)[1])
    monkeypatch.setattr(jax_qm, "quant_mlp_block_fused", rec("mlp"))
    monkeypatch.setattr(jax_qm, "regroup_attn_weights",
                        lambda *a: (None,) * 4)
    monkeypatch.setattr(jax_qv, "_chained_int8_mlp", chained)
    shape = jnp.zeros((1, 1), jnp.int8)
    blk = {"attn/in_proj": {"w8": shape, "scale": None, "bias": None},
           "attn/out_proj": {"w8": shape, "scale": None, "bias": None},
           "mlp/c_fc": {"w8": jax.ShapeDtypeStruct((w, hidden), jnp.int8),
                        "scale": None, "bias": None},
           "mlp/c_proj": {"w8": shape, "scale": None, "bias": None},
           "ln_1": {"scale": None, "bias": None},
           "ln_2": {"scale": None, "bias": None}}
    jax_qv.apply_int8_vit_blocks({"resblocks_0": blk},
                                 jnp.zeros((1, 257, w), jnp.float32), cfg,
                                 start=0, stop=1)
    return ("full" in seen, seen.get("split", 0),
            "chained" if "chained" in seen else "whole",
            seen.get("chained", 1))


@pytest.mark.parametrize("name", LARGE)
def test_full_size_plans_equal_jax(name, monkeypatch):
    """The explicit plans ``chip_smoke.py`` drives as JAX's routes
    (``JAX_ROUTES``) are JAX's: the bf16 one equals JAX's
    ``_fused_block_plan`` in bf16 field by field, the int8 one what JAX's
    int8 gates pick; the port's own plans stay K1 and K14."""
    cfg, jcfg = CLIP_ARCHS[name], JAX_ARCHS[name]
    route = chip_smoke.JAX_ROUTES[name]
    plan = fast_vit.split_block_plan(cfg, route["groups"], route["chunks"])
    ref = jax_fast_vit._fused_block_plan(jcfg, jnp.bfloat16)
    for key in ("merge", "attn_split", "n_groups", "mlp_whole", "mlp_chunks",
                "heads", "width", "act"):
        assert plan[key] == ref[key], key
    iplan = qv.split_int8_plan(cfg, route["int8_groups"],
                               route["int8_chunks"])
    merged, groups, mlp, slices = _jax_int8_gates(jcfg, monkeypatch)
    assert (iplan["merge"], iplan["attn_groups"], iplan["mlp"],
            iplan["mlp_chunks"]) == (merged, groups, mlp, slices)
    assert fast_vit._fused_block_plan(cfg)["merge"]
    assert qv.int8_block_plan(cfg)["merge"]
    assert chip_smoke.LARGE_MODELS[name] == name.replace("/", "-")
    assert zoo._normalize_openclip_name(chip_smoke.LARGE_MODELS[name]) == name
