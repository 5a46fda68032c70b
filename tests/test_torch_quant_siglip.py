"""The int8 SigLIP tower of the port against the JAX package on the same
weights, carried over by the weight carry: the quantized weights bit for bit,
the int8 encode (K8, K13, K9, K10 plain versions; JAX: Pallas in interpret
mode) and the int8 frozen prefix of the PEFT step's hybrid encode.  The
engine and the train loss: ``tests/test_torch_quant_serving.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.models import fast_siglip as jax_fast
from aihab_clip_tpu.models import quant_siglip as jax_qs
from aihab_clip_tpu.models import siglip as jax_siglip

from aihab_clip_tpu_torch.models import SigLIPConfig, fast_siglip
from aihab_clip_tpu_torch.models import quant_siglip as qs
from aihab_clip_tpu_torch.ops import quant_matmul as qm

from test_torch_peft import _port_model

# 16 heads of 8: two head groups in the encode (8 heads each), four in the
# PEFT prefix (4 each); a hidden width that is no multiple of 128
TOWER = dict(embed_dim=128, image_resolution=32, patch_size=8,
             vision_width=128, vision_layers=2, vision_heads=16,
             vision_mlp_dim=344, context_length=16, vocab_size=49408,
             text_width=64, text_layers=1, text_heads=2, text_mlp_dim=128)
# the tower gates against interpret mode: per-image cosine and max|d| over
# max|ref|.  In bf16 each kernel's output is rounded in both packages, and a
# sum on the other side of a rounding boundary moves a value by one bf16 ulp
# (measured: 2 ulps of the largest feature, 7.8e-3 of max|ref|)
GATES = {"float32": (0.9999, 5e-3), "bfloat16": (0.9999, 2 ** -6)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, so the CPU's fp32 sums (and the int8 codes
    rounded from them) do not depend on the machine's core count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tower():
    """(JAX config, noisy JAX params, port model, images)."""
    jcfg = jax_siglip.SigLIPConfig(**TOWER)
    params = jax.jit(jax_siglip.SigLIPModel(jcfg).init)(
        jax.random.key(11), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 16), jnp.int32))["params"]
    rng = np.random.default_rng(12)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    model = _port_model(params, SigLIPConfig(**TOWER))
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
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
    """Every int8 code and scale of ``quantize_siglip_params`` equals the JAX
    package's on the carried fp32 weights, the regrouped K13 tensors too."""
    jcfg, params, model, _ = tower
    cfg = SigLIPConfig(**TOWER)
    ref = jax_qs.quantize_siglip_params(params, jcfg)
    got = qs.quantize_siglip_params(model, cfg)
    assert fast_siglip.siglip_attn_groups(cfg) == 2
    for key in ("w8", "scale", "bias"):
        np.testing.assert_array_equal(got["conv1"][key].numpy(),
                                      np.asarray(ref["conv1"][key]))
    for i in range(cfg.vision_layers):
        g, r = (t["transformer"][f"resblocks_{i}"] for t in (got, ref))
        for name in ("attn/qkv", "attn/out_proj", "mlp/c_fc", "mlp/c_proj",
                     "attn/qkv_g", "ln_1", "ln_2"):
            assert set(g[name]) == set(r[name]), name
            for key, want in r[name].items():
                np.testing.assert_array_equal(g[name][key].numpy(),
                                              np.asarray(want),
                                              err_msg=f"{i} {name}/{key}")
        # the int8 weights live K-major: the kernels read them in place
        assert g["mlp/c_fc"]["w8"].t().is_contiguous()
        assert qm._qkv_operand(g["attn/qkv_g"]["w8_g"]).data_ptr() == \
            g["attn/qkv_g"]["w8_g"].data_ptr()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_tower_matches_jax(tower, dtype):
    """The int8 encode through the plain K8/K13/K9/K10 against JAX's kernel
    path in interpret mode (``GATES``; measured in fp32: cosine 1 - 1e-13,
    max|d| 4.7e-7 of max|ref|; in bf16: 0.99997, 7.8e-3), and against JAX's
    ``impl="xla"`` reference (cosine >= 0.99, ``tests/test_quant.py:361-382``;
    measured 0.99997 in fp32, 0.99991 in bf16)."""
    jcfg, params, model, images = tower
    cfg = SigLIPConfig(**TOWER)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq = jax_qs.quantize_siglip_params(params, jcfg)
    ref = jax_qs.siglip_encode_int8(jq, params, jnp.asarray(images), jcfg,
                                    dtype=jdt, impl="pallas",
                                    attn_impl="split", interpret=True)
    xla = jax_qs.siglip_encode_int8(jq, params, jnp.asarray(images), jcfg,
                                    dtype=jdt, impl="xla")
    qm.reset_launch_counts()
    with torch.no_grad():
        got = qs.siglip_encode_int8(qs.quantize_siglip_params(model, cfg),
                                    model, torch.from_numpy(images), cfg,
                                    dtype=tdt)
    assert got.dtype == tdt and not any(qm.launch_counts().values())
    _close_tower(got.float().numpy(), ref, dtype)
    assert _cos(got.float().numpy(), xla).min() >= 0.99


def test_int8_tower_refuses_other_routes(tower):
    _, _, model, images = tower
    cfg = SigLIPConfig(**TOWER)
    with pytest.raises(NotImplementedError, match="pallas"):
        qs.siglip_encode_int8({}, model, torch.from_numpy(images), cfg,
                              impl="xla")


# ---------------------------------------------------------------------------
# the int8 frozen prefix of the PEFT step
# ---------------------------------------------------------------------------


def test_hybrid_int8_prefix_matches_jax(tower):
    """Block 0 through the int8 plain versions without a graph (JAX:
    interpret-mode Pallas behind ``stop_gradient``), block 1 and the MAP
    head canonical, at the fp32 tower gates (measured: cosine 1 - 1e-13,
    max|d| 4.7e-7 of max|ref|); no gradient reaches the prefix."""
    jcfg, params, model, images = tower
    cfg = SigLIPConfig(**TOWER)
    n_groups = fast_siglip.siglip_attn_groups(cfg, hybrid=True)
    assert n_groups == 4
    jq = {"resblocks_0": jax_qs.quantize_siglip_block(
        params["visual"]["transformer"]["resblocks_0"], 16, n_groups)}
    ref = jax_fast.siglip_encode_hybrid(params, jnp.asarray(images), jcfg, 1,
                                        dtype=jnp.float32, interpret=True,
                                        qprefix=jq)
    qprefix = {"resblocks_0": qs.quantize_siglip_block(
        model.visual.transformer.resblocks[0], 16, n_groups)}
    model.zero_grad(set_to_none=True)
    got = fast_siglip.siglip_encode_hybrid(model, torch.from_numpy(images),
                                           cfg, 1, dtype=torch.float32,
                                           qprefix=qprefix)
    _close_tower(got.detach().numpy(), ref)
    got.sum().backward()
    for name, p in model.named_parameters():
        reached = p.grad is not None
        assert reached == name.startswith(("visual.transformer.resblocks.1.",
                                           "visual.ln_post",
                                           "visual.attnpool")), name
    model.zero_grad(set_to_none=True)
