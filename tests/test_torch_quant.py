"""The int8 ops of the port against the JAX package: host quantization
(``ops/quant.py``) bit for bit, and the plain versions of K8, K9, K10 and K13
(``ops/quant_matmul.py``) against the Pallas kernels in interpret mode.  The
CUDA kernels against their plain versions on a card:
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aihab_clip_tpu.ops import quant as jax_quant
from aihab_clip_tpu.ops import quant_matmul as jax_qm

from aihab_clip_tpu_torch.ops import quant, quant_matmul as qm

ACTS = ["none", "quick_gelu", "gelu_tanh", "gelu_poly"]


@pytest.fixture(autouse=True)
def _default_gelu_poly(monkeypatch):
    # the JAX gelu_poly form is read from the environment; the port
    # implements its default (deg-5 sigmoid poly)
    monkeypatch.delenv("AIHAB_ERF_IMPL", raising=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: CPU matmuls sum in an order that depends on the
    thread count, and an fp32 sum that lands on the other side of a bf16 or
    int8 rounding boundary moves K13's output by ~5e-3 (measured at two
    threads), far above the 1e-4 held here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return rng, n


def _weights(n, k, cols):
    w8, ws = jax_quant.quantize_weight(jnp.asarray(n(k, cols, scale=k ** -0.5)))
    return np.asarray(w8), np.asarray(ws)


def _t(*arrs):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrs]


def _codes_agree(got8, want8, min_equal=0.999):
    """int8 codes: equal in >= 99.9% of entries, never more than 1 apart
    (a flip is an fp32 sum on the other side of a rounding boundary)."""
    d = np.abs(got8.astype(np.int32) - want8.astype(np.int32))
    assert d.max() <= 1
    assert (d == 0).mean() >= min_equal
    return (d == 0).mean()


# ---------------------------------------------------------------------------
# host quantization
# ---------------------------------------------------------------------------


def test_quantize_weight_and_activation_bit_identical():
    _, n = _rng(0)
    w = n(96, 344) * np.linspace(0.01, 3, 344, dtype=np.float32)
    w[:, 7] = 0.0                                  # an all-zero channel
    w8, ws = quant.quantize_weight(torch.from_numpy(w))
    jw8, jws = jax_quant.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    x = n(37, 96, scale=4.0)
    x8, sx = quant.quantize_activation(torch.from_numpy(x))
    jx8, jsx = jax_quant.quantize_activation(jnp.asarray(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("act", [None, "quick_gelu", "gelu_tanh", "gelu"])
def test_quant_dense_matches_jax(act):
    _, n = _rng(1)
    x = n(20, 64)
    w8, ws = _weights(n, 64, 48)
    b = n(48, scale=0.1)
    out = quant.quant_dense(*_t(x, w8, ws, b), act=act)
    ref = jax_quant.quant_dense(*(jnp.asarray(a) for a in (x, w8, ws, b)),
                                act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_int_matmul_is_exact():
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (9, 4304), dtype=np.int8)
    b = np.full((4304, 3), 127, np.int8)
    a[0] = 127                        # 127^2 * 4304 = 6.9e7 > 2^24
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = quant.int_matmul(*_t(a, b))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# ---------------------------------------------------------------------------
# K8, K9, K10: plain versions vs interpret-mode Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("ln,res", [(False, False), (True, False),
                                    (False, True), (True, True)])
def test_quant_matmul_fused_plain_matches_pallas(ln, res, act, dtype):
    _, n = _rng(3)
    m, k, cols = 40, 96, 160
    x = n(m, k, scale=2.0)
    w8, ws = _weights(n, k, cols)
    b = n(cols, scale=0.1)
    lns, lnb = (1 + n(k, scale=0.1), n(k, scale=0.1)) if ln else (None, None)
    r = n(m, cols) if res else None
    jdt = getattr(jnp, dtype)
    ref = jax_qm.quant_matmul_fused(
        jnp.asarray(x, jdt), jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(b),
        act=act, residual=None if r is None else jnp.asarray(r, jdt),
        ln_scale=None if lns is None else jnp.asarray(lns),
        ln_bias=None if lnb is None else jnp.asarray(lnb), interpret=True)
    tdt = getattr(torch, dtype)
    xt, rt = _t(x, r)
    out = qm.quant_matmul_fused(
        xt.to(tdt), *_t(w8, ws, b), act=act,
        residual=None if rt is None else rt.to(tdt),
        ln_scale=None if lns is None else torch.from_numpy(lns),
        ln_bias=None if lnb is None else torch.from_numpy(lnb))
    assert out.dtype == tdt and out.shape == (m, cols)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    else:   # the same fp32 values, each rounded once to bf16
        np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2,
                                   rtol=2 ** -8)


def test_quant_matmul_fused_rejects_unknown_act():
    with pytest.raises(ValueError, match="unknown activation"):
        qm.quant_matmul_fused(torch.zeros(2, 16), torch.zeros(16, 8,
                                                             dtype=torch.int8),
                              torch.ones(8), torch.zeros(8), act="relu")


@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_fused_qout_plain_matches_pallas(dtype, act):
    """N = 344, no multiple of 128: the requantize spans the whole row."""
    _, n = _rng(4)
    m, k, cols = 64, 128, 344
    x = n(m, k, scale=2.0)
    w8, ws = _weights(n, k, cols)
    b, lns, lnb = n(cols, scale=0.1), 1 + n(k, scale=0.1), n(k, scale=0.1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref8, refs = jax_qm.quant_matmul_fused_qout(
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in (w8, ws, b, lns, lnb)),
        act=act, ln_eps=1e-6, interpret=True)
    y8, ys = qm.quant_matmul_fused_qout(
        torch.from_numpy(x).to(tdt), *_t(w8, ws, b, lns, lnb), act=act,
        ln_eps=1e-6)
    assert y8.dtype == torch.int8 and tuple(ys.shape) == (m, 1)
    _codes_agree(y8.numpy(), np.asarray(ref8))
    np.testing.assert_allclose(ys.numpy(), np.asarray(refs), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("res_dtype", ["float32", "bfloat16"])
def test_quant_matmul_q8in_plain_matches_pallas(res_dtype):
    """Identical int8 inputs: only the dequant epilogue's fp32 rounding
    remains (K = 4304 sums past 2^24 are exact through float64)."""
    rng, n = _rng(5)
    m, k, cols = 48, 4304, 96
    x8 = rng.integers(-127, 128, (m, k), dtype=np.int8)
    xs = np.abs(n(m, 1)) * 0.01 + 1e-3
    w8, ws = _weights(n, k, cols)
    b = n(cols, scale=0.1)
    r = n(m, cols)
    jdt, tdt = getattr(jnp, res_dtype), getattr(torch, res_dtype)
    ref = jax_qm.quant_matmul_q8in(
        *(jnp.asarray(a) for a in (x8, xs, w8, ws, b)),
        jnp.asarray(r, jdt), interpret=True)
    out = qm.quant_matmul_q8in(*_t(x8, xs, w8, ws, b),
                               torch.from_numpy(r).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# K13 and its weight regrouping
# ---------------------------------------------------------------------------


def _k13_inputs(seed, b, s, heads, d, n_groups):
    _, n = _rng(seed)
    w = heads * d
    x = n(b, s, w)
    wqkv8, sqkv = _weights(n, w, 3 * w)
    wout8, sout = _weights(n, w, w)
    bqkv, bout = n(3 * w, scale=0.1), n(w, scale=0.1)
    lns, lnb = 1 + n(w, scale=0.1), n(w, scale=0.1)
    grouped = [np.asarray(t) for t in jax_qm.regroup_attn_weights(
        jnp.asarray(wqkv8), jnp.asarray(sqkv), jnp.asarray(bqkv),
        jnp.asarray(wout8), heads, n_groups)]
    return x, (wqkv8, sqkv, bqkv, wout8), grouped + [sout, bout, lns, lnb]


@pytest.mark.parametrize("heads,d,n_groups", [(2, 72, 1), (4, 72, 2),
                                              (8, 16, 4)])
def test_regroup_attn_weights_matches_jax(heads, d, n_groups):
    _, packed, grouped = _k13_inputs(6, 1, 1, heads, d, n_groups)
    got = qm.regroup_attn_weights(*_t(*packed), heads, n_groups)
    for g, want in zip(got, grouped[:4]):
        np.testing.assert_array_equal(g.numpy(), want)
    # the kernels' storage, seen through JAX's shapes
    qkv, out = qm.int8_attn_weights(got[0], got[3])
    np.testing.assert_array_equal(qkv.numpy(), grouped[0])
    np.testing.assert_array_equal(out.numpy(), grouped[3])
    assert qm._qkv_operand(qkv).data_ptr() == qkv.data_ptr()
    pad = qm._out_operand(out)
    assert pad.data_ptr() == out.data_ptr() and pad.shape[1] % 32 == 0
    np.testing.assert_array_equal(pad.numpy(), qm._out_operand(
        got[3].contiguous()).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded_io", [False, True])
@pytest.mark.parametrize("heads,d,n_groups", [(2, 72, 1), (4, 72, 2),
                                              (8, 16, 4)])
def test_quant_attn_block_split_plain_matches_pallas(heads, d, n_groups,
                                                     padded_io, dtype):
    """n_groups 1, 2, 4; head_dim 72 and 16; a ragged S (37 real tokens in
    a 48 pad) with ``padded_io``.  Measured max|d|: fp32 2.4e-7 in every
    case (limit 1e-4); bf16 0, or 9.8e-4 in one case, one output rounded to
    the neighbouring bf16 value (limit 2^-8 max|y|)."""
    s = 48 if padded_io else 37
    x, _, args = _k13_inputs(7, 2, s, heads, d, n_groups)
    kw = dict(padded_io=True, seq_len=37) if padded_io else {}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_qm.quant_attn_block_split(
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in args), heads,
        n_groups, ln_eps=1e-6, interpret=True, **kw)
    out = qm.quant_attn_block_split(torch.from_numpy(x).to(tdt), *_t(*args),
                                    heads, n_groups, ln_eps=1e-6, **kw)
    assert out.dtype == tdt and out.shape == x.shape
    ref = np.asarray(ref, np.float32)
    valid = slice(0, 37)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy()[:, valid], ref[:, valid],
                                   atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(out.float().numpy()[:, valid],
                                   ref[:, valid],
                                   atol=2 ** -8 * np.abs(ref).max(), rtol=0)


def test_quant_attn_block_split_argument_checks():
    x, _, args = _k13_inputs(8, 1, 20, 4, 16, 2)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="must divide heads"):
        qm.quant_attn_block_split(xt, *_t(*args), 4, 3)
    with pytest.raises(ValueError, match="requires seq_len"):
        qm.quant_attn_block_split(xt, *_t(*args), 4, 2, padded_io=True)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.quant_attn_block_split(xt, *_t(*args), 4, 2, padded_io=True,
                                  seq_len=20)


def test_cpu_calls_count_no_launch():
    qm.reset_launch_counts()
    _, n = _rng(9)
    w8, ws = _weights(n, 32, 16)
    qm.quant_matmul_fused(torch.from_numpy(n(4, 32)), *_t(w8, ws, n(16)))
    assert all(v == 0 for v in qm.launch_counts().values())
