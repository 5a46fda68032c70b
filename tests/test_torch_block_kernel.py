"""Plain versions of the block kernels (K1-K5) against the JAX Pallas
kernels run in interpret mode.  The CUDA kernels against their plain
versions on a card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aihab_clip_tpu.ops import block_kernel as jax_bk

from aihab_clip_tpu_torch.ops import block_kernel as bk

B, S, W, HIDDEN = 2, 17, 64, 256
ACTS = ["quick_gelu", "gelu_tanh", "gelu_poly"]


@pytest.fixture(autouse=True)
def _default_gelu_poly(monkeypatch):
    # the JAX gelu_poly form is read from the environment; the port
    # implements its default (deg-5 sigmoid poly)
    monkeypatch.delenv("AIHAB_ERF_IMPL", raising=False)


def _inputs(seed, s=S):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = n(B, s, W)
    params = [1 + n(W, scale=0.1), n(W, scale=0.1),
              n(W, 3 * W, scale=W ** -0.5), n(3 * W, scale=0.1),
              n(W, W, scale=W ** -0.5), n(W, scale=0.1),
              1 + n(W, scale=0.1), n(W, scale=0.1),
              n(W, HIDDEN, scale=W ** -0.5), n(HIDDEN, scale=0.1),
              n(HIDDEN, W, scale=HIDDEN ** -0.5), n(W, scale=0.1)]
    return x, params


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("mlp_chunks", [1, 2])
@pytest.mark.parametrize("heads", [2, 4])
def test_full_block_plain_matches_pallas(heads, mlp_chunks, act):
    x, params = _inputs(1)
    ref = jax_bk.full_block_fused(jnp.asarray(x), *_j(params), heads,
                                  mlp_chunks=mlp_chunks, act=act,
                                  interpret=True)
    out = bk.full_block_fused(torch.from_numpy(x), *_t(params), heads,
                              mlp_chunks=mlp_chunks, act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("padded_io", [False, True])
@pytest.mark.parametrize("heads", [2, 4])
def test_attn_block_plain_matches_pallas(heads, padded_io):
    seq_len = S
    x, params = _inputs(2, s=32 if padded_io else S)
    kw = dict(padded_io=True, seq_len=seq_len) if padded_io else {}
    ref = jax_bk.attn_block_fused(jnp.asarray(x), *_j(params[:6]), heads,
                                  interpret=True, **kw)
    out = bk.attn_block_fused(torch.from_numpy(x), *_t(params[:6]), heads,
                              **kw)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy()[:, :seq_len],
                               np.asarray(ref)[:, :seq_len], atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("act", ACTS)
def test_mlp_block_plain_matches_pallas(act):
    x, params = _inputs(3)
    x2 = x.reshape(B * S, W)
    ref = jax_bk.mlp_block_fused(jnp.asarray(x2), *_j(params[6:]),
                                 interpret=True, tile_m=16, act=act)
    out = bk.mlp_block_fused(torch.from_numpy(x2), *_t(params[6:]), act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)


def test_plain_act_matches_jax():
    h = np.linspace(-12, 12, 4001, dtype=np.float32)
    for act in ACTS:
        ref = np.asarray(jax_bk._act_f32(jnp.asarray(h), act))
        out = bk.act_f32(torch.from_numpy(h), act).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


def test_bf16_plain_rounds_like_the_tpu_kernel():
    """bf16 operands: the plain K1 stays within bf16 resolution of the JAX
    kernel (both round qkv, attention and h to bf16; y1 stays fp32)."""
    x, params = _inputs(4)
    xb = x.astype(jnp.bfloat16)
    pj = [jnp.asarray(p, jnp.bfloat16) if p.ndim == 2 else jnp.asarray(p)
          for p in params]
    ref = np.asarray(jax_bk.full_block_fused(jnp.asarray(xb), *pj, 2,
                                             interpret=True), np.float32)
    pt = [torch.from_numpy(p).bfloat16() if p.ndim == 2 else torch.from_numpy(p)
          for p in params]
    out = bk.full_block_fused(torch.from_numpy(np.asarray(xb, np.float32))
                              .bfloat16(), *pt, 2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.05, rtol=0.02)


def test_cpu_calls_count_no_launch():
    bk.reset_launch_counts()
    x, params = _inputs(5)
    bk.full_block_fused(torch.from_numpy(x), *_t(params), 2)
    assert all(v == 0 for v in bk.launch_counts().values())


def test_block_argument_checks():
    x, params = _inputs(6)
    with pytest.raises(ValueError, match="activation"):
        bk.full_block_fused(torch.from_numpy(x), *_t(params), 2, act="relu")
    with pytest.raises(ValueError, match="mlp_chunks"):
        bk.full_block_fused(torch.from_numpy(x), *_t(params), 2, mlp_chunks=3)
    with pytest.raises(ValueError, match="seq_len"):
        bk.attn_block_fused(torch.from_numpy(x), *_t(params[:6]), 2,
                            padded_io=True)


# ---------------------------------------------------------------------------
# K5 attn_block_split and K4 mlp_block_split (the SigLIP path)


def _split_attn_inputs(seed, head_dim, heads=2, s=37, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = heads * head_dim

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = n(2, s, w)
    wqkv, bqkv = n(w, 3 * w, scale=w ** -0.5), n(3 * w, scale=0.1)
    wout, bout = n(w, w, scale=w ** -0.5), n(w, scale=0.1)
    ln = (1 + n(w, scale=0.1), n(w, scale=0.1))
    if dtype != np.float32:   # values exactly representable in bf16
        x, wqkv, wout = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                         for a in (x, wqkv, wout))
    return x, wqkv, bqkv, wout, bout, ln


def _jax_split_attn(x, wqkv, bqkv, wout, bout, ln, heads, n_groups, dt, **kw):
    wg, bg, og = jax_bk.regroup_attn_weights_f(
        jnp.asarray(wqkv, dt), jnp.asarray(bqkv), jnp.asarray(wout, dt),
        heads, n_groups)
    out = jax_bk.attn_block_split(jnp.asarray(x, dt), wg, bg, og,
                                  jnp.asarray(bout), *_j(ln), heads, n_groups,
                                  ln_eps=1e-6, interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port_split_attn(x, wqkv, bqkv, wout, bout, ln, heads, n_groups, dt,
                     **kw):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt)

    wg, bg, og = bk.regroup_attn_weights_f(t(wqkv), torch.from_numpy(bqkv),
                                           t(wout), heads, n_groups)
    return bk.attn_block_split(t(x), wg, bg, og, torch.from_numpy(bout),
                               *_t(ln), heads, n_groups, ln_eps=1e-6, **kw)


@pytest.mark.parametrize("seq", ["ragged", "padded_io"])
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("head_dim", [32, 72])
def test_attn_block_split_plain_matches_pallas(head_dim, n_groups, seq):
    """K5 in fp32 against the Pallas kernel in interpret mode: S=37 (no
    multiple of 16), or a 48-row padded input holding 37 real tokens."""
    padded = seq == "padded_io"
    args = _split_attn_inputs(7, head_dim, s=48 if padded else 37)
    kw = dict(padded_io=True, seq_len=37) if padded else {}
    ref = _jax_split_attn(*args, 2, n_groups, jnp.float32, **kw)
    out = _port_split_attn(*args, 2, n_groups, torch.float32, **kw)
    assert out.shape == args[0].shape
    np.testing.assert_allclose(out.numpy()[:, :37], ref[:, :37], atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("n_groups", [1, 2, 4])
def test_regroup_matches_jax_exactly(n_groups):
    x, wqkv, bqkv, wout, _, _ = _split_attn_inputs(8, 72, heads=4)
    ref = jax_bk.regroup_attn_weights_f(jnp.asarray(wqkv), jnp.asarray(bqkv),
                                        jnp.asarray(wout), 4, n_groups)
    out = bk.regroup_attn_weights_f(*_t([wqkv, bqkv, wout]), 4, n_groups)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _split_mlp_inputs(seed, w=144, hidden=344, m=37):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [n(m, w), 1 + n(w, scale=0.1), n(w, scale=0.1),
            n(w, hidden, scale=w ** -0.5), n(hidden, scale=0.1),
            n(hidden, w, scale=hidden ** -0.5), n(w, scale=0.1)]


@pytest.mark.parametrize("f32_partial", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_mlp_block_split_plain_matches_pallas(n_chunks, f32_partial):
    """K4 in fp32, gelu_tanh, eps 1e-6, hidden 344 (no multiple of 128)."""
    args = _split_mlp_inputs(9)
    ref = jax_bk.mlp_block_split(*_j(args), n_chunks=n_chunks,
                                 act="gelu_tanh", ln_eps=1e-6, interpret=True,
                                 f32_partial=f32_partial)
    out = bk.mlp_block_split(*_t(args), n_chunks=n_chunks, act="gelu_tanh",
                             ln_eps=1e-6, tile_m=128, f32_partial=f32_partial)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)


def _bf16_ulp(ref):
    """The spacing of bf16 numbers at |ref| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_bf16_attn_block_split_rounds_like_the_tpu_kernel():
    """bf16 K5 at head_dim 72 against the JAX kernel in bf16: the q-scale
    before q's rounding, P normalised before its cast and the fp32 group
    sum put the plain version within 1 bf16 ulp of the TPU kernel; the
    CUDA kernel's order (1/sum on the output rows) does not."""
    args = _split_attn_inputs(10, 72, dtype="bf16")
    ref = _jax_split_attn(*args, 2, 2, jnp.bfloat16)
    out = _port_split_attn(*args, 2, 2, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    d = np.abs(out.float().numpy() - ref)
    assert (d <= _bf16_ulp(ref)).all(), d.max()
    x = torch.from_numpy(args[0]).bfloat16()
    flat = bk._split_layouts(x, *bk.regroup_attn_weights_f(
        torch.from_numpy(args[1]).bfloat16(), torch.from_numpy(args[2]),
        torch.from_numpy(args[3]).bfloat16(), 2, 2), 2, 2)
    rows = bk._attn_split(bk._PLAIN, x, *flat, torch.from_numpy(args[4]),
                          *_t(args[5]), 2, 1, 37, 1e-6).float().numpy()
    assert (np.abs(rows - ref) > _bf16_ulp(ref)).any()


def test_bf16_mlp_block_split_rounds_like_the_tpu_kernel():
    """bf16 K4 (2 chunks, partial in bf16 between them) against the JAX
    kernel in bf16: within 2 bf16 ulps (an fp32 sum taken in another
    order can land on the other side of a rounding boundary, and the
    chunk-0 partial then carries that ulp into chunk 1)."""
    args = _split_mlp_inputs(11)
    bf = [jnp.asarray(a, jnp.bfloat16) if i in (0, 3, 5) else jnp.asarray(a)
          for i, a in enumerate(args)]
    ref = np.asarray(jax_bk.mlp_block_split(
        *bf, n_chunks=2, act="gelu_tanh", ln_eps=1e-6,
        interpret=True).astype(jnp.float32))
    pt = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()
          if i in (0, 3, 5) else torch.from_numpy(args[i])
          for i, a in enumerate(bf)]
    out = bk.mlp_block_split(*pt, n_chunks=2, act="gelu_tanh", ln_eps=1e-6)
    assert out.dtype == torch.bfloat16
    d = np.abs(out.float().numpy() - ref)
    assert (d <= 2 * _bf16_ulp(ref)).all(), d.max()


def test_split_argument_checks():
    args = _split_mlp_inputs(12)
    with pytest.raises(ValueError, match="n_chunks"):
        bk.mlp_block_split(*_t(args), n_chunks=3)
    with pytest.raises(ValueError, match="activation"):
        bk.mlp_block_split(*_t(args), act="relu")
    x, wqkv, bqkv, wout, bout, ln = _split_attn_inputs(13, 72, heads=4)
    with pytest.raises(ValueError, match="n_groups"):
        bk.attn_block_split(*_t([x, wqkv, bqkv, wout, bout, *ln]), 4, 3)
    with pytest.raises(ValueError, match="seq_len"):
        _port_split_attn(*_split_attn_inputs(13, 72, s=48), 2, 1,
                         torch.float32, padded_io=True)
    bk.reset_launch_counts()
    bk.mlp_block_split(*_t(args), n_chunks=2)
    _port_split_attn(*_split_attn_inputs(14, 72), 2, 2, torch.float32)
    assert all(v == 0 for v in bk.launch_counts().values())
