"""Plain versions of the block kernels (K1-K3) against the JAX Pallas
kernels run in interpret mode, and — on a card — each CUDA kernel against
its plain version."""

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


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    w, heads, hidden = 128, 2, 512

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def close(out, ref, rel):
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        assert ((out - ref).norm() / ref.norm()).item() <= rel

    x = rnd(3, 80, w)
    p = [1 + rnd(w, scale=0.1, dtype=torch.float32),
         rnd(w, scale=0.1, dtype=torch.float32),
         rnd(w, 3 * w, scale=w ** -0.5), rnd(3 * w, scale=0.1, dtype=torch.float32),
         rnd(w, w, scale=w ** -0.5), rnd(w, scale=0.1, dtype=torch.float32),
         1 + rnd(w, scale=0.1, dtype=torch.float32),
         rnd(w, scale=0.1, dtype=torch.float32),
         rnd(w, hidden, scale=w ** -0.5),
         rnd(hidden, scale=0.1, dtype=torch.float32),
         rnd(hidden, w, scale=hidden ** -0.5),
         rnd(w, scale=0.1, dtype=torch.float32)]
    x2 = x.reshape(-1, w)
    for act in ("none",) + tuple(ACTS):
        for xin in (x2, x2.float()):
            close(bk.ln_gemm(xin, *p[:4], act=act),
                  bk.ln_gemm_plain(xin, *p[:4], act=act), 2e-3)
    for res in (x2, x2.float()):
        for odt in (torch.bfloat16, torch.float32):
            close(bk.gemm_residual(x2, p[4], p[5], res, out_dtype=odt),
                  bk.gemm_residual_plain(x2, p[4], p[5], res, out_dtype=odt),
                  2e-3)
    qkv = rnd(3, 80, 3 * w, scale=2.0)
    for seq_len in (80, 70):
        close(bk.attention(qkv, heads, seq_len)[:, :seq_len],
              bk.attention_plain(qkv, heads, seq_len)[:, :seq_len], 5e-3)
    close(bk.full_block_fused(x, *p, heads),
          bk.full_block_fused_plain(x, *p, heads), 1e-2)
    close(bk.attn_block_fused(x, *p[:6], heads),
          bk.attn_block_fused_plain(x, *p[:6], heads), 1e-2)
    close(bk.mlp_block_fused(x2, *p[6:]), bk.mlp_block_fused_plain(x2, *p[6:]),
          1e-2)
