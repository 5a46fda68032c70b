"""The port's fused attention (K6) plain versions against the JAX package:
the forward against ``_pallas_attention`` (interpret mode) and
``_xla_attention``, the backward against ``_pallas_attention_bwd``
(interpret mode) and ``jax.grad`` of ``_xla_attention``, the autograd
Function against the JAX custom VJP, bf16 rounding against the TPU kernel,
and the dispatch.  The CUDA kernels against these plain versions on a card:
``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.ops import attention as jax_att

from aihab_clip_tpu_torch.ops import attention as att

# (batch, seq, heads, head_dim): full and ragged 64-key tiles, head_dim 72
CASES = [(2, 64, 2, 64), (2, 100, 2, 64), (2, 197, 2, 64), (2, 100, 2, 72)]


def _inputs(seed, b, s, heads, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, heads * d)).astype(np.float32)
            for _ in range(4)]                               # q, k, v, g


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _bf16(arrs):
    """(JAX bf16 arrays, the same values as torch bf16 tensors)."""
    jb = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    return jb, [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                for a in jb]


def _bf16_ulp(ref):
    """The spacing of bf16 numbers at |ref| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("b,s,heads,d", CASES)
def test_forward_plain_matches_pallas_and_xla(b, s, heads, d):
    q, k, v, _ = _inputs(s + d, b, s, heads, d)
    out = att.fused_attention_plain(*_t([q, k, v]), heads).numpy()
    ref = jax_att._pallas_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), heads, interpret=True)
    xla = jax_att._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), heads)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(xla), atol=2e-5)


@pytest.mark.parametrize("b,s,heads,d", CASES)
def test_backward_plain_matches_pallas_and_xla(b, s, heads, d):
    q, k, v, g = _inputs(2 * s + d, b, s, heads, d)
    grads = att.fused_attention_bwd_plain(*_t([q, k, v, g]), heads)
    ref = jax_att._pallas_attention_bwd(*map(jnp.asarray, (q, k, v, g)),
                                        heads, interpret=True)
    _, vjp = jax.vjp(lambda a, b_, c: jax_att._xla_attention(a, b_, c, heads),
                     *map(jnp.asarray, (q, k, v)))
    xla = vjp(jnp.asarray(g))
    for got, r, x in zip(grads, ref, xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=3e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(x), atol=3e-5)


@pytest.mark.parametrize("d", [64, 72])
def test_autograd_function_matches_the_custom_vjp(d):
    """``fused_attention`` on CPU tensors (the wrappers' plain versions)
    against JAX ``fused_attention`` with its custom VJP, interpret mode."""
    b, s, heads = 2, 100, 2
    q, k, v, g = _inputs(d, b, s, heads, d)
    out, vjp = jax.vjp(
        lambda a, b_, c: jax_att.fused_attention(a, b_, c, heads, True),
        *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (t.requires_grad_() for t in _t([q, k, v]))
    before = att.launch_counts()
    y = att.fused_attention(tq, tk, tv, heads)
    y.backward(torch.from_numpy(g))
    assert att.launch_counts() == before       # CPU: no kernel launch
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), atol=2e-5)
    for got, r in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=3e-5)


def test_forward_wrapper_returns_the_row_logsumexp():
    q, k, v, _ = _inputs(5, 2, 100, 2, 72)
    out, lse = att.fused_attention_fwd(*_t([q, k, v]), 2)
    assert lse.shape == (2, 2, 100) and lse.dtype == torch.float32
    torch.testing.assert_close(out, att.fused_attention_plain(
        *_t([q, k, v]), 2), rtol=0, atol=0)
    qh = q.reshape(2, 100, 2, 72).transpose(0, 2, 1, 3)
    kh = k.reshape(2, 100, 2, 72).transpose(0, 2, 1, 3)
    scores = qh @ kh.transpose(0, 1, 3, 2) / np.sqrt(72.0)
    m = scores.max(-1, keepdims=True)
    ref = (m + np.log(np.exp(scores - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,s,heads,d", [(2, 100, 2, 72), (2, 197, 2, 64)])
def test_bf16_plain_rounds_like_the_tpu_kernels(b, s, heads, d, seed):
    """bf16 inputs through the plain versions and the interpret-mode Pallas
    kernels in bf16: every output within 1 bf16 ulp of the tensor's largest
    magnitude (measured: <= 0.5 at these seeds; an fp32 sum taken in
    another order lands on the other side of a rounding boundary, and near
    zero, where the products cancel, one such flip is many ulps of the
    element itself)."""
    jb, tb = _bf16(_inputs(seed, b, s, heads, d))
    ref = np.asarray(jax_att._pallas_attention(*jb[:3], heads, interpret=True)
                     .astype(jnp.float32))
    out = att.fused_attention_plain(*tb[:3], heads)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= \
        _bf16_ulp(np.abs(ref).max())
    ref_grads = jax_att._pallas_attention_bwd(*jb, heads, interpret=True)
    for got, r in zip(att.fused_attention_bwd_plain(*tb, heads), ref_grads):
        r = np.asarray(r.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        assert np.abs(got.float().numpy() - r).max() <= \
            _bf16_ulp(np.abs(r).max())


def test_bf16_kernel_row_term_costs_about_one_ulp_relative():
    """The CUDA backward's row term, rowsum(dO * O) over the bf16 forward
    output, against the TPU kernel's rowsum(dp * p): dv does not use it and
    is unchanged; dq and dk move by ~2e-3 relative L2 (one bf16 ulp is
    2^-9 = 1.95e-3 relative) at the test's seed."""
    jb, tb = _bf16(_inputs(11, 2, 100, 2, 72))
    ref_grads = [np.asarray(r.astype(jnp.float32)) for r in
                 jax_att._pallas_attention_bwd(*jb, 2, interpret=True)]
    out = att.fused_attention_plain(*tb[:3], 2)
    grads = att.fused_attention_bwd_plain(*tb, 2, out=out)
    rel = [np.linalg.norm(g.float().numpy() - r) / np.linalg.norm(r)
           for g, r in zip(grads, ref_grads)]
    assert rel[0] < 4e-3 and rel[1] < 4e-3
    assert rel[2] <= 1e-6


def test_dispatch_on_cpu_takes_plain_math_and_matches_jax():
    """``attention()`` on CPU tensors takes plain math at any S (the JAX
    dispatch on a CPU backend takes XLA), including S in the kernel window
    and causal masks; no kernel launches."""
    rng = np.random.default_rng(0)
    before = att.launch_counts()
    for s, causal in ((600, False), (64, False), (64, True)):
        q, k, v = (rng.standard_normal((1, s, 144)).astype(np.float32)
                   for _ in range(3))
        out = att.attention(*_t([q, k, v]), 2, causal=causal)
        ref = jax_att.attention(*map(jnp.asarray, (q, k, v)), 2,
                                causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert att.launch_counts() == before


@pytest.mark.parametrize("kw,x", [
    ({}, torch.zeros(1, 600, 144)),                           # CPU tensor
    ({"causal": True}, torch.zeros(1, 600, 144)),
    ({}, torch.zeros(1, 600, 64, dtype=torch.bfloat16)),      # head_dim 32
])
def test_forced_kernel_raises_where_it_cannot_run(kw, x):
    with pytest.raises(ValueError, match="use_fused=True"):
        att.attention(x, x, x, 2, use_fused=True, **kw)
    with pytest.raises(ValueError, match="use_fused=True"):
        jax_att.attention(*(jnp.zeros((1, 600, 144)),) * 3, 2, use_fused=True)


def test_dispatch_window_is_the_jax_one():
    assert (att.FUSED_MIN_SEQ, att.FUSED_MAX_SEQ) == (jax_att.FUSED_MIN_SEQ,
                                                      1536)
    assert att.HEAD_DIMS == (64, 72)


def test_kernel_argument_checks():
    x = torch.zeros(1, 64, 144, dtype=torch.bfloat16)
    assert att._check_qkv(2, x, x, x) == (1, 64, 72)
    with pytest.raises(ValueError, match="head_dim"):
        att._check_qkv(4, x, x, x)
    with pytest.raises(TypeError, match="bf16"):
        att._check_qkv(2, x, x.float(), x)
    with pytest.raises(ValueError, match="contiguous"):
        att._check_qkv(2, x, x.transpose(0, 1), x)
