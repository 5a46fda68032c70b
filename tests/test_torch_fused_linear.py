"""The port's K16 (``ops/fused_linear.py``) against the JAX package's:
``ln_matmul`` / ``matmul_residual`` on CPU tensors (their plain versions,
and the XLA formulation for exact gelu) against JAX's Pallas kernels in
interpret mode, on both grid variants, and against JAX's XLA formulations,
in fp32 at 1e-4 (``tests/test_fused_linear.py``); the autograd gradients
against ``jax.grad`` of JAX's public functions.  The CUDA kernels against
their plain versions on a card: ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aihab_clip_tpu.ops.fused_linear as jfl

from aihab_clip_tpu_torch.ops import fused_linear as fl

ACTS = [(None, 1e-5), ("quick_gelu", 1e-5), ("gelu_tanh", 1e-6),
        ("gelu", 1e-5)]


def _case(rng, m, k, n):
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    b = rng.standard_normal((n,)).astype(np.float32)
    ls = rng.standard_normal((k,)).astype(np.float32)
    lb = rng.standard_normal((k,)).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, b, ls, lb, res


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [(197, 96, 256), (300, 128, 384),
                                   (100, 64, 200)])
@pytest.mark.parametrize("full_n", [True, False])
@pytest.mark.parametrize("act,eps", ACTS)
def test_ln_matmul_matches_jax(rng, shape, full_n, act, eps, monkeypatch):
    monkeypatch.setattr(jfl, "_FULLN_WEIGHT_BYTES",
                        10 * 1024 * 1024 if full_n else 0)
    x, w, b, ls, lb, _ = _case(rng, *shape)
    fl.reset_launch_counts()
    with torch.no_grad():
        out = fl.ln_matmul(*_t(x, ls, lb, w, b), act, eps).numpy()
    assert fl.launch_counts() == {"ln_matmul": 0, "matmul_residual": 0}
    kernel = np.asarray(jfl._ln_matmul_pallas(
        *map(jnp.asarray, (x, ls, lb, w, b)), act, eps, interpret=True))
    xla = np.asarray(jfl._ln_matmul_xla(*map(jnp.asarray, (x, ls, lb, w, b)),
                                        act, eps))
    assert out.shape == (shape[0], shape[2]) and out.dtype == np.float32
    np.testing.assert_allclose(out, kernel, atol=1e-4)
    np.testing.assert_allclose(out, xla, atol=1e-4)


@pytest.mark.parametrize("shape", [(197, 96, 256), (100, 64, 200)])
@pytest.mark.parametrize("full_n", [True, False])
def test_matmul_residual_matches_jax(rng, shape, full_n, monkeypatch):
    monkeypatch.setattr(jfl, "_FULLN_WEIGHT_BYTES",
                        10 * 1024 * 1024 if full_n else 0)
    x, w, b, _, _, res = _case(rng, *shape)
    with torch.no_grad():
        out = fl.matmul_residual(*_t(x, w, b, res)).numpy()
    kernel = np.asarray(jfl._matmul_residual_pallas(
        *map(jnp.asarray, (x, w, b, res)), interpret=True))
    xla = np.asarray(jfl._matmul_residual_xla(
        *map(jnp.asarray, (x, w, b, res))))
    np.testing.assert_allclose(out, kernel, atol=1e-4)
    np.testing.assert_allclose(out, xla, atol=1e-4)


def _rel(a, b):
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.mark.parametrize("act,eps", ACTS)
def test_ln_matmul_grads_match_jax(rng, act, eps):
    """The autograd backward recomputes through the XLA formulation, as
    JAX's custom VJP does: every input's gradient at 1e-5 relative."""
    x, w, b, ls, lb, _ = _case(rng, 32, 16, 8)

    def jax_loss(*a):
        return jnp.sum(jfl.ln_matmul(*a, act, eps) ** 2)

    ref = jax.grad(jax_loss, argnums=tuple(range(5)))(
        *map(jnp.asarray, (x, ls, lb, w, b)))
    ins = [t.requires_grad_() for t in _t(x, ls, lb, w, b)]
    fl.ln_matmul(*ins, act, eps).square().sum().backward()
    for name, t, g in zip(("x", "ln_scale", "ln_bias", "w", "b"), ins, ref):
        assert _rel(t.grad.numpy(), np.asarray(g)) < 1e-5, name


def test_matmul_residual_grads_match_jax(rng):
    x, w, b, _, _, res = _case(rng, 32, 16, 8)
    ref = jax.grad(lambda *a: jnp.sum(jfl.matmul_residual(*a) ** 2),
                   argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, w, b, res)))
    ins = [t.requires_grad_() for t in _t(x, w, b, res)]
    fl.matmul_residual(*ins).square().sum().backward()
    for name, t, g in zip(("x", "w", "b", "res"), ins, ref):
        assert _rel(t.grad.numpy(), np.asarray(g)) < 1e-5, name


def test_plain_versions_round_where_the_kernels_round(rng):
    """bf16 on the CPU: the kernel-order plain versions round once, after
    the fp32 bias and residual sums; the XLA formulations round before the
    bias.  Both stay within 2 bf16 ulps of max|ref| of each other."""
    x, w, b, ls, lb, res = _case(rng, 64, 32, 48)
    xb, wb, bb, lsb, lbb, rb = (t.bfloat16() if t.dim() == 2 else t
                                for t in _t(x, w, b, ls, lb, res))
    with torch.no_grad():
        for act in ("quick_gelu", "gelu_poly", "gelu"):
            out = fl.ln_matmul(xb, lsb, lbb, wb, bb, act)
            ref = fl._ln_matmul_xla(xb, lsb, lbb, wb, bb, act)
            assert out.dtype == torch.bfloat16
            lim = 2 * 2 ** -8 * ref.float().abs().max().item()
            assert (out.float() - ref.float()).abs().max().item() <= lim
        out = fl.matmul_residual(xb, wb, bb, rb)
        ref = fl._matmul_residual_xla(xb, wb, bb, rb)
        lim = 2 * 2 ** -8 * ref.float().abs().max().item()
        assert (out.float() - ref.float()).abs().max().item() <= lim


def test_unknown_activation_raises(rng):
    x, w, b, ls, lb, _ = _case(rng, 8, 16, 8)
    with pytest.raises(ValueError, match="unknown activation"):
        fl.ln_matmul(*_t(x, ls, lb, w, b), "relu")
