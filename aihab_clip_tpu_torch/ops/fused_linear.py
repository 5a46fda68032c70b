"""LN-prologue and residual-epilogue linear layers on Hopper (K16), with
their plain versions (counterpart of ``aihab_clip_tpu/ops/fused_linear.py``).

  * ``ln_matmul(x, ls, lb, w, b, activation=None, eps=1e-5)``
        -> act(LN(x) @ w + b)   (``:299``; ``pallas_call`` :159 full-N, :188 tiled)
  * ``matmul_residual(x, w, b, res)``
        -> x @ w + b + res      (``:326``; :227, :255)

Each is a ``torch.autograd.Function`` whose backward recomputes through the
plain formulation, as JAX's ``custom_vjp`` does (``:310-346``).  On CUDA
tensors the forward launches the ``ln_gemm`` / ``gemm_residual`` kernels of
``ops/block_kernel.py`` (``csrc/block_kernels.cu``): their activation
epilogue (or ``act_pass`` for the gelu_poly forms past sig5), LN eps passed
through.  The TPU kernels chose a full-N or an N-tiled grid by whether the
weight fits VMEM; these GEMMs stream weight tiles through shared memory, so
one kernel serves every width.  JAX pads N to 128; the kernels need K and N
multiples of 8, so N is padded to 8 on the card and the result sliced, and a
K that is not a multiple of 8 raises.  They take bf16 x and w and store bf16
(JAX's output dtype is x's): fp32 operands on the card raise a
``TypeError``.

Exact-erf ``activation="gelu"`` takes the plain formulation on every device:
that is JAX's own dispatch, which sends it to XLA even on the TPU
(``:305-307``; Mosaic has no erf), and it launches no kernel.

The plain versions: ``_ln_matmul_xla`` and ``_matmul_residual_xla``, JAX's
XLA formulations (``:285-296``), round to x's dtype before the bias and
serve the backward and the ``gelu`` route; ``ln_matmul_plain`` and
``matmul_residual_plain`` follow the kernels' order (fp32 bias and residual
sums, one rounding) and serve CPU tensors and the card comparisons.  Each
public function counts its kernel launches (``ln_matmul.launches``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .block_kernel import (_ln_f32, act_f32, gemm_residual, ln_gemm,
                           ln_gemm_plain)

# the activations the kernels apply, by JAX's name (None: no activation)
KERNEL_ACTS = {None: "none", "quick_gelu": "quick_gelu",
               "gelu_tanh": "gelu_tanh", "gelu_poly": "gelu_poly"}


def _kernel_act(activation) -> str:
    if activation not in KERNEL_ACTS:
        raise ValueError(f"unknown activation '{activation}'")
    return KERNEL_ACTS[activation]


def _act(h, activation):
    """``_act_f32`` (``fused_linear.py:48``) on fp32 ``h``."""
    if activation == "gelu":
        return F.gelu(h)
    return act_f32(h, _kernel_act(activation))


def _ln_matmul_xla(x, ln_scale, ln_bias, w, b, activation=None, eps=1e-5):
    """JAX's XLA formulation (``:285``): LN in fp32, rounded to x's dtype,
    the product and the bias in x's dtype, the activation in fp32."""
    ln = _ln_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    out = ln @ w + b.to(x.dtype)
    if activation is not None:
        out = _act(out.float(), activation).to(x.dtype)
    return out


def _matmul_residual_xla(x, w, b, res):
    """JAX's XLA formulation (``:294``)."""
    return (x @ w + b.to(x.dtype) + res).to(x.dtype)


def ln_matmul_plain(x, ln_scale, ln_bias, w, b, activation=None, eps=1e-5):
    """The kernel's arithmetic (``_ln_matmul_fulln_kernel``): LN in fp32
    rounded to w's dtype, the product summed in fp32, + bias, act, one
    rounding to x's dtype.  ``gelu`` is the XLA formulation, as in JAX."""
    if activation == "gelu":
        return _ln_matmul_xla(x, ln_scale, ln_bias, w, b, activation, eps)
    return ln_gemm_plain(x, ln_scale, ln_bias, w, b,
                         act=_kernel_act(activation), eps=eps).to(x.dtype)


def matmul_residual_plain(x, w, b, res):
    """The kernel's arithmetic (``_matmul_residual_fulln_kernel``): (x @ w +
    b) + res summed in fp32, one rounding to x's dtype."""
    out = (x.float() @ w.float() + b.float()) + res.float()
    return out.to(x.dtype)


def _pad_cols(w, b, res=None):
    """N padded to a multiple of 8 with zero columns (JAX pads to 128)."""
    pad = -w.shape[1] % 8
    if not pad:
        return w, b, res
    return (F.pad(w, (0, pad)), F.pad(b.float(), (0, pad)),
            None if res is None else F.pad(res, (0, pad)))


def _check_card(name, x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name} takes x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}'s kernel takes bf16 x and w (it stores "
                        f"bf16), got {x.dtype} and {w.dtype}")
    if x.shape[1] % 8:
        raise ValueError(f"{name}'s kernel needs K a multiple of 8, got "
                         f"{x.shape[1]}")


def _ln_matmul_fwd(x, ln_scale, ln_bias, w, b, activation, eps):
    if activation == "gelu" or not x.is_cuda:
        return ln_matmul_plain(x, ln_scale, ln_bias, w, b, activation, eps)
    act = _kernel_act(activation)
    _check_card("ln_matmul", x, w)
    n = w.shape[1]
    wp, bp, _ = _pad_cols(w.contiguous(), b)
    y = ln_gemm(x.contiguous(), ln_scale, ln_bias, wp, bp, act=act, eps=eps)
    ln_matmul.launches += 1
    return y if n % 8 == 0 else y[:, :n].contiguous()


def _matmul_residual_fwd(x, w, b, res):
    if not x.is_cuda:
        return matmul_residual_plain(x, w, b, res)
    _check_card("matmul_residual", x, w)
    n = w.shape[1]
    wp, bp, rp = _pad_cols(w.contiguous(), b, res.contiguous())
    y = gemm_residual(x.contiguous(), wp, bp, rp, out_dtype=x.dtype)
    matmul_residual.launches += 1
    return y if n % 8 == 0 else y[:, :n].contiguous()


def _vjp(fn, saved, g, *static):
    """Gradients of ``fn(*saved, *static)`` at ``saved`` along ``g``."""
    inputs = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        out = fn(*inputs, *static)
    return torch.autograd.grad(out, inputs, g)


class _LnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, b, activation, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w, b)
        ctx.static = (activation, eps)
        return _ln_matmul_fwd(x, ln_scale, ln_bias, w, b, activation, eps)

    @staticmethod
    def backward(ctx, g):
        return (*_vjp(_ln_matmul_xla, ctx.saved_tensors, g, *ctx.static),
                None, None)


class _MatmulResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, res):
        ctx.save_for_backward(x, w, b, res)
        return _matmul_residual_fwd(x, w, b, res)

    @staticmethod
    def backward(ctx, g):
        return _vjp(_matmul_residual_xla, ctx.saved_tensors, g)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def ln_matmul(x, ln_scale, ln_bias, w, b, activation=None, eps=1e-5):
    """act(LN(x) @ w + b) over x [M, K], w [K, N], in x's dtype (K16).
    Kernel ``ln_gemm`` on CUDA tensors; exact ``gelu`` takes the plain
    formulation everywhere, as JAX's dispatch does; the plain version on
    CPU tensors.  Gradients through the XLA formulation (the autograd
    Function only where one is needed: its host time showed beside the
    shortest kernels)."""
    if not _needs_grad(x, ln_scale, ln_bias, w, b):
        return _ln_matmul_fwd(x, ln_scale, ln_bias, w, b, activation, eps)
    return _LnMatmul.apply(x, ln_scale, ln_bias, w, b, activation, eps)


def matmul_residual(x, w, b, res):
    """x @ w + b + res over x [M, K], w [K, N], res [M, N], in x's dtype
    (K16).  Kernel ``gemm_residual`` on CUDA tensors, the plain version on
    CPU tensors.  Gradients through the XLA formulation (the autograd
    Function only where one is needed)."""
    if not _needs_grad(x, w, b, res):
        return _matmul_residual_fwd(x, w, b, res)
    return _MatmulResidual.apply(x, w, b, res)


COUNTED = (ln_matmul, matmul_residual)
for _fn in COUNTED:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}
