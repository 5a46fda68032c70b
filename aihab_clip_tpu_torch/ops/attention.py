"""Fused multi-head attention (K6) on Hopper, with its plain versions
(counterpart of ``aihab_clip_tpu/ops/attention.py``).

``fused_attention(q, k, v, num_heads)`` is a ``torch.autograd.Function`` over
two hand-written CUDA kernels, for q/k/v [B, S, W] with the heads packed in W
(the JAX layout, so nothing is transposed):

  * forward (``_pallas_attention`` :91, pallas_call :113): the TMA + wgmma
    flash kernel of ``csrc/block_kernels.cu`` (``flash_attention_kernel``)
    reading the three separate tensors, fp32 scores scaled by 1/sqrt(d), P
    in registers, and storing each row's fp32 log-sum-exp for the backward;
  * backward (``_pallas_attention_bwd`` :204, pallas_call :226):
    ``csrc/fused_attention_bwd.cu``, a dq kernel (which also forms the row
    term) and a dk/dv kernel, TMA + wgmma like the forward, that rebuild P
    from the log-sum-exp in registers.

Both take head_dim 64 or 72, bf16, non-causal.  ``attention()`` dispatches as
the JAX package does (:304-338): the kernel for non-causal sequences of
``FUSED_MIN_SEQ`` to 1536 tokens, plain math otherwise.  That window is the
TPU's measured crossover, kept so the port runs K6 exactly where the JAX path
runs its Pallas kernel.  The kernel also needs bf16 CUDA tensors of head_dim
64 or 72; every other call (CPU tensors, fp32, SigLIP's S=64 text tower)
takes plain math.  This is dispatch by dtype and shape, not a fallback:
``use_fused=True`` raises where the kernel cannot run.

Numerics against the TPU kernel: the forward applies 1/sum to the output rows
(the TPU kernel normalises P before its bf16 cast), and the backward's row
term is rowsum(dO * O) over the bf16 output where the TPU kernel sums dp * p;
both are stated tolerances (PERF.md).  The plain versions follow the TPU
kernels line by line and serve the CPU tests and CPU tensors.
"""

from __future__ import annotations

import math

import torch

from ._build import launch

# K6's head widths: those of its backward kernels (the forward's flash
# kernel also takes ViT-g's 88 and ViT-bigG's 104, ops/block_kernel.py)
HEAD_DIMS = (64, 72)
# the JAX dispatch window (attention.py:281, :321): below it XLA was faster
# on the TPU; above it the TPU kernel's [S, S] scores overflow VMEM
FUSED_MIN_SEQ = 512
FUSED_MAX_SEQ = 1536


# ---------------------------------------------------------------------------
# plain versions (PyTorch)
# ---------------------------------------------------------------------------


def _heads(t, num_heads):
    """[B, S, W] -> fp32 [B, H, S, d]."""
    b, s, w = t.shape
    return t.float().reshape(b, s, num_heads, w // num_heads).transpose(1, 2)


def _merge(t, dtype):
    """fp32 [B, H, S, d] -> [B, S, H*d] in ``dtype``."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def _probs(q, k, num_heads, seq_len):
    """Masked softmax of the fp32 scores (``_attn_kernel`` :63-69): fp32
    [B, H, S, S], keys at or past ``seq_len`` at -1e30."""
    s, d = q.shape[1], q.shape[2] // num_heads
    scores = _heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)
    scores = scores * (1.0 / math.sqrt(d))
    masked = torch.arange(s, device=q.device) >= (s if seq_len is None
                                                  else seq_len)
    scores = scores.masked_fill(masked, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True), scores


def fused_attention_plain(q, k, v, num_heads: int, seq_len: int | None = None):
    """Plain version of the forward (``_attn_kernel``): fp32 scores times
    1/sqrt(d), keys >= ``seq_len`` masked, P normalised and then cast to v's
    dtype, PV accumulated in fp32, output in q's dtype.  [B, S, W] each."""
    p, _ = _probs(q, k, num_heads, seq_len)
    return _merge(p.to(v.dtype).float() @ _heads(v, num_heads), q.dtype)


def fused_attention_bwd_plain(q, k, v, g, num_heads: int,
                              seq_len: int | None = None, out=None):
    """Plain version of the backward (``_attn_bwd_kernel`` :130-171): P
    recomputed in fp32, dv = bf16(p)^T g, dp = g v^T in fp32, ds = (p * (dp -
    rowsum(dp * p)) * scale) in q's dtype, dq = ds k, dk = ds^T q, each
    accumulated in fp32 and returned in q's dtype.  With ``out`` (the
    forward's output) the row term is rowsum(g * out), as the CUDA kernel
    forms it."""
    d = q.shape[2] // num_heads
    p, _ = _probs(q, k, num_heads, seq_len)
    gh, vh = _heads(g, num_heads), _heads(v, num_heads)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ gh
    dp = gh @ vh.transpose(-1, -2)
    if out is None:
        row = (dp * p).sum(-1, keepdim=True)
    else:
        row = (gh * _heads(out, num_heads)).sum(-1, keepdim=True)
    ds = (p * (dp - row) * (1.0 / math.sqrt(d))).to(q.dtype).float()
    dq = ds @ _heads(k, num_heads)
    dk = ds.transpose(-1, -2) @ _heads(q, num_heads)
    return _merge(dq, q.dtype), _merge(dk, q.dtype), _merge(dv, q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_qkv(num_heads, *ts):
    q = ts[0]
    b, s, w = q.shape
    d = w // num_heads
    if w != num_heads * d or d not in HEAD_DIMS:
        raise ValueError(f"fused_attention needs head_dim in {HEAD_DIMS}: "
                         f"width {w} over {num_heads} heads")
    for t in ts:
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise TypeError(f"fused_attention takes bf16 tensors on one "
                            f"card, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (b, s, w) or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("fused_attention takes contiguous, 16-byte "
                             f"aligned [B, S, W] tensors, got {tuple(t.shape)}")
    return b, s, d


def fused_attention_fwd(q, k, v, num_heads: int):
    """q, k, v [B, S, W] -> (out [B, S, W] in q's dtype, lse [B, H, S] fp32
    row log-sum-exp of the scaled scores).  Kernel on CUDA tensors (bf16,
    head_dim 64 or 72); plain version on CPU tensors."""
    if not q.is_cuda:
        p, scores = _probs(q, k, num_heads, None)
        out = p.to(v.dtype).float() @ _heads(v, num_heads)
        return _merge(out, q.dtype), torch.logsumexp(scores, -1)
    b, s, d = _check_qkv(num_heads, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32, device=q.device)
    launch("aihab_fused_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, num_heads, d,
           1.0 / math.sqrt(d))
    fused_attention_fwd.launches += 1
    return out, lse


def fused_attention_bwd(q, k, v, out, lse, g, num_heads: int,
                        need_dq: bool = True, need_dkdv: bool = True):
    """Gradients (dq, dk, dv) of ``out = fused_attention(q, k, v)`` for the
    output cotangent ``g``, from the forward's ``out`` and ``lse``; an
    output not asked for is None and its kernel work is skipped.  Kernels
    on CUDA tensors; plain version (JAX's row term) on CPU tensors."""
    if not q.is_cuda:
        grads = fused_attention_bwd_plain(q, k, v, g, num_heads)
        return tuple(t if want else None for t, want in
                     zip(grads, (need_dq, need_dkdv, need_dkdv)))
    b, s, d = _check_qkv(num_heads, q, k, v, out, g)
    if lse.shape != (b, num_heads, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be fp32 [B, H, S], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q) if need_dq else None
    dk = torch.empty_like(k) if need_dkdv else None
    dv = torch.empty_like(v) if need_dkdv else None
    ptr = (lambda t: None if t is None else t.data_ptr())
    launch("aihab_fused_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), ptr(dq), ptr(dk), ptr(dv), b, s, num_heads, d,
           1.0 / math.sqrt(d))
    fused_attention_bwd.launches += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """out = softmax(q k^T / sqrt(d)) v over packed heads; the backward runs
    the backward kernel (the JAX custom VJP, attention.py:253-276)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        out, lse = fused_attention_fwd(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = fused_attention_bwd(
            q, k, v, out, lse, g.contiguous(), ctx.num_heads, need_dq=need_q,
            need_dkdv=need_k or need_v)
        return (dq, dk if need_k else None, dv if need_v else None, None)


def fused_attention(q, k, v, num_heads: int):
    """Fused multi-head attention over packed-head inputs [B, S, W],
    differentiable (``FusedAttention``)."""
    return FusedAttention.apply(q, k, v, num_heads)


def dot_product_attention(q, k, v, num_heads: int, causal: bool = False):
    """The dispatch's plain math, ``jax.nn.dot_product_attention``'s XLA
    form: q [B, Sq, W] over k, v [B, Sk, W] (heads packed in W), fp32 scores
    and softmax, P cast to v's dtype for PV."""
    b, sq, w = q.shape
    d = w // num_heads

    def heads(t):
        return t.reshape(b, t.shape[1], num_heads, d).transpose(1, 2)

    scores = (heads(q).float() @ heads(k).float().transpose(-1, -2)) \
        / math.sqrt(d)
    if causal:
        mask = torch.ones(sq, sq, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return (p.to(v.dtype) @ heads(v)).transpose(1, 2).reshape(b, sq, w)


def attention(q, k, v, num_heads: int, *, causal: bool = False,
              use_fused: bool | None = None):
    """Self-attention over [B, S, W] (heads packed in W), dispatched as in
    the JAX package: the K6 kernel for non-causal S in [FUSED_MIN_SEQ,
    FUSED_MAX_SEQ] on bf16 CUDA tensors of head_dim 64 or 72, plain math
    otherwise.  ``use_fused=False`` forces plain math; ``use_fused=True``
    forces the kernel at any S and raises where it cannot run."""
    d = q.shape[-1] // num_heads
    runnable = (q.is_cuda and not causal and q.dtype == torch.bfloat16
                and d in HEAD_DIMS)
    if use_fused is True and not runnable:
        raise ValueError(
            "use_fused=True cannot be honored: the fused kernel is "
            f"non-causal, bf16, head_dim {HEAD_DIMS}, CUDA-only "
            f"(causal={causal}, dtype={q.dtype}, head_dim={d}, "
            f"device={q.device})")
    if use_fused is None:
        use_fused = FUSED_MIN_SEQ <= q.shape[1] <= FUSED_MAX_SEQ
    if use_fused and runnable:
        return fused_attention(q, k, v, num_heads)
    return dot_product_attention(q, k, v, num_heads, causal)


COUNTED = (fused_attention_fwd, fused_attention_bwd)
for _fn in COUNTED:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}
