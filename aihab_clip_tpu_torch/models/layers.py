"""Shared building blocks of the CLIP towers (``nn.Module``).

The numerics contract of ``aihab_clip_tpu/models/layers.py``:
  * LayerNorm computes in fp32 (eps 1e-5) and casts back to the input dtype;
  * QuickGELU is ``x * sigmoid(1.702 x)``;
  * attention uses one packed in-projection (``in_proj_weight`` [3W, W], the
    torch ``nn.MultiheadAttention`` layout) and a causal mask for text.

Parameters are stored in fp32 with torch's ``nn.Linear`` layout ([out, in]);
each module computes in the dtype of its input, casting weights at use —
JAX's ``param_dtype=float32`` / ``dtype=<compute>`` split.

``remat`` (JAX's ``nn.remat`` of each block, ``layers.py:193-201``): a block
whose ``remat`` is set runs under ``torch.utils.checkpoint`` while autograd
records, so its activations are recomputed in the backward instead of kept;
the gradients are the same.  ``set_remat`` sets it on every block of a
model; ``remat_blocks`` sets it for the duration of a call (the scanned
encodes' ``scan_remat``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32, output cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def resolve_act(name: str):
    """Activation by name: ``quick_gelu`` (OpenAI CLIP), ``gelu`` (exact
    erf), ``gelu_tanh``."""
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return F.gelu
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` in x's dtype."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def attention(q, k, v, causal: bool = False):
    """softmax(q k^T / sqrt(d)) v over [B, H, S, D]; scores and softmax in
    fp32, probabilities cast to v's dtype for the PV product."""
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        s = q.shape[-2]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return p.to(v.dtype) @ v


class MultiheadAttention(nn.Module):
    """Packed-QKV multi-head self-attention."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} not divisible by heads {heads}")
        self.heads = heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, w = x.shape
        qkv = linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, s, self.heads, w // self.heads).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        out = attention(q, k, v, self.causal).transpose(1, 2).reshape(b, s, w)
        return linear(out, self.out_proj.weight, self.out_proj.bias)


class MLP(nn.Module):
    """c_fc -> act -> c_proj (4x expansion unless ``mlp_dim`` says)."""

    def __init__(self, width: int, mlp_dim: int = 0, act: str = "quick_gelu"):
        super().__init__()
        hidden = mlp_dim or 4 * width
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)
        self.act = resolve_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(linear(x, self.c_fc.weight, self.c_fc.bias))
        return linear(h, self.c_proj.weight, self.c_proj.bias)


def checkpoint_pinned(module: nn.Module, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``, with ``module``'s
    parameter slots put back as they read now for the backward's
    recompute: LoRA swaps W_eff into them for a ``with`` block
    (``train/lora.lora_applied``) that the backward runs outside."""
    slots = [(m, k) for m in module.modules()
             for k, w in m._parameters.items() if w is not None]

    def run(weights, *a):
        held = [m._parameters[k] for m, k in slots]
        for (m, k), w in zip(slots, weights):
            m._parameters[k] = w
        try:
            return fn(*a)
        finally:
            for (m, k), w in zip(slots, held):
                m._parameters[k] = w

    return torch.utils.checkpoint.checkpoint(
        run, [m._parameters[k] for m, k in slots], *args,
        use_reentrant=False)


class GatherBlock(nn.Module):
    """A block of a tower that FSDP gathers one at a time: ``block(x)``
    runs ``_forward``.  A block given ``gather`` (a context manager that
    puts its whole weights into its parameter slots, FSDP's per-block
    gather, and merges its LoRA adapters into them) runs ``_forward``
    inside it, checkpointed while autograd records: the whole weights live
    for the block's forward and again for its backward's recompute, never
    across the step.  ``ConvNeXtBlock`` and the RN ``Bottleneck`` are
    such blocks; the transformer blocks are ``RematBlock``s."""

    gather = None

    def run(self, fn, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``fn(x)`` as this block's compute: inside its ``gather`` when it
        has one (checkpointed while autograd records), else checkpointed
        when ``remat`` and autograd records, else plainly.  ``fn`` is read
        by the caller now: the backward's recompute runs after the
        caller's contexts (the gather, a tensor-parallel ``_forward``) have
        ended."""
        if self.gather is not None:
            gather = self.gather

            def gathered(x):
                with gather():
                    return fn(x)

            if torch.is_grad_enabled():
                return torch.utils.checkpoint.checkpoint(
                    gathered, x, use_reentrant=False)
            return gathered(x)
        if remat and torch.is_grad_enabled():
            return checkpoint_pinned(self, fn, x)
        return fn(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(self._forward, x)


class RematBlock(GatherBlock):
    """A transformer block: a ``GatherBlock`` whose ``block(x)`` also
    checkpoints ``_forward`` when ``remat`` is set and autograd records
    (JAX's ``nn.remat`` of the block)."""

    remat = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(self._forward, x, self.remat)


def set_remat(model: nn.Module, enabled: bool = True) -> nn.Module:
    """Set ``remat`` on every transformer block of ``model`` (both towers;
    a ConvNeXt or RN tower's blocks are ``GatherBlock``s without it, as
    JAX's take no remat)."""
    for mod in model.modules():
        if isinstance(mod, RematBlock):
            mod.remat = bool(enabled)
    return model


@contextlib.contextmanager
def remat_blocks(module: nn.Module, enabled: bool):
    """``remat`` set to ``enabled`` on every block of ``module`` for the
    duration, each block's own flag restored after."""
    blocks = [m for m in module.modules() if isinstance(m, RematBlock)]
    saved = [blk.remat for blk in blocks]
    for blk in blocks:
        blk.remat = bool(enabled)
    try:
        yield module
    finally:
        for blk, flag in zip(blocks, saved):
            blk.remat = flag


class ResidualAttentionBlock(RematBlock):
    """Pre-LN transformer block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 mlp_dim: int = 0, act: str = "quick_gelu"):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, heads, causal)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, mlp_dim, act)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """Stack of residual attention blocks."""

    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False, mlp_dim: int = 0,
                 act: str = "quick_gelu"):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal, mlp_dim, act)
            for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x)
        return x
