"""Shared building blocks of the CLIP towers (``nn.Module``).

The numerics contract of ``aihab_clip_tpu/models/layers.py``:
  * LayerNorm computes in fp32 (eps 1e-5) and casts back to the input dtype;
  * QuickGELU is ``x * sigmoid(1.702 x)``;
  * attention uses one packed in-projection (``in_proj_weight`` [3W, W], the
    torch ``nn.MultiheadAttention`` layout) and a causal mask for text.

Parameters are stored in fp32 with torch's ``nn.Linear`` layout ([out, in]);
each module computes in the dtype of its input, casting weights at use —
JAX's ``param_dtype=float32`` / ``dtype=<compute>`` split.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
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


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 mlp_dim: int = 0, act: str = "quick_gelu"):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, heads, causal)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, mlp_dim, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
