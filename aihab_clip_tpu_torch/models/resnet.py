"""ModifiedResNet vision tower with QKV attention pooling (counterpart of
``aihab_clip_tpu/models/resnet.py``), OpenAI's RN50 to RN50x64 CLIP towers.

Public input is NHWC, as in the JAX package.  The tower runs NCHW with OIHW
conv weights on a channels-last view of that input (``permute(0, 3, 1,
2)``, no copy), so its activations stay channels-last throughout, which is
the layout cuDNN takes on the card.

  * a 3-conv stem (3x3, stride 2 then 1, 1), each conv followed by a
    frozen BatchNorm and ReLU, then a 2x2 average pool;
  * four stages of ``Bottleneck`` blocks (1x1, 3x3, 1x1 convs, expansion
    4) whose strided blocks average-pool with kernel = stride before
    ``conv3`` and in the downsample branch, instead of a strided conv;
  * ``AttentionPool2d``: the mean token prepended, the positional
    embedding added, one multi-head attention whose only query is the
    mean token (the full attention's row 0, so no HW x HW matrix is
    formed).  The output is the pre-projection feature (``width * 32``
    wide); ``project=True`` also returns ``c_proj`` of it.

``FrozenBatchNorm`` computes in fp32 whatever the input dtype:
``(x - mean) * rsqrt(var + eps) * weight + bias``.  ``weight`` (JAX's
``scale``) and ``bias`` are trainable; ``mean`` and ``var`` are parameters
that never require a gradient, so one state dict carries the whole
checkpoint under JAX's names (``PARITY.md``, "FrozenBatchNorm PEFT
semantics").  Module attributes carry the flax names (``layer1_0``,
``downsample_conv``, ``downsample_bn``, ``attnpool.c_proj`` ...), so
``models/convert.py`` carries a JAX parameter tree by name.
``models/fast_resnet.py`` folds every (conv, BatchNorm) pair for the
forward-only card path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GatherBlock, attention, linear


def conv(x: torch.Tensor, weight: torch.Tensor, bias=None, *,
         stride: int = 1, padding: int = 0) -> torch.Tensor:
    """A conv over NCHW ``x`` with an OIHW weight, in x's dtype."""
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding)


class FrozenBatchNorm(nn.Module):
    """BatchNorm over NCHW with fixed statistics, computed in fp32 and cast
    back to the input dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.var = nn.Parameter(torch.ones(features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def chan(t):
            return t.float().view(1, -1, 1, 1)

        inv = torch.rsqrt(chan(self.var) + self.eps)
        y = (x.float() - chan(self.mean)) * inv
        return (y * chan(self.weight) + chan(self.bias)).to(x.dtype)


class Bottleneck(GatherBlock):
    """One block; under FSDP it gathers its own weights as it runs
    (``GatherBlock``)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        if stride > 1 or inplanes != out:
            self.downsample_conv = nn.Conv2d(inplanes, out, 1, bias=False)
            self.downsample_bn = FrozenBatchNorm(out)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(conv(x, self.conv1.weight)))
        out = F.relu(self.bn2(conv(out, self.conv2.weight, padding=1)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(conv(out, self.conv3.weight))
        identity = x
        if hasattr(self, "downsample_conv"):
            if self.stride > 1:
                identity = F.avg_pool2d(x, self.stride)
            identity = self.downsample_bn(
                conv(identity, self.downsample_conv.weight))
        return F.relu(out + identity)


def attention_pool(tokens: torch.Tensor, pos, q_proj, k_proj, v_proj,
                   heads: int) -> torch.Tensor:
    """[B, HW, C] tokens -> the pre-projection pooled feature [B, C]: the
    mean token prepended, ``pos`` added, the mean token's attention over
    every token.  ``*_proj`` are (weight [out, in], bias) pairs."""
    b, _, c = tokens.shape
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + pos.to(tokens.dtype)

    def split(t):
        return t.reshape(b, t.shape[1], heads, c // heads).transpose(1, 2)

    q = split(linear(tokens[:, :1], *q_proj))
    k = split(linear(tokens, *k_proj))
    v = split(linear(tokens, *v_proj))
    return attention(q, k, v).reshape(b, c)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor, *, project: bool = False):
        b, c, h, w = x.shape
        pre = attention_pool(
            x.permute(0, 2, 3, 1).reshape(b, h * w, c),
            self.positional_embedding,
            *((m.weight, m.bias) for m in (self.q_proj, self.k_proj,
                                            self.v_proj)), heads=self.heads)
        if not project:
            return pre
        return pre, linear(pre, self.c_proj.weight, self.c_proj.bias)


class ModifiedResNet(nn.Module):
    """The RN tower; fp32 parameters, computing in ``dtype``."""

    def __init__(self, layers: Tuple[int, int, int, int], output_dim: int,
                 heads: int, input_resolution: int = 224, width: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.layers = tuple(layers)
        self.dtype = dtype  # compute dtype; parameters stay fp32
        half = width // 2
        self.conv1 = nn.Conv2d(3, half, 3, 2, 1, bias=False)
        self.bn1 = FrozenBatchNorm(half)
        self.conv2 = nn.Conv2d(half, half, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(half)
        self.conv3 = nn.Conv2d(half, width, 3, 1, 1, bias=False)
        self.bn3 = FrozenBatchNorm(width)
        inplanes = width
        for stage, (n_blocks, planes, stride) in enumerate(zip(
                self.layers, (width, 2 * width, 4 * width, 8 * width),
                (1, 2, 2, 2)), 1):
            for blk in range(n_blocks):
                setattr(self, f"layer{stage}_{blk}", Bottleneck(
                    inplanes, planes, stride if blk == 0 else 1))
                inplanes = planes * Bottleneck.expansion
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim)

    def forward(self, x: torch.Tensor, *, project: bool = False):
        """x [B, H, W, 3] NHWC -> the pre-projection pooled feature."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(conv(
                x, getattr(self, f"conv{i}").weight, stride=2 if i == 1
                else 1, padding=1)))
        x = F.avg_pool2d(x, 2)
        for stage, n_blocks in enumerate(self.layers, 1):
            for blk in range(n_blocks):
                x = getattr(self, f"layer{stage}_{blk}")(x)
        return self.attnpool(x, project=project)
