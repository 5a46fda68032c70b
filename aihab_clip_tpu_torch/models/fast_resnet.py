"""Folded-BatchNorm ModifiedResNet encode, the forward-only card path
(counterpart of ``aihab_clip_tpu/models/fast_resnet.py``).

Every BatchNorm of the RN tower is frozen (``models/resnet.py``), so each
(conv, BatchNorm) pair folds into one conv with a bias once, at load:

    a       = weight * rsqrt(var + eps)          (per output channel)
    kernel' = kernel * a
    bias'   = bias - mean * a

The fold is computed in fp32; the folded kernel is then cast to the compute
dtype (one more rounding on a bf16 tower) and the bias stays fp32.  The
folded convs run as PyTorch convs (cuDNN on the card) on channels-last
activations with channels-last kernels, the average pools as
``avg_pool2d``, the attention pool as the canonical module's single-query
attention (``resnet.attention_pool``).  The JAX package left this whole
tower to XLA: no Pallas kernel lies on it, so none is written here.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .resnet import attention_pool

_STRIDES = (1, 2, 2, 2)


def _fold_pair(conv, bn, dtype):
    """(conv, FrozenBatchNorm) -> {"weight": OIHW folded kernel in
    ``dtype``, channels-last; "bias": fp32}."""
    k = conv.weight.detach().float()
    a = bn.weight.detach().float() * torch.rsqrt(bn.var.detach().float()
                                                 + bn.eps)
    bias = bn.bias.detach().float() - bn.mean.detach().float() * a
    weight = (k * a[:, None, None, None]).to(dtype)
    return {"weight": weight.contiguous(memory_format=torch.channels_last),
            "bias": bias}


def fold_resnet_bn(model, dtype=torch.bfloat16) -> Dict:
    """The RN tower of ``model`` as a folded tree, on the model's device:
    ``conv1``-``conv3`` and every ``layer<s>_<b>``'s ``conv1``-``conv3`` and
    ``downsample_conv`` as folded pairs, the attention pool's weights in
    ``dtype``.  Built once at load (the weights are frozen for encode)."""
    vis = model.visual
    out: Dict = {"dtype": dtype}
    for i in (1, 2, 3):
        out[f"conv{i}"] = _fold_pair(getattr(vis, f"conv{i}"),
                                     getattr(vis, f"bn{i}"), dtype)
    for name, blk in vis.named_children():
        if not name.startswith("layer"):
            continue
        fb = {f"conv{i}": _fold_pair(getattr(blk, f"conv{i}"),
                                     getattr(blk, f"bn{i}"), dtype)
              for i in (1, 2, 3)}
        if hasattr(blk, "downsample_conv"):
            fb["downsample_conv"] = _fold_pair(blk.downsample_conv,
                                               blk.downsample_bn, dtype)
        out[name] = fb
    ap = vis.attnpool
    out["attnpool"] = {
        "positional_embedding": ap.positional_embedding.detach().to(dtype),
        **{k: (getattr(ap, k).weight.detach().to(dtype),
               getattr(ap, k).bias.detach().to(dtype))
           for k in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    return out


def _conv(x, p, *, stride=1, pad=0):
    return F.conv2d(x, p["weight"], p["bias"].to(x.dtype), stride=stride,
                    padding=pad)


def _bottleneck(fb, x, *, stride: int):
    out = torch.relu_(_conv(x, fb["conv1"]))
    out = torch.relu_(_conv(out, fb["conv2"], pad=1))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = _conv(out, fb["conv3"])
    identity = x
    if "downsample_conv" in fb:
        if stride > 1:
            identity = F.avg_pool2d(x, stride)
        identity = _conv(identity, fb["downsample_conv"])
    return torch.relu_(out.add_(identity))


def resnet_stem(folded: Dict, x: torch.Tensor) -> torch.Tensor:
    """NHWC preprocessed images -> the stem's output (3 folded convs with
    ReLU, the 2x2 pool), channels-last NCHW in the tree's dtype."""
    x = x.to(folded["dtype"]).permute(0, 3, 1, 2)
    x = torch.relu_(_conv(x, folded["conv1"], stride=2, pad=1))
    x = torch.relu_(_conv(x, folded["conv2"], pad=1))
    x = torch.relu_(_conv(x, folded["conv3"], pad=1))
    return F.avg_pool2d(x, 2)


def resnet_stage(folded: Dict, x: torch.Tensor, config,
                 stage: int) -> torch.Tensor:
    """The Bottleneck blocks of stage ``stage`` (1-4)."""
    for blk in range(config.vision_layers[stage - 1]):
        x = _bottleneck(folded[f"layer{stage}_{blk}"], x,
                        stride=_STRIDES[stage - 1] if blk == 0 else 1)
    return x


def resnet_pool(folded: Dict, x: torch.Tensor, config, *,
                project: bool = False):
    """The attention pool over stage 4's output: the pre-projection
    feature, or ``(pre, c_proj(pre))``."""
    ap = folded["attnpool"]
    b, c, h, w = x.shape
    pre = attention_pool(x.permute(0, 2, 3, 1).reshape(b, h * w, c),
                         ap["positional_embedding"], ap["q_proj"],
                         ap["k_proj"], ap["v_proj"], config.vision_heads)
    if not project:
        return pre
    return pre, F.linear(pre, *ap["c_proj"])


def resnet_encode_folded(folded: Dict, x: torch.Tensor, config, *,
                         project: bool = False):
    """folded: ``fold_resnet_bn``'s tree; x [B, H, W, 3] preprocessed
    images.  Returns the pre-projection features or ``(pre, projected)``,
    in the tree's dtype."""
    x = resnet_stem(folded, x)
    for stage in range(1, 5):
        x = resnet_stage(folded, x, config, stage)
    return resnet_pool(folded, x, config, project=project)
