"""Fast ConvNeXt-CLIP encode over the Hopper kernels (counterpart of
``aihab_clip_tpu/models/fast_convnext.py``).

The convolutions (stem, downsample, the depthwise 7x7) stay PyTorch convs
on channels-last views (``models/convnext.conv_nhwc``), as the JAX package
left them to XLA; every block's LN -> fc1 -> exact GELU -> fc2 -> gamma ->
+ residual runs through K7 ``convnext_mlp_block`` (``ops/block_kernel``) or,
with ``qmlp``, its W8A8 twin K15 ``quant_convnext_mlp_block``
(``ops/quant_matmul``).  Exact GELU is the kernels' ``gelu_poly``, their
default activation.

  * ``pack_convnext``          the tower's weights in the kernels' layout,
                               built once at load (fc weights [in, out] in
                               the compute dtype, LN, biases and gamma fp32)
  * ``quantize_convnext_mlp``  the int8 fc1/fc2 weights, bit-identical to
                               JAX's
  * ``apply_convnext_blocks``  blocks [start, stop), a stage's downsample
                               before its first block in range
  * ``convnext_encode_fused``  stem -> every block through K7 (or K15) ->
                               pooled ``head_norm`` -> head
  * ``convnext_encode_hybrid`` the PEFT train step's encode: the stem and
                               the frozen bottom blocks through K7 without a
                               graph, then the canonical blocks and head
                               under autograd

JAX's ``build_dw_matrices`` (``fast_convnext.py:69-133``) turns the
depthwise 7x7 into a banded [S, S] matrix per channel for the TPU's matrix
unit: the same math, and no Pallas kernel.  On the card the depthwise conv
is cuDNN's grouped conv (``groups=C``), so ``dwmat`` is accepted as None
only.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.block_kernel import convnext_mlp_block
from ..ops.quant import quantize_weight
from ..ops.quant_matmul import int8_weight, quant_convnext_mlp_block
from .convnext import conv_nhwc, stage_blocks

def _ln_f32(x, scale, bias, eps=1e-6):
    y = F.layer_norm(x.float(), scale.shape, scale, bias, eps)
    return y.to(x.dtype)


def pack_convnext(model, config, dtype=torch.bfloat16, *,
                  stop: Optional[int] = None, mlp: bool = True) -> Dict:
    """The ConvNeXt tower's weights for ``convnext_encode_fused``, on the
    model's device, for blocks [0, stop) (default all; the PEFT hybrid packs
    its frozen prefix): convs in ``dtype`` (channels-last), LN, biases and
    gamma fp32, fc weights [in, out] in ``dtype`` unless ``mlp`` is False
    (the int8 engine's pack, whose MLPs run from ``quantize_convnext_mlp``)."""
    vis = model.visual
    depths = tuple(config.vision_layers)
    stop = sum(depths) if stop is None else stop

    def conv(m):
        return (m.weight.detach().to(dtype).contiguous(
            memory_format=torch.channels_last), m.bias.detach().to(dtype))

    def vec(t):
        return t.detach().float().contiguous()

    def ln(m):
        return vec(m.weight), vec(m.bias)

    def mat(lin):       # torch [out, in] -> kernel [in, out], compute dtype
        return lin.weight.detach().T.to(dtype).contiguous()

    down, blocks = {}, []
    for s, b, _ in stage_blocks(depths, 0, stop):
        if s and b == 0:
            down[s] = dict(ln=ln(getattr(vis, f"down_norm_{s}")),
                           conv=conv(getattr(vis, f"down_conv_{s}")))
        blk = getattr(vis, f"stage{s}_block{b}")
        packed = dict(dw=conv(blk.dwconv), ln=ln(blk.norm),
                      b1=vec(blk.fc1.bias), b2=vec(blk.fc2.bias),
                      gamma=vec(blk.gamma))
        if mlp:
            packed.update(w1=mat(blk.fc1), w2=mat(blk.fc2))
        blocks.append(packed)
    heads = (("head_fc1", "head_fc2") if config.vision_proj == "mlp"
             else ("head_proj",))
    head = {name: (mat(getattr(vis, name)),
                   getattr(vis, name).bias.detach().to(dtype))
            for name in heads}
    return dict(dtype=dtype, stem=conv(vis.stem_conv),
                stem_norm=ln(vis.stem_norm), down=down, blocks=blocks,
                head_norm=ln(vis.head_norm), head=head)


def quantize_convnext_mlp(model, config) -> Dict:
    """Per-block int8 (w8, scale) pairs for fc1 and fc2 (``fast_convnext.py
    :136-152``), from the fp32 parameters, in the kernels' K-major layout;
    convs, LNs, gamma, stem and head stay as they are."""
    vis = model.visual
    q = {}
    for s, b, _ in stage_blocks(config.vision_layers, 0,
                                sum(config.vision_layers)):
        blk = getattr(vis, f"stage{s}_block{b}")
        q[f"stage{s}_block{b}"] = {}
        for name in ("fc1", "fc2"):
            w8, scale = quantize_weight(getattr(blk, name).weight.detach().t())
            q[f"stage{s}_block{b}"][name] = {"w8": int8_weight(w8),
                                             "scale": scale}
    return q


def _stem(packed, x):
    x = conv_nhwc(x.to(packed["dtype"]), *packed["stem"], stride=4)
    return _ln_f32(x, *packed["stem_norm"])


def apply_convnext_blocks(packed, x: torch.Tensor, config, *, start: int,
                          stop: int, qmlp: Optional[Dict] = None,
                          dwmat=None) -> torch.Tensor:
    """Blocks [start, stop) of the global depth order (``fast_convnext.py
    :155-212``) over ``packed`` (``pack_convnext``), ``x`` the NHWC
    activation just before block ``start``: a stage's downsample runs before
    its first block in range (it belongs to that block's lock group), the
    depthwise conv as a grouped conv, the rest of the block through K7, or
    K15 with ``qmlp`` (``quantize_convnext_mlp``)."""
    if dwmat is not None:
        raise NotImplementedError(
            "the banded depthwise matrices (build_dw_matrices) are a TPU "
            "matrix-unit form of the 7x7 depthwise conv, not ported: the card "
            "runs it as a grouped conv")
    for s, b, k in stage_blocks(config.vision_layers, start, stop):
        if s and b == 0:
            dn = packed["down"][s]
            x = conv_nhwc(_ln_f32(x, *dn["ln"]), *dn["conv"], stride=2)
        blk = packed["blocks"][k]
        n, h, w, c = x.shape
        y = conv_nhwc(x, *blk["dw"], padding=3, groups=c)
        rows = (y.reshape(n * h * w, c), x.reshape(n * h * w, c), *blk["ln"])
        if qmlp is not None:
            q = qmlp[f"stage{s}_block{b}"]
            out = quant_convnext_mlp_block(
                *rows, q["fc1"]["w8"], q["fc1"]["scale"], blk["b1"],
                q["fc2"]["w8"], q["fc2"]["scale"], blk["b2"], blk["gamma"])
        else:
            out = convnext_mlp_block(*rows, blk["w1"], blk["b1"], blk["w2"],
                                     blk["b2"], blk["gamma"])
        x = out.reshape(n, h, w, c)
    return x


def _head(packed, x, *, project: bool):
    pre = _ln_f32(x.mean(dim=(1, 2)), *packed["head_norm"])
    if not project:
        return pre
    head = packed["head"]
    if "head_fc1" in head:                                   # mlp head (_d)
        w1, b1 = head["head_fc1"]
        w2, b2 = head["head_fc2"]
        return pre, F.gelu(pre @ w1 + b1) @ w2 + b2
    w, b = head["head_proj"]
    return pre, pre @ w + b


def convnext_encode_fused(packed, x: torch.Tensor, config, *,
                          project: bool = False, qmlp: Optional[Dict] = None,
                          dwmat=None):
    """x [B, H, W, 3] normalized NHWC -> the pre-projection features (or
    ``(pre, projected)``) in the pack's dtype, every block through K7, or
    through K15 with ``qmlp`` (the int8 serving path; convs stay in the
    pack's dtype)."""
    total = sum(config.vision_layers)
    if len(packed["blocks"]) != total:
        raise ValueError(f"the pack holds {len(packed['blocks'])} of {total} "
                         "blocks")
    x = _stem(packed, x)
    x = apply_convnext_blocks(packed, x, config, start=0, stop=total,
                              qmlp=qmlp, dwmat=dwmat)
    return _head(packed, x, project=project)


def convnext_encode_hybrid(model, images: torch.Tensor, config,
                           n_prefix: int, *, project: bool = False,
                           dtype=torch.bfloat16,
                           packed_prefix: Optional[Dict] = None):
    """The PEFT train step's encode (``fast_convnext.py:251-288``): the stem
    and the ``n_prefix`` FROZEN bottom blocks through K7 under
    ``torch.no_grad()`` (JAX's ``stop_gradient``: no graph is built there),
    then the canonical blocks ``[n_prefix, L)`` and head under autograd, in
    ``dtype``.  ``packed_prefix`` (``pack_convnext`` with ``stop=n_prefix``)
    is packed once per run by the caller, here when not given.  With
    ``n_prefix`` 0 the stem is differentiable too.  Under a data-parallel
    mesh each rank calls it on its rows of the batch, its own pack
    replicated (JAX's ``shard_map`` of the prefix,
    ``fast_convnext.py:266-279``)."""
    vis = model.visual
    if n_prefix > 0:
        if packed_prefix is None:
            packed_prefix = pack_convnext(model, config, dtype, stop=n_prefix)
        with torch.no_grad():
            x = apply_convnext_blocks(packed_prefix,
                                      _stem(packed_prefix, images), config,
                                      start=0, stop=n_prefix)
        x = x.to(dtype)
    else:
        x = vis.stem(images.to(dtype))
    x = vis.blocks(x, n_prefix, sum(config.vision_layers))
    return vis.head(x, project=project)
