"""int8 (W8A8 dynamic) SigLIP vision-tower encode for serving (counterpart of
``aihab_clip_tpu/models/quant_siglip.py``).

The JAX module's measured recipe on the SigLIP layout (separate q/k/v
projections, gelu_tanh MLP, LN eps 1e-6, MAP pooling head):

  * the patchify conv as an im2col int8 GEMM + conv bias
    (``quant_matmul_fused``, K8);
  * per block: ``quant_attn_block_split`` (K13: LN1 + int8 QKV over head
    groups + bf16 attention + int8 out-proj + residual), then the chained
    int8 MLP, ``quant_matmul_fused_qout`` (K9: LN2 + c_fc + gelu_tanh,
    requantized to int8) and ``quant_matmul_q8in`` (K10: c_proj + bias +
    residual);
  * ``ln_post`` and the MAP head on the original weights, in the compute
    dtype (one probe token: plain PyTorch, as the JAX package left it to
    XLA).

``siglip_encode_int8``'s ``impl`` and ``attn_impl`` name JAX's routes
(``quant_siglip.py:206-249``):

  * ``impl="pallas"`` (``"auto"``), ``attn_impl="split"`` (``"auto"``): the
    kernel route above; the kernels run on CUDA tensors and their plain
    versions on CPU tensors;
  * ``impl="pallas"``, ``attn_impl="chained"``: per block K8 with the LN1
    prologue for the packed qkv, ``ops/attention.attention`` (K6f on the
    card at S in its window, head_dim 72, bf16), K8 with the residual for
    the out-projection, then K9 -> K10; the patch embed through K8;
  * ``impl="xla"`` (any ``attn_impl``): per GEMM ``ops/quant.quant_dense``
    (the int8 product through ``torch._int_mm`` on a card, exact either
    way), LN1/LN2 in the compute dtype (eps 1e-6), gelu_tanh after the
    dequantize, ``attention`` for the core.

JAX's ``"auto"`` picks ``"xla"`` off the TPU; the port's picks the kernel
route, its serving path.  An unknown route raises.  The weights are
quantized once, from the fp32 parameters (``load`` keeps them fp32 whatever
the compute dtype), into the kernels' K-major layout
(``ops/quant_matmul.int8_weight``); the dict keeps the JAX package's names
and shapes.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from ..ops.attention import attention
from ..ops.quant import quantize_weight
from ..ops.quant_matmul import (int8_attn_weights, int8_weight,
                                quant_attn_block_split,
                                quant_matmul_fused_qout, quant_matmul_q8in,
                                regroup_attn_weights)
from . import quant_vit
from .fast_siglip import _map_pool, siglip_attn_groups
from .siglip import LN_EPS, SigLIPConfig, SigLIPModel


def _vec(t):
    return t.detach().float().contiguous()


def _dense(linear: torch.nn.Linear) -> Dict:
    """A Linear's [out, in] weight as JAX's [in, out] kernel, quantized."""
    w8, ws = quantize_weight(linear.weight.detach().t())
    return {"w8": int8_weight(w8), "scale": ws, "bias": _vec(linear.bias)}


def quantize_siglip_block(blk, heads: int = 0, n_groups: int = 0) -> Dict:
    """Quantize one ``SigLIPBlock``'s GEMM weights: q/k/v PACKED into one
    [W, 3W] GEMM; with ``heads``/``n_groups`` the head-group regrouping of
    K13 is done here too, once (``quant_siglip.py:42-87``)."""
    at = blk.attn
    w8, ws = quantize_weight(torch.cat([p.weight.detach().t() for p in
                                        (at.q_proj, at.k_proj, at.v_proj)],
                                       dim=1))
    q = {"attn/qkv": {"w8": w8, "scale": ws, "bias": torch.cat(
        [_vec(p.bias) for p in (at.q_proj, at.k_proj, at.v_proj)])}}
    q["attn/out_proj"] = _dense(at.out_proj)
    q["mlp/c_fc"] = _dense(blk.mlp.c_fc)
    q["mlp/c_proj"] = _dense(blk.mlp.c_proj)
    for name in ("ln_1", "ln_2"):
        ln = getattr(blk, name)
        q[name] = {"scale": _vec(ln.weight), "bias": _vec(ln.bias)}
    if heads and n_groups:
        wg, sg, bg, og = regroup_attn_weights(
            w8, ws, q["attn/qkv"]["bias"], q["attn/out_proj"]["w8"], heads,
            n_groups)
        wg, og = int8_attn_weights(wg, og)
        q["attn/qkv_g"] = {"w8_g": wg, "scale_g": sg, "bias_g": bg,
                           "out_g": og}
    q["attn/qkv"]["w8"] = int8_weight(w8)
    return q


def quantize_siglip_params(model: SigLIPModel, config: SigLIPConfig) -> Dict:
    """Quantize the SigLIP vision tower's GEMM weights once
    (``quant_siglip.py:90-116``), on the model's device."""
    vp = model.visual
    k8, ks = quantize_weight(vp.patch_kernel().detach())
    n_groups = siglip_attn_groups(config)
    return {
        "conv1": {"w8": int8_weight(k8), "scale": ks,
                  "bias": _vec(vp.conv1.bias)},
        "positional_embedding": vp.positional_embedding.detach(),
        "transformer": {
            f"resblocks_{i}": quantize_siglip_block(blk, config.vision_heads,
                                                    n_groups)
            for i, blk in enumerate(vp.transformer.resblocks)},
    }


IMPLS = ("auto", "pallas", "xla")
ATTN_IMPLS = ("auto", "split", "chained")


# JAX's per-GEMM routes, at SigLIP's LN eps (the ViT's 1e-5 is the default)
_qmm_xla = functools.partial(quant_vit._qmm_xla, ln_eps=LN_EPS)
_qmm_kernel = functools.partial(quant_vit._qmm_kernel, ln_eps=LN_EPS)


def apply_int8_siglip_blocks(qblocks: Dict, x: torch.Tensor,
                             config: SigLIPConfig, *, start: int,
                             stop: int, use_pallas: bool = True,
                             use_split_attn: bool = True) -> torch.Tensor:
    """SigLIP blocks [start, stop) over x [B, S, W] (forward only; also the
    int8 frozen prefix of the PEFT step, on the split route), JAX's three
    routes (``quant_siglip.py:119-203``): ``use_split_attn`` (with
    ``use_pallas``) K13 -> K9 -> K10; ``use_pallas`` alone the chained
    route, K8 + LN for qkv, ``attention``, K8 + residual, K9 -> K10;
    neither, ``quant_dense`` per GEMM with ``attention``.  ``qblocks`` is
    {resblocks_i: quantize_siglip_block(...)}, regrouped at quantize time;
    the residual stream stays in x's dtype."""
    heads, width = config.vision_heads, config.vision_width
    b, s, _ = x.shape
    x2 = x.reshape(b * s, width)
    qmm = _qmm_kernel if use_pallas else _qmm_xla
    for i in range(start, stop):
        blk = qblocks[f"resblocks_{i}"]
        out_q = blk["attn/out_proj"]
        if use_pallas and use_split_attn:
            g = blk["attn/qkv_g"]
            # the stored grouping wins: the hybrid prefix quantizes with its
            # own
            x2 = quant_attn_block_split(
                x2.reshape(b, s, width), g["w8_g"], g["scale_g"],
                g["bias_g"], g["out_g"], out_q["scale"], out_q["bias"],
                blk["ln_1"]["scale"], blk["ln_1"]["bias"], heads,
                int(g["w8_g"].shape[0]), ln_eps=LN_EPS).reshape(b * s, width)
        else:
            qkv = qmm(x2, blk["attn/qkv"], ln=blk["ln_1"])
            # K6f takes contiguous q, k and v (JAX's split makes arrays)
            q, k, v = (t.contiguous() for t in
                       qkv.reshape(b, s, 3 * width).split(width, dim=-1))
            attn = attention(q, k, v, heads).reshape(b * s, width)
            x2 = qmm(attn, out_q, residual=x2)
        fc, pr = blk["mlp/c_fc"], blk["mlp/c_proj"]
        if use_pallas:
            hdn8, hsc = quant_matmul_fused_qout(
                x2, fc["w8"], fc["scale"], fc["bias"], blk["ln_2"]["scale"],
                blk["ln_2"]["bias"], act="gelu_tanh", ln_eps=LN_EPS)
            x2 = quant_matmul_q8in(hdn8, hsc, pr["w8"], pr["scale"],
                                   pr["bias"], residual=x2)
        else:
            hdn = qmm(x2, fc, act="gelu_tanh", ln=blk["ln_2"])
            x2 = qmm(hdn, pr, residual=x2)
    return x2.reshape(b, s, width)


def siglip_patchify_int8(qparams: Dict, images: torch.Tensor,
                         config: SigLIPConfig, dtype=torch.bfloat16, *,
                         use_pallas: bool = True):
    """images [B, H, W, 3] -> tokens [B, S, W] in ``dtype``: im2col + K8
    (conv bias in its epilogue; ``quant_dense`` off the kernel route) +
    the positional embedding."""
    p = config.patch_size
    x = images.to(dtype)
    b, h, w, c = x.shape
    gh, gw = h // p, w // p
    patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b * gh * gw, p * p * c)
    qmm = _qmm_kernel if use_pallas else _qmm_xla
    x = qmm(patches, qparams["conv1"]).reshape(b, gh * gw, config.vision_width)
    return x + qparams["positional_embedding"].to(x.dtype)


def siglip_encode_int8(qparams: Dict, model: SigLIPModel,
                       images: torch.Tensor, config: SigLIPConfig, *,
                       project: bool = False, dtype=torch.bfloat16,
                       impl: str = "auto", attn_impl: str = "auto"):
    """images [B, H, W, 3] normalized NHWC -> pooled SigLIP embedding (or
    ``(pooled, pooled)`` with ``project=True``).  ``qparams`` from
    ``quantize_siglip_params``; ``model`` carries the original weights of
    ``ln_post`` and the MAP head.  ``impl`` (``IMPLS``) and ``attn_impl``
    (``ATTN_IMPLS``) name JAX's route (module docstring); ``"auto"`` is the
    split kernel route."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    use_pallas = impl != "xla"
    use_split = use_pallas and attn_impl != "chained"
    x = siglip_patchify_int8(qparams, images, config, dtype,
                             use_pallas=use_pallas)
    x = apply_int8_siglip_blocks(qparams["transformer"], x, config, start=0,
                                 stop=config.vision_layers,
                                 use_pallas=use_pallas,
                                 use_split_attn=use_split)
    pooled = _map_pool(model, x)
    return (pooled, pooled) if project else pooled
