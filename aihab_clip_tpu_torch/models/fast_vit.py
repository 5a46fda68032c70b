"""Fast ViT encode: the CLIP vision tower over the Hopper block kernels
(counterpart of ``aihab_clip_tpu/models/fast_vit.py``).  SigLIP towers
dispatch to ``fast_siglip`` and ConvNeXt towers to ``fast_convnext`` from
``pack_fastest`` and ``encode_image_fastest``.

``pack_fastest`` lays the tower's weights out once, at load, in the
kernels' layout (GEMM weights [in, out] contiguous in the compute dtype, LN
and bias vectors fp32); ``vit_encode_block_fused`` runs patchify + the
block stack + ``ln_post(CLS)`` + ``proj`` over that pack: K1 per block by
the H100 plan, or K2 + K3 with ``merge_blocks="off"``.  JAX's TPU route for
the wide towers (ViT-H/g/bigG), K5 over head groups + K4 over hidden
chunks, is a ``split_block_plan`` for ``_apply_fused_blocks``.  The patch-embed
and projection products stay ``torch.matmul``, as the JAX package left
them to XLA; every block GEMM and the attention run in the hand-written
kernels of ``ops/block_kernel.py`` when the pack lives on the card, and in
their plain versions on the CPU.

``vit_encode_fast`` is JAX's per-op encode over the same pack: per block
``ln_matmul`` (LN1 + qkv), the plain attention, ``matmul_residual``
(out-proj + x), ``ln_matmul`` (LN2 + c_fc + act) and ``matmul_residual``
(c_proj + x), the K16 kernels of ``ops/fused_linear.py``.  The block
stack's per-op MLP (``_apply_fused_blocks`` with ``mlp_whole`` off, which
``AIHAB_NO_GELU_POLY=1`` selects for exact-``gelu`` towers) runs the same
pair after K2.

``vit_encode_hybrid`` is the PEFT train step's encode: the frozen bottom
``n_prefix`` blocks through K1 over a pack of those blocks (or, with
``qprefix``, the int8 block K14 of ``quant_vit``) without a graph, then the
trainable blocks as the canonical ``ResidualAttentionBlock`` modules under
autograd.  ``vit_encode_train`` is JAX's differentiable tower with the MLP
half through K17 (``ops/block_kernel.mlp_block_train``) forward and
backward; ``use_fused_train_encode`` is its gate.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..ops.attention import dot_product_attention
from ..ops.block_kernel import (ACTS, attn_block_fused, attn_block_split,
                                full_block_fused, mlp_block_fused,
                                mlp_block_split, mlp_block_train,
                                regroup_attn_weights_f)
from ..ops.fused_linear import ln_matmul, matmul_residual
from .clip import CLIPConfig
from .fast_convnext import convnext_encode_fused, pack_convnext
from .fast_siglip import pack_siglip_fast_params, siglip_encode_fast
from .siglip import SigLIPConfig


def _ln(x, scale, bias, eps=1e-5):
    y = torch.nn.functional.layer_norm(x.float(), scale.shape, scale, bias, eps)
    return y.to(x.dtype)


def pack_fastest(model, config, dtype=torch.bfloat16, *,
                 stop: Optional[int] = None):
    """Weights of a CLIP ViT, ConvNeXt or SigLIP tower in the kernels'
    layout, on the model's device, for blocks [0, stop) (default all; the
    PEFT hybrid packs its frozen CLIP prefix).  Built once at load (or once
    per training run); ``None`` for towers without a fast path."""
    if isinstance(config, SigLIPConfig):
        return pack_siglip_fast_params(model, config, dtype, stop=stop)
    if isinstance(config, CLIPConfig) and config.tower == "convnext":
        return pack_convnext(model, config, dtype, stop=stop)
    if not (isinstance(config, CLIPConfig) and config.is_vit):
        return None
    vp = model.visual

    def mat(t):       # torch [out, in] -> kernel [in, out], compute dtype
        return t.detach().T.to(dtype).contiguous()

    def vec(t):
        return t.detach().float().contiguous()

    blocks = []
    for blk in vp.transformer.resblocks[:stop]:
        blocks.append(dict(
            ln1_scale=vec(blk.ln_1.weight), ln1_bias=vec(blk.ln_1.bias),
            w_qkv=mat(blk.attn.in_proj_weight), b_qkv=vec(blk.attn.in_proj_bias),
            w_out=mat(blk.attn.out_proj.weight), b_out=vec(blk.attn.out_proj.bias),
            ln2_scale=vec(blk.ln_2.weight), ln2_bias=vec(blk.ln_2.bias),
            w_fc=mat(blk.mlp.c_fc.weight), b_fc=vec(blk.mlp.c_fc.bias),
            w_proj=mat(blk.mlp.c_proj.weight), b_proj=vec(blk.mlp.c_proj.bias)))
    return dict(
        dtype=dtype,
        patch_kernel=vp.patch_kernel().detach().to(dtype).contiguous(),
        class_embedding=vp.class_embedding.detach().to(dtype),
        positional_embedding=vp.positional_embedding.detach().to(dtype),
        ln_pre=(vec(vp.ln_pre.weight), vec(vp.ln_pre.bias)),
        blocks=blocks,
        ln_post=(vec(vp.ln_post.weight), vec(vp.ln_post.bias)),
        proj=vp.proj.detach().to(dtype).contiguous())


def _vit_embed(packed, images: torch.Tensor, config: CLIPConfig):
    """Patchify-as-matmul, class token, positional embedding, ln_pre ->
    [B, S, W] tokens in the pack's dtype."""
    p = config.vision_patch_size
    x = images.to(packed["dtype"])
    b, h, w, c = x.shape
    patches = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = patches.reshape(b, (h // p) * (w // p), p * p * c) @ packed["patch_kernel"]
    cls = packed["class_embedding"].expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + packed["positional_embedding"]
    return _ln(x, *packed["ln_pre"])


def _fused_block_plan(config: CLIPConfig, merge_blocks: str = "auto"):
    """Kernel dispatch for the block stack, from H100 facts.

    The TPU plan gated each kernel on a VMEM byte budget, because its
    kernels keep a block's weights resident.  These kernels stream weight
    tiles through shared memory and hold no whole weight, so no width needs
    a split path: any CLIP ViT whose activation the kernels compute takes
    the merged block (K1), which keeps the mid-block residual in fp32.
    ``merge_blocks="off"`` runs the two-kernel halves (K2 + K3) instead,
    rounding that residual to the compute dtype between them, as the TPU
    path does.  JAX's split route (K5 + K4) is reached only through
    ``split_block_plan``.  Exact-erf ``gelu`` towers use the kernels' ``gelu_poly``,
    unless ``AIHAB_NO_GELU_POLY`` is set (read at each call, as in JAX,
    ``fast_vit.py:429-440``): then the activation stays ``gelu``, which no
    block kernel computes, and each block runs K2 and the per-op MLP
    (``ln_matmul`` with exact gelu, ``matmul_residual``)."""
    gelu_poly = (config.act == "gelu"
                 and not os.environ.get("AIHAB_NO_GELU_POLY"))
    act = "gelu_poly" if gelu_poly else config.act
    kernel_act_ok = act in ACTS and act != "none"
    return dict(merge=kernel_act_ok and merge_blocks != "off",
                attn_split=False, mlp_whole=kernel_act_ok, mlp_chunks=0,
                full_chunks=1, heads=config.vision_heads,
                width=config.vision_width, act=act)


def split_block_plan(config: CLIPConfig, n_groups: int, mlp_chunks: int):
    """JAX's split route for a CLIP tower (``fast_vit.py:410-481``): per
    block K5 (``attn_block_split``) over ``n_groups`` head groups, then K4
    (``mlp_block_split``) over ``mlp_chunks`` hidden chunks.  JAX's TPU plan
    takes it where a block's weights overflow its VMEM budgets (ViT-H/14,
    ViT-g/14, ViT-bigG/14 at 8-10 groups and 3-8 chunks); the H100 plan
    never does, so it is an explicit plan, for parity and A/B."""
    heads = config.vision_heads
    hidden = config.vision_mlp_dim or 4 * config.vision_width
    if n_groups < 1 or heads % n_groups or mlp_chunks < 1 \
            or hidden % mlp_chunks:
        raise ValueError(f"{n_groups} groups of {heads} heads or "
                         f"{mlp_chunks} chunks of {hidden} do not divide")
    plan = _fused_block_plan(config, "off")
    if not plan["mlp_whole"]:
        raise NotImplementedError("K4 computes no exact gelu: "
                                  "AIHAB_NO_GELU_POLY is set")
    return dict(plan, attn_split=True, n_groups=n_groups, mlp_whole=False,
                mlp_chunks=mlp_chunks)


def _apply_fused_blocks(packed, x, plan, *, start: int, stop: int):
    """Run blocks [start, stop) through the block kernels: K1, or K2 (K5
    with ``attn_split``, over head groups regrouped at each call, as JAX
    does) then K3 (``mlp_whole``), K4 (``mlp_chunks``) or the per-op pair
    ``ln_matmul`` -> ``matmul_residual`` (K16).  Unlike JAX's two-kernel
    route, no padding of S to 16: the kernels mask their ragged edges."""
    heads, act = plan["heads"], plan["act"]
    b, s, w = x.shape
    for blk in packed["blocks"][start:stop]:
        if plan["merge"]:
            x = full_block_fused(x, **blk, heads=heads,
                                 mlp_chunks=plan["full_chunks"], act=act)
            continue
        if plan["attn_split"]:
            wg, bg, og = regroup_attn_weights_f(
                blk["w_qkv"], blk["b_qkv"], blk["w_out"], heads,
                plan["n_groups"])
            x = attn_block_split(x, wg, bg, og, blk["b_out"],
                                 blk["ln1_scale"], blk["ln1_bias"], heads,
                                 plan["n_groups"])
        else:
            x = attn_block_fused(x, blk["ln1_scale"], blk["ln1_bias"],
                                 blk["w_qkv"], blk["b_qkv"], blk["w_out"],
                                 blk["b_out"], heads)
        x2 = x.reshape(b * s, w)
        if plan["mlp_whole"]:
            x2 = mlp_block_fused(x2, blk["ln2_scale"], blk["ln2_bias"],
                                 blk["w_fc"], blk["b_fc"], blk["w_proj"],
                                 blk["b_proj"], act=act)
        elif plan["mlp_chunks"]:
            x2 = mlp_block_split(x2, blk["ln2_scale"], blk["ln2_bias"],
                                 blk["w_fc"], blk["b_fc"], blk["w_proj"],
                                 blk["b_proj"], n_chunks=plan["mlp_chunks"],
                                 act=act)
        else:
            hdn = ln_matmul(x2, blk["ln2_scale"], blk["ln2_bias"],
                            blk["w_fc"], blk["b_fc"], act)
            x2 = matmul_residual(hdn, blk["w_proj"], blk["b_proj"], x2)
        x = x2.reshape(b, s, w)
    return x


def vit_encode_fast(packed, images: torch.Tensor, config: CLIPConfig, *,
                    project: bool = False):
    """images [B, H, W, 3] normalized NHWC -> pre-projection CLS features
    (or ``(pre, projected)``) through the per-op kernels (``fast_vit.py:93``):
    per block ``ln_matmul`` -> plain attention (JAX's ``_xla_attention``,
    outside Pallas there too) -> ``matmul_residual`` -> ``ln_matmul`` with
    the tower's activation (exact ``gelu`` plain, as JAX dispatches it) ->
    ``matmul_residual``; 2 + 2 K16 launches per block.  ``packed`` from
    ``pack_fastest``."""
    x = _per_op_blocks(packed, _vit_embed(packed, images, config), config)
    pre = _ln(x[:, 0, :], *packed["ln_post"])
    if not project:
        return pre
    return pre, pre @ packed["proj"]


def _per_op_blocks(packed, x, config: CLIPConfig):
    """``vit_encode_fast``'s block stack over tokens x [B, S, W]."""
    b, s, w = x.shape
    heads = config.vision_heads
    x2 = x.reshape(b * s, w)
    for blk in packed["blocks"][:config.vision_layers]:
        qkv = ln_matmul(x2, blk["ln1_scale"], blk["ln1_bias"], blk["w_qkv"],
                        blk["b_qkv"])
        q, k, v = qkv.reshape(b, s, 3 * w).chunk(3, dim=-1)
        attn = dot_product_attention(q, k, v, heads).reshape(b * s, w)
        x2 = matmul_residual(attn, blk["w_out"], blk["b_out"], x2)
        hdn = ln_matmul(x2, blk["ln2_scale"], blk["ln2_bias"], blk["w_fc"],
                        blk["b_fc"], config.act)
        x2 = matmul_residual(hdn, blk["w_proj"], blk["b_proj"], x2)
    return x2.reshape(b, s, w)


def vit_encode_block_fused(packed, images: torch.Tensor, config: CLIPConfig,
                           *, project: bool = False,
                           merge_blocks: str = "auto"):
    """images [B, H, W, 3] normalized NHWC -> pre-projection CLS features
    (or ``(pre, projected)``), every block through the block kernels.
    ``packed`` comes from ``pack_fastest``; ``merge_blocks``: 'auto' or
    'off' (the K2 + K3 halves)."""
    x = _vit_embed(packed, images, config)
    plan = _fused_block_plan(config, merge_blocks)
    x = _apply_fused_blocks(packed, x, plan, start=0,
                            stop=config.vision_layers)
    pre = _ln(x[:, 0, :], *packed["ln_post"])
    if not project:
        return pre
    return pre, pre @ packed["proj"]


def encode_image_fastest(model, x: torch.Tensor, config, *,
                         project: bool = False, packed=None):
    """The fastest image encode for where ``x`` lives: CLIP ViT, ConvNeXt
    and SigLIP towers on the card take the block kernels (``packed`` from
    ``pack_fastest``, required there); the CPU runs the canonical module."""
    on_card = x.is_cuda and (isinstance(config, SigLIPConfig) or (
        isinstance(config, CLIPConfig)
        and (config.is_vit or config.tower == "convnext")))
    if not on_card:
        return model.encode_image(x, project=project)
    if packed is None:
        raise ValueError("the card path needs packed=pack_fastest(...), "
                         "built once at load")
    if isinstance(config, SigLIPConfig):
        return siglip_encode_fast(model, x, config, project=project,
                                  packed=packed)
    if config.tower == "convnext":
        return convnext_encode_fused(packed, x, config, project=project)
    return vit_encode_block_fused(packed, x, config, project=project)


def _stem(vp, dtype):
    """The canonical tower's stem weights in ``dtype``, differentiable."""
    return dict(dtype=dtype, patch_kernel=vp.patch_kernel().to(dtype),
                class_embedding=vp.class_embedding.to(dtype),
                positional_embedding=vp.positional_embedding.to(dtype),
                ln_pre=(vp.ln_pre.weight, vp.ln_pre.bias))


def vit_encode_hybrid(model, images: torch.Tensor, config: CLIPConfig,
                      n_prefix: int, *, project: bool = False,
                      dtype=torch.bfloat16,
                      packed_prefix: Optional[Dict] = None,
                      qprefix: Optional[Dict] = None):
    """The PEFT train step's encode (``fast_vit.py:687-739``): the stem and
    the ``n_prefix`` FROZEN bottom blocks through K1 under
    ``torch.no_grad()`` (the counterpart of JAX's ``stop_gradient`` on the
    fused region's inputs: no graph is built there), then the canonical
    ``ResidualAttentionBlock`` modules ``[n_prefix, L)``, ``ln_post`` and
    ``proj`` under autograd, in ``dtype``.  ``packed_prefix``
    (``pack_fastest`` with ``stop=n_prefix``) is packed once per run by the
    caller; it is packed here when not given.  ``qprefix`` ({resblocks_i:
    ``quant_vit.quantize_vit_block``}) switches the prefix blocks to the
    int8 block K14; the stem stays in ``dtype``, as in JAX.  With
    ``n_prefix`` 0 the stem is differentiable too."""
    vp = model.visual
    if n_prefix > 0 and qprefix is None and packed_prefix is None:
        packed_prefix = pack_fastest(model, config, dtype, stop=n_prefix)
    # the stem's weights in dtype: the pack's, or the canonical tower's
    stem = packed_prefix or _stem(vp, dtype)
    if n_prefix > 0:
        with torch.no_grad():
            x = _vit_embed(stem, images, config)
            if qprefix is not None:
                from .quant_vit import apply_int8_vit_blocks

                x = apply_int8_vit_blocks(qprefix, x, config, start=0,
                                          stop=n_prefix)
            else:
                x = _apply_fused_blocks(stem, x, _fused_block_plan(config),
                                        start=0, stop=n_prefix)
    else:
        x = _vit_embed(stem, images, config)
    x = x.to(dtype)
    for blk in vp.transformer.resblocks[n_prefix:]:
        x = blk(x)
    pre = vp.ln_post(x[:, 0, :])
    if not project:
        return pre
    return pre, pre @ vp.proj.to(pre.dtype)


def vit_encode_train(model, images: torch.Tensor, config: CLIPConfig, *,
                     project: bool = False, dtype=torch.bfloat16):
    """The differentiable fast encode (``fast_vit.py:344-392``), every
    parameter of ``model``'s visual tower trainable: the stem, then per
    block the attention half as plain torch ops under autograd (JAX leaves
    it to XLA) and the MLP half through ``mlp_block_train`` (K17: one
    forward and one backward launch per block), then ``ln_post(CLS)`` and
    ``proj``, in ``dtype``.  The MLP is QuickGELU whatever ``config.act``
    says, as in JAX (``:378``)."""
    vp = model.visual
    x = _vit_embed(_stem(vp, dtype), images, config)
    b, s, w = x.shape
    heads = config.vision_heads
    for blk in vp.transformer.resblocks:
        att, mlp = blk.attn, blk.mlp
        ln1 = _ln(x, blk.ln_1.weight, blk.ln_1.bias)
        qkv = ln1 @ att.in_proj_weight.to(dtype).t() \
            + att.in_proj_bias.to(dtype)
        out = dot_product_attention(*qkv.chunk(3, dim=-1), heads) \
            @ att.out_proj.weight.to(dtype).t()
        x = x + out + att.out_proj.bias.to(dtype)
        x = mlp_block_train(
            x.reshape(b * s, w), blk.ln_2.weight, blk.ln_2.bias,
            mlp.c_fc.weight.to(dtype).t(), mlp.c_fc.bias,
            mlp.c_proj.weight.to(dtype).t(), mlp.c_proj.bias,
        ).reshape(b, s, w)
    pre = _ln(x[:, 0, :], vp.ln_post.weight, vp.ln_post.bias)
    if not project:
        return pre
    return pre, pre @ vp.proj.to(pre.dtype)


def _on_card(model) -> bool:
    return next(model.parameters()).is_cuda


def use_fused_train_encode(model, config, mesh=None,
                           dtype=torch.bfloat16) -> bool:
    """Dispatch gate of ``vit_encode_train`` (``fast_vit.py:395-407``): no
    mesh, a CLIP ViT, its parameters on the card (JAX: the TPU) and the
    bf16 compute dtype K17 stores.  JAX also bounded the MLP weight pair by
    a VMEM budget, because its kernel held both matrices resident; K17's
    GEMMs stream weight tiles through shared memory, so no width is
    refused."""
    if mesh is not None or dtype != torch.bfloat16:
        return False
    if not (isinstance(config, CLIPConfig) and config.is_vit):
        return False
    return _on_card(model)
