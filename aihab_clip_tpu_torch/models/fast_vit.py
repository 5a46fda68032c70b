"""Fast ViT encode: the CLIP vision tower over the Hopper block kernels
(counterpart of ``aihab_clip_tpu/models/fast_vit.py``).  SigLIP towers
dispatch to ``fast_siglip`` from ``pack_fastest`` and
``encode_image_fastest``.

``pack_fastest`` lays the tower's weights out once, at load, in the
kernels' layout (GEMM weights [in, out] contiguous in the compute dtype, LN
and bias vectors fp32); ``vit_encode_block_fused`` runs patchify + the
block stack + ``ln_post(CLS)`` + ``proj`` over that pack.  The patch-embed
and projection products stay ``torch.matmul``, as the JAX package left
them to XLA; every block GEMM and the attention run in the hand-written
kernels of ``ops/block_kernel.py`` when the pack lives on the card, and in
their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from ..ops.block_kernel import (ACTS, attn_block_fused, full_block_fused,
                                mlp_block_fused)
from .clip import CLIPConfig
from .fast_siglip import pack_siglip_fast_params, siglip_encode_fast
from .siglip import SigLIPConfig

def _ln(x, scale, bias, eps=1e-5):
    y = torch.nn.functional.layer_norm(x.float(), scale.shape, scale, bias, eps)
    return y.to(x.dtype)


def pack_fastest(model, config, dtype=torch.bfloat16):
    """Weights of a CLIP ViT or SigLIP tower in the kernels' layout, on the
    model's device.  Built once at load; ``None`` for towers without a fast
    path."""
    if isinstance(config, SigLIPConfig):
        return pack_siglip_fast_params(model, config, dtype)
    if not (isinstance(config, CLIPConfig) and config.is_vit):
        return None
    vp = model.visual

    def mat(t):       # torch [out, in] -> kernel [in, out], compute dtype
        return t.detach().T.to(dtype).contiguous()

    def vec(t):
        return t.detach().float().contiguous()

    blocks = []
    for blk in vp.transformer.resblocks:
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
    path does.  Exact-erf ``gelu`` towers use the kernels' ``gelu_poly``."""
    act = "gelu_poly" if config.act == "gelu" else config.act
    kernel_act_ok = act in ACTS and act != "none"
    return dict(merge=kernel_act_ok and merge_blocks != "off",
                attn_split=False, mlp_whole=kernel_act_ok, mlp_chunks=0,
                full_chunks=1, heads=config.vision_heads,
                width=config.vision_width, act=act)


def _apply_fused_blocks(packed, x, plan, *, start: int, stop: int):
    """Run blocks [start, stop) through the block kernels."""
    if plan["attn_split"] or plan["mlp_chunks"]:
        raise NotImplementedError(
            "the H100 plan splits no CLIP block: head-group attention "
            "(attn_block_split, K5) and the chunked MLP (mlp_block_split, "
            "K4) serve SigLIP's fast encode (models/fast_siglip.py)")
    if not plan["mlp_whole"]:
        raise NotImplementedError(
            "per-op ln_matmul / matmul_residual (K16) is not ported")
    heads, act = plan["heads"], plan["act"]
    b, s, w = x.shape
    for blk in packed["blocks"][start:stop]:
        if plan["merge"]:
            x = full_block_fused(x, **blk, heads=heads,
                                 mlp_chunks=plan["full_chunks"], act=act)
            continue
        x = attn_block_fused(x, blk["ln1_scale"], blk["ln1_bias"],
                             blk["w_qkv"], blk["b_qkv"], blk["w_out"],
                             blk["b_out"], heads)
        x = mlp_block_fused(x.reshape(b * s, w), blk["ln2_scale"],
                            blk["ln2_bias"], blk["w_fc"], blk["b_fc"],
                            blk["w_proj"], blk["b_proj"],
                            act=act).reshape(b, s, w)
    return x


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
    """The fastest image encode for where ``x`` lives: CLIP ViT and SigLIP
    towers on the card take the block kernels (``packed`` from
    ``pack_fastest``, required there); the CPU runs the canonical module."""
    on_card = x.is_cuda and (isinstance(config, SigLIPConfig) or (
        isinstance(config, CLIPConfig) and config.is_vit))
    if not on_card:
        return model.encode_image(x, project=project)
    if packed is None:
        raise ValueError("the card path needs packed=pack_fastest(...), "
                         "built once at load")
    if isinstance(config, SigLIPConfig):
        return siglip_encode_fast(model, x, config, project=project,
                                  packed=packed)
    return vit_encode_block_fused(packed, x, config, project=project)
