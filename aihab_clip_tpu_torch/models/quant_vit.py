"""int8 (W8A8 dynamic) CLIP ViT encode for serving, and the int8 frozen
prefix of the PEFT step (counterpart of ``aihab_clip_tpu/models/quant_vit.py``).

The JAX module's kernel recipe on the CLIP layout (packed q|k|v, quick_gelu
or gelu MLP, LN eps 1e-5, CLS token + ``ln_post`` + ``proj``):

  * the patchify conv as an im2col int8 GEMM with no bias
    (``quant_matmul_fused``, K8), then the class token, the positional
    embedding and ``ln_pre`` in the compute dtype;
  * per block the merged int8 block ``quant_full_block_fused`` (K14), or
    with ``merge_blocks="off"`` its two halves ``quant_attn_block_fused``
    (K12) and ``quant_mlp_block_fused`` (K11); ``apply_int8_vit_blocks``
    over a ``split_int8_plan`` runs JAX's route for the wide towers: K12 or
    the head-group split ``quant_attn_block_split`` (K13), then the chained
    ``quant_matmul_fused_qout`` -> ``quant_matmul_q8in`` (K9 -> K10);
  * ``ln_post(CLS)`` and ``proj`` in the compute dtype (one token: plain
    PyTorch, as the JAX package left it to XLA).

Only the kernel route (JAX ``impl="pallas"``) is ported: here the kernels
run on CUDA tensors and their plain versions on CPU tensors.  JAX's
``impl="xla"`` and ``"chained"`` routes (its CPU reference and an A/B route)
raise.  The weights are quantized once, from the fp32 parameters, into the
kernels' K-major layout (``ops/quant_matmul.int8_weight``); the dict keeps
the JAX package's names and shapes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..ops.quant import quantize_weight
from ..ops.quant_matmul import (int8_attn_weights, int8_weight,
                                quant_attn_block_fused,
                                quant_attn_block_split,
                                quant_full_block_fused, quant_matmul_fused,
                                quant_matmul_fused_qout, quant_matmul_q8in,
                                quant_mlp_block_fused, regroup_attn_weights)
from .clip import CLIPConfig
from .fast_vit import _ln


def _vec(t):
    return t.detach().float().contiguous()


def _dense(w_in_out: torch.Tensor, bias: torch.Tensor) -> Dict:
    w8, ws = quantize_weight(w_in_out.detach())
    return {"w8": int8_weight(w8), "scale": ws, "bias": _vec(bias)}


def quantize_vit_block(blk) -> Dict:
    """Quantize one ``ResidualAttentionBlock``'s GEMM weights (JAX's [in,
    out] kernels, per-output-channel int8) with its LNs passed through
    (``quant_vit.py:47-62``)."""
    at, mlp = blk.attn, blk.mlp
    q = {"attn/in_proj": _dense(at.in_proj_weight.t(), at.in_proj_bias),
         "attn/out_proj": _dense(at.out_proj.weight.t(), at.out_proj.bias),
         "mlp/c_fc": _dense(mlp.c_fc.weight.t(), mlp.c_fc.bias),
         "mlp/c_proj": _dense(mlp.c_proj.weight.t(), mlp.c_proj.bias)}
    for name in ("ln_1", "ln_2"):
        ln = getattr(blk, name)
        q[name] = {"scale": _vec(ln.weight), "bias": _vec(ln.bias)}
    return q


def quantize_vit_params(model, config: CLIPConfig) -> Dict:
    """Quantize the ViT tower's GEMM weights once (``quant_vit.py:65-90``),
    on the model's device; everything else passes through."""
    vp = model.visual
    k8, ks = quantize_weight(vp.patch_kernel().detach())

    def ln(m):
        return {"scale": _vec(m.weight), "bias": _vec(m.bias)}

    return {
        "conv1": {"w8": int8_weight(k8), "scale": ks},
        "class_embedding": vp.class_embedding.detach(),
        "positional_embedding": vp.positional_embedding.detach(),
        "ln_pre": ln(vp.ln_pre),
        "ln_post": ln(vp.ln_post),
        "proj": vp.proj.detach(),
        "transformer": {f"resblocks_{i}": quantize_vit_block(blk)
                        for i, blk in enumerate(vp.transformer.resblocks)},
    }


def _kernel_act(config) -> str:
    """The kernels' activation for this tower (``quant_vit.py:94-105``):
    exact ``gelu`` runs as ``gelu_poly``, JAX's default form, unless
    ``AIHAB_NO_GELU_POLY`` is set (read at each call): then it stays
    ``gelu``, which JAX sends to its XLA route."""
    if config.act == "gelu" and not os.environ.get("AIHAB_NO_GELU_POLY"):
        return "gelu_poly"
    return config.act


def int8_block_plan(config: CLIPConfig, merge_blocks: str = "auto") -> Dict:
    """Kernel dispatch for the int8 block stack, from H100 facts.

    The TPU plan (``quant_vit.py:172-214``) gated the merged block K14 on a
    VMEM estimate of its resident int8 weights and fp32 working set, and
    long sequences on the head-group split K13.  These kernels stream weight
    tiles through shared memory and hold no whole weight, so neither gate
    applies: every CLIP ViT takes K14, which keeps the mid-block residual in
    fp32.  ``merge_blocks="off"`` runs K12 + K11 instead, rounding that
    residual to x's dtype between them as JAX's two-kernel route does, the
    way ``fast_vit.vit_encode_block_fused`` runs K2 + K3.  K13
    (``attn_groups`` > 0) and the chained K9 -> K10 MLP (``mlp="chained"``,
    ``mlp_chunks`` slices) are reached only through an explicit plan."""
    if merge_blocks not in ("auto", "off"):
        raise ValueError(f"merge_blocks {merge_blocks!r} not 'auto'/'off'")
    act = _kernel_act(config)
    if act == "gelu":
        raise NotImplementedError(
            "exact gelu under AIHAB_NO_GELU_POLY: JAX's int8 encode takes "
            "its XLA route (impl='xla', quant_vit.py:300-306), which is not "
            "ported; only the kernel path ('pallas') is (ROADMAP A15)")
    return dict(merge=merge_blocks != "off", attn_groups=0, mlp="whole",
                mlp_chunks=1, act=act)


def split_int8_plan(config: CLIPConfig, attn_groups: int,
                    mlp_chunks: int) -> Dict:
    """JAX's two-kernel int8 route (``quant_vit.py:165-215, 266-290``): per
    block K13 over ``attn_groups`` head groups (0: K12, every head in one),
    then the chained K9 -> K10 MLP over ``mlp_chunks`` hidden slices.  JAX's
    TPU gates take it for ViT-H/14 (K12, 1 slice), ViT-g/14 and ViT-bigG/14
    (8 groups, 2 slices); the H100 plan never does."""
    heads = config.vision_heads
    hidden = config.vision_mlp_dim or 4 * config.vision_width
    if attn_groups < 0 or (attn_groups and heads % attn_groups) \
            or mlp_chunks < 1 or hidden % mlp_chunks:
        raise ValueError(f"{attn_groups} groups of {heads} heads or "
                         f"{mlp_chunks} slices of {hidden} do not divide")
    return dict(int8_block_plan(config, "off"), attn_groups=attn_groups,
                mlp="chained", mlp_chunks=mlp_chunks)


def _chained_int8_mlp(x2, fc, pr, ln, *, act: str, n_ch: int):
    """The chained K9 -> K10 MLP over ``n_ch`` hidden slices, the c_proj
    bias added once (``quant_vit.py:108-139``)."""
    ch = fc["w8"].shape[1] // n_ch
    acc = x2
    for c in range(n_ch):
        sl = slice(c * ch, (c + 1) * ch)
        hdn8, hsc = quant_matmul_fused_qout(
            x2, fc["w8"][:, sl], fc["scale"][sl], fc["bias"][sl],
            ln["scale"], ln["bias"], act=act)
        acc = quant_matmul_q8in(
            hdn8, hsc, pr["w8"][sl, :], pr["scale"],
            pr["bias"] if c == 0 else torch.zeros_like(pr["bias"]),
            residual=acc)
    return acc


def apply_int8_vit_blocks(qblocks: Dict, x: torch.Tensor, config: CLIPConfig,
                          *, start: int, stop: int,
                          plan: Optional[Dict] = None) -> torch.Tensor:
    """Blocks [start, stop) over the int8 kernels (forward only; also the
    int8 frozen prefix of the PEFT step, ``fast_vit.vit_encode_hybrid``).
    ``qblocks`` is {resblocks_i: ``quantize_vit_block``}; x [B, S, W] tokens
    after ``ln_pre``; ``plan`` from ``int8_block_plan`` (default: K14 for
    every block).  The residual stream leaves each block in x's dtype."""
    plan = plan or int8_block_plan(config)
    heads, width = config.vision_heads, config.vision_width
    act = plan["act"]
    b, s, _ = x.shape
    for i in range(start, stop):
        blk = qblocks[f"resblocks_{i}"]
        ip, op = blk["attn/in_proj"], blk["attn/out_proj"]
        fc, pr = blk["mlp/c_fc"], blk["mlp/c_proj"]
        if plan["merge"]:
            x = quant_full_block_fused(
                x, ip["w8"], ip["scale"], ip["bias"], op["w8"], op["scale"],
                op["bias"], blk["ln_1"]["scale"], blk["ln_1"]["bias"],
                fc["w8"], fc["scale"], fc["bias"], pr["w8"], pr["scale"],
                pr["bias"], blk["ln_2"]["scale"], blk["ln_2"]["bias"], heads,
                act=act)
            continue
        if plan["attn_groups"]:
            wg, sg, bg, og = regroup_attn_weights(
                ip["w8"], ip["scale"], ip["bias"], op["w8"], heads,
                plan["attn_groups"])
            wg, og = int8_attn_weights(wg, og)
            x = quant_attn_block_split(
                x, wg, sg, bg, og, op["scale"], op["bias"],
                blk["ln_1"]["scale"], blk["ln_1"]["bias"], heads,
                plan["attn_groups"])
        else:
            x = quant_attn_block_fused(
                x, ip["w8"], ip["scale"], ip["bias"], op["w8"], op["scale"],
                op["bias"], blk["ln_1"]["scale"], blk["ln_1"]["bias"], heads)
        x2 = x.reshape(b * s, width)
        if plan["mlp"] == "chained":
            x2 = _chained_int8_mlp(x2, fc, pr, blk["ln_2"], act=act,
                                   n_ch=plan["mlp_chunks"])
        else:
            x2 = quant_mlp_block_fused(
                x2, fc["w8"], fc["scale"], fc["bias"], pr["w8"], pr["scale"],
                pr["bias"], blk["ln_2"]["scale"], blk["ln_2"]["bias"],
                act=act)
        x = x2.reshape(b, s, width)
    return x


def vit_patchify_int8(qparams: Dict, images: torch.Tensor,
                      config: CLIPConfig, dtype=torch.bfloat16):
    """images [B, H, W, 3] -> tokens [B, S, W] in ``dtype``: im2col + K8 (no
    bias; at patch 14, K = 588 in a 592-wide padding), the class token, the
    positional embedding and ``ln_pre``."""
    p = config.vision_patch_size
    x = images.to(dtype)
    b, h, w, c = x.shape
    gh, gw = h // p, w // p
    patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b * gh * gw, p * p * c)
    cq = qparams["conv1"]
    x = quant_matmul_fused(patches, cq["w8"], cq["scale"],
                           torch.zeros_like(cq["scale"]))
    x = x.reshape(b, gh * gw, config.vision_width)
    cls = qparams["class_embedding"].to(dtype).expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + qparams["positional_embedding"].to(dtype)
    return _ln(x, qparams["ln_pre"]["scale"], qparams["ln_pre"]["bias"])


def vit_encode_int8(qparams: Dict, images: torch.Tensor, config: CLIPConfig,
                    *, project: bool = False, dtype=torch.bfloat16,
                    impl: str = "auto", merge_blocks: str = "auto"):
    """images [B, H, W, 3] normalized NHWC -> pre-projection CLS features
    (or ``(pre, projected)``).  ``qparams`` from ``quantize_vit_params``.
    ``impl`` names the JAX route: only the kernel path (``"pallas"``, which
    ``"auto"`` picks on the TPU) is ported.  ``merge_blocks``: 'auto' (K14)
    or 'off' (K12 + K11)."""
    if impl not in ("pallas", "auto"):
        raise NotImplementedError(
            f"vit_encode_int8 impl={impl!r}: only the kernel path ('pallas') "
            "is ported; CPU tensors run its plain versions")
    plan = int8_block_plan(config, merge_blocks)
    x = vit_patchify_int8(qparams, images, config, dtype)
    x = apply_int8_vit_blocks(qparams["transformer"], x, config, start=0,
                              stop=config.vision_layers, plan=plan)
    pre = _ln(x[:, 0, :], qparams["ln_post"]["scale"],
              qparams["ln_post"]["bias"])
    if not project:
        return pre
    return pre, pre @ qparams["proj"].to(pre.dtype)
