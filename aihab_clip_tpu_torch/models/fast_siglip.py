"""Fast SigLIP encodes: the SigLIP vision tower over the Hopper block
kernels (counterpart of ``aihab_clip_tpu/models/fast_siglip.py``).

``pack_siglip_fast_params`` lays the tower's weights out once, at load:
the separate q/k/v projections regrouped into head groups
(``regroup_attn_weights_f``) and then laid out as one [W, G*3gD] matrix,
so a single ``ln_gemm`` computes every group; the out-proj grouped as
[G, gD, W]; the MLP weights [in, out] in the compute dtype; LN and bias
vectors fp32.  ``siglip_encode_fast`` (serving, forward only) runs

  patchify (patch matmul + conv bias) + positional embedding
  -> per block: ``attn_block_split`` (K5) -> ``mlp_block_split`` (K4)
  -> ``ln_post`` -> MAP pooling head.

``siglip_encode_hybrid`` is the PEFT train step's encode: the frozen bottom
``n_prefix`` blocks through K5/K4 (or, with ``qprefix``, the int8 kernels
K13/K9/K10 of ``quant_siglip``) without a graph, then the trainable blocks
as the canonical ``SigLIPBlock`` modules under autograd (their attention
through the fused attention kernel, K6), then the MAP head.

The patch matmul, ``ln_post`` and the MAP head stay plain PyTorch (the JAX
package left them to XLA; the head pools one probe token).  The blocks run
in the hand-written kernels of ``ops/block_kernel.py`` when the pack lives
on the card and in their plain versions on the CPU.  The head grouping and
the chunk count keep the JAX values, which the TPU's VMEM chose (8 groups
of 2 heads and 2 chunks at SO400M), so the packed tensors and the rounding
points are the JAX path's.

The scanned encode (``fast_siglip.py:243-291``): eager PyTorch compiles
nothing, so there is no ``lax.scan`` to cut a compile, and
``siglip_encode_scan`` is the module tower itself, its blocks checkpointed
under ``scan_remat``.  The blocks' self-attention goes through
``ops.attention.attention``, so SO400M's S = 576 runs the fused kernel K6
forward and backward on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.block_kernel import (attn_block_split, mlp_block_split,
                                regroup_attn_weights_f)
from .layers import remat_blocks
from .siglip import LN_EPS, SigLIPConfig, SigLIPModel

# the TPU kernel's one-kernel MLP weight-pair budget in bytes
# (fast_vit.py:36), from which the JAX path derives its chunk count
MLP_WHOLE_KERNEL_MAX_BYTES = 11 * 2 ** 20


def siglip_attn_groups(config: SigLIPConfig, hybrid: bool = False) -> int:
    """Head groups of the JAX paths: 8 heads per group (4 for the PEFT
    hybrid prefix) for towers of width <= 1024, 2 for wider ones (SO400M:
    16 heads -> 8 groups either way), halved until it divides the heads;
    1 head per group when nothing does."""
    heads = config.vision_heads
    hpg = (4 if hybrid else 8) if config.vision_width <= 1024 else 2
    while hpg > 1 and heads % hpg:
        hpg //= 2
    return heads // hpg


def _siglip_mlp_chunks(config: SigLIPConfig, dtype) -> int:
    """The JAX path's MLP chunk count: the fewest chunks that divide the
    hidden dim and whose weight pair fits the TPU budget (SO400M bf16:
    19.8 MB -> 2), else the largest divisor <= 8."""
    hidden, width = config.vision_mlp_dim, config.vision_width
    pair_bytes = 2 * width * hidden * torch.finfo(dtype).bits // 8
    fit = next((n for n in (1, 2, 3, 4, 6, 8) if hidden % n == 0
                and pair_bytes // n <= MLP_WHOLE_KERNEL_MAX_BYTES), None)
    if fit is not None:
        return fit
    return max((n for n in (8, 6, 4, 3, 2, 1) if hidden % n == 0), default=1)


def pack_siglip_fast_params(model: SigLIPModel, config: SigLIPConfig,
                            dtype=torch.bfloat16, *, start: int = 0,
                            stop: Optional[int] = None,
                            hybrid: bool = False) -> Dict:
    """The vision tower's weights in the kernels' layout, on the model's
    device, for blocks [start, stop) (default all; the PEFT hybrid packs
    its frozen prefix, with ``hybrid``'s grouping).  Built once at load (or
    once per training run)."""
    n_groups = siglip_attn_groups(config, hybrid)
    vp = model.visual
    width = config.vision_width
    stop = config.vision_layers if stop is None else stop

    def mat(t):       # torch [out, in] -> kernel [in, out], compute dtype
        return t.detach().T.to(dtype).contiguous()

    def vec(t):
        return t.detach().float().contiguous()

    blocks = []
    for blk in vp.transformer.resblocks[start:stop]:
        at = blk.attn
        projs = (at.q_proj, at.k_proj, at.v_proj)
        wqkv_g, b_qkv_g, wout_g = regroup_attn_weights_f(
            torch.cat([mat(p.weight) for p in projs], dim=1),
            torch.cat([vec(p.bias) for p in projs]), mat(at.out_proj.weight),
            config.vision_heads, n_groups)
        blocks.append(dict(
            ln1_scale=vec(blk.ln_1.weight), ln1_bias=vec(blk.ln_1.bias),
            # one [W, G*3gD] matrix: group j's q_j | k_j | v_j side by side
            wqkv_g=wqkv_g.permute(1, 0, 2).reshape(width, -1).contiguous(),
            b_qkv_g=b_qkv_g, wout_g=wout_g, b_out=vec(at.out_proj.bias),
            ln2_scale=vec(blk.ln_2.weight), ln2_bias=vec(blk.ln_2.bias),
            w_fc=mat(blk.mlp.c_fc.weight), b_fc=vec(blk.mlp.c_fc.bias),
            w_proj=mat(blk.mlp.c_proj.weight),
            b_proj=vec(blk.mlp.c_proj.bias)))
    return dict(
        dtype=dtype, n_groups=n_groups, start=start,
        mlp_chunks=_siglip_mlp_chunks(config, dtype),
        patch_kernel=vp.patch_kernel().detach().to(dtype).contiguous(),
        patch_bias=vp.conv1.bias.detach().to(dtype),
        positional_embedding=vp.positional_embedding.detach().to(dtype),
        blocks=blocks)


def _siglip_embed(packed, images: torch.Tensor, config: SigLIPConfig):
    """Patchify as reshape + matmul (+ conv bias) + position embedding, in
    the pack's dtype (numerically the canonical tower's stem)."""
    p = config.patch_size
    x = images.to(packed["dtype"])
    b, h, w, c = x.shape
    patches = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, (h // p) * (w // p), p * p * c)
    x = patches @ packed["patch_kernel"] + packed["patch_bias"]
    return x + packed["positional_embedding"]


def _apply_fused_siglip_blocks(packed, x, config: SigLIPConfig, *,
                               start: int, stop: int):
    """Blocks [start, stop) of the pack through K5 -> K4 (forward only)."""
    heads, width = config.vision_heads, config.vision_width
    b, s, _ = x.shape
    first = packed["start"]
    for blk in packed["blocks"][start - first:stop - first]:
        x = attn_block_split(x, blk["wqkv_g"], blk["b_qkv_g"], blk["wout_g"],
                             blk["b_out"], blk["ln1_scale"], blk["ln1_bias"],
                             heads, packed["n_groups"], ln_eps=LN_EPS)
        x = mlp_block_split(x.reshape(b * s, width), blk["ln2_scale"],
                            blk["ln2_bias"], blk["w_fc"], blk["b_fc"],
                            blk["w_proj"], blk["b_proj"],
                            n_chunks=packed["mlp_chunks"], act="gelu_tanh",
                            ln_eps=LN_EPS).reshape(b, s, width)
    return x


def _map_pool(model: SigLIPModel, x: torch.Tensor) -> torch.Tensor:
    """ln_post + the MAP pooling head, the canonical modules in x's dtype."""
    vp = model.visual
    return vp.attnpool(vp.ln_post(x))


def siglip_encode_fast(model: SigLIPModel, images: torch.Tensor,
                       config: SigLIPConfig, *, project: bool = False,
                       dtype=torch.bfloat16, packed: Optional[Dict] = None):
    """images [B, H, W, 3] normalized NHWC -> pooled SigLIP embedding (or
    ``(pooled, pooled)`` with ``project=True``: SigLIP has no separate
    vision projection).  ``packed`` from ``pack_siglip_fast_params`` (made
    here in ``dtype`` when not given)."""
    if packed is None:
        packed = pack_siglip_fast_params(model, config, dtype)
    x = _siglip_embed(packed, images, config)
    x = _apply_fused_siglip_blocks(packed, x, config, start=0,
                                   stop=config.vision_layers)
    pooled = _map_pool(model, x)
    return (pooled, pooled) if project else pooled


def siglip_encode_hybrid(model: SigLIPModel, images: torch.Tensor,
                         config: SigLIPConfig, n_prefix: int, *,
                         project: bool = False, dtype=torch.bfloat16,
                         packed_prefix: Optional[Dict] = None,
                         qprefix: Optional[Dict] = None):
    """The PEFT train step's encode (``fast_siglip.py:319-386``): the stem
    and the ``n_prefix`` FROZEN bottom blocks through K5/K4 under
    ``torch.no_grad()`` (the counterpart of JAX's ``stop_gradient`` on the
    fused region's inputs: no graph is built there), then the canonical
    ``SigLIPBlock`` modules ``[n_prefix, L)`` and the MAP head under
    autograd, in ``dtype``.  ``packed_prefix`` (``pack_siglip_fast_params``
    with ``stop=n_prefix, hybrid=True``) is packed once per run by the
    caller; it is packed here when not given.  ``qprefix``
    ({resblocks_i: ``quant_siglip.quantize_siglip_block``}) switches the
    prefix blocks to the int8 kernels (K13 -> K9 -> K10); the stem stays in
    ``dtype``, as in JAX.  With ``n_prefix`` 0 the stem is differentiable
    too.  Under a data-parallel mesh each rank calls it on its rows of the
    batch, its own pack replicated (JAX's ``shard_map`` of the prefix,
    ``fast_siglip.py:366-376``)."""
    vp = model.visual

    def stem():   # the canonical stem's weights in dtype
        return dict(dtype=dtype, patch_kernel=vp.patch_kernel().to(dtype),
                    patch_bias=vp.conv1.bias.to(dtype),
                    positional_embedding=vp.positional_embedding.to(dtype))

    if n_prefix > 0 and qprefix is not None:
        from .quant_siglip import apply_int8_siglip_blocks

        with torch.no_grad():
            x = apply_int8_siglip_blocks(
                qprefix, _siglip_embed(stem(), images, config), config,
                start=0, stop=n_prefix)
    elif n_prefix > 0:
        if packed_prefix is None:
            packed_prefix = pack_siglip_fast_params(
                model, config, dtype, stop=n_prefix, hybrid=True)
        with torch.no_grad():
            x = _siglip_embed(packed_prefix, images, config)
            x = _apply_fused_siglip_blocks(packed_prefix, x, config, start=0,
                                           stop=n_prefix)
    else:
        x = _siglip_embed(stem(), images, config)
    x = x.to(dtype)
    for blk in vp.transformer.resblocks[n_prefix:]:
        x = blk(x)
    pooled = _map_pool(model, x)
    return (pooled, pooled) if project else pooled


# ---------------------------------------------------------------------------
# the scanned encode
# ---------------------------------------------------------------------------


def siglip_encode_scan(model: SigLIPModel, images: torch.Tensor,
                       config: SigLIPConfig, *, project: bool = False,
                       dtype=torch.bfloat16, remat: bool = False):
    """JAX's scanned canonical encode: the module tower in ``dtype`` (the
    stem, each ``SigLIPBlock`` in turn, the MAP head), with every vision
    block's ``remat`` set to ``remat`` for the call, so each block is
    checkpointed in training (the gradients are the same)."""
    with remat_blocks(model.visual, remat):
        return siglip_encode_hybrid(model, images, config, 0,
                                    project=project, dtype=dtype)
