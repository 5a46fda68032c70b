"""The tensor-parallel block forward (the compute JAX's GSPMD derives
from ``_TP_RULES``): Megatron's column/row pair in each half-block of a
CLIP ViT (packed qkv) or SigLIP (q/k/v) tower, over the tensor-parallel
shards ``mesh.shard_params`` cut.

  ln_1 -> copy_to_group -> qkv (this rank's heads) -> attention ->
  out_proj (this rank's input rows) -> reduce_from_group -> + bias, x
  ln_2 -> copy_to_group -> c_fc (this rank's hidden units) -> act ->
  c_proj (this rank's input rows) -> reduce_from_group -> + bias, x

The row-parallel biases are added once, after the all-reduce.  The
products are plain ``torch`` GEMMs: JAX computes them outside any Pallas
kernel too.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from . import comm
from .mesh import MODEL_AXIS


def tp_block_forward(blk, x: torch.Tensor, mesh) -> torch.Tensor:
    """One block (``ResidualAttentionBlock`` or ``SigLIPBlock``) whose
    qkv/``c_fc``/``out_proj``/``c_proj`` parameters hold this rank's
    tensor-parallel shards; ``x`` [B, S, W] replicated over the model
    axis, and so is the result."""
    from ..models.layers import linear
    from ..ops.attention import dot_product_attention

    tp = mesh.shape[MODEL_AXIS]
    att, mlp = blk.attn, blk.mlp
    if att.heads % tp:
        raise ValueError(f"{att.heads} heads do not divide over the model "
                         f"axis ({tp})")
    h = comm.copy_to_group(blk.ln_1(x), mesh, MODEL_AXIS)
    if hasattr(att, "in_proj_weight"):
        q, k, v = linear(h, att.in_proj_weight,
                         att.in_proj_bias).chunk(3, dim=-1)
    else:
        q, k, v = (linear(h, lin.weight, lin.bias)
                   for lin in (att.q_proj, att.k_proj, att.v_proj))
    o = dot_product_attention(q, k, v, att.heads // tp,
                              causal=getattr(att, "causal", False))
    o = comm.reduce_from_group(linear(o, att.out_proj.weight), mesh,
                               MODEL_AXIS)
    x = x + o + att.out_proj.bias.to(x.dtype)
    h = comm.copy_to_group(blk.ln_2(x), mesh, MODEL_AXIS)
    h = mlp.act(linear(h, mlp.c_fc.weight, mlp.c_fc.bias))
    o = comm.reduce_from_group(linear(h, mlp.c_proj.weight), mesh,
                               MODEL_AXIS)
    return x + o + mlp.c_proj.bias.to(x.dtype)


def tp_local(name: str) -> bool:
    """The parameters the tensor-parallel forward reads as shards: the
    visual transformer blocks'.  Every other parameter a rule cuts (the
    text tower's, SigLIP's MAP head's) is gathered whole for its
    replicated compute."""
    return name.startswith("visual.transformer.resblocks.")


@contextlib.contextmanager
def tensor_parallel_blocks(model, mesh):
    """Inside the block the model's visual transformer blocks run
    ``tp_block_forward`` (each block's ``_forward``, so ``remat`` still
    checkpoints it); a model axis of one changes nothing."""
    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) == 1:
        yield model
        return
    blocks = list(model.visual.transformer.resblocks)
    try:
        for blk in blocks:
            blk._forward = functools.partial(tp_block_forward, blk,
                                             mesh=mesh)
        yield model
    finally:
        for blk in blocks:
            blk.__dict__.pop("_forward", None)
