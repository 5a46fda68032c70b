"""The tensor-parallel forward (the compute JAX's GSPMD derives from
``_TP_RULES``): Megatron's column/row pair in each half-block of every
block the rules cut, over the tensor-parallel shards ``mesh.shard_params``
cut: the visual and the text transformer blocks of a CLIP tower (packed
qkv; the text tower's causal) or a SigLIP one (q/k/v), and SigLIP's MAP
head.

  ln_1 -> copy_to_group -> qkv (this rank's heads) -> attention ->
  out_proj (this rank's input rows) -> reduce_from_group -> + bias, x
  ln_2 -> copy_to_group -> c_fc (this rank's hidden units) -> act ->
  c_proj (this rank's input rows) -> reduce_from_group -> + bias, x

The MAP head runs the same pair with its probe replicated: q from the
probe, k and v from the tokens, each over this rank's heads.  The
row-parallel biases are added once, after the all-reduce.  The products
are plain ``torch`` GEMMs: JAX computes them outside any Pallas kernel
too; the attention is the one the module's own forward runs (SigLIP's
dispatch, CLIP's plain math).  ConvNeXt and RN towers match no rule, so
JAX and the port replicate them.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from . import comm
from .mesh import MODEL_AXIS


def _local_heads(att, mesh) -> int:
    tp = mesh.shape[MODEL_AXIS]
    if att.heads % tp:
        raise ValueError(f"{att.heads} heads do not divide over the model "
                         f"axis ({tp})")
    return att.heads // tp


def _tp_mlp(mlp, h: torch.Tensor, mesh) -> torch.Tensor:
    """c_fc over this rank's hidden units -> act -> c_proj over its input
    rows, summed over the model axis, + bias."""
    from ..models.layers import linear

    h = comm.copy_to_group(h, mesh, MODEL_AXIS)
    h = mlp.act(linear(h, mlp.c_fc.weight, mlp.c_fc.bias))
    o = comm.reduce_from_group(linear(h, mlp.c_proj.weight), mesh,
                               MODEL_AXIS)
    return o + mlp.c_proj.bias.to(o.dtype)


def _tp_attention(att, q_in: torch.Tensor, kv_in: torch.Tensor, mesh,
                  attend) -> torch.Tensor:
    """The attention over this rank's heads, its out_proj over this rank's
    input rows, summed over the model axis, + bias."""
    from ..models.layers import linear

    heads = _local_heads(att, mesh)
    q_in = comm.copy_to_group(q_in, mesh, MODEL_AXIS)
    kv_in = q_in if kv_in is None else comm.copy_to_group(kv_in, mesh,
                                                          MODEL_AXIS)
    if hasattr(att, "in_proj_weight"):
        q, k, v = linear(q_in, att.in_proj_weight,
                         att.in_proj_bias).chunk(3, dim=-1)
    else:
        q, k, v = (linear(t, lin.weight, lin.bias) for t, lin in (
            (q_in, att.q_proj), (kv_in, att.k_proj), (kv_in, att.v_proj)))
    o = comm.reduce_from_group(linear(attend(q, k, v, heads),
                                      att.out_proj.weight), mesh, MODEL_AXIS)
    return o + att.out_proj.bias.to(o.dtype)


def _block_attend(att):
    """The attention the block's own module runs: SigLIP's dispatch (K6 on
    the card where it qualifies), CLIP's plain math (causal for text)."""
    from ..ops.attention import attention, dot_product_attention

    if hasattr(att, "in_proj_weight"):
        return functools.partial(dot_product_attention,
                                 causal=getattr(att, "causal", False))
    return attention


def tp_block_forward(blk, x: torch.Tensor, mesh) -> torch.Tensor:
    """One block (``ResidualAttentionBlock`` or ``SigLIPBlock``) whose
    qkv/``c_fc``/``out_proj``/``c_proj`` parameters hold this rank's
    tensor-parallel shards; ``x`` [B, S, W] replicated over the model
    axis, and so is the result."""
    x = x + _tp_attention(blk.attn, blk.ln_1(x), None, mesh,
                          _block_attend(blk.attn))
    return x + _tp_mlp(blk.mlp, blk.ln_2(x), mesh)


def tp_map_head_forward(head, tokens: torch.Tensor, mesh) -> torch.Tensor:
    """SigLIP's ``MAPHead`` over its tensor-parallel shards: the probe
    (replicated) attends over the tokens with this rank's heads, then the
    MLP pair; [B, S, W] tokens -> [B, W], replicated."""
    from ..ops.attention import dot_product_attention

    b, _, w = tokens.shape
    probe = head.probe.to(tokens.dtype).expand(b, 1, w)
    x = _tp_attention(head.attn, probe, tokens, mesh, dot_product_attention)
    x = x + _tp_mlp(head.mlp, head.ln(x), mesh)
    return x[:, 0, :]


_TP_PREFIXES = ("visual.transformer.resblocks.", "text.transformer.resblocks.",
                "visual.attnpool.attn.", "visual.attnpool.mlp.")


def tp_local(name: str) -> bool:
    """The parameters the tensor-parallel forward reads as shards: the
    transformer blocks' of both towers and SigLIP's MAP head's
    attention and MLP (every parameter ``_TP_RULES`` cuts but the token
    embedding, which no rule cuts on the model axis)."""
    return name.startswith(_TP_PREFIXES)


def _tp_modules(model):
    """(module, the attribute its forward sits in, its tensor-parallel
    forward) for every block the rules cut: the transformer blocks of both
    towers, SigLIP's MAP head."""
    from ..models.siglip import MAPHead

    for tower in (model.visual, model.text):
        for blk in getattr(getattr(tower, "transformer", None), "resblocks",
                           ()):
            yield blk, "_forward", tp_block_forward
    head = getattr(model.visual, "attnpool", None)
    if isinstance(head, MAPHead):
        yield head, "forward", tp_map_head_forward


@contextlib.contextmanager
def tensor_parallel_blocks(model, mesh):
    """Inside the block the model's transformer blocks (both towers) run
    ``tp_block_forward`` (each block's ``_forward``, so ``remat`` and the
    FSDP gather still wrap it) and a MAP head ``tp_map_head_forward``; a
    model axis of one changes nothing.  Re-entrant: an inner use leaves
    the outer one's forwards in place."""
    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) == 1:
        yield model
        return
    saved = []
    try:
        for mod, attr, fwd in _tp_modules(model):
            saved.append((mod, attr, mod.__dict__.get(attr)))
            object.__setattr__(mod, attr, functools.partial(fwd, mod,
                                                            mesh=mesh))
        yield model
    finally:
        for mod, attr, prev in reversed(saved):
            if prev is None:
                mod.__dict__.pop(attr, None)
            else:
                object.__setattr__(mod, attr, prev)
