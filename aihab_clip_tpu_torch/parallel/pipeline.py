"""Pipeline parallelism (GPipe) for CLIP ViT towers (counterpart of
``aihab_clip_tpu/parallel/pipeline.py``).

The transformer blocks are split into ``n_stages`` contiguous groups; the
ranks of a ``stage`` mesh axis each hold one group and microbatches
stream through them:

  * the schedule runs T = M + P - 1 ticks; at tick t stage p computes
    microbatch t - p (when in range): stage 0 takes it from the input,
    the others receive one [mb, S, W] activation from the previous stage
    (``send``/``recv``), and the last stage's outputs reach every stage
    rank by a broadcast (JAX's masked ``psum``);
  * the patch embedding and ``ln_post``/``proj`` are computed replicated
    on every rank, as in JAX;
  * the backward runs the schedule in reverse: stage p receives the
    gradient of its output from stage p + 1, back-propagates its blocks
    (accumulating its parameters' gradients) and sends the gradient of its
    input to stage p - 1; stage 0's reaches every stage rank;
  * a composed (data, stage) mesh gives each data replica its own
    pipeline over its rows of every microbatch (JAX's layout: microbatch
    m's rows split over ``data``); the outputs are gathered over ``data``,
    and the stage parameters' gradients summed over it, so
    ``pipeline_encode`` takes and returns the global batch and its
    gradients are the tower's, as ``jax.grad`` through JAX's is.

Departure D6: JAX's ``_block`` runs QuickGELU whatever the tower's
activation; the port runs every layer through the tower's own block
module, so a GELU tower pipelines the network it trains and serves.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.func import functional_call

from . import comm
from .mesh import DATA_AXIS, Mesh, _grid_mesh

STAGE_AXIS = "stage"


def make_pipeline_mesh(n_stages: int, devices=None, data_parallel: int = 1,
                       *, device="cuda") -> Mesh:
    """A (stage,) mesh, or a composed (data, stage) mesh when
    ``data_parallel > 1`` (the stage axis minor: rank r is stage
    r % n_stages of replica r // n_stages), over all ranks."""
    if devices is not None:
        raise ValueError("the port's mesh spans the process group's ranks: "
                         "pass devices=None")
    shape = ({STAGE_AXIS: n_stages} if data_parallel == 1
             else {DATA_AXIS: data_parallel, STAGE_AXIS: n_stages})
    return _grid_mesh(shape, device)


def _blocks(model_or_params):
    """{i: {block parameter name: tensor}} of the visual transformer."""
    items = (model_or_params.named_parameters()
             if isinstance(model_or_params, torch.nn.Module)
             else model_or_params.items())
    prefix = "visual.transformer.resblocks."
    out: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, t in items:
        if name.startswith(prefix):
            i, rest = name[len(prefix):].split(".", 1)
            out.setdefault(int(i), {})[rest] = t
    return out


@torch.no_grad()
def stack_stage_params(params, n_layers: int, n_stages: int
                       ) -> Dict[str, torch.Tensor]:
    """The visual blocks' parameters (a model, or {name: tensor}) as
    {block parameter name: [n_stages, layers_per_stage, ...]}.  Requires
    ``n_layers % n_stages == 0``."""
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{n_stages} stages")
    per = n_layers // n_stages
    blocks = _blocks(params)
    return {k: torch.stack([torch.stack([blocks[s * per + i][k].detach()
                                         for i in range(per)])
                            for s in range(n_stages)])
            for k in blocks[0]}


def place_stage_params(mesh: Mesh, stacked) -> Dict[str, torch.Tensor]:
    """This rank's stage of the stacked parameters ([layers_per_stage,
    ...] leaves), as trainable fp32 ``Parameter``s on the mesh's device."""
    s = mesh.coords[STAGE_AXIS]
    return {k: torch.nn.Parameter(v[s].to(mesh.device, copy=True))
            for k, v in stacked.items()}


def _stage_forward(stage_params, x, block: torch.nn.Module):
    """This stage's blocks ([Lp, ...] leaves) over x: the tower's own block
    module ``block`` run over each layer's parameters in turn."""
    for i in range(next(iter(stage_params.values())).shape[0]):
        x = functional_call(block, {k: v[i] for k, v in stage_params.items()},
                            (x,))
    return x


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule forward and in reverse; ``params`` ride as
    inputs so the output requires a gradient whenever they do, and their
    gradients are accumulated by the inner backward of each microbatch
    (the reentrant ``checkpoint`` pattern)."""

    @staticmethod
    def forward(ctx, x, mesh, block, m, keys, track, *params):
        stage_params = dict(zip(keys, params))
        n_stages, p = mesh.shape[STAGE_AXIS], mesh.coords[STAGE_AXIS]
        ranks = mesh.axis_ranks(STAGE_AXIS)
        # [M, mb, S, W], this replica's rows of every microbatch
        xs = comm.own_piece(x.reshape(m, x.shape[0] // m, *x.shape[1:]),
                            mesh, DATA_AXIS, 1) \
            if DATA_AXIS in mesh.shape else \
            x.reshape(m, x.shape[0] // m, *x.shape[1:])
        saved = {}
        outs = torch.empty_like(xs)
        for t in range(m + n_stages - 1):
            i = t - p
            if not 0 <= i < m:
                continue
            inp = xs[i] if p == 0 else comm.recv(xs.shape[1:], xs.dtype,
                                                 ranks[p - 1], mesh)
            inp = inp.detach().requires_grad_(track)
            with torch.set_grad_enabled(track):
                y = _stage_forward(stage_params, inp, block)
            saved[i] = (inp, y)
            if p < n_stages - 1:
                comm.send(y.detach(), ranks[p + 1])
            else:
                outs[i] = y.detach()
        comm.broadcast_(outs, mesh, STAGE_AXIS, n_stages - 1)
        if DATA_AXIS in mesh.shape:
            outs = comm.all_gather_cat(outs, mesh, DATA_AXIS, 1)
        ctx.mesh, ctx.m, ctx.saved, ctx.params = mesh, m, saved, params
        ctx.xs_shape = xs.shape
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, grad):
        mesh, m, saved, params = ctx.mesh, ctx.m, ctx.saved, ctx.params
        n_stages, p = mesh.shape[STAGE_AXIS], mesh.coords[STAGE_AXIS]
        ranks = mesh.axis_ranks(STAGE_AXIS)
        g = grad.reshape(m, grad.shape[0] // m, *grad.shape[1:])
        if DATA_AXIS in mesh.shape:
            g = comm.own_piece(g, mesh, DATA_AXIS, 1)
        # the stage parameters' gradients of this call alone, summed over
        # the data replicas, then added to what they held
        held = [q.grad for q in params]
        for q in params:
            q.grad = None
        gx = torch.zeros(ctx.xs_shape, dtype=grad.dtype, device=grad.device)
        for i in reversed(range(m)):
            inp, y = saved[i]
            gy = g[i] if p == n_stages - 1 else comm.recv(
                y.shape, y.dtype, ranks[p + 1], mesh)
            torch.autograd.backward(y, gy.to(y.dtype))
            gi = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if p > 0:
                comm.send(gi, ranks[p - 1])
            else:
                gx[i] = gi
        ctx.saved = None
        if DATA_AXIS in mesh.shape:
            comm.all_reduce_grads_(params, mesh, DATA_AXIS)
        for q, h in zip(params, held):
            if h is not None:
                q.grad = h if q.grad is None else q.grad + h
        comm.broadcast_(gx, mesh, STAGE_AXIS, 0)
        if DATA_AXIS in mesh.shape:
            gx = comm.all_gather_cat(gx, mesh, DATA_AXIS, 1)
        return (gx.reshape(grad.shape), None, None, None, None,
                None) + (None,) * len(params)


def pipeline_blocks(stage_params, x: torch.Tensor, block: torch.nn.Module,
                    mesh: Mesh, num_microbatches: int) -> torch.Tensor:
    """[B, S, W] -> [B, S, W] through the pipelined transformer blocks, on
    every rank of the mesh (the global batch in and out; see the module
    docstring).  ``block`` is one of the tower's blocks (JAX passes the
    head count instead): each layer of ``stage_params`` runs through its
    forward, so the stages compute what the tower's module does, its
    activation included (D6).  Differentiable."""
    n_stages = mesh.shape[STAGE_AXIS]
    dp = mesh.shape.get(DATA_AXIS, 1)
    b, m = x.shape[0], num_microbatches
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    if (b // m) % dp != 0:
        raise ValueError(f"microbatch {b // m} not divisible by "
                         f"data_parallel {dp}")
    if n_stages == 1 and dp == 1:
        return _stage_forward(stage_params, x, block)
    keys = list(stage_params)
    track = torch.is_grad_enabled() and (x.requires_grad or any(
        v.requires_grad for v in stage_params.values()))
    return _Pipeline.apply(x, mesh, block, m, keys, track,
                           *(stage_params[k] for k in keys))


def pipeline_encode(model, stage_params, images: torch.Tensor, config,
                    mesh: Mesh, *, num_microbatches: int,
                    project: bool = False, dtype=torch.bfloat16):
    """The ViT encode with the transformer blocks pipeline-parallel:
    ``model``'s stem, ``ln_post`` and ``proj`` (replicated on every rank),
    ``stage_params`` from ``stack_stage_params`` + ``place_stage_params``.
    Differentiable: gradients reach the stage parameters, the model's
    stem and head, and ``images``."""
    from ..models.fast_vit import _stem, _vit_embed

    vp = model.visual
    x = _vit_embed(_stem(vp, dtype), images, config)
    x = pipeline_blocks(stage_params, x, vp.transformer.resblocks[0], mesh,
                        num_microbatches)
    pre = vp.ln_post(x[:, 0, :])
    if not project:
        return pre
    return pre, pre @ vp.proj.to(pre.dtype)
