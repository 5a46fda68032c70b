"""The collectives of the port's parallel paths, and their autograd.

The JAX package needs none of this: GSPMD inserts the all-reduces,
all-gathers and reduce-scatters and differentiates through them.  Here
they are explicit, over the process groups of a ``mesh.Mesh`` axis:

  * ``copy_to_group`` / ``reduce_from_group``: Megatron's pair around a
    tensor-parallel half-block (identity forward and all-reduce backward;
    all-reduce forward and identity backward);
  * ``gather_param``: a sharded parameter made whole for its use, whose
    backward either reduce-scatters the gradient (FSDP: every rank's
    gradient is a part of the global one) or keeps this rank's slice
    (a tensor-parallel shard read whole by replicated compute);
  * ``all_reduce_grads_``: the data-parallel gradient sum, one flat
    buffer per dtype;
  * ``send``/``recv`` of the pipeline's activations and gradients.

A shard along a dim can be head-aligned: ``groups=3`` splits the packed
qkv rows ``[3W]`` as three ``[W]`` blocks, each cut in ``n`` (so a rank
holds the q, k and v rows of its heads).

gloo takes CUDA tensors in its collectives but not in ``send``/``recv``
(the card's build writes the device pointer to its socket); on a gloo
group those, and every collective of a dtype other than fp32, run on
host copies.  ``staged`` counts them by op; NCCL groups never stage.
"""

from __future__ import annotations

import collections
from typing import List

import torch
import torch.distributed as dist

# ops gloo runs on host copies of CUDA tensors, whatever their dtype
_GLOO_HOST_OPS = frozenset({"send", "recv"})
staged: collections.Counter = collections.Counter()


def _host_staged(op: str, t: torch.Tensor, group) -> bool:
    if not t.is_cuda or dist.get_backend(group) != "gloo":
        return False
    stage = op in _GLOO_HOST_OPS or t.dtype != torch.float32
    if stage:
        staged[op] += 1
    return stage


def _split(t: torch.Tensor, n: int, dim: int, groups: int = 1
           ) -> List[torch.Tensor]:
    """``t`` cut in ``n`` along ``dim`` (each of ``groups`` blocks of the
    dim cut in ``n``, the k-th pieces joined), contiguous."""
    if groups == 1:
        return [c.contiguous() for c in t.chunk(n, dim)]
    u = t.unflatten(dim, (groups, t.shape[dim] // groups))
    return [c.flatten(dim, dim + 1).contiguous() for c in u.chunk(n, dim + 1)]


def _cat(chunks, dim: int, groups: int = 1) -> torch.Tensor:
    """The inverse of ``_split``."""
    if groups == 1:
        return torch.cat(chunks, dim)
    parts = [c.unflatten(dim, (groups, c.shape[dim] // groups))
             for c in chunks]
    return torch.cat(parts, dim + 1).flatten(dim, dim + 1)


def all_reduce_(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` in place over the ``axis`` group."""
    if mesh.shape[axis] == 1:
        return t
    group = mesh.group(axis)
    if _host_staged("all_reduce", t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """``t`` of the ``axis`` group's member at coordinate ``src`` on every
    member (in place)."""
    if mesh.shape[axis] == 1:
        return t
    group, root = mesh.group(axis), mesh.axis_ranks(axis)[src]
    if _host_staged("broadcast", t, group):
        h = t.cpu()
        dist.broadcast(h, root, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, root, group=group)
    return t


def all_gather_cat(t: torch.Tensor, mesh, axis: str, dim: int,
                   groups: int = 1) -> torch.Tensor:
    """The ``axis`` group's tensors joined along ``dim`` in coordinate
    order (``groups``: see ``_split``)."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    group = mesh.group(axis)
    src = t.contiguous()
    if _host_staged("all_gather", src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return _cat(parts, dim, groups).to(t.device)


def reduce_scatter_dim(t: torch.Tensor, mesh, axis: str, dim: int,
                       groups: int = 1) -> torch.Tensor:
    """The ``axis`` group's sum of ``t``, of which this rank keeps its
    piece along ``dim``."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    group = mesh.group(axis)
    pieces = _split(t, n, dim, groups)
    if _host_staged("reduce_scatter", t, group):
        pieces = [p.cpu() for p in pieces]
    out = torch.empty_like(pieces[0])
    dist.reduce_scatter(out, pieces, group=group)
    return out.to(t.device)


def own_piece(t: torch.Tensor, mesh, axis: str, dim: int,
              groups: int = 1) -> torch.Tensor:
    """This rank's piece of a whole tensor, as the ``axis`` group cuts it."""
    n = mesh.shape[axis]
    return t if n == 1 else _split(t, n, dim, groups)[mesh.coords[axis]]


def send(t: torch.Tensor, dst: int) -> None:
    """``t`` to global rank ``dst`` (blocking)."""
    if _host_staged("send", t, None):
        t = t.cpu()
    dist.send(t.contiguous(), dst)


def recv(shape, dtype, src: int, mesh) -> torch.Tensor:
    """A tensor from global rank ``src`` onto the mesh's device."""
    out = torch.empty(shape, dtype=dtype, device=mesh.device)
    if _host_staged("recv", out, None):
        h = torch.empty(shape, dtype=dtype)
        dist.recv(h, src)
        return out.copy_(h)
    dist.recv(out, src)
    return out


def _reduce_f32(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ``axis`` sum of ``x``, added in fp32 and cast back."""
    y = x.float().contiguous()
    if y is x:
        y = y.clone()
    return all_reduce_(y, mesh, axis).to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_f32(g, ctx.mesh, ctx.axis), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce_f32(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_group(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The input of a tensor-parallel region: identity forward, the
    gradient summed over ``axis`` backward."""
    if mesh.shape[axis] == 1:
        return x
    return _CopyToGroup.apply(x, mesh, axis)


def reduce_from_group(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The output of a tensor-parallel region: the partial results summed
    over ``axis`` forward, identity backward."""
    if mesh.shape[axis] == 1:
        return x
    return _ReduceFromGroup.apply(x, mesh, axis)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, axis, dim, groups, reduce_grad):
        ctx.args = (mesh, axis, dim, groups, reduce_grad)
        return all_gather_cat(local, mesh, axis, dim, groups)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, groups, reduce_grad = ctx.args
        g = (reduce_scatter_dim(g, mesh, axis, dim, groups) if reduce_grad
             else own_piece(g, mesh, axis, dim, groups))
        return g, None, None, None, None, None


def gather_param(local: torch.Tensor, mesh, axis: str, dim: int,
                 groups: int = 1, reduce_grad: bool = True) -> torch.Tensor:
    """A parameter's ``axis`` shards joined along ``dim``; differentiable
    when autograd records and ``local`` requires a gradient (the backward
    reduce-scatters, or with ``reduce_grad=False`` keeps this rank's
    piece)."""
    if mesh.shape[axis] == 1:
        return local
    if torch.is_grad_enabled() and local.requires_grad:
        return _GatherParam.apply(local, mesh, axis, dim, groups,
                                  reduce_grad)
    return all_gather_cat(local.detach(), mesh, axis, dim, groups)


def any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` is set on any rank of the mesh."""
    t = torch.tensor([float(flag)], device=mesh.device)
    for axis in mesh.shape:
        all_reduce_(t, mesh, axis)
    return bool(t.item() > 0)


def all_reduce_grads_(params, mesh, axis: str = "data") -> None:
    """Sum the gradients of ``params`` over ``axis`` in place, one flat
    buffer per (device, dtype)."""
    if mesh.shape[axis] == 1:
        return
    buckets = collections.defaultdict(list)
    for p in params:
        if p.grad is not None:
            buckets[(p.grad.device, p.grad.dtype)].append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat, mesh, axis)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def broadcast_tensors_(tensors, mesh, axis: str, src: int = 0) -> None:
    """Each tensor of ``tensors`` from the ``axis`` member at ``src`` (one
    flat buffer per (device, dtype))."""
    if mesh.shape[axis] == 1:
        return
    buckets = collections.defaultdict(list)
    for t in tensors:
        buckets[(t.device, t.dtype)].append(t)
    for ts in buckets.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        broadcast_(flat, mesh, axis, src)
        off = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
