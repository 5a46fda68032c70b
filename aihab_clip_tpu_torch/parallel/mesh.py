"""Process meshes and parameter sharding (counterpart of
``aihab_clip_tpu/parallel/mesh.py``).

JAX lays a ``jax.sharding.Mesh`` over devices and lets GSPMD partition the
step.  The port lays a ``Mesh`` over the ranks of ``torch.distributed``
(one rank a device) and partitions by hand:

  * axis ``data``  — each rank takes its shard of the global batch and the
    gradients are summed over the axis (``comm.all_reduce_grads_``);
  * axis ``model`` — tensor parallelism: the attention's qkv (or q/k/v)
    and ``c_fc`` are cut along their output dim and ``out_proj`` and
    ``c_proj`` along their input dim (Megatron's column/row pairs), by
    JAX's ``_TP_RULES`` matched on each port parameter's JAX path
    (``models/convert.jax_param_path``), so both packages shard the same
    dims; each half-block ends in one all-reduce;
  * FSDP (``fsdp=True``): ``param_pspec``'s rule, the largest dim not yet
    sharded that the data size divides, over ``data``; the parameter is
    gathered before use and its gradient reduce-scattered, so the Adam
    moments (over the local shards) shrink with the data size too.

A rank's coordinates follow JAX's device grid: rank ``r`` of a (data,
model) mesh sits at ``(r // model, r % model)``.  ``shard_params`` cuts the
model's parameters in place into the local shards (the model's own
``Parameter`` slots then hold them, so an optimizer over
``model.parameters()`` holds sharded Adam moments) and returns the
``Sharding`` that gathers them back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .distributed import is_initialized, local_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of ranks: ``shape`` {axis: size} in major-to-minor order,
    this rank's ``coords`` {axis: index}, and per axis the process group
    of the ranks that differ from this one only along it."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    device: torch.device
    _groups: Dict[str, object]
    _ranks: Dict[str, List[int]]

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def group(self, axis: str):
        return self._groups[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """Global ranks of this rank's ``axis`` group, by coordinate."""
        return self._ranks[axis]

    def describe(self) -> str:
        return (f"{self.shape} over {self.size} ranks ({self.backend}), "
                f"rank {self.rank} at {self.coords} on {self.device}")


def _grid_mesh(shape: Dict[str, int], device) -> Mesh:
    """The mesh of the whole world as a row-major grid of ``shape``; every
    rank creates every group, in the same order (``dist.new_group``)."""
    if not is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized process group: run under "
            "torch.distributed.run (or initialize_distributed) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = int(np.prod(list(shape.values())))
    if size != world:
        raise ValueError(f"mesh {shape} needs {size} ranks, the world has "
                         f"{world}")
    axes = list(shape)
    grid = np.arange(world).reshape(tuple(shape.values()))
    coords = dict(zip(axes, (int(c) for c in
                             np.unravel_index(rank, grid.shape))))
    groups, ranks = {}, {}
    for i, axis in enumerate(axes):
        if shape[axis] == 1:       # nothing to talk to along this axis
            groups[axis], ranks[axis] = None, [rank]
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
        for line in lines:
            members = [int(r) for r in line]
            g = (dist.group.WORLD if len(members) == world
                 else dist.new_group(members))
            if rank in members:
                groups[axis], ranks[axis] = g, members
    return Mesh(dict(shape), rank, coords, local_device(device), groups,
                ranks)


def make_mesh(devices=None, model_parallel: int = 1, *,
              device="cuda") -> Mesh:
    """A (data, model) mesh over every rank of the process group (this
    rank's device ``cuda:{LOCAL_RANK}``, or the CPU when asked for).
    ``devices`` must be None: a rank owns one device."""
    if devices is not None:
        raise ValueError("the port's mesh spans the process group's ranks, "
                         "one device each: pass devices=None")
    n = dist.get_world_size() if is_initialized() else 1
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} ranks not divisible by model_parallel={model_parallel}")
    return _grid_mesh({DATA_AXIS: n // model_parallel,
                       MODEL_AXIS: model_parallel}, device)


class BatchShard(NamedTuple):
    """This rank's part of a batch: shard ``index`` of ``count``."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"batch {n} not divisible by the data axis "
                             f"({self.count})")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: Mesh) -> BatchShard:
    """Leading-axis (batch) sharding over the data axis."""
    return BatchShard(mesh.coords.get(DATA_AXIS, 0),
                      mesh.shape.get(DATA_AXIS, 1))


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global batch array, as tensors on the
    mesh's device."""
    out = []
    for a in arrays:
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        out.append(t[batch_sharding(mesh).rows(t.shape[0])].to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def replicated(mesh: Mesh, *tensors):
    """Rank 0's value of each tensor on every rank (in place; the
    placement JAX's ``NamedSharding(mesh, P())`` gives)."""
    for axis in mesh.shape:
        comm.broadcast_tensors_(tensors, mesh, axis, 0)
    return tensors if len(tensors) > 1 else tensors[0]


# ---------------------------------------------------------------------------
# Tensor-parallel rules (JAX paths -> PartitionSpec, JAX's table verbatim):
# column-parallel (output dim) for QKV/c_fc, row-parallel (input dim) for
# out_proj/c_proj
# ---------------------------------------------------------------------------

_TP_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r".*attn/in_proj/kernel$", (None, MODEL_AXIS)),
    (r".*attn/in_proj/bias$", (MODEL_AXIS,)),
    (r".*attn/(q_proj|k_proj|v_proj)/kernel$", (None, MODEL_AXIS)),
    (r".*attn/(q_proj|k_proj|v_proj)/bias$", (MODEL_AXIS,)),
    (r".*attn/out_proj/kernel$", (MODEL_AXIS, None)),
    (r".*mlp/c_fc/kernel$", (None, MODEL_AXIS)),
    (r".*mlp/c_fc/bias$", (MODEL_AXIS,)),
    (r".*mlp/c_proj/kernel$", (MODEL_AXIS, None)),
    (r".*/token_embedding$", (None, None)),
)


def param_pspec(path: str, tp: bool, fsdp: bool = False,
                shape: Optional[Tuple[int, ...]] = None,
                data_size: int = 1) -> Tuple:
    """The partition spec (a tuple of axis names or None per dim of the
    JAX leaf; ``()`` replicated) of a '/'-joined JAX param path, JAX's
    rule: the TP rules when ``tp``, then with ``fsdp`` the largest dim
    still unsharded that ``data_size`` divides over ``data``."""
    spec: Tuple = ()
    if tp:
        for pattern, s in _TP_RULES:
            if re.match(pattern, path):
                spec = s
                break
    if fsdp and shape is not None and data_size > 1:
        dims = list(spec) + [None] * (len(shape) - len(spec))
        best = None
        for i, d in enumerate(shape):
            if dims[i] is None and d % data_size == 0:
                if best is None or d > shape[best]:
                    best = i
        if best is not None:
            dims[best] = DATA_AXIS
            spec = tuple(dims)
    return spec


def _jax_view(name: str, shape) -> Tuple[str, Tuple[int, ...],
                                        Tuple[int, ...]]:
    """(JAX path, JAX leaf shape, perm: the port's dim d is the leaf's
    perm[d])."""
    from ..models.convert import jax_param_path

    path, perm = jax_param_path(name, len(shape))
    jshape = [0] * len(shape)
    for d, j in enumerate(perm):
        jshape[j] = shape[d]
    return path, tuple(jshape), perm


def param_shardings(mesh: Mesh, params, fsdp: bool = False
                    ) -> Dict[str, Tuple]:
    """{parameter name: the port tensor's spec} (an axis name or None per
    dim) for a model or a {name: tensor} dict: JAX's ``param_pspec`` on
    the parameter's JAX path and shape, carried to the port's layout."""
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    tp = mesh.shape.get(MODEL_AXIS, 1) > 1
    data = mesh.shape.get(DATA_AXIS, 1)
    out = {}
    for name, t in items:
        path, jshape, perm = _jax_view(name, tuple(t.shape))
        jspec = param_pspec(path, tp, fsdp=fsdp, shape=jshape,
                            data_size=data)
        jspec = tuple(jspec) + (None,) * (len(jshape) - len(jspec))
        out[name] = tuple(jspec[perm[d]] for d in range(len(perm)))
    return out


def _qkv_groups(name: str, dim: int, axis: str) -> int:
    """The packed in_proj's output rows are cut per q, k and v along the
    model axis (so a rank holds whole heads); everything else plainly."""
    return 3 if (axis == MODEL_AXIS and dim == 0 and name.endswith(
        ("in_proj_weight", "in_proj_bias"))) else 1


@dataclasses.dataclass
class _Cut:
    axis: str
    dim: int
    groups: int


class Sharding:
    """The shards ``shard_params`` cut: {name: [cuts]} (the model axis's
    first), and the gathers back."""

    def __init__(self, mesh: Mesh, cuts: Dict[str, List[_Cut]]):
        self.mesh = mesh
        self.cuts = cuts

    def data_sharded(self, name: str) -> bool:
        return any(c.axis == DATA_AXIS for c in self.cuts.get(name, ()))

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor."""
        t = full
        for c in self.cuts.get(name, ()):
            t = comm.own_piece(t, self.mesh, c.axis, c.dim, c.groups)
        return t.contiguous()

    def full(self, name: str, local: torch.Tensor,
             axes: Sequence[str] = (DATA_AXIS, MODEL_AXIS)) -> torch.Tensor:
        """A shard gathered over ``axes`` (data first): differentiable,
        the data gather's backward reduce-scatters, the model gather's
        keeps this rank's piece (the compute after it is replicated over
        the model axis)."""
        t = local
        for c in reversed(self.cuts.get(name, ())):
            if c.axis in axes:
                t = comm.gather_param(t, self.mesh, c.axis, c.dim, c.groups,
                                      reduce_grad=c.axis == DATA_AXIS)
        return t

    @contextlib.contextmanager
    def _swapped(self, model: torch.nn.Module, names, tp_local):
        """``names`` read whole inside the block (gathered differentiably;
        those ``tp_local(name)`` picks gathered over data only)."""
        swapped = []
        try:
            for name in names:
                mod_name, _, attr = name.rpartition(".")
                mod = model.get_submodule(mod_name)
                shard = mod._parameters[attr]
                keep = tp_local is not None and tp_local(name)
                mod._parameters[attr] = self.full(
                    name, shard, (DATA_AXIS,) if keep
                    else (DATA_AXIS, MODEL_AXIS))
                swapped.append((mod, attr, shard))
            yield model
        finally:
            for mod, attr, shard in reversed(swapped):
                mod._parameters[attr] = shard

    @contextlib.contextmanager
    def _block_gather(self, model, names, tp_local, adapters, alpha):
        """One block's gather: its data-cut weights whole, then its LoRA
        adapters merged into them (``W_eff``, differentiable in A and B)."""
        with self._swapped(model, names, tp_local):
            if adapters:
                from ..train.lora import lora_applied

                with lora_applied(model, adapters, alpha):
                    yield model
            else:
                yield model

    @contextlib.contextmanager
    def gathered(self, model: torch.nn.Module, tp_local=None,
                 per_block: bool = False, adapters=None,
                 alpha: float = 1.0, unread: Tuple[str, ...] = ()):
        """Inside the block every sharded parameter of ``model`` reads
        whole (gathered once, differentiably); those ``tp_local(name)``
        picks read as their tensor-parallel shard (gathered over data
        only), for the tensor-parallel forward.  ``adapters`` (LoRA,
        ``train/lora``) are merged into the weights they adapt (``W_eff``
        with ``alpha``) after the gather.  ``per_block`` leaves every
        tower block's FSDP shards (those cut over data) in place and has
        each block (``layers.GatherBlock``: the transformer, ConvNeXt and
        RN blocks) gather its own and merge its own adapters when it runs,
        so a rank never holds more than one block's whole weights; for
        callers that read the blocks through their forward alone.  A block
        cut over the model axis alone runs as it is: its gather would save
        nothing.  Parameters under the ``unread`` prefixes (a tower the
        caller does not read) stay as their shards."""
        from ..models.layers import GatherBlock

        adapters = adapters or {}
        blocks = ({n: m for n, m in model.named_modules()
                   if isinstance(m, GatherBlock)} if per_block else {})

        def owner(name):
            return next((b for b in blocks if name.startswith(b + ".")),
                        None)

        own: Dict[str, List[str]] = {}
        eager = []
        for name in self.cuts:
            if name.startswith(unread):
                continue
            b = owner(name) if self.data_sharded(name) else None
            if b is None:
                eager.append(name)
            else:
                own.setdefault(b, []).append(name)
        merge: Dict[str, Dict] = {}
        rest = {}
        for name, ab in adapters.items():
            b = owner(name)
            if b is None:
                rest[name] = ab
            else:
                merge.setdefault(b, {})[name] = ab
        try:
            for b in set(own) | set(merge):
                blocks[b].gather = functools.partial(
                    self._block_gather, model, own.get(b, []), tp_local,
                    merge.get(b), alpha)
            with self._block_gather(model, eager, tp_local, rest, alpha):
                yield model
        finally:
            for b in set(own) | set(merge):
                blocks[b].gather = None

    @torch.no_grad()
    def full_state(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """Every parameter of ``model`` whole, by name (new tensors for the
        sharded ones)."""
        return {n: self.full(n, p.detach()) if n in self.cuts else p.detach()
                for n, p in model.named_parameters()}

    @torch.no_grad()
    def unshard_(self, model: torch.nn.Module) -> None:
        """Put whole parameters back into the model's slots (the shards
        gathered; ``requires_grad`` kept)."""
        for name in self.cuts:
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            shard = mod._parameters[attr]
            mod._parameters[attr] = torch.nn.Parameter(
                self.full(name, shard.detach()),
                requires_grad=shard.requires_grad)

    def full_opt_state(self, opt, names: List[str]) -> Dict:
        """An Adam ``state_dict`` with every moment gathered whole
        (``names``: the parameter of each index), the form a checkpoint
        keeps whatever the world size."""
        sd = opt.state_dict()
        state = {}
        for idx, st in sd["state"].items():
            name = names[idx]
            state[idx] = {k: (self.full(name, v) if name in self.cuts
                              and torch.is_tensor(v) and v.ndim > 0 else v)
                          for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def local_opt_state(self, full_sd: Dict, names: List[str], device
                        ) -> Dict:
        """The inverse of ``full_opt_state``: each whole moment cut to
        this rank's shard."""
        state = {}
        for idx, st in full_sd["state"].items():
            name = names[int(idx)]
            state[int(idx)] = {k: (self.local(name, torch.as_tensor(v))
                                   .to(device) if name in self.cuts
                                   and torch.is_tensor(v) and v.ndim > 0
                                   else v) for k, v in st.items()}
        return {"state": state, "param_groups": full_sd["param_groups"]}


def shard_params(mesh: Mesh, model: torch.nn.Module, fsdp: bool = False
                 ) -> Sharding:
    """Cut the model's parameters in place into this rank's shards by the
    TP rules (when the model axis has more than one rank) and, with
    ``fsdp``, the data axis (``param_shardings``); parameters no rule
    cuts stay whole (replicated).  Returns the ``Sharding``."""
    specs = param_shardings(mesh, model, fsdp=fsdp)
    cuts: Dict[str, List[_Cut]] = {}
    for name, spec in specs.items():
        order = sorted((d for d, a in enumerate(spec) if a),
                       key=lambda d: spec[d] != MODEL_AXIS)
        if order:
            cuts[name] = [_Cut(spec[d], d, _qkv_groups(name, d, spec[d]))
                          for d in order]
    plan = Sharding(mesh, cuts)
    for name, param in model.named_parameters():
        if name not in cuts:
            continue
        for c in cuts[name]:
            n = mesh.shape[c.axis]
            if param.shape[c.dim] % (n * c.groups):
                raise ValueError(
                    f"{name} {tuple(param.shape)}: dim {c.dim} does not "
                    f"divide over the {c.axis} axis ({n})")
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        mod._parameters[attr] = torch.nn.Parameter(
            plan.local(name, param.detach()),
            requires_grad=param.requires_grad)
    return plan
