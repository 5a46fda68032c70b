"""LoRA: low-rank adapter fine-tuning (counterpart of
``aihab_clip_tpu/train/lora.py``).

Every target weight gets a trainable pair ``A [in, r]``, ``B [r, out]`` in
JAX's layout (A ~ N(0, 1) / r in fp32, B = 0, so the delta starts at zero)
and the tower trains ``W_eff = W + (alpha / r) * A @ B`` with the base
weights frozen.  The port keeps ``nn.Linear``'s [out, in] weight, so the
delta it adds is the transpose: ``_delta`` is the one place that says so.

Targets: the attention projections (CLIP's packed ``in_proj`` and
``out_proj``; SigLIP's ``q/k/v/out_proj``) and, with ``include_mlp``, the
MLP's ``c_fc``/``c_proj`` of every transformer block of the chosen towers
(``visual``, and ``text`` under ``tune_text``): the 2-D Dense weights below
``<tower>.transformer``.  The adapters are keyed by the port's parameter
names; ``models/convert.py`` maps them to and from JAX's kernel paths, the
keys of ``lora_adapters.npz``.

The merge happens each step, as JAX's does in-jit: ``lora_applied`` swaps
each target parameter of the model for its ``W_eff`` (a tensor that carries
the adapters' gradient) for the length of a ``with`` block, so every encode
path (the module, the scanned encode, ``pack_fastest``'s kernel pack, the
text head) reads ``W_eff`` while the base parameters stay untouched, and
``state_dict()`` never sees anything but the plain names.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Tuple

import torch

from ..models.convert import jax_kernel_path

# the weights a transformer block's modules carry as targets
ATTN_KERNELS = ("in_proj", "out_proj", "q_proj", "k_proj", "v_proj")
MLP_KERNELS = ("c_fc", "c_proj")


def _module_of(name: str) -> str:
    """The Dense module a weight belongs to (``in_proj_weight`` is the
    packed attention's ``in_proj``)."""
    parts = name.split(".")
    return "in_proj" if parts[-1] == "in_proj_weight" else parts[-2]


def lora_target_paths(model: torch.nn.Module, *,
                      towers: Tuple[str, ...] = ("visual",),
                      include_mlp: bool = False) -> List[str]:
    """Parameter names of every target weight, in the order of JAX's
    sorted kernel paths (the order ``lora_init`` draws in)."""
    found = []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if (len(parts) < 4 or parts[0] not in towers
                or parts[1] != "transformer" or p.ndim != 2
                or not (parts[-1] == "weight"
                        or parts[-1] == "in_proj_weight")):
            continue
        mod = _module_of(name)
        if mod in ATTN_KERNELS or (include_mlp and mod in MLP_KERNELS):
            found.append((tuple(jax_kernel_path(name).split("/")), name))
    return [name for _, name in sorted(found)]


def lora_init(model: torch.nn.Module, rank: int,
              generator: torch.Generator, *,
              towers: Tuple[str, ...] = ("visual",),
              include_mlp: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """{parameter name: {"a": [in, r], "b": [r, out]}}, fp32 leaf tensors
    on the model's device that require a gradient: A from ``generator``
    (a CPU ``torch.Generator``; the runner seeds it ``seed + 7919``), B
    zero."""
    params = dict(model.named_parameters())
    adapters = {}
    for name in lora_target_paths(model, towers=towers,
                                  include_mlp=include_mlp):
        w = params[name]
        n_out, n_in = w.shape
        a = torch.randn(n_in, rank, generator=generator) * (1.0 / rank)
        adapters[name] = {
            "a": a.to(w.device).requires_grad_(),
            "b": torch.zeros(rank, n_out, device=w.device).requires_grad_()}
    if not adapters:
        raise ValueError(
            f"no LoRA target kernels found under towers={towers} "
            "(expected <tower>.transformer.resblocks.<i>... 2-D weights)")
    return adapters


def _delta(ab: Mapping[str, torch.Tensor], alpha: float) -> torch.Tensor:
    """(alpha / r) * A @ B in JAX's [in, out], transposed to the port's
    [out, in]."""
    rank = ab["a"].shape[1]
    return ((ab["a"] @ ab["b"]) * (alpha / rank)).T


def lora_merge(params: Mapping[str, torch.Tensor], adapters: Mapping,
               alpha: float) -> Dict[str, torch.Tensor]:
    """{name: W_eff} for every adapted weight, the rest as given:
    ``W_eff = (W.float() + delta).to(W.dtype)``; differentiable with
    respect to the adapters."""
    out = dict(params)
    for name, ab in adapters.items():
        w = out[name]
        out[name] = (w.float() + _delta(ab, alpha).to(w.device)).to(w.dtype)
    return out


@contextlib.contextmanager
def lora_applied(model: torch.nn.Module, adapters: Mapping, alpha: float):
    """Inside the block, each adapted parameter of ``model`` reads as its
    ``W_eff``; the base parameters are put back on exit (also on error)."""
    slots = {}
    for name in adapters:
        mod_name, _, attr = name.rpartition(".")
        slots[name] = (model.get_submodule(mod_name), attr)
    # the slots' tensors as they read now (a sharded model's whole ones
    # inside its ``Sharding.gathered`` block)
    merged = lora_merge({n: m._parameters[a] for n, (m, a) in slots.items()},
                        adapters, alpha)
    swapped = []
    try:
        for name, w_eff in merged.items():
            mod, attr = slots[name]
            swapped.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = w_eff
        yield model
    finally:
        for mod, attr, orig in reversed(swapped):
            mod._parameters[attr] = orig


@torch.no_grad()
def merged_params(model: torch.nn.Module, adapters: Mapping,
                  alpha: float) -> Dict[str, torch.Tensor]:
    """Every parameter of the model by name, the adapted ones as W_eff
    (new tensors; the model is not changed)."""
    detached = {n: {k: t.detach() for k, t in ab.items()}
                for n, ab in adapters.items()}
    return lora_merge({n: p.detach() for n, p in model.named_parameters()},
                      detached, alpha)


def lora_param_count(adapters: Mapping) -> int:
    return sum(int(ab["a"].numel() + ab["b"].numel())
               for ab in adapters.values())
