"""Model checkpoints with resume, and projector files (counterpart of
``aihab_clip_tpu/utils/checkpointing.py``), in the JAX package's layout:
either package resumes, warm-starts or evaluates from the other's.

  * path scheme: ``<save_model_dir>/<model>_<epoch>_<YYYYMMDD_HH>`` (``/``
    in the name becomes ``_``), under ``root_path`` when relative;
  * layout: ``meta.json`` (JAX's keys: ``epoch``, ``timestamp``,
    ``clip_backend``, ``open_clip_model``, ``backbone``, ``cfg``,
    ``has_opt_state``) and ``state/``, orbax's ``StandardCheckpointer``
    layout (``utils/orbax.py``: ``_METADATA``, an OCDBT database of zarr
    arrays) holding ``{"params": JAX's param tree, "opt_state": optax's
    state}``.  ``params`` are the model's under JAX's names and layouts
    (``models/convert.state_dict_to_flax_params``).  ``opt_state`` is
    ``optax.inject_hyperparams(optax.adam)``'s state, JAX's PEFT optimizer:
    ``count``, ``hyperparams`` (``learning_rate``, ``b1``, ``b2``, ``eps``,
    ``eps_root``), ``hyperparams_states`` and ``inner_state`` =
    (ScaleByAdamState(``count``, ``mu``, ``nu``), EmptyState()); ``mu`` and
    ``nu`` cover the trainable leaves alone (JAX's ``partition_params``),
    from ``torch.optim.Adam``'s ``exp_avg`` and ``exp_avg_sq``, ``count``
    from its ``step`` (``adam_to_optax``, ``optax_to_adam``).  A LoRA run's
    moments sit under JAX's adapter tree (``<kernel path>: {a, b}``).
    ``state/`` is written into a temporary directory and renamed into
    place, as orbax renames on commit, so a checkpoint whose write never
    finished has no ``state/`` and ``latest_checkpoint`` skips it;
  * ``save_checkpoint(..., async_save=True)`` copies every tensor to the
    host before it returns (the train loop may update its parameters at
    once) and writes to disk on one background thread;
    ``wait_for_async_saves`` blocks until every write has committed.

``load_checkpoint`` also reads ``state/payload.pt`` (``torch.save`` of
{"params", "opt_state"}), the port's layout before it wrote JAX's.  LoRA
adapters go both ways through ``lora_adapters.npz`` (``models/convert.py``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..cache.feature_cache import resolve_model_name

from ..models.convert import (flax_params_to_state_dict, jax_kernel_path,
                              state_dict_to_flax_params)
from . import orbax

LEGACY_PAYLOAD = "payload.pt"


def _resolve_dir(root: Path, path: str) -> Path:
    out = Path(path)
    return out if out.is_absolute() else root / out


def _ckpt_dir(cfg) -> Path:
    ft_cfg = cfg.get("finetune", {})
    root = Path(cfg.get("root_path", "./"))
    return _resolve_dir(root, ft_cfg.get("save_model_dir", "model_ckpt"))


def checkpoint_path(cfg, epoch: int, timestamp: Optional[str] = None) -> Path:
    name = resolve_model_name(cfg)
    ts = timestamp or datetime.now().strftime("%Y%m%d_%H")
    return _ckpt_dir(cfg) / f"{name}_{int(epoch)}_{ts}".replace("/", "_")


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to the host (a new
    buffer even for CPU tensors, so later in-place updates cannot reach
    the checkpoint)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _nest(flat: Dict[str, Any]) -> Dict:
    """{"a/b/c": leaf} -> nested dicts."""
    out: Dict = {}
    for key, v in flat.items():
        node = out
        *head, leaf = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _lora_split(name: str):
    """A LoRA adapter tensor's name (``<weight name>.a`` or ``.b``) ->
    (weight name, "a" | "b"); None for a model parameter."""
    base, _, leaf = name.rpartition(".")
    return (base, leaf) if leaf in ("a", "b") and base.endswith(
        "weight") else None


def adam_to_optax(opt_state: Dict, params: Dict[str, torch.Tensor]) -> Dict:
    """A ``torch.optim.Adam`` ``state_dict`` whose group names its
    parameters (``param_names``) -> optax's ``inject_hyperparams(adam)``
    state over those parameters in JAX's tree and layouts.  A parameter
    with no Adam state yet (no gradient so far) gets zero moments, as optax
    keeps them.  ``params`` gives the shapes of those."""
    group = opt_state["param_groups"][0]
    names = group.get("param_names")
    states = opt_state["state"]
    if names is None:
        if states:
            raise ValueError("the optimizer state names no parameters "
                             "(param_groups[0]['param_names'])")
        names = []
    steps = {float(st["step"]) for st in states.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam steps differ across parameters: {steps}")
    count = np.int32(steps.pop() if steps else 0)
    moments = {"mu": {}, "nu": {}}
    for idx, name in zip(group["params"], names):
        st = states.get(idx)
        for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            t = st[slot] if st is not None else torch.zeros_like(
                params[name])
            moments[key][name] = t
    tree = {}
    for key, by_name in moments.items():
        node = _nest(state_dict_to_flax_params(
            {n: t for n, t in by_name.items() if _lora_split(n) is None}))
        for n, t in by_name.items():
            split = _lora_split(n)
            if split is not None:  # JAX's adapter tree: {kernel path: a, b}
                node.setdefault(jax_kernel_path(split[0]), {})[split[1]] = \
                    _f32(t.detach().float().cpu().numpy())
        tree[key] = node
    b1, b2 = group["betas"]
    return {"count": count,
            "hyperparams": {"b1": _f32(b1), "b2": _f32(b2),
                            "eps": _f32(group["eps"]), "eps_root": _f32(0.0),
                            "learning_rate": _f32(group["lr"])},
            "hyperparams_states": {},
            "inner_state": ({"count": count, "mu": tree["mu"],
                             "nu": tree["nu"]}, None)}


def _py(x) -> float:
    """A float32 scalar as the shortest float that rounds to it (0.9, not
    0.8999999761581421)."""
    return float(str(np.float32(x)))


def optax_to_adam(state: Dict) -> Dict:
    """The inverse of ``adam_to_optax``: a ``torch.optim.Adam``
    ``state_dict`` over the parameters the moments name (in JAX's order),
    ``param_names`` in its group.  ``adam_state_for`` orders it for an
    optimizer."""
    inner = state["inner_state"][0]
    step = torch.tensor(float(np.asarray(inner["count"])), dtype=torch.float32)
    per: Dict[str, Dict] = {}
    for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        node = inner[key]
        dense = {k: v for k, v in node.items() if "/" not in k}
        for name, t in flax_params_to_state_dict(dense).items():
            per.setdefault(name, {})[slot] = t
        for path, ab in node.items():
            if "/" in path:  # a LoRA adapter's {a, b}
                for leaf, v in ab.items():
                    per.setdefault(f"{_port_weight_name(path)}.{leaf}", {})[
                        slot] = torch.from_numpy(np.array(v, np.float32))
    names = list(per)
    hp = state["hyperparams"]
    return {"state": {i: {"step": step.clone(), **per[n]}
                      for i, n in enumerate(names)},
            "param_groups": [{
                "param_names": names, "lr": _py(hp["learning_rate"]),
                "betas": (_py(hp["b1"]), _py(hp["b2"])),
                "eps": _py(hp["eps"]), "weight_decay": 0, "amsgrad": False,
                "maximize": False, "foreach": None, "capturable": False,
                "differentiable": False, "fused": None,
                "params": list(range(len(names)))}]}


def _port_weight_name(kernel_path: str) -> str:
    """JAX's Dense kernel path -> the port's weight name (the inverse of
    ``jax_kernel_path``)."""
    name, _ = next(iter(flax_params_to_state_dict(
        {kernel_path: np.zeros((1, 1), np.float32)}).items()))
    return name


def adam_state_for(opt_state: Dict, names: List[str],
                   template: Dict) -> Dict:
    """A checkpoint's Adam ``state_dict`` laid out for an optimizer over
    ``names`` (its parameter of each index), whose own ``state_dict()`` is
    ``template``: the moments by name, the group's settings the
    optimizer's own (a state without ``param_names``, the port's layout
    before JAX's, is taken as it stands)."""
    saved = opt_state["param_groups"][0].get("param_names")
    if saved is None:
        return opt_state
    by_name = {n: opt_state["state"][i]
               for i, n in zip(opt_state["param_groups"][0]["params"], saved)
               if i in opt_state["state"]}
    missing = sorted(set(names) - set(saved))
    if missing:
        raise KeyError(f"the checkpoint's optimizer state lacks {missing[:5]}"
                       " (another set of trainable parameters)")
    groups = [{k: v for k, v in g.items() if k != "param_names"}
              for g in template["param_groups"]]
    return {"state": {i: by_name[n] for i, n in enumerate(names)
                      if n in by_name},
            "param_groups": groups}


def with_param_names(opt_state: Dict, names: List[str]) -> Dict:
    """``opt_state`` with its group naming each index's parameter (what
    ``adam_to_optax`` needs)."""
    groups = [dict(g) for g in opt_state["param_groups"]]
    groups[0]["param_names"] = list(names)
    return {"state": opt_state["state"], "param_groups": groups}


def _commit(path: Path, payload: Dict) -> None:
    """Write ``state/`` (JAX's layout) into a temporary directory, then
    rename it into place (a reader never sees a half-written
    ``state/``)."""
    tmp = path / f"state.tmp-{os.getpid()}-{threading.get_ident()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tree = {"params": _nest(state_dict_to_flax_params(payload["params"]))}
    if "opt_state" in payload:
        tree["opt_state"] = adam_to_optax(payload["opt_state"],
                                          payload["params"])
    orbax.write_state(tmp, tree)
    final = path / "state"
    if final.exists():   # the same model, epoch and hour saved again
        shutil.rmtree(final)
    os.replace(tmp, final)


# one writer thread for the process, made at the first async save
_WRITER: Optional[ThreadPoolExecutor] = None
_PENDING: List[Future] = []
_LOCK = threading.Lock()


def _writer() -> ThreadPoolExecutor:
    global _WRITER
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="ckpt-writer")
    return _WRITER


def wait_for_async_saves() -> None:
    """Block until every async checkpoint write has committed; re-raises a
    write's error."""
    with _LOCK:
        pending, _PENDING[:] = list(_PENDING), []
    for fut in pending:
        fut.result()


def save_checkpoint(cfg, params: Dict, opt_state: Any = None, epoch: int = 0,
                    extra_meta: Optional[Dict] = None,
                    async_save: bool = False) -> Path:
    """``params``: {name: tensor}; ``opt_state``: an Adam ``state_dict()``
    naming its parameters (``with_param_names``; kept when
    ``finetune.save_optimizer``, default true).
    ``async_save``: return once the tensors are on the host, and write on
    the background thread; call ``wait_for_async_saves()`` before relying
    on the files."""
    ts = datetime.now().strftime("%Y%m%d_%H")
    path = checkpoint_path(cfg, epoch, ts).resolve()
    path.mkdir(parents=True, exist_ok=True)
    payload = {"params": _to_host(dict(params))}
    if opt_state is not None and bool(cfg.get("finetune", {}).get(
            "save_optimizer", True)):
        payload["opt_state"] = _to_host(opt_state)
    if async_save:
        with _LOCK:
            _PENDING.append(_writer().submit(_commit, path, payload))
    else:
        _commit(path, payload)
    meta = {
        "epoch": int(epoch),
        "timestamp": ts,
        "clip_backend": cfg.get("clip_backend", "openclip"),
        "open_clip_model": cfg.get("open_clip_model", None),
        "backbone": cfg.get("backbone", None),
        "cfg": _cfg_to_jsonable(cfg),
        "has_opt_state": "opt_state" in payload,
    }
    if extra_meta:
        meta.update(extra_meta)
    (path / "meta.json").write_text(json.dumps(meta, indent=2, default=str))
    return path


def _cfg_to_jsonable(cfg) -> Dict:
    try:
        return json.loads(json.dumps(
            cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg),
            default=str))
    except Exception:
        return {}


def load_checkpoint(path) -> Dict[str, Any]:
    """{"params": {name: CPU tensor}, "opt_state" (an Adam ``state_dict``
    naming its parameters, when saved), "meta"}, from JAX's layout (either
    package's) or the port's older ``payload.pt``."""
    path = Path(path).resolve()
    meta = json.loads((path / "meta.json").read_text())
    state = path / "state"
    if (state / LEGACY_PAYLOAD).is_file():
        restored = dict(torch.load(state / LEGACY_PAYLOAD,
                                   map_location="cpu", weights_only=True))
    elif (state / "_METADATA").is_file():
        tree = orbax.read_state(state)
        restored = {"params": flax_params_to_state_dict(tree["params"])}
        if "opt_state" in tree:
            restored["opt_state"] = optax_to_adam(tree["opt_state"])
    else:
        raise FileNotFoundError(
            f"{path} holds no committed state/ (its write never finished)")
    restored["meta"] = meta
    return restored


def load_params_into(model: torch.nn.Module, params: Dict) -> None:
    """Copy checkpoint ``params`` into the model's parameters in place
    (every parameter must be present, with its shape)."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    if missing:
        raise KeyError(f"checkpoint lacks parameters {missing[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(params[name])


def latest_checkpoint(cfg) -> Optional[Path]:
    """Newest committed checkpoint directory for the configured model, or
    None.  A name must be the model's followed by ``_`` (so "ViT-B-16"
    is not shadowed by "ViT-B-16-SigLIP2..."), and the directory must hold
    ``meta.json`` and the committed ``state/``."""
    ckpt_dir = _ckpt_dir(cfg)
    if not ckpt_dir.is_dir():
        return None
    prefix = resolve_model_name(cfg)
    candidates = [p for p in ckpt_dir.iterdir()
                  if p.is_dir() and p.name.startswith(prefix + "_")
                  and (p / "meta.json").is_file()
                  and (p / "state").is_dir()]
    if not candidates:
        return None

    def sort_key(p: Path):
        m = re.search(r"_(\d+)_(\d{8}_\d{2})$", p.name)
        return (m.group(2), int(m.group(1))) if m else ("", 0)

    return max(candidates, key=sort_key)


def _np(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_projector(path, weight, bias=None,
                   meta: Optional[Dict] = None) -> None:
    """Persist a ProLIP projector (npz + json): the same ``.npz`` keys
    (``weight``, ``bias`` when present) as JAX's, so either package reads
    the other's projector."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {"weight": _np(weight)}
    if bias is not None:
        arrays["bias"] = _np(bias)
    np.savez(path, **arrays)
    if meta:
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2,
                                                        default=str))


def load_projector(path):
    """(weight, bias or None) as numpy arrays."""
    with np.load(path) as data:
        weight = data["weight"]
        bias = data["bias"] if "bias" in data.files else None
    return weight, bias
