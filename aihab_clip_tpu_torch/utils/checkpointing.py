"""Model checkpoints with resume, and projector files (counterpart of
``aihab_clip_tpu/utils/checkpointing.py``).

  * path scheme: ``<save_model_dir>/<model>_<epoch>_<YYYYMMDD_HH>`` (``/``
    in the name becomes ``_``), under ``root_path`` when relative;
  * layout: ``meta.json`` (JAX's keys: ``epoch``, ``timestamp``,
    ``clip_backend``, ``open_clip_model``, ``backbone``, ``cfg``,
    ``has_opt_state``) and the committed directory ``state/`` holding
    ``payload.pt``: ``{"params": {name: tensor}, "opt_state":
    optimizer.state_dict()}`` written by ``torch.save`` and read with
    ``weights_only=True``.  ``state/`` is written into a temporary
    directory and renamed into place, as orbax renames on commit, so a
    checkpoint whose write never finished has no ``state/`` and
    ``latest_checkpoint`` skips it;
  * ``save_checkpoint(..., async_save=True)`` copies every tensor to the
    host before it returns (the train loop may update its parameters at
    once) and writes to disk on one background thread;
    ``wait_for_async_saves`` blocks until every write has committed.

The port cannot read the JAX package's orbax checkpoints (ROADMAP A18b),
nor JAX the port's; LoRA adapters go both ways (``lora_adapters.npz``,
``models/convert.py``).
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

PAYLOAD = "payload.pt"


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


def _commit(path: Path, payload: Dict) -> None:
    """Write ``state/`` into a temporary directory, then rename it into
    place (a reader never sees a half-written ``state/``)."""
    tmp = path / f"state.tmp-{os.getpid()}-{threading.get_ident()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / PAYLOAD)
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
    """``params``: {name: tensor}; ``opt_state``: an optimizer
    ``state_dict()`` (kept when ``finetune.save_optimizer``, default true).
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
    """{"params": {name: CPU tensor}, "opt_state" (when saved), "meta"}."""
    path = Path(path).resolve()
    meta = json.loads((path / "meta.json").read_text())
    state = path / "state"
    if not (state / PAYLOAD).is_file():
        raise FileNotFoundError(
            f"{path} holds no committed state/ (its write never finished)")
    restored = dict(torch.load(state / PAYLOAD, map_location="cpu",
                               weights_only=True))
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
