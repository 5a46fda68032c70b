"""Projector checkpoints (counterpart of ``save_projector`` /
``load_projector`` in ``aihab_clip_tpu/utils/checkpointing.py``): the same
``.npz`` keys (``weight``, ``bias`` when present) and the JSON beside it,
so either package reads the other's projector.  The model checkpoints
(orbax there) are ROADMAP A10."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def _np(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_projector(path, weight, bias=None,
                   meta: Optional[Dict] = None) -> None:
    """Persist a ProLIP projector (npz + json)."""
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
