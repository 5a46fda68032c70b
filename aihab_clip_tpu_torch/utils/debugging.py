"""Numerical-debugging helpers (counterpart of
``aihab_clip_tpu/utils/debugging.py``).

  * ``nan_debugging()``      — context manager turning on autograd's anomaly
                               mode, so the first backward op that produces
                               a NaN raises with the forward op's traceback
                               (JAX: ``jax_debug_nans``);
  * ``assert_finite(tree)``  — host check that every floating leaf of a
                               nested dict / list of tensors or arrays
                               (params, grads, metrics) is finite; names
                               the offending leaves with their counts, in
                               JAX's ``keystr`` form;
  * ``finite_or_raise(x)``   — host check of one tensor, returned unchanged
                               (JAX's in-jit callback; eager PyTorch checks
                               on the spot, which syncs a card).
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def nan_debugging(enabled: bool = True):
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(bool(enabled))
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) in JAX's flattening order: dict keys sorted, lists
    and tuples in order; ``None`` is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def assert_finite(tree: Any, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming every leaf that holds a NaN or
    an Inf, with its count."""
    bad = []
    for path, leaf in _leaves(tree):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            bad.append(f"{path} ({n_bad} non-finite)")
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: " + "; ".join(bad))


def finite_or_raise(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Raise when ``x`` holds a NaN or an Inf; returns ``x`` unchanged."""
    if not bool(torch.isfinite(x.float()).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x
