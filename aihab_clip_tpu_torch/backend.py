"""Device resolution (counterpart of ``aihab_clip_tpu/backend.py``).

JAX decides placement from its default backend; the port is explicit: every
entry point takes a ``device`` and resolves it here.  A request for the card
where none is present raises — it never falls back to the CPU silently, so
a number measured "on the GPU" cannot quietly come from the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.  Raises when
    CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
