"""Profiling and step-time instrumentation (counterpart of
``aihab_clip_tpu/utils/profiling.py``).

  * ``trace(dir)``      — context manager around ``torch.profiler`` with the
                          CPU and (on a card) CUDA activities; writes one
                          Chrome trace (``trace_<time>.json``) into ``dir``;
  * ``annotate(name)``  — ``torch.profiler.record_function`` for a named
                          region;
  * ``device_memory_stats()`` — the card's bytes in use, peak and total from
                          ``torch.cuda.memory_stats`` (None off the card);
  * ``StepTimer``       — rolling step time and throughput, JAX's window and
                          arithmetic.

JAX's ``enable_compilation_cache`` has no counterpart: it configures XLA's
compile cache.  The kernels' build cache is ``ops/_build.py``'s (a library
per source under ``build/``, keyed by the hash of its source and headers).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, with_memory: bool = True):
    """Profile the block; the Chrome trace lands in ``log_dir``."""
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities(),
                                  profile_memory=with_memory)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def device_memory_stats() -> Optional[Dict[str, int]]:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of card 0, or None
    without a card (JAX returns None where the backend keeps no stats)."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(0)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(0).total_memory}


class StepTimer:
    """Rolling-window step timer: call ``tick(items)`` once per step."""

    def __init__(self, window: int = 50):
        # one maxlen for both, so each interval pairs with one item count
        self._times = deque(maxlen=window)
        self._items = deque(maxlen=window)
        self._t_last: Optional[float] = None
        self.total_steps = 0

    def tick(self, items: int = 0) -> None:
        now = time.perf_counter()
        if self._t_last is not None:
            self._times.append(now - self._t_last)
            self._items.append(items)
        self._t_last = now
        self.total_steps += 1

    @property
    def mean_step_seconds(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def items_per_second(self) -> float:
        t = sum(self._times)
        return sum(self._items) / t if t > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        out = {
            "steps": self.total_steps,
            "mean_step_ms": self.mean_step_seconds * 1e3,
            "items_per_sec": self.items_per_second,
        }
        mem = device_memory_stats()
        if mem:
            out["device_peak_mb"] = mem["peak_bytes_in_use"] / 1e6
        return out
