"""The reduction of a ``torch.profiler`` trace to what the readers and the
result line need: device time by kernel, the device's busy time (the union
of every kernel, copy and fill), and its idle gaps labelled by what the host
was doing (the benchmark's span and the innermost host call over the gap).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

GAPS_LABELLED = 400


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    base = base.split("<")[0].split("(")[0].strip()
    return base.rsplit("::", 1)[-1] or name[:80]


def _times(ev) -> Tuple[float, float]:
    try:
        start, dur = ev.start_ns(), ev.duration_ns()
    except AttributeError:
        start, dur = ev.start_us() * 1e3, ev.duration_us() * 1e3
    return start * 1e-9, dur * 1e-9


def _annotation(ev) -> bool:
    """A marked range on the device's timeline (the benchmark's spans) is
    no device work."""
    marked = getattr(ev, "is_user_annotation", None)
    return (ev.device_type().name == "CUDA"
            and ((marked is not None and marked()) or
                 ev.name().startswith("bench/")))


def read_profile(prof, wall_s: float) -> dict:
    """Kernels and host calls of a stopped profiler, reduced."""
    from torch.autograd import DeviceType

    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for ev in prof.profiler.kineto_results.events():
        start, dur = _times(ev)
        if _annotation(ev):
            continue
        if ev.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur, ev.name()))
        elif ev.device_type() == DeviceType.CPU:
            host.append((start, start + dur, ev.name()))
    kernel_s: Dict[str, float] = {}
    for s, e, name in dev:
        key = short_name(name)
        kernel_s[key] = kernel_s.get(key, 0.0) + (e - s)
    merged = _merge(sorted((s, e) for s, e, _ in dev))
    busy = sum(e - s for s, e in merged)
    return {"kernel_s": kernel_s, "busy_s": busy, "window_s": wall_s,
            "launches": len(dev),
            "idle": _label_gaps(merged, host, wall_s, busy)}


def _merge(intervals):
    out: List[List[float]] = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label_gaps(merged, host, wall_s: float, busy_s: float):
    """Idle seconds by the host's activity: the longest gaps between device
    work, each labelled by the benchmark span and the innermost host call
    that cover its middle; the rest of the idle time summed apart."""
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps.sort(reverse=True)
    starts = np.array([s for s, _, _ in host]) if host else np.zeros(0)
    ends = np.array([e for _, e, _ in host]) if host else np.zeros(0)
    names = [n for _, _, n in host]
    spans = np.array([n.startswith("bench/") for n in names], bool)
    by_label: Dict[str, float] = {}
    for length, a, b in gaps[:GAPS_LABELLED]:
        mid = 0.5 * (a + b)
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        span = [i for i in cover if spans[i]]
        inner = [i for i in cover if not spans[i]]
        label = names[min(span, key=lambda i: ends[i] - starts[i])] \
            if span else "outside the spans"
        if inner:
            label += " > " + names[min(inner,
                                       key=lambda i: ends[i] - starts[i])]
        by_label[label] = by_label.get(label, 0.0) + length
    rest = max(0.0, wall_s - busy_s - sum(by_label.values()))
    if rest > 0:
        by_label["shorter gaps and the segment's ends"] = rest
    return sorted(by_label.items(), key=lambda kv: -kv[1])


def breakdown(profile: dict, labels=None) -> dict:
    """The device's ten longest operations (segment A) and its idle time by
    what the host was doing (segment B, which traced the host too)."""
    ops = sorted(profile["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = labels if labels is not None else profile["idle"]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}


def kernel_seconds(profile: dict, table) -> float:
    """Device seconds of the kernels a metric's name table lists (exact
    short names)."""
    return sum(profile["kernel_s"].get(name, 0.0) for name in table)
