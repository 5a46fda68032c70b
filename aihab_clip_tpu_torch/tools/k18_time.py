"""K18 (``normalize_u8_pallas``) timed on one card: its own device time and
the host's time per call, in this checkout and optionally in another.

    python -m aihab_clip_tpu_torch.tools.k18_time [--parent DIR] [--reps 2]

Each measurement runs in a fresh process whose working directory and import
path are one checkout (``DIR``, e.g. a ``git archive`` of the parent commit
unpacked, or this one), so each builds and times its own kernel; the order is
parent, change, change, parent (``--reps`` rounds), or this checkout alone
without ``--parent``.  At uint8 [64, 224, 224, 3] -> bf16 (the eval batch of
path (a)), after warm-up:

  * ``graph_ms``: a CUDA graph of ``LAUNCHES`` launches replayed, CUDA events
    around the replay, over the count: the kernel's device time with the
    graph's gaps and no host in the way;
  * ``profiler_ms``: the kernel's mean duration in ``torch.profiler``'s CUDA
    activity over one replay of that graph (None when the trace holds no
    device time);
  * ``events_ms``: CUDA events around ``LAUNCHES`` calls back to back (how the
    kernel table's rows are timed; here bound by the host when the host's
    call outlasts the kernel);
  * ``host_ms``: the host clock over ``LAUNCHES`` calls and one synchronize;
  * ``fp32_graph_ms``: the graph's time with fp32 output;
  * ``cold_ms``: the kernel's mean duration (``torch.profiler``) in a graph
    whose every launch follows a 128 MB memset, so its input and output
    start outside the 50 MB L2 (at this shape both fit in L2 together,
    which the warm figures above enjoy);
  * ``exact``: the output equals the plain version bit for bit, in bf16 and
    fp32, at the batch and at a ragged 1 x 17 x 13 x 3.

Prints one JSON line per run (with the card's name and power limit) and, with
``--parent``, a summary line of the change's figures over the parent's.
``measure`` is also what ``chip_smoke.py`` calls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SHAPE = (64, 224, 224, 3)
LAUNCHES = 100

_RUN = r"""
import importlib.util, json, subprocess, sys
spec = importlib.util.spec_from_file_location("k18_time_tool", sys.argv[1])
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
from aihab_clip_tpu_torch.ops import pallas_preprocess as pp
out = tool.measure(pp)
out["card"] = subprocess.run(
    ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
     "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
print(json.dumps(out), flush=True)
"""


def _graph_ms(fn, launches: int):
    """CUDA-event ms per launch of a graph of ``launches`` calls of ``fn``,
    and the graph (for the profiler)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / launches, graph


def _profiler_ms(graph):
    """The mean device duration of the K18 kernel over one replay, from
    ``torch.profiler`` (None if the trace holds no device time for it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    times = [e for e in prof.key_averages() if "normalize_u8" in e.key]
    total = sum(getattr(e, "device_time_total", 0.0)
                or getattr(e, "cuda_time_total", 0.0) for e in times)
    count = sum(e.count for e in times)
    return total / count / 1e3 if count and total else None


def _cold_ms(fn, launches: int):
    """The kernel's mean duration over ``launches`` launches, each after a
    128 MB memset that evicts the L2."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def step():
        flush.zero_()
        return fn()

    _, graph = _graph_ms(step, launches)
    return _profiler_ms(graph)


def measure(pp, shape=SHAPE, launches: int = LAUNCHES, seed: int = 0) -> dict:
    """K18 of the package module ``pp`` (``ops.pallas_preprocess``) on the
    card: the figures of the module docstring."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, shape, dtype=torch.uint8,
                       generator=gen).cuda()
    ragged = torch.randint(0, 256, (1, 17, 13, 3), dtype=torch.uint8,
                           generator=gen).cuda()
    exact = all(
        torch.equal(pp.normalize_u8_pallas(t, dtype=dt),
                    pp.normalize_u8_pallas_plain(t, dtype=dt))
        for t in (u8, ragged) for dt in (torch.bfloat16, torch.float32))

    def call():
        return pp.normalize_u8_pallas(u8)

    for _ in range(5):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        call()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / launches
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(launches):
        call()
    e1.record()
    torch.cuda.synchronize()
    events_ms = e0.elapsed_time(e1) / launches
    graph_ms, graph = _graph_ms(call, launches)
    try:
        prof_ms = _profiler_ms(graph)
    except Exception as exc:  # the trace is a second reading, not a gate
        print(f"[k18] torch.profiler gave no reading: {exc!r}",
              file=sys.stderr)
        prof_ms = None
    fp32_ms, _ = _graph_ms(lambda: pp.normalize_u8_pallas(
        u8, dtype=torch.float32), launches)
    del graph
    out = dict(shape=list(shape), graph_ms=graph_ms, profiler_ms=prof_ms,
               events_ms=events_ms, host_ms=host_ms, fp32_graph_ms=fp32_ms,
               cold_ms=_cold_ms(call, launches // 5), exact=exact,
               launches=launches)
    return out


def _run(checkout: Path, label: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, str(Path(__file__).resolve())],
        cwd=checkout, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{label} run failed:\n{proc.stderr[-4000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    row["tree"] = label
    print(json.dumps(row), flush=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    here = Path(__file__).resolve().parents[2]
    if args.parent is None:
        _run(here, "change")
        return
    rows = []
    for _ in range(args.reps):
        for label, tree in (("parent", args.parent), ("change", here),
                            ("change", here), ("parent", args.parent)):
            rows.append(_run(tree.resolve(), label))
    summary = {}
    for key in ("graph_ms", "cold_ms", "events_ms", "host_ms",
                "fp32_graph_ms"):
        per = {t: [r[key] for r in rows if r["tree"] == t]
               for t in ("parent", "change")}
        summary[key] = dict(parent=per["parent"], change=per["change"])
        if per["parent"] and per["change"]:
            summary[key]["ratio"] = min(per["change"]) / min(per["parent"])
    print(json.dumps({"summary": summary,
                      "exact": all(r["exact"] for r in rows)}))


if __name__ == "__main__":
    main()
