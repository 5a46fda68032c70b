"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its traffic loop, reads the trace, runs the per-layer readers, decides
``correct`` and builds the result line.

A cell is (configuration, traffic).  Its files, all found by name:

* ``configs/<config>.json``: the sizes (the path is the config's ``file``);
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  general generator ``loops/<kind>.py`` that reads them;
* ``limits/<workload>.json``: each compared number's limit and the
  readings it was set from;
* ``metrics/<metric>.py``: one reader per per-layer metric.

A run: set-up (weights from the seed, the system built, every shape of
the cell warmed), the window (``--seconds``), then, with the program's
state freed, the plain reference over a sample drawn from the seed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aihab_clip_tpu")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def quantity(name: str) -> str:
    """The loop's quantity an end-to-end metric reports: its name up to the
    first dot, so that ``classify_images_per_s.so400m`` (a bound of its own
    for one model's cells) reads the loop's ``classify_images_per_s``."""
    return name.split(".", 1)[0]


def cell_of(spec: dict, workload: str) -> dict:
    """A workload's configuration, traffic, limits and metric lists."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits_path = BENCH / "limits" / f"{workload}.json"
    limits = (json.loads(limits_path.read_text())["limits"]
              if limits_path.exists() else {})
    return {"workload": w, "cfg": cfg, "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in spec["end_to_end"]
                           if applies(m, workload)],
            "per_layer": [m for m in spec["per_layer"]
                          if applies(m, workload)]}


def load_file_module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules (``names``, default
    ``sys.modules``) that the benchmark must not load, compared whole
    (``aihab_clip_tpu_torch`` is not ``aihab_clip_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(names or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own nvcc builds already land in ``<checkout>/build``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def few_threads() -> None:
    """One host thread for the math libraries' pools (set before torch is
    imported): the loops are host-paced, and idle pool threads spinning on
    the host's few cores only add noise to the runs."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def seed_mix(*parts: int) -> int:
    """A 63-bit seed from a run seed and sub-stream numbers."""
    h = 1469598103934665603
    for p in parts:
        h = ((h ^ (int(p) & (2 ** 64 - 1))) * 1099511628211) % (2 ** 64)
    return h % (2 ** 63)


def quantile(values, q: float) -> float:
    """Nearest-rank quantile of all ``values`` (inf counts as the
    largest)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


# ---------------------------------------------------------------------------


class Run:
    """One run's state: its inputs, its spans and counters, and what the
    loop hands back."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str, options: Optional[dict] = None):
        self.cell = cell
        self.cfg, self.traffic = cell["cfg"], cell["traffic"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = device
        self.options = options or {}
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, Any] = {}
        self.profile: Optional[dict] = None
        self.labels: Optional[list] = None
        self.rest: Optional[list] = None
        self.rest_spans: Optional[Dict[str, int]] = None
        self._prof = None
        self._phase: Optional[str] = None
        self._stopped: Dict[str, tuple] = {}
        self._a_items = int(self.traffic.get("trace_items", 0))
        self._b_items = int(self.traffic.get("label_items", 0))

    @property
    def on_card(self) -> bool:
        return self.device.startswith("cuda")

    @contextmanager
    def span(self, name: str):
        """The benchmark's own span around a call into a layer: its host
        time kept by name, and a marked range in the trace."""
        rf = None
        if self._prof is not None:
            import torch

            rf = torch.profiler.record_function(f"bench/{name}")
            rf.__enter__()
        start = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - start)
            if rf is not None:
                rf.__exit__(None, None, None)

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize()

    # -- the traced segments ----------------------------------------------
    # With --trace 1 the window holds two traced segments, then an untraced
    # rest: segment A (``trace_items`` items, the card's activity alone, so
    # the host pays almost nothing for it) gives the kernels' device time,
    # the busy time and the idle share; segment B (``label_items`` items,
    # the host's calls too) labels the idle gaps by what the host was doing;
    # the rest gives the rates and the spans the readers use.

    def trace_counts(self, a_items: int, b_items: int) -> None:
        """Items in segments A and B, where the traffic file does not give
        them (the open loop counts its sends from its rate)."""
        self._a_items, self._b_items = a_items, b_items

    def trace_begin(self) -> None:
        if self.trace and self.on_card and self._phase is None:
            self._phase = "A"
            self._start(host=False)

    def trace_item(self, k: int, rows: int, drain=None) -> None:
        """After the window's ``k``-th item (``rows`` images so far);
        ``drain`` waits for the items in flight (None: an open loop)."""
        if self._phase == "A" and k >= self._a_items:
            self._stopped["A"] = self._stop(drain, k, rows)
            self._phase, self._b_from = "B", k
            self._start(host=True)
        elif self._phase == "B" and k >= self._b_from + self._b_items:
            self._stopped["B"] = self._stop(drain, k, rows)
            self._phase = "rest"
            self.rest = [time.perf_counter(), k, rows, None, None]
            self.rest_spans = {n: len(v) for n, v in self.spans.items()}

    def trace_end(self, k: int, rows: int, drain=None) -> None:
        """At the window's end, after ``k`` items and ``rows`` images; the
        traces are read only now, so reading them costs the window
        nothing."""
        if self._phase in ("A", "B"):
            self._stopped[self._phase] = self._stop(drain, k, rows)
        elif self._phase == "rest":
            self.rest[3:] = [time.perf_counter() - self.rest[0],
                             (k - self.rest[1], rows - self.rest[2])]
        self._phase = "done"
        from .trace import read_profile

        for seg, (prof, wall, info) in self._stopped.items():
            out = read_profile(prof, wall)
            out.update(info)
            if seg == "A":
                self.profile = out
            else:
                self.labels = out["idle"]
        self._stopped = {}

    def _start(self, host: bool) -> None:
        import torch

        self.sync()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._prof_t = time.perf_counter()

    def _stop(self, drain, items: int, rows: int):
        if drain is not None:
            drain()
            self.sync()
        wall = time.perf_counter() - self._prof_t
        prof, self._prof = self._prof, None
        prof.stop()
        return prof, wall, {"items": items, "rows": rows,
                            "synced": drain is not None}

    def window_rest(self):
        """(seconds, items, images) of the window after the traced
        segments, or None."""
        if self.rest is None or self.rest[3] is None or self.rest[3] <= 0:
            return None
        return self.rest[3], self.rest[4][0], self.rest[4][1]

    def spans_after_trace(self, name: str) -> List[float]:
        """The span's durations in the untraced rest of the window (all of
        them in a run without a trace)."""
        spans = self.spans.get(name, [])
        if self.rest_spans is None:
            return [] if self.trace and self.on_card else spans
        return spans[self.rest_spans.get(name, 0):]


def device_info(run: Run) -> dict:
    import torch

    if not run.on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    n = int(run.cell["workload"].get("chips", 1))
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(n))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n, "memory_peak_bytes": int(peak)}


def card_settings() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({type(exc).__name__})"


def free_device() -> None:
    gc.collect()
    try:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    except ImportError:
        pass


def strict_json(obj):
    """The result with every infinite or NaN float written as a string
    ("inf", "nan"), so the line is JSON that any parser reads."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: strict_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [strict_json(v) for v in obj]
    return obj


def judge(numbers: Dict[str, float], limits: Dict[str, dict]):
    """The numbers the cell's limits file names, each beside its limit;
    ``correct`` when there is at least one and every one is finite and
    within its limit.  The loop's other numbers are returned apart, as
    readings that are not compared."""
    checks, ok = {}, bool(limits)
    for name, lim in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": lim["limit"]}
        if not math.isfinite(value) or value > lim["limit"]:
            ok = False
    return ok, checks, {k: v for k, v in numbers.items() if k not in limits}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str, t0: float, options: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result line as a dict."""
    import torch

    run = Run(cell, seed, seconds, trace, device, options)
    if run.on_card:
        run.counters["card"] = card_settings()
    loop_mod = load_file_module(BENCH / "loops" / f"{run.traffic['kind']}.py",
                                f"benchmark_loop_{run.traffic['kind']}")
    loop = loop_mod.Loop(run)
    loop.setup()
    free_device()
    if run.on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    e2e = loop.window()
    run.sync()
    device = device_info(run)
    loop.release()
    free_device()
    numbers = loop.verify()
    correct, checks, readings = judge(numbers, cell["limits"])
    correct = correct and loop.failed == 0
    metrics: Dict[str, dict] = {}
    if not trace:
        values = dict(e2e, setup_s=setup_s)
        for m in cell["end_to_end"]:
            value = values.get(m["name"], values.get(quantity(m["name"])))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = MetricContext(run, device)
        for m in cell["per_layer"]:
            reader = load_file_module(BENCH / "metrics" / f"{m['name']}.py",
                                      "benchmark_metric_"
                                      + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.profile is not None:
            device["busy_s"] = run.profile["busy_s"]
            device["window_s"] = run.profile["window_s"]
    result = {"correct": bool(correct), "attempted": int(loop.attempted),
              "failed": int(loop.failed), "metrics": metrics,
              "device": device}
    if trace and run.profile is not None:
        from .trace import breakdown

        result["breakdown"] = breakdown(run.profile, run.labels)
    result["run"] = {"workload": cell["workload"]["name"], "seed": run.seed,
                     "seconds": run.seconds, "setup_s": setup_s,
                     "card": run.counters.get("card", ""),
                     "readings": readings, **loop.report()}
    result["checks"] = checks
    return result


class MetricContext:
    """What a per-layer reader reads: the configuration and traffic, the
    traced segment A (``profile``), the untraced rest of the window
    (``rest``: seconds, items, images), the spans of the rest
    (``spans(name)``), the counters, the device record and the benchmark's
    arithmetic."""

    def __init__(self, run: Run, device: dict):
        from . import arith

        self.cfg, self.traffic = run.cfg, run.traffic
        self.profile = run.profile
        self.rest = run.window_rest()
        self.spans = run.spans_after_trace
        self.counters = run.counters
        self.device = device
        self.arith = arith
        self.peaks = (arith.peaks_for(device.get("kind", ""))
                      if device.get("platform") == "gpu" else None)
