"""The result line's shape, and the refusals: no card, and a checkout that
holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys
import time

from benchmark import harness

SEED = 2 ** 31 + 5


def test_result_line_shape(tiny_cell):
    cell = tiny_cell("so400m-classify-b64", "siglip",
                     {"batch": 4, "pool_batches": 2, "check_rows": 4,
                      "warmup_batches": 1},
                     {"logit_gap": 1.0, "logit_rms": 1.0})
    res = harness.run_cell(cell, SEED, 0.3, False, "cpu",
                           time.perf_counter())
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"classify_images_per_s.so400m",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_per_layer_metrics_need_a_trace(tiny_cell):
    cell = tiny_cell("so400m-classify-b64", "siglip",
                     {"batch": 4, "pool_batches": 2, "check_rows": 4,
                      "warmup_batches": 1},
                     {"logit_gap": 1.0, "logit_rms": 1.0})
    res = harness.run_cell(cell, SEED, 0.3, True, "cpu", time.perf_counter())
    # off the card there is no device trace: only the span reader reads
    assert set(res["metrics"]) == {"dispatch_host_ms.classify.so400m"}
    assert "breakdown" not in res and "busy_s" not in res["device"]


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "so400m-classify-b64", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True, env=env,
        timeout=300)


def test_no_card_exits_nonzero_without_a_result():
    out = _run(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_cell_has_its_files():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.cell_of(spec, w["name"])
        assert (harness.BENCH / "loops"
                / f"{cell['traffic']['kind']}.py").exists()
        assert cell["limits"], f"{w['name']} has no limits"
        for m in cell["per_layer"]:
            assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
    for c in spec["configs"]:
        assert (harness.ROOT / c["file"]).exists()


def test_per_layer_metrics_move_a_metric_of_their_cells():
    """Each per-layer metric's cells report the end-to-end metric it
    moves, and each end-to-end metric reads a quantity its cells' loops
    return (``harness.quantity``)."""
    spec = harness.load_spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    every = [w["name"] for w in spec["workloads"]]
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", every):
            assert harness.applies(moved, w), (m["name"], w)
    assert harness.quantity("classify_images_per_s.so400m") == (
        "classify_images_per_s")
    assert harness.quantity("setup_s") == "setup_s"


def test_line_is_strict_json_when_a_number_is_infinite():
    res = {"correct": False, "metrics": {"x": {"value": float("inf")}},
           "checks": {"g": {"value": float("nan"), "limit": 1.0}},
           "run": {"lat": [1.0, float("-inf")]}}
    line = json.dumps(harness.strict_json(res), allow_nan=False)
    back = json.loads(line)
    assert back["metrics"]["x"]["value"] == "inf"
    assert back["checks"]["g"]["value"] == "nan"
    assert back["run"]["lat"] == [1.0, "-inf"]
