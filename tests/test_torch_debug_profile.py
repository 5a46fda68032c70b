"""The port's debugging, profiling and logging utilities against the JAX
package's: ``StepTimer`` on the same clock ticks, ``assert_finite`` naming
the same leaves with the same counts, ``finite_or_raise``,
``nan_debugging``, ``trace``/``annotate`` writing a Chrome trace, the
``profile_dir`` of ``finetune``, and ``RunLogger``'s W&B mode (with a
stand-in ``wandb`` module, and its fallback without one) and confusion
matrix heatmaps (and their skip without ``seaborn``)."""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.utils import debugging as jax_debugging
from aihab_clip_tpu.utils import logging as jax_logging
from aihab_clip_tpu.utils import profiling as jax_profiling

from aihab_clip_tpu_torch.utils import debugging, logging, profiling


def _clock(monkeypatch, module, ticks):
    it = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("window", [3, 50])
def test_step_timer_matches_jax(monkeypatch, window):
    ticks = [0.0, 0.5, 0.75, 1.5, 1.6, 2.9, 3.0]
    items = [0, 8, 8, 7, 8, 3, 8]
    mine, ref = profiling.StepTimer(window), jax_profiling.StepTimer(window)
    for timer, module in ((mine, profiling), (ref, jax_profiling)):
        _clock(monkeypatch, module, list(ticks))
        for n in items:
            timer.tick(items=n)
    assert mine.total_steps == ref.total_steps == len(ticks)
    assert mine.mean_step_seconds == pytest.approx(ref.mean_step_seconds,
                                                   rel=1e-12)
    assert mine.items_per_second == pytest.approx(ref.items_per_second,
                                                  rel=1e-12)
    got, want = mine.summary(), ref.summary()
    for key in ("steps", "mean_step_ms", "items_per_sec"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    empty = profiling.StepTimer()
    assert empty.mean_step_seconds == 0.0 and empty.items_per_second == 0.0


def test_assert_finite_matches_jax():
    tree = {"b": {"w": np.array([1.0, np.nan, np.inf], np.float32),
                  "ok": np.ones(3, np.float32)},
            "a": [np.zeros(2, np.float32), np.array([np.nan], np.float32)],
            "i": np.array([1, 2], np.int32), "n": None}
    with pytest.raises(FloatingPointError) as ref:
        jax_debugging.assert_finite(tree, "grads")
    torch_tree = {"b": {"w": torch.tensor([1.0, float("nan"), float("inf")]),
                        "ok": torch.ones(3, dtype=torch.bfloat16)},
                  "a": [torch.zeros(2), torch.tensor([float("nan")])],
                  "i": torch.tensor([1, 2]), "n": None}
    for t in (tree, torch_tree):
        with pytest.raises(FloatingPointError) as got:
            debugging.assert_finite(t, "grads")
        assert str(got.value) == str(ref.value)
    assert "(2 non-finite)" in str(ref.value)
    debugging.assert_finite({"x": torch.ones(2)})
    jax_debugging.assert_finite({"x": np.ones(2)})


def test_finite_or_raise_and_nan_debugging():
    x = torch.ones(3)
    assert debugging.finite_or_raise(x) is x
    with pytest.raises(FloatingPointError, match="loss"):
        debugging.finite_or_raise(torch.tensor([1.0, float("inf")]), "loss")
    with pytest.raises(FloatingPointError, match="loss"):
        np.asarray(jax_debugging.finite_or_raise(jnp.array([jnp.inf]),
                                                 "loss"))
    assert not torch.is_anomaly_enabled()
    with debugging.nan_debugging():
        assert torch.is_anomaly_enabled()
        w = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (w.sqrt() * 0.0 / w).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "my_region" in names
    assert profiling.device_memory_stats() is None or torch.cuda.is_available()


def test_finetune_profile_dir(tmp_path):
    """``profile_dir`` traces the first epoch's first 5 steps: one Chrome
    trace with 5 ``train_step`` regions; the report carries the
    ``StepTimer``'s summary."""
    from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
    from aihab_clip_tpu_torch.models import load
    from aihab_clip_tpu_torch.train import peft

    rng = np.random.default_rng(0)
    n = 28
    ds = ImageArrayDataset(
        images=rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
        labels=rng.integers(0, 20, n), l2_labels=np.zeros(n, np.int64),
        poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
        poly_word_labels=[""] * n, file_names=[f"{i}" for i in range(n)],
        plot_idx=list(range(n)), image_sources=["s"] * n)
    model = load("random:Tiny", device="cpu").model
    cfg = peft.PEFTConfig(resolution=32, num_classes=20, lr=1e-3, epochs=2,
                          crop_mode="center")
    out = peft.finetune(model, SplitView(ds, np.arange(n), 4), None, None,
                        cfg, text_weights=torch.zeros(32, 20), device="cpu",
                        verbose=False, profile_dir=str(tmp_path / "prof"))
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert sum(e.get("name") == "train_step"
               and e.get("cat") == "user_annotation" for e in events) == 5
    thr = out["report"]["first_epoch_throughput"]
    assert thr["steps"] == 14 and thr["items_per_sec"] > 0


class _FakeWandb(types.ModuleType):
    """A stand-in ``wandb`` recording what the logger sends."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []
        outer = self

        class Run:
            def log(self, payload):
                outer.calls.append(("log", sorted(payload)))

            def finish(self):
                outer.calls.append(("finish",))

        self._run = Run

        class Table:
            def __init__(self, **kw):
                self.kw = kw

        class Image:
            def __init__(self, fig):
                self.fig = fig

        self.Table, self.Image = Table, Image

    def init(self, project=None, name=None, config=None):
        self.calls.append(("init", project, name, sorted(config)))
        return self._run()


def test_logger_wandb_mode_and_fallback(tmp_path, monkeypatch, capsys):
    """'wandb' without the package falls back to the stdout logger, as
    JAX's does, with no error; with it (a stand-in module), both packages
    send W&B the same calls: init, the scalars, the tables, the two
    heatmaps, finish."""
    monkeypatch.setitem(sys.modules, "wandb", None)   # not importable
    log = logging.RunLogger("p", "r", mode="wandb",
                            run_dir=str(tmp_path / "w"), config={"a": 1})
    log.log({"x": 1})
    assert (tmp_path / "w" / "log.jsonl").read_text().strip() == '{"x": 1}'
    ref = jax_logging.RunLogger("p", "r", mode="wandb",
                                run_dir=str(tmp_path / "j"), config={"a": 1})
    ref.log({"x": 1})
    assert (tmp_path / "j" / "log.jsonl").read_text() == \
        (tmp_path / "w" / "log.jsonl").read_text()

    calls = {}
    for name, mod in (("port", logging), ("jax", jax_logging)):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        monkeypatch.setattr(jax_logging, "wandb", fake)
        monkeypatch.setattr(jax_logging, "_HAS_WANDB", True)
        lg = mod.RunLogger("proj", "run", mode="auto", config={"a": 1},
                           run_dir=str(tmp_path / name))
        lg.log({"acc": 0.5})
        lg.log_confusion_matrix(np.array([[1, 2], [0, 3]]), ["u", "v"])
        lg.finish()
        calls[name] = fake.calls
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ("init", "proj", "run", ["a"])
    assert ("log", ["Confusion Matrix"]) in calls["port"]
    assert not (tmp_path / "port").exists()


def test_confusion_matrix_heatmaps_and_their_skip(tmp_path, monkeypatch,
                                                  capsys):
    cm = np.array([[3, 1], [0, 2]])
    lg = logging.RunLogger("p", "r", mode="stdout", run_dir=str(tmp_path / "h"))
    lg.log_confusion_matrix(cm, ["u", "v"])
    assert (tmp_path / "h" / "confusion_matrix.csv").read_text() == \
        "true_label,u,v\nu,3,1\nv,0,2\n"
    for png in ("confusion_matrix.png", "confusion_matrix_norm.png"):
        assert (tmp_path / "h" / png).read_bytes()[:4] == b"\x89PNG"
    monkeypatch.setitem(sys.modules, "seaborn", None)
    capsys.readouterr()
    lg2 = logging.RunLogger("p", "r", mode="stdout",
                            run_dir=str(tmp_path / "s"))
    lg2.log_confusion_matrix(cm, ["u", "v"])
    ref = jax_logging.RunLogger("p", "r", mode="stdout",
                                run_dir=str(tmp_path / "js"))
    monkeypatch.setitem(sys.modules, "pandas", sys.modules.get("pandas"))
    ref.log_confusion_matrix(cm, ["u", "v"])
    out = capsys.readouterr().out
    skips = [line for line in out.splitlines() if "cm plot skipped" in line]
    assert len(skips) == 2 and skips[0] == skips[1]
    assert (tmp_path / "s" / "confusion_matrix.csv").is_file()
    assert not (tmp_path / "s" / "confusion_matrix.png").exists()
