"""The harness, driven past its look for a card at a tiny size on the CPU
with the timed path broken underneath, reports ``correct`` false: for each
fault its cells can have (an answer altered where it is produced; a train
step that leaves the state unchanged; half of the batch left out, the mean
over the rest).  One card, so no exchange between cards to leave out."""

import json
import time

import pytest

from benchmark import harness

SEED = 2 ** 31 + 999


def run(cell, seconds, **options):
    return harness.run_cell(cell, SEED, seconds, False, "cpu",
                            time.perf_counter(), options)


@pytest.mark.parametrize("family", ["siglip", "clip_vit"])
def test_altered_answer_fails_classify(tiny_cell, family):
    cell = tiny_cell("so400m-classify-b64", family,
                     {"batch": 4, "pool_batches": 3, "check_rows": 12,
                      "warmup_batches": 1},
                     {"logit_gap": 1e-3, "logit_rms": 1e-3})
    assert run(cell, 0.5)["correct"]
    res = run(cell, 0.5, fault="answer")
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > 1.0


def test_altered_answer_fails_serve(tiny_cell):
    traffic = dict(json.loads((harness.BENCH / "traffic" / "serve_open.json")
                              .read_text()),
                   batch=8, rate_per_s=100, pool_images=16, check_rows=32)
    cell = tiny_cell("so400m-classify-b64", "siglip", traffic,
                     {"logit_gap": 1e-3, "logit_rms": 1e-3})
    res = run(cell, 1.0, fault="answer")
    assert not res["correct"]


@pytest.mark.parametrize("fault,number", [("frozen", "change_gap_median"),
                                          ("half_batch", "grad_diff_median")])
def test_broken_step_fails_peft(tiny_cell, fault, number):
    traffic = dict(json.loads((harness.BENCH / "traffic"
                               / "peft_step_b16.json").read_text()),
                   batch=4, image_size=40, pool_batches=4, unlocked_groups=2)
    cell = tiny_cell("so400m-classify-b64", "siglip", traffic,
                     {"grad_diff_median": 1e-3, "change_gap_median": 1e-3})
    res = run(cell, 0.3, fault=fault)
    assert not res["correct"]
    assert res["checks"][number]["value"] > 1e-1
    if fault == "frozen":
        assert res["checks"][number]["value"] == pytest.approx(1.0)


def test_judge_compares_the_numbers_the_limits_name():
    ok, checks, readings = harness.judge({"a": 0.5, "b": 9.0},
                                         {"a": {"limit": 1.0}})
    assert ok and checks == {"a": {"value": 0.5, "limit": 1.0}}
    assert readings == {"b": 9.0}
    assert not harness.judge({"a": 0.0}, {})[0]          # nothing compared
    assert not harness.judge({}, {"a": {"limit": 1.0}})[0]   # none read
    assert not harness.judge({"a": float("inf")}, {"a": {"limit": 1.0}})[0]
    assert not harness.judge({"a": 1.5}, {"a": {"limit": 1.0}})[0]


@pytest.mark.parametrize("family", ["siglip", "clip_vit"])
def test_float8_control_fails_classify(tiny_cell, family):
    """The control, the reference in float8 in the program's place, reads
    far above the program at a tiny size too."""
    cell = tiny_cell("so400m-classify-b64", family,
                     {"batch": 4, "pool_batches": 3, "check_rows": 12,
                      "warmup_batches": 1},
                     {"logit_gap": 1e-3, "logit_rms": 1e-3})
    sound = run(cell, 0.3)
    control = run(cell, 0.3, control="fp8")
    assert sound["correct"] and not control["correct"]
    for key in ("logit_gap", "logit_rms"):
        assert (control["checks"][key]["value"]
                > 30 * sound["checks"][key]["value"])


@pytest.mark.parametrize("family", ["siglip", "clip_vit"])
def test_int8_control_fails_classify(tiny_cell, family):
    """The port's own int8 engine, the path below the bfloat16 the
    configurations serve in, reads far above the program at a tiny size,
    in the image's own part of the gap too."""
    cell = tiny_cell("so400m-classify-b64", family,
                     {"batch": 4, "pool_batches": 3, "check_rows": 12,
                      "warmup_batches": 1},
                     {"image_gap": 1e-3, "image_rms": 1e-3})
    sound = run(cell, 0.3)
    control = run(cell, 0.3, control="int8")
    assert sound["correct"] and not control["correct"]
    for key in ("image_gap", "image_rms"):
        assert control["checks"][key]["value"] > 1e-2


def test_float8_control_fails_peft(tiny_cell):
    traffic = dict(json.loads((harness.BENCH / "traffic"
                               / "peft_step_b16.json").read_text()),
                   batch=4, image_size=40, pool_batches=4, unlocked_groups=2)
    cell = tiny_cell("so400m-classify-b64", "siglip", traffic,
                     {"grad_diff_median": 1e-3, "change_gap_median": 1e-3})
    res = run(cell, 0.3, control="fp8")
    assert not res["correct"]
    assert res["checks"]["grad_diff_median"]["value"] > 1e-2
