"""On the card: the controls come out not correct in every cell at the
cell's own size, and the program itself comes out correct on the same
seed.  The controls are the reference computed in float8 put in the
program's place, and in the classify cells the port's own int8 engine.
The fine-tune's int8 frozen prefix reads within the program's own spread
on every number compared (PERF.md), so it is no control there.  Run with ``python -m pytest benchmark/tests
-m gpu`` on a machine with a card."""

import json
import subprocess
import sys

import pytest

from benchmark import harness

SEED = 2 ** 31 + 2 ** 29 + 17


def _run(workload, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0", *extra],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _controls():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        kind = harness.cell_of(spec, w["name"])["traffic"]["kind"]
        for control in ("int8", "fp8"):
            if control == "int8" and kind == "peft_step":
                continue
            yield w["name"], control


@pytest.mark.gpu
@pytest.mark.parametrize("workload,control", list(_controls()))
def test_control_is_not_correct(workload, control):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sound = _run(workload)
    lowered = _run(workload, "--control", control)
    assert sound["correct"], sound["checks"]
    assert not lowered["correct"], lowered["checks"]
