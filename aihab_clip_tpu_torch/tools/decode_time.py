"""Two stages of the fast JPEG decode timed on one photo, in this checkout
and optionally in another: the host Huffman stage (``csrc/jpeg_entropy.cpp``
through ``ops/jpeg.entropy_decode``) and, where a card is, J1
(``ops/jpeg.jpeg_idct``) at full scale and at m = 2.

    python -m aihab_clip_tpu_torch.tools.decode_time [--parent DIR] [--reps 2]

The photo is ``chip_smoke.py``'s 4000 x 3000 one (``photo``: 16 px patches
of colour plus noise, seed 0) written once by this checkout's encoder
(4:2:0, quality 95); each measurement runs in a fresh process whose working
directory and import path are one checkout (``DIR``, e.g. a ``git archive``
of the parent commit unpacked, or this one), so each builds its own
libraries and decodes the same bytes.  The order is parent, change, change,
parent (``--reps`` rounds), or this checkout alone without ``--parent``.
Each process reports the median of ``TIMED`` Huffman decodes after one
warm-up (the plan made once, at full scale; ``entropy_ms``) and the median
of ``J1_TIMED`` J1 launches after one, by CUDA events (``j1_ms``); this
checkout also times the photo's progressive re-code
(``tools/jpeg_fixtures.py``).  Prints one JSON line per run and, with
``--parent``, a summary line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

SIZE, SEED, TIMED, J1_TIMED = (3000, 4000), 0, 7, 50


def entropy_ms(blob: bytes, timed: int) -> float:
    """The C++ entropy decode (Huffman or arithmetic coding) of one photo
    at full scale (``entropy_decode`` alone, the plan made once): the
    median ms of ``timed`` decodes after one warm-up.  Runs in whichever checkout it is imported from (``run``
    passes its source to each one)."""
    import statistics
    import time

    import torch

    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.ops import jpeg as J

    plan = J.plan_batch([D.parse_jpeg(blob)], [8], 224)
    coef = torch.empty(plan.coef_total, dtype=torch.int16)
    times = []
    for _ in range(timed + 1):
        t0 = time.perf_counter()
        if int(J.entropy_decode(plan, [blob], coef)[0]) != 0:
            raise RuntimeError("the C++ entropy decode failed")
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:])


def j1_ms(blob: bytes, m: int, timed: int):
    """J1 on one photo's coefficients at scale m/8 on the card: the median
    ms (CUDA events) of ``timed`` launches after one warm-up; None without
    a card.  Runs in whichever checkout it is imported from."""
    import statistics

    import torch

    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.ops import jpeg as J

    if not torch.cuda.is_available():
        return None
    plan = J.plan_batch([D.parse_jpeg(blob)], [m], 224)
    coef = torch.empty(plan.coef_total, dtype=torch.int16)
    if int(J.entropy_decode(plan, [blob], coef)[0]) != 0:
        raise RuntimeError("the C++ entropy decode failed")
    dev = torch.device("cuda")
    args = [coef.to(dev)] + [torch.from_numpy(a).to(dev)
                             for a in (plan.qtables, plan.segs)]
    planes = torch.empty(plan.plane_total, dtype=torch.uint8, device=dev)
    times = []
    for _ in range(timed + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        J.jpeg_idct(*args, planes)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


# one checkout's measurement, after the sources of entropy_ms and j1_ms
_RUN = r"""
import json, subprocess, sys

timed, j1_timed = int(sys.argv[1]), int(sys.argv[2])
blobs = [open(p, "rb").read() for p in sys.argv[3:]]
out = {"baseline_ms": entropy_ms(blobs[0], timed)}
for m in (8, 2):
    out[f"j1_m{m}_ms"] = j1_ms(blobs[0], m, j1_timed)
if len(blobs) > 1:
    out["progressive_ms"] = entropy_ms(blobs[1], timed)
try:
    out["card"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
except FileNotFoundError:         # a host without the card's tools
    out["card"] = None
print(json.dumps(out), flush=True)
"""


def photo(h: int = SIZE[0], w: int = SIZE[1], seed: int = SEED):
    """A seeded RGB photo [h, w, 3] uint8, 16 px patches of colour plus
    noise: ``chip_smoke.py``'s photos (by default its 12 MP one)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    coarse = rng.normal(128, 60, (-(-h // 16), -(-w // 16), 3))
    return np.clip(np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
                   + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)


def run(tree: Path, files) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    script = inspect.getsource(entropy_ms) + inspect.getsource(j1_ms) + _RUN
    proc = subprocess.run([sys.executable, "-c", script, str(TIMED),
                           str(J1_TIMED), *map(str, files)], cwd=tree,
                          env=env, capture_output=True, text=True,
                          check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    here = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(here))
    from aihab_clip_tpu_torch.data.encode import encode_jpeg
    from aihab_clip_tpu_torch.tools.jpeg_fixtures import progressive_recode

    with tempfile.TemporaryDirectory() as tmp:
        base, prog = Path(tmp, "base.jpg"), Path(tmp, "prog.jpg")
        base.write_bytes(encode_jpeg(photo()))
        prog.write_bytes(progressive_recode(base.read_bytes()))
        order = ([("change", here)] if args.parent is None else
                 [("parent", args.parent), ("change", here),
                  ("change", here), ("parent", args.parent)] * args.reps)
        runs = []
        for label, tree in order:
            files = [base] if label == "parent" else [base, prog]
            out = dict(run(tree, files), tree=label)
            print(json.dumps(out), flush=True)
            runs.append(out)
    if args.parent is not None:
        summary = {}
        for key in ("baseline_ms", "j1_m8_ms", "j1_m2_ms"):
            if runs[0][key] is None:
                continue
            got = {t: sorted(r[key] for r in runs if r["tree"] == t)
                   for t in ("parent", "change")}
            summary[key] = dict(got, change_over_parent=(
                statistics.median(got["change"])
                / statistics.median(got["parent"])))
        summary["progressive_ms"] = sorted(r["progressive_ms"] for r in runs
                                           if "progressive_ms" in r)
        print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
