"""A/B of the block kernels' attention between two checkouts, on one card.

    python -m aihab_clip_tpu_torch.tools.ab_attention --parent DIR [--reps 2]

``DIR`` is another checkout of the repository (for example ``git archive``
of the parent commit, unpacked).  Each measurement runs in a fresh process
whose working directory and import path are one checkout, so each builds
and times its own kernels.  The order is parent, change, change, parent
(``--reps`` rounds of it).  Timed: ``ops.block_kernel.attention`` at the
ViT-B/16 serving shape (B=64, S=197, 12 heads of 64, packed q | k | v) and
at the SigLIP SO400M shape (B=64, S=576, 16 heads of 72, 8 groups of 2,
q pre-scaled), CUDA events over 50 launches after warm-up.  Prints one JSON
line per run and a summary line with the change's time relative to the
parent's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_TIMING = r"""
import json, torch
from aihab_clip_tpu_torch.ops import block_kernel as bk
g = torch.Generator().manual_seed(0)
out = {}
for name, (b, s, heads, d, groups, q_scaled) in {
        "attention[hd64, ViT-B/16]": (64, 197, 12, 64, None, False),
        "attention[hd72, grouped, SO400M]": (64, 576, 16, 72, 2, True)}.items():
    qkv = torch.randn(b, s, 3 * heads * d, generator=g).to("cuda", torch.bfloat16)
    fn = lambda: bk.attention(qkv, heads, group_heads=groups, q_scaled=q_scaled)
    for _ in range(5):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(50):
        fn()
    e1.record()
    torch.cuda.synchronize()
    out[name] = e0.elapsed_time(e1) / 50
print(json.dumps(out))
"""


def _run(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", _TIMING], cwd=tree, env=env,
                          capture_output=True, text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    change = Path(__file__).resolve().parents[2]
    runs = {"parent": [], "change": []}
    for _ in range(args.reps):
        for label, tree in (("parent", args.parent), ("change", change),
                            ("change", change), ("parent", args.parent)):
            row = _run(tree.resolve())
            runs[label].append(row)
            print(json.dumps({"tree": label, **row}), flush=True)
    summary = {}
    for name in runs["parent"][0]:
        p = sum(r[name] for r in runs["parent"]) / len(runs["parent"])
        c = sum(r[name] for r in runs["change"]) / len(runs["change"])
        summary[name] = dict(parent_ms=p, change_ms=c, change_over_parent=c / p)
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
