"""A/B of the block kernels' attention between two checkouts, on one card.

    python -m aihab_clip_tpu_torch.tools.ab_attention --parent DIR [--reps 2]
        [--reverse]

``DIR`` is another checkout of the repository (for example ``git archive``
of the parent commit, unpacked).  Each measurement runs in a fresh process
whose working directory and import path are one checkout, so each builds
and times its own kernels.  The order is parent, change, change, parent
(``--reps`` rounds of it), or with ``--reverse`` change, parent, parent,
change.  Timed: ``ops.block_kernel.attention`` at the
ViT-B/16 serving shape (B=64, S=197, 12 heads of 64, packed q | k | v) and
at the SigLIP SO400M shape (B=64, S=576, 16 heads of 72, 8 groups of 2,
q pre-scaled), and ``ops.attention.fused_attention_fwd`` (K6) at the SO400M
PEFT shape (B=16, S=576, 16 heads of 72), CUDA events over 50 launches after
warm-up; and ``classify_batch`` images/s at batch 64 on the host clock (100
batches of ViT-B/16, 20 of SO400M, after 3) of ``ClassifierEngine(
"random:ViT-B/16")`` and of the SigLIP SO400M engine
(``random:ViT-SO400M-16-SigLIP2-384``), and each engine's encode of one
batch on the device (CUDA events over 50, as the kernels).  Prints one JSON line per
run and a summary line with the change's figure relative to the parent's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_TIMING = r"""
import json, time, numpy as np, torch
from aihab_clip_tpu_torch.ops import attention as att
from aihab_clip_tpu_torch.models.fast_vit import encode_image_fastest
from aihab_clip_tpu_torch.ops import block_kernel as bk
from aihab_clip_tpu_torch.ops.preprocess import eval_transform
from aihab_clip_tpu_torch.serving import ClassifierEngine
g = torch.Generator().manual_seed(0)
out = {}

def rnd(*shape):
    return torch.randn(*shape, generator=g).to("cuda", torch.bfloat16)

def timed(fn):
    for _ in range(5):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(50):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 50

for name, (b, s, heads, d, groups, q_scaled) in {
        "attention[hd64, ViT-B/16]": (64, 197, 12, 64, None, False),
        "attention[hd72, grouped, SO400M]": (64, 576, 16, 72, 2, True)}.items():
    qkv = rnd(b, s, 3 * heads * d)
    out[name] = timed(lambda: bk.attention(qkv, heads, group_heads=groups,
                                           q_scaled=q_scaled))
q, k, v = (rnd(16, 576, 16 * 72) for _ in range(3))
out["fused_attention_fwd[hd72, B=16 S=576]"] = timed(
    lambda: att.fused_attention_fwd(q, k, v, 16))
for name, model, n in (("ViT-B/16", "random:ViT-B/16", 100),
                       ("SigLIP SO400M", "random:ViT-SO400M-16-SigLIP2-384",
                        20)):
    eng = ClassifierEngine(model, batch_size=64, verbose=False)
    cfg, dim = eng.bundle.config, eng.decode_dim
    u8 = np.random.default_rng(64).integers(0, 256, (64, dim, dim, 3),
                                            dtype=np.uint8)
    for _ in range(3):
        eng.classify_batch(u8)
    t0 = time.perf_counter()
    for _ in range(n):
        eng.classify_batch(u8)
    out[f"classify_batch[{name}, batch 64] images/s"] = \
        n * 64 / (time.perf_counter() - t0)
    with torch.inference_mode():
        xb = eval_transform(torch.from_numpy(u8).cuda(),
                            cfg.image_resolution, dtype=torch.bfloat16)
        out[f"encode[{name}, batch 64] ms"] = timed(
            lambda: encode_image_fastest(eng.bundle.model, xb, cfg,
                                         packed=eng._packed))
    del eng
    torch.cuda.empty_cache()
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
    ap.add_argument("--reverse", action="store_true")
    args = ap.parse_args()
    change = Path(__file__).resolve().parents[2]
    runs = {"parent": [], "change": []}
    trees = {"parent": args.parent, "change": change}
    order = ("change", "parent", "parent", "change") if args.reverse else \
        ("parent", "change", "change", "parent")
    for _ in range(args.reps):
        for label in order:
            tree = trees[label]
            row = _run(tree.resolve())
            runs[label].append(row)
            print(json.dumps({"tree": label, **row}), flush=True)
    summary = {}
    for name in runs["parent"][0]:
        p = sum(r[name] for r in runs["parent"]) / len(runs["parent"])
        c = sum(r[name] for r in runs["change"]) / len(runs["change"])
        summary[name] = dict(parent=p, change=c, change_over_parent=c / p)
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
