#!/usr/bin/env python
"""Batch inference CLI: classify a folder of habitat photos -> CSV
(counterpart of ``aihab_clip_tpu/tools/predict.py``).

Loads a model (zoo name, checkpoint path, or random for a smoke run), builds
the CS prompt-ensemble text head, decodes the folder a batch at a time at
full scale (JPEGs through the fast decode, one call a batch) and classifies
each padded batch while the next one decodes (lag-1), then writes per-image
top-k predictions with probabilities.  The CSV is written with the stdlib
``csv`` module and has the bytes of JAX's ``DataFrame.to_csv`` on the same
rows.

Usage:
    python -m aihab_clip_tpu_torch.tools.predict --images <folder> \\
        [--model ViT-B/16] [--out predictions.csv] [--batch_size 64] \\
        [--topk 3] [--flat] [--resolution 224] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from pathlib import Path

import numpy as np


def write_csv(path, rows) -> None:
    """``rows`` (dicts with one key order) as pandas' ``to_csv(index=False)``
    writes them: a header, minimal quoting, '\\n' line ends, floats by
    their shortest repr."""
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(rows[0]))
        for row in rows:
            w.writerow([repr(v) if isinstance(v, float) else v
                        for v in row.values()])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True, help="folder of images")
    p.add_argument("--model", default="ViT-B/16",
                   help="zoo name | checkpoint path | hf-hub:<repo> (a "
                        "local HF snapshot) | random:<ARCH>")
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--topk", type=int, default=3)
    p.add_argument("--resolution", type=int, default=0,
                   help="0 = model native")
    p.add_argument("--flat", action="store_true",
                   help="flat prompts (default: hierarchical descriptive)")
    p.add_argument("--lora", default=None, metavar="ADAPTERS_NPZ",
                   help="a lora_adapters.npz (of either package) merged "
                        "into the weights before serving")
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--quantize", default="none", choices=["none", "int8"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from ..serving import ClassifierEngine

    try:
        engine = ClassifierEngine(
            model=args.model, batch_size=args.batch_size,
            resolution=args.resolution, flat=args.flat, lora=args.lora,
            lora_alpha=args.lora_alpha, quantize=args.quantize,
            device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))

    folder = Path(args.images)
    files = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    if not files:
        raise SystemExit(f"no images found in {folder}")
    print(f"[predict] {len(files)} images, model {args.model} "
          f"({engine.bundle.source}), resolution {engine.resolution}, "
          f"{engine.device}")

    bs = args.batch_size
    rows = []
    t0 = time.perf_counter()

    def emit(kept, probs_dev):
        probs = probs_dev.cpu().numpy()[:len(kept)]
        tk = engine.topk(probs, args.topk)
        for i, f in enumerate(kept):
            row = {"file_name": f,
                   "predicted_label": tk[i][0]["label"],
                   "predicted_word_label": tk[i][0]["name"]}
            for j, rec in enumerate(tk[i]):
                row[f"top{j + 1}_label"] = rec["label"]
                row[f"top{j + 1}_name"] = rec["name"]
                row[f"top{j + 1}_prob"] = rec["prob"]
            rows.append(row)

    pending = None  # lag-1: decode batch i+1 while the device classifies i
    for start in range(0, len(files), bs):
        chunk = files[start:start + bs]
        decoded = engine.decode_files([str(folder / f) for f in chunk])
        kept = [f for f, arr in zip(chunk, decoded) if arr is not None]
        if not kept:
            continue
        batch = np.stack([arr for arr in decoded if arr is not None])
        if len(batch) < bs:  # pad to the batch shape
            batch = np.concatenate(
                [batch, np.zeros((bs - len(batch),) + batch.shape[1:],
                                 np.uint8)])
        probs_dev = engine.classify_dispatch(batch)
        if pending is not None:
            emit(*pending)
        pending = (kept, probs_dev)
    if pending is not None:
        emit(*pending)
    dt = time.perf_counter() - t0

    write_csv(args.out, rows)
    print(f"[predict] {len(rows)} predictions in {dt:.1f}s "
          f"({len(rows) / max(dt, 1e-9):.1f} img/s incl. decode) -> {args.out}")
    return rows


if __name__ == "__main__":
    main()
