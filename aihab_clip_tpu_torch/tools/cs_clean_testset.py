#!/usr/bin/env python
"""Test-set cleaning CLI: score / select / materialize subcommands over a
cached embedding split (counterpart of
``aihab_clip_tpu/tools/cs_clean_testset.py``).  Scoring runs on the card
(``--device cuda``, the default; it raises without one) unless
``--device cpu`` is given.

Examples:
    python -m aihab_clip_tpu_torch.tools.cs_clean_testset score \\
        --cache_dir feat_cache_vis/ViTB16_cs/test/seed1 --scorer multi \\
        --out scores.csv
    python -m aihab_clip_tpu_torch.tools.cs_clean_testset select \\
        --scores scores.csv --mode bottom_pct --pct 0.05 --out selected.csv
    python -m aihab_clip_tpu_torch.tools.cs_clean_testset materialize \\
        --selected selected.csv --src_dir data/CS_test \\
        --dst_dir data/CS_test_clean --index_file index.csv
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..backend import resolve_device
from .table import Table


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    s = sub.add_parser("score", parents=[common],
                       help="score a cached embedding split")
    s.add_argument("--cache_dir", required=True)
    s.add_argument("--scorer", choices=["single", "multi"], default="single")
    s.add_argument("--k_mode", choices=["heuristic", "fixed"],
                   default="heuristic")
    s.add_argument("--k_fixed", type=int, default=2)
    s.add_argument("--k_max", type=int, default=4)
    s.add_argument("--out", type=str, default=None, help="output CSV path")

    se = sub.add_parser("select", parents=[common],
                        help="select outlier rows from scores")
    se.add_argument("--scores", required=True)
    se.add_argument("--mode", choices=["bottom_pct", "threshold", "margin"],
                    default="bottom_pct")
    se.add_argument("--pct", type=float, default=0.05)
    se.add_argument("--threshold", type=float, default=None)
    se.add_argument("--margin_threshold", type=float, default=None)
    se.add_argument("--out", type=str, required=True)

    m = sub.add_parser("materialize", parents=[common],
                       help="write a cleaned dataset folder")
    m.add_argument("--selected", required=True)
    m.add_argument("--src_dir", required=True)
    m.add_argument("--dst_dir", required=True)
    m.add_argument("--index_file", required=True)
    m.add_argument("--link", action="store_true",
                   help="symlink instead of copy")
    return p


def _run_score(args, device) -> Table:
    from ..cache import load_embedding_cache
    from .outlier_cleaning import MultiPrototypeScorer, SingleCentroidScorer

    cache = load_embedding_cache(args.cache_dir)
    if args.scorer == "single":
        scorer = SingleCentroidScorer(cache["embeddings"], cache["labels"],
                                      cache["metadata"], device=device)
        scores = scorer.score_centroid_distance()
        sim_col = "sim_to_centroid"
    else:
        scorer = MultiPrototypeScorer(cache["embeddings"], cache["labels"],
                                      cache["metadata"], device=device)
        scorer.compute_prototypes(k_mode=args.k_mode, k_fixed=args.k_fixed,
                                  k_max=args.k_max)
        scores = scorer.score_prototype_distance()
        sim_col = "sim_to_prototype"

    print(f"[score] {len(scores)} rows; "
          f"mean {sim_col}={scores[sim_col].mean():.4f}; "
          f"bottom-5% flagged={int(scores['is_bottom_5pct'].sum())}")
    print("[score] per-class outlier score (mean/max):")
    for label, idx in scores.groups("ground_truth_num_label"):
        grp = scores["outlier_score"][idx]
        print(f"  class {label}: {grp.mean():.4f} / {grp.max():.4f}")
    if args.out:
        scores.to_csv(args.out)
        print(f"[score] -> {args.out}")
    return scores


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if args.command == "score":
        return _run_score(args, device)
    if args.command == "select":
        from .outlier_cleaning import select_outliers

        scores = Table.read_csv(args.scores)
        selected = select_outliers(scores, mode=args.mode, pct=args.pct,
                                   threshold=args.threshold,
                                   margin_threshold=args.margin_threshold)
        selected.to_csv(args.out)
        print(f"[select] {len(selected)} / {len(scores)} rows -> {args.out}")
        return selected
    from .outlier_cleaning import materialize_clean_split

    selected = Table.read_csv(args.selected)
    stats = materialize_clean_split(selected, Path(args.src_dir),
                                    Path(args.dst_dir), args.index_file,
                                    copy=not args.link)
    print(f"[materialize] kept={stats['kept']} dropped={stats['dropped']} "
          f"-> {args.dst_dir}")
    return stats


if __name__ == "__main__":
    main()
