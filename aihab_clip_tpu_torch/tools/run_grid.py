#!/usr/bin/env python
"""Local (W&B-free) sweep runner: expands a W&B-style sweep YAML into the
full parameter grid and runs each combination through the pipeline
(counterpart of ``aihab_clip_tpu/tools/run_grid.py``), on the card
(``--device cuda``, the default; it raises without one) or the CPU.

Reads the repo's ``sweeps/*.yaml`` unchanged (the port's own YAML reader),
with no service dependency:

    python -m aihab_clip_tpu_torch.tools.run_grid \\
        --sweep sweeps/openclip_ft.yaml [--base_config ...] \\
        [--dataset_config ...] [--limit N] [--dry_run] \\
        [--out grid_results.csv] [--device cuda|cpu]

Results (run name, overrides, top1/top3/f1/mcc or acc) accumulate into a
CSV sorted by the sweep's metric after every run, written as
``DataFrame(rows).to_csv(index=False)`` writes it.
"""

from __future__ import annotations

import argparse
import itertools
from pathlib import Path
from typing import Dict, List


def expand_grid(sweep: Dict) -> List[Dict[str, object]]:
    """Expand `parameters: {key: {values: [...]}}` into the cross product."""
    params = sweep.get("parameters", {})
    keys, value_lists = [], []
    for key, spec in params.items():
        if "values" in spec:
            keys.append(key)
            value_lists.append(list(spec["values"]))
        elif "value" in spec:
            keys.append(key)
            value_lists.append([spec["value"]])
        else:
            raise ValueError(
                f"Only grid sweeps are supported locally; parameter '{key}' "
                f"has no 'values'/'value' entry")
    return [dict(zip(keys, combo))
            for combo in itertools.product(*value_lists)]


def result_metrics(result: Dict) -> Dict[str, float]:
    """The row's metrics from ``runner.run``'s result, as JAX takes them."""
    if "peft" in result and result["peft"].get("test"):
        t = result["peft"]["test"]
        return dict(top1_acc=t["top1"], top3_acc=t["top3"], f1=t["f1"],
                    mcc=t["mcc"], loss=t["loss"])
    if "prolip" in result:
        return dict(acc=result["prolip"]["acc"],
                    loss=result["prolip"]["loss"])
    return {}


def sorted_rows(rows: List[Dict], metric: str, goal: str):
    """The rows as a table, stably sorted by ``metric`` (missing last) when
    some row has it."""
    from .table import Table

    table = Table.from_rows(rows)
    if metric in table:
        table = table.sort_values([metric], [goal != "maximize"])
    return table


def run_grid(sweep_path: str, base_config: str, dataset_config: str,
             limit: int = 0, dry_run: bool = False,
             out_csv: str = "grid_results.csv", device="cuda") -> List[Dict]:
    from ..backend import resolve_device
    from ..config import load_configs, safe_load, set_by_dotted_path
    from ..runner import run
    from .run_ft_sweep import sweep_run_name

    dev = resolve_device(device)
    sweep = safe_load(Path(sweep_path).read_text(), name=str(sweep_path))
    metric = sweep.get("metric", {}).get("name", "top1_acc")
    goal = sweep.get("metric", {}).get("goal", "maximize")
    combos = expand_grid(sweep)
    if limit:
        combos = combos[:limit]
    print(f"[grid] {len(combos)} combinations from {sweep_path} "
          f"({goal} {metric})")

    rows: List[Dict] = []
    for i, combo in enumerate(combos):
        cfg = load_configs(base_config, dataset_config,
                           anchors=(Path.cwd(),))
        for key, value in combo.items():
            set_by_dotted_path(cfg, key, value)
        cfg["wandb_project"] = None  # offline
        name = sweep_run_name(cfg)
        print(f"[grid {i + 1}/{len(combos)}] {name}  {combo}")
        if dry_run:
            rows.append({"run": name, **combo})
            continue

        result = run(cfg, inspect_only=False, logger_mode="off", device=dev)
        rows.append({"run": name, **combo, **result_metrics(result)})
        sorted_rows(rows, metric, goal).to_csv(out_csv)

    print(f"[grid] results -> {out_csv}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sweep", required=True)
    p.add_argument("--base_config", default="configs/base.yaml")
    p.add_argument("--dataset_config", default="configs/cs.yaml")
    p.add_argument("--limit", type=int, default=0,
                   help="run only the first N combinations")
    p.add_argument("--dry_run", action="store_true",
                   help="print the expanded grid without running")
    p.add_argument("--out", default="grid_results.csv")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    return run_grid(args.sweep, args.base_config, args.dataset_config,
                    limit=args.limit, dry_run=args.dry_run, out_csv=args.out,
                    device=args.device)


if __name__ == "__main__":
    main()
