#!/usr/bin/env python
"""Sweep launcher: accepts arbitrary dotted-key overrides and runs the full
pipeline (counterpart of ``aihab_clip_tpu/tools/run_ft_sweep.py``) on the
card (``--device cuda``, the default; it raises without one) or, with
``--device cpu``, on the CPU.

Works both under a W&B agent (``wandb agent`` passes ``--key=value`` pairs;
the sweep file's ``program`` must name
``aihab_clip_tpu_torch/tools/run_ft_sweep.py``) and standalone:

    python -m aihab_clip_tpu_torch.tools.run_ft_sweep \\
        --base_config configs/base.yaml --dataset_config configs/cs.yaml \\
        --lr_v=1e-4 --finetune.unlocked_groups=5 --seed=3

Unknown args are parsed as dotted-path config overrides (may create new
nested keys, with type coercion against existing leaves).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Tuple

from ..config import ConfigNode, load_configs, set_by_dotted_path


def parse_known(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base_config", type=str, default="configs/base.yaml")
    p.add_argument("--dataset_config", type=str, default="configs/cs.yaml")
    p.add_argument("--inspect_only", action="store_true")
    p.add_argument("--logger", type=str, default="auto",
                   choices=["auto", "wandb", "stdout", "off"])
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p.parse_known_args(argv)


def parse_overrides(unknown: List[str]) -> List[Tuple[str, str]]:
    """Parse ``--key value`` and ``--key=value`` forms into (dotted, raw)."""
    out: List[Tuple[str, str]] = []
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--"):
            raise ValueError(f"Unexpected sweep argument: {tok}")
        tok = tok[2:]
        if "=" in tok:
            key, value = tok.split("=", 1)
            i += 1
        else:
            key = tok
            if i + 1 >= len(unknown):
                raise ValueError(f"Missing value for override --{key}")
            value = unknown[i + 1]
            i += 2
        out.append((key, value))
    return out


def load_cfg_with_overrides(args, overrides) -> ConfigNode:
    here = Path(__file__).resolve().parents[2]
    cfg = load_configs(args.base_config, args.dataset_config,
                       anchors=(Path.cwd(), here))
    for key, value in overrides:
        set_by_dotted_path(cfg, key, value)
    return cfg


def sweep_run_name(cfg) -> str:
    ft = cfg.get("finetune", {})
    return (f"{cfg.get('dataset', 'ds')}"
            f"_s{cfg.get('shots', 0)}"
            f"_seed{cfg.get('seed', 1)}"
            f"_{str(cfg.get('open_clip_model', cfg.get('backbone', 'clip'))).split('/')[-1]}"
            f"_{cfg.get('train_epoch', 0)}ep"
            f"_ug{ft.get('unlocked_groups', 0)}")


def main(argv=None):
    from ..backend import resolve_device
    from ..runner import run

    args, unknown = parse_known(argv)
    device = resolve_device(args.device)
    overrides = parse_overrides(unknown)
    cfg = load_cfg_with_overrides(args, overrides)
    if overrides:
        print("[sweep] overrides:", dict(overrides))
    # sweeps report to a suffixed project, mirroring the reference
    if cfg.get("wandb_project", None):
        cfg["wandb_project"] = f"{cfg['wandb_project']}_sweep"
    name = sweep_run_name(cfg)
    print(f"[sweep] run name: {name}")
    return run(cfg, inspect_only=args.inspect_only,
               config_file=Path(args.dataset_config).stem,
               logger_mode=args.logger, run_name=name, device=device)


if __name__ == "__main__":
    main()
