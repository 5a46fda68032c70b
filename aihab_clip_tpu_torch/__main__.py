"""The package's entry point (the counterpart of ``main.py``):

    python -m aihab_clip_tpu_torch --base_config configs/base.yaml \\
        --dataset_config configs/cs.yaml [--device cuda|cpu] \\
        [--inspect_only] [--logger auto|wandb|stdout|off] [--opts KEY VALUE ...]

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs on the CPU.  ``--opts`` takes the rest of the command line, so
it comes last.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .backend import resolve_device
from .config import load_configs
from .runner import run


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m aihab_clip_tpu_torch")
    p.add_argument("--base_config", type=str, default="configs/base.yaml")
    p.add_argument("--dataset_config", type=str, default="configs/cs.yaml")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    p.add_argument("--inspect_only", action="store_true",
                   help="Run data/transform inspection only")
    p.add_argument("--logger", type=str, default="auto",
                   choices=["auto", "wandb", "stdout", "off"])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    root = Path(__file__).resolve().parent.parent
    cfg = load_configs(args.base_config, args.dataset_config, args.opts,
                       anchors=(root,))
    return run(cfg, inspect_only=args.inspect_only,
               config_file=Path(args.dataset_config).stem,
               logger_mode=args.logger, device=device)


if __name__ == "__main__":
    main()
