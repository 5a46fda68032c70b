"""The package's entry point (the counterpart of ``main.py``):

    python -m aihab_clip_tpu_torch --base_config configs/base.yaml \\
        --dataset_config configs/cs.yaml [--device cuda|cpu] \\
        [--inspect_only] [--logger auto|wandb|stdout|off] [--opts KEY VALUE ...]

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs on the CPU.  ``--opts`` takes the rest of the command line, so
it comes last.

Over N ranks (``parallel.enabled`` auto takes a mesh of them)::

    python -m torch.distributed.run --nproc_per_node N \
        -m aihab_clip_tpu_torch ...

the process group is initialised from the launcher's environment (NCCL on
the card, one card a rank; gloo with ``--device cpu``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .backend import resolve_device
from .config import load_configs
from .parallel.distributed import (initialize_distributed, local_device,
                                   shutdown_distributed)
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
    device = local_device(resolve_device(args.device))
    initialize_distributed(device=device)
    root = Path(__file__).resolve().parent.parent
    cfg = load_configs(args.base_config, args.dataset_config, args.opts,
                       anchors=(root,))
    try:
        return run(cfg, inspect_only=args.inspect_only,
                   config_file=Path(args.dataset_config).stem,
                   logger_mode=args.logger, device=device)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
