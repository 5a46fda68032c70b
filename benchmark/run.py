"""The benchmark of ``aihab_clip_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  Prints one JSON line last on standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``; ``checks`` last: each compared number
beside its limit) and the same checks as the last lines of standard error.
Exits non-zero, printing no result, without a card (or with fewer cards
than the cell asks for), when the port is missing, and when ``jax``,
``jaxlib``, ``flax`` or the JAX package was loaded.

``--control fp8`` puts the reference computed in float8 in the program's
place (the control the limits are set against), ``--control int8`` runs
the port's own int8 path, ``--fault <name>`` plants a fault (``answer``,
``frozen``, ``half_batch``), ``--rate`` sets an open loop's rate and
``--look`` adds to a fine-tune run's readings what its first step moved
and the reference with every parameter read in bfloat16 (``PERF.md``).
The driver uses none of them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("int8", "fp8"), default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--look", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    harness.set_cache_dirs()
    harness.few_threads()
    import torch

    torch.set_num_threads(1)

    spec = harness.load_spec()
    cell = harness.cell_of(spec, args.workload)
    chips = int(cell["workload"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card for {args.workload} (needs {chips})",
              file=sys.stderr)
        return 3
    options = {k: v for k, v in (("control", args.control),
                                 ("fault", args.fault), ("rate", args.rate),
                                 ("look", args.look or None))
               if v is not None}
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T0, options)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(harness.strict_json(result), allow_nan=False),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
