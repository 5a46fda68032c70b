"""Compare the machine code of one CUDA source between two checkouts.

    python -m aihab_clip_tpu_torch.tools.sass_diff --parent DIR \
        [--source block_kernels] [--match flash_attention_kernel]

``DIR`` is another checkout of the repository (for example ``git archive``
of the parent commit, unpacked).  Both checkouts' ``csrc/<source>.cu``
compile with the flags of ``ops/_build.py`` into cubins under this
checkout's ``build/sass_diff/``; ``cuobjdump -sass`` lists each kernel's
SASS, demangled by ``c++filt`` (a kernel in an anonymous namespace has a
mangled name of its own in each compilation), and every kernel whose name
holds ``--match`` (all kernels when it is empty) is reported as the same
(every instruction and its encoding, scheduling bits included), differing
(with both instruction counts), or in one checkout only.  Prints one JSON
line per kernel and a summary line; exits 1 if a kernel present in both
differs.  Needs ``nvcc`` and ``cuobjdump``, not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from ..ops import _build

_FUNCTION = re.compile(r"^\s*Function : (.+?)\s*$", re.M)
# an instruction: /*0040*/  <instruction> ;  /* 0x<encoding> */
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?;)")


def _nvcc_flags():
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC", "-Xptxas",
                                                       "-v")]
    return flags + ["-cubin"]


def sass(tree: Path, source: str, out_dir: Path) -> dict:
    """{demangled kernel name: its SASS listing} of ``tree``'s source;
    symbols inside the instructions are demangled too."""
    csrc = tree / "aihab_clip_tpu_torch" / "csrc"
    cubin = out_dir / f"{source}.cubin"
    subprocess.run([_build._nvcc(), *_nvcc_flags(), "-I", str(csrc),
                    str(csrc / f"{source}.cu"), "-o", str(cubin)],
                   check=True, capture_output=True, text=True)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    text = subprocess.run(["c++filt"], input=text, check=True,
                          capture_output=True, text=True).stdout
    heads = list(_FUNCTION.finditer(text))
    kernels = {}
    for i, m in enumerate(heads):
        end = heads[i + 1].start() if i + 1 < len(heads) else len(text)
        kernels[m.group(1)] = text[m.end():end]
    return kernels


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--source", default="block_kernels")
    ap.add_argument("--match", default="")
    args = ap.parse_args()
    change = Path(__file__).resolve().parents[2]
    root = change / "build" / "sass_diff"
    got = {}
    for label, tree in (("parent", args.parent.resolve()), ("change", change)):
        (root / label).mkdir(parents=True, exist_ok=True)
        got[label] = sass(tree, args.source, root / label)
    names = sorted(set(got["parent"]) | set(got["change"]))
    counts = {"same": 0, "differs": 0, "parent only": 0, "change only": 0}
    for name in names:
        if args.match not in name:
            continue
        p, c = got["parent"].get(name), got["change"].get(name)
        verdict = ("change only" if p is None else "parent only" if c is None
                   else "same" if p == c else "differs")
        counts[verdict] += 1
        print(json.dumps({"kernel": name, "verdict": verdict,
                          "parent_insns": None if p is None
                          else len(_INSN.findall(p)),
                          "change_insns": None if c is None
                          else len(_INSN.findall(c))}))
    print(json.dumps({"source": args.source, "match": args.match, **counts}))
    sys.exit(1 if counts["differs"] else 0)


if __name__ == "__main__":
    main()
