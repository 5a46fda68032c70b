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
(every instruction and its encoding, scheduling bits included; blanks
collapsed, since cuobjdump pads a listing to its cubin's longest line),
differing (with both instruction counts), or in one checkout only.  A
kernel is named by its name and template arguments (its parameter list,
which a parameter added at the end changes, is compared through the SASS).
A template flag appended to a kernel is matched by itself: a parent kernel
whose name the change lacks is compared with the change's kernel of that
name and one more last template argument, the one reading ``false`` (or
``0``) where there are several (``flash_attention_kernel<64, bf16>`` with
``flash_attention_kernel<64, bf16, false>``).  Prints one JSON line per
kernel and a summary line; exits 1 if a kernel present in both differs.
Needs ``nvcc`` and ``cuobjdump``, not a card.
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


def kernel_key(name: str) -> str:
    """A demangled kernel name without its parameter list (the last
    parenthesised group)."""
    depth, i = 0, len(name)
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            break
    return name[:i] if name.endswith(")") else name


def split_last_arg(key: str):
    """(``key`` without its last template argument, that argument), or
    None where the key has fewer than two template arguments."""
    if not key.endswith(">"):
        return None
    depth = 0
    for i in range(len(key) - 2, -1, -1):
        c = key[i]
        depth += {">": 1, ")": 1, "<": -1, "(": -1}.get(c, 0)
        if depth < 0:  # the list's opening '<': one argument only
            return None
        if c == "," and depth == 0:
            return key[:i] + ">", key[i + 1:-1].strip()
    return None


def match_appended_flags(parent: dict, change: dict):
    """(``change`` with each kernel that appended a template flag keyed by
    the parent kernel it extends (see the module's docstring), {that
    parent key: the change's own key})."""
    grown = {}  # parent key -> [(appended argument, change key)]
    for key in change:
        cut = None if key in parent else split_last_arg(key)
        if cut is not None and cut[0] in parent and cut[0] not in change:
            grown.setdefault(cut[0], []).append((cut[1], key))
    out, renamed = dict(change), {}
    for base, found in grown.items():
        off = [k for arg, k in found
               if len(found) == 1 or arg in ("false", "0")]
        if len(off) == 1:
            out[base] = out.pop(off[0])
            renamed[base] = off[0]
    return out, renamed


def sass(tree: Path, source: str, out_dir: Path) -> dict:
    """{kernel key: its SASS listing} of ``tree``'s source; symbols inside
    the instructions are demangled too."""
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
        # each line with its runs of blanks collapsed: cuobjdump pads the
        # encodings' column to the longest line of the whole cubin
        kernels[kernel_key(m.group(1))] = "\n".join(
            " ".join(line.split()) for line in text[m.end():end].splitlines())
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
    got["change"], renamed = match_appended_flags(got["parent"],
                                                  got["change"])
    names = sorted(set(got["parent"]) | set(got["change"]))
    counts = {"same": 0, "differs": 0, "parent only": 0, "change only": 0}
    for name in names:
        if args.match not in name:
            continue
        p, c = got["parent"].get(name), got["change"].get(name)
        verdict = ("change only" if p is None else "parent only" if c is None
                   else "same" if p == c else "differs")
        counts[verdict] += 1
        row = {"kernel": name, "verdict": verdict,
               "parent_insns": None if p is None else len(_INSN.findall(p)),
               "change_insns": None if c is None else len(_INSN.findall(c))}
        if name in renamed:
            row["change_kernel"] = renamed[name]
        print(json.dumps(row))
    print(json.dumps({"source": args.source, "match": args.match, **counts}))
    sys.exit(1 if counts["differs"] else 0)


if __name__ == "__main__":
    main()
