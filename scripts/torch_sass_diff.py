#!/usr/bin/env python3
"""Whether a kernel's machine code (SASS) is the same in two checkouts of
the port: a change against its parent.

    python3 scripts/torch_sass_diff.py PARENT CHANGE
        [--source flatpack] [--pair flat_kernelILi0E=flat_kernelILi0E ...] [--all]

PARENT and CHANGE are the roots of two checkouts (a ``git archive`` of each
will do).  Each builds ``microflow_tpu_torch/csrc/<source>.cu`` with its own
``kernels/build.py`` (its flags, into its own ``build/torch_ext/``), in a
process of its own; ``cuobjdump -sass`` dumps the library, and each
``--pair`` compares the entry function of PARENT whose name contains the
left-hand text with the one of CHANGE whose name contains the right-hand
text, instruction by instruction, addresses and encodings dropped; ``--all``
pairs every entry function of one name in both (the hash that names an
anonymous namespace, which follows the source's path, left out), and the
``--pair`` pairs given with it (an instantiation renamed, e.g. the flat
kernel's ``flat_kernelILb0E=flat_kernelILi0E``), and lists those left in
only one.  Prints
one JSON line: per pair the functions' names, their instruction counts,
whether the code is identical, how many instructions differ and the first
few that do.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from microflow_tpu_torch.kernels import build; "
         "print(build.build_all((sys.argv[2],))[sys.argv[2]])")


def sass(root: str, source: str) -> dict[str, list[str]]:
    """{entry function: its instructions} of ``source`` built in ``root``."""
    lib = subprocess.run([sys.executable, "-c", BUILD, os.path.abspath(root), source],
                         capture_output=True, text=True, check=True,
                         cwd=root).stdout.strip().splitlines()[-1]
    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in dump.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            name = m.group(1)
            funcs[name] = []
        elif name and (m := re.match(r"\s*/\*[0-9a-f]+\*/\s*(.*?;)", line)):
            funcs[name].append(" ".join(m.group(1).split()))
    return funcs


def pick(funcs: dict, text: str) -> str:
    (name,) = [f for f in funcs if text in f]
    return name


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--source", default="flatpack")
    ap.add_argument("--pair", nargs="+", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()
    old, new = sass(args.parent, args.source), sass(args.change, args.source)
    plain = lambda funcs: {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", f): f for f in funcs}
    old_by, new_by = plain(old), plain(new)
    given = args.pair if args.pair is not None or args.all else [
        f"flat_kernelILi{m}E=flat_kernelILi{m}E" for m in range(5) if m != 1]
    names = [(pick(old, left), pick(new, right))
             for left, right in (pair.split("=") for pair in given or [])]
    if args.all:
        names += [(old_by[n], new_by[n]) for n in sorted(set(old_by) & set(new_by))]
        paired_old = {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", a) for a, _ in names}
        paired_new = {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", b) for _, b in names}
        old_by = {k: v for k, v in old_by.items() if k not in paired_old}
        new_by = {k: v for k, v in new_by.items() if k not in paired_new}
    pairs = []
    for a, b in names:
        ops = difflib.SequenceMatcher(None, old[a], new[b], autojunk=False).get_opcodes()
        diff = [(old[a][i1:i2], new[b][j1:j2]) for tag, i1, i2, j1, j2 in ops if tag != "equal"]
        pairs.append({"parent": a, "change": b, "parent_instructions": len(old[a]),
                      "change_instructions": len(new[b]), "identical": old[a] == new[b],
                      "differing": sum(max(len(x), len(y)) for x, y in diff),
                      "first_differences": diff[:5]})
    only = lambda a, b: sorted(set(a) - set(b)) if args.all else []
    print(json.dumps({"source": args.source, "pairs": pairs,
                      "only_parent": only(old_by, new_by), "only_change": only(new_by, old_by)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
