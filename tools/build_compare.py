#!/usr/bin/env python3
"""Hold this tree's plain kernel builds against another tree's.

Builds ``csrc/{lwsw,lw,sw}.cu`` in both trees (each with its own
ops/cuda/build.py, in parallel) through ``tools/sass_count.py``, then
compares, per library:
* ptxas's report (``<lib>.ptxas.txt``: per kernel instantiation the
  registers, spills, stack, barriers and static shared memory);
* tools/sass_count.py's instruction counts by kind, per function and per
  loop body.
The anonymous namespaces' hashes, ptxas's compile times and the library
hashes differ between any two sources and are left out.  A change that
only adds code under a define that the plain build does not set must
give equal reports.

Usage (on a machine with nvcc and cuobjdump):
  python tools/build_compare.py --against _archive/parent [--out f.json]
Prints one line per library and one JSON line; exit 0 iff all are equal.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("lwsw", "lw", "sw")
_VOLATILE = [(re.compile(r"_GLOBAL__N__[0-9a-f]{8}"), "_GLOBAL__N__"),
             (re.compile(r"_INTERNAL_[0-9a-f]{8}"), "_INTERNAL_"),
             (re.compile(r"Compile time = [0-9.]+ ms"), "Compile time"),
             (re.compile(r"-[0-9a-f]{16}\.so"), ".so")]


def normalize(text: str) -> str:
    for pattern, repl in _VOLATILE:
        text = pattern.sub(repl, text)
    return text


def tree_report(tree: str) -> dict:
    """{"sass": sass_count's stdout, name: that library's ptxas report}
    for the plain builds of the tree at ``tree``."""
    run = lambda *cmd: subprocess.run(
        [sys.executable, *cmd], cwd=tree, capture_output=True, text=True,
        check=True).stdout
    out = {"sass": run("tools/sass_count.py")}
    paths = run("-c", "from ecckd_tpu_torch.ops.cuda import build\n"
                f"for n in {NAMES!r}: print(build.library_path(n))")
    for name, path in zip(NAMES, paths.split()):
        with open(f"{path}.ptxas.txt") as f:
            out[name] = f.read()
    return out


def registers(report: str) -> list:
    """ptxas's "Used ..." lines, one per kernel instantiation."""
    return re.findall(r"Used \d+ registers[^\n]*", report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/build_compare.py")
    ap.add_argument("--against", required=True,
                    help="the other tree (e.g. the parent commit unpacked "
                         "by git archive)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with ThreadPoolExecutor(2) as pool:
        this, other = pool.map(tree_report,
                               (REPO, os.path.abspath(args.against)))
    sass_same = normalize(this["sass"]) == normalize(other["sass"])
    result = {"against": args.against, "sass_count_equal": sass_same,
              "libraries": {}}
    for name in NAMES:
        same = normalize(this[name]) == normalize(other[name])
        result["libraries"][name] = {"ptxas_equal": same,
                                     "ptxas": registers(this[name])}
        print(f"build_compare: {name}: ptxas report "
              f"{'equal' if same else 'DIFFERS'} "
              f"({len(registers(this[name]))} instantiations)", flush=True)
    print(f"build_compare: sass_count per loop body "
          f"{'equal' if sass_same else 'DIFFERS'}", flush=True)
    result["pass"] = sass_same and all(
        r["ptxas_equal"] for r in result["libraries"].values())
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
