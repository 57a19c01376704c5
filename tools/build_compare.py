#!/usr/bin/env python3
"""Hold this tree's plain kernel builds against another tree's.

Builds ``csrc/{lwsw,lw,sw}.cu`` in both trees (each with its own
ops/cuda/build.py, in parallel) through ``tools/sass_count.py``, then
compares, per library and per function (kernel instantiation or device
function):
* ptxas's report (``<lib>.ptxas.txt``: per kernel instantiation the
  registers, spills, stack, barriers, static shared and constant memory);
* tools/sass_count.py's instruction counts by kind, per function and per
  loop body.
The anonymous namespaces' hashes, ptxas's compile times and the library
hashes differ between any two sources and are left out.  Every function
of the other tree must be in this one with equal reports; functions only
this tree has (new instantiations) are listed, not compared.  A change
that only adds code under a define that the plain build does not set, or
only adds instantiations, must pass.

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


def ptxas_functions(report: str) -> dict:
    """ptxas's report split by function: {name: its lines}, the lines
    before the first function under ""."""
    out, key = {"": []}, ""
    for line in normalize(report).splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m and m.group(1) != key:
            key = m.group(1)
            out.setdefault(key, [])
        out[key].append(line)
    return out


def sass_functions(text: str) -> dict:
    """tools/sass_count.py's summary split by function: {"library
    function": its lines}."""
    out, key = {}, None
    for line in normalize(text).splitlines():
        m = re.match(r"== (\S+ \S+): ", line)
        if m:
            key = m.group(1)
            out[key] = []
        if key is not None:
            out[key].append(line)
    return out


def compare(this: dict, other: dict) -> dict:
    """Functions in both with unequal lines, in the other only, in this
    only."""
    return {"differ": sorted(k for k in this.keys() & other.keys()
                             if this[k] != other[k]),
            "missing": sorted(other.keys() - this.keys()),
            "added": sorted(this.keys() - other.keys())}


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
    sass = compare(sass_functions(this["sass"]),
                   sass_functions(other["sass"]))
    sass_same = not sass["differ"] and not sass["missing"]
    result = {"against": args.against, "sass_count_equal": sass_same,
              "sass_count": sass, "libraries": {}}
    for name in NAMES:
        ptxas = compare(ptxas_functions(this[name]),
                        ptxas_functions(other[name]))
        same = not ptxas["differ"] and not ptxas["missing"]
        result["libraries"][name] = {"ptxas_equal": same, **ptxas,
                                     "ptxas": registers(this[name])}
        print(f"build_compare: {name}: ptxas report "
              f"{'equal' if same else 'DIFFERS'} "
              f"({len(registers(this[name]))} instantiations, "
              f"{len(ptxas['added'])} functions added)", flush=True)
    print(f"build_compare: sass_count per loop body "
          f"{'equal' if sass_same else 'DIFFERS'} ({len(sass['added'])} "
          f"functions added)", flush=True)
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
