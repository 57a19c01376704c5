#!/usr/bin/env python3
"""Count the SASS instructions of the port's CUDA kernels by kind.

Builds ``csrc/{lwsw,lw,sw}.cu`` (ops/cuda/build.py), disassembles each
library with ``cuobjdump -sass`` and, for every kernel function in it
(both table-mode instantiations), finds the loops (a backward branch to
an address at or before it closes a loop) and counts the instructions of
each loop body by kind, nested loops counted apart.  The loop bodies are
what a kernel issues per layer and g-point; a reader composes the count
per (column, layer) from them and the trip counts (PERF.md §6).

Kinds: 64-bit address arithmetic (IMAD.WIDE, the carry halves .X),
other integer, global / shared / constant / local loads and stores,
shuffles, FFMA/FMUL/FADD, other float, MUFU (by function: RCP for a
divide, EX2 for an exponential, LG2 for a logarithm, RSQ for a square
root), conversions, control flow and barriers, uniform-datapath
instructions.

Usage (on a machine with nvcc and cuobjdump):
  python tools/sass_count.py [--kernels lwsw,lw,sw] [--out-dir DIR]
Prints one summary per kernel function; with ``--out-dir`` also writes
each library's full SASS there (<name>.sass) and the summary as JSON.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_TARGET = re.compile(r"0x([0-9a-f]+)")

KINDS = ("addr64", "int", "ldg", "stg", "lds", "sts", "ldc", "local",
         "shfl", "fma_mul_add", "float_other", "mufu", "conv", "control",
         "uniform", "other")


def kind_of(op: str) -> str:
    """The kind of one SASS opcode (with its modifiers, no predicate)."""
    mods = op.split(".")
    base = mods[0]
    if base.startswith("U"):
        return "uniform"
    if base in ("IMAD", "IADD3", "LEA") and ("WIDE" in mods or "X" in mods):
        return "addr64"
    if base == "LDG":
        return "ldg"
    if base in ("STG", "RED", "ATOMG"):
        return "stg"
    if base == "LDS":
        return "lds"
    if base == "STS":
        return "sts"
    if base == "LDC":
        return "ldc"
    if base in ("LDL", "STL"):
        return "local"
    if base == "SHFL":
        return "shfl"
    if base in ("FFMA", "FMUL", "FADD"):
        return "fma_mul_add"
    if base in ("FMNMX", "FSETP", "FSEL", "FCHK", "FSET", "FRND"):
        return "float_other"
    if base == "MUFU":
        return "mufu"
    if base in ("F2I", "I2F", "F2F", "I2FP", "F2FP"):
        return "conv"
    if base in ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR",
                "WARPSYNC", "BREAK", "BMOV", "NOP", "YIELD", "JMP", "JMX",
                "BRX", "VOTE", "MEMBAR", "ERRBAR", "DEPBAR", "S2R", "CS2R",
                "S2UR", "PLOP3", "P2R", "R2P"):
        return "control"
    if base in ("IADD3", "IMAD", "LEA", "SHF", "LOP3", "ISETP", "SEL",
                "PRMT", "IABS", "IMNMX", "MOV", "POPC", "FLO", "BREV",
                "IMUL", "SGXT", "LOP", "IADD"):
        return "int"
    return "other"


def functions(sass: str):
    """{function name: [(address, opcode text)]} from cuobjdump -sass."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _LINE.search(line)
        if m and name is not None:
            text = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
            out[name].append((int(m.group(1), 16), text))
    return out


def loops(instrs):
    """Loop regions [start, end] (addresses, end = the backward branch),
    innermost first by size."""
    regions = set()
    for addr, text in instrs:
        if text.split(" ")[0].split(".")[0] == "BRA":
            m = _TARGET.search(text)
            if m and int(m.group(1), 16) <= addr:
                regions.add((int(m.group(1), 16), addr))
    return sorted(regions, key=lambda r: (r[1] - r[0], r[0]))


def count(instrs, lo, hi, skip=()):
    c = collections.Counter()
    mufu = collections.Counter()
    for addr, text in instrs:
        if not lo <= addr <= hi or any(a <= addr <= b for a, b in skip):
            continue
        op = text.split(" ")[0]
        k = kind_of(op)
        c[k] += 1
        if k == "mufu":
            mufu[op.split(".")[1] if "." in op else "?"] += 1
    c["total"] = sum(c[k] for k in KINDS)
    return dict(c), dict(mufu)


def summarize(name: str, instrs):
    regions = loops(instrs)
    rows = []
    for lo, hi in regions:
        nested = [r for r in regions if r != (lo, hi) and lo <= r[0]
                  and r[1] <= hi]
        depth = sum(1 for r in regions if r != (lo, hi) and r[0] <= lo
                    and hi <= r[1])
        own, mufu = count(instrs, lo, hi, skip=nested)
        rows.append({"start": hex(lo), "end": hex(hi), "depth": depth,
                     "nested": len(nested), "own": own, "mufu": mufu})
    rows.sort(key=lambda r: int(r["start"], 16))
    total, mufu = count(instrs, 0, 1 << 40)
    return {"function": name, "instructions": len(instrs), "total": total,
            "mufu": mufu, "loops": rows}


def fmt_counts(c: dict) -> str:
    return " ".join(f"{k}={c[k]}" for k in ("total",) + KINDS if c.get(k))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/sass_count.py")
    ap.add_argument("--kernels", default="lwsw,lw,sw")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    from ecckd_tpu_torch.ops.cuda import build
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(build.nvcc_path()).parent / "cuobjdump")
    report = []
    for name in args.kernels.split(","):
        lib = build.build(name)
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            Path(args.out_dir, f"{name}.sass").write_text(sass)
        for fn, instrs in functions(sass).items():
            s = summarize(fn, instrs)
            s["library"] = name
            report.append(s)
            print(f"== {name} {fn}: {s['instructions']} instructions | "
                  f"{fmt_counts(s['total'])} | mufu {s['mufu']}")
            for r in s["loops"]:
                print(f"   loop {r['start']}-{r['end']} depth {r['depth']} "
                      f"nested {r['nested']}: {fmt_counts(r['own'])} | "
                      f"mufu {r['mufu']}")
    if args.out_dir:
        Path(args.out_dir, "sass_count.json").write_text(
            json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
