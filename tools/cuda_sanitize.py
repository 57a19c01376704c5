#!/usr/bin/env python3
"""Run the staged kernels (K1 csrc/lwsw.cu, K3 lw.cu, K4 sw.cu) under
NVIDIA's compute-sanitizer on one card.

Three tools, each over one child process that launches every
configuration once (the kernels only, no plain version) and checks the
outputs finite:
* ``racecheck`` (shared-memory hazards) and ``synccheck`` (barrier use):
  K1 and K3 at nlay 8, 60 and 137 at 1, 3 and 4 Gauss angles, K4 at nlay
  8, 60 and 137, each in the exact and the fast table mode, on 300
  columns through 16 persistent blocks, so every block walks its ring of
  column slots several times;
* ``memcheck``: the device-staging route of each kernel (K1 nlay 300, K3
  nlay 600, K4 nlay 430; both modes), with PyTorch's caching allocator
  off so each tensor is its own allocation.

Usage (on a machine with a card and the CUDA toolkit):
  python tools/cuda_sanitize.py [--tools racecheck,synccheck,memcheck]
      [--out chiprun_out/sanitize.json]
Prints each tool's ERROR SUMMARY and one JSON line; exit status 0 iff
every tool ran and reported 0 errors.  Where the sanitizer refuses the
card ("Device not supported", as in a sandbox without the debugger
interface), each tool records ``"supported": false`` and no result.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

NCOL, BLOCKS = 300, 16
SHARED = ([("lwsw", n, a) for n in (8, 60, 137) for a in (1, 3, 4)]
          + [("lw", n, a) for n in (8, 60, 137) for a in (1, 3, 4)]
          + [("sw", n, 1) for n in (8, 60, 137)])
DEVICE = [("lwsw", 300, 1), ("lw", 600, 1), ("sw", 430, 1)]
TOOLS = {"racecheck": SHARED, "synccheck": SHARED, "memcheck": DEVICE}


def child(configs) -> int:
    """Launch each (kernel, nlay, angles) configuration in both table
    modes; 0 iff every output is finite."""
    import numpy as np
    import torch
    from ecckd_tpu_torch.io.synthetic import (example_flux_batch,
                                              write_synthetic_ckd)
    from ecckd_tpu_torch.models.loader import load_ckd_model
    from ecckd_tpu_torch.ops.cuda import lw, lwsw, plan, staged, sw
    models = {}
    with tempfile.TemporaryDirectory() as work:
        for key, kind in (("lw", "lw_fsck"), ("sw", "sw_wide")):
            path = os.path.join(work, f"{key}.nc")
            write_synthetic_ckd(path, kind, seed=7)
            models[key] = load_ckd_model(path, dtype=torch.float32,
                                         device="cuda")
    ok = True
    for kernel, nlay, n_ang in configs:
        b = example_flux_batch(NCOL, nlay, np.float32, device="cuda")
        t = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()
             if k != "concs"}
        emis = t["emis"][:, None].expand(-1, models["lw"].ngpt).contiguous()
        for fast in (False, True):
            if kernel == "lw":
                prep = plan.prepare_lw(models["lw"], t["plev"], t["tlay"],
                                       t["tlev"], t["tsfc"], emis, b["concs"],
                                       n_ang, fast=fast)
                core, bands = lw._kernel_core, (prep[1], None)
            elif kernel == "sw":
                prep = plan.prepare_sw(models["sw"], t["plev"], t["tlay"],
                                       b["concs"], t["alb"], t["tsi"],
                                       t["sza"], fast=fast)
                core, bands = sw._kernel_core, (None, prep[1])
            else:
                prep = plan.prepare(models["lw"], models["sw"], t["plev"],
                                    t["tlay"], t["tlev"], t["tsfc"], emis,
                                    b["concs"], t["alb"], t["tsi"], t["sza"],
                                    n_ang, fast=fast)
                core, bands = lwsw._kernel_core, prep[1:]
            stage, _ = staged.occupancy(prep[0], *bands)
            outs = core(*prep, NCOL, max_blocks=BLOCKS)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            ok = ok and finite
            print(f"sanitize child: {kernel} nlay {nlay} {n_ang} angle(s) "
                  f"{'fast' if fast else 'exact'}: C = {stage.slots}, "
                  f"{stage.threads} threads, "
                  + ("shared" if stage.shared else "device")
                  + f" staging, {BLOCKS} blocks, finite {finite}",
                  flush=True)
    return 0 if ok else 1


def sanitizer() -> str:
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (f"{home}/bin/compute-sanitizer",
                 f"{home}/compute-sanitizer/compute-sanitizer"):
        if os.path.isfile(cand):
            return cand
    raise RuntimeError("compute-sanitizer not found")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/cuda_sanitize.py")
    ap.add_argument("--tools", default="racecheck,synccheck,memcheck")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(TOOLS[args.child])
    import torch
    if not torch.cuda.is_available():
        print("cuda_sanitize: no CUDA card", file=sys.stderr)
        return 1
    # Build the kernels once, outside the sanitizer.
    from ecckd_tpu_torch.ops.cuda import build
    for name in ("lwsw", "lw", "sw"):
        build.build(name)
    tool_path = sanitizer()
    results, ok = {}, True
    for tool in args.tools.split(","):
        env = dict(os.environ)
        if tool == "memcheck":
            env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
        cmd = [tool_path, "--tool", tool, "--error-exitcode", "9"]
        if tool == "racecheck":
            cmd += ["--racecheck-report", "all"]
        cmd += [sys.executable, os.path.abspath(__file__), "--child", tool]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
        seconds = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        summary = re.findall(r"ERROR SUMMARY: (\d+) error", out)
        hazards = re.findall(r"RACECHECK SUMMARY: (\d+) hazard", out)
        launched = len(re.findall(r"^sanitize child: .*finite True", out,
                                  re.M))
        errors = int(summary[-1]) if summary else None
        supported = "Device not supported" not in out
        passed = supported and proc.returncode == 0 and errors == 0
        ok = ok and passed
        results[tool] = {"supported": supported, "rc": proc.returncode,
                         "errors": errors,
                         "hazards": int(hazards[-1]) if hazards else None,
                         "configurations": 2 * len(TOOLS[tool]),
                         "finite": launched, "seconds": round(seconds, 1),
                         "pass": passed}
        tail = [ln for ln in out.splitlines() if "=========" in ln][-12:]
        verdict = ("ok" if passed else "FAIL" if supported
                   else "NOT RUN (device not supported)")
        print(f"cuda_sanitize: {tool}: {verdict} rc "
              f"{proc.returncode}, errors {errors}, {launched} of "
              f"{2 * len(TOOLS[tool])} launches finite, {seconds:.1f} s",
              flush=True)
        for ln in tail:
            print(f"  {ln}")
    line = json.dumps({"sanitizer": tool_path, "pass": ok,
                       "tools": results})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
