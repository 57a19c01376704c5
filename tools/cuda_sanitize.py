#!/usr/bin/env python3
"""Check the staged kernels' ring protocol (K1 csrc/lwsw.cu, K3 lw.cu, K4
sw.cu) on one card: under NVIDIA's compute-sanitizer, or (``--checked``)
with the kernels' own checked build.

The sanitizer route: three tools, each over one child process that
launches every configuration once (the kernels only, no plain version)
and checks the outputs finite:
* ``racecheck`` (shared-memory hazards) and ``synccheck`` (barrier use):
  K1 and K3 at nlay 8, 60 and 137 at 1, 3 and 4 Gauss angles, K4 at nlay
  8, 60 and 137, each in the exact and the fast table mode, on 300
  columns through 16 persistent blocks, so every block walks its ring of
  column slots several times;
* ``memcheck``: the device-staging route of each kernel (K1 nlay 300, K3
  nlay 600, K4 nlay 430; both modes), with PyTorch's caching allocator
  off so each tensor is its own allocation.
Where the sanitizer refuses the card ("Device not supported", as in a
machine without the debugger interface), each tool records
``"supported": false`` and no result.

The checked route (``--checked``) needs no sanitizer.  It builds each
kernel with ``-DECCKD_CHECK_RING`` (ops/cuda/ring_check.py,
csrc/ring_check.cuh: slot ledgers checked after every barrier wait, NaN
poison over a freed slot's rows, guard words after every slot, seeded
jitter at the hand-over points) and runs it over ``CHECKED``: the
sanitizer's configurations plus nlay 30, 47 and 91 and the depths that
reach every other staging regime of each kernel (``stage_plan``: threads
per block, C, S, the route: shared, split or device staging), on
``CHECKED_NCOL`` columns,
in both table modes, and K1's double instantiation over ``CHECKED_F64``
(float64 inputs and models: the f64 plans' routes), and over
``CHECKED_WIDE`` and ``CHECKED_WIDE_F64`` on the 36-g-point lw_rrtmgp
(K1 and K3 with an LW band wider than a warp: every staging regime of
that band at float32 and, for K1, float64), and K1's Jacobian
instantiation over ``CHECKED_JAC`` in both table modes (every staging
regime it takes), at jitter 0 on the
full card and through 16 blocks, and at ``JITTER_NS`` with each of
``SEEDS``.  Every run must show 0
violations (canaries intact), finite outputs and outputs bit for bit
equal to the plain build's.  Then the builds with the planted faults
run over the same configurations (exact mode and f64, jitter 0 and one
seed):
``-DECCKD_PLANT_SKIP_FREE`` (in slot 0's round 1 the optics warps wait
for each other but not for the slot's sweeps, and join its FREE only
after staging it) in each, and ``-DECCKD_PLANT_SKIP_PRM`` (in slot 0's
round 0 the LW sweep warps free the slot before they write the next
column's layer parameters, and write them late; on the split route the
optics warps compute slot 0's parameters ahead of their FREE wait already
in round 1, while the last optics warp stages round 0 late) in those
whose plan has the parameter stage.  The checker must report each plant in each kernel it runs in: a violation,
a NaN or an output that differs.

Usage (on a machine with a card and the CUDA toolkit):
  python tools/cuda_sanitize.py [--tools racecheck,synccheck,memcheck]
      [--out sanitize.json]
  python tools/cuda_sanitize.py --checked [--out checked.json]
Prints one line per tool or configuration and one JSON record (written to
``--out`` too); exit status 0 iff everything passed.
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

# The checked route: the depths of tools/shape_sweep_cuda.py and those that
# reach each kernel's other staging regimes on an H100 (K1: the split
# route's ends at 1 and 3 angles, at 1 angle those of the parameter stage
# (124-175), and one whole column per block; K3: 1024 threads at C = 2,
# C = 1, device staging in 512 threads; K4: C = 2, C = 1).
EXTRA = ([(k, n, a) for k in ("lwsw", "lw") for n in (30, 47, 91)
          for a in (1, 3)]
         + [("lwsw", n, 1) for n in (124, 175, 208, 230)]
         + [("lwsw", n, 3) for n in (122, 202)]
         + [("lw", 200, 1), ("lw", 430, 1), ("lw", 600, 4)]
         + [("sw", n, 1) for n in (30, 47, 91, 180, 300)])
CHECKED = SHARED + DEVICE + EXTRA
# K1's double instantiation: its f64 plans (8 B a word) in shared memory
# (nlay 8: two blocks of 384 threads; 47, 60: C = 2 in 768; 110: C = 1),
# split (80 with the parameter stage at 1 angle, 91 without) and in the
# device slice (137, 300), at 1 and 3 angles.
CHECKED_F64 = [("lwsw", n, a) for n in (8, 47, 60, 80, 91, 110, 137, 300)
               for a in (1, 3)]
# lw_rrtmgp's 36 LW g-points (two g-chunks; csrc/common.cuh "Layout"): every
# staging regime K1 and K3 reach with them, at float32 (K1: two blocks
# of 512 threads whole to nlay 58 and split from 59, at 1 angle with the
# parameter stage to 87 and without it from 88, 1024 threads whole,
# split, C = 1, the device; on the split route at 1 angle one LW sweep
# warp per g-chunk (nlay 60, 91, 137, 190) or one over the pairs where
# the second warp's accumulators do not fit (87, 103, 175, 206)) and K1's
# at float64 (384 threads whole, 768 whole and split, C = 1, the device).
CHECKED_WIDE = ([("lwsw", n, a) for n in (8, 60, 91, 110, 137, 220, 300)
                 for a in (1, 3)]
                + [("lwsw", n, 1) for n in (87, 103, 175, 190, 206)]
                + [("lw", n, a) for n in (8, 60, 137, 300, 600)
                   for a in (1, 3)] + [("lw", 600, 4)])
CHECKED_WIDE_F64 = [("lwsw", n, a) for n in (8, 40, 80, 110, 137)
                    for a in (1, 3)]
# K1's Jacobian instantiation (lw_fsck + sw_wide, one angle, float32):
# every regime it takes, with the accumulator row of the Jacobian (two
# blocks of 512 threads to nlay 61, one block of 1024 with C = 2 whole to
# 122, split with the parameter stage 123-174 and without it 175-207,
# C = 1 whole from 208); at 207 the guard words leave no room.
CHECKED_JAC = [("lwsw", n, 1) for n in (8, 60, 91, 122, 123, 137, 174, 175,
                                        206, 208, 230)]
CHECKED_NCOL = 2003
SEEDS = (1, 2, 3)
JITTER_NS = 2000
# (seed, jitter ns, blocks: None for as many as the card holds)
RUNS = ([(0, 0, None), (0, 0, BLOCKS)]
        + [(seed, JITTER_NS, BLOCKS) for seed in SEEDS])
PLANT_RUNS = [(0, 0, BLOCKS), (SEEDS[0], JITTER_NS, BLOCKS)]
KERNELS = ("lwsw", "lw", "sw")
PLANTS = ("free", "prm")  # ops/cuda/ring_check.py PLANT_DEFINES


def load_models() -> dict:
    """The synthetic lw_fsck, lw_rrtmgp and sw_wide models (seed 7),
    float32 under "lw", "lw_rrtmgp" and "sw", float64 under "lw64",
    "lw_rrtmgp64" and "sw64", on the card."""
    import torch
    from ecckd_tpu_torch.io.synthetic import write_synthetic_ckd
    from ecckd_tpu_torch.models.loader import load_ckd_model
    models = {}
    with tempfile.TemporaryDirectory() as work:
        for key, kind in (("lw", "lw_fsck"), ("lw_rrtmgp", "lw_rrtmgp"),
                          ("sw", "sw_wide")):
            path = os.path.join(work, f"{key}.nc")
            write_synthetic_ckd(path, kind, seed=7)
            for suffix, dt in (("", torch.float32), ("64", torch.float64)):
                models[key + suffix] = load_ckd_model(path, dtype=dt,
                                                      device="cuda")
    return models


def prepare(models: dict, kernel: str, ncol: int, nlay: int, n_ang: int,
            fast: bool, f64: bool = False, lw_key: str = "lw"):
    """(the kernel's ``_kernel_core``, its prepared inputs, the bands for
    ``staged``) on ``example_flux_batch(ncol, nlay)``, in float64 with the
    float64 models if ``f64``, with the LW model ``lw_key``."""
    import numpy as np
    import torch
    from ecckd_tpu_torch.io.synthetic import example_flux_batch
    from ecckd_tpu_torch.ops.cuda import lw, lwsw, plan, sw
    suffix = "64" if f64 else ""
    models = {"lw": models[lw_key + suffix], "sw": models["sw" + suffix]}
    b = example_flux_batch(ncol, nlay, np.float64 if f64 else np.float32,
                           device="cuda")
    t = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()
         if k != "concs"}
    emis = t["emis"][:, None].expand(-1, models["lw"].ngpt).contiguous()
    if kernel == "lw":
        prep = plan.prepare_lw(models["lw"], t["plev"], t["tlay"], t["tlev"],
                               t["tsfc"], emis, b["concs"], n_ang, fast=fast)
        return lw._kernel_core, prep, (prep[1], None)
    if kernel == "sw":
        prep = plan.prepare_sw(models["sw"], t["plev"], t["tlay"],
                               b["concs"], t["alb"], t["tsi"], t["sza"],
                               fast=fast)
        return sw._kernel_core, prep, (None, prep[1])
    prep = plan.prepare(models["lw"], models["sw"], t["plev"], t["tlay"],
                        t["tlev"], t["tsfc"], emis, b["concs"], t["alb"],
                        t["tsi"], t["sza"], n_ang, fast=fast)
    return lwsw._kernel_core, prep, prep[1:]


def child(configs) -> int:
    """Launch each (kernel, nlay, angles) configuration in both table
    modes; 0 iff every output is finite."""
    import torch
    from ecckd_tpu_torch.ops.cuda import staged
    models = load_models()
    ok = True
    for kernel, nlay, n_ang in configs:
        for fast in (False, True):
            core, prep, bands = prepare(models, kernel, NCOL, nlay, n_ang,
                                        fast)
            stage, _ = staged.occupancy(prep[0], *bands)
            outs = core(*prep, NCOL, max_blocks=BLOCKS)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            ok = ok and finite
            print(f"sanitize child: {kernel} nlay {nlay} {n_ang} angle(s) "
                  f"{'fast' if fast else 'exact'}: C = {stage.slots}, "
                  f"{stage.threads} threads, {stage.route} staging, "
                  f"{BLOCKS} blocks, finite {finite}", flush=True)
    return 0 if ok else 1


def regime(plan) -> str:
    """A staging plan's regime: threads per block, C, S, the route
    (shared, split or device staging), the parameter stage, the LW sweep
    warps an angle where a set has two."""
    return (f"{plan.threads} threads, C = {plan.slots}, S = {plan.sets}, "
            f"{plan.route}, stage {'on' if plan.prm_stage else 'off'}"
            + (f", {plan.lw_warps} LW sweep warps an angle"
               if plan.lw_warps > 1 else ""))


def build_checked(plant_kernels=KERNELS) -> float:
    """Build every kernel plain and checked, and ``plant_kernels`` with
    each planted fault too: one nvcc per library, all started together.
    Returns the seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from ecckd_tpu_torch.ops.cuda import build, ring_check
    jobs = ([(k, ()) for k in KERNELS]
            + [(k, ring_check.defines()) for k in KERNELS]
            + [(k, ring_check.defines(plant)) for plant in PLANTS
               for k in plant_kernels])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build.build(*job), jobs))
    return time.perf_counter() - t0


def check_config(models: dict, kernel: str, nlay: int, n_ang: int,
                 fast: bool, runs, plant: str = "",
                 ncol: int = CHECKED_NCOL, f64: bool = False,
                 lw_key: str = "lw", jac: bool = False):
    """One configuration through the checked build (with the planted
    fault ``plant`` if given), once per (seed, jitter, blocks) of
    ``runs``, in float64 (K1's double instantiation) if ``f64``, on K1's
    Jacobian instantiation if ``jac``: per run the error record, whether
    the outputs are finite and whether they equal the plain build's bit
    for bit; with the LW model ``lw_key``.  None for the PRM plant on a
    plan without the parameter stage (it plants nothing there)."""
    import torch
    from ecckd_tpu_torch.ops.cuda import ring_check, staged
    core, prep, bands = prepare(models, kernel, ncol, nlay, n_ang, fast,
                                f64, lw_key)
    launch = {"jac": True} if jac else {}
    plan = ring_check.guarded(staged.plan_for(prep[0], *bands, **launch))
    if plant == "prm" and not plan.prm_stage:
        return None
    ref = core(*prep, ncol, max_blocks=BLOCKS, **launch)
    lib = ring_check.library(kernel, plant)
    ring_check.errors(lib, kernel)           # clear the record
    out = {"kernel": kernel, "nlay": nlay, "angles": n_ang,
           "lw_model": lw_key if kernel != "sw" else None,
           "mode": "f64" if f64 else "bf16" if fast else "bf16x3",
           "jac": jac, "plant": plant,
           "regime": regime(plan), "ncol": ncol, "runs": []}
    try:
        for seed, jitter, blocks in runs:
            ring_check.configure(lib, kernel, seed, jitter)
            got = core(*prep, ncol, plan=plan, max_blocks=blocks, lib=lib,
                       **launch)
            torch.cuda.synchronize()
            out["runs"].append({
                "seed": seed, "jitter_ns": jitter, "blocks": blocks or "card",
                **ring_check.errors(lib, kernel),
                "finite": all(bool(torch.isfinite(g).all()) for g in got),
                "bitwise_equal": all(torch.equal(g, r)
                                     for g, r in zip(got, ref))})
    finally:
        ring_check.configure(lib, kernel, 0, 0)
    return out


def run_clean(run: dict) -> bool:
    """A run the checker has nothing to report on."""
    return run["count"] == 0 and run["finite"] and run["bitwise_equal"]


def verdict(checked, planted) -> dict:
    """Pass iff every run of ``checked`` is clean and, for every planted
    fault in every kernel of ``planted``, some run with it is not."""
    clean = all(run_clean(r) for c in checked for r in c["runs"])
    caught = {p: {k: any(not run_clean(r) for c in planted
                         if (c["plant"], c["kernel"]) == (p, k)
                         for r in c["runs"])
                  for k in sorted({c["kernel"] for c in planted
                                   if c["plant"] == p})}
              for p in sorted({c["plant"] for c in planted})}
    return {"clean": clean, "plant_caught": caught,
            "pass": clean and bool(caught)
            and all(all(by_kernel.values()) for by_kernel in caught.values())}


def describe(c: dict) -> str:
    """One line of a checked configuration's runs."""
    runs = c["runs"]
    bad = [r for r in runs if not run_clean(r)]
    head = (("caught" if bad else "MISSED") if c["plant"]
            else ("FAIL" if bad else "ok"))
    first = next((r["first"] for r in runs if r["first"]), None)
    return (f"{'plant ' + c['plant'] if c['plant'] else 'checked'}: {head} "
            f"{c['kernel']} "
            + (f"{c['lw_model']} " if c.get("lw_model") not in (None, "lw")
               else "")
            + f"nlay {c['nlay']} {c['angles']} angle(s) {c['mode']} "
            + ("jacobian " if c.get("jac") else "")
            + f"({c['regime']}): {len(runs)} runs, violations "
            f"{[r['count'] for r in runs]}, finite "
            f"{[r['finite'] for r in runs]}, bitwise equal "
            f"{[r['bitwise_equal'] for r in runs]}"
            + (f", first {first}" if first else ""))


def run_checked(configs=CHECKED, plant_configs=CHECKED, modes=(False, True),
                runs=RUNS, plant_runs=PLANT_RUNS,
                ncol: int = CHECKED_NCOL, f64_configs=CHECKED_F64,
                wide_configs=CHECKED_WIDE,
                wide_f64_configs=CHECKED_WIDE_F64,
                jac_configs=CHECKED_JAC) -> dict:
    """The checked build over ``configs`` and ``wide_configs`` (on
    lw_rrtmgp) in ``modes`` and over ``f64_configs`` and
    ``wide_f64_configs`` in float64, and K1's Jacobian instantiation over
    ``jac_configs`` in ``modes``, and each planted fault over
    ``plant_configs``, ``wide_configs`` (exact mode), the float64 ones
    and the Jacobian's (exact mode), each configuration printed as it
    ends; the record with its ``verdict``."""
    models = load_models()
    t0 = time.perf_counter()
    checked, planted = [], []
    wide = "lw_rrtmgp"
    todo = ([(c, fast, False, "lw", False) for c in configs
             for fast in modes]
            + [(c, False, True, "lw", False) for c in f64_configs]
            + [(c, fast, False, wide, False) for c in wide_configs
               for fast in modes]
            + [(c, False, True, wide, False) for c in wide_f64_configs]
            + [(c, fast, False, "lw", True) for c in jac_configs
               for fast in modes])
    for (kernel, nlay, n_ang), fast, f64, lw_key, jac in todo:
        checked.append(check_config(models, kernel, nlay, n_ang, fast,
                                    runs, ncol=ncol, f64=f64, lw_key=lw_key,
                                    jac=jac))
        print(describe(checked[-1]), flush=True)
    for plant in PLANTS:
        for (kernel, nlay, n_ang), f64, lw_key, jac in (
                [(c, False, "lw", False) for c in plant_configs]
                + [(c, True, "lw", False) for c in f64_configs]
                + [(c, False, wide, False) for c in wide_configs]
                + [(c, True, wide, False) for c in wide_f64_configs]
                + [(c, False, "lw", True) for c in jac_configs]):
            c = check_config(models, kernel, nlay, n_ang, False, plant_runs,
                             plant=plant, ncol=ncol, f64=f64, lw_key=lw_key,
                             jac=jac)
            if c is not None:
                planted.append(c)
                print(describe(c), flush=True)
    return {"seconds": time.perf_counter() - t0, "seeds": list(SEEDS),
            "jitter_ns": JITTER_NS, "ncol": ncol,
            "configurations": len(checked),
            "runs": sum(len(c["runs"]) for c in checked),
            "plant_runs": sum(len(c["runs"]) for c in planted),
            **verdict(checked, planted), "checked": checked,
            "planted": planted}


def checked_main(out_path) -> int:
    import torch
    if not torch.cuda.is_available():
        print("cuda_sanitize: no CUDA card", file=sys.stderr)
        return 1
    from ecckd_tpu_torch.utils.profiling import card_name
    card = card_name()
    build_s = build_checked()
    print(f"checked: built plain, checked and planted libraries in "
          f"{build_s:.1f} s on {card}", flush=True)
    record = {"route": "checked build (-DECCKD_CHECK_RING)", "card": card,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_seconds": build_s, **run_checked()}
    print(f"checked: {'PASS' if record['pass'] else 'FAIL'} "
          f"{record['configurations']} configurations, {record['runs']} "
          f"runs clean: {record['clean']}; planted fault caught "
          f"{record['plant_caught']} ({record['seconds']:.1f} s)",
          flush=True)
    line = json.dumps(record)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if record["pass"] else 1


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
    ap.add_argument("--checked", action="store_true",
                    help="run the kernels' checked build instead of the "
                         "sanitizer")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(TOOLS[args.child])
    if args.checked:
        return checked_main(args.out)
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
