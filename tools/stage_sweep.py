#!/usr/bin/env python3
"""Time the staged kernels (K1 csrc/lwsw.cu, K3 lw.cu, K4 sw.cu) over
block shapes on one CUDA card.

For each kernel at the protocol batch (65,536 x 60 by default,
``example_flux_batch`` on the synthetic lw_fsck / sw_wide files, seed 7)
and each (blocks per SM, C columns per block, S sets of sweep warps) in
``--shapes``, builds the staging plan with ops/cuda/staged.py
``stage_plan`` (which fits the request to the card), launches the kernel
on it and times it with CUDA events (median of 10 after 2 warm-ups).  Every
shape's outputs must equal the default shape's bit for bit (a column's
arithmetic does not depend on the block it runs in); the script exits 1
if one does not.  Shapes are timed in turns (default, the others, the
default again) so the spread of one call shows.

Usage (on a machine with a card):
  python tools/stage_sweep.py [--kernels lw,sw,lwsw] [--angles 1]
      [--shapes 2x2x1,4x2x2,...] [--ncol 65536] [--nlay 60]
Prints one line per (kernel, shape) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/stage_sweep.py")
    ap.add_argument("--kernels", default="lw,sw,lwsw")
    ap.add_argument("--angles", type=int, default=1)
    ap.add_argument("--shapes", default="2x2x1,2x2x2,4x2x1,4x2x2,2x3x3,"
                    "2x4x2,2x4x4,1x4x4,4x1x1")
    ap.add_argument("--ncol", type=int, default=65536)
    ap.add_argument("--nlay", type=int, default=60)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("stage_sweep: no CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import cuda_time_ms
    from ecckd_tpu_torch.io.synthetic import (example_flux_batch,
                                              write_synthetic_ckd)
    from ecckd_tpu_torch.models.loader import load_ckd_model
    from ecckd_tpu_torch.ops.cuda import lw, lwsw, plan, staged, sw
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    models = {}
    with tempfile.TemporaryDirectory() as work:
        for key, kind in (("lw", "lw_fsck"), ("sw", "sw_wide")):
            path = os.path.join(work, f"{key}.nc")
            write_synthetic_ckd(path, kind, seed=7)
            models[key] = load_ckd_model(path, dtype=torch.float32,
                                         device="cuda")
    b = example_flux_batch(args.ncol, args.nlay, np.float32, device="cuda")
    t = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()
         if k != "concs"}
    emis = t["emis"][:, None].expand(-1, models["lw"].ngpt).contiguous()
    preps = {
        "lw": plan.prepare_lw(models["lw"], t["plev"], t["tlay"], t["tlev"],
                              t["tsfc"], emis, b["concs"],
                              n_gauss_angles=args.angles),
        "sw": plan.prepare_sw(models["sw"], t["plev"], t["tlay"],
                              b["concs"], t["alb"], t["tsi"], t["sza"]),
        "lwsw": plan.prepare(models["lw"], models["sw"], t["plev"],
                             t["tlay"], t["tlev"], t["tsfc"], emis,
                             b["concs"], t["alb"], t["tsi"], t["sza"],
                             n_gauss_angles=args.angles)}
    cores = {"lw": lw._kernel_core, "sw": sw._kernel_core,
             "lwsw": lwsw._kernel_core}
    props = torch.cuda.get_device_properties(0)
    limits = (props.shared_memory_per_block_optin,
              props.shared_memory_per_multiprocessor)
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.shapes.split(",")]
    ok = True
    for name in args.kernels.split(","):
        prep = preps[name]
        atm = prep[0]
        lw_in, sw_in = {"lw": (prep[1], None), "sw": (None, prep[1]),
                        "lwsw": prep[1:]}[name]
        core = cores[name]
        default = staged.plan_for(atm, lw_in, sw_in)
        ref = [o.clone() for o in core(*prep, args.ncol)]
        order = [None] + shapes + [None]
        for shape in order:
            if shape is None:
                p, label = default, f"default {staged.SHAPES[name]}"
            else:
                p = staged.stage_plan(
                    args.nlay, lw_in.plan.ngpt if lw_in else 0,
                    sw_in.plan.ngpt if sw_in else 0,
                    lw_in.n_gauss_angles if lw_in else 1,
                    staged.band_gases(lw_in.plan) if lw_in else (0, 0),
                    staged.band_gases(sw_in.plan) if sw_in else (0, 0),
                    *limits, blocks_per_sm=shape[0], max_slots=shape[1],
                    sets=shape[2])
                label = "x".join(map(str, shape))
            _, per_sm = staged.occupancy(atm, lw_in, sw_in, plan=p)
            out = core(*prep, args.ncol, plan=p)
            same = all(torch.equal(o, r) for o, r in zip(out, ref))
            ok = ok and same
            ms = cuda_time_ms(lambda: core(*prep, args.ncol, plan=p))
            print(f"stage_sweep: {name} {args.ncol}x{args.nlay} "
                  f"{args.angles} angle(s) shape {label}: {p.threads} "
                  f"threads, C = {p.slots}, S = {p.sets}, "
                  + (f"{p.shared_bytes} B shared" if p.shared
                     else "device staging")
                  + (f" + an LW slice of {p.slice_floats} floats per slot"
                     if p.split else "")
                  + f", {per_sm} blocks per SM | {ms:.3f} ms | bitwise "
                  f"equal to the default: {same} | {card}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
