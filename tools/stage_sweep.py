#!/usr/bin/env python3
"""Time the staged kernels (K1 csrc/lwsw.cu, K3 lw.cu, K4 sw.cu) over
block shapes on one CUDA card.

For each kernel at the protocol batch (65,536 x 60 by default; ``--nlay``
and ``--angles`` take comma-separated lists and sweep each pair,
``example_flux_batch`` on the synthetic ``--lw-kind`` (lw_fsck or
lw_rrtmgp) / sw_wide files, seed 7; on a model of more than one band the
emissivity is drawn per column and band, uniform in [0.9, 1.0], seed 7)
and each (blocks per SM, C columns per block, S sets of sweep warps) in
``--shapes``, builds the staging plan with ops/cuda/staged.py
``stage_plan`` (which fits the request to the card), launches the kernel
on it and times it with CUDA events (median of 10 after 2 warm-ups).  A
shape ``BxCxS+p`` asks for the parameter stage, ``BxCxS-p`` for none,
``BxCxS`` takes ``stage_plan``'s rule; then ``s`` asks for the split
route, ``w`` for whole columns, neither takes the rule; a last ``g2``
asks for one LW sweep warp per g-chunk of a band of two (``lw_warps``),
``g1`` for one warp an angle, neither takes the rule; ``--shapes ""``
times the default plan alone.  A shape that
cannot have the stage, route or LW warps it asks for is skipped with a
line that says so.  Each line gives the plan's report (``StagePlan.report``) and
the blocks per SM the card holds.  ``--dtype
float64`` runs the models and the batch in float64 (K1's double
instantiation; the plans at 8 B a word).  Every
shape's outputs must equal bit for bit those of the first shape timed
with its LW sweep warps an angle, the default's where they agree (a
column's arithmetic does not depend on the block it runs in; one LW warp
per g-chunk adds the chunks' level sums after the g-sum, where one warp
over both adds per lane before it); the script exits 1 if one does
not.  Shapes are timed in turns (default, the others, the
default again) so the spread of one call shows.  With ``--roles`` each
line of the merged kernel also gives its timed build's time
(ops/cuda/role_clock.py, the same plan; the two builds timed in turns),
whether its outputs equal the plain build's bit for bit (the script
exits 1 if not), and its warp
roles' wait shares: the optics warps' at FREE, the LW sweep warps' at
FULL and LW_DONE, the SW sweep warps' at FULL; and each sweep warp's
cycles a column (``role_clock.sweep_cycles``: the SW warp's, the LW
warps' by g-chunk).  ``--jac`` runs the merged kernel's Jacobian
instantiation (RTE's LW surface-temperature Jacobian as a fifth output,
one more accumulator row a slot in every plan).

Usage (on a machine with a card):
  python tools/stage_sweep.py [--kernels lw,sw,lwsw] [--angles 1,3]
      [--shapes 2x2x1,4x2x2,2x2x2+p,2x2x2-p,2x2x2s,2x2x2+psg1,...]
      [--ncol 65536]
      [--nlay 60,137] [--dtype float32|float64]
      [--lw-kind lw_fsck|lw_rrtmgp] [--roles] [--jac]
Prints one line per (kernel, shape) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import functools
import os
import re
import subprocess
import sys
import tempfile

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)


def roles_report(role_clock, core, prep, ncol, plan, out,
                 cuda_time_ms, rounds: int = 8) -> tuple:
    """(the merged kernel's timed build at ``plan`` against the plain
    build, whose outputs are ``out``, in words; whether its outputs equal
    ``out`` bit for bit).  The two builds are timed in turns (plain,
    timed, timed, plain, ...; ``rounds`` of 5 launches each), and each
    build's time is the median of its rounds."""
    import statistics
    import torch
    with role_clock.timed() as timing:
        got = core(*prep, ncol, plan=plan)
    lib = role_clock.library()
    runs = {None: [], lib: []}
    for r in range(rounds):
        for build in ((None, lib) if r % 2 == 0 else (lib, None)):
            runs[build].append(cuda_time_ms(
                lambda: core(*prep, ncol, plan=plan, lib=build),
                warmup=1, runs=5))
    role_clock.read(lib)
    ms, ms_t = (statistics.median(runs[b]) for b in (None, lib))
    same = all(torch.equal(g, o) for g, o in zip(got, out))
    s = timing.shares
    k = {r: "-" if c is None else f"{c / 1e3:.1f}" for r, c in
         role_clock.sweep_cycles(timing.record, ncol).items()}
    return (f" | in turns plain {ms:.3f} ms, timed build {ms_t:.3f} ms "
            f"({100 * (ms_t / ms - 1):+.2f} %), bitwise equal to the plain "
            f"build: {same}, wait shares: optics {s['optics']:.2f} %, "
            f"LW sweep {s['lw_sweep']:.2f} %, SW sweep "
            f"{s['sw_sweep']:.2f} %, sweep k cycles a column and warp: SW "
            f"{k['sw_sweep']}, LW g-chunk 0 {k['lw_chunk0']}, LW g-chunk 1 "
            f"{k['lw_chunk1']}"), same


def sweep(name, prep, core, shapes, limits, ncol, nlay, n_ang, card,
          cuda_time_ms, role_clock=None, jac: bool = False) -> bool:
    """Time kernel ``name`` on its prepared inputs ``prep`` at each shape
    of ``shapes`` (blocks per SM, C, S, the stage, the route and the LW
    sweep warps an angle asked for, the label)
    between two runs of the default plan, one line each; True iff every
    shape's outputs equal bit for bit those of the first plan run with
    the same LW sweep warps an angle.  With ``role_clock``
    (ops/cuda/role_clock.py) each merged-kernel line adds its timed
    build's report (``roles_report``), which must equal it too.  ``jac``:
    ``core`` runs the merged kernel's Jacobian instantiation, whose plans
    hold its row."""
    import torch
    from ecckd_tpu_torch.ops.cuda import staged
    atm = prep[0]
    lw_in, sw_in = {"lw": (prep[1], None), "sw": (None, prep[1]),
                    "lwsw": prep[1:]}[name]
    default = staged.plan_for(atm, lw_in, sw_in, jac)
    refs = {default.lw_warps: [o.clone() for o in core(*prep, ncol)]}
    head = (f"stage_sweep: {name} {ncol}x{nlay} {n_ang} angle(s) "
            f"{atm.tlay.dtype}{' jacobian' if jac else ''} shape")
    ok = True
    for shape in [None] + shapes + [None]:
        if shape is None:
            p, label = default, f"default {staged.SHAPES[name]}"
        else:
            label = shape[6]
            try:
                p = staged.stage_plan(
                    nlay, lw_in.plan.ngpt if lw_in else 0,
                    sw_in.plan.ngpt if sw_in else 0,
                    lw_in.n_gauss_angles if lw_in else 1,
                    staged.band_gases(lw_in.plan) if lw_in else (0, 0),
                    staged.band_gases(sw_in.plan) if sw_in else (0, 0),
                    *limits, blocks_per_sm=shape[0], max_slots=shape[1],
                    sets=shape[2], param_stage=shape[3],
                    word_bytes=atm.tlay.element_size(), split=shape[4],
                    lw_warps=shape[5], jac=jac)
            except ValueError as e:
                print(f"{head} {label}: skipped ({e})", flush=True)
                continue
        _, per_sm = staged.occupancy(atm, lw_in, sw_in, plan=p, jac=jac)
        out = core(*prep, ncol, plan=p)
        ref = refs.setdefault(p.lw_warps, [o.clone() for o in out])
        same = all(torch.equal(o, r) for o, r in zip(out, ref))
        ok = ok and same
        if not same:
            diff = max(float((o - r).abs().max() / r.abs().max())
                       for o, r in zip(out, ref))
            same = f"False (largest difference {diff:.3e} of a flux scale)"
        ms = cuda_time_ms(lambda: core(*prep, ncol, plan=p))
        roles = ""
        if role_clock is not None and name == "lwsw":
            roles, timed_same = roles_report(role_clock, core, prep, ncol,
                                             p, out, cuda_time_ms)
            ok = ok and timed_same
        print(f"{head} {label}: {p.report}; "
              + (f"{p.shared_bytes} B shared" if p.shared
                 else "device staging")
              + (f" + an LW slice of {p.slice_floats} floats per slot"
                 if p.split else "")
              + f"; the card holds {per_sm} blocks per SM"
              f" | {ms:.3f} ms | bitwise equal to the default: {same} | "
              f"{card}{roles}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/stage_sweep.py")
    ap.add_argument("--kernels", default="lw,sw,lwsw")
    ap.add_argument("--angles", default="1",
                    help="Gauss angles, comma-separated")
    ap.add_argument("--shapes", default="2x2x1,2x2x2,4x2x1,4x2x2,2x3x3,"
                    "2x4x2,2x4x4,1x4x4,4x1x1")
    ap.add_argument("--ncol", type=int, default=65536)
    ap.add_argument("--nlay", default="60",
                    help="layers, comma-separated")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--lw-kind", default="lw_fsck",
                    choices=("lw_fsck", "lw_rrtmgp"))
    ap.add_argument("--roles", action="store_true",
                    help="also time the merged kernel's timed build and "
                    "print its warp roles' wait shares")
    ap.add_argument("--jac", action="store_true",
                    help="run the merged kernel's Jacobian instantiation "
                    "(lwsw only)")
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
    from ecckd_tpu_torch.ops.cuda import lw, lwsw, plan, sw
    role_clock = None
    if args.roles:
        from ecckd_tpu_torch.ops.cuda import role_clock
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    models, dtype = {}, getattr(torch, args.dtype)
    with tempfile.TemporaryDirectory() as work:
        for key, kind in (("lw", args.lw_kind), ("sw", "sw_wide")):
            path = os.path.join(work, f"{key}.nc")
            write_synthetic_ckd(path, kind, seed=7)
            models[key] = load_ckd_model(path, dtype=dtype, device="cuda")
    props = torch.cuda.get_device_properties(0)
    limits = (props.shared_memory_per_block_optin,
              props.shared_memory_per_multiprocessor)
    shapes = []
    for spec in filter(None, args.shapes.split(",")):
        dims, sign, route, warps = re.fullmatch(
            r"(\d+x\d+x\d+)([+-]p)?([sw])?(?:g([12]))?", spec).groups()
        stage = None if sign is None else sign == "+p"
        split = None if route is None else route == "s"
        shapes.append((*(int(x) for x in dims.split("x")), stage, split,
                       None if warps is None else int(warps), spec))
    cores = {"lw": lw._kernel_core, "sw": sw._kernel_core,
             "lwsw": (functools.partial(lwsw._kernel_core, jac=True)
                      if args.jac else lwsw._kernel_core)}
    ok = True
    for nlay in (int(n) for n in str(args.nlay).split(",")):
        b = example_flux_batch(args.ncol, nlay, np.dtype(args.dtype),
                               device="cuda")
        t = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()
             if k != "concs"}
        emis = t["emis"][:, None].expand(-1, models["lw"].ngpt).contiguous()
        if models["lw"].nband > 1:
            gen = torch.Generator(device="cuda").manual_seed(7)
            banded = 0.9 + 0.1 * torch.rand(
                (args.ncol, models["lw"].nband), generator=gen,
                device="cuda", dtype=dtype)
            emis = models["lw"].gpt_weights_per_band(banded).contiguous()
        for n_ang in (int(a) for a in str(args.angles).split(",")):
            for name in args.kernels.split(","):
                if name == "sw" and n_ang != 1:
                    continue
                prep = {
                    "lw": lambda: plan.prepare_lw(
                        models["lw"], t["plev"], t["tlay"], t["tlev"],
                        t["tsfc"], emis, b["concs"], n_gauss_angles=n_ang),
                    "sw": lambda: plan.prepare_sw(
                        models["sw"], t["plev"], t["tlay"], b["concs"],
                        t["alb"], t["tsi"], t["sza"]),
                    "lwsw": lambda: plan.prepare(
                        models["lw"], models["sw"], t["plev"], t["tlay"],
                        t["tlev"], t["tsfc"], emis, b["concs"], t["alb"],
                        t["tsi"], t["sza"], n_gauss_angles=n_ang)}[name]()
                if args.jac and name != "lwsw":
                    continue
                ok = sweep(name, prep, cores[name], shapes, limits,
                           args.ncol, nlay, n_ang, card,
                           cuda_time_ms, role_clock, args.jac) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
