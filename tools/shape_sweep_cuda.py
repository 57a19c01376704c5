#!/usr/bin/env python3
"""On-card depth sweep of the port's main path -> SHAPES_CUDA.json.

The port's counterpart of tools/shape_sweep_chip.py.  The merged kernel's
staging follows the atmosphere's depth (ops/cuda/staged.py stage_plan:
threads per block, C columns staged per block, S sets of sweep warps,
shared or device memory); this tool runs the shipped execution mode,
``capture.jit(pipeline.lw_sw_fluxes)`` with ``backend="cuda"`` and the
models passed as arguments, at the depths real NWP and climate grids use,
``SHAPES``: 30 (coarse climate), 47 (MERRA-2), 60 (RFMIP / CKDMIP), 91
and 137 (ECMWF L91 / L137), each at an odd column count for parity, and
at 1 and 3 LW Gauss angles.  Per (depth, angles) leg:

* parity: the captured call (eager, capture, replay) on the adversarial
  batch of tools/cuda_parity.py against ``lwsw_fluxes_plain`` at float64
  on the card (``bench_cuda.hold``): max|d| / flux scale per output
  <= 5e-5; in the fast mode <= 5e-5 from the fast plain version and
  <= 5e-4 and > 0 from the exact one.  The same check again after the
  timed window, on the last replay at the timed shape
  (``bench_cuda.timed_batch``'s columns);
* columns/s and column-layers/s at ``NCOL_TIME`` columns
  (``bench_cuda.time_steps``: the steps' scalars summed on the card, one
  read as the barrier; best of ``--epochs`` epochs, the angle legs of a
  depth interleaved);
* the kernel alone (CUDA events, chip_smoke.cuda_time_ms) beside its
  bound (chip_smoke.kernel_bound) and its share of it;
* the staging plan (``staged.occupancy``: C, S, threads, blocks per SM
  from the card's occupancy calculator, shared bytes or device staging,
  the parameter stage);
* ``first_call_seconds``: the first two calls at the timed shape (the
  eager warm-up and the capture), with the library already built; the
  build's seconds are recorded once, when this run built it.

``--fast`` runs the fast table mode.  The mode in effect picks the bounds
and the artifact: SHAPES_CUDA.json (exact) or SHAPES_CUDA_FAST.json
(fast), so a fast record can never take the exact one's name.  Only a
run at ``NCOL_TIME`` writes it; the record names the card and its power
limit.  Exit 1 if any leg is outside its bounds.  Without a card the tool
raises.  The ckd files are synthetic (ecckd_tpu_torch.io.synthetic, seed
7) at the shipped files' dimensions.  This tool imports nothing of JAX.

Usage:  python tools/shape_sweep_cuda.py [--fast] [--angles 1,3]
            [--ncol 65536] [--iters 10] [--epochs 4] [--out PATH]
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

# (nlay, parity ncol): tools/shape_sweep_chip.py's depths and column counts.
SHAPES = [(30, 293), (47, 331), (60, 293), (91, 275), (137, 261)]
NCOL_TIME = 65536
PARITY_SEED = 293


def artifact(mode: str) -> str:
    """The artifact of a run in table mode ``mode``."""
    from ecckd_tpu_torch import config
    return "SHAPES_CUDA_FAST.json" if config.is_fast(mode) \
        else "SHAPES_CUDA.json"


def bounds(mode: str) -> dict:
    """A leg's bounds in table mode ``mode`` (tools/cuda_parity.py): from
    the plain version of the same mode, and in the fast mode from the
    exact one (where it must also be > 0)."""
    from ecckd_tpu_torch import config
    from tools import cuda_parity
    out = {"same_mode": cuda_parity.SAME_MODE_BOUND}
    if config.is_fast(mode):
        out["vs_exact"] = cuda_parity.BOUNDS[mode]
    return out


def card() -> str:
    """nvidia-smi's name and power limit of the card; raises without
    one (a CPU number must never pass as the card's)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("shape_sweep_cuda: no CUDA card "
                           "(torch.cuda.is_available() is false)")
    from ecckd_tpu_torch.utils.profiling import card_name
    return card_name()


def judge(leg: dict, mode: str) -> bool:
    """Whether a leg is inside its bounds (a NaN error is not)."""
    b = bounds(mode)
    for r in (leg["parity"], leg["parity_timed"]):
        if not r["max_rel"] <= b["same_mode"]:
            return False
        if "vs_exact" in b and not 0.0 < r["vs_exact"] <= b["vs_exact"]:
            return False
    return leg["columns_per_sec"] > 0


def sweep(shapes=SHAPES, angles=(1, 3), ncol_time: int = NCOL_TIME,
          iters: int = 10, epochs: int = 4) -> dict:
    """Every (depth, angles) leg on the card in the current table mode:
    {"nlay<n>_ncol<m>": {"nlay", "parity_ncol", "angles": {"<a>": leg}}}
    (the module docstring lists a leg's fields)."""
    import torch
    import bench_cuda
    import chip_smoke
    from ecckd_tpu_torch import capture, config, pipeline
    from ecckd_tpu_torch.ops.cuda import lwsw, plan, staged
    from tools import cuda_parity
    device, _ = bench_cuda.card()
    _, _, models32, models64 = bench_cuda.on_the_card()
    lw32, sw32 = models32["fsck"], models32["wide"]
    lw64, sw64 = models64["fsck"], models64["wide"]
    jitted = capture.jit(pipeline.lw_sw_fluxes)
    chunk = bench_cuda.COLUMN_CHUNK
    out = {}
    for nlay, pcol in shapes:
        arrays, gases = cuda_parity.adversarial_batch(pcol, nlay, PARITY_SEED)
        b32, b64 = (cuda_parity.on_card(arrays, gases, dt, lw32.ngpt, device)
                    for dt in (torch.float32, torch.float64))
        b32["emis"] = b32["emis_col"]
        b = bench_cuda.batch(ncol_time, nlay, np.float32, device)
        emis = b["emis"][:, None].expand(-1, lw32.ngpt).contiguous()
        idx, t64 = bench_cuda.timed_batch(b, ncol_time)
        t64["emis"] = t64["emis"][:, None].expand(-1, lw32.ngpt)
        legs, cases = {}, {}
        for ang in angles:
            name = f"nlay{nlay}_{ang}ang"
            case = bench_cuda.Case(jitted, (lw32, sw32),
                                   {"n_gauss_angles": ang,
                                    "column_chunk": chunk})
            plain = lambda bb, ang=ang: lambda mode: cuda_parity.solve(
                "lwsw", "plain", lw64, sw64, bb, n_gauss_angles=ang,
                mxu_mode=mode)
            gate = bench_cuda.hold(name, "gate",
                                   [case(b32) for _ in range(3)], plain(b64))
            t0 = time.perf_counter()
            case.step(b).item()            # eager warm-up
            case.step(b).item()            # capture (and its replay)
            first = time.perf_counter() - t0
            prep = plan.prepare(lw32, sw32, b["plev"], b["tlay"], b["tlev"],
                                b["tsfc"], emis, b["concs"], b["alb"],
                                b["tsi"], b["sza"], ang, config.is_fast())
            stage, per_sm = staged.occupancy(*prep)
            kernel_ms = chip_smoke.cuda_time_ms(
                lambda: lwsw._kernel_core(*prep, chunk))
            bound = chip_smoke.kernel_bound(prep)
            del prep
            legs[str(ang)] = {
                "parity": gate, "first_call_seconds": first,
                "kernel_ms": kernel_ms, "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"],
                "share": bound["bound_ms"] / kernel_ms,
                "plan": {"C": stage.slots, "S": stage.sets,
                         "threads": stage.threads, "blocks_per_sm": per_sm,
                         "staging": stage.route,
                         "param_stage": stage.prm_stage,
                         "shared_bytes": stage.shared_bytes,
                         "bytes_per_column": stage.bytes_per_column}}
            cases[ang] = (case, plain)
        # Interleaved epochs: drift between windows hits both angles alike.
        best = dict.fromkeys(angles, float("inf"))
        for _ in range(epochs):
            for ang, (case, _) in cases.items():
                best[ang] = min(best[ang], bench_cuda.time_steps(
                    lambda: case.step(b), iters, 0))
        for ang, (case, plain) in cases.items():
            leg = legs[str(ang)]
            timed = bench_cuda.hold(f"nlay{nlay}_{ang}ang", "timed",
                                    [[o[idx] for o in case(b)]], plain(t64))
            timed["columns"] = int(idx.numel())
            cols = ncol_time / best[ang]
            leg.update(parity_timed=timed, seconds_per_step=best[ang],
                       columns_per_sec=cols, col_layers_per_sec=cols * nlay)
            p = leg["plan"]
            print(f"  nlay={nlay:3d} ang={ang}: parity "
                  f"{leg['parity']['max_rel']:.3e} / timed "
                  f"{timed['max_rel']:.3e}, {cols / 1e6:.3f}M cols/s "
                  f"({cols * nlay / 1e6:.1f}M col-layers/s), kernel "
                  f"{leg['kernel_ms']:.3f} ms (bound {leg['bound_ms']:.4f}"
                  f" ms, share {leg['share']:.3f}), C = {p['C']} S = "
                  f"{p['S']} {p['threads']} threads x {p['blocks_per_sm']} "
                  f"per SM ({p['staging']}), first call "
                  f"{leg['first_call_seconds']:.2f} s", file=sys.stderr,
                  flush=True)
        out[f"nlay{nlay}_ncol{pcol}"] = {"nlay": nlay, "parity_ncol": pcol,
                                         "angles": legs}
        del b, cases
    return out


def main(argv=None, out_dir: str = _REPO_ROOT) -> int:
    ap = argparse.ArgumentParser(prog="tools/shape_sweep_cuda.py")
    ap.add_argument("--out", default=None,
                    help="the artifact (default: the mode's, in the "
                         "repository root)")
    ap.add_argument("--angles", default="1,3")
    ap.add_argument("--fast", action="store_true",
                    help="the fast table mode (bf16 tables) -> "
                         "SHAPES_CUDA_FAST.json")
    ap.add_argument("--ncol", type=int, default=NCOL_TIME,
                    help="timed columns (only NCOL_TIME writes the "
                         "artifact)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args(argv)
    angles = tuple(int(a) for a in args.angles.split(","))
    import torch
    from ecckd_tpu_torch import config
    from ecckd_tpu_torch.ops.cuda import build
    label = card()
    previous = config.mxu_precision()
    mode = "bf16" if args.fast else previous
    built = not build.library_path("lwsw").is_file()
    t0 = time.perf_counter()
    build.build("lwsw")
    build_s = time.perf_counter() - t0 if built else None
    config.set_mxu_precision(mode)
    try:
        shapes = sweep(angles=angles, ncol_time=args.ncol, iters=args.iters,
                       epochs=args.epochs)
    finally:
        config.set_mxu_precision(previous)
    ok = all(judge(leg, mode) for s in shapes.values()
             for leg in s["angles"].values())
    record = {"generated_by": "tools/shape_sweep_cuda.py",
              "date": datetime.date.today().isoformat(), "device": label,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "path": "capture.jit(pipeline.lw_sw_fluxes), backend cuda",
              "anchor": "lwsw_fluxes_plain, float64, on the card",
              "mxu_precision": mode, "bounds": bounds(mode),
              "ncol_timing": args.ncol,
              "column_chunk": 65536, "angles": list(angles),
              "iters": args.iters, "epochs": args.epochs,
              "build_seconds": build_s, "pass": ok, "shapes": shapes}
    path = args.out or os.path.join(out_dir, artifact(mode))
    if args.ncol == NCOL_TIME or args.out:
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    else:
        path = "not written (off protocol)"
    print(json.dumps({k: v for k, v in record.items() if k != "shapes"}))
    print(f"shape sweep: {'PASS' if ok else 'FAIL'} -> {path}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
