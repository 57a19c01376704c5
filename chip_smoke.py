#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (ecckd_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero and no
result line is printed:

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit.
2. build: compiles csrc/lwsw.cu, lw.cu and sw.cu (the staged body of
   csrc/staged.cuh with both bands, the LW band, the SW band) with nvcc
   from this checkout, one nvcc each, all at once (timed; ptxas
   registers, spills and barriers); each library holds the exact and the
   fast instantiations, and both entry points are bound.  Phase 15's
   checked builds (ops/cuda/ring_check.py) start at the same time.
3. models: writes the synthetic ckd files (shipped dimensions, values from
   a seed): lw_fsck, lw_rrtmgp (36 g-points), sw_wide, their
   negative-entry variants and sw_wide on a 47-point pressure grid, and
   loads them with the port's loader.  Then, for phase 2's kernels, their
   staging plans (ops/cuda/staged.py stage_plan: bytes per column, C
   columns per block, the dynamic shared memory per block or device
   staging, threads) and the blocks per SM of the CUDA occupancy
   calculator (ecckd_<name>_occupancy): K1 for the main path, 3 angles,
   lw_rrtmgp and nlay 300; K3 and K4 for their main paths, K3 at 3 angles
   and on lw_rrtmgp, K4 on sw_p47, and both at the depth they stage in
   device memory (nlay 600 and 430).
4. parity: each kernel (float32) against its plain PyTorch version at
   float64 on the card, case by case (tools/cuda_parity.py's CASES and
   run_case): max|d| / flux scale <= 5e-5 per output.  The merged kernel
   (K1/K2): RFMIP 1800 x 60, nlay 1/2/8/137, nlay 300 at 1 and 3 angles
   (staged in device memory), 2-4 Gauss angles, a chunked launch, the
   negative-entry pair, lw_rrtmgp with sw_wide at 1 and 3 angles.  The
   LW kernel (K3) and the SW kernel (K4): RFMIP
   1800 x 60, nlay 1/2/8/137, a chunked launch, the negative-entry models,
   the depth each stages in device memory (K3 nlay 600 at 1 and 3
   angles, K4 nlay 430); K3 also at 2-4 angles and on lw_rrtmgp at 1, 3
   and 4 angles, K4 on the 47-point grid.  Each kernel also on a gas set
   without cfc11, cfc12 and n2o: band shapes other than the shipped ones,
   which run the kernels' run-time instantiations in shared memory.  The
   pair on two grids through lw_sw_fluxes(backend="cuda") must launch K3
   and K4 and not K1.
5. shared code: on one mergeable batch, K3's LW and K4's SW outputs
   against K1's (the same per-(layer, g) arithmetic, csrc/common.cuh;
   K1 sums over g-points in another order): <= 5e-5 of the flux scale,
   and whether they are equal bit for bit.
6. main paths at the 65,536 x 60 protocol batch, each driven with the
   launch counts set to 0 just before and read just after:
   pipeline.lw_sw_fluxes, lw_fluxes and sw_fluxes (backend="auto").  The
   kernel's count must grow from 0, outputs be finite, SW TOA down equal
   mu0 * TSI by day and 0 by night, and the first columns match the
   float64 plain version.  Then lw_sw_fluxes(auto) on the same batch in
   float64: K1's double instantiation, ``lwsw_f64`` launches equal to
   ceil(ncol / column_chunk) and no other count, float64 outputs, the
   first columns within 1e-10 of the flux scale of the plain version with
   float64's constants (compute=float64), which the float32 kernel's
   outputs must exceed, SW TOA down mu0 * TSI by day and 0 by night.
   Then lw_sw_fluxes(auto, flux_up_jac=True) at l91_jac_batch's launch,
   65,536 x 91: K1's Jacobian instantiation, ``lwsw_jac`` launches equal
   to ceil(ncol / column_chunk) and no other count, J > 0 everywhere, the
   first columns' J within 1e-5 of the largest |J| of the plain version's
   at float64 (``lwsw_fluxes_plain(..., flux_up_jac=True)``) and its
   fluxes within the flux bound, and bit for bit those of K1's plain
   instantiation on the same batch.
7. RFMIP drivers at the reference's size, 100 sites x 18 experiments x 60
   layers (1800 columns): ecckd_rfmip_lw, ecckd_rfmip_sw and ecckd_rfmip
   main([...]) with --device cuda on a synthetic RFMIP file, each with the
   counts set to 0 before and read after; K3, K4 and K1 must have run and
   no fast or f64 entry point, the files (read and written by the native
   netCDF3 engine, as --metrics-json records) be finite and match the
   float64 plain version, SW TOA down equal mu0 * TSI by day and 0 by
   night, and the combined driver's files match the separate drivers'.
8. times: each kernel and its plain float32 version at 65,536 x 60 (and
   the kernels at 1800 x 60, K3 + K4 against K1 at both sizes) with CUDA
   events (warm-up, median of 10), with and without host prep, beside the
   card's name and power limit; each kernel's bound (``kernel_bound``:
   bytes over the HBM rate or float operations over the f32 peak, the
   larger) and its share of it.  Then, each with bound and share, at
   65,536 columns: K3 on lw_rrtmgp and at 3 angles (with its plain f32
   version), K4 on sw_p47, K1 at 3 and 4 angles (K2), on lw_rrtmgp and
   at nlay 137.  K1's double instantiation at 65,536 x 60 with its plain
   float64 version and its bound at the f64 peak (34 TFLOP/s, its
   bytes at 8 B a value).  K1's Jacobian instantiation at 65,536 x 91,
   beside K1 without it on the same batch, with its plain float32 version
   and its bound (the Jacobian's work added, as ``lwsw_jac_roofline``
   counts it).
9. stream: cli/scale_bench.main at full width, 1,048,576 x 60 in chunks of
   65,536, full outputs, over every local card: the base chunk placed
   over the cards once, each chunk built on every card from its resident
   piece, the step captured per card (utils/capture.jit), each card's
   outputs copied into their rows of one pinned host buffer.  A checking
   pass (one streamed pass) holds every chunk finite and the first 2048
   columns of chunks 0 and 15 against the float64 plain version, with
   the counts set to 0 before and read after: the merged kernel exactly
   once per step call per card (every chunk, the compute reference's
   steps and the warm-ups), K3 and K4 never.  The same chunks on one card
   (--no-shard) and split into three pieces on card 0 (the last one
   padded) must equal its chunks bit for bit.  The measuring pass (best
   of 4 interleaved rounds) counts the same way and prints the number of
   cards, columns/s, the compute reference (the captured step on every
   card's resident piece, no join, no D2H), the overlap efficiency and
   the per-phase host budget; with fewer than four cards it prints that
   four were not measured.  Then toa-net outputs, and a journaled run at
   262,144 columns, two chunks zeroed in the journal and the files, and
   --resume: the files must equal the first run's bit for bit.
10. column split: ecckd_rfmip through the split over the local cards
   against --no-shard (files bitwise equal, merged kernel launched); then
   a one-rank NCCL process group and mesh.distributed_columns_call against
   the single call (bitwise), and the group destroyed.
11. profiling and gradients: utils/profiling.trace around an eager and a
   replayed (utils/capture.jit) lw_sw_fluxes(auto) call at 65,536 x 60
   and 1800 x 60, each the second of two calls under the profiler: the
   trace must name the merged kernel; prints the device time, the share
   of the call the card was idle, when its first device event starts and
   the CUDA runtime calls in it.  lw_fluxes(auto) on float32 CUDA
   tensors with tlay requiring grad launches no kernel and
   back-propagates finite gradients; backend="cuda" and lw_fluxes_cuda
   raise.
12. fast mode (config.set_mxu_precision("bf16"), --fast): each kernel's
   fast entry point at f32 against the fast plain version at f64 on phase
   4's cases, the deep columns included (<= 5e-5), and against the exact
   plain f64 (<= 5e-4, > 0);
   lw_sw_fluxes, lw_fluxes and sw_fluxes (auto) at 65,536 x 60 in the fast
   mode, and ecckd_rfmip{,_lw,_sw} --fast at 100 x 18 x 60, each with the
   counts set to 0 before and read after: the fast entry points ran and
   the exact ones did not.  Times each fast kernel and its plain version at
   65,536 x 60, and the exact kernels again, interleaved (exact, fast,
   fast, exact), after the fast path has run.
13. captured calls: utils/capture.jit of lw_sw_fluxes (K1, K2 at 3
   angles, K1 at nlay 300 in device staging), lw_fluxes (K3) and
   sw_fluxes (K4) at 65,536 x 60 and 1800 x 60, exact and then fast mode
   (K5) on one jitted function, and lw_sw_fluxes at 65,536 x 60 in float64
   (K1's double instantiation, counted under ``lwsw_f64``): warm-up,
   capture and replays equal the eager call bit for bit, on the first
   inputs and on new ones (other tlay, tsfc and sza, night columns among
   them); each call returns fresh tensors and leaves earlier ones
   unchanged; each call's launch counts equal the eager call's, in the
   mode's counter only; a mode switch captures anew.  Times the eager
   wrapper, the captured call and the kernel alone (CUDA events, median
   of 10), and scale_bench's step eager against captured.  Inputs that
   require grad must raise, and so must a capture of a function that
   reads the card back.
14. the bench: bench_cuda.main off its protocol, into a scratch
   directory, each with the counts set to 0 before and read after: the
   headline at 65,536 x 60 and configs at 8192 x 60, each exact and
   --fast, so its gate runs over the headline and all six configurations
   in both table modes, and its check after the timed window over every
   case at the timed shape; then cpu_baseline at 256 columns.  Each line
   must parse, values be > 0, parity_ok hold, every timed case be held
   after its window (parity_timed), the card be named, the mode's
   kernel entry points have run and no other, and nothing be written to
   the scratch directory or the repository root.  Prints the lines.

15. depth sweep and ring check: tools/shape_sweep_cuda.py's legs (nlay
   30, 47, 60, 91 and 137, at 1 and 3 angles, capture.jit of
   lw_sw_fluxes) in both table modes, timed at 16,384 columns: parity on
   the adversarial batch and again after the timed window within the
   sweep's bounds, columns/s > 0, each leg's staging plan; then the
   kernels' checked build (tools/cuda_sanitize.py --checked, built with
   phase 2's) over K1, K3 and K4 at nlay 60 and 137 at 1 angle and K1
   and K3 at 3 angles, both table modes, and K1's double instantiation
   over tools/cuda_sanitize.py's CHECKED_F64 (every f64 staging regime),
   and K1's Jacobian instantiation at nlay 91 and 137 (``RING_JAC``),
   at jitter 0 and one seed: no violation, finite outputs bit for bit
   equal to the plain build's; and the planted faults in K1, at float32
   and over CHECKED_F64, which the checker must report.  One
   line per leg and the phase's seconds.

The last two lines are the kernels' JSON record (exact and fast entries,
K1's double instantiation ``lwsw_f64`` and its Jacobian instantiation
``lwsw_jac``, each with its launches, time and bound) and
{"ok": true, "device": {...}}.  This script imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

BOUND = 5e-5            # max|d| / flux scale, per output (tools/chip_parity.py)
F64_BOUND = 1e-10       # the f64 kernel against the plain version at float64
FAST_BOUND = 5e-4       # the fast mode against the exact plain version
PROTOCOL = (65536, 60)  # BENCH_CONFIGS protocol batch (columns, layers)
RFMIP = (100, 18, 60)   # the reference's RFMIP workload (sites, expts, layers)
STREAM = 1_048_576      # scale_bench's default million-column run
DEEP = {"lw": 600, "sw": 430}  # depths K3 / K4 stage in device memory
SWEEP_NCOL = 16384      # phase 15's timed columns per sweep leg
RING_CHECKED = ([(k, n, 1) for k in ("lwsw", "lw", "sw") for n in (60, 137)]
                + [(k, n, 3) for k in ("lwsw", "lw") for n in (60, 137)])
RING_PLANT = [("lwsw", 60, 1), ("lwsw", 137, 1)]
RING_WIDE = [("lwsw", 60, 1), ("lw", 60, 1)]  # on lw_rrtmgp's 36 g-points
RING_JAC = [("lwsw", 91, 1), ("lwsw", 137, 1)]  # K1's Jacobian instantiation
JAC_SHAPE = (65536, 91)  # l91_jac_batch's launch (columns, layers)
JAC_BOUND = 1e-5        # K1's J against the plain f64 J, of its largest |J|
# The Jacobian's operations (radbench/metrics/lwsw_jac_roofline.py): per
# (column, LW g-point) the surface's Planck difference and emissivity
# product, per (column, level, LW g-point, angle) the recurrence and its
# g-sum.
JAC_OPS = dict(surface=12 + 2, level=1 + 1)
KERNELS = {  # name: (source, TPU kernel it replaces)
    "lwsw": ("ecckd_tpu_torch/csrc/lwsw.cu",
             "ecckd_tpu/ops/pallas/lwsw.py:61"),
    "lw": ("ecckd_tpu_torch/csrc/lw.cu", "ecckd_tpu/ops/pallas/lw.py:54"),
    "sw": ("ecckd_tpu_torch/csrc/sw.cu", "ecckd_tpu/ops/pallas/sw.py:39"),
}


PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (700 W)
PEAK_F64_FLOPS = 34e12  # H100 SXM, f64 outside the tensor cores (700 W)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
# Float operations of the kernels' arithmetic, counting an add, multiply,
# compare or select as 1 (an FMA as 2) and each accurate library call at
# the operations of its CUDA implementation: expm1f 20, logf 15, a
# division 8, sqrtf 6.  Per g-point: a dense gas 12 (bilinear 9, weight,
# clamp, sum), a LUT gas 25, a Planck value 12, the LW layer sources 42,
# one LW sweep step pair (down, up, their g-sums) 6, the SW Rayleigh sum
# and two-stream 136, the SW direct / adding sweeps 43.  Per layer,
# independent of g: the interpolation point 41, a dense gas weight 3, a
# LUT index 30, a Planck point 12.
OPS = dict(dense=12, lut=25, planck=12, lw_sources=42, lw_sweep=6,
           sw_optics=136, sw_sweep=43, point=41, dense_w=3, lut_w=30,
           planck_point=12)


def kernel_bound(prep, jac: bool = False) -> dict:
    """The least time the card could take for one kernel call on the
    prepared inputs ``prep`` (plan.prepare / prepare_lw / prepare_sw):
    the larger of the bytes it must move (each input read once, each
    output written once, the tables once) over the HBM rate, and the
    float operations the function needs (``OPS``, on this call's gases,
    g-points, layers and angles) over the peak of the inputs' precision
    (f32, or f64 for the double instantiation; bytes at the inputs'
    element size, the outputs' too).  The count is the
    function's, the same for every kernel: per (layer, g-point) 2 Planck
    values (nlay layer values and nlay + 1 level values per column, the
    surface's within the rounding) and one set of LW layer sources per
    angle, however often a kernel recomputes them.  ``jac``: the merged
    kernel's Jacobian instantiation, with the Jacobian's operations
    (``JAC_OPS``) and one more output."""
    import torch
    from ecckd_tpu_torch.ops.cuda import staged
    atm, bands = prep[0], prep[1:]
    ncol, nlay = atm.tlay.shape
    tensors = [atm.plev, atm.tlay, atm.vmr_prof, atm.vmr_col]
    per_layer = OPS["point"]
    per_lg = 0
    for band in bands:
        nd, nl = staged.band_gases(band.plan)
        gas = nd * OPS["dense"] + nl * OPS["lut"]
        per_layer += nd * OPS["dense_w"] + nl * OPS["lut_w"]
        arr = band.arrays
        tensors += [arr.table, arr.t_first]
        if hasattr(band, "tlev"):           # LW
            n_ang = band.n_gauss_angles
            per_layer += 2 * OPS["planck_point"]
            tensors += [band.tlev, band.tsfc, band.emis, arr.planck_function]
            sweeps = n_ang * (OPS["lw_sources"] + OPS["lw_sweep"])
            per_lg += band.plan.ngpt * (gas + 2 * OPS["planck"] + sweeps)
        else:                               # SW
            tensors += [band.alb, band.mu0, band.tsi_scale, arr.solar,
                        arr.rayleigh]
            per_lg += band.plan.ngpt * (gas + OPS["sw_optics"]
                                        + OPS["sw_sweep"])
    n_out = 2 * len(bands) + int(jac)
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + n_out * ncol * (nlay + 1) * atm.tlay.element_size())
    ops = ncol * nlay * (per_layer + per_lg)
    if jac:
        lw_band = bands[0]
        ops += ncol * lw_band.plan.ngpt * (
            JAC_OPS["surface"]
            + (nlay + 1) * lw_band.n_gauss_angles * JAC_OPS["level"])
    peak = (PEAK_F64_FLOPS if atm.tlay.dtype == torch.float64
            else PEAK_F32_FLOPS)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "ops": ops, "bytes": nbytes}


def cuda_time_ms(fn, warmup: int = 2, runs: int = 10) -> float:
    """Median of ``runs`` CUDA-event timings of fn() after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli(main_fn, argv, **kw):
    """(return code, last stdout line) of a CLI's main(argv); its stdout is
    captured, not printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv, **kw)
    lines = buf.getvalue().strip().splitlines()
    return rc, (lines[-1] if lines else "")


def busy_idle(events, t0: float, t1: float):
    """(device-busy microseconds, idle share) of [t0, t1] from a Chrome
    trace's device events (the union of their intervals)."""
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in events)
    busy, end = 0.0, t0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy, 1.0 - busy / (t1 - t0)


def trace_call(drive, trace_dir: str):
    """Trace two calls of ``drive()`` (utils/profiling.trace), the second
    in a span named "call": the first takes the profiler's own first-call
    costs.  None if the trace names no lwsw_kernel or has no span; else
    the span to the last device event (ms), the device time, its kernels
    and lwsw_kernel's part, the device-busy time, the idle share of the
    span, when the first device event starts after the span does, and
    the CUDA runtime calls in the span (name, count, ms), most time
    first."""
    import torch
    from ecckd_tpu_torch.utils import profiling
    with profiling.trace(trace_dir):
        drive()
        torch.cuda.synchronize()
        with torch.profiler.record_function("call"):
            drive()
        torch.cuda.synchronize()
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device_ev = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    kernel_ev = [e for e in device_ev if e.get("cat") == "kernel"]
    lwsw_ev = [e for e in kernel_ev if "lwsw_kernel" in e["name"]]
    span = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == "call"]
    if not (lwsw_ev and span):
        return None
    t0 = span[0]["ts"]
    t1 = max([t0 + span[0]["dur"]] + [e["ts"] + e["dur"] for e in device_ev
                                      if e["ts"] >= t0])
    device_ev = [e for e in device_ev if e["ts"] >= t0]
    kernel_ev = [e for e in kernel_ev if e["ts"] >= t0]
    lwsw_ev = [e for e in lwsw_ev if e["ts"] >= t0]
    busy, idle = busy_idle(device_ev, t0, t1)
    runtime = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and t0 <= e["ts"] < t1:
            n, us = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, us + e["dur"])
    return {"name": lwsw_ev[0]["name"] if lwsw_ev else "",
            "call_ms": (t1 - t0) / 1e3,
            "device_ms": sum(e["dur"] for e in kernel_ev) / 1e3,
            "kernels": len(kernel_ev),
            "lwsw_ms": sum(e["dur"] for e in lwsw_ev) / 1e3,
            "busy_ms": busy / 1e3, "idle": idle,
            "lead_ms": (min(e["ts"] for e in device_ev) - t0) / 1e3
            if device_ev else float("nan"),
            "runtime": sorted(((k, n, us / 1e3) for k, (n, us)
                               in runtime.items()), key=lambda r: -r[2])}


def main() -> int:
    import torch
    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("device: FAIL torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ecckd_tpu_torch.utils.profiling import card_name
    card = card_name()
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)
    with tempfile.TemporaryDirectory() as work:
        return run(card, work)


def run(card: str, work: str) -> int:
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from ecckd_tpu_torch import pipeline
    from ecckd_tpu_torch.cli import (ecckd_rfmip, ecckd_rfmip_lw,
                                     ecckd_rfmip_sw)
    from ecckd_tpu_torch.cli.common import build_gas_concs
    from ecckd_tpu_torch.gases import GasConcs
    from ecckd_tpu_torch.io.rfmip import (read_fluxes, read_rfmip,
                                          write_synthetic_rfmip)
    from ecckd_tpu_torch.io.synthetic import (example_flux_batch,
                                              write_synthetic_ckd)
    from ecckd_tpu_torch.models.loader import load_ckd_model
    from ecckd_tpu_torch.ops.cuda import (binding, build, common, lw, lwsw,
                                          plan, staged, sw)
    from tools import cuda_parity
    from tools.cuda_parity import flux_errors, on_card, solve
    wrappers = {"lwsw": lwsw.lwsw_fluxes_cuda, "lw": lw.lw_fluxes_cuda,
                "sw": sw.sw_fluxes_cuda}
    modules = {"lwsw": lwsw, "lw": lw, "sw": sw}

    def reset_counts():
        for w in wrappers.values():
            w.launches = w.fast_launches = 0
        lwsw.lwsw_fluxes_cuda.f64_launches = 0
        lwsw.lwsw_fluxes_cuda.jac_launches = 0

    def counts():
        # launches per entry point: exact ("lwsw"), fast ("lwsw_fast"),
        # the merged kernel's double instantiation ("lwsw_f64") and its
        # Jacobian instantiation in either table mode ("lwsw_jac")
        out = {k: w.launches for k, w in wrappers.items()}
        out.update({f"{k}_fast": w.fast_launches
                    for k, w in wrappers.items()})
        out["lwsw_f64"] = lwsw.lwsw_fluxes_cuda.f64_launches
        out["lwsw_jac"] = lwsw.lwsw_fluxes_cuda.jac_launches
        return out

    # ---- 2. build: one nvcc per kernel source, all started together -------
    # (with phase 15's checked builds, which are waited for there)
    from ecckd_tpu_torch.ops.cuda import ring_check
    from tools import cuda_sanitize, shape_sweep_cuda
    checked_builds = ([(k, ring_check.defines()) for k in KERNELS]
                      + [("lwsw", ring_check.defines(plant))
                         for plant in cuda_sanitize.PLANTS])
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(KERNELS) + len(checked_builds))
    checked_jobs = [pool.submit(build.build, *job) for job in checked_builds]
    lib_paths = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    for name in modules:
        # binds both entry points and checks the struct
        binding.library(name)
    build_s = time.perf_counter() - t0
    for name, path in lib_paths.items():
        ptxas = [ln.strip() for ln in open(f"{path}.ptxas.txt")
                 if "registers" in ln or "spill" in ln]
        print(f"build: ok {name} {os.path.relpath(path)} | "
              + " | ".join(ptxas), flush=True)
    print(f"build: ok 3 kernels (exact and fast entry points each) in "
          f"{build_s:.2f} s (parallel nvcc, beside phase 15's "
          f"{len(checked_builds)} checked builds)", flush=True)

    # ---- 3. models --------------------------------------------------------
    models, paths = {}, {}
    for key, kind, neg, n_p in cuda_parity.SYNTHETIC:
        paths[key] = os.path.join(work, f"{key}.nc")
        write_synthetic_ckd(paths[key], kind, seed=7, negative_entry=neg,
                            n_pressure=n_p)
        for dt in (torch.float32, torch.float64):
            models[key, dt] = load_ckd_model(paths[key], dtype=dt,
                                             device="cuda")
    m32 = lambda k: models[k, torch.float32]
    m64 = lambda k: models[k, torch.float64]
    lw32, sw32 = m32("lw"), m32("sw")
    print(f"models: ok lw_fsck ngpt={lw32.ngpt} nband={lw32.nband} "
          f"planck={lw32.planck_function.shape[0]} | lw_rrtmgp "
          f"ngpt={m32('lw_rrtmgp').ngpt} nband={m32('lw_rrtmgp').nband} | "
          f"sw_wide ngpt={sw32.ngpt} nband={sw32.nband} | grid "
          f"{tuple(lw32.temperature_grid.shape)} mergeable="
          f"{plan.models_mergeable(lw32, sw32)} | sw_p47 grid "
          f"{tuple(m32('sw_p47').temperature_grid.shape)} mergeable="
          f"{plan.models_mergeable(lw32, m32('sw_p47'))}", flush=True)

    # The staging plans and the card's occupancy for them (the builds of
    # phase 2, on the models just loaded): K1 on the main path, at 3
    # angles, on lw_rrtmgp and on columns too deep for shared memory; K3
    # and K4 on their main paths, K3 at 3 angles and on lw_rrtmgp, K4 on
    # sw_p47, and both on columns too deep for shared memory.
    names = example_flux_batch(1, 1, np.float32)["concs"].names
    gases = lambda key: (staged.band_gases(plan.build_plan(m32(key), names))
                         if key else (0, 0))
    props = torch.cuda.get_device_properties(0)
    limits = (props.shared_memory_per_block_optin,
              props.shared_memory_per_multiprocessor)
    print(f"build: card shared memory {limits[0]} B per block (opt-in), "
          f"{limits[1]} B per SM", flush=True)
    for kernel, label, lw_key, sw_key, nl, n_ang in (
            ("lwsw", "main path", "lw", "sw", PROTOCOL[1], 1),
            ("lwsw", "3 angles", "lw", "sw", PROTOCOL[1], 3),
            ("lwsw", "lw_rrtmgp", "lw_rrtmgp", "sw", PROTOCOL[1], 1),
            ("lwsw", "split", "lw", "sw", 137, 1),
            ("lwsw", "deep", "lw", "sw", 300, 1),
            ("lw", "main path", "lw", None, PROTOCOL[1], 1),
            ("lw", "3 angles", "lw", None, PROTOCOL[1], 3),
            ("lw", "lw_rrtmgp", "lw_rrtmgp", None, PROTOCOL[1], 1),
            ("lw", "deep", "lw", None, DEEP["lw"], 1),
            ("sw", "main path", None, "sw", PROTOCOL[1], 1),
            ("sw", "sw_p47", None, "sw_p47", PROTOCOL[1], 1),
            ("sw", "deep", None, "sw", DEEP["sw"], 1)):
        ng_lw = m32(lw_key).ngpt if lw_key else 0
        ng_sw = m32(sw_key).ngpt if sw_key else 0
        blocks, slots, sets = staged.SHAPES[kernel]
        p = staged.stage_plan(nl, ng_lw, ng_sw, n_ang, gases(lw_key),
                              gases(sw_key), *limits, blocks_per_sm=blocks,
                              max_slots=slots, sets=sets)
        n_t = m32(lw_key or sw_key).temperature_grid.shape[1]
        band = lambda key, ng: key and (ng, gases(key)[0], sum(gases(key)))
        shape = (band(lw_key, ng_lw), band(sw_key, ng_sw), n_t)
        per_sm = [staged.blocks_per_sm(kernel, shape, p.threads,
                                       p.shared_bytes, mode, 0,
                                       split=p.split)
                  for mode in ("exact", "fast")]
        tag = {"lwsw": "K1", "lw": "K3", "sw": "K4"}[kernel]
        print(f"build: {tag} staging, {label} ({lw_key or ''}"
              f"{'+' if lw_key and sw_key else ''}{sw_key or ''}, {nl} "
              f"layers, {n_ang} angle(s)): {p.bytes_per_column} B per "
              f"column, C = {p.slots} per block, S = {p.sets} sweep sets, in "
              + (f"{p.shared_bytes} B of dynamic shared memory"
                 if p.shared else "device memory")
              + (f" and LW rows of {4 * p.slice_floats} B per slot in device "
                 "memory" if p.split else "")
              + f", {p.threads} threads, blocks per SM (occupancy "
              f"calculator) {per_sm[0]} exact / {per_sm[1]} fast",
              flush=True)

    # ---- 4. parity: kernel (f32) vs plain (f64) on the card -------------
    failures = []
    worst_abs = dict.fromkeys(KERNELS, 0.0)
    for i, case in enumerate(cuda_parity.CASES):
        kernel, name, ncol, nlay, n_ang, lk, sk, _, _ = case
        r = cuda_parity.run_case(models, case, seed=100 + i, mode="bf16x3")
        worst_abs[kernel] = max(worst_abs[kernel], r["max_abs"])
        if not r["ok"]:
            failures.append(f"parity {kernel} {name}")
        print(f"parity: {'ok' if r['ok'] else 'FAIL'} {kernel} {name} "
              f"({ncol}x{nlay}, {n_ang} angle(s), {lk or ''}"
              f"{'+' if lk and sk else ''}{sk or ''}) max|d|/scale "
              + " ".join(f"{v:.3e}" for v in r["rel"])
              + f" max|d|={r['max_abs']:.3e} W m-2 (bound {BOUND:.0e})",
              flush=True)

    # The pair on two (p, T) grids: lw_sw_fluxes(cuda) takes K3 + K4.
    arrays, gases = cuda_parity.adversarial_batch(1800, 60, seed=99)
    b32 = on_card(arrays, gases, torch.float32, lw32.ngpt)
    b64 = on_card(arrays, gases, torch.float64, lw32.ngpt)
    reset_counts()
    lw_f, sw_f = pipeline.lw_sw_fluxes(
        lw32, m32("sw_p47"), b32["plev"], b32["tlay"], b32["tlev"],
        b32["tsfc"], b32["emis_col"], b32["concs"], b32["alb"], b32["tsi"],
        b32["sza"], backend="cuda")
    torch.cuda.synchronize()
    launched = counts()
    got = (lw_f.flux_up, lw_f.flux_dn, sw_f.flux_up, sw_f.flux_dn)
    ref = (*solve("lw", "plain", m64("lw"), None, b64),
           *solve("sw", "plain", None, m64("sw_p47"), b64))
    rel, absolute = flux_errors(got, ref)
    ok = (max(rel) <= BOUND and launched == {"lwsw": 0, "lw": 1, "sw": 1,
                                             "lwsw_fast": 0, "lw_fast": 0,
                                             "sw_fast": 0, "lwsw_f64": 0,
                                             "lwsw_jac": 0})
    if not ok:
        failures.append("parity non-mergeable pair")
    print(f"parity: {'ok' if ok else 'FAIL'} lw_sw_fluxes(cuda) lw_fsck + "
          f"sw_p47 (two grids, 1800x60) launches={launched} max|d|/scale "
          + " ".join(f"{r:.3e}" for r in rel) + f" max|d|={absolute:.3e}",
          flush=True)

    # ---- 5. shared code: K3 / K4 against K1 ------------------------------
    arrays, gases = cuda_parity.adversarial_batch(1800, 60, seed=7)
    b32 = on_card(arrays, gases, torch.float32, lw32.ngpt)
    merged = solve("lwsw", "cuda", lw32, sw32, b32)
    single = (*solve("lw", "cuda", lw32, None, b32),
              *solve("sw", "cuda", None, sw32, b32))
    torch.cuda.synchronize()
    diffs = [float((s - m).abs().max()) for s, m in zip(single, merged)]
    rel, _ = flux_errors(single, merged)
    ok = max(rel) <= BOUND
    if not ok:
        failures.append("shared code")
    print(f"shared code: {'ok' if ok else 'FAIL'} K3/K4 vs K1 (1800x60) "
          f"max|d| lw_up={diffs[0]:.3e} lw_dn={diffs[1]:.3e} "
          f"sw_up={diffs[2]:.3e} sw_dn={diffs[3]:.3e} W m-2; bitwise equal: "
          f"{all(d == 0.0 for d in diffs)}", flush=True)

    # ---- 6. main paths at the protocol batch -------------------------------
    ncol, nlay = PROTOCOL
    batch = example_flux_batch(ncol, nlay, np.float32, device="cuda")
    t = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()
         if k != "concs"}
    concs = batch["concs"]
    day = batch["sza"] < 90.0 - 2.0 * float(np.spacing(np.float32(90.0)))
    mu0_tsi = 1361.0 * np.cos(np.deg2rad(batch["sza"].astype(np.float64)))
    n_check = 2048
    b64 = on_card({k: v[:n_check] for k, v in batch.items() if k != "concs"},
                  {n: v[:n_check].cpu().numpy() for n, v in zip(
                      concs.names, concs.values)}, torch.float64, lw32.ngpt)
    paths_run = {
        "lwsw": lambda: pipeline.lw_sw_fluxes(
            lw32, sw32, t["plev"], t["tlay"], t["tlev"], t["tsfc"],
            t["emis"], concs, t["alb"], t["tsi"], t["sza"], backend="auto"),
        "lw": lambda: (pipeline.lw_fluxes(
            lw32, t["plev"], t["tlay"], t["tlev"], t["tsfc"], t["emis"],
            concs, backend="auto"),),
        "sw": lambda: (pipeline.sw_fluxes(
            sw32, t["plev"], t["tlay"], concs, t["alb"], t["tsi"], t["sza"],
            backend="auto"),),
    }
    refs = {name: lambda name=name, **kw: solve(
        name, "plain", m64("lw") if name != "sw" else None,
        m64("sw") if name != "lw" else None, b64, **kw) for name in KERNELS}
    main_launches, main_outs = {}, {}
    for name, drive in paths_run.items():
        reset_counts()
        fluxes = drive()
        torch.cuda.synchronize()
        launched = counts()
        main_launches[name] = launched[name]
        outs = [o for f in fluxes for o in (f.flux_up, f.flux_dn)]
        main_outs[name] = outs
        rel, _ = flux_errors([o[:n_check] for o in outs],
                             refs[name](mxu_mode="bf16x3"))
        checks = {
            f"{name} launches > 0": launched[name] > 0,
            "no other kernel": all(v == 0 for k, v in launched.items()
                                   if k != name),
            "shapes": all(tuple(o.shape) == (ncol, nlay + 1) for o in outs),
            "finite": all(bool(torch.isfinite(o).all()) for o in outs),
            f"first {n_check} columns vs plain f64": max(rel) <= BOUND,
        }
        if name != "lw":
            sw_f = fluxes[-1]
            toa = sw_f.flux_dn[:, 0].double().cpu().numpy()
            night = torch.as_tensor(~day, device="cuda")
            # mu0 is cos of a float32 angle: grazing columns need an
            # absolute tolerance (1e-5 of the TSI).
            checks["sw toa dn == mu0*tsi (day)"] = bool(np.allclose(
                toa[day], mu0_tsi[day], rtol=1e-5, atol=1e-5 * 1361.0))
            checks["night sw == 0"] = bool(
                (sw_f.flux_dn[night] == 0).all()
                and (sw_f.flux_up[night] == 0).all())
        ok = all(checks.values())
        if not ok:
            failures.append(f"main path {name}")
        entry = {"lwsw": "lw_sw_fluxes", "lw": "lw_fluxes",
                 "sw": "sw_fluxes"}[name]
        print(f"main path: {'ok' if ok else 'FAIL'} {entry}(auto) "
              f"{ncol}x{nlay} launches={launched} | " + " | ".join(
                  f"{k}: {v}" for k, v in checks.items())
              + f" | max|d|/scale={max(rel):.3e}", flush=True)

    # The merged main path on float64 tensors: K1's double instantiation,
    # held against the plain version with float64's constants within
    # F64_BOUND, which the float32 kernel's outputs above must fail.
    lw64, sw64 = m64("lw"), m64("sw")
    t64 = {k: v.double() for k, v in t.items()}
    concs_p64 = GasConcs(values=tuple(v.double() for v in concs.values),
                         names=concs.names)
    reset_counts()
    fluxes = pipeline.lw_sw_fluxes(
        lw64, sw64, t64["plev"], t64["tlay"], t64["tlev"], t64["tsfc"],
        t64["emis"], concs_p64, t64["alb"], t64["tsi"], t64["sza"],
        backend="auto")
    torch.cuda.synchronize()
    launched = counts()
    main_launches["lwsw_f64"] = launched["lwsw_f64"]
    outs = [o for f in fluxes for o in (f.flux_up, f.flux_dn)]
    ref64 = refs["lwsw"](mxu_mode="bf16x3", compute=torch.float64)
    rel, worst_abs["lwsw_f64"] = flux_errors([o[:n_check] for o in outs],
                                             ref64)
    rel32 = max(flux_errors([o[:n_check] for o in main_outs["lwsw"]],
                            ref64)[0])
    want = -(-ncol // binding.DEFAULT_COLUMN_CHUNK)
    day64 = batch["sza"] < 90.0 - 2.0 * float(np.spacing(np.float64(90.0)))
    toa = fluxes[1].flux_dn[:, 0].cpu().numpy()
    night = torch.as_tensor(~day64, device="cuda")
    checks = {
        f"lwsw_f64 launches == {want}": launched["lwsw_f64"] == want,
        "no other kernel": all(v == 0 for k, v in launched.items()
                               if k != "lwsw_f64"),
        "float64 outputs": all(o.dtype == torch.float64 for o in outs),
        "shapes": all(tuple(o.shape) == (ncol, nlay + 1) for o in outs),
        "finite": all(bool(torch.isfinite(o).all()) for o in outs),
        f"first {n_check} columns vs plain f64 <= {F64_BOUND:.0e}":
        max(rel) <= F64_BOUND,
        "float32 kernel above it": rel32 > F64_BOUND,
        "sw toa dn == mu0*tsi (day)": bool(np.allclose(
            toa[day64], mu0_tsi[day64], rtol=1e-9, atol=1e-9 * 1361.0)),
        "night sw == 0": bool((fluxes[1].flux_dn[night] == 0).all()
                              and (fluxes[1].flux_up[night] == 0).all()),
    }
    ok = all(checks.values())
    if not ok:
        failures.append("main path lwsw_f64")
    print(f"main path: {'ok' if ok else 'FAIL'} lw_sw_fluxes(auto) float64 "
          f"{ncol}x{nlay} launches={launched} | " + " | ".join(
              f"{k}: {v}" for k, v in checks.items())
          + f" | max|d|/scale={max(rel):.3e} (float32 kernel {rel32:.3e}) "
          f"max|d|={worst_abs['lwsw_f64']:.3e} W m-2", flush=True)

    # The merged main path with RTE's LW surface-temperature Jacobian at
    # l91_jac_batch's launch: K1's Jacobian instantiation, its J held
    # against the plain version's at float64 within JAC_BOUND of the
    # largest |J|, its fluxes against the plain f64 ones within BOUND and
    # against K1's plain instantiation on the same batch bit for bit.
    ncol_j, nlay_j = JAC_SHAPE
    batch_j = example_flux_batch(ncol_j, nlay_j, np.float32, device="cuda")
    t_j = {k: torch.as_tensor(v, device="cuda") for k, v in batch_j.items()
           if k != "concs"}
    concs_j = batch_j["concs"]
    b64_j = on_card({k: v[:n_check] for k, v in batch_j.items()
                     if k != "concs"},
                    {n: v[:n_check].cpu().numpy() for n, v in zip(
                        concs_j.names, concs_j.values)}, torch.float64,
                    lw32.ngpt)

    def drive_j(**kw):
        lw_f, sw_f = pipeline.lw_sw_fluxes(
            lw32, sw32, t_j["plev"], t_j["tlay"], t_j["tlev"], t_j["tsfc"],
            t_j["emis"], concs_j, t_j["alb"], t_j["tsi"], t_j["sza"],
            backend="auto", **kw)
        return [lw_f.flux_up, lw_f.flux_dn, sw_f.flux_up, sw_f.flux_dn,
                lw_f.flux_up_jac]

    reset_counts()
    outs = drive_j(flux_up_jac=True)
    torch.cuda.synchronize()
    launched = counts()
    main_launches["lwsw_jac"] = launched["lwsw_jac"]
    plain_inst = drive_j()[:4]
    ref_j = solve("lwsw", "plain", m64("lw"), m64("sw"), b64_j,
                  mxu_mode="bf16x3", flux_up_jac=True)
    rel, worst_abs["lwsw_jac"] = flux_errors([o[:n_check] for o in outs[:4]],
                                             ref_j[:4])
    d_jac = float((outs[4][:n_check].double() - ref_j[4]).abs().max())
    rel_jac = d_jac / float(ref_j[4].abs().max())
    want = -(-ncol_j // binding.DEFAULT_COLUMN_CHUNK)
    checks = {
        f"lwsw_jac launches == {want}": launched["lwsw_jac"] == want,
        "no other kernel": all(v == 0 for k, v in launched.items()
                               if k != "lwsw_jac"),
        "shapes": all(tuple(o.shape) == (ncol_j, nlay_j + 1) for o in outs),
        "finite": all(bool(torch.isfinite(o).all()) for o in outs),
        "J > 0": bool((outs[4] > 0).all()),
        f"first {n_check} columns' fluxes vs plain f64": max(rel) <= BOUND,
        f"J vs plain f64 <= {JAC_BOUND:.0e} of max|J|": rel_jac <= JAC_BOUND,
        "fluxes bitwise K1's plain instantiation's": all(
            torch.equal(a, b) for a, b in zip(outs[:4], plain_inst)),
    }
    ok = all(checks.values())
    if not ok:
        failures.append("main path lwsw_jac")
    print(f"main path: {'ok' if ok else 'FAIL'} lw_sw_fluxes(auto, "
          f"flux_up_jac=True) {ncol_j}x{nlay_j} launches={launched} | "
          + " | ".join(f"{k}: {v}" for k, v in checks.items())
          + f" | fluxes max|d|/scale={max(rel):.3e} max|d|="
          f"{worst_abs['lwsw_jac']:.3e} W m-2, J max|d|/max|J|="
          f"{rel_jac:.3e} max|d|={d_jac:.3e} W m-2 K-1", flush=True)

    # ---- 7. RFMIP drivers at 100 x 18 x 60 ----------------------------------
    nsite, nexp, nlay_r = RFMIP
    rfmip = os.path.join(work, "rfmip.nc")
    write_synthetic_rfmip(rfmip, nsite=nsite, nlay=nlay_r, nexp=nexp, seed=0)
    data = read_rfmip(rfmip)
    stem = "_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"
    drivers = (("lw", ecckd_rfmip_lw.main, [paths["lw"]], ("rlu", "rld")),
               ("sw", ecckd_rfmip_sw.main, [paths["sw"]], ("rsu", "rsd")),
               ("lwsw", ecckd_rfmip.main, [paths["lw"], paths["sw"]],
                ("rlu", "rld", "rsu", "rsd")))
    # The float64 plain version on the drivers' inputs (reference order of
    # the requested gases, the top-pressure clamp).
    plev = pipeline.clamp_top_pressure(data.plev, lw32.get_press_min())
    d64 = lambda x: torch.as_tensor(x, device="cuda", dtype=torch.float64)
    concs64 = build_gas_concs(data, np.float64, "cuda")

    def driver_refs(mode):
        out = dict(zip(("rlu", "rld"), lw.lw_fluxes_plain(
            m64("lw"), d64(plev), d64(data.tlay), d64(data.tlev),
            d64(data.sfc_t), d64(data.sfc_emis)[:, None].expand(
                -1, lw32.ngpt), concs64, mxu_mode=mode)))
        out.update(zip(("rsu", "rsd"), sw.sw_fluxes_plain(
            m64("sw"), d64(plev), d64(data.tlay), concs64, d64(data.sfc_alb),
            d64(data.tsi), d64(data.sza), mxu_mode=mode)))
        return out

    ref_files = driver_refs("bf16x3")
    files, driver_s, driver_launches = {}, {}, {}
    for name, drive, ckd, outputs in drivers:
        out_dir = os.path.join(work, f"out_{name}")
        metrics = os.path.join(out_dir, "metrics.json")
        reset_counts()
        rc = drive([rfmip, *ckd, "--device", "cuda", "--output-dir",
                    out_dir, "--heating-rates", "--metrics-json", metrics])
        torch.cuda.synchronize()
        launched = counts()
        driver_launches[name] = launched
        with open(metrics) as f:
            driver_m = json.load(f)
        driver_s[name] = driver_m["seconds"]
        files[name] = {v: read_fluxes(os.path.join(out_dir, v + stem), v)
                       for v in outputs}
        got = [torch.as_tensor(files[name][v]) for v in outputs]
        ref = [ref_files[v].cpu() for v in outputs]
        rel, _ = flux_errors(got, ref)
        checks = {
            "rc == 0": rc == 0,
            f"{name} launches > 0": launched[name] > 0,
            "no fast, f64 or Jacobian entry point": not any(
                v for k, v in launched.items()
                if k.endswith(("_fast", "_f64", "_jac"))),
            "io_engine native": driver_m["io_engine"] == "native",
            "shapes": all(g.shape == (data.ncol, nlay_r + 1) for g in got),
            "finite": all(bool(torch.isfinite(g).all()) for g in got),
            "vs plain f64": max(rel) <= BOUND,
        }
        if "rsd" in outputs:
            day_r = data.sza < 90.0 - 2.0 * float(np.spacing(np.float32(90)))
            toa = files[name]["rsd"][:, 0]
            mu0_tsi_r = data.tsi * np.cos(np.deg2rad(data.sza))
            checks["sw toa dn == mu0*tsi (day)"] = bool(np.allclose(
                toa[day_r], mu0_tsi_r[day_r], rtol=1e-5, atol=1e-5 * 1361.0))
            checks["night sw == 0"] = bool(
                not files[name]["rsd"][~day_r].any()
                and not files[name]["rsu"][~day_r].any())
        ok = all(checks.values())
        if not ok:
            failures.append(f"rfmip driver {name}")
        print(f"rfmip driver: {'ok' if ok else 'FAIL'} "
              f"{drive.__module__.split('.')[-1]} {nsite}x{nexp}x{nlay_r} "
              f"launches={launched} solve {driver_s[name] * 1e3:.3f} ms "
              f"(first call, host clock after the barrier) | "
              + " | ".join(f"{k}: {v}" for k, v in checks.items())
              + f" | max|d|/scale={max(rel):.3e}", flush=True)
    sep = {**files["lw"], **files["sw"]}
    rel, absolute = flux_errors(
        [torch.as_tensor(files["lwsw"][v]) for v in ("rlu", "rld", "rsu",
                                                      "rsd")],
        [torch.as_tensor(sep[v]) for v in ("rlu", "rld", "rsu", "rsd")])
    ok = max(rel) <= BOUND
    if not ok:
        failures.append("rfmip combined vs separate")
    print(f"rfmip driver: {'ok' if ok else 'FAIL'} combined vs separate "
          f"files max|d|={absolute:.3e} W m-2 max|d|/scale={max(rel):.3e}",
          flush=True)

    # ---- 8. times -----------------------------------------------------------
    emis_gpt = t["emis"][:, None].expand(-1, lw32.ngpt).contiguous()
    args = {"lwsw": (lw32, sw32, t["plev"], t["tlay"], t["tlev"], t["tsfc"],
                     emis_gpt, concs, t["alb"], t["tsi"], t["sza"]),
            "lw": (lw32, t["plev"], t["tlay"], t["tlev"], t["tsfc"],
                   emis_gpt, concs),
            "sw": (sw32, t["plev"], t["tlay"], concs, t["alb"], t["tsi"],
                   t["sza"])}
    preps = {"lwsw": plan.prepare(*args["lwsw"]),
             "lw": plan.prepare_lw(*args["lw"]),
             "sw": plan.prepare_sw(*args["sw"])}
    plain_core = {"lwsw": lwsw._plain_core, "lw": common.lw_plain,
                  "sw": common.sw_plain}
    plain = {"lwsw": lwsw.lwsw_fluxes_plain, "lw": lw.lw_fluxes_plain,
             "sw": sw.sw_fluxes_plain}
    chunk = binding.DEFAULT_COLUMN_CHUNK
    times, bounds = {}, {}
    for name in KERNELS:
        prep = preps[name]
        k_ms = cuda_time_ms(lambda: modules[name]._kernel_core(*prep, chunk))
        p_ms = cuda_time_ms(lambda: plain_core[name](*prep))
        k_e2e = cuda_time_ms(lambda: wrappers[name](*args[name]))
        p_e2e = cuda_time_ms(lambda: plain[name](*args[name]))
        times[name] = (k_ms, p_ms)
        bounds[name] = kernel_bound(prep)
        bd = bounds[name]
        print(f"times: {name} {ncol}x{nlay} 1 angle on {card}: kernel "
              f"{k_ms:.3f} ms ({ncol / k_ms * 1e3:.0f} columns/s), plain f32 "
              f"{p_ms:.3f} ms ({ncol / p_ms * 1e3:.0f} columns/s); with host "
              f"prep: kernel {k_e2e:.3f} ms, plain {p_e2e:.3f} ms (median "
              f"of 10 after 2 warm-up, CUDA events) | bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['ops']:.4g} "
              f"operations, {bd['bytes']:.4g} bytes), share of the bound "
              f"{bd['bound_ms'] / k_ms:.4f}", flush=True)
    # K1's double instantiation on the same batch in float64, against its
    # plain version at float64 (the torch path's cost at this precision).
    args64 = (lw64, sw64, t64["plev"], t64["tlay"], t64["tlev"], t64["tsfc"],
              emis_gpt.double(), concs_p64, t64["alb"], t64["tsi"],
              t64["sza"])
    prep64 = plan.prepare(*args64)
    k_ms = cuda_time_ms(lambda: lwsw._kernel_core(*prep64, chunk))
    p_ms = cuda_time_ms(lambda: lwsw._plain_core(*prep64, torch.float64))
    k_e2e = cuda_time_ms(lambda: lwsw.lwsw_fluxes_cuda(*args64))
    times["lwsw_f64"] = (k_ms, p_ms)
    bounds["lwsw_f64"] = bd = kernel_bound(prep64)
    print(f"times: lwsw_f64 {ncol}x{nlay} 1 angle on {card}: kernel "
          f"{k_ms:.3f} ms ({ncol / k_ms * 1e3:.0f} columns/s), plain f64 "
          f"{p_ms:.3f} ms ({ncol / p_ms * 1e3:.0f} columns/s); with host "
          f"prep: kernel {k_e2e:.3f} ms (median of 10 after 2 warm-up, CUDA "
          f"events) | bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
          f"({bd['ops']:.4g} operations at {PEAK_F64_FLOPS:.3g} FLOP/s, "
          f"{bd['bytes']:.4g} bytes), share of the bound "
          f"{bd['bound_ms'] / k_ms:.4f}", flush=True)
    # K1's Jacobian instantiation at l91_jac_batch's launch, beside K1's
    # plain instantiation on the same batch and the plain float32 version
    # with the Jacobian; its bound counts the Jacobian's work too.
    args_j = (lw32, sw32, t_j["plev"], t_j["tlay"], t_j["tlev"],
              t_j["tsfc"], t_j["emis"][:, None].expand(-1, lw32.ngpt)
              .contiguous(), concs_j, t_j["alb"], t_j["tsi"], t_j["sza"])
    prep_j = plan.prepare(*args_j)
    k_ms = cuda_time_ms(lambda: lwsw._kernel_core(*prep_j, chunk, jac=True))
    k0_ms = cuda_time_ms(lambda: lwsw._kernel_core(*prep_j, chunk))
    p_ms = cuda_time_ms(lambda: lwsw._plain_core(*prep_j, jac=True))
    k_e2e = cuda_time_ms(lambda: lwsw.lwsw_fluxes_cuda(*args_j,
                                                       flux_up_jac=True))
    times["lwsw_jac"] = (k_ms, p_ms)
    bounds["lwsw_jac"] = bd = kernel_bound(prep_j, jac=True)
    print(f"times: lwsw_jac {ncol_j}x{nlay_j} 1 angle on {card}: kernel "
          f"{k_ms:.3f} ms ({ncol_j / k_ms * 1e3:.0f} columns/s; K1 without "
          f"the Jacobian {k0_ms:.3f} ms), plain f32 {p_ms:.3f} ms "
          f"({ncol_j / p_ms * 1e3:.0f} columns/s); with host prep: kernel "
          f"{k_e2e:.3f} ms (median of 10 after 2 warm-up, CUDA events) | "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
          f"({bd['ops']:.4g} operations, {bd['bytes']:.4g} bytes), share of "
          f"the bound {bd['bound_ms'] / k_ms:.4f}", flush=True)
    # More shapes of each kernel at 65,536 columns, each with its bound:
    # K3 on lw_rrtmgp (36 g-points) and at 3 angles, K4 on sw_p47 (its own
    # 47-point grid), K1/K2 at 3 and 4 angles, on lw_rrtmgp and at nlay 137
    # (where K1 stages on the split route).
    rr_emis = emis_gpt[:, :1].expand(-1, 36).contiguous()
    deep_n = 137
    deep = example_flux_batch(ncol, deep_n, np.float32, device="cuda")
    td = {k: torch.as_tensor(v, device="cuda") for k, v in deep.items()
          if k != "concs"}
    shapes = {
        ("lw", "lw_rrtmgp"): plan.prepare_lw(
            m32("lw_rrtmgp"), *args["lw"][1:5], rr_emis, concs),
        ("lw", "3 angles"): plan.prepare_lw(*args["lw"], n_gauss_angles=3),
        ("sw", "sw_p47"): plan.prepare_sw(m32("sw_p47"), *args["sw"][1:]),
        ("lwsw", "3 angles (K2)"): plan.prepare(*args["lwsw"],
                                               n_gauss_angles=3),
        ("lwsw", "4 angles (K2)"): plan.prepare(*args["lwsw"],
                                               n_gauss_angles=4),
        ("lwsw", "lw_rrtmgp + sw_wide"): plan.prepare(
            m32("lw_rrtmgp"), *args["lwsw"][1:6], rr_emis,
            *args["lwsw"][7:]),
        ("lwsw", f"nlay {deep_n}"): plan.prepare(
            lw32, sw32, td["plev"], td["tlay"], td["tlev"], td["tsfc"],
            td["emis"][:, None].expand(-1, lw32.ngpt).contiguous(),
            deep["concs"], td["alb"], td["tsi"], td["sza"]),
    }
    for (name, label), prep in shapes.items():
        ms = cuda_time_ms(lambda: modules[name]._kernel_core(*prep, chunk))
        bd = kernel_bound(prep)
        n = prep[0].tlay.shape[1]
        # K3's other shapes with their plain f32 version (PERF.md's table
        # of kernels has a row for each).
        plain_ms = ""
        if name == "lw":
            p_ms = cuda_time_ms(lambda: plain_core[name](*prep))
            plain_ms = f", plain f32 {p_ms:.3f} ms"
        print(f"times: {name} kernel {ncol}x{n} {label}: {ms:.3f} ms"
              f"{plain_ms}, bound {bd['bound_ms']:.4f} ms by "
              f"{bd['bound_by']}, share {bd['bound_ms'] / ms:.4f} | on "
              f"{card}", flush=True)
    n_r = nsite * nexp
    cut = lambda x: (x[:n_r] if isinstance(x, torch.Tensor)
                     and x.shape[:1] == (ncol,) else x)
    small_concs = GasConcs(values=tuple(cut(v) for v in concs.values),
                           names=concs.names)
    small = {k: tuple(small_concs if x is concs else cut(x) for x in a)
             for k, a in args.items()}
    small_prep = {"lwsw": plan.prepare(*small["lwsw"]),
                  "lw": plan.prepare_lw(*small["lw"]),
                  "sw": plan.prepare_sw(*small["sw"])}
    small_ms = {name: cuda_time_ms(
        lambda: modules[name]._kernel_core(*small_prep[name], chunk))
        for name in KERNELS}
    print(f"times: {n_r}x{nlay} kernels: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in small_ms.items())
          + f" | K3 + K4 {small_ms['lw'] + small_ms['sw']:.3f} ms against K1 "
          f"{small_ms['lwsw']:.3f} ms; at {ncol}x{nlay} K3 + K4 "
          f"{times['lw'][0] + times['sw'][0]:.3f} ms against K1 "
          f"{times['lwsw'][0]:.3f} ms | on {card}", flush=True)

    # ---- 9. stream: scale_bench at 1,048,576 x 60 over every local card ----
    from ecckd_tpu_torch.cli import scale_bench
    from ecckd_tpu_torch.parallel.scale import run_weak_scaling
    from ecckd_tpu_torch.utils import capture
    n_cards = torch.cuda.device_count()
    chunk_cols = PROTOCOL[0]
    n_chunks = STREAM // chunk_cols
    stream_argv = ["--columns", str(STREAM), "--chunk", str(chunk_cols),
                   "--nlay", str(nlay), "--outputs", "full", "--device",
                   "cuda", "--lw-file", paths["lw"], "--sw-file", paths["sw"]]

    def step_calls(rounds: int) -> int:
        """Calls of scale_bench's step per card in one run: the compute
        reference's warm-up and capture, one warm-up chunk, then per round
        a reference epoch and every chunk."""
        return 3 + rounds * (scale_bench.REF_ITERS + n_chunks)

    seen, samples, kept = [], {}, {}

    def check(host, i):
        seen.append((i, all(bool(np.isfinite(a).all()) for a in host)))
        kept[i] = [a.copy() for a in host]
        if i in (0, n_chunks - 1):
            samples[i] = [torch.as_tensor(a[:n_check].copy()) for a in host]

    reset_counts()
    rc, line = run_cli(scale_bench.main, stream_argv + ["--repeats", "1"],
                       consume=check)
    torch.cuda.synchronize()
    launched = counts()
    # scale_bench's chunk i is the protocol batch with tsfc + 0.01 (i % 7).
    rel = []
    for i, got in sorted(samples.items()):
        tsfc = (batch["tsfc"][:n_check]
                + np.float32(0.01) * np.float32(i % 7)).astype(np.float32)
        ref = solve("lwsw", "plain", m64("lw"), m64("sw"),
                    dict(b64, tsfc=torch.as_tensor(tsfc, device="cuda",
                                                   dtype=torch.float64)))
        rel.append(max(flux_errors(got, [r.cpu() for r in ref])[0]))
    want = n_cards * step_calls(1)
    checks = {
        "rc == 0": rc == 0,
        f"{n_chunks} chunks once, in order": [i for i, _ in seen]
        == list(range(n_chunks)),
        "finite": all(ok for _, ok in seen),
        f"chunks 0 and {n_chunks - 1} first {n_check} columns vs plain f64":
        len(rel) == 2 and max(rel) <= BOUND,
        f"lwsw launches == {n_cards} card(s) x {step_calls(1)} step calls":
        launched["lwsw"] == want,
        "no other kernel": all(v == 0 for k, v in launched.items()
                               if k != "lwsw"),
    }
    ok = all(checks.values())
    if not ok:
        failures.append("stream check")
    print(f"stream: {'ok' if ok else 'FAIL'} scale_bench checking pass "
          f"{STREAM}x{nlay} chunk {chunk_cols} over {n_cards} card(s), "
          f"captured step per card | launches={launched} | " + " | ".join(
              f"{k}: {v}" for k, v in checks.items())
          + f" | max|d|/scale={max(rel or [float('nan')]):.3e}", flush=True)

    # The same chunks on one card (--no-shard), and split into three
    # pieces on card 0 (21,846 columns each, the last with two padded
    # ones): every chunk bit for bit equal to the run over every card.
    def same_as_kept(host, i):
        equal_chunks.append((i, all(np.array_equal(a, b) for a, b in
                                    zip(host, kept.get(i, ())))))

    equal_chunks = []
    reset_counts()
    rc1, _ = run_cli(scale_bench.main, stream_argv + [
        "--repeats", "1", "--no-shard"], consume=same_as_kept)
    torch.cuda.synchronize()
    one_card, one_launched = equal_chunks, counts()
    equal_chunks = []
    card0 = [torch.device("cuda", 0)] * 3
    reset_counts()
    run_weak_scaling(
        capture.jit(scale_bench.make_step("full")),
        scale_bench.resident_chunks(lw32, sw32, example_flux_batch(
            chunk_cols, nlay, np.float32), card0, chunk_cols),
        n_chunks, chunk_cols, mesh=card0, consume=same_as_kept)
    torch.cuda.synchronize()
    pieces, pieces_launched = equal_chunks, counts()
    every = lambda got: (len(got) == n_chunks and all(eq for _, eq in got))
    checks = {
        "one card rc == 0": rc1 == 0,
        "one card bitwise": every(one_card),
        f"one card lwsw launches == {step_calls(1)}":
        one_launched["lwsw"] == step_calls(1),
        "3 pieces on card 0 bitwise": every(pieces),
        f"3 pieces lwsw launches == 3 x {n_chunks + 1}":
        pieces_launched["lwsw"] == 3 * (n_chunks + 1),
    }
    ok = all(checks.values())
    if not ok:
        failures.append("stream bitwise")
    print(f"stream: {'ok' if ok else 'FAIL'} the {n_cards}-card stream's "
          f"{n_chunks} chunks against one card (--no-shard) and against 3 "
          "pieces on card 0 | " + " | ".join(
              f"{k}: {v}" for k, v in checks.items()), flush=True)
    kept.clear()

    reset_counts()
    rc, line = run_cli(scale_bench.main, stream_argv)
    torch.cuda.synchronize()
    launched = counts()
    try:
        sm = json.loads(line)
    except ValueError:
        sm = {}
    rounds = sm.get("streamed_repeats_best_of", 0)
    checks = {
        "rc == 0": rc == 0,
        f"n_chunks == {n_chunks}": sm.get("n_chunks") == n_chunks,
        f"n_devices == {n_cards}": sm.get("n_devices") == n_cards,
        f"lwsw launches == {n_cards} card(s) x {step_calls(rounds)} step "
        "calls": rounds > 0 and launched["lwsw"] == n_cards * step_calls(
            rounds),
        "no other kernel": all(v == 0 for k, v in launched.items()
                               if k != "lwsw"),
    }
    ok = all(checks.values())
    if not ok:
        failures.append("stream measure")
    budget = ("wall_s", "dispatch_s", "d2h_issue_s", "drain_wait_s",
              "consume_s")
    print(f"stream: {'ok' if ok else 'FAIL'} scale_bench {STREAM}x{nlay} "
          f"chunk {chunk_cols} full outputs over {n_cards} card(s), best of "
          f"{rounds} on {card}: columns_per_sec {sm.get('columns_per_sec')} "
          f"| compute_ref_cols_per_sec {sm.get('compute_ref_cols_per_sec')} "
          f"| overlap_efficiency {sm.get('overlap_efficiency')} | budget "
          + " ".join(f"{k}={sm.get(k)}" for k in budget)
          + f" | launches={launched} | " + " | ".join(
              f"{k}: {v}" for k, v in checks.items()), flush=True)
    if n_cards < 4:
        print(f"stream: four cards not measured (this machine has "
              f"{n_cards})", flush=True)
    rc, line = run_cli(scale_bench.main, stream_argv[:6] + [
        "--outputs", "toa-net"] + stream_argv[8:] + ["--repeats", "2"])
    tn = json.loads(line) if rc == 0 else {}
    if rc != 0:
        failures.append("stream toa-net")
    print(f"stream: {'ok' if rc == 0 else 'FAIL'} scale_bench toa-net "
          f"outputs (4 B/col), best of 2 on {card}: columns_per_sec "
          f"{tn.get('columns_per_sec')} | compute_ref_cols_per_sec "
          f"{tn.get('compute_ref_cols_per_sec')} | overlap_efficiency "
          f"{tn.get('overlap_efficiency')} | budget "
          + " ".join(f"{k}={tn.get(k)}" for k in budget), flush=True)

    # Restart journal: --resume after two chunks are lost is bitwise.
    out_dir = os.path.join(work, "stream_out")
    small = ["--columns", str(4 * chunk_cols)] + stream_argv[2:] + [
        "--out-dir", out_dir]
    names = ("rlu", "rld", "rsu", "rsd")
    rc1, _ = run_cli(scale_bench.main, small)
    first = {v: np.load(os.path.join(out_dir, f"{v}.npy")) for v in names}
    with open(os.path.join(out_dir, "progress.json")) as f:
        journal = json.load(f)
    journal["done"] = [0, 1]
    with open(os.path.join(out_dir, "progress.json"), "w") as f:
        json.dump(journal, f)
    for v in names:
        arr = np.lib.format.open_memmap(os.path.join(out_dir, f"{v}.npy"),
                                        mode="r+")
        arr[2 * chunk_cols:] = 0.0
        arr.flush()
        del arr
    rc2, _ = run_cli(scale_bench.main, small + ["--resume"])
    with open(os.path.join(out_dir, "progress.json")) as f:
        redone = json.load(f)["done"]
    equal = all(np.array_equal(np.load(os.path.join(out_dir, f"{v}.npy")),
                               first[v]) for v in names)
    ok = rc1 == 0 and rc2 == 0 and redone == [0, 1, 2, 3] and equal
    if not ok:
        failures.append("stream resume")
    print(f"stream: {'ok' if ok else 'FAIL'} --resume {4 * chunk_cols}x"
          f"{nlay} after chunks 2, 3 zeroed: journal {redone}, files "
          f"bitwise equal to the first run: {equal}", flush=True)

    # ---- 10. column split ---------------------------------------------------
    from ecckd_tpu_torch.parallel import mesh as pmesh
    split_files = {}
    for tag, extra in (("split", []), ("no_shard", ["--no-shard"])):
        out_dir = os.path.join(work, f"out_{tag}")
        reset_counts()
        rc = ecckd_rfmip.main([rfmip, paths["lw"], paths["sw"], "--device",
                               "cuda", "--output-dir", out_dir, *extra])
        torch.cuda.synchronize()
        launched = counts()
        split_files[tag] = (rc, launched, {
            v: read_fluxes(os.path.join(out_dir, v + stem), v)
            for v in names})
    (rc_s, l_s, f_s), (rc_n, _, f_n) = split_files["split"], \
        split_files["no_shard"]
    equal = all(np.array_equal(f_s[v], f_n[v]) for v in names)
    ok = rc_s == 0 and rc_n == 0 and l_s["lwsw"] > 0 and equal
    if not ok:
        failures.append("column split")
    print(f"split: {'ok' if ok else 'FAIL'} ecckd_rfmip through the split "
          f"over {len(pmesh.make_column_mesh())} card(s) "
          f"{nsite}x{nexp}x{nlay_r} launches={l_s} | files bitwise equal "
          f"to --no-shard: {equal}", flush=True)

    solve_lwsw = lambda ml, ms, *a: pipeline.lw_sw_fluxes(ml, ms, *a,
                                                          backend="auto")

    def call_args(b, gases, ml=lw32, ms=sw32):
        return (ml, ms, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                b["emis"], gases, b["alb"], b["tsi"], b["sza"])

    single = solve_lwsw(*call_args(t, concs))
    pmesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        rank, size = pmesh.world()
        reset_counts()
        gathered = pmesh.distributed_columns_call(
            solve_lwsw, torch.device("cuda", 0), call_args(t, concs), ncol,
            replicated_argnums=(0, 1))
        torch.cuda.synchronize()
        launched = counts()
    finally:
        torch.distributed.destroy_process_group()
    equal = all(torch.equal(g.flux_up, s.flux_up)
                and torch.equal(g.flux_dn, s.flux_dn)
                for g, s in zip(gathered, single))
    ok = size == 1 and launched["lwsw"] > 0 and equal
    if not ok:
        failures.append("distributed split")
    print(f"split: {'ok' if ok else 'FAIL'} NCCL process group of {size}, "
          f"distributed_columns_call(lw_sw_fluxes) {ncol}x{nlay} "
          f"launches={launched} | bitwise equal to the single call: "
          f"{equal} | group destroyed: "
          f"{not torch.distributed.is_initialized()}", flush=True)

    # ---- 11. profiling and gradients ----------------------------------------
    from ecckd_tpu_torch.utils import capture
    replayed = capture.jit(pipeline.lw_sw_fluxes)
    t_small = {k: cut(v) for k, v in t.items()}
    traced = (
        ("eager call", ncol, paths_run["lwsw"]),
        ("replayed call", ncol, lambda: replayed(*call_args(t, concs))),
        ("eager call", nsite * nexp, lambda: pipeline.lw_sw_fluxes(
            *call_args(t_small, small_concs))),
        ("replayed call", nsite * nexp,
         lambda: replayed(*call_args(t_small, small_concs))))
    for i, (label, n, drive) in enumerate(traced):
        drive()
        drive()     # a captured call: warm-up, capture
        torch.cuda.synchronize()
        r = trace_call(drive, os.path.join(work, f"trace{i}"))
        if r is not None and not r["name"]:
            r = None
        if r is None:
            failures.append(f"profile {label} {n}")
            print(f"profile: FAIL {label} {n}x{nlay}: no lwsw_kernel in the "
                  "trace, or no call span", flush=True)
            continue
        print(f"profile: ok {label} {n}x{nlay}: trace names "
              f"{r['name'][:60]!r} | call {r['call_ms']:.3f} ms (profiler "
              f"on), device time {r['device_ms']:.3f} ms in {r['kernels']} "
              f"kernels, lwsw_kernel {r['lwsw_ms']:.3f} ms, device busy "
              f"{r['busy_ms']:.3f} ms, idle share {r['idle']:.4f}, first "
              f"device event at +{r['lead_ms']:.3f} ms | CUDA runtime in the "
              "call: " + ", ".join(f"{k} x{n} {ms:.3f} ms"
                                   for k, n, ms in r["runtime"][:5])
              + f" | on {card}", flush=True)
    del replayed

    n_g = 2048
    g = {k: v[:n_g] for k, v in t.items()}
    concs_g = GasConcs(values=tuple(v[:n_g] if v.ndim else v
                                    for v in concs.values),
                       names=concs.names)
    tlay_g = g["tlay"].clone().requires_grad_()
    lw_call = lambda tl, **kw: pipeline.lw_fluxes(
        lw32, g["plev"], tl, g["tlev"], g["tsfc"], g["emis"], concs_g, **kw)
    reset_counts()
    loss = lw_call(tlay_g).flux_dn[:, -1].sum()
    loss.backward()
    torch.cuda.synchronize()
    launched = counts()
    refused = []
    for name, call in (
            ("backend='cuda'", lambda: lw_call(tlay_g, backend="cuda")),
            ("lw_fluxes_cuda", lambda: lw.lw_fluxes_cuda(
                lw32, g["plev"], tlay_g, g["tlev"], g["tsfc"],
                g["emis"][:, None].expand(-1, lw32.ngpt), concs_g))):
        try:
            call()
        except ValueError as e:
            refused.append(name if "requires grad" in str(e) else None)
    checks = {
        "no kernel launched": all(v == 0 for v in launched.values()),
        "grad finite": tlay_g.grad is not None
        and bool(torch.isfinite(tlay_g.grad).all()),
        "warming raises surface down": tlay_g.grad is not None
        and float(tlay_g.grad.sum()) > 0,
        "cuda routes raise": refused == ["backend='cuda'", "lw_fluxes_cuda"],
    }
    ok = all(checks.values())
    if not ok:
        failures.append("gradients")
    print(f"gradients: {'ok' if ok else 'FAIL'} lw_fluxes(auto) {n_g}x{nlay} "
          f"float32 on the card, tlay requires grad: launches={launched} | "
          + " | ".join(f"{k}: {v}" for k, v in checks.items()), flush=True)


    # ---- 12. fast mode --------------------------------------------------------
    from ecckd_tpu_torch import config
    fast_abs = dict.fromkeys(KERNELS, 0.0)
    for i, case in enumerate(cuda_parity.CASES):
        kernel, name, ncol_c, nlay_c, n_ang, lk, sk, _, _ = case
        r = cuda_parity.run_case(models, case, seed=100 + i, mode="bf16")
        fast_abs[kernel] = max(fast_abs[kernel], r["max_abs"])
        if not r["ok"]:
            failures.append(f"fast parity {kernel} {name}")
        print(f"fast parity: {'ok' if r['ok'] else 'FAIL'} {kernel}_fast "
              f"{name} ({ncol_c}x{nlay_c}, {n_ang} angle(s), {lk or ''}"
              f"{'+' if lk and sk else ''}{sk or ''}) max|d|/scale vs fast "
              f"plain f64 {r['max_rel']:.3e} (bound {BOUND:.0e}), vs exact "
              f"plain f64 {r['max_rel_vs_exact']:.3e} (bound "
              f"{FAST_BOUND:.0e}, > 0) max|d|={r['max_abs']:.3e} W m-2",
              flush=True)

    fast_launches = {}
    config.set_mxu_precision("bf16")
    try:
        for name, drive in paths_run.items():
            reset_counts()
            fluxes = drive()
            torch.cuda.synchronize()
            launched = counts()
            fast_launches[name] = launched[f"{name}_fast"]
            outs = [o[:n_check] for f in fluxes for o in (f.flux_up,
                                                         f.flux_dn)]
            rel_f = max(flux_errors(outs, refs[name](mxu_mode="bf16"))[0])
            rel_e = max(flux_errors(outs, refs[name](mxu_mode="bf16x3"))[0])
            checks = {
                f"{name}_fast launches > 0": launched[f"{name}_fast"] > 0,
                "no other entry point": all(
                    v == 0 for k, v in launched.items()
                    if k != f"{name}_fast"),
                "finite": all(bool(torch.isfinite(o).all()) for f in fluxes
                              for o in (f.flux_up, f.flux_dn)),
                f"first {n_check} columns vs fast plain f64": rel_f <= BOUND,
                "vs exact plain f64": 0.0 < rel_e <= FAST_BOUND,
            }
            ok = all(checks.values())
            if not ok:
                failures.append(f"fast main path {name}")
            print(f"fast path: {'ok' if ok else 'FAIL'} {name} (auto, "
                  f"mode bf16) {ncol}x{nlay} launches={launched} | "
                  + " | ".join(f"{k}: {v}" for k, v in checks.items())
                  + f" | max|d|/scale vs fast {rel_f:.3e}, vs exact "
                  f"{rel_e:.3e}", flush=True)
    finally:
        config.set_mxu_precision("bf16x3")

    fast_refs = driver_refs("bf16")
    for name, drive, ckd, outputs in drivers:
        out_dir = os.path.join(work, f"fast_{name}")
        metrics = os.path.join(out_dir, "metrics.json")
        reset_counts()
        try:
            rc = drive([rfmip, *ckd, "--device", "cuda", "--output-dir",
                        out_dir, "--metrics-json", metrics, "--fast"])
            torch.cuda.synchronize()
        finally:
            config.set_mxu_precision("bf16x3")
        launched = counts()
        with open(metrics) as f:
            driver_m = json.load(f)
        got = [torch.as_tensor(read_fluxes(os.path.join(out_dir, v + stem),
                                           v)) for v in outputs]
        rel_f = max(flux_errors(got, [fast_refs[v].cpu()
                                      for v in outputs])[0])
        rel_e = max(flux_errors(got, [ref_files[v].cpu()
                                      for v in outputs])[0])
        checks = {
            "rc == 0": rc == 0,
            f"{name}_fast launches > 0": launched[f"{name}_fast"] > 0,
            "no exact, f64 or Jacobian entry point": all(
                launched[k] == 0 for k in (*KERNELS, "lwsw_f64",
                                           "lwsw_jac")),
            "metrics": (driver_m["mxu_precision"], driver_m["io_engine"])
            == ("bf16", "native"),
            "finite": all(bool(torch.isfinite(g).all()) for g in got),
            "vs fast plain f64": rel_f <= BOUND,
            "vs exact plain f64": 0.0 < rel_e <= FAST_BOUND,
        }
        ok = all(checks.values())
        if not ok:
            failures.append(f"fast rfmip driver {name}")
        print(f"fast rfmip driver: {'ok' if ok else 'FAIL'} "
              f"{drive.__module__.split('.')[-1]} --fast {nsite}x{nexp}x"
              f"{nlay_r} launches={launched} | " + " | ".join(
                  f"{k}: {v}" for k, v in checks.items())
              + f" | max|d|/scale vs fast {rel_f:.3e}, vs exact {rel_e:.3e}",
              flush=True)

    # Times: exact, fast, fast, exact per kernel, now that the fast entry
    # points have run (the exact ones' times of phase 8 came before).
    fast_preps = {"lwsw": plan.prepare(*args["lwsw"], fast=True),
                  "lw": plan.prepare_lw(*args["lw"], fast=True),
                  "sw": plan.prepare_sw(*args["sw"], fast=True)}
    fast_times, fast_bounds = {}, {}
    for name in KERNELS:
        core = modules[name]._kernel_core
        exact = lambda: core(*preps[name], chunk)
        fast = lambda: core(*fast_preps[name], chunk)
        e1, f1, f2, e2 = (cuda_time_ms(fn) for fn in (exact, fast, fast,
                                                      exact))
        p_ms = cuda_time_ms(lambda: plain_core[name](*fast_preps[name]))
        fast_times[name] = (statistics.mean((f1, f2)), p_ms)
        fast_bounds[name] = kernel_bound(fast_preps[name])
        print(f"times: {name}_fast {ncol}x{nlay} 1 angle on {card}: kernel "
              f"{f1:.3f} / {f2:.3f} ms, fast plain f32 {p_ms:.3f} ms, bound "
              f"{fast_bounds[name]['bound_ms']:.4f} ms by "
              f"{fast_bounds[name]['bound_by']}, share "
              f"{fast_bounds[name]['bound_ms'] / fast_times[name][0]:.4f} | "
              f"exact kernel now {e1:.3f} / {e2:.3f} ms, in phase 8 (before "
              f"any fast launch) {times[name][0]:.3f} ms (median of 10 after "
              f"2 warm-up, CUDA events)", flush=True)

    # ---- 13. captured calls ---------------------------------------------------
    def leaves(out):
        out = out if isinstance(out, tuple) else (out,)
        return [x for f in out for x in (f.flux_up, f.flux_dn)]

    def equal(got, ref):
        return all(torch.equal(g, r) for g, r in zip(got, ref))

    def other_inputs(b):
        # Other tlay, tsfc and sza, night columns among them: a replay
        # must read its own inputs, not the captured call's.
        j = torch.arange(b["tlay"].shape[0], device="cuda").float()
        return dict(b, tlay=b["tlay"] + 4.0 * torch.cos(0.1 * j)[:, None],
                    tsfc=b["tsfc"] - 6.0, sza=b["sza"].flip(0))

    def lw_args(b, gases):
        return (lw32, b["plev"], b["tlay"], b["tlev"], b["tsfc"], b["emis"],
                gases)

    def sw_args(b, gases):
        return (sw32, b["plev"], b["tlay"], gases, b["alb"], b["tsi"],
                b["sza"])

    def prep_for(kernel, b, gases, n_ang=1):
        emis = b["emis"][:, None].expand(-1, lw32.ngpt).contiguous()
        if kernel == "lwsw":
            return plan.prepare(*call_args(b, gases)[:6], emis, gases,
                                b["alb"], b["tsi"], b["sza"], n_ang)
        if kernel == "lw":
            return plan.prepare_lw(*lw_args(b, gases)[:5], emis, gases,
                                   n_ang)
        return plan.prepare_sw(*sw_args(b, gases))

    deep_n = 300   # K1 stages these columns in device memory (phase 3)
    deep = example_flux_batch(16384, deep_n, np.float32, device="cuda")
    t_deep = {k: torch.as_tensor(v, device="cuda") for k, v in deep.items()
              if k != "concs"}
    both = ("bf16x3", "bf16")
    captured_paths = (  # label, kernel, fn, args, batch, gases, kw, modes
        ("K1", "lwsw", pipeline.lw_sw_fluxes, call_args, t, concs, {}, both),
        ("K2", "lwsw", pipeline.lw_sw_fluxes, call_args, t, concs,
         {"n_gauss_angles": 3}, ("bf16x3",)),
        ("K3", "lw", pipeline.lw_fluxes, lw_args, t, concs, {}, both),
        ("K4", "sw", pipeline.sw_fluxes, sw_args, t, concs, {}, both),
        ("K1", "lwsw", pipeline.lw_sw_fluxes, call_args, t_small,
         small_concs, {}, both),
        ("K3", "lw", pipeline.lw_fluxes, lw_args, t_small, small_concs, {},
         both),
        ("K4", "sw", pipeline.sw_fluxes, sw_args, t_small, small_concs, {},
         both),
        ("K1", "lwsw", pipeline.lw_sw_fluxes, call_args, t_deep,
         deep["concs"], {}, ("bf16x3",)),
        ("K1 f64", "lwsw", pipeline.lw_sw_fluxes,
         lambda b, gases: call_args(b, gases, lw64, sw64), t64, concs_p64,
         {}, ("bf16x3",)))
    for label, kernel, fn, make, b, gases, kw, modes in captured_paths:
        n, nl = b["tlay"].shape
        args_a, args_b = make(b, gases), make(other_inputs(b), gases)
        jitted = capture.jit(fn)
        for m, mode in enumerate(modes):
            config.set_mxu_precision(mode)
            try:
                name = (f"{kernel}_fast" if config.is_fast() else
                        f"{kernel}_f64" if b["tlay"].dtype == torch.float64
                        else kernel)
                reset_counts()
                ref_a = leaves(fn(*args_a, **kw))
                torch.cuda.synchronize()
                eager_counts = counts()
                ref_b = leaves(fn(*args_b, **kw))
                outs, per_call = [], []
                # warm-up, capture and replay, replay on new inputs, replay
                for args in (args_a, args_a, args_b, args_a):
                    reset_counts()
                    outs.append(leaves(jitted(*args, **kw)))
                    torch.cuda.synchronize()
                    per_call.append(counts())
            finally:
                config.set_mxu_precision("bf16x3")
            ptrs = [o.data_ptr() for out in outs for o in out]
            checks = {
                "warm-up, capture, replays equal eager bitwise": equal(
                    outs[0], ref_a) and equal(outs[1], ref_a)
                and equal(outs[3], ref_a),
                "replay on new inputs equals eager on them": equal(outs[2],
                                                                   ref_b),
                "fresh tensors, earlier ones unchanged": len(set(ptrs))
                == len(ptrs),
                f"per call {name} launches == eager's": eager_counts[name] > 0
                and all(v == 0 for k, v in eager_counts.items() if k != name)
                and all(c == eager_counts for c in per_call),
                "captured anew per table mode": len(jitted.entries) == m + 1
                and all(e.graph is not None
                        for e in jitted.entries.values()),
            }
            ok = all(checks.values())
            if not ok:
                failures.append(f"captured {label} {n}x{nl} {mode}")
            print(f"captured: {'ok' if ok else 'FAIL'} {label} "
                  f"capture.jit({fn.__name__}) {n}x{nl} {kw or ''} mode "
                  f"{mode}: launches per call {eager_counts[name]} ({name}) "
                  "| " + " | ".join(f"{k}: {v}" for k, v in checks.items()),
                  flush=True)
        if label in ("K2", "K1 f64") or nl == deep_n:
            continue
        prep = prep_for(kernel, b, gases)
        eager = lambda: fn(*args_a, **kw)
        replay = lambda: jitted(*args_a, **kw)
        alone = lambda: modules[kernel]._kernel_core(*prep, chunk)
        ms = [cuda_time_ms(f) for f in (eager, replay, alone, alone, replay,
                                        eager)]
        print(f"captured times: {label} {fn.__name__} {n}x{nl} on {card}: "
              f"eager wrapper {ms[0]:.3f} / {ms[5]:.3f} ms, captured call "
              f"{ms[1]:.3f} / {ms[4]:.3f} ms, kernel alone {ms[2]:.3f} / "
              f"{ms[3]:.3f} ms (median of 10 after 2 warm-up, CUDA events, "
              "in the order eager, captured, kernel, kernel, captured, "
              "eager)", flush=True)
    del jitted

    # scale_bench's step (full outputs) eager and captured, at its chunk.
    step = scale_bench.make_step("full")
    captured_step = capture.jit(step)
    step_args = (*call_args(t, concs)[:7], t["alb"], t["tsi"], t["sza"],
                 concs)
    want = step(*step_args)
    got = [captured_step(*step_args) for _ in range(3)]
    ok = all(equal(g, want) for g in got)
    ms = [cuda_time_ms(f) for f in (
        lambda: step(*step_args), lambda: captured_step(*step_args),
        lambda: captured_step(*step_args), lambda: step(*step_args))]
    if not ok:
        failures.append("captured scale_bench step")
    print(f"captured: {'ok' if ok else 'FAIL'} scale_bench step (full "
          f"outputs) {ncol}x{nlay} on {card}: eager {ms[0]:.3f} / "
          f"{ms[3]:.3f} ms, captured {ms[1]:.3f} / {ms[2]:.3f} ms (median "
          f"of 10, CUDA events, eager, captured, captured, eager) | replays "
          f"equal the eager step bitwise: {ok}", flush=True)
    del captured_step

    # What capture refuses: inputs that require grad, and a function that
    # reads the card back inside the graph (the capture raises).
    refused = {}
    grad_jit = capture.jit(pipeline.lw_fluxes)
    try:
        grad_jit(*lw_args(dict(g, tlay=tlay_g), concs_g))
    except ValueError as e:
        refused["grad"] = "requires grad" in str(e)
    bad = capture.jit(lambda x: x * float(x.sum()))
    x = t["tsfc"].clone()
    bad(x)                     # the warm-up runs eagerly
    try:
        bad(x)                 # the capture
    except Exception as e:     # noqa: BLE001 (torch's capture error)
        refused["failed capture"] = type(e).__name__
    torch.cuda.synchronize()
    after = leaves(pipeline.lw_sw_fluxes(*call_args(t, concs)))
    checks = {"grad refused": refused.get("grad", False),
              "failed capture raised": "failed capture" in refused,
              "card usable after": equal(after, leaves(paths_run["lwsw"]()))}
    ok = all(checks.values())
    if not ok:
        failures.append("capture refusals")
    print(f"captured: {'ok' if ok else 'FAIL'} refusals {refused} | "
          + " | ".join(f"{k}: {v}" for k, v in checks.items()), flush=True)

    # ---- 14. the bench: bench_cuda.py off-protocol, into a scratch dir ----
    import bench_cuda

    def bench_line(argv):
        """(exit code, parsed last line or None) of bench_cuda.main."""
        import contextlib
        import io
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = bench_cuda.main(argv, artifact_dir=bench_dir)
        except SystemExit as e:       # a failed gate or a refusal
            rc = e.code
        lines = buf.getvalue().strip().splitlines()
        try:
            return rc, json.loads(lines[-1])
        except (IndexError, ValueError):
            return rc, None

    def root_state():
        root = os.path.dirname(os.path.abspath(bench_cuda.__file__))
        return {n: os.path.isfile(os.path.join(root, n))
                and os.stat(os.path.join(root, n)).st_mtime_ns
                for n in os.listdir(root)}

    bench_dir = os.path.join(work, "bench_artifacts")
    os.makedirs(bench_dir)
    before = root_state()
    n_cfg = 8192
    bench_runs = (  # argv, the kernel entry that must run, the ones that not
        (["--mode", "headline", "--ncol", str(ncol)], ("lwsw",),
         ("lw", "sw", "lwsw_fast", "lwsw_f64", "lwsw_jac")),
        (["--mode", "headline", "--ncol", str(ncol), "--fast"],
         ("lwsw_fast",), ("lwsw", "lw", "sw", "lwsw_f64", "lwsw_jac")),
        (["--mode", "configs", "--ncol", str(n_cfg)], ("lwsw", "lw"),
         ("sw", "lwsw_fast", "lw_fast", "lwsw_f64", "lwsw_jac")),
        (["--mode", "configs", "--ncol", str(n_cfg), "--fast"],
         ("lwsw_fast", "lw_fast"),
         ("lwsw", "lw", "sw", "lwsw_f64", "lwsw_jac")))
    for argv, ran, not_ran in bench_runs:
        reset_counts()
        rc, line = bench_line(argv)
        torch.cuda.synchronize()
        launched = counts()
        line = line or {}
        values = (list(line["configs"].values()) if "configs" in line
                  else [line.get("value", 0.0)])
        checks = {
            "rc == 0": rc == 0,
            "line parses": bool(line),
            "value > 0": all(v > 0 for v in values),
            "parity_ok": line.get("parity_ok") is True,
            "timed shape held": bool(line.get("parity_timed")) and all(
                r["ok"] for r in line["parity_timed"].values()),
            "off protocol": line.get("protocol") is False,
            "on the card": line.get("device") == card,
            f"{'/'.join(ran)} launched": all(launched[k] > 0 for k in ran),
            "no other entry point": all(launched[k] == 0 for k in not_ran),
        }
        ok = all(checks.values())
        if not ok:
            failures.append(f"bench {' '.join(argv)}")
        print(f"bench: {'ok' if ok else 'FAIL'} bench_cuda.py "
              f"{' '.join(argv)} launches={launched} | " + " | ".join(
                  f"{k}: {v}" for k, v in checks.items()), flush=True)
        print(f"bench line: {json.dumps(line)}", flush=True)
    rc, line = bench_line(["--mode", "cpu_baseline", "--ncol", "256"])
    line = line or {}
    written = sorted(os.listdir(bench_dir))
    checks = {"rc == 0": rc == 0, "line parses": bool(line),
              "value > 0": line.get("value", 0.0) > 0,
              "no artifact written off protocol": written == [],
              "nothing written to the repository root":
              root_state() == before}
    ok = all(checks.values())
    if not ok:
        failures.append("bench cpu_baseline / artifacts")
    print(f"bench: {'ok' if ok else 'FAIL'} bench_cuda.py --mode cpu_baseline"
          f" --ncol 256 | " + " | ".join(f"{k}: {v}"
                                         for k, v in checks.items()),
          flush=True)
    print(f"bench line: {json.dumps(line)}", flush=True)

    # ---- 15. depth sweep and the ring checker -------------------------------
    import contextlib
    import io
    t15 = time.perf_counter()
    for mode in ("bf16x3", "bf16"):
        config.set_mxu_precision(mode)
        try:   # the sweep's own notes (stderr) give way to one line a leg
            with contextlib.redirect_stderr(io.StringIO()):
                shapes = shape_sweep_cuda.sweep(ncol_time=SWEEP_NCOL,
                                                iters=4, epochs=1)
        finally:
            config.set_mxu_precision("bf16x3")
        for key, shape in shapes.items():
            for ang, leg in shape["angles"].items():
                ok = shape_sweep_cuda.judge(leg, mode)
                if not ok:
                    failures.append(f"sweep {key} {ang} angle(s) {mode}")
                p = leg["plan"]
                print(f"sweep: {'ok' if ok else 'FAIL'} nlay {shape['nlay']}"
                      f" {ang} angle(s) {mode}: parity "
                      f"{leg['parity']['max_rel']:.3e}"
                      + (f" (vs exact {leg['parity']['vs_exact']:.3e})"
                         if "vs_exact" in leg["parity"] else "")
                      + f", after timing {leg['parity_timed']['max_rel']:.3e}"
                      f" | {leg['columns_per_sec']:,.0f} columns/s at "
                      f"{SWEEP_NCOL} columns, kernel {leg['kernel_ms']:.3f}"
                      f" ms, share {leg['share']:.3f} | C = {p['C']}, S = "
                      f"{p['S']}, {p['threads']} threads x "
                      f"{p['blocks_per_sm']} per SM, {p['staging']} | first "
                      f"call {leg['first_call_seconds']:.2f} s", flush=True)
    t_wait = time.perf_counter()
    for job in checked_jobs:
        job.result()
    pool.shutdown()
    wait_s = time.perf_counter() - t_wait
    ring = cuda_sanitize.run_checked(
        configs=RING_CHECKED, plant_configs=RING_PLANT,
        f64_configs=cuda_sanitize.CHECKED_F64, wide_configs=RING_WIDE,
        wide_f64_configs=[], jac_configs=RING_JAC,
        runs=[(0, 0, None), (cuda_sanitize.SEEDS[0],
                             cuda_sanitize.JITTER_NS, cuda_sanitize.BLOCKS)])
    if not ring["clean"]:
        failures.append("ring check")
    if not ring["pass"]:
        failures.append(f"planted fault caught {ring['plant_caught']}")
    print(f"ring check: {'ok' if ring['pass'] else 'FAIL'} "
          f"{ring['configurations']} configurations, {ring['runs']} runs "
          f"clean: {ring['clean']}; planted fault caught "
          f"{ring['plant_caught']}", flush=True)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s (of which "
          f"{wait_s:.1f} s waiting for the checked builds started in phase "
          "2)", flush=True)

    if failures:
        print(f"chip_smoke: FAIL {failures}", file=sys.stderr)
        return 1
    print(card)
    # (entry name, kernel, key of its records, the records)
    entries = [(name, name, name, main_launches, worst_abs, times, bounds)
               for name in KERNELS]
    entries += [(f"{name}_fast", name, name, fast_launches, fast_abs,
                 fast_times, fast_bounds) for name in KERNELS]
    entries.append(("lwsw_f64", "lwsw", "lwsw_f64", main_launches,
                    worst_abs, times, bounds))
    entries.append(("lwsw_jac", "lwsw", "lwsw_jac", main_launches,
                    worst_abs, times, bounds))
    # library_ms: no one PyTorch call computes gas optics and a solver.
    # plain_ms: the plain version at the entry's precision (f32, or f64).
    print(json.dumps({"kernels": [{
        "name": entry, "route": "cuda",
        "source": KERNELS[kernel][0], "replaces": KERNELS[kernel][1],
        "launches": launches[key], "max_abs_err": err[key],
        "ms": tm[key][0], "plain_ms": tm[key][1],
        "bound_ms": bd[key]["bound_ms"], "bound_by": bd[key]["bound_by"],
        "library_ms": None}
        for entry, kernel, key, launches, err, tm, bd in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
