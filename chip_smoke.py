#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (ecckd_tpu_torch).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero and no
result line is printed:

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit.
2. build: compiles csrc/lwsw.cu with nvcc from this checkout (timed).
3. models: writes the synthetic lw_fsck / sw_wide ckd files (shipped
   dimensions, values from a seed) and loads them with the port's loader.
4. parity: the merged LW+SW kernel (float32) against its plain PyTorch
   version at float64 on the card, case by case (RFMIP 1800 x 60,
   nlay 1/2/8/137, 2-4 Gauss angles, a chunked launch, the negative-entry
   model pair): max|d| / flux scale <= 5e-5 per output.
5. main path: pipeline.lw_sw_fluxes(backend="auto") on CUDA tensors at the
   65,536 x 60 protocol batch; the kernel's launch count must grow from 0,
   outputs be finite, SW TOA down equal mu0 * TSI by day and 0 by night,
   and the first columns match the float64 plain version.
6. times: kernel and plain float32 version at 65,536 x 60 with CUDA
   events (warm-up, median of 10), with the card's name and power limit.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  This script imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BOUND = 5e-5            # max|d| / flux scale, per output (tools/chip_parity.py)
PROTOCOL = (65536, 60)  # BENCH_CONFIGS protocol batch (columns, layers)
REPLACES = "ecckd_tpu/ops/pallas/lwsw.py:61"


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def parity_batch(ncol: int, nlay: int, seed: int):
    """Heterogeneous columns hitting the kernel's edge cases: surface
    pressures over 2.6 decades (every pressure-grid point at one layer
    index), temperatures past both Planck-table ends in every 8th column,
    h2o over five decades per cell (vmr floor and LUT top), ch4 below its
    reference, an unknown gas, day, grazing and night suns."""
    import numpy as np
    rng = np.random.default_rng(seed)
    p_sfc = np.logspace(np.log10(270.0), np.log10(1.05e5), ncol)
    rng.shuffle(p_sfc)
    p_top = 10.0 ** rng.uniform(np.log10(0.8), np.log10(4.0), ncol)
    plev = np.stack([np.logspace(np.log10(t), np.log10(s), nlay + 1)
                     for t, s in zip(p_top, p_sfc)])
    logp = np.log(0.5 * (plev[:, 1:] + plev[:, :-1]))
    tlay = (288.0 - 55.0 * np.exp(-((logp - np.log(1.5e4)) ** 2) / 4.0)
            + 3.0 * rng.standard_normal((ncol, nlay)))
    tlev = (288.0 - 55.0 * np.exp(-((np.log(plev) - np.log(1.5e4)) ** 2)
                                  / 4.0)
            + 3.0 * rng.standard_normal((ncol, nlay + 1)))
    extreme = np.arange(ncol) % 8 == 3
    tlay[extreme] = rng.uniform(100.0, 360.0, (int(extreme.sum()), nlay))
    tlev[extreme] = rng.uniform(100.0, 360.0, (int(extreme.sum()), nlay + 1))
    gases = dict(
        co2=np.full(ncol, 4.0e-4), ch4=np.full(ncol, 1.2e-6),
        n2o=np.full(ncol, 3.3e-7), o2=np.full(ncol, 0.2095),
        cfc11=np.full(ncol, 2.0e-10), cfc12=np.full(ncol, 5.0e-10),
        h2o=10.0 ** rng.uniform(-6.8, -1.5, (ncol, nlay)),
        o3=10.0 ** rng.uniform(-8.0, -5.2, (ncol, nlay)),
        no2=np.full(ncol, 1.0e-9))
    arrays = dict(plev=plev, tlay=tlay, tlev=tlev,
                  tsfc=rng.uniform(110.0, 355.0, ncol),
                  emis=np.linspace(0.7, 1.0, ncol),
                  alb=np.linspace(0.02, 0.9, ncol),
                  tsi=np.full(ncol, 1361.0),
                  sza=np.linspace(0.0, 120.0, ncol))
    return arrays, gases


def on_card(arrays: dict, gases: dict, dtype, ngpt_lw: int):
    """numpy batch -> CUDA tensors + GasConcs (float32 values rounded once,
    so the float64 reference sees the kernel's exact inputs)."""
    import numpy as np
    import torch
    from ecckd_tpu_torch.gases import GasConcs
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        device="cuda", dtype=dtype)
    out = {k: t(v) for k, v in arrays.items()}
    out["emis"] = out["emis"][:, None].expand(-1, ngpt_lw).contiguous()
    out["concs"] = GasConcs.create([(k, t(v)) for k, v in gases.items()])
    return out


def solve(fn, lw, sw, b, **kw):
    return fn(lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"], b["emis"],
              b["concs"], b["alb"], b["tsi"], b["sza"], **kw)


def flux_errors(got, ref):
    """(max relative error per output over its band's flux scale, max
    absolute error) — the tools/chip_parity.py metric."""
    rel, absolute = [], 0.0
    for band in (slice(0, 2), slice(2, 4)):
        scale = max(float(r.abs().max()) for r in ref[band])
        for g, r in zip(got[band], ref[band]):
            d = float((g.double() - r.double()).abs().max())
            rel.append(d / scale)
            absolute = max(absolute, d)
    return rel, absolute


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


def main() -> int:
    import torch
    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("device: FAIL torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)

    import numpy as np
    from ecckd_tpu_torch import pipeline
    from ecckd_tpu_torch.io.synthetic import (example_flux_batch,
                                              write_synthetic_ckd)
    from ecckd_tpu_torch.models.loader import load_ckd_model
    from ecckd_tpu_torch.ops.cuda import build, lwsw, plan

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build("lwsw")
    lwsw._library()
    ptxas = [ln.strip() for ln in open(f"{lib_path}.ptxas.txt")
             if "registers" in ln or "spill" in ln]
    print(f"build: ok {time.perf_counter() - t0:.2f} s "
          f"{os.path.relpath(lib_path)} | " + " | ".join(ptxas), flush=True)

    # ---- 3. models ------------------------------------------------------
    models = {}
    with tempfile.TemporaryDirectory() as d:
        for key, kind, neg in (("lw", "lw_fsck", False),
                               ("sw", "sw_wide", False),
                               ("lw_neg", "lw_fsck", True),
                               ("sw_neg", "sw_wide", True)):
            path = os.path.join(d, f"{key}.nc")
            write_synthetic_ckd(path, kind, seed=7, negative_entry=neg)
            for dt in (torch.float32, torch.float64):
                models[key, dt] = load_ckd_model(path, dtype=dt,
                                                 device="cuda")
    lw32, sw32 = models["lw", torch.float32], models["sw", torch.float32]
    print(f"models: ok lw_fsck ngpt={lw32.ngpt} nband={lw32.nband} "
          f"planck={lw32.planck_function.shape[0]} | sw_wide "
          f"ngpt={sw32.ngpt} nband={sw32.nband} | grid "
          f"{tuple(lw32.temperature_grid.shape)} mergeable="
          f"{plan.models_mergeable(lw32, sw32)}", flush=True)

    # ---- 4. parity: kernel (f32) vs plain (f64) on the card -------------
    failures = []
    worst_abs = 0.0
    cases = [  # name, ncol, nlay, angles, pair, column chunk
        ("nlay1", 1037, 1, 1, "", None), ("nlay2", 1037, 2, 1, "", None),
        ("nlay8", 1037, 8, 1, "", None),
        ("rfmip_1800x60", 1800, 60, 1, "", None),
        ("rfmip_1800x60_chunk768", 1800, 60, 1, "", 768),
        ("nlay137", 1037, 137, 1, "", None),
        ("angles2_nlay60", 1037, 60, 2, "", None),
        ("angles3_nlay60", 1037, 60, 3, "", None),
        ("angles4_nlay60", 1037, 60, 4, "", None),
        ("negative_entry_nlay60", 1037, 60, 1, "_neg", None),
        ("negative_entry_angles3", 1037, 60, 3, "_neg", None),
    ]
    for i, (name, ncol, nlay, n_ang, pair, chunk) in enumerate(cases):
        arrays, gases = parity_batch(ncol, nlay, seed=100 + i)
        lw_m, sw_m = models["lw" + pair, torch.float32], models[
            "sw" + pair, torch.float32]
        b32 = on_card(arrays, gases, torch.float32, lw_m.ngpt)
        b64 = on_card(arrays, gases, torch.float64, lw_m.ngpt)
        got = solve(lwsw.lwsw_fluxes_cuda, lw_m, sw_m, b32,
                    n_gauss_angles=n_ang,
                    column_chunk=chunk or lwsw.DEFAULT_COLUMN_CHUNK)
        ref = solve(lwsw.lwsw_fluxes_plain, models["lw" + pair, torch.float64],
                    models["sw" + pair, torch.float64], b64,
                    n_gauss_angles=n_ang)
        torch.cuda.synchronize()
        rel, absolute = flux_errors(got, ref)
        worst_abs = max(worst_abs, absolute)
        ok = max(rel) <= BOUND and all(bool(torch.isfinite(g).all())
                                       for g in got)
        if not ok:
            failures.append(name)
        print(f"parity: {'ok' if ok else 'FAIL'} {name} ({ncol}x{nlay}, "
              f"{n_ang} angle(s)) max|d|/scale lw_up={rel[0]:.3e} "
              f"lw_dn={rel[1]:.3e} sw_up={rel[2]:.3e} sw_dn={rel[3]:.3e} "
              f"max|d|={absolute:.3e} W m-2 (bound {BOUND:.0e})", flush=True)

    # ---- 5. main path ----------------------------------------------------
    ncol, nlay = PROTOCOL
    batch = example_flux_batch(ncol, nlay, np.float32, device="cuda")
    t = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()
         if k != "concs"}
    lwsw.lwsw_fluxes_cuda.launches = 0
    lw_f, sw_f = pipeline.lw_sw_fluxes(
        lw32, sw32, t["plev"], t["tlay"], t["tlev"], t["tsfc"], t["emis"],
        batch["concs"], t["alb"], t["tsi"], t["sza"], backend="auto")
    torch.cuda.synchronize()
    launches = lwsw.lwsw_fluxes_cuda.launches
    outs = (lw_f.flux_up, lw_f.flux_dn, sw_f.flux_up, sw_f.flux_dn)
    day = batch["sza"] < 90.0 - 2.0 * float(np.spacing(np.float32(90.0)))
    mu0_tsi = 1361.0 * np.cos(np.deg2rad(batch["sza"].astype(np.float64)))
    toa = sw_f.flux_dn[:, 0].double().cpu().numpy()
    night = torch.as_tensor(~day, device="cuda")
    # The first columns against the float64 plain version.
    n_check = 2048
    b64 = on_card({k: v[:n_check] for k, v in batch.items() if k != "concs"},
                  {n: v[:n_check].cpu().numpy() for n, v in zip(
                      batch["concs"].names, batch["concs"].values)},
                  torch.float64, lw32.ngpt)
    ref = solve(lwsw.lwsw_fluxes_plain, models["lw", torch.float64],
                models["sw", torch.float64], b64)
    rel, _ = flux_errors([o[:n_check] for o in outs], ref)
    checks = {
        "launches > 0": launches > 0,
        "shapes": all(tuple(o.shape) == (ncol, nlay + 1) for o in outs),
        "finite": all(bool(torch.isfinite(o).all()) for o in outs),
        # mu0 is cos of a float32 angle: grazing columns need an absolute
        # tolerance (1e-5 of the TSI).
        "sw toa dn == mu0*tsi (day)": bool(np.allclose(
            toa[day], mu0_tsi[day], rtol=1e-5, atol=1e-5 * 1361.0)),
        "night sw == 0": bool((sw_f.flux_dn[night] == 0).all()
                              and (sw_f.flux_up[night] == 0).all()),
        f"first {n_check} columns vs plain f64": max(rel) <= BOUND,
    }
    ok = all(checks.values())
    if not ok:
        failures.append("main_path")
    print(f"main path: {'ok' if ok else 'FAIL'} lw_sw_fluxes(auto) "
          f"{ncol}x{nlay} launches={launches} | " + " | ".join(
              f"{k}: {v}" for k, v in checks.items())
          + f" | max|d|/scale={max(rel):.3e}", flush=True)

    # ---- 6. times ---------------------------------------------------------
    emis_gpt = t["emis"][:, None].expand(-1, lw32.ngpt).contiguous()
    args = (lw32, sw32, t["plev"], t["tlay"], t["tlev"], t["tsfc"], emis_gpt,
            batch["concs"], t["alb"], t["tsi"], t["sza"])
    prep = plan.prepare(*args)
    kernel_ms = cuda_time_ms(lambda: lwsw._kernel_core(
        prep, lwsw.DEFAULT_COLUMN_CHUNK))
    plain_ms = cuda_time_ms(lambda: lwsw._plain_core(prep))
    kernel_e2e_ms = cuda_time_ms(lambda: lwsw.lwsw_fluxes_cuda(*args))
    plain_e2e_ms = cuda_time_ms(lambda: lwsw.lwsw_fluxes_plain(*args))
    print(f"times: {ncol}x{nlay} 1 angle on {card}: kernel {kernel_ms:.3f} ms"
          f" ({ncol / kernel_ms * 1e3:.0f} columns/s), plain f32 "
          f"{plain_ms:.3f} ms ({ncol / plain_ms * 1e3:.0f} columns/s); "
          f"with host prep: kernel {kernel_e2e_ms:.3f} ms, plain "
          f"{plain_e2e_ms:.3f} ms (median of 10 after 2 warm-up, CUDA "
          f"events)", flush=True)

    if failures:
        print(f"chip_smoke: FAIL {failures}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": [{
        "name": "lwsw", "route": "cuda",
        "source": "ecckd_tpu_torch/csrc/lwsw.cu", "replaces": REPLACES,
        "launches": launches, "max_abs_err": worst_abs, "ms": kernel_ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
