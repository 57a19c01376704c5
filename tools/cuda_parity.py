"""On-card parity gate of the port's CUDA kernels, in both table modes.

The port's counterpart of tools/chip_parity.py: every kernel (float32) on
the card against its plain PyTorch version at float64 on the card, which
runs the same computation in the same table mode.  Imports no JAX.

Cases: the adversarial batch (pressures over 2.6 decades at the surface,
temperatures past both Planck-table ends in every 8th column, h2o over
five decades per cell, ch4 below its reference, an unknown gas, day,
grazing and night suns) through the merged kernel (K1/K2, lwsw.cu), the
LW kernel (K3, lw.cu) and the SW kernel (K4, sw.cu): nlay 1/2/8/60/137,
1-4 Gauss angles, a chunked launch, the negative-entry models, the
36-g-point lw_rrtmgp with its emissivity banded (16 bands; K1 and K3
at nlay 60 and 137, 1 and 3 angles, K3 at 4) and a SW model on a
47-point grid, the depths each kernel stages in device memory (K1
nlay 300, K3 600, K4 430), and a gas set without cfc11, cfc12 and n2o,
whose band shapes run each kernel's run-time instantiation (``CASES``).
The
synthetic ckd files always; with ``--data-dir``, also the shipped ecCKD
1.2 files in that directory, over tools/chip_parity.py's set of cases.

Each mode has its bound, under the JAX package's names (``BOUNDS``): the
kernel against the exact plain f64 version within 5e-5 of the flux scale
in ``bf16x3`` and 5e-4 in the fast mode ``bf16``, where it must also
differ (> 0); and in every mode within 5e-5 of the plain f64 version of
its own mode (``SAME_MODE_BOUND``).  The mode ``f64`` runs the merged
kernel's cases through its double instantiation (inputs and models in
float64, the exact table) against the plain f64 version with float64's
constants (``lwsw_fluxes_plain(compute=torch.float64)``), within
``F64_BOUND``; each such case also records the float32 kernel on the same
inputs, which must read above that bound.

Usage:
  python tools/cuda_parity.py [--out PARITY_CUDA.json]
                              [--modes bf16x3,bf16,f64]
                              [--data-dir DIR] [--ncol 549]
Writes one JSON artifact; exit status 0 iff every case is inside its
bounds.  chip_smoke.py runs ``run_case`` over ``CASES`` (phases 4, 12).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

# max|kernel - plain f64 exact| / flux scale per mode (tools/chip_parity.py).
BOUNDS = {"bf16x3": 5.0e-5, "bf16": 5.0e-4,
          "highest": 5.0e-5, "default": 5.0e-4}
SAME_MODE_BOUND = 5.0e-5
F64_MODE = "f64"
F64_BOUND = 1.0e-9
"""max|f64 kernel - plain f64| / flux scale: rounding in double, with room
for the few layers near the two-stream resonance; the float32 kernel reads
1e-7 and more on every case."""

SYNTHETIC = (  # model key, synthetic kind, negative entries, pressure points
    ("lw", "lw_fsck", False, 53), ("sw", "sw_wide", False, 53),
    ("lw_neg", "lw_fsck", True, 53), ("sw_neg", "sw_wide", True, 53),
    ("lw_rrtmgp", "lw_rrtmgp", False, 53), ("sw_p47", "sw_wide", False, 47))

SHIPPED = {"fsck": "ecckd-1.2_lw_ckd-definition_climate_fsck-tol0.0161.nc",
           "rrtmgp": "ecckd-1.2_lw_ckd-definition_climate_rrtmgp-tol0.061.nc",
           "wide": "ecckd-1.2_sw_ckd-definition_climate_wide-tol0.05.nc"}

# The shipped models' band shapes under the RFMIP gases run kernel
# instantiations with their g-points, gas counts and temperatures as
# template constants (csrc/staged.cuh); without these gases every band has
# fewer dense gases, so the kernels take their run-time instantiation.
RUNTIME_SHAPE_DROP = ("cfc11", "cfc12", "n2o")

# kernel, name, ncol, nlay, angles, lw model, sw model, column chunk,
# gases left out of the batch
CASES = [
    ("lwsw", "nlay1", 1037, 1, 1, "lw", "sw", None, ()),
    ("lwsw", "nlay2", 1037, 2, 1, "lw", "sw", None, ()),
    ("lwsw", "nlay8", 1037, 8, 1, "lw", "sw", None, ()),
    ("lwsw", "rfmip_1800x60", 1800, 60, 1, "lw", "sw", None, ()),
    ("lwsw", "rfmip_1800x60_chunk768", 1800, 60, 1, "lw", "sw", 768, ()),
    # nlay 137: the split route (LW rows in a device slice), each
    # instantiation of it.
    ("lwsw", "nlay137", 1037, 137, 1, "lw", "sw", None, ()),
    ("lwsw", "nlay137_angles3", 1037, 137, 3, "lw", "sw", None, ()),
    ("lwsw", "lw_rrtmgp_nlay137", 1037, 137, 1, "lw_rrtmgp", "sw", None,
     ()),
    ("lwsw", "lw_rrtmgp_nlay137_angles3", 1037, 137, 3, "lw_rrtmgp", "sw",
     None, ()),
    ("lwsw", "angles2_nlay60", 1037, 60, 2, "lw", "sw", None, ()),
    ("lwsw", "angles3_nlay60", 1037, 60, 3, "lw", "sw", None, ()),
    ("lwsw", "angles4_nlay60", 1037, 60, 4, "lw", "sw", None, ()),
    ("lwsw", "negative_entry_nlay60", 1037, 60, 1, "lw_neg", "sw_neg", None,
     ()),
    ("lwsw", "negative_entry_angles3", 1037, 60, 3, "lw_neg", "sw_neg",
     None, ()),
    ("lwsw", "lw_rrtmgp_nlay60", 1037, 60, 1, "lw_rrtmgp", "sw", None, ()),
    ("lwsw", "lw_rrtmgp_angles3", 1037, 60, 3, "lw_rrtmgp", "sw", None, ()),
    # lw_rrtmgp whole in shared memory, two blocks per SM (nlay <= 58).
    ("lwsw", "lw_rrtmgp_nlay47", 1037, 47, 1, "lw_rrtmgp", "sw", None, ()),
    # Columns too deep for shared memory: K1 stages them in device memory.
    ("lwsw", "nlay300_device_staging", 1037, 300, 1, "lw", "sw", None, ()),
    ("lwsw", "nlay300_device_staging_angles3", 1037, 300, 3, "lw", "sw",
     None, ()),
    ("lw", "rfmip_1800x60", 1800, 60, 1, "lw", None, None, ()),
    ("lw", "rfmip_1800x60_chunk768", 1800, 60, 1, "lw", None, 768, ()),
    ("lw", "nlay1", 1037, 1, 1, "lw", None, None, ()),
    ("lw", "nlay2", 1037, 2, 1, "lw", None, None, ()),
    ("lw", "nlay8", 1037, 8, 1, "lw", None, None, ()),
    ("lw", "nlay137", 1037, 137, 1, "lw", None, None, ()),
    ("lw", "angles2_nlay60", 1037, 60, 2, "lw", None, None, ()),
    ("lw", "angles3_nlay60", 1037, 60, 3, "lw", None, None, ()),
    ("lw", "angles4_nlay60", 1037, 60, 4, "lw", None, None, ()),
    ("lw", "negative_entry_nlay60", 1037, 60, 1, "lw_neg", None, None, ()),
    ("lw", "negative_entry_angles3", 1037, 60, 3, "lw_neg", None, None, ()),
    ("lw", "lw_rrtmgp_nlay60", 1037, 60, 1, "lw_rrtmgp", None, None, ()),
    ("lw", "lw_rrtmgp_angles3", 1037, 60, 3, "lw_rrtmgp", None, 512, ()),
    ("lw", "lw_rrtmgp_angles4", 1037, 60, 4, "lw_rrtmgp", None, None, ()),
    ("lw", "lw_rrtmgp_nlay137", 1037, 137, 1, "lw_rrtmgp", None, None, ()),
    ("lw", "lw_rrtmgp_nlay137_angles3", 1037, 137, 3, "lw_rrtmgp", None,
     None, ()),
    # Columns too deep for shared memory: K3 and K4 stage them in device
    # memory (ops/cuda/staged.py stage_plan).
    ("lw", "nlay600_device_staging", 1037, 600, 1, "lw", None, None, ()),
    ("lw", "nlay600_device_staging_angles3", 1037, 600, 3, "lw", None, None,
     ()),
    ("sw", "rfmip_1800x60", 1800, 60, 1, None, "sw", None, ()),
    ("sw", "rfmip_1800x60_chunk768", 1800, 60, 1, None, "sw", 768, ()),
    ("sw", "nlay1", 1037, 1, 1, None, "sw", None, ()),
    ("sw", "nlay2", 1037, 2, 1, None, "sw", None, ()),
    ("sw", "nlay8", 1037, 8, 1, None, "sw", None, ()),
    ("sw", "nlay137", 1037, 137, 1, None, "sw", None, ()),
    ("sw", "negative_entry_nlay60", 1037, 60, 1, None, "sw_neg", None, ()),
    ("sw", "sw_p47_nlay60", 1037, 60, 1, None, "sw_p47", None, ()),
    ("sw", "nlay430_device_staging", 1037, 430, 1, None, "sw", None, ()),
    # Other band shapes: the run-time instantiations in shared memory.
    ("lwsw", "runtime_shape_nlay60", 1037, 60, 1, "lw", "sw", None,
     RUNTIME_SHAPE_DROP),
    ("lwsw", "runtime_shape_lw_rrtmgp_angles3", 1037, 60, 3, "lw_rrtmgp",
     "sw", None, RUNTIME_SHAPE_DROP),
    ("lwsw", "runtime_shape_nlay137", 1037, 137, 1, "lw", "sw", None,
     RUNTIME_SHAPE_DROP),
    ("lw", "runtime_shape_nlay60", 1037, 60, 1, "lw", None, None,
     RUNTIME_SHAPE_DROP),
    ("lw", "runtime_shape_nlay137_angles3", 1037, 137, 3, "lw", None, None,
     RUNTIME_SHAPE_DROP),
    ("lw", "runtime_shape_lw_rrtmgp", 1037, 60, 1, "lw_rrtmgp", None, None,
     RUNTIME_SHAPE_DROP),
    ("sw", "runtime_shape_nlay60", 1037, 60, 1, None, "sw", None,
     RUNTIME_SHAPE_DROP),
    ("sw", "runtime_shape_sw_p47_nlay137", 1037, 137, 1, None, "sw_p47",
     None, RUNTIME_SHAPE_DROP),
]


def shipped_cases(ncol: int, nlay: int):
    """tools/chip_parity.py's set on the shipped files."""
    out = [("lw", f"shipped_fsck_angles{a}", ncol, nlay, a, "fsck", None,
            None, ()) for a in (1, 2, 3, 4)]
    out += [("lw", f"shipped_rrtmgp_angles{a}", ncol, nlay, a, "rrtmgp",
             None, None, ()) for a in (1, 3)]
    out += [("sw", "shipped_wide", ncol, nlay, 1, None, "wide", None, ())]
    out += [("lwsw", f"shipped_merged_fsck_angles{a}", ncol, nlay, a, "fsck",
             "wide", None, ()) for a in (1, 2, 3, 4)]
    out += [("lwsw", "shipped_merged_rrtmgp", ncol, nlay, 1, "rrtmgp",
             "wide", None, ())]
    return out


def adversarial_batch(ncol: int, nlay: int, seed: int):
    """Heterogeneous columns hitting the kernels' edge cases (numpy, f64):
    (arrays, gases)."""
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


def banded_emissivity(emis_col: np.ndarray, nband: int) -> np.ndarray:
    """(ncol, nband) emissivity that differs from band to band: each
    column's value scaled by 0.9-1.0 in steps that turn with the column."""
    ncol = emis_col.shape[0]
    step = (np.arange(ncol)[:, None] * 7 + np.arange(nband)[None, :] * 5
            ) % nband
    return emis_col[:, None] * (1.0 - 0.1 * step / nband)


def on_card(arrays: dict, gases: dict, dtype, ngpt_lw: int,
            device="cuda", gpt2band=None):
    """numpy batch -> tensors on ``device`` + GasConcs (float32 values
    rounded once, so the float64 reference sees the kernel's exact
    inputs).  "emis" is per g-point (the kernels' argument), "emis_col"
    per column (the pipeline's).  With ``gpt2band`` (an LW model's band
    of each g-point) over more than one band, the emissivity is banded
    (``banded_emissivity``), each band's value on its g-points."""
    import torch
    from ecckd_tpu_torch.gases import GasConcs
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        device=device, dtype=dtype)
    out = {k: t(v) for k, v in arrays.items()}
    out["emis_col"] = out["emis"]
    out["emis"] = out["emis"][:, None].expand(-1, ngpt_lw).contiguous()
    if gpt2band is not None and max(gpt2band) > 0:
        band = t(banded_emissivity(np.asarray(arrays["emis"]),
                                   max(gpt2band) + 1))
        out["emis"] = band[:, list(gpt2band)].contiguous()
    out["concs"] = GasConcs.create([(k, t(v)) for k, v in gases.items()])
    return out


def flux_errors(got, ref):
    """(max|d| / band flux scale per output, max|d|).  got/ref hold one
    band's (up, dn) or both bands' (lw_up, lw_dn, sw_up, sw_dn)."""
    rel, absolute = [], 0.0
    for band in range(0, len(ref), 2):
        scale = max(float(abs(r).max()) for r in ref[band:band + 2])
        for g, r in zip(got[band:band + 2], ref[band:band + 2]):
            d = float(abs(g.double() - r.double()).max())
            rel.append(d / scale)
            absolute = max(absolute, d)
    return rel, absolute


def solve(kernel: str, route: str, lw, sw, b, **kw):
    """One kernel's wrapper (route "cuda") or plain version ("plain") on
    batch b."""
    from ecckd_tpu_torch.ops.cuda import lw as lw_mod, lwsw, sw as sw_mod
    if kernel == "lwsw":
        fn = getattr(lwsw, f"lwsw_fluxes_{route}")
        return fn(lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                  b["emis"], b["concs"], b["alb"], b["tsi"], b["sza"], **kw)
    if kernel == "lw":
        fn = getattr(lw_mod, f"lw_fluxes_{route}")
        return fn(lw, b["plev"], b["tlay"], b["tlev"], b["tsfc"], b["emis"],
                  b["concs"], **kw)
    kw.pop("n_gauss_angles", None)
    fn = getattr(sw_mod, f"sw_fluxes_{route}")
    return fn(sw, b["plev"], b["tlay"], b["concs"], b["alb"], b["tsi"],
              b["sza"], **kw)


def run_case(models: dict, case, seed: int, mode: str) -> dict:
    """One case in one mode: the kernel at f32 (in ``F64_MODE``, its
    double instantiation at f64) against the plain version at f64 in the
    same table mode, and (in the fast mode) against the exact plain
    version.  ``models[key, dtype]`` are CUDA models."""
    import torch
    from ecckd_tpu_torch import config
    from ecckd_tpu_torch.ops.cuda.binding import DEFAULT_COLUMN_CHUNK
    kernel, name, ncol, nlay, n_ang, lk, sk, chunk, drop = case
    f32, f64 = torch.float32, torch.float64
    m = lambda key, dt: models[key, dt] if key else None
    arrays, gases = adversarial_batch(ncol, nlay, seed)
    gases = {k: v for k, v in gases.items() if k not in drop}
    ng = m(lk, f32).ngpt if lk else 1
    bands = m(lk, f32).gpt2band if lk else None
    b32, b64 = (on_card(arrays, gases, dt, ng, gpt2band=bands)
                for dt in (f32, f64))
    f64_mode = mode == F64_MODE
    table_mode = "bf16x3" if f64_mode else mode
    run = lambda dt, b: solve(kernel, "cuda", m(lk, dt), m(sk, dt), b,
                              n_gauss_angles=n_ang, mxu_mode=table_mode,
                              column_chunk=chunk or DEFAULT_COLUMN_CHUNK)
    got = run(f64, b64) if f64_mode else run(f32, b32)
    # the plain version with the constants of the kernel's compute type
    compute = {"compute": f64} if f64_mode else {}
    ref = solve(kernel, "plain", m(lk, f64), m(sk, f64), b64,
                n_gauss_angles=n_ang, mxu_mode=table_mode, **compute)
    torch.cuda.synchronize()
    rel, absolute = flux_errors(got, ref)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    out = {"kernel": kernel, "name": name, "shape": [ncol, nlay],
           "angles": n_ang, "models": [lk, sk], "gases_left_out": list(drop),
           "mode": mode,
           "max_rel": max(rel), "rel": rel, "max_abs": absolute,
           "finite": finite}
    if f64_mode:
        out["max_rel_f32"] = max(flux_errors(run(f32, b32), ref)[0])
        out["ok"] = (finite and max(rel) <= F64_BOUND
                     and out["max_rel_f32"] > F64_BOUND)
        return out
    ok = finite and max(rel) <= SAME_MODE_BOUND
    if config.is_fast(mode):
        exact = solve(kernel, "plain", m(lk, f64), m(sk, f64), b64,
                      n_gauss_angles=n_ang, mxu_mode="bf16x3")
        out["max_rel_vs_exact"] = max(flux_errors(got, exact)[0])
        ok = ok and 0.0 < out["max_rel_vs_exact"] <= BOUNDS[mode]
    out["ok"] = ok
    return out


def load_models(work: str, data_dir=None) -> dict:
    """Synthetic models (SYNTHETIC, seed 7) and, if ``data_dir`` holds
    them, the shipped ones, each at f32 and f64 on the card."""
    import torch
    from ecckd_tpu_torch.io.synthetic import write_synthetic_ckd
    from ecckd_tpu_torch.models.loader import load_ckd_model
    paths = {}
    for key, kind, neg, n_p in SYNTHETIC:
        paths[key] = os.path.join(work, f"{key}.nc")
        write_synthetic_ckd(paths[key], kind, seed=7, negative_entry=neg,
                            n_pressure=n_p)
    if data_dir:
        for key, name in SHIPPED.items():
            if os.path.isfile(os.path.join(data_dir, name)):
                paths[key] = os.path.join(data_dir, name)
    return {(key, dt): load_ckd_model(path, dtype=dt, device="cuda")
            for key, path in paths.items()
            for dt in (torch.float32, torch.float64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/cuda_parity.py")
    ap.add_argument("--out", default="PARITY_CUDA.json")
    ap.add_argument("--modes", default="bf16x3,bf16,f64")
    ap.add_argument("--data-dir", default=None,
                    help="directory holding the shipped ecCKD 1.2 ckd files")
    ap.add_argument("--ncol", type=int, default=549,
                    help="columns of the shipped-file cases")
    ap.add_argument("--nlay", type=int, default=60)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cuda_parity: no CUDA card", file=sys.stderr)
        return 1
    from ecckd_tpu_torch import config
    modes = args.modes.split(",")
    for mode in modes:
        if mode != F64_MODE:
            config.is_fast(mode)   # an unknown mode string raises here
    from ecckd_tpu_torch.utils.profiling import card_name
    card = card_name()
    with tempfile.TemporaryDirectory() as work:
        models = load_models(work, args.data_dir)
    cases = list(CASES)
    shipped = all((k, torch.float32) in models for k in SHIPPED)
    if shipped:
        cases += shipped_cases(args.ncol, args.nlay)
    results, ok = {}, True
    for mode in modes:
        rows = []
        for i, case in enumerate(cases):
            if mode == F64_MODE and case[0] != "lwsw":
                continue           # float64 runs on the merged kernel alone
            r = run_case(models, case, seed=100 + i, mode=mode)
            rows.append(r)
            ok = ok and r["ok"]
            print(f"[{mode}] {'ok' if r['ok'] else 'FAIL'} {r['kernel']} "
                  f"{r['name']}: max_rel {r['max_rel']:.3e} (same mode)"
                  + (f", {r['max_rel_vs_exact']:.3e} vs exact"
                     if "max_rel_vs_exact" in r else "")
                  + (f", float32 kernel {r['max_rel_f32']:.3e}"
                     if "max_rel_f32" in r else ""), file=sys.stderr)
        f64_mode = mode == F64_MODE
        key = ("max_rel_vs_exact" if not f64_mode and config.is_fast(mode)
               else "max_rel")
        results[mode] = {
            "bound": F64_BOUND if f64_mode else BOUNDS[mode],
            "same_mode_bound": F64_BOUND if f64_mode else SAME_MODE_BOUND,
            "worst_max_rel": max(r["max_rel"] for r in rows),
            "worst_vs_exact": max(r[key] for r in rows),
            "pass": all(r["ok"] for r in rows), "cases": rows}
    out = {"generated_by": "tools/cuda_parity.py",
           "date": datetime.date.today().isoformat(), "card": card,
           "reference": "plain PyTorch version at float64 on the card",
           "shipped_files": shipped,
           "pass": ok, "modes": results}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"cuda parity: {'PASS' if ok else 'FAIL'} -> {args.out} on {card}")
    for mode, r in results.items():
        print(f"  {mode}: worst vs exact {r['worst_vs_exact']:.3e} (bound "
              f"{r['bound']:.1e}), worst vs its own mode "
              f"{r['worst_max_rel']:.3e} (bound {r['same_mode_bound']:.1e})"
              f" over {len(r['cases'])} cases")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
