"""Combined longwave + shortwave RFMIP driver (counterpart of
``ecckd_tpu.cli.ecckd_rfmip``).

The reference ships two executables run back to back
(example/rfmip-rad-irf/ecckd_rfmip_lw.F90, _sw.F90); climate workloads
need both bands over the same atmosphere.  This driver reads the RFMIP
file once and computes all four flux products (rlu/rld/rsu/rsd) with
``pipeline.lw_sw_fluxes``, one call per local card over its piece of the
columns (cli/common.split_call): on a CUDA device at f32 that is the
merged kernel (csrc/lwsw.cu) for a pair on one (p, T) grid, and the LW
and SW kernels otherwise.

Usage: python -m ecckd_tpu_torch.cli.ecckd_rfmip <rfmip_file> <lw_ckd>
       <sw_ckd> [-f 1|2] [-p 1|2] [--device cuda|cpu] [--heating-rates] ...
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ecckd_tpu_torch.cli import common
from ecckd_tpu_torch.config import numpy_dtype
from ecckd_tpu_torch.io.rfmip import write_fluxes
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.pipeline import clamp_top_pressure, lw_sw_fluxes
from ecckd_tpu_torch.utils import profiling


def main(argv=None) -> int:
    p = common.make_parser("ecckd_rfmip")
    # The standard parser's ``ecckd_file`` slot is the LW file; one more
    # positional takes the SW file.
    p.add_argument("sw_ecckd_file", help="ecckd SW ckd-definition file")
    args = p.parse_args(argv)
    n_quad_angles = 3 if args.physics_index == 2 else 1
    print(f" Using forcing index {args.forcing_index} and physics index "
          f"{args.physics_index}", file=sys.stderr)

    data, model_lw, device = common.load_inputs(args)
    model_sw = load_ckd_model(args.sw_ecckd_file, dtype=model_lw.dtype,
                              device=device)
    if not model_lw.source_is_internal():
        print("ecckd_rfmip: first ckd file isn't for longwave.",
              file=sys.stderr)
        return 1
    if not model_sw.source_is_external():
        print("ecckd_rfmip: second ckd file isn't for shortwave.",
              file=sys.stderr)
        return 1
    dtype = numpy_dtype(model_lw.dtype)

    top_at_1 = data.top_at_1
    press_min = max(model_lw.get_press_min(), model_sw.get_press_min())
    plev = clamp_top_pressure(data.plev.astype(dtype), press_min, top_at_1)
    concs = common.build_gas_concs(data, dtype, device)
    if args.validate:
        from ecckd_tpu_torch.utils.checks import validate_inputs
        validate_inputs(plev, data.tlay, data.tlev, press_min=press_min,
                        press_max=min(model_lw.get_press_max(),
                                      model_sw.get_press_max()))
    plev_t, tlay, tlev, tsfc, emis, alb, tsi, sza = common.on_device(
        [plev, data.tlay.astype(dtype), data.tlev.astype(dtype),
         data.sfc_t.astype(dtype), data.sfc_emis.astype(dtype),
         data.sfc_alb.astype(dtype), data.tsi.astype(dtype),
         data.sza.astype(dtype)], device)

    solve = lambda ml, ms, *a: lw_sw_fluxes(
        ml, ms, *a, n_gauss_angles=n_quad_angles, top_at_1=top_at_1,
        backend=args.backend)
    with common.Timer("lw+sw flux solve") as t:
        (flw, fsw), n_devices = common.split_call(
            solve, (model_lw, model_sw, plev_t, tlay, tlev, tsfc, emis, concs,
                    alb, tsi, sza), data.ncol, device, args.no_shard,
            replicated_argnums=(0, 1))
        profiling.barrier(flw.flux_up, flw.flux_dn, fsw.flux_up, fsw.flux_dn)

    out = {}
    for name, arr in (("rlu", flw.flux_up), ("rld", flw.flux_dn),
                      ("rsu", fsw.flux_up), ("rsd", fsw.flux_dn)):
        out[name] = arr.cpu().numpy()[:data.ncol]
    if args.validate and not all(np.isfinite(a).all()
                                 for a in out.values()):
        print("ecckd_rfmip: non-finite fluxes in output", file=sys.stderr)
        return 1
    if not common.writes_files():
        return 0
    if args.metrics_json:
        # Both bands' sanity ranges: an SW-only regression must show too.
        sw_up, sw_dn = out["rsu"], out["rsd"]
        common.write_metrics(
            args.metrics_json, ncol=data.ncol, seconds=t.seconds,
            args=args, fluxes=flw, n_devices=n_devices,
            extra={"driver": "lwsw", "n_quad_angles": n_quad_angles,
                   "sw_flux_up_range": [float(sw_up.min()),
                                        float(sw_up.max())],
                   "sw_flux_dn_range": [float(sw_dn.min()),
                                        float(sw_dn.max())],
                   "sw_all_finite": bool(np.isfinite(sw_up).all()
                                         and np.isfinite(sw_dn).all())})
    # LW file names carry the physics index; SW files are always p1
    # (ecckd_rfmip_lw.F90:59-62 vs ecckd_rfmip_sw.F90:56-57).
    lw_sfx = f"r1i1p{args.physics_index}f{args.forcing_index}_gn.nc"
    sw_sfx = f"r1i1p1f{args.forcing_index}_gn.nc"
    sfx = {"rlu": lw_sfx, "rld": lw_sfx, "rsu": sw_sfx, "rsd": sw_sfx,
           "hrl": lw_sfx, "hrs": sw_sfx}
    os.makedirs(args.output_dir, exist_ok=True)
    for name in ("rlu", "rld", "rsu", "rsd"):
        path = os.path.join(args.output_dir,
                            f"{name}_Efx_RTE-ecckd_rad-irf_{sfx[name]}")
        write_fluxes(path, name, out[name], data.nsite, data.nexp)
        print(f" Wrote {path}", file=sys.stderr)
    if args.heating_rates:
        from ecckd_tpu_torch.fluxes import heating_rate
        from ecckd_tpu_torch.io.rfmip import write_heating_rates
        for tag, up, dn in (("hrl", out["rlu"], out["rld"]),
                            ("hrs", out["rsu"], out["rsd"])):
            hr = heating_rate(*map(torch.as_tensor,
                                   (up, dn, plev[:data.ncol]))).numpy()
            path = os.path.join(args.output_dir,
                                f"{tag}_Efx_RTE-ecckd_rad-irf_{sfx[tag]}")
            write_heating_rates(path, tag, hr, data.nsite, data.nexp)
            print(f" Wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
