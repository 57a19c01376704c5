"""Shortwave RFMIP driver (counterpart of ``ecckd_tpu.cli.ecckd_rfmip_sw``).

The reference ``ecckd_rfmip_sw`` executable
(example/rfmip-rad-irf/ecckd_rfmip_sw.F90): gas optics + Rayleigh, TSI
renormalisation, two-stream/adding solve with night-column masking,
CMIP-format rsu/rsd output.  The columns are split over the local cards,
one ``pipeline.sw_fluxes`` call each (cli/common.split_call): on a CUDA
device at f32 that is the SW kernel (csrc/sw.cu).  The
reference hard-codes physics index 1 in the SW output file names
(ecckd_rfmip_sw.F90:56-57); reproduced.

Usage: python -m ecckd_tpu_torch.cli.ecckd_rfmip_sw <rfmip_file> <sw_ckd>
       [-f 1|2] [--device cuda|cpu] [--precision f32|f64] ...
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ecckd_tpu_torch.cli import common
from ecckd_tpu_torch.config import numpy_dtype
from ecckd_tpu_torch.io.rfmip import write_fluxes
from ecckd_tpu_torch.pipeline import clamp_top_pressure, sw_fluxes
from ecckd_tpu_torch.utils import profiling


def main(argv=None) -> int:
    args = common.make_parser("ecckd_rfmip_sw").parse_args(argv)
    print(f" Using forcing index {args.forcing_index} and physics index "
          f"{args.physics_index}", file=sys.stderr)

    data, model, device = common.load_inputs(args)
    if not model.source_is_external():
        print("ecckd_rfmip_sw: k-distribution file isn't for shortwave.",
              file=sys.stderr)
        return 1
    dtype = numpy_dtype(model.dtype)

    top_at_1 = data.top_at_1
    plev = clamp_top_pressure(data.plev.astype(dtype), model.get_press_min(),
                              top_at_1)
    concs = common.build_gas_concs(data, dtype, device)
    if args.validate:
        from ecckd_tpu_torch.utils.checks import validate_inputs
        validate_inputs(plev, data.tlay,
                        press_min=model.get_press_min(),
                        press_max=model.get_press_max())
    plev_t, tlay, alb, tsi, sza = common.on_device(
        [plev, data.tlay.astype(dtype), data.sfc_alb.astype(dtype),
         data.tsi.astype(dtype), data.sza.astype(dtype)], device)

    solve = lambda m, *a: sw_fluxes(m, *a, top_at_1=top_at_1,
                                    backend=args.backend)
    with common.Timer("sw flux solve") as t:
        fluxes, n_devices = common.split_call(
            solve, (model, plev_t, tlay, concs, alb, tsi, sza), data.ncol,
            device, args.no_shard, replicated_argnums=(0,))
        profiling.barrier(fluxes.flux_up, fluxes.flux_dn)

    up = fluxes.flux_up.cpu().numpy()[:data.ncol]
    dn = fluxes.flux_dn.cpu().numpy()[:data.ncol]
    if args.validate and not (np.isfinite(up).all()
                              and np.isfinite(dn).all()):
        print("ecckd_rfmip_sw: non-finite fluxes in output", file=sys.stderr)
        return 1
    if not common.writes_files():
        return 0
    if args.metrics_json:
        common.write_metrics(args.metrics_json, ncol=data.ncol,
                             seconds=t.seconds, args=args, fluxes=fluxes,
                             n_devices=n_devices, extra={"driver": "sw"})
    suffix = f"r1i1p1f{args.forcing_index}_gn.nc"
    os.makedirs(args.output_dir, exist_ok=True)
    up_path = os.path.join(args.output_dir,
                           f"rsu_Efx_RTE-ecckd_rad-irf_{suffix}")
    dn_path = os.path.join(args.output_dir,
                           f"rsd_Efx_RTE-ecckd_rad-irf_{suffix}")
    write_fluxes(up_path, "rsu", up, data.nsite, data.nexp)
    write_fluxes(dn_path, "rsd", dn, data.nsite, data.nexp)
    print(f" Wrote {up_path} and {dn_path}", file=sys.stderr)
    if args.heating_rates:
        from ecckd_tpu_torch.fluxes import heating_rate
        from ecckd_tpu_torch.io.rfmip import write_heating_rates
        hr = heating_rate(*map(torch.as_tensor,
                               (up, dn, plev[:data.ncol]))).numpy()
        hr_path = os.path.join(args.output_dir,
                               f"hrs_Efx_RTE-ecckd_rad-irf_{suffix}")
        write_heating_rates(hr_path, "hrs", hr, data.nsite, data.nexp)
        print(f" Wrote {hr_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
