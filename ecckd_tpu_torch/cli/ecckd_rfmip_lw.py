"""Longwave RFMIP driver (counterpart of ``ecckd_tpu.cli.ecckd_rfmip_lw``).

The reference ``ecckd_rfmip_lw`` executable
(example/rfmip-rad-irf/ecckd_rfmip_lw.F90): reads the RFMIP atmosphere,
computes gas optics and Planck sources, solves longwave fluxes with 1 or 3
quadrature angles (physics index), writes CMIP-format rlu/rld files.  The
columns are split over the local cards, one ``pipeline.lw_fluxes`` call
each (cli/common.split_call; ``--no-shard``: one call, ``--num-processes``:
one piece per process): on a CUDA device at f32 that is the LW kernel
(csrc/lw.cu).

Usage: python -m ecckd_tpu_torch.cli.ecckd_rfmip_lw <rfmip_file> <lw_ckd>
       [-f 1|2] [-p 1|2] [--device cuda|cpu] [--precision f32|f64] ...
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ecckd_tpu_torch.cli import common
from ecckd_tpu_torch.config import numpy_dtype
from ecckd_tpu_torch.io.rfmip import write_fluxes
from ecckd_tpu_torch.pipeline import clamp_top_pressure, lw_fluxes
from ecckd_tpu_torch.utils import profiling


def main(argv=None) -> int:
    args = common.make_parser("ecckd_rfmip_lw").parse_args(argv)
    n_quad_angles = 3 if args.physics_index == 2 else 1
    print(f" Using forcing index {args.forcing_index} and physics index "
          f"{args.physics_index}", file=sys.stderr)

    data, model, device = common.load_inputs(args)
    if not model.source_is_internal():
        print("ecckd_rfmip_lw: k-distribution file isn't for longwave.",
              file=sys.stderr)
        return 1
    dtype = numpy_dtype(model.dtype)

    top_at_1 = data.top_at_1
    plev = clamp_top_pressure(data.plev.astype(dtype), model.get_press_min(),
                              top_at_1)
    concs = common.build_gas_concs(data, dtype, device)
    if args.validate:
        from ecckd_tpu_torch.utils.checks import validate_inputs
        validate_inputs(plev, data.tlay, data.tlev,
                        press_min=model.get_press_min(),
                        press_max=model.get_press_max())
    arrays = common.on_device(
        [plev, data.tlay.astype(dtype), data.tlev.astype(dtype),
         data.sfc_t.astype(dtype), data.sfc_emis.astype(dtype)], device)

    solve = lambda m, *a: lw_fluxes(m, *a, n_gauss_angles=n_quad_angles,
                                    top_at_1=top_at_1, backend=args.backend)
    with common.Timer("lw flux solve") as t:
        fluxes, n_devices = common.split_call(
            solve, (model, *arrays, concs), data.ncol, device, args.no_shard,
            replicated_argnums=(0,))
        profiling.barrier(fluxes.flux_up, fluxes.flux_dn)

    up = fluxes.flux_up.cpu().numpy()[:data.ncol]
    dn = fluxes.flux_dn.cpu().numpy()[:data.ncol]
    if args.validate and not (np.isfinite(up).all()
                              and np.isfinite(dn).all()):
        print("ecckd_rfmip_lw: non-finite fluxes in output", file=sys.stderr)
        return 1
    if not common.writes_files():
        return 0
    if args.metrics_json:
        common.write_metrics(args.metrics_json, ncol=data.ncol,
                             seconds=t.seconds, args=args, fluxes=fluxes,
                             n_devices=n_devices,
                             extra={"driver": "lw",
                                    "n_quad_angles": n_quad_angles})
    suffix = f"r1i1p{args.physics_index}f{args.forcing_index}_gn.nc"
    os.makedirs(args.output_dir, exist_ok=True)
    up_path = os.path.join(args.output_dir,
                           f"rlu_Efx_RTE-ecckd_rad-irf_{suffix}")
    dn_path = os.path.join(args.output_dir,
                           f"rld_Efx_RTE-ecckd_rad-irf_{suffix}")
    write_fluxes(up_path, "rlu", up, data.nsite, data.nexp)
    write_fluxes(dn_path, "rld", dn, data.nsite, data.nexp)
    print(f" Wrote {up_path} and {dn_path}", file=sys.stderr)
    if args.heating_rates:
        from ecckd_tpu_torch.fluxes import heating_rate
        from ecckd_tpu_torch.io.rfmip import write_heating_rates
        hr = heating_rate(*map(torch.as_tensor,
                               (up, dn, plev[:data.ncol]))).numpy()
        hr_path = os.path.join(args.output_dir,
                               f"hrl_Efx_RTE-ecckd_rad-irf_{suffix}")
        write_heating_rates(hr_path, "hrl", hr, data.nsite, data.nexp)
        print(f" Wrote {hr_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
