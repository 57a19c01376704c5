"""Public gas-optics API (counterpart of ``ecckd_tpu.models.gas_optics``;
the reference's ``gas_optics`` generic, gas_optics_ecckd.f90:381-473).

* :func:`gas_optics_lw` ~ ``gas_optics_int``: optical depth + Planck sources;
* :func:`gas_optics_sw` ~ ``gas_optics_ext``: optical depth + Rayleigh,
  single-scattering albedo and the TOA solar source.

As in the reference, ``play`` and ``col_dry`` are accepted and ignored:
layer pressures are re-derived from the level pressures.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.optics import (OpticalProps1scl, OpticalProps2str,
                                    SourceFuncLW)
from ecckd_tpu_torch.ops.optical_depth import gas_optical_depth
from ecckd_tpu_torch.ops.planck import planck_source, planck_source_jac
from ecckd_tpu_torch.ops.rayleigh import rayleigh_optical_depth


def gas_optics_lw(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
                  tsfc: torch.Tensor, gas_concs: GasConcs,
                  tlev: torch.Tensor, play: torch.Tensor = None,
                  col_dry: torch.Tensor = None,
                  logarithmic_interpolation: bool = False
                  ) -> Tuple[OpticalProps1scl, SourceFuncLW]:
    """Longwave optical depth and Planck sources, with the surface
    source's change over 1 K (``sfc_source_jac``, the surface term of the
    surface-temperature Jacobian).

    Args:
      plev: level pressures [Pa], (ncol, nlay+1).
      tlay: layer temperatures [K], (ncol, nlay).
      tsfc: surface skin temperatures [K], (ncol,).
      tlev: level temperatures [K], (ncol, nlay+1), required as in the
        reference (gas_optics_ecckd.f90:414-417).
    """
    if not model.source_is_internal():
        raise ValueError("gas_optics_lw requires a longwave ckd model")
    del play, col_dry  # parity-only arguments
    tau = gas_optical_depth(model, plev, tlay, gas_concs,
                            logarithmic_interpolation)
    pt, pf = model.planck_temperature, model.planck_function
    lev = planck_source(tlev, pt, pf)
    sources = SourceFuncLW(
        lay_source=planck_source(tlay, pt, pf),
        lev_source_inc=lev[:, 1:, :],
        lev_source_dec=lev[:, :-1, :],
        sfc_source=planck_source(tsfc, pt, pf),
        sfc_source_jac=planck_source_jac(tsfc, pt, pf),
    )
    return OpticalProps1scl(tau=tau), sources


def gas_optics_sw(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
                  gas_concs: GasConcs, play: torch.Tensor = None,
                  col_dry: torch.Tensor = None,
                  logarithmic_interpolation: bool = False
                  ) -> Tuple[OpticalProps2str, torch.Tensor]:
    """Shortwave optical properties and the TOA solar source.

    Returns:
      (optical_props, toa_src) with toa_src (ncol, ngpt): the per-g-point
      solar irradiance broadcast over columns (gas_optics_ecckd.f90:468-472).
    """
    if not model.source_is_external():
        raise ValueError("gas_optics_sw requires a shortwave ckd model")
    del play, col_dry
    tau_gas = gas_optical_depth(model, plev, tlay, gas_concs,
                                logarithmic_interpolation)
    tau_ray = rayleigh_optical_depth(plev, model.rayleigh_coeff)
    tau = tau_gas + tau_ray
    # ssa = tau_ray / tau_total; g = 0 (gas_optics_ecckd.f90:457-464).
    ssa = tau_ray / tau
    toa_src = model.solar_irradiance.to(tau.dtype).expand(tlay.shape[0],
                                                          model.ngpt)
    return (OpticalProps2str(tau=tau, ssa=ssa, g=torch.zeros_like(tau)),
            toa_src)


def gas_optics(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
               gas_concs: GasConcs, tsfc: torch.Tensor = None,
               tlev: torch.Tensor = None, **kwargs):
    """Generic dispatch mirroring the reference's ``ecckd%gas_optics(...)``:
    LW models need ``tsfc`` and ``tlev``; SW models take neither."""
    if model.source_is_internal():
        if tsfc is None or tlev is None:
            raise ValueError("longwave gas_optics requires tsfc and tlev "
                             "(gas_optics_ecckd.f90:414-417)")
        return gas_optics_lw(model, plev, tlay, tsfc, gas_concs, tlev,
                             **kwargs)
    if tsfc is not None or tlev is not None:
        raise ValueError("shortwave gas_optics takes no tsfc/tlev "
                         "(gas_optics_ecckd.f90:431-473)")
    return gas_optics_sw(model, plev, tlay, gas_concs, **kwargs)
