"""Longwave no-scattering flux solver (counterpart of
``ecckd_tpu.solvers.lw``).

Per g-point, integrate the Schwarzschild equation along 1..4 discrete
zenith angles (first-order Gaussian quadrature) with a source linear in
optical depth inside each layer, surface emission ``emis * B_sfc`` and
isotropic reflection ``(1 - emis)``, then sum the quadrature to fluxes and
the g-points to broadband.

With ``flux_up_jac`` it also returns RTE's ``flux_up_Jac``: the derivative
of the upward flux at every level with respect to the surface
temperature.  The surface source is the only term that depends on it and
the transport is linear in it, so per g-point and angle a second
recurrence rides the up sweep: J = emis * dB_sfc at the surface (dB_sfc
the source's change over 1 K, ``SourceFuncLW.sfc_source_jac``), then
J(k) = T(k) J(k+1) up the layers, summed as the fluxes are.  It equals
flux_up(T_sfc + 1 K) - flux_up(T_sfc) with every other input fixed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ecckd_tpu_torch import constants
from ecckd_tpu_torch.optics import OpticalProps1scl, SourceFuncLW
from ecckd_tpu_torch.solvers.quadrature import gauss_angles
from ecckd_tpu_torch.solvers.scan import affine_sweep_broadband

# planck.py divides by constants.PI and the flux reconstruction here
# multiplies by 2*PI: the exact pi*B round trip needs the same constant.
TWO_PI = 2.0 * constants.PI


def _linear_in_tau_sources(tau_slant: torch.Tensor, trans: torch.Tensor,
                           lay_source: torch.Tensor,
                           lev_source_dn: torch.Tensor,
                           lev_source_up: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer emitted radiance for down/up propagation with a source
    linear in optical depth; a 2nd-order series for optically thin layers
    (tau below sqrt(machine eps)) avoids the cancellation."""
    tau_thresh = float(torch.finfo(tau_slant.dtype).eps) ** 0.5
    big = torch.clamp(tau_slant, min=tau_thresh)
    one_m_trans = -torch.expm1(-tau_slant)
    fact = torch.where(tau_slant > tau_thresh,
                       one_m_trans / big - trans,
                       tau_slant * (0.5 - tau_slant / 3.0))
    source_dn = one_m_trans * lev_source_dn + \
        2.0 * fact * (lay_source - lev_source_dn)
    source_up = one_m_trans * lev_source_up + \
        2.0 * fact * (lay_source - lev_source_up)
    return source_dn, source_up


def rte_lw(optical_props: OpticalProps1scl, sources: SourceFuncLW,
           sfc_emis_gpt: torch.Tensor, top_at_1: bool = True,
           n_gauss_angles: int = 1,
           inc_flux_gpt: Optional[torch.Tensor] = None,
           flux_up_jac: bool = False) -> Tuple[torch.Tensor, ...]:
    """Broadband longwave fluxes.

    Args:
      optical_props: tau (ncol, nlay, ngpt).
      sources: Planck intensities (see SourceFuncLW).
      sfc_emis_gpt: surface emissivity per g-point, (ncol, ngpt).
      top_at_1: True if layer index 0 is the top of the atmosphere.
      n_gauss_angles: quadrature order, 1..4.
      inc_flux_gpt: optional isotropic incident flux at TOA per g-point
        (ncol, ngpt); it is converted to the per-angle boundary radiance
        F/PI, so a transparent atmosphere returns exactly this flux at
        every level and quadrature order.
      flux_up_jac: also return d flux_up / d T_sfc (needs
        ``sources.sfc_source_jac``).

    Returns:
      (flux_up, flux_dn) broadband [W m-2], each (ncol, nlay+1), in the
      same level orientation as the inputs; with ``flux_up_jac`` a third,
      d flux_up / d T_sfc [W m-2 K-1], (ncol, nlay+1) too.
    """
    tau = optical_props.tau
    lay = sources.lay_source
    lev_inc = sources.lev_source_inc
    lev_dec = sources.lev_source_dec
    if not top_at_1:
        # Canonicalize to top-at-first-index; the edge roles swap with it.
        flip = lambda x: torch.flip(x, dims=(1,))
        tau, lay = flip(tau), flip(lay)
        lev_inc, lev_dec = flip(sources.lev_source_dec), flip(
            sources.lev_source_inc)

    dtype, device = tau.dtype, tau.device
    ncol, nlay, ngpt = tau.shape
    secants, weights = gauss_angles(n_gauss_angles)

    flux_up = torch.zeros((ncol, nlay + 1), dtype=dtype, device=device)
    flux_dn = torch.zeros((ncol, nlay + 1), dtype=dtype, device=device)
    if flux_up_jac:
        if sources.sfc_source_jac is None:
            raise ValueError("flux_up_jac needs sources.sfc_source_jac")
        jac = torch.zeros((ncol, nlay + 1), dtype=dtype, device=device)
        jac_sfc = sfc_emis_gpt * sources.sfc_source_jac
        no_source = tau.new_zeros(()).expand_as(tau)
    top = torch.zeros((ncol, ngpt), dtype=dtype, device=device)
    if inc_flux_gpt is not None:
        # Isotropic incident FLUX -> per-angle boundary RADIANCE F/PI.
        top = (inc_flux_gpt / constants.PI).to(dtype)

    for secant, weight in zip(secants, weights):
        tau_slant = tau * secant
        trans = torch.exp(-tau_slant)
        # Downward propagation exits a layer at its increasing-index edge,
        # upward at its decreasing-index edge.
        source_dn, source_up = _linear_in_tau_sources(
            tau_slant, trans, lay, lev_inc, lev_dec)
        dn_levels, rad_dn_sfc = affine_sweep_broadband(trans, source_dn, top)
        rad_sfc = (sfc_emis_gpt * sources.sfc_source
                   + (1.0 - sfc_emis_gpt) * rad_dn_sfc)
        up_levels, _ = affine_sweep_broadband(trans, source_up, rad_sfc,
                                              reverse=True)
        w = TWO_PI * weight
        flux_dn = flux_dn + w * dn_levels
        flux_up = flux_up + w * up_levels
        if flux_up_jac:
            jac_levels, _ = affine_sweep_broadband(trans, no_source, jac_sfc,
                                                   reverse=True)
            jac = jac + w * jac_levels

    if not top_at_1:
        flux_up = torch.flip(flux_up, dims=(1,))
        flux_dn = torch.flip(flux_dn, dims=(1,))
    if flux_up_jac:
        return flux_up, flux_dn, (jac if top_at_1 else torch.flip(jac, (1,)))
    return flux_up, flux_dn
