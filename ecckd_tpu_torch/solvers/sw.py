"""Shortwave two-stream + adding flux solver (counterpart of
``ecckd_tpu.solvers.sw``).

Per g-point: two-stream reflectance/transmittance of every layer (direct
and diffuse), combined into level fluxes by the adding method (Shonk &
Hogan 2008), with the direct beam attenuated by exp(-tau/mu0); broadband
sums over g-points.  The three recurrences (direct beam down, albedo of
the stack below up, diffuse flux down) are Python loops over layers.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ecckd_tpu_torch.optics import OpticalProps2str
from ecckd_tpu_torch.solvers.scan import affine_scan
from ecckd_tpu_torch.solvers.two_stream import two_stream


def rte_sw(optical_props: OpticalProps2str, mu0: torch.Tensor,
           toa_flux: torch.Tensor, sfc_alb_dir_gpt: torch.Tensor,
           sfc_alb_dif_gpt: torch.Tensor, top_at_1: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Broadband shortwave fluxes.

    Args:
      optical_props: tau/ssa/g, each (ncol, nlay, ngpt).
      mu0: cosine of the solar zenith angle, (ncol,); columns with
        mu0 <= 0 return zero flux.
      toa_flux: TOA direct irradiance per g-point per unit mu0,
        (ncol, ngpt); the solver multiplies by mu0.
      sfc_alb_dir_gpt / sfc_alb_dif_gpt: surface albedos, (ncol, ngpt).

    Returns:
      (flux_up, flux_dn, flux_dn_dir) broadband [W m-2], each
      (ncol, nlay+1); flux_dn includes the direct beam.
    """
    tau, ssa, g = optical_props.tau, optical_props.ssa, optical_props.g
    if not top_at_1:
        flip = lambda x: torch.flip(x, dims=(1,))
        tau, ssa, g = flip(tau), flip(ssa), flip(g)
    nlay = tau.shape[1]

    # Night columns (mu0 <= 0) run at a safe mu0 and are zeroed on return.
    night = mu0 <= 0.0
    mu0 = torch.where(night, torch.ones_like(mu0), mu0)

    ts = two_stream(tau, ssa, g, mu0)

    flux_dir_top = mu0[:, None] * toa_flux
    flux_dir = affine_scan(ts.t_noscat, torch.zeros_like(ts.t_noscat),
                           flux_dir_top, dim=1)      # (ncol, nlay+1, ngpt)
    dir_in = flux_dir[:, :-1, :]

    src_up = ts.r_dir * dir_in
    src_dn = ts.t_dir * dir_in
    src_sfc = sfc_alb_dir_gpt * flux_dir[:, -1, :]

    # Upward pass: albedo of (and upward emission from) the stack below
    # each level, from the surface up.
    albedo = [None] * (nlay + 1)
    src = [None] * (nlay + 1)
    denom = [None] * nlay
    albedo[nlay], src[nlay] = sfc_alb_dif_gpt, src_sfc
    for j in range(nlay - 1, -1, -1):
        r_dif, t_dif = ts.r_dif[:, j], ts.t_dif[:, j]
        denom[j] = 1.0 / (1.0 - r_dif * albedo[j + 1])
        albedo[j] = (r_dif + t_dif * t_dif * albedo[j + 1] * denom[j])
        src[j] = src_up[:, j] + t_dif * denom[j] * (
            src[j + 1] + albedo[j + 1] * src_dn[:, j])

    # Downward diffuse flux F[j+1] = (Tdif_j F[j] + Rdif_j src[j+1]
    # + src_dn_j) * denom_j; up[j] = F[j] * albedo[j] + src[j].
    dn = torch.zeros_like(flux_dir_top)
    dn_sums = [torch.sum(dn, dim=-1)]
    up_sums = [torch.sum(dn * albedo[0] + src[0], dim=-1)]
    for j in range(nlay):
        a = ts.t_dif[:, j] * denom[j]
        b = (ts.r_dif[:, j] * src[j + 1] + src_dn[:, j]) * denom[j]
        dn = a * dn + b
        dn_sums.append(torch.sum(dn, dim=-1))
        up_sums.append(torch.sum(dn * albedo[j + 1] + src[j + 1], dim=-1))
    flux_dn_direct = torch.sum(flux_dir, dim=-1)
    flux_up = torch.stack(up_sums, dim=1)
    flux_dn = torch.stack(dn_sums, dim=1) + flux_dn_direct
    day = torch.where(night, 0.0, 1.0).to(flux_up.dtype)[:, None]
    flux_up = flux_up * day
    flux_dn = flux_dn * day
    flux_dn_direct = flux_dn_direct * day
    if not top_at_1:
        flux_up = torch.flip(flux_up, dims=(1,))
        flux_dn = torch.flip(flux_dn, dims=(1,))
        flux_dn_direct = torch.flip(flux_dn_direct, dims=(1,))
    return flux_up, flux_dn, flux_dn_direct
