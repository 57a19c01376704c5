"""The plain reference at a stated working precision: ``rte.fluxes`` with
the night rule of that precision.

``rte.py`` computes in float64 and marks a column night where sza >= 90 -
2 spacing(90) in float32, the working precision of the configurations it
was written for.  rte-ecckd's RFMIP program applies the rule in its own
working precision (ecckd_rfmip_sw.F90:103-108), so at float64 a column is
night from 90 - 2 spacing(90) in float64, 1.4e-14 degrees below 90, where
float32 draws it 1.5e-5 degrees below.  Everything else is ``rte.py``'s:
this module takes its pieces and changes only the threshold.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from radbench.reference import rte
from radbench.reference.ckd import Ckd

F64 = rte.F64


def night_sza(precision: str) -> float:
    """90 - 2 spacing(90) in the working precision ``precision``
    ("float32" or "float64")."""
    return 90.0 - 2.0 * float(np.spacing(np.dtype(precision).type(90.0)))


def sw_fluxes(ckd: Ckd, b: dict, night: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rte.sw_fluxes`` with night from sza >= ``night``."""
    plev = b["plev"]
    tau_gas = rte.optical_depth(ckd, plev, b["tlay"], b["concs"])
    moles = rte.MOLES_PER_PA * (plev[:, 1:] - plev[:, :-1])
    tau_ray = moles[..., None] * rte._t(ckd.rayleigh, plev.device)
    tau = tau_gas + tau_ray
    ssa = tau_ray / tau
    day = b["sza"] < night
    mu0 = torch.where(day, torch.cos(b["sza"] * (math.pi / 180.0)),
                      torch.ones_like(b["sza"]))
    solar = rte._t(ckd.solar_irradiance, plev.device)
    toa = solar[None, :] * (b["tsi"] / solar.sum())[:, None]
    r_dif, t_dif, r_dir, t_dir, t_noscat = rte.two_stream(tau, ssa, mu0)
    ncol, nlay, _ = tau.shape
    alb = b["alb"][:, None]

    direct = [mu0[:, None] * toa]
    for j in range(nlay):
        direct.append(direct[-1] * t_noscat[:, j])
    albedo = [None] * (nlay + 1)
    source = [None] * (nlay + 1)
    denom = [None] * nlay
    albedo[nlay] = alb.expand(ncol, tau.shape[2])
    source[nlay] = alb * direct[nlay]
    for j in range(nlay - 1, -1, -1):
        denom[j] = 1.0 / (1.0 - r_dif[:, j] * albedo[j + 1])
        albedo[j] = r_dif[:, j] + (t_dif[:, j] ** 2 * albedo[j + 1]
                                   * denom[j])
        source[j] = r_dir[:, j] * direct[j] + t_dif[:, j] * denom[j] * (
            source[j + 1] + albedo[j + 1] * t_dir[:, j] * direct[j])
    diffuse = torch.zeros_like(direct[0])
    up = [source[0].sum(-1)]
    dn = [direct[0].sum(-1)]
    for j in range(nlay):
        diffuse = denom[j] * (t_dif[:, j] * diffuse + r_dif[:, j]
                              * source[j + 1] + t_dir[:, j] * direct[j])
        up.append((diffuse * albedo[j + 1] + source[j + 1]).sum(-1))
        dn.append((diffuse + direct[j + 1]).sum(-1))
    mask = day.to(F64)[:, None]
    return torch.stack(up, dim=1) * mask, torch.stack(dn, dim=1) * mask


def fluxes(lw: Ckd, sw: Ckd, b: dict, n_angles: int = 1,
           precision: str = "float64", block: int = 512):
    """``rte.fluxes`` with the night rule of ``precision``: (lw_up, lw_dn,
    sw_up, sw_dn) in float64 for the batch ``b``, in blocks of ``block``
    columns on ``b``'s device."""
    night = night_sza(precision)
    b64 = {k: v.to(F64) for k, v in b.items() if k != "concs"}
    b64["concs"] = {k: v.to(F64) for k, v in b["concs"].items()}
    ncol = b64["tlay"].shape[0]
    parts = []
    for c0 in range(0, ncol, block):
        part = {k: v[c0:c0 + block] for k, v in b64.items() if k != "concs"}
        part["concs"] = {k: v[c0:c0 + block] for k, v in b64["concs"].items()}
        parts.append((*rte.lw_fluxes(lw, part, n_angles),
                      *sw_fluxes(sw, part, night)))
    return tuple(torch.cat(p) for p in zip(*parts))
