"""The plain reference: broadband LW and SW fluxes in float64 PyTorch.

It follows rte-ecckd's ``gas_optics_ecckd.f90`` and the RTE solvers that
the RFMIP example links against, with nothing taken from the program
under test: it reads the ckd file itself (``ckd.read_ckd``) and takes the
benchmark's own batch.

* Interpolation points: the layer pressure is the mean of its two levels;
  fractional indices clamp to [0, N - 1.0001] on the uniform ln p and T
  axes (the T axis starts at the first grid column interpolated at the
  pressure point) and to [0, N - 1.001] on the log-uniform h2o axis,
  with the mole fraction floored at the axis's first entry.
* Optical depth: per gas, (moles of dry air) x (weight) x (bi- or
  tri-linear table value), clamped at 0 per g-point before the sum;
  weights 1, vmr or vmr - reference for codes none, linear and
  relative-linear, and vmr for the table gas.
* Planck: linear in T on the table's axis, extrapolated above it, scaled
  by T / T0 below it, divided by pi (3.14159265359, as the scheme spells
  it).  Rayleigh: moles x coefficient; single-scattering albedo
  tau_ray / tau, asymmetry 0.
* LW: no scattering, 1-4 Gauss angles (secants 1.66 at one angle), a
  source linear in optical depth, the surface emitting and reflecting.
* SW: Meador-Weaver two-stream with PIFM coefficients, direct beam
  exp(-tau / mu0), the adding method from the surface up and then down;
  TOA irradiance scaled to the column's TSI; a column is night where
  sza >= 90 - 2 spacing(90) in float32, the configuration's working
  precision, and its fluxes are 0.

``fluxes`` returns (lw_up, lw_dn, sw_up, sw_dn), each (ncol, nlay + 1),
levels from the top down.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from radbench.reference.ckd import LUT, NONE, RELATIVE_LINEAR, Ckd

PI = 3.14159265359
MOLES_PER_PA = 1.0 / (9.80665 * 0.001 * 28.970)
GAUSS = {1: ((1.66,), (0.5,)),
         2: ((1.18350343, 2.81649655), (0.3180413817, 0.1819586183)),
         3: ((1.09719858, 1.69338507, 4.70941630),
             (0.2009319137, 0.2292411064, 0.0698269799)),
         4: ((1.06056257, 1.38282560, 2.40148179, 7.15513024),
             (0.1355069134, 0.2034645680, 0.1298475476, 0.0311809710))}
NIGHT_SZA = 90.0 - 2.0 * float(np.spacing(np.float32(90.0)))
F64 = torch.float64


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=F64, device=device)


def _index(raw: torch.Tensor, n: int, clamp: float = 1.0001):
    idx = torch.clamp(raw, 0.0, n - clamp)
    i0 = torch.floor(idx)
    return i0.long(), idx - i0


def optical_depth(ckd: Ckd, plev, tlay, concs: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """Gas optical depth, (ncol, nlay, ngpt)."""
    device = tlay.device
    ncol, nlay = tlay.shape
    log_p = torch.log(0.5 * (plev[:, 1:] + plev[:, :-1]))
    lp = np.log(ckd.pressure)
    n_p, n_t = ckd.temperature.shape
    ip, wp = _index((log_p - lp[0]) / (lp[1] - lp[0]), n_p)
    t_first = _t(ckd.temperature[:, 0], device)
    dt = ckd.temperature[0, 1] - ckd.temperature[0, 0]
    t0 = (1.0 - wp) * t_first[ip] + wp * t_first[ip + 1]
    it, wt = _index((tlay - t0) / dt, n_t)
    moles = MOLES_PER_PA * (plev[:, 1:] - plev[:, :-1])
    wp, wt = wp[..., None], wt[..., None]

    def bilinear(table, lead=()):
        c = lambda dp, dt_: table[(*lead, ip + dp, it + dt_)]
        return ((1 - wt) * ((1 - wp) * c(0, 0) + wp * c(1, 0))
                + wt * ((1 - wp) * c(0, 1) + wp * c(1, 1)))

    tau = torch.zeros((ncol, nlay, ckd.ngpt), dtype=F64, device=device)
    for gas in ckd.contributions(concs):
        table = _t(gas.table, device)
        if gas.code == NONE:
            weight = moles
        else:
            vmr = concs[gas.name].to(F64)
            vmr = (vmr[:, None] if vmr.ndim == 1 else vmr).expand(ncol, nlay)
            weight = moles * (vmr - gas.reference_mf
                              if gas.code == RELATIVE_LINEAR else vmr)
        if gas.code == LUT:
            mf = gas.mf_grid
            iv, wv = _index(
                (torch.log(torch.clamp(vmr, min=mf[0])) - math.log(mf[0]))
                / math.log(mf[1] / mf[0]), len(mf), clamp=1.001)
            wv = wv[..., None]
            coeff = (1 - wv) * bilinear(table, (iv,)) + wv * bilinear(
                table, (iv + 1,))
        else:
            coeff = bilinear(table)
        tau = tau + torch.clamp(weight[..., None] * coeff, min=0.0)
    return tau


def planck(ckd: Ckd, temperature: torch.Tensor) -> torch.Tensor:
    """Planck intensity (*S, ngpt) at temperatures of shape S."""
    table = _t(ckd.planck_function, temperature.device)
    t0 = ckd.planck_temperature[0]
    dt = ckd.planck_temperature[1] - t0
    idx = (temperature - t0) / dt
    i0 = torch.clamp(torch.floor(idx).long(), 0, table.shape[0] - 2)
    w = (idx - i0)[..., None]
    inside = (1.0 - w) * table[i0] + w * table[i0 + 1]
    below = (temperature / t0)[..., None] * table[0]
    return torch.where((idx >= 0)[..., None], inside, below) / PI


def lw_fluxes(ckd: Ckd, b: dict, n_angles: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    tau = optical_depth(ckd, b["plev"], b["tlay"], b["concs"])
    lay = planck(ckd, b["tlay"])
    lev = planck(ckd, b["tlev"])
    sfc = planck(ckd, b["tsfc"])
    emis = b["emis"][:, None]
    ncol, nlay, _ = tau.shape
    up = torch.zeros((ncol, nlay + 1), dtype=F64, device=tau.device)
    dn = torch.zeros_like(up)
    thresh = math.sqrt(float(torch.finfo(F64).eps))
    for secant, weight in zip(*GAUSS[n_angles]):
        ts = tau * secant
        trans = torch.exp(-ts)
        absorbed = -torch.expm1(-ts)
        fact = torch.where(ts > thresh,
                           absorbed / torch.clamp(ts, min=thresh) - trans,
                           ts * (0.5 - ts / 3.0))
        src_dn = absorbed * lev[:, 1:] + 2.0 * fact * (lay - lev[:, 1:])
        src_up = absorbed * lev[:, :-1] + 2.0 * fact * (lay - lev[:, :-1])
        x = torch.zeros_like(sfc)
        rad_dn = [x.sum(-1)]
        for j in range(nlay):
            x = trans[:, j] * x + src_dn[:, j]
            rad_dn.append(x.sum(-1))
        x = emis * sfc + (1.0 - emis) * x
        rad_up = [x.sum(-1)]
        for j in range(nlay - 1, -1, -1):
            x = trans[:, j] * x + src_up[:, j]
            rad_up.append(x.sum(-1))
        w = 2.0 * PI * weight
        dn = dn + w * torch.stack(rad_dn, dim=1)
        up = up + w * torch.stack(rad_up[::-1], dim=1)
    return up, dn


def two_stream(tau, ssa, mu0):
    """Meador-Weaver with PIFM coefficients at asymmetry 0: (r_dif, t_dif,
    r_dir, t_dir, t_noscat), each (ncol, nlay, ngpt)."""
    mu0 = mu0[:, None, None]
    g1 = (8.0 - 5.0 * ssa) * 0.25
    g2 = 0.75 * ssa
    g3 = 0.5
    g4 = 1.0 - g3
    alpha1 = g1 * g4 + g2 * g3
    alpha2 = g1 * g3 + g2 * g4
    k = torch.sqrt(torch.clamp((g1 - g2) * (g1 + g2), min=1e-12))
    e1 = torch.exp(-k * tau)
    e2 = e1 * e1
    rt = 1.0 / (k * (1.0 + e2) + g1 * (1.0 - e2))
    r_dif = rt * g2 * (1.0 - e2)
    t_dif = rt * 2.0 * k * e1
    t_noscat = torch.exp(-tau / mu0)
    k_mu = k * mu0
    denom = 1.0 - k_mu * k_mu
    eps = float(torch.finfo(F64).eps)
    denom = torch.where(denom.abs() >= eps, denom, torch.full_like(denom, eps))
    rt2 = ssa * rt / denom
    kg3, kg4 = k * g3, k * g4
    r_dir = rt2 * ((1.0 - k_mu) * (alpha2 + kg3)
                   - (1.0 + k_mu) * (alpha2 - kg3) * e2
                   - 2.0 * (kg3 - alpha2 * k_mu) * e1 * t_noscat)
    t_dir = -rt2 * ((1.0 + k_mu) * (alpha1 + kg4) * t_noscat
                    - (1.0 - k_mu) * (alpha1 - kg4) * e2 * t_noscat
                    - 2.0 * (kg4 + alpha1 * k_mu) * e1)
    r_dir = torch.minimum(torch.clamp(r_dir, min=0.0), 1.0 - t_noscat)
    t_dir = torch.minimum(torch.clamp(t_dir, min=0.0), 1.0 - t_noscat - r_dir)
    return r_dif, t_dif, r_dir, t_dir, t_noscat


def sw_fluxes(ckd: Ckd, b: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    plev = b["plev"]
    tau_gas = optical_depth(ckd, plev, b["tlay"], b["concs"])
    moles = MOLES_PER_PA * (plev[:, 1:] - plev[:, :-1])
    tau_ray = moles[..., None] * _t(ckd.rayleigh, plev.device)
    tau = tau_gas + tau_ray
    ssa = tau_ray / tau
    day = b["sza"] < NIGHT_SZA
    mu0 = torch.where(day, torch.cos(b["sza"] * (math.pi / 180.0)),
                      torch.ones_like(b["sza"]))
    solar = _t(ckd.solar_irradiance, plev.device)
    toa = solar[None, :] * (b["tsi"] / solar.sum())[:, None]
    r_dif, t_dif, r_dir, t_dir, t_noscat = two_stream(tau, ssa, mu0)
    ncol, nlay, _ = tau.shape
    alb = b["alb"][:, None]

    direct = [mu0[:, None] * toa]
    for j in range(nlay):
        direct.append(direct[-1] * t_noscat[:, j])
    # Albedo of, and upward diffuse source from, the stack below each
    # level, from the surface up.
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


def fluxes(lw: Ckd, sw: Ckd, b: dict, n_angles: int = 1, block: int = 512):
    """(lw_up, lw_dn, sw_up, sw_dn) in float64 for the batch ``b`` (a dict
    of float tensors as ``radbench.inputs.make_batch`` gives, any dtype),
    computed in blocks of ``block`` columns on ``b``'s device."""
    b64 = {k: v.to(F64) for k, v in b.items() if k != "concs"}
    b64["concs"] = {k: v.to(F64) for k, v in b["concs"].items()}
    ncol = b64["tlay"].shape[0]
    parts = []
    for c0 in range(0, ncol, block):
        part = {k: v[c0:c0 + block] for k, v in b64.items() if k != "concs"}
        part["concs"] = {k: v[c0:c0 + block] for k, v in b64["concs"].items()}
        parts.append((*lw_fluxes(lw, part, n_angles), *sw_fluxes(sw, part)))
    return tuple(torch.cat(p) for p in zip(*parts))
