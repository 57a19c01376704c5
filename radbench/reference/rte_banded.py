"""The plain reference with the surface emissivity given per LW band.

RTE's ``rte_lw`` takes the surface emissivity as ``sfc_emis(nband,
ncol)``: one value per column and band, which holds on every g-point of
that band.  ``rte.py`` takes one value per column.  This module reads
which band each g-point belongs to from the ckd file itself (its
``band_number`` variable, 0-based), spreads each band's emissivity over
that band's g-points, and solves the LW with ``rte.py``'s optical depth,
Planck source and no-scattering sweeps, in float64.  The SW is
``rte.sw_fluxes`` as it is (the albedo stays one value per column).

Nothing here comes from the program under test.  The GPU's TF32 matrix
paths are switched off before each solve, so float64 is float64 on any
device.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from scipy.io import netcdf_file

from radbench.reference import rte
from radbench.reference.ckd import Ckd

F64 = torch.float64


def band_of_gpt(path: str) -> np.ndarray:
    """The band of each g-point of the ckd file at ``path``: its
    ``band_number`` variable, 0-based, (ngpt,)."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        return np.array(f.variables["band_number"][...], dtype=np.int64)
    finally:
        f.close()


def lw_fluxes(ckd: Ckd, b: dict, n_angles: int, emis_gpt: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rte.lw_fluxes`` with the emissivity ``emis_gpt`` per column and
    g-point, (ncol, ngpt)."""
    tau = rte.optical_depth(ckd, b["plev"], b["tlay"], b["concs"])
    lay = rte.planck(ckd, b["tlay"])
    lev = rte.planck(ckd, b["tlev"])
    sfc = rte.planck(ckd, b["tsfc"])
    ncol, nlay, _ = tau.shape
    up = torch.zeros((ncol, nlay + 1), dtype=F64, device=tau.device)
    dn = torch.zeros_like(up)
    thresh = math.sqrt(float(torch.finfo(F64).eps))
    for secant, weight in zip(*rte.GAUSS[n_angles]):
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
        x = emis_gpt * sfc + (1.0 - emis_gpt) * x
        rad_up = [x.sum(-1)]
        for j in range(nlay - 1, -1, -1):
            x = trans[:, j] * x + src_up[:, j]
            rad_up.append(x.sum(-1))
        w = 2.0 * rte.PI * weight
        dn = dn + w * torch.stack(rad_dn, dim=1)
        up = up + w * torch.stack(rad_up[::-1], dim=1)
    return up, dn


def fluxes(lw: Ckd, sw: Ckd, b: dict, n_angles: int, bands: np.ndarray,
           block: int = 512):
    """(lw_up, lw_dn, sw_up, sw_dn) in float64 for the batch ``b``, whose
    ``emis`` is (ncol, nband), with ``bands`` the LW file's band of each
    g-point (``band_of_gpt``); in blocks of ``block`` columns on ``b``'s
    device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if b["emis"].ndim != 2 or len(bands) != lw.ngpt:
        raise ValueError(f"emissivity {tuple(b['emis'].shape)} and "
                         f"{len(bands)} g-point bands for a file of "
                         f"{lw.ngpt} g-points")
    b64 = {k: v.to(F64) for k, v in b.items() if k != "concs"}
    b64["concs"] = {k: v.to(F64) for k, v in b["concs"].items()}
    index = torch.as_tensor(bands, dtype=torch.long,
                            device=b64["emis"].device)
    ncol = b64["tlay"].shape[0]
    parts = []
    for c0 in range(0, ncol, block):
        part = {k: v[c0:c0 + block] for k, v in b64.items() if k != "concs"}
        part["concs"] = {k: v[c0:c0 + block] for k, v in b64["concs"].items()}
        emis_gpt = part["emis"].index_select(1, index)
        parts.append((*lw_fluxes(lw, part, n_angles, emis_gpt),
                      *rte.sw_fluxes(sw, part)))
    return tuple(torch.cat(p) for p in zip(*parts))
