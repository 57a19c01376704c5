"""The plain reference with RTE's LW surface-temperature Jacobian.

RTE's ``rte_lw`` takes an optional ``flux_up_Jac(ncol, nlay+1)``: the
derivative of the upward LW flux at every level with respect to the
surface temperature [W m-2 K-1].  RRTMGP fills its ``sfc_source_Jac`` as
the surface Planck source at T_sfc + 1 K less that at T_sfc
(``delta_Tsurf = 1``).  The downward flux does not depend on T_sfc; the
surface source is the only term that does, and the transport is linear in
it.  So per g-point and angle the Jacobian is a second recurrence on the
up sweep:

* at the surface, J = emis * dB, with dB the source's change over 1 K;
* up the layers, J(j) = T(j) J(j + 1), with T the layer's transmittance
  along the angle;
* flux_up_jac = sum over angles of 2 pi w times the sum over g-points of J.

dB is ``planck_change``: ``rte.planck`` at T + 1 K less ``rte.planck`` at
T, written without the cancellation of the two (the table's adjacent
entries differ by a few percent): where both temperatures fall on the
table's 1 K axis, the difference of the two rows each interpolates
between, interpolated; above the table, where the source extrapolates
the last interval, that interval's difference; below it, where the source
is (T / T0) B_0, B_0 / T0 per kelvin; between the two pieces the exact
difference of the pieces.  The fluxes and the optical depth are
``rte.py``'s; nothing comes from the program under test.

``fluxes`` returns (lw_up, lw_dn, sw_up, sw_dn, lw_up_jac, lw_dn_jac), each
(ncol, nlay + 1), levels from the top down; lw_dn_jac, the down flux's
derivative, is zero.
"""
from __future__ import annotations

import torch

from radbench.reference import rte
from radbench.reference.ckd import Ckd

F64 = torch.float64


def planck_change(ckd: Ckd, temperature: torch.Tensor) -> torch.Tensor:
    """``rte.planck`` at temperature + 1 K less at temperature, (*S,
    ngpt), without cancellation (see the module docstring)."""
    table = rte._t(ckd.planck_function, temperature.device)
    n = table.shape[0]
    t0 = float(ckd.planck_temperature[0])
    dt = float(ckd.planck_temperature[1]) - t0
    if dt != 1.0:
        raise ValueError(f"the Planck table's step is {dt} K, not 1 K")
    idx = temperature - t0
    i0 = torch.clamp(torch.floor(idx).long(), 0, n - 2)
    w = (idx - i0)[..., None]
    rows = table[1:] - table[:-1]                  # B(k + 1) - B(k)
    k = torch.clamp(i0 + 1, max=n - 2)
    inside = (1.0 - w) * rows[i0] + w * rows[k]
    top = rows[n - 2].expand_as(inside)
    below = (table[0] / t0).expand_as(inside)
    # Between T0 - 1 K and T0: (B_0 + (idx + 1) rows_0) - (1 + idx / T0) B_0.
    a = (idx + 1.0)[..., None]
    across = a * rows[0] - (idx / t0)[..., None] * table[0]
    out = torch.where((idx >= n - 2)[..., None], top, inside)
    out = torch.where((idx < 0)[..., None], across, out)
    out = torch.where((idx < -1)[..., None], below, out)
    return out / rte.PI


def lw_up_jac(ckd: Ckd, b: dict, n_angles: int, block: int = 512
              ) -> torch.Tensor:
    """d lw_up / d T_sfc in float64, (ncol, nlay + 1), for the batch ``b``
    (any dtype), in blocks of ``block`` columns: J carried up from
    emis * dB at the surface through ``rte.optical_depth``'s layers."""
    f64 = lambda v: v.to(F64)
    parts = []
    for c0 in range(0, b["tlay"].shape[0], block):
        c = slice(c0, c0 + block)
        tau = rte.optical_depth(ckd, f64(b["plev"][c]), f64(b["tlay"][c]),
                                {g: f64(v[c]) for g, v in b["concs"].items()})
        y0 = f64(b["emis"][c])[:, None] * planck_change(ckd,
                                                        f64(b["tsfc"][c]))
        jac = 0.0
        for secant, weight in zip(*rte.GAUSS[n_angles]):
            trans = torch.exp(-tau * secant)
            y = y0
            levels = [y.sum(-1)]
            for j in range(tau.shape[1] - 1, -1, -1):
                y = trans[:, j] * y
                levels.append(y.sum(-1))
            jac = jac + 2.0 * rte.PI * weight * torch.stack(levels[::-1], 1)
        parts.append(jac)
    return torch.cat(parts)


def fluxes(lw: Ckd, sw: Ckd, b: dict, n_angles: int = 1, block: int = 512):
    """(lw_up, lw_dn, sw_up, sw_dn, lw_up_jac, lw_dn_jac) in float64 for
    the batch ``b`` (as ``radbench.inputs.make_batch`` gives it, any
    dtype), in blocks of ``block`` columns on ``b``'s device: the first
    four ``rte.fluxes``'s."""
    jac = lw_up_jac(lw, b, n_angles, block)
    return (*rte.fluxes(lw, sw, b, n_angles, block), jac,
            torch.zeros_like(jac))
