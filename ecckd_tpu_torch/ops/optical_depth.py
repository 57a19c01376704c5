"""Gas optical depth (counterpart of ``ecckd_tpu.ops.optical_depth``;
the reference's ``calculate_optical_depth``, gas_optics_ecckd.f90:64-241,
323-376).

* The requested-gas set is resolved from the gas names: request order is
  kept, unknown gases are skipped silently, and the composite table
  contributes exactly once (gas_optics_ecckd.f90:358-367).
* All bi-linear (dense) gases share one batched gather over the stacked
  table; their three concentration codes collapse into one affine weight
  ``simple_weight * (a*vmr + b)``.
* Each gas's optical depth is clamped at zero per g-point *before*
  accumulation (gas_optics_ecckd.f90:233-238).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ecckd_tpu_torch import constants
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.ops import interp


class GasContribution(NamedTuple):
    gas_index: int
    name: str


def resolve_contributions(model: CKDModel, names: Tuple[str, ...]
                          ) -> List[GasContribution]:
    """Requested order kept, unknown gases skipped, composite-only gases
    contribute once (the first one requested)."""
    out: List[GasContribution] = []
    used_composite = False
    for name in names:
        key = name.strip().lower()
        if key not in model.gas_names:
            continue  # silent skip, gas_optics_ecckd.f90:358-364
        gi = model.gas_names.index(key)
        if model.gas_composite_only[gi]:
            if used_composite:
                continue
            used_composite = True
        out.append(GasContribution(gi, key))
    return out


def gas_optical_depth(model: CKDModel, plev: torch.Tensor,
                      tlay: torch.Tensor, gas_concs: GasConcs,
                      logarithmic_interpolation: bool = False
                      ) -> torch.Tensor:
    """Total gas optical depth, (ncol, nlay, ngpt).

    Args:
      plev: level pressures [Pa], (ncol, nlay+1).
      tlay: layer temperatures [K], (ncol, nlay).
      logarithmic_interpolation: interpolate log(coefficient) instead of
        the coefficient (the reference's never-selected alternate branch).
    """
    ncol, nlay = tlay.shape
    dtype, device = tlay.dtype, tlay.device
    contributions = resolve_contributions(model, gas_concs.names)

    n_p = model.log_pressure.shape[0]
    n_t = model.temperature_grid.shape[1]
    p_iw = interp.pressure_index(
        plev, model.log_pressure[0],
        model.log_pressure[1] - model.log_pressure[0], n_p)
    t_iw = interp.temperature_index(tlay, p_iw, model.temperature_grid)

    # Moles of dry air per m^2 in each layer (gas_optics_ecckd.f90:107,143).
    simple_weight = constants.MOLES_PER_PA * (plev[:, 1:] - plev[:, :-1])

    ngpt = model.ngpt
    tau = torch.zeros((ncol, nlay, ngpt), dtype=dtype, device=device)

    dense = [c for c in contributions
             if model.gas_codes[c.gas_index] != constants.CONC_LUT]
    if dense:
        rows = torch.as_tensor([model.gas_table_idx[c.gas_index]
                                for c in dense], device=device)
        scale_offset = [model.weight_scale_offset(c.gas_index) for c in dense]
        a = torch.as_tensor([s for s, _ in scale_offset], dtype=dtype,
                            device=device)
        b = torch.as_tensor([o for _, o in scale_offset], dtype=dtype,
                            device=device)
        vmrs = torch.stack([gas_concs.get_vmr(c.name, ncol, nlay).to(
            dtype=dtype, device=device) for c in dense])   # (G, ncol, nlay)
        weights = simple_weight * (a[:, None, None] * vmrs + b[:, None, None])
        tables = model.coeff_dense[rows].reshape(len(dense), n_p * n_t, ngpt)
        coeff = interp.bilinear_gather(tables, n_t, p_iw, t_iw,
                                       logarithmic_interpolation)
        tau_g = torch.clamp(weights[..., None] * coeff, min=0.0)
        tau = tau + torch.sum(tau_g, dim=0)

    for c in contributions:
        gi = c.gas_index
        if model.gas_codes[gi] != constants.CONC_LUT:
            continue
        vmr = gas_concs.get_vmr(c.name, ncol, nlay).to(dtype=dtype,
                                                       device=device)
        v_iw = interp.vmr_index(vmr, model.lut_mf_grids[model.gas_table_idx[gi]])
        table_flat = model.coeff_lut[model.gas_table_idx[gi]].reshape(-1, ngpt)
        coeff = interp.trilinear_gather(table_flat, n_p, n_t, p_iw, t_iw,
                                        v_iw, logarithmic_interpolation)
        tau = tau + torch.clamp((simple_weight * vmr)[..., None] * coeff,
                                min=0.0)
    return tau
