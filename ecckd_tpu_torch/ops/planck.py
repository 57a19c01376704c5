"""Planck source interpolation (counterpart of ``ecckd_tpu.ops.planck``;
the reference's ``calculate_planck_function``, gas_optics_ecckd.f90:245-289):

* linear interpolation on the uniform Planck-temperature axis;
* temperatures above the table extrapolate linearly from the last interval;
* temperatures below the first entry scale the first row: B = (T/T0)*row0;
* the result is divided by PI (flux [W m-2] -> intensity [W m-2 sr-1]).
"""
from __future__ import annotations

import torch

from ecckd_tpu_torch import constants


def planck_source(temperature: torch.Tensor, planck_temperature: torch.Tensor,
                  planck_function: torch.Tensor) -> torch.Tensor:
    """Planck intensity (*S, ngpt) at temperatures of any shape S."""
    n = planck_function.shape[0]
    t0 = planck_temperature[0]
    dt = planck_temperature[1] - planck_temperature[0]
    idx = (temperature - t0) / dt
    i0 = torch.clamp(torch.floor(idx).long(), 0, n - 2)
    w1 = (idx - i0)[..., None]
    interp = ((1.0 - w1) * planck_function[i0]
              + w1 * planck_function[i0 + 1])
    below = (temperature / t0)[..., None] * planck_function[0]
    out = torch.where((idx >= 0)[..., None], interp, below)
    return out / constants.PI
