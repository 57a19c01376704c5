"""Rayleigh scattering optical depth, shortwave only (counterpart of
``ecckd_tpu.ops.rayleigh``; gas_optics_ecckd.f90:293-319):
tau_ray(col, lay, gpt) = dp / (g * 0.001 * M_air) * rayleigh_coeff(gpt).
"""
from __future__ import annotations

import torch

from ecckd_tpu_torch import constants


def rayleigh_optical_depth(level_pressure: torch.Tensor,
                           rayleigh_coeff: torch.Tensor) -> torch.Tensor:
    """tau_ray, (ncol, nlay, ngpt), from (ncol, nlay+1) level pressures."""
    moles = ((level_pressure[:, 1:] - level_pressure[:, :-1])
             * constants.MOLES_PER_PA)
    return moles[..., None] * rayleigh_coeff
