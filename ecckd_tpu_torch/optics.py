"""Optical-property containers (counterparts of ``ecckd_tpu.optics``).

Array convention: (ncol, nlay, ngpt), layer index 0 at the first array
row; the ``top_at_1`` orientation is handled by the solvers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class OpticalProps1scl:
    """Absorption-only optical properties (longwave)."""
    tau: torch.Tensor  # (ncol, nlay, ngpt)


@dataclasses.dataclass(frozen=True)
class OpticalProps2str:
    """Two-stream optical properties (shortwave)."""
    tau: torch.Tensor  # (ncol, nlay, ngpt) extinction optical depth
    ssa: torch.Tensor  # (ncol, nlay, ngpt) single-scattering albedo
    g: torch.Tensor    # (ncol, nlay, ngpt) asymmetry factor (0 for Rayleigh)


@dataclasses.dataclass(frozen=True)
class SourceFuncLW:
    """Planck source functions [W m-2 sr-1] (intensities; the /PI
    conversion happens inside the Planck interpolation)."""
    lay_source: torch.Tensor      # (ncol, nlay, ngpt) layer-mean source
    lev_source_inc: torch.Tensor  # (ncol, nlay, ngpt) source at the layer's
    #                               increasing-index edge (level j+1)
    lev_source_dec: torch.Tensor  # (ncol, nlay, ngpt) source at the layer's
    #                               decreasing-index edge (level j)
    sfc_source: torch.Tensor      # (ncol, ngpt) surface source
    sfc_source_jac: Optional[torch.Tensor] = None
    #                               (ncol, ngpt) the surface source's change
    #                               over 1 K (ops/planck.planck_source_jac)
