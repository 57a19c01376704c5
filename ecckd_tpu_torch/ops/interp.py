"""Fractional-index interpolation helpers (counterpart of
``ecckd_tpu.ops.interp``).

Exact index/clamp arithmetic of the reference hot kernel
(gas_optics_ecckd.f90:117-163) in 0-based form:

  idx = clip(raw, 0, N - 1.0001);  i0 = floor(idx);  w1 = idx - i0

so i0 is in [0, N-2] and w1 in [0, 1).  The vmr axis uses the looser clamp
constant ``N - 1.001`` (gas_optics_ecckd.f90:160).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class IndexWeight(NamedTuple):
    i0: torch.Tensor  # int64 lower grid index, in [0, N-2]
    w1: torch.Tensor  # fractional weight of index i0+1


def fractional_index(raw: torch.Tensor, n: int, clamp: float = 1.0001
                     ) -> IndexWeight:
    """Clamped fractional index on a uniform grid of ``n`` points."""
    idx = torch.clamp(raw, 0.0, n - clamp)
    i0 = torch.floor(idx)
    return IndexWeight(i0.long(), idx - i0)


def pressure_index(level_pressure: torch.Tensor, log_p0: torch.Tensor,
                   d_log_p: torch.Tensor, n_pressure: int) -> IndexWeight:
    """Pressure interpolation points from *level* pressures: the layer
    pressure is the mean of the bounding levels (gas_optics_ecckd.f90:120)."""
    log_p = torch.log(0.5 * (level_pressure[..., 1:]
                             + level_pressure[..., :-1]))
    return fractional_index((log_p - log_p0) / d_log_p, n_pressure)


def temperature_index(layer_temperature: torch.Tensor, p_iw: IndexWeight,
                      temperature_grid: torch.Tensor) -> IndexWeight:
    """Temperature interpolation points; the temperature-axis origin is the
    first grid column interpolated at the clamped pressure index
    (gas_optics_ecckd.f90:131-132)."""
    t_first = temperature_grid[:, 0]
    dt = temperature_grid[0, 1] - temperature_grid[0, 0]
    t0 = (1.0 - p_iw.w1) * t_first[p_iw.i0] + p_iw.w1 * t_first[p_iw.i0 + 1]
    return fractional_index((layer_temperature - t0) / dt,
                            temperature_grid.shape[1])


def vmr_index(layer_vmr: torch.Tensor, mf_grid: Tuple[float, ...]
              ) -> IndexWeight:
    """Mole-fraction interpolation points on the log-uniform LUT axis, with
    the vmr floored at the first grid entry (gas_optics_ecckd.f90:151-163)."""
    mf0 = mf_grid[0]
    d_log = math.log(mf_grid[1] / mf_grid[0])
    log_vmr = torch.log(torch.clamp(layer_vmr, min=mf0))
    return fractional_index((log_vmr - math.log(mf0)) / d_log, len(mf_grid),
                            clamp=1.001)


def _take(table_flat: torch.Tensor, idx: torch.Tensor, logarithmic: bool
          ) -> torch.Tensor:
    """table_flat (..., R, ngpt) gathered at idx (S) along R ->
    (..., *S, ngpt)."""
    lead, ngpt = table_flat.shape[:-2], table_flat.shape[-1]
    out = torch.index_select(table_flat, -2, idx.reshape(-1))
    out = out.reshape(*lead, *idx.shape, ngpt)
    return torch.log(out) if logarithmic else out


def bilinear_gather(table_flat: torch.Tensor, n_t: int, p_iw: IndexWeight,
                    t_iw: IndexWeight, logarithmic: bool = False
                    ) -> torch.Tensor:
    """Bi-linear (pressure, temperature) interpolation of stacked tables.

    Args:
      table_flat: (..., np*nT, ngpt) tables flattened over the (p, T) grid.
      p_iw, t_iw: index/weight pairs of shape S (e.g. (ncol, nlay)).
      logarithmic: interpolate log(coefficient) and exponentiate (the
        reference's alternate branch, gas_optics_ecckd.f90:205-211).
    Returns:
      (..., *S, ngpt) interpolated coefficients.
    """
    idx = p_iw.i0 * n_t + t_iw.i0
    take = lambda off: _take(table_flat, idx + off, logarithmic)
    pw1, tw1 = p_iw.w1[..., None], t_iw.w1[..., None]
    pw0, tw0 = 1.0 - pw1, 1.0 - tw1
    out = (tw0 * (pw0 * take(0) + pw1 * take(n_t))
           + tw1 * (pw0 * take(1) + pw1 * take(n_t + 1)))
    return torch.exp(out) if logarithmic else out


def trilinear_gather(table_flat: torch.Tensor, n_p: int, n_t: int,
                     p_iw: IndexWeight, t_iw: IndexWeight,
                     v_iw: IndexWeight, logarithmic: bool = False
                     ) -> torch.Tensor:
    """Tri-linear (vmr, pressure, temperature) interpolation of a LUT
    flattened to (n_mf*np*nT, ngpt); returns (*S, ngpt)."""
    idx = (v_iw.i0 * n_p + p_iw.i0) * n_t + t_iw.i0
    take = lambda off: _take(table_flat, idx + off, logarithmic)
    pw1, tw1, vw1 = (p_iw.w1[..., None], t_iw.w1[..., None],
                     v_iw.w1[..., None])
    pw0, tw0, vw0 = 1.0 - pw1, 1.0 - tw1, 1.0 - vw1
    stride_v = n_p * n_t
    lo = (tw0 * (pw0 * take(0) + pw1 * take(n_t))
          + tw1 * (pw0 * take(1) + pw1 * take(n_t + 1)))
    hi = (tw0 * (pw0 * take(stride_v) + pw1 * take(stride_v + n_t))
          + tw1 * (pw0 * take(stride_v + 1) + pw1 * take(stride_v + n_t + 1)))
    out = vw0 * lo + vw1 * hi
    return torch.exp(out) if logarithmic else out
