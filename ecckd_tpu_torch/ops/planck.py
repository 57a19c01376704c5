"""Planck source interpolation (counterpart of ``ecckd_tpu.ops.planck``;
the reference's ``calculate_planck_function``, gas_optics_ecckd.f90:245-289):

* linear interpolation on the uniform Planck-temperature axis;
* temperatures above the table extrapolate linearly from the last interval;
* temperatures below the first entry scale the first row: B = (T/T0)*row0;
* the result is divided by PI (flux [W m-2] -> intensity [W m-2 sr-1]).

``planck_source_jac`` is the change of that source over 1 K, the surface
term of RTE's LW surface-temperature Jacobian.
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


def planck_source_jac(temperature: torch.Tensor,
                      planck_temperature: torch.Tensor,
                      planck_function: torch.Tensor) -> torch.Tensor:
    """The change of ``planck_source`` over 1 K at temperatures of any shape
    S, (*S, ngpt), per kelvin: the table's first difference over one table
    step, interpolated at the temperature, over the step in kelvin.  On the
    ckd files' 1 K axis this is planck_source(T + 1 K) - planck_source(T)
    exactly, written without the cancellation of two interpolated sources
    (B / dB is about 70): a difference of adjacent table entries.

    It clamps where ``planck_source`` does: above the table's last interval,
    where the source extrapolates that interval linearly, it holds that
    interval's difference; below the first entry, where the source is
    (T / T0) B_0, it holds B_0 / T0 per kelvin; within one step below T0 it
    blends that and the first difference linearly, as the source's two
    pieces meet there.  In table steps, with E_0 = B_0 dt / T0 and
    E_k = B_k - B_(k-1), it is E interpolated at (T - T0) / dt + 1, held
    at E_0 and E_(n-1) beyond the ends, divided by dt and by PI."""
    n = planck_function.shape[0]
    t0 = planck_temperature[0]
    dt = planck_temperature[1] - planck_temperature[0]
    pos = (temperature - t0) / dt + 1.0
    m = torch.clamp(torch.floor(pos).long(), 0, n - 2)
    w = torch.clamp(pos - m, 0.0, 1.0)[..., None]
    steps = torch.cat([planck_function[:1] * (dt / t0),
                       planck_function[1:] - planck_function[:-1]])
    diff = (1.0 - w) * steps[m] + w * steps[m + 1]
    return diff / dt / constants.PI
