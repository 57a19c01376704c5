"""Two-stream layer reflectance/transmittance, shortwave (counterpart of
``ecckd_tpu.solvers.two_stream``).

Meador & Weaver (1980) solutions with Zdunkowski PIFM coupling
coefficients, in the cancellation-free complement forms (everything built
from 1 - exp(.) computed with expm1).  Per (column, layer, g-point):

  r_dif, t_dif : reflectance/transmittance for diffuse incidence
  r_dir, t_dir : reflectance / diffuse transmittance for direct incidence
  t_noscat     : direct-beam transmittance exp(-tau/mu0)
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TwoStream(NamedTuple):
    r_dif: torch.Tensor
    t_dif: torch.Tensor
    r_dir: torch.Tensor
    t_dir: torch.Tensor
    t_noscat: torch.Tensor


def two_stream(tau: torch.Tensor, ssa: torch.Tensor, g: torch.Tensor,
               mu0: torch.Tensor) -> TwoStream:
    """tau/ssa/g (ncol, nlay, ngpt); mu0 (ncol,) cosine zenith angle."""
    eps = float(torch.finfo(tau.dtype).eps)
    mu0b = mu0[:, None, None]

    gamma1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (ssa * (1.0 - g)) * 0.25
    gamma3 = (2.0 - 3.0 * mu0b * g) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4

    k = torch.sqrt(torch.clamp((gamma1 - gamma2) * (gamma1 + gamma2),
                               min=1e-12))
    # em1 = 1 - e, m1 = 1 - e^2, tm1 = 1 - t with e = exp(-k tau),
    # t = exp(-tau/mu0), all cancellation-free.
    em1 = -torch.expm1(-k * tau)
    m1 = em1 * (2.0 - em1)
    exp_mktau = 1.0 - em1
    exp_m2ktau = 1.0 - m1

    rt_term = 1.0 / (k * (1.0 + exp_m2ktau) + gamma1 * m1)
    r_dif = rt_term * gamma2 * m1
    t_dif = rt_term * 2.0 * k * exp_mktau

    tm1 = -torch.expm1(-tau / mu0b)
    t_noscat = 1.0 - tm1

    # Exact regrouping of Meador-Weaver eqs 14-15 with the resonance
    # denominator 1 - (k mu0)^2 guarded away from zero.
    k_mu = k * mu0b
    k_g3 = k * gamma3
    k_g4 = k * gamma4
    denom = 1.0 - k_mu * k_mu
    denom = torch.where(torch.abs(denom) >= eps, denom,
                        torch.full_like(denom, eps))
    rt2 = ssa * rt_term / denom
    q = em1 * em1 + 2.0 * exp_mktau * tm1
    s = em1 * em1 - tm1 * (1.0 + exp_m2ktau)
    r_dir = rt2 * (alpha2 * (m1 - k_mu * q) + k_g3 * (q - k_mu * m1))
    t_dir = -rt2 * (alpha1 * (t_noscat * m1 + k_mu * s)
                    + k_g4 * (s + k_mu * t_noscat * m1))

    # Energy safety: reflected + transmitted (direct and diffuse) <= 1.
    r_dir = torch.minimum(torch.clamp(r_dir, min=0.0), 1.0 - t_noscat)
    t_dir = torch.minimum(torch.clamp(t_dir, min=0.0),
                          1.0 - t_noscat - r_dir)
    return TwoStream(r_dif=r_dif, t_dif=t_dif, r_dir=r_dir, t_dir=t_dir,
                     t_noscat=t_noscat)
