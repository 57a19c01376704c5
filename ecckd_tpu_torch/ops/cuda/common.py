"""Torch ports of the per-layer math the merged kernel carries.

Counterparts of the single homes in ``ecckd_tpu/ops/pallas/common.py``
(``lw_layer_sources``, ``two_stream_g0``, ``sw_adding_up_step``,
``sw_adding_dn_step``).  ``csrc/lwsw.cu`` implements the same formulas
per g-point; ``lwsw_fluxes_plain`` builds on these, at any dtype and on
any device.  The constants are the kernel's float32 ones at every dtype
(thin-layer threshold sqrt(eps_f32), the 1e-8 tau floor, the
eps_f32 * tau^2 resonance guard), so the plain path at float64 differs from
the kernel only by rounding.
"""
from __future__ import annotations

import numpy as np
import torch

EPS_F32 = float(np.finfo(np.float32).eps)
THIN_LAYER_TAU = float(np.sqrt(np.finfo(np.float32).eps))
"""Below this slant optical depth the LW source uses its series form."""


def lw_layer_sources(ts, lay, lev_dec, lev_inc, thresh=THIN_LAYER_TAU):
    """Transmittance and linear-in-tau LW path sources of a layer at slant
    optical depth ``ts``; ``lev_dec``/``lev_inc`` are the Planck sources at
    the layer's decreasing/increasing-index edge (levels j and j+1).
    Returns (tr, src_dn, src_up)."""
    omt = -torch.expm1(-ts)
    tr = 1.0 - omt
    fact = torch.where(ts > thresh,
                       omt / torch.clamp(ts, min=thresh) - tr,
                       ts * (0.5 - ts * (1.0 / 3.0)))
    src_dn = omt * lev_inc + 2.0 * fact * (lay - lev_inc)
    src_up = omt * lev_dec + 2.0 * fact * (lay - lev_dec)
    return tr, src_dn, src_up


def two_stream_g0(tau, u, mu0, inv_mu0):
    """g = 0 two-stream coefficients (Meador-Weaver/PIFM specialised to
    Rayleigh + absorption) in the cancellation-free complement forms,
    rescaled by tau so only one reciprocal remains; ``u`` is the Rayleigh
    optical depth (u <= tau).  tau is floored at 1e-8 inside the scattering
    algebra only.  Returns (r_dif, t_dif, r_dir, t_dir, t_noscat)."""
    taus = torch.clamp(tau, min=1e-8)
    ktau = torch.sqrt(torch.maximum((taus - u) * (4.0 * taus - u),
                                    1e-12 * (taus * taus)))
    em1 = -torch.expm1(-ktau)
    m1 = em1 * (2.0 - em1)                    # 1 - e^2
    e = 1.0 - em1                             # e^-ktau
    e2 = 1.0 - m1                             # e^-2ktau
    tm1 = -torch.expm1(-tau * inv_mu0)        # 1 - t, true tau
    t = 1.0 - tm1
    km = ktau * mu0
    tau2 = taus * taus
    d = tau2 - km * km
    d = torch.where(torch.abs(d) >= EPS_F32 * tau2, d, EPS_F32 * tau2)
    g1t = 2.0 * taus - 1.25 * u
    al = taus - 0.25 * u
    a = ktau * (1.0 + e2) + g1t * m1
    p = 1.0 / (a * d)                         # the one divide
    inv_a = d * p
    r_dif = (0.75 * u) * m1 * inv_a
    t_dif = (2.0 * ktau) * e * inv_a
    q = em1 * em1 + (2.0 * e) * tm1
    s = em1 * em1 - tm1 * (1.0 + e2)
    u_p = u * p
    half_kt = 0.5 * ktau
    t_m1 = t * m1
    r_dir = u_p * (al * (taus * m1 - km * q)
                   + half_kt * (taus * q - km * m1))
    t_dir = -u_p * (al * (taus * t_m1 + km * s)
                    + half_kt * (taus * s + km * t_m1))
    r_dir = torch.minimum(torch.clamp(r_dir, min=0.0), 1.0 - t)
    t_dir = torch.minimum(torch.clamp(t_dir, min=0.0), 1.0 - t - r_dir)
    return r_dif, t_dif, r_dir, t_dir, t


def sw_adding_up_step(r_dif, t_dif, albedo, src, src_up, src_dn):
    """One bottom-up adding step: albedo and source of the stack below the
    level above.  Returns (denom, albedo_above, src_above); ``denom`` is
    reused by the downward pass."""
    denom = 1.0 / (1.0 - r_dif * albedo)
    albedo_new = r_dif + t_dif * t_dif * albedo * denom
    src_new = src_up + t_dif * denom * (src + albedo * src_dn)
    return denom, albedo_new, src_new


def sw_adding_dn_step(t_dif, r_dif, denom, dn, albedo_next, src_next,
                      src_dn):
    """One top-down adding step: diffuse downward flux through a layer and
    the upward flux at the level below.  Returns (dn_next, up_next)."""
    dn_next = (t_dif * dn + r_dif * src_next + src_dn) * denom
    up_next = dn_next * albedo_next + src_next
    return dn_next, up_next
