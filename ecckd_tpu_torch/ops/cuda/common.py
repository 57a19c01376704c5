"""The plain PyTorch counterpart of ``csrc/common.cuh``.

* The per-layer math, ports of the single homes in
  ``ecckd_tpu/ops/pallas/common.py`` (``lw_layer_sources``,
  ``two_stream_g0``, ``sw_adding_up_step``, ``sw_adding_dn_step``).
* The bodies of one band's solve, ``gas_tau_plain``, ``lw_plain`` and
  ``sw_plain`` (common.cuh's ``gas_tau_params``, ``lw_optics`` with
  ``lw_sweeps_staged``, ``sw_optics`` with ``sw_sweeps_staged``), on the
  host preparation of ops/cuda/plan.py, and the night mask.  The
  table mode travels with the prepared band: a band whose table is bf16
  (plan.model_arrays(fast=True)) runs the fast mode's interpolation.

``lwsw_fluxes_plain``, ``lw_fluxes_plain`` and ``sw_fluxes_plain`` are
built from these, at any dtype and on any device, as the three kernels are
built from common.cuh.  The constants are those of the compute type of the
kernel the plain path stands for (common.cuh "Compute type"), given as
``compute`` and not read from the dtype the plain path runs in: float32's
(thin-layer threshold sqrt(eps), resonance guard eps * tau^2, tau floor
1e-8) for the kernels' float instantiations, the default, and float64's
(tau floor 1e-8 * eps64 / eps32) for the merged kernel's double one.  So
the plain path at float64 differs from either kernel only by rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from ecckd_tpu_torch import constants
from ecckd_tpu_torch.ops import interp
from ecckd_tpu_torch.ops.cuda import plan as plan_mod
from ecckd_tpu_torch.ops.planck import planck_source, planck_source_jac
from ecckd_tpu_torch.solvers.quadrature import gauss_angles

_COMPUTE = {torch.float32: np.float32, torch.float64: np.float64}


def kernel_eps(compute: torch.dtype = torch.float32) -> float:
    """The epsilon of kernel compute type ``compute``: float32 (the
    kernels' float instantiations) or float64 (the merged kernel's double
    one)."""
    return float(np.finfo(_COMPUTE[compute]).eps)


def tau_floor(compute: torch.dtype = torch.float32) -> float:
    """The floor of ``two_stream_g0``'s scattering algebra: 1e-8 at
    float32, 1e-8 * eps64 / eps32 = 1e-8 * 2**-29 at float64."""
    return 1e-8 * kernel_eps(compute) / kernel_eps(torch.float32)


def thin_layer_tau(compute: torch.dtype = torch.float32) -> float:
    """Below this slant optical depth the LW source uses its series form:
    sqrt(eps), rounded to the compute type as the kernel's is."""
    return float(np.sqrt(np.finfo(_COMPUTE[compute]).eps))


def lw_layer_sources(ts, lay, lev_dec, lev_inc, thresh=thin_layer_tau()):
    """Transmittance and linear-in-tau LW path sources of a layer at slant
    optical depth ``ts``; ``lev_dec``/``lev_inc`` are the Planck sources at
    the layer's decreasing/increasing-index edge (levels j and j+1);
    ``thresh``: the series' threshold (``thin_layer_tau``).
    Returns (tr, src_dn, src_up)."""
    omt = -torch.expm1(-ts)
    tr = 1.0 - omt
    fact = torch.where(ts > thresh,
                       omt / torch.clamp(ts, min=thresh) - tr,
                       ts * (0.5 - ts * (1.0 / 3.0)))
    src_dn = omt * lev_inc + 2.0 * fact * (lay - lev_inc)
    src_up = omt * lev_dec + 2.0 * fact * (lay - lev_dec)
    return tr, src_dn, src_up


def two_stream_g0(tau, u, mu0, inv_mu0, compute=torch.float32):
    """g = 0 two-stream coefficients (Meador-Weaver/PIFM specialised to
    Rayleigh + absorption) in the cancellation-free complement forms,
    rescaled by tau so only one reciprocal remains; ``u`` is the Rayleigh
    optical depth (u <= tau).  tau is floored at ``tau_floor`` inside the
    scattering algebra only, and the resonance guard is at
    ``kernel_eps``, both of kernel compute type ``compute``.
    Returns (r_dif, t_dif, r_dir, t_dir, t_noscat)."""
    eps = kernel_eps(compute)
    taus = torch.clamp(tau, min=tau_floor(compute))
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
    d = torch.where(torch.abs(d) >= eps * tau2, d, eps * tau2)
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


def interp_points(atm: plan_mod.Atmosphere, band: plan_mod.BandInputs):
    """The band's (p, T) interpolation points (ops/interp.py) in its
    grid's dtype: the working dtype, or float32 in the fast mode, where
    the arithmetic is common.cuh's layer_point (plan.model_arrays says
    why)."""
    arr = band.arrays
    grid = arr.temperature_grid
    # The grid constants as tensors on the device: PyTorch's CUDA division
    # by a Python number multiplies by its reciprocal, which rounds
    # otherwise than the kernel's division.
    const = lambda x: torch.tensor(x, dtype=grid.dtype, device=grid.device)
    p_iw = interp.pressure_index(atm.plev.to(grid.dtype), const(arr.log_p0),
                                 const(arr.d_log_p), band.n_p)
    return p_iw, interp.temperature_index(atm.tlay.to(grid.dtype), p_iw,
                                          grid)


def _bilinear_fast(table: torch.Tensor, row0: torch.Tensor, n_t: int,
                   p_iw: interp.IndexWeight, t_iw: interp.IndexWeight
                   ) -> torch.Tensor:
    """The fast mode's (p, T) interpolation of the (rows, ngpt) table at
    lower corner rows ``row0``: the TPU's one bf16 MXU pass of the one-hot
    contraction, sum_corners bf16(wp * wt) * bf16(k), written out.  The
    float32 corner products are rounded to bf16 here; the table already
    holds bf16 values.  Sums in the table's (working) dtype."""
    pw1, tw1 = p_iw.w1[..., None], t_iw.w1[..., None]
    pw0, tw0 = 1.0 - pw1, 1.0 - tw1
    bf16 = lambda w: w.to(torch.bfloat16).to(table.dtype)
    take = lambda off: torch.index_select(
        table, 0, (row0 + off).reshape(-1)).reshape(*row0.shape, -1)
    return (bf16(pw0 * tw0) * take(0) + bf16(pw1 * tw0) * take(n_t)
            + bf16(pw0 * tw1) * take(1) + bf16(pw1 * tw1) * take(n_t + 1))


def gas_tau_plain(atm: plan_mod.Atmosphere, band: plan_mod.BandInputs,
                  simple_w: torch.Tensor) -> torch.Tensor:
    """(ncol, nlay, ngpt) gas optical depth of one band on its own model's
    (p, T) grid, from the flat table, the gas plan and the vmr stacks, per
    gas clamped at zero (common.cuh's gas_tau_params).

    On a fast-mode band (bf16 table) each (p, T) interpolation is
    ``_bilinear_fast`` at float32 points (``interp_points``); the LUT
    gas's mole-fraction weights, the gas weights and the clamp stay in the
    working dtype, as on the TPU (ops/pallas/common.py: the mole-fraction
    weight is applied after the contraction)."""
    arr = band.arrays
    p_iw, t_iw = interp_points(atm, band)
    table = arr.table.to(atm.tlay.dtype)
    n_pt = band.n_p * band.n_t
    corner = p_iw.i0 * band.n_t + t_iw.i0

    def vmr(slot):
        kind, idx = band.vmr_kinds[slot]
        if kind == plan_mod.VMR_PROFILE:
            return atm.vmr_prof[:, idx, :]
        return atm.vmr_col[:, idx, None]

    tau = torch.zeros((*atm.tlay.shape, band.plan.ngpt), dtype=table.dtype,
                      device=table.device)
    for sl in band.plan.slices:
        if sl.kind == plan_mod.KIND_DENSE:
            w = (simple_w * sl.b if sl.vmr_slot < 0
                 else simple_w * (sl.a * vmr(sl.vmr_slot) + sl.b))
            if arr.fast:
                coeff = _bilinear_fast(table, sl.row0 + corner, band.n_t,
                                       p_iw, t_iw)
            else:
                coeff = interp.bilinear_gather(
                    table[sl.row0:sl.row0 + n_pt], band.n_t, p_iw, t_iw)
        else:
            v = vmr(sl.vmr_slot)
            v_iw = interp.vmr_index(v, sl.mf_grid)
            if arr.fast:
                lo, hi = (_bilinear_fast(
                    table, sl.row0 + (v_iw.i0 + dv) * n_pt + corner,
                    band.n_t, p_iw, t_iw) for dv in (0, 1))
                vw1 = v_iw.w1[..., None]
                coeff = (1.0 - vw1) * lo + vw1 * hi
            else:
                rows = len(sl.mf_grid) * n_pt
                coeff = interp.trilinear_gather(
                    table[sl.row0:sl.row0 + rows], band.n_p, band.n_t, p_iw,
                    t_iw, v_iw)
            w = simple_w * v
        tau = tau + torch.clamp(w[..., None] * coeff, min=0.0)
    return tau


def _simple_weight(atm: plan_mod.Atmosphere) -> torch.Tensor:
    """Moles of dry air per m^2 in each layer."""
    return constants.MOLES_PER_PA * (atm.plev[:, 1:] - atm.plev[:, :-1])


def lw_plain(atm: plan_mod.Atmosphere, lw: plan_mod.LwInputs,
             compute: torch.dtype = torch.float32, jac: bool = False):
    """One LW band (common.cuh's lw_optics and lw_sweeps_staged): gas
    optics, Planck sources and the sweeps per angle
    (common.multi_angle_lw_sweeps; at 1 angle the same per-layer math as
    the staged sources), with the constants of kernel compute type
    ``compute``.  Returns (up, dn), and with ``jac`` (the merged kernel's
    Jacobian instantiation) d up / d T_sfc third: J = emis * dB_sfc at the
    surface (``planck_source_jac``), carried up the layers beside the
    radiance by their transmittances."""
    tau = gas_tau_plain(atm, lw, _simple_weight(atm))
    arr = lw.arrays
    planck = lambda t: planck_source(t, arr.planck_temperature,
                                     arr.planck_function)
    b_lay, b_lev, b_sfc = planck(atm.tlay), planck(lw.tlev), planck(lw.tsfc)
    ncol, nlay = atm.tlay.shape
    up = torch.zeros((ncol, nlay + 1), dtype=tau.dtype, device=tau.device)
    dn = torch.zeros_like(up)
    up_jac = torch.zeros_like(up)
    if jac:
        j_sfc = lw.emis * planck_source_jac(lw.tsfc, arr.planck_temperature,
                                            arr.planck_function)
    for sec, wgt in zip(*gauss_angles(lw.n_gauss_angles)):
        w2pi = 2.0 * constants.PI * wgt
        # Edge convention of common.level_edges: the decreasing-index edge
        # of layer j is level j, the increasing-index edge level j+1.
        tr, src_dn, src_up = lw_layer_sources(
            tau * sec, b_lay, b_lev[:, :-1], b_lev[:, 1:],
            thin_layer_tau(compute))
        rad = torch.zeros_like(b_sfc)
        dn_sums = [torch.zeros_like(up[:, 0])]
        for j in range(nlay):
            rad = tr[:, j] * rad + src_dn[:, j]
            dn_sums.append(torch.sum(rad, dim=-1))
        rad = lw.emis * b_sfc + (1.0 - lw.emis) * rad
        up_sums = [torch.sum(rad, dim=-1)]
        if jac:
            y = j_sfc
            jac_sums = [torch.sum(y, dim=-1)]
        for j in range(nlay - 1, -1, -1):
            rad = tr[:, j] * rad + src_up[:, j]
            up_sums.append(torch.sum(rad, dim=-1))
            if jac:
                y = tr[:, j] * y
                jac_sums.append(torch.sum(y, dim=-1))
        dn = dn + w2pi * torch.stack(dn_sums, dim=1)
        up = up + w2pi * torch.stack(up_sums[::-1], dim=1)
        if jac:
            up_jac = up_jac + w2pi * torch.stack(jac_sums[::-1], dim=1)
    return (up, dn, up_jac) if jac else (up, dn)


def sw_plain(atm: plan_mod.Atmosphere, sw: plan_mod.SwInputs,
             compute: torch.dtype = torch.float32):
    """One SW band (common.cuh's sw_optics and sw_sweeps_staged): gas
    optics + Rayleigh, the direct beam, then adding up and down
    (sw_adding_*_step), with the constants of kernel compute type
    ``compute``.  Returns (up, dn) before the night mask."""
    simple_w = _simple_weight(atm)
    tau_gas = gas_tau_plain(atm, sw, simple_w)
    arr = sw.arrays
    nlay = atm.tlay.shape[1]
    tau_ray = simple_w[..., None] * arr.rayleigh
    mu0 = sw.mu0[:, None, None]
    r_dif, t_dif, r_dir, t_dir, t = two_stream_g0(
        tau_gas + tau_ray, tau_ray, mu0, 1.0 / mu0, compute)
    direct = (sw.mu0 * sw.tsi_scale)[:, None] * arr.solar
    dn_sums = [torch.sum(direct, dim=-1)]
    src_up, src_dn = [], []
    for j in range(nlay):
        src_up.append(r_dir[:, j] * direct)
        src_dn.append(t_dir[:, j] * direct)
        direct = t[:, j] * direct
        dn_sums.append(torch.sum(direct, dim=-1))
    albedo = [None] * (nlay + 1)
    src = [None] * (nlay + 1)
    denom = [None] * nlay
    albedo[nlay], src[nlay] = sw.alb, sw.alb * direct
    for j in range(nlay - 1, -1, -1):
        denom[j], albedo[j], src[j] = sw_adding_up_step(
            r_dif[:, j], t_dif[:, j], albedo[j + 1], src[j + 1], src_up[j],
            src_dn[j])
    up_sums = [torch.sum(src[0], dim=-1)]
    dif = torch.zeros_like(direct)
    for j in range(nlay):
        dif, up_next = sw_adding_dn_step(
            t_dif[:, j], r_dif[:, j], denom[j], dif, albedo[j + 1],
            src[j + 1], src_dn[j])
        dn_sums[j + 1] = dn_sums[j + 1] + torch.sum(dif, dim=-1)
        up_sums.append(torch.sum(up_next, dim=-1))
    return torch.stack(up_sums, dim=1), torch.stack(dn_sums, dim=1)


def night_masked(sw: plan_mod.SwInputs, up: torch.Tensor, dn: torch.Tensor):
    """Zero the night columns, which ran with mu0 = 1 (sw.py:325)."""
    day = sw.usecol.to(up.dtype)[:, None]
    return up * day, dn * day
