"""Merged longwave + shortwave solve: the CUDA kernel and its plain version.

``lwsw_fluxes_cuda`` is the port of the JAX package's
``ops/pallas/lwsw.py::lwsw_fluxes_fused`` (TPU kernel ``_lwsw_kernel``):
both bands' broadband fluxes for one atmosphere over one shared
(p, T) interpolation grid, ``top_at_1``, 1-4 LW Gauss angles.  On CUDA
tensors it launches ``csrc/lwsw.cu`` (float32 only) or raises; on CPU
tensors it runs ``lwsw_fluxes_plain``, the same computation in plain
PyTorch, which takes any dtype on any device and is what the kernel is
tested against.

Both run on the same host preparation (ops/cuda/plan.py) and share the
night mask applied after the solve.  Returns (lw_up, lw_dn, sw_up, sw_dn),
each (ncol, nlay+1).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ecckd_tpu_torch import constants
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.ops import interp
from ecckd_tpu_torch.ops.cuda import common, plan as plan_mod
from ecckd_tpu_torch.ops.planck import planck_source
from ecckd_tpu_torch.solvers.quadrature import gauss_angles

Fluxes4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

DEFAULT_COLUMN_CHUNK = 65536
"""Columns per kernel launch: bounds the per-layer scratch (at nlay 60,
~54 KB per column, ~3.5 GB per 65,536-column chunk)."""

MAX_SLICES = 16  # csrc/lwsw.cu


# --- ctypes mirror of csrc/lwsw.cu's LwswArgs ------------------------------
class _Slice(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("row0", ctypes.c_int),
                ("vmr_kind", ctypes.c_int), ("vmr_idx", ctypes.c_int),
                ("n_mf", ctypes.c_int), ("a", ctypes.c_float),
                ("b", ctypes.c_float), ("mf0", ctypes.c_float),
                ("log_mf0", ctypes.c_float), ("d_log", ctypes.c_float),
                ("v_hi", ctypes.c_float)]


class _Band(ctypes.Structure):
    _fields_ = [("table", ctypes.c_void_p), ("ngpt", ctypes.c_int),
                ("nslice", ctypes.c_int), ("s", _Slice * MAX_SLICES)]


_PTR_FIELDS = ("plev", "tlay", "tlev", "tsfc", "emis", "alb", "mu0",
               "tsi_scale", "vmr_prof", "vmr_scal", "t_first", "planck",
               "solar", "ray", "lw_up", "lw_dn", "sw_up", "sw_dn",
               "lw_scratch", "sw_scratch")


class _Args(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in _PTR_FIELDS]
                + [("lw", _Band), ("sw", _Band)]
                + [(name, ctypes.c_int) for name in (
                    "ncol", "nlay", "n_prof", "n_scal", "n_p", "n_t",
                    "n_planck", "n_ang")]
                + [(name, ctypes.c_float) for name in (
                    "log_p0", "d_log_p", "p_hi", "dt", "t_hi", "planck_t0",
                    "planck_dt")]
                + [("sec", ctypes.c_float * 4), ("w2pi", ctypes.c_float * 4)])


def _library() -> ctypes.CDLL:
    """Build (first use) and bind csrc/lwsw.cu.  Imported here, not at
    module import, so the CPU tests import this module without nvcc."""
    from ecckd_tpu_torch.ops.cuda import build
    lib = build.load("lwsw")
    lib.ecckd_lwsw_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ecckd_lwsw_launch.restype = ctypes.c_int
    lib.ecckd_lwsw_args_size.argtypes = []
    lib.ecckd_lwsw_args_size.restype = ctypes.c_int
    lib.ecckd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ecckd_cuda_error_string.restype = ctypes.c_char_p
    if lib.ecckd_lwsw_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(
            f"LwswArgs layout mismatch: C {lib.ecckd_lwsw_args_size()} "
            f"bytes vs ctypes {ctypes.sizeof(_Args)}")
    return lib


def _band_struct(band: plan_mod.BandInputs) -> _Band:
    slices = band.plan.slices
    if len(slices) > MAX_SLICES:
        raise ValueError(f"{len(slices)} contributing gases; the kernel "
                         f"takes at most {MAX_SLICES}")
    out = _Band(table=band.arrays.table.data_ptr(), ngpt=band.plan.ngpt,
                nslice=len(slices))
    for i, sl in enumerate(slices):
        vkind, vidx = (band.vmr_kinds[sl.vmr_slot] if sl.vmr_slot >= 0
                       else (plan_mod.VMR_NONE, 0))
        out.s[i] = _Slice(kind=sl.kind, row0=sl.row0, vmr_kind=vkind,
                          vmr_idx=vidx, a=sl.a, b=sl.b)
        if sl.kind == plan_mod.KIND_LUT:
            # The constants of interp.vmr_index, rounded to float32 once.
            grid = sl.mf_grid
            out.s[i].n_mf = len(grid)
            out.s[i].mf0 = grid[0]
            out.s[i].log_mf0 = math.log(grid[0])
            out.s[i].d_log = math.log(grid[1] / grid[0])
            out.s[i].v_hi = len(grid) - 1.001
    return out


def _check_kernel_inputs(p: plan_mod.LwswInputs) -> None:
    tensors = dict(plev=p.plev, tlay=p.tlay, tlev=p.tlev, tsfc=p.tsfc,
                   emis=p.emis, alb=p.alb, mu0=p.mu0, tsi_scale=p.tsi_scale,
                   vmr_prof=p.vmr_prof, vmr_col=p.vmr_col,
                   lw_table=p.lw.arrays.table, sw_table=p.sw.arrays.table,
                   planck=p.lw.arrays.planck_function)
    device = p.tlay.device
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"lwsw kernel: {name} is on {t.device}, "
                             f"expected one CUDA device ({device})")
        if t.dtype != torch.float32:
            raise ValueError(f"lwsw kernel takes float32; {name} is "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lwsw kernel: {name} is not contiguous")
    ncol, nlay = p.tlay.shape
    expect = dict(plev=(ncol, nlay + 1), tlev=(ncol, nlay + 1),
                  tsfc=(ncol,), emis=(ncol, p.lw.plan.ngpt),
                  alb=(ncol, p.sw.plan.ngpt), mu0=(ncol,),
                  tsi_scale=(ncol,))
    for name, shape in expect.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"lwsw kernel: {name} has shape "
                             f"{tuple(tensors[name].shape)}, expected {shape}")
    if p.vmr_prof.shape[0] != ncol or p.vmr_prof.shape[2] != nlay \
            or p.vmr_col.shape[0] != ncol:
        raise ValueError("lwsw kernel: vmr stacks do not match (ncol, nlay)")
    for t in (p.lw.arrays.table, p.sw.arrays.table):
        if t.numel() >= 2 ** 31:
            raise ValueError("lwsw kernel: table exceeds 32-bit row indexing")


def _kernel_core(p: plan_mod.LwswInputs, column_chunk: int) -> Fluxes4:
    """Launch csrc/lwsw.cu over column chunks on the current stream."""
    _check_kernel_inputs(p)
    lib = _library()
    ncol, nlay = p.tlay.shape
    dev = p.tlay.device
    ng_lw, ng_sw = p.lw.plan.ngpt, p.sw.plan.ngpt
    n_ang = p.n_gauss_angles
    outs = [torch.zeros((ncol, nlay + 1), dtype=torch.float32, device=dev)
            for _ in range(4)]
    if ncol == 0:
        return tuple(outs)
    chunk = max(1, min(int(column_chunk), ncol))
    lw_rows = 2 * nlay if n_ang == 1 else 3 * nlay + 1
    lw_scratch = torch.empty((lw_rows, chunk, ng_lw), dtype=torch.float32,
                             device=dev)
    sw_scratch = torch.empty((6 * nlay + 2, chunk, ng_sw),
                             dtype=torch.float32, device=dev)
    lwa, swa = p.lw.arrays, p.sw.arrays
    secants, weights = gauss_angles(n_ang)
    args = _Args(
        t_first=lwa.t_first.data_ptr(), planck=lwa.planck_function.data_ptr(),
        solar=swa.solar.data_ptr(), ray=swa.rayleigh.data_ptr(),
        lw_scratch=lw_scratch.data_ptr(), sw_scratch=sw_scratch.data_ptr(),
        lw=_band_struct(p.lw), sw=_band_struct(p.sw),
        nlay=nlay, n_prof=p.vmr_prof.shape[1], n_scal=p.vmr_col.shape[1],
        n_p=p.n_p, n_t=p.n_t, n_planck=lwa.planck_function.shape[0],
        n_ang=n_ang, log_p0=lwa.log_p0, d_log_p=lwa.d_log_p,
        p_hi=p.n_p - 1.0001, dt=lwa.dt, t_hi=p.n_t - 1.0001,
        planck_t0=lwa.planck_t0, planck_dt=lwa.planck_dt)
    for a, (sec, wgt) in enumerate(zip(secants, weights)):
        args.sec[a] = sec
        args.w2pi[a] = 2.0 * constants.PI * wgt
    per_column = dict(plev=p.plev, tlay=p.tlay, tlev=p.tlev, tsfc=p.tsfc,
                      emis=p.emis, alb=p.alb, mu0=p.mu0,
                      tsi_scale=p.tsi_scale, vmr_prof=p.vmr_prof,
                      vmr_scal=p.vmr_col, lw_up=outs[0], lw_dn=outs[1],
                      sw_up=outs[2], sw_dn=outs[3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0 in range(0, ncol, chunk):
        c1 = min(c0 + chunk, ncol)
        for name, t in per_column.items():
            setattr(args, name, t[c0:c1].data_ptr())
        args.ncol = c1 - c0
        rc = lib.ecckd_lwsw_launch(ctypes.byref(args), stream)
        if rc != 0:
            raise RuntimeError(f"lwsw kernel launch failed: CUDA error {rc} "
                               f"({lib.ecckd_cuda_error_string(rc).decode()})")
        lwsw_fluxes_cuda.launches += 1
    return tuple(outs)


# --- the plain version ------------------------------------------------------
def _gas_tau_plain(p: plan_mod.LwswInputs, band: plan_mod.BandInputs,
                   p_iw, t_iw, simple_w) -> torch.Tensor:
    """(ncol, nlay, ngpt) gas optical depth from the flat table, the gas
    plan and the vmr stacks, per gas clamped at zero (the kernel's
    gas_tau)."""
    table = band.arrays.table
    n_pt = p.n_p * p.n_t

    def vmr(slot):
        kind, idx = band.vmr_kinds[slot]
        if kind == plan_mod.VMR_PROFILE:
            return p.vmr_prof[:, idx, :]
        return p.vmr_col[:, idx, None]

    tau = torch.zeros((*p.tlay.shape, band.plan.ngpt), dtype=table.dtype,
                      device=table.device)
    for sl in band.plan.slices:
        if sl.kind == plan_mod.KIND_DENSE:
            w = (simple_w * sl.b if sl.vmr_slot < 0
                 else simple_w * (sl.a * vmr(sl.vmr_slot) + sl.b))
            coeff = interp.bilinear_gather(table[sl.row0:sl.row0 + n_pt],
                                           p.n_t, p_iw, t_iw)
        else:
            v = vmr(sl.vmr_slot)
            rows = len(sl.mf_grid) * n_pt
            coeff = interp.trilinear_gather(
                table[sl.row0:sl.row0 + rows], p.n_p, p.n_t, p_iw, t_iw,
                interp.vmr_index(v, sl.mf_grid))
            w = simple_w * v
        tau = tau + torch.clamp(w[..., None] * coeff, min=0.0)
    return tau


def _lw_plain(p: plan_mod.LwswInputs, tau: torch.Tensor):
    """LW sweeps per angle (common.multi_angle_lw_sweeps; at 1 angle the
    same per-layer math as the fused layer pass)."""
    arr = p.lw.arrays
    planck = lambda t: planck_source(t, arr.planck_temperature,
                                     arr.planck_function)
    b_lay, b_lev, b_sfc = planck(p.tlay), planck(p.tlev), planck(p.tsfc)
    ncol, nlay = p.tlay.shape
    up = torch.zeros((ncol, nlay + 1), dtype=tau.dtype, device=tau.device)
    dn = torch.zeros_like(up)
    for sec, wgt in zip(*gauss_angles(p.n_gauss_angles)):
        w2pi = 2.0 * constants.PI * wgt
        # Edge convention of common.level_edges: the decreasing-index edge
        # of layer j is level j, the increasing-index edge level j+1.
        tr, src_dn, src_up = common.lw_layer_sources(
            tau * sec, b_lay, b_lev[:, :-1], b_lev[:, 1:])
        rad = torch.zeros_like(b_sfc)
        dn_sums = [torch.zeros_like(up[:, 0])]
        for j in range(nlay):
            rad = tr[:, j] * rad + src_dn[:, j]
            dn_sums.append(torch.sum(rad, dim=-1))
        rad = p.emis * b_sfc + (1.0 - p.emis) * rad
        up_sums = [torch.sum(rad, dim=-1)]
        for j in range(nlay - 1, -1, -1):
            rad = tr[:, j] * rad + src_up[:, j]
            up_sums.append(torch.sum(rad, dim=-1))
        dn = dn + w2pi * torch.stack(dn_sums, dim=1)
        up = up + w2pi * torch.stack(up_sums[::-1], dim=1)
    return up, dn


def _sw_plain(p: plan_mod.LwswInputs, tau_gas: torch.Tensor,
              simple_w: torch.Tensor):
    """SW direct beam, then adding up and down (sw_adding_*_step)."""
    arr = p.sw.arrays
    nlay = p.tlay.shape[1]
    tau_ray = simple_w[..., None] * arr.rayleigh
    mu0 = p.mu0[:, None, None]
    r_dif, t_dif, r_dir, t_dir, t = common.two_stream_g0(
        tau_gas + tau_ray, tau_ray, mu0, 1.0 / mu0)
    direct = (p.mu0 * p.tsi_scale)[:, None] * arr.solar
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
    albedo[nlay], src[nlay] = p.alb, p.alb * direct
    for j in range(nlay - 1, -1, -1):
        denom[j], albedo[j], src[j] = common.sw_adding_up_step(
            r_dif[:, j], t_dif[:, j], albedo[j + 1], src[j + 1], src_up[j],
            src_dn[j])
    up_sums = [torch.sum(src[0], dim=-1)]
    dif = torch.zeros_like(direct)
    for j in range(nlay):
        dif, up_next = common.sw_adding_dn_step(
            t_dif[:, j], r_dif[:, j], denom[j], dif, albedo[j + 1],
            src[j + 1], src_dn[j])
        dn_sums[j + 1] = dn_sums[j + 1] + torch.sum(dif, dim=-1)
        up_sums.append(torch.sum(up_next, dim=-1))
    return torch.stack(up_sums, dim=1), torch.stack(dn_sums, dim=1)


def _plain_core(p: plan_mod.LwswInputs) -> Fluxes4:
    # One set of interpolation points serves both models (shared grid).
    lwa = p.lw.arrays
    p_iw = interp.pressure_index(p.plev, lwa.log_p0, lwa.d_log_p, p.n_p)
    t_iw = interp.temperature_index(p.tlay, p_iw, lwa.temperature_grid)
    simple_w = constants.MOLES_PER_PA * (p.plev[:, 1:] - p.plev[:, :-1])
    lw_up, lw_dn = _lw_plain(p, _gas_tau_plain(p, p.lw, p_iw, t_iw,
                                               simple_w))
    sw_up, sw_dn = _sw_plain(p, _gas_tau_plain(p, p.sw, p_iw, t_iw,
                                               simple_w), simple_w)
    return lw_up, lw_dn, sw_up, sw_dn


def _night_masked(p: plan_mod.LwswInputs, fluxes: Fluxes4) -> Fluxes4:
    lw_up, lw_dn, sw_up, sw_dn = fluxes
    day = p.usecol.to(sw_up.dtype)[:, None]
    return lw_up, lw_dn, sw_up * day, sw_dn * day


def lwsw_fluxes_plain(model_lw: CKDModel, model_sw: CKDModel,
                      plev: torch.Tensor, tlay: torch.Tensor,
                      tlev: torch.Tensor, tsfc: torch.Tensor,
                      emis_gpt: torch.Tensor, gas_concs: GasConcs,
                      sfc_alb: torch.Tensor, tsi: torch.Tensor,
                      sza_deg: torch.Tensor, n_gauss_angles: int = 1
                      ) -> Fluxes4:
    """The kernel's computation in plain PyTorch, in tlay's dtype on
    tlay's device.  Arguments as ``lwsw_fluxes_cuda``."""
    p = plan_mod.prepare(model_lw, model_sw, plev, tlay, tlev, tsfc,
                         emis_gpt, gas_concs, sfc_alb, tsi, sza_deg,
                         n_gauss_angles)
    return _night_masked(p, _plain_core(p))


def lwsw_fluxes_cuda(model_lw: CKDModel, model_sw: CKDModel,
                     plev: torch.Tensor, tlay: torch.Tensor,
                     tlev: torch.Tensor, tsfc: torch.Tensor,
                     emis_gpt: torch.Tensor, gas_concs: GasConcs,
                     sfc_alb: torch.Tensor, tsi: torch.Tensor,
                     sza_deg: torch.Tensor, n_gauss_angles: int = 1,
                     column_chunk: int = DEFAULT_COLUMN_CHUNK) -> Fluxes4:
    """Both bands' broadband fluxes through the merged CUDA kernel.

    Args mirror pipeline.lw_sw_fluxes with the surface already per g-point:
      emis_gpt: (ncol, ngpt_lw) emissivity; sfc_alb: (ncol,) or
      (ncol, ngpt_sw) albedo; tsi (ncol,) [W m-2]; sza_deg (ncol,).
      column_chunk: columns per launch (bounds the scratch memory).

    On CUDA tensors this launches the kernel (float32 only; anything else
    raises).  On CPU tensors it runs ``lwsw_fluxes_plain``: there is no
    kernel there.  Each launch adds one to ``lwsw_fluxes_cuda.launches``.
    """
    p = plan_mod.prepare(model_lw, model_sw, plev, tlay, tlev, tsfc,
                         emis_gpt, gas_concs, sfc_alb, tsi, sza_deg,
                         n_gauss_angles)
    if p.tlay.device.type == "cpu":
        return _night_masked(p, _plain_core(p))
    return _night_masked(p, _kernel_core(p, column_chunk))


lwsw_fluxes_cuda.launches = 0
