"""End-to-end flux pipelines (counterpart of ``ecckd_tpu.pipeline``):
gas optics -> solver -> broadband fluxes for a column batch.

Driver-level semantics reproduced here:
* spectrally constant (ncol,) or banded (ncol, nband) surface
  emissivity/albedo expanded to g-points (ecckd_rfmip_lw.F90:112-116,
  ecckd_rfmip_sw.F90:135-140);
* SW: TOA flux renormalised to the requested TSI, night columns
  (sza >= 90 - 2*spacing(90)) run with mu0 = 1 and are zeroed afterwards
  (ecckd_rfmip_sw.F90:103-108,125-161).

Backends: ``"torch"`` is the plain tensor path (gas_optics_* + rte_lw /
rte_sw); ``"cuda"`` is the hand-written kernels, which apply to float32
CUDA tensors in ``top_at_1`` order (LW: 1-4 Gauss angles), and the merged
one also to float64 ones in the exact table mode:
* ``lw_fluxes`` runs the LW kernel (ops/cuda/lw.py, csrc/lw.cu);
* ``sw_fluxes`` runs the SW kernel (ops/cuda/sw.py, csrc/sw.cu);
* ``lw_sw_fluxes`` runs the merged kernel (ops/cuda/lwsw.py,
  csrc/lwsw.cu; at float64 its double instantiation) when the two models
  share a (p, T) grid, and otherwise ``lw_fluxes`` + ``sw_fluxes`` (the LW
  and the SW kernel, each on its own model's grid).
``"auto"`` takes the kernels where they apply and the torch path
otherwise (float64 outside the merged kernel or in the fast mode, CPU
tensors, ``top_at_1=False``,
``logarithmic_interpolation``, and any per-column input that requires
grad while grad is enabled: the kernels define no backward, so gradients
run on the torch path).  Asking for ``"cuda"`` where a needed kernel does
not apply raises, with the reason.

The table mode (``config.set_mxu_precision``; ``--fast``) is read by the
kernel routes at each call: the fast mode launches each kernel's fast
entry point.  The torch route ignores the mode and interpolates the
tables exactly, as the JAX package's XLA path ignores its MXU mode.

RTE's LW surface-temperature Jacobian (``flux_up_jac=True`` on
``lw_fluxes`` and ``lw_sw_fluxes``): the LW ``FluxesBroadband`` also
carries ``flux_up_jac``, d flux_up / d T_sfc at every level
[W m-2 K-1].  The kernel route is the merged kernel's Jacobian
instantiation (float32, one angle, the shipped lw_fsck + sw_wide shapes,
whole or split staging: ``_kernel_refusal`` names what it leaves out);
everything else takes the torch path on ``"auto"`` and raises on
``"cuda"``.

With ``utils.checks.enable_nan_debugging`` on, each stage's output is
checked (gas optics and the solver on the torch route, the fluxes on a
kernel route) and the first non-finite one raises, naming its stage.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ecckd_tpu_torch import config
from ecckd_tpu_torch.config import numpy_dtype
from ecckd_tpu_torch.fluxes import FluxesBroadband
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.models.gas_optics import gas_optics_lw, gas_optics_sw
from ecckd_tpu_torch.ops.cuda.binding import (DEFAULT_COLUMN_CHUNK,
                                              FAST_F64_REFUSAL, grad_refusal)
from ecckd_tpu_torch.ops.cuda.lw import lw_fluxes_cuda
from ecckd_tpu_torch.ops.cuda import staged
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda
from ecckd_tpu_torch.ops.cuda.plan import build_plan, models_mergeable
from ecckd_tpu_torch.ops.cuda.sw import sw_fluxes_cuda
from ecckd_tpu_torch.solvers.lw import rte_lw
from ecckd_tpu_torch.solvers.sw import rte_sw
from ecckd_tpu_torch.utils.checks import check_stage

BACKENDS = ("auto", "torch", "cuda")

_KERNELS = {"lwsw": "the merged kernel K1 (csrc/lwsw.cu)",
            "lw": "the LW kernel K3 (csrc/lw.cu)",
            "sw": "the SW kernel K4 (csrc/sw.cu)"}


def _check_backend(backend: str, logarithmic_interpolation: bool = False
                   ) -> None:
    """A typo'd backend must not silently re-route the compute path."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                         "'torch' or 'cuda'")
    if logarithmic_interpolation and backend == "cuda":
        raise ValueError("logarithmic_interpolation is not supported by the "
                         "CUDA kernel; use backend='auto' or 'torch'")


def _surface_to_gpt(model: CKDModel, sfc, ncol: int, dtype,
                    device) -> torch.Tensor:
    """Surface emissivity/albedo to per-g-point (ncol, ngpt): a spectrally
    constant (ncol,) value or a banded (ncol, nband) one."""
    sfc = torch.as_tensor(sfc, device=device).to(dtype)
    if sfc.ndim == 1:
        return sfc[:, None].expand(ncol, model.ngpt)
    if sfc.shape[-1] != model.nband:
        raise ValueError(f"banded surface array has {sfc.shape[-1]} bands; "
                         f"model has {model.nband}")
    return model.gpt_weights_per_band(sfc)


def _column_slice(x, c0: int, c1: int, ncol: int):
    """Columns [c0, c1) of a batch argument: tensors / GasConcs values
    whose leading axis is the column axis; anything else unchanged."""
    if isinstance(x, GasConcs):
        return GasConcs(values=tuple(_column_slice(v, c0, c1, ncol)
                                     for v in x.values), names=x.names)
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == ncol:
        return x[c0:c1]
    return x


def _over_column_chunks(fn, batch: tuple, ncol: int,
                        chunk: int) -> FluxesBroadband:
    """Run ``fn(*batch)`` over column chunks (bounding peak memory) and
    concatenate the fluxes."""
    parts = [fn(*(_column_slice(x, c0, min(c0 + chunk, ncol), ncol)
                  for x in batch)) for c0 in range(0, ncol, chunk)]
    jac = None
    if parts[0].flux_up_jac is not None:
        jac = torch.cat([f.flux_up_jac for f in parts])
    return FluxesBroadband(torch.cat([f.flux_up for f in parts]),
                           torch.cat([f.flux_dn for f in parts]), jac)


def lw_fluxes(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
              tlev: torch.Tensor, tsfc: torch.Tensor, sfc_emis: torch.Tensor,
              gas_concs: GasConcs, n_gauss_angles: int = 1,
              top_at_1: bool = True, column_chunk: Optional[int] = None,
              backend: str = "auto",
              logarithmic_interpolation: bool = False,
              flux_up_jac: bool = False) -> FluxesBroadband:
    """Longwave broadband fluxes for a column batch.

    Args:
      sfc_emis: surface emissivity, (ncol,) or banded (ncol, nband).
      column_chunk: on the kernel path, columns per launch (default
        ops/cuda/binding.DEFAULT_COLUMN_CHUNK); on the torch path,
        optional chunks bounding peak memory.
      backend: "auto" | "torch" | "cuda" (the LW kernel; raises where it
        does not apply).
      logarithmic_interpolation: the reference's alternate log-space table
        interpolation; torch path only.
      flux_up_jac: also give d flux_up / d T_sfc (the result's
        ``flux_up_jac``); torch path only (the LW kernel has no Jacobian).
    """
    _check_backend(backend, logarithmic_interpolation)
    ncol = tlay.shape[0]
    if backend != "torch" and not logarithmic_interpolation:
        refusal = _kernel_refusal(
            tlay, top_at_1, n_gauss_angles,
            inputs=(plev, tlev, tsfc, sfc_emis, gas_concs), kernel="lw",
            flux_up_jac=flux_up_jac)
        if refusal is None:
            emis_gpt = _surface_to_gpt(model, sfc_emis, ncol, tlay.dtype,
                                       tlay.device)
            up, dn = lw_fluxes_cuda(
                model, plev, tlay, tlev, tsfc, emis_gpt, gas_concs,
                n_gauss_angles=n_gauss_angles,
                column_chunk=column_chunk or DEFAULT_COLUMN_CHUNK)
            check_stage("lw kernel", flux_up=up, flux_dn=dn)
            return FluxesBroadband(flux_up=up, flux_dn=dn)
        _refuse_cuda(backend, "lw", refusal)
    if column_chunk is not None and ncol > column_chunk:
        fn = lambda p, tl, tv, ts, e, c: lw_fluxes(
            model, p, tl, tv, ts, e, c, n_gauss_angles=n_gauss_angles,
            top_at_1=top_at_1, backend=backend,
            logarithmic_interpolation=logarithmic_interpolation,
            flux_up_jac=flux_up_jac)
        return _over_column_chunks(
            fn, (plev, tlay, tlev, tsfc, sfc_emis, gas_concs), ncol,
            column_chunk)
    props, sources = gas_optics_lw(
        model, plev, tlay, tsfc, gas_concs, tlev,
        logarithmic_interpolation=logarithmic_interpolation)
    check_stage("gas_optics_lw", tau=props.tau,
                lay_source=sources.lay_source,
                lev_source_inc=sources.lev_source_inc,
                lev_source_dec=sources.lev_source_dec,
                sfc_source=sources.sfc_source)
    emis_gpt = _surface_to_gpt(model, sfc_emis, ncol, props.tau.dtype,
                               tlay.device)
    out = rte_lw(props, sources, emis_gpt, top_at_1=top_at_1,
                 n_gauss_angles=n_gauss_angles, flux_up_jac=flux_up_jac)
    check_stage("rte_lw", flux_up=out[0], flux_dn=out[1],
                **({"flux_up_jac": out[2]} if flux_up_jac else {}))
    return FluxesBroadband(*out)


def sw_fluxes(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
              gas_concs: GasConcs, sfc_alb: torch.Tensor, tsi: torch.Tensor,
              sza_deg: torch.Tensor, top_at_1: bool = True,
              column_chunk: Optional[int] = None, backend: str = "auto",
              logarithmic_interpolation: bool = False) -> FluxesBroadband:
    """Shortwave broadband fluxes for a column batch.

    Args:
      sfc_alb: surface albedo, (ncol,) or banded (ncol, nband); diffuse ==
        direct, as in the reference RFMIP program.
      tsi: requested total solar irradiance [W m-2], (ncol,).
      sza_deg: solar zenith angle [degrees], (ncol,).
      column_chunk: as lw_fluxes.
      backend: "auto" | "torch" | "cuda" (the SW kernel; raises where it
        does not apply).
    """
    _check_backend(backend, logarithmic_interpolation)
    ncol = tlay.shape[0]
    if backend != "torch" and not logarithmic_interpolation:
        refusal = _kernel_refusal(
            tlay, top_at_1, inputs=(plev, gas_concs, sfc_alb, tsi, sza_deg),
            kernel="sw")
        if refusal is None:
            alb = torch.as_tensor(sfc_alb, device=tlay.device).to(tlay.dtype)
            if alb.ndim == 2:
                alb = _surface_to_gpt(model, alb, ncol, tlay.dtype,
                                      tlay.device)
            up, dn = sw_fluxes_cuda(
                model, plev, tlay, gas_concs, alb, tsi, sza_deg,
                column_chunk=column_chunk or DEFAULT_COLUMN_CHUNK)
            check_stage("sw kernel", flux_up=up, flux_dn=dn)
            return FluxesBroadband(flux_up=up, flux_dn=dn)
        _refuse_cuda(backend, "sw", refusal)
    if column_chunk is not None and ncol > column_chunk:
        fn = lambda p, tl, c, a, t, s: sw_fluxes(
            model, p, tl, c, a, t, s, top_at_1=top_at_1, backend=backend,
            logarithmic_interpolation=logarithmic_interpolation)
        return _over_column_chunks(
            fn, (plev, tlay, gas_concs, sfc_alb, tsi, sza_deg), ncol,
            column_chunk)
    props, toa_src = gas_optics_sw(
        model, plev, tlay, gas_concs,
        logarithmic_interpolation=logarithmic_interpolation)
    check_stage("gas_optics_sw", tau=props.tau, ssa=props.ssa,
                toa_src=toa_src)
    dtype, device = props.tau.dtype, tlay.device

    # Renormalise the incoming solar flux to the requested TSI.
    def_tsi = torch.sum(toa_src, dim=-1, keepdim=True)
    toa_flux = toa_src * (torch.as_tensor(tsi, device=device)[:, None].to(
        dtype) / def_tsi)

    # Night mask: sza >= 90 - 2*spacing(90) in working precision.
    spacing90 = float(np.spacing(np.asarray(90.0, dtype=numpy_dtype(dtype))))
    sza = torch.as_tensor(sza_deg, device=device).to(dtype)
    usecol = sza < (90.0 - 2.0 * spacing90)
    deg_to_rad = float(np.arccos(-1.0) / 180.0)
    mu0 = torch.where(usecol, torch.cos(sza * deg_to_rad),
                      torch.ones_like(sza))

    alb_gpt = _surface_to_gpt(model, sfc_alb, ncol, dtype, device)
    flux_up, flux_dn, _ = rte_sw(props, mu0, toa_flux, alb_gpt, alb_gpt,
                                 top_at_1=top_at_1)
    check_stage("rte_sw", flux_up=flux_up, flux_dn=flux_dn)
    mask = usecol[:, None].to(dtype)
    return FluxesBroadband(flux_up=flux_up * mask, flux_dn=flux_dn * mask)


def _kernel_refusal(tlay: torch.Tensor, top_at_1: bool,
                    n_gauss_angles: int = 1, inputs: tuple = (),
                    kernel: str = "lwsw", flux_up_jac: bool = False,
                    models: tuple = (), gases: tuple = ()) -> Optional[str]:
    """Why CUDA kernel ``kernel`` ("lwsw", "lw" or "sw") does not apply to
    this call, or None if it does: the same rule for the three, but that
    float64 runs on the merged kernel alone (its double instantiation),
    in the exact table mode.  ``inputs`` are the call's other per-column
    inputs: if any of them, or tlay, requires grad the kernels would cut
    the autograd graph.  With ``flux_up_jac`` the merged kernel's Jacobian
    instantiation must take the call: float32, one angle, and the bands of
    ``models`` (LW, SW) under the gas names ``gases`` at tlay's layers
    where ``staged.jac_refusal`` passes them (on a CUDA card, also their
    staging route); these reasons come before the device's, so that a
    call on the CPU names them too."""
    grad = grad_refusal(tlay, *inputs)
    if grad is not None:
        return grad
    if flux_up_jac:
        card = (None, None)
        if tlay.device.type == "cuda":
            props = torch.cuda.get_device_properties(tlay.device)
            card = (props.shared_memory_per_block_optin,
                    props.shared_memory_per_multiprocessor)
        jac = _jac_refusal(tlay, n_gauss_angles, kernel, models, gases, card)
        if jac is not None:
            return jac
    if tlay.device.type != "cuda":
        return f"tensors are on {tlay.device}, not a CUDA device"
    if tlay.dtype == torch.float64:
        if kernel != "lwsw":
            return (f"{_KERNELS[kernel]} has no float64 instantiation; "
                    "float64 runs on the merged kernel K1 alone")
        if config.is_fast(None):
            return FAST_F64_REFUSAL
    elif tlay.dtype != torch.float32:
        return (f"the kernels take float32 (the merged one also float64), "
                f"got {tlay.dtype}")
    if not top_at_1:
        return "the kernels take top_at_1 layer order"
    if not 1 <= n_gauss_angles <= 4:
        return f"n_gauss_angles={n_gauss_angles} is outside 1..4"
    return None


def _jac_refusal(tlay: torch.Tensor, n_gauss_angles: int, kernel: str,
                 models: tuple, gases: tuple,
                 card: tuple = (None, None)) -> Optional[str]:
    """``_kernel_refusal``'s reasons for the Jacobian: K3 and K4 have no
    Jacobian instantiation, and K1's is float32's at one angle on the
    bands ``staged.jac_refusal`` takes (their route too, given the card's
    shared memory per block and per SM in ``card``)."""
    if kernel != "lwsw":
        return (f"{_KERNELS[kernel]} has no Jacobian instantiation; "
                f"flux_up_jac runs on {_KERNELS['lwsw']}")
    if tlay.dtype != torch.float32:
        return ("the Jacobian instantiation of the merged kernel is "
                f"float32's alone, got {tlay.dtype}")
    if n_gauss_angles != 1:
        return ("the Jacobian instantiation of the merged kernel sweeps one "
                f"angle, got n_gauss_angles={n_gauss_angles}")
    (lw_plan, sw_plan), n_t = ([build_plan(m, gases) for m in models],
                               models[0].temperature_grid.shape[1])
    return staged.jac_refusal(tlay.shape[1], lw_plan.ngpt, sw_plan.ngpt,
                              staged.band_gases(lw_plan),
                              staged.band_gases(sw_plan), n_t, *card)


def _refuse_cuda(backend: str, kernel: str, refusal: str) -> None:
    """backend='cuda' never falls back to the torch path."""
    if backend == "cuda":
        raise ValueError(f"backend='cuda' requested but {_KERNELS[kernel]} "
                         f"does not apply: {refusal}")


def lw_sw_fluxes(model_lw: CKDModel, model_sw: CKDModel, plev: torch.Tensor,
                 tlay: torch.Tensor, tlev: torch.Tensor, tsfc: torch.Tensor,
                 sfc_emis: torch.Tensor, gas_concs: GasConcs,
                 sfc_alb: torch.Tensor, tsi: torch.Tensor,
                 sza_deg: torch.Tensor, n_gauss_angles: int = 1,
                 top_at_1: bool = True, column_chunk: Optional[int] = None,
                 backend: str = "auto", flux_up_jac: bool = False
                 ) -> Tuple[FluxesBroadband, FluxesBroadband]:
    """Both bands' broadband fluxes over one atmosphere (the climate-model
    and RFMIP-benchmark shape of the workload).  Returns (lw, sw).

    Where the kernels apply (see the module docstring) and the models share
    a (p, T) grid, this is one merged-kernel pass per column chunk
    (``column_chunk`` defaults to the kernel's); otherwise lw_fluxes +
    sw_fluxes with the same backend, each taking its own kernel where it
    applies.  ``flux_up_jac``: the LW result also carries d flux_up /
    d T_sfc (``FluxesBroadband.flux_up_jac``), on the merged kernel's
    Jacobian instantiation where ``_kernel_refusal`` passes the call, else
    on the torch path (``"cuda"`` raises with its reason).
    """
    _check_backend(backend)
    inputs = (plev, tlev, tsfc, sfc_emis, gas_concs, sfc_alb, tsi, sza_deg)
    merged = backend != "torch" and models_mergeable(model_lw, model_sw)
    if merged:
        refusal = _kernel_refusal(tlay, top_at_1, n_gauss_angles, inputs,
                                  "lwsw", flux_up_jac, (model_lw, model_sw),
                                  gas_concs.names)
        if flux_up_jac and refusal is not None:
            _refuse_cuda(backend, "lwsw", refusal)
        merged = refusal is None
    if merged:
        ncol, dtype, device = tlay.shape[0], tlay.dtype, tlay.device
        emis_gpt = _surface_to_gpt(model_lw, sfc_emis, ncol, dtype, device)
        alb = torch.as_tensor(sfc_alb, device=device).to(dtype)
        if alb.ndim == 2:
            alb = _surface_to_gpt(model_sw, alb, ncol, dtype, device)
        lu, ld, su, sd, *jac = lwsw_fluxes_cuda(
            model_lw, model_sw, plev, tlay, tlev, tsfc, emis_gpt, gas_concs,
            alb, tsi, sza_deg, n_gauss_angles=n_gauss_angles,
            column_chunk=column_chunk or DEFAULT_COLUMN_CHUNK,
            flux_up_jac=flux_up_jac)
        check_stage("lwsw kernel", lw_flux_up=lu, lw_flux_dn=ld,
                    sw_flux_up=su, sw_flux_dn=sd,
                    **({"lw_flux_up_jac": jac[0]} if jac else {}))
        return (FluxesBroadband(lu, ld, *jac),
                FluxesBroadband(flux_up=su, flux_dn=sd))
    return (lw_fluxes(model_lw, plev, tlay, tlev, tsfc, sfc_emis, gas_concs,
                      n_gauss_angles=n_gauss_angles, top_at_1=top_at_1,
                      column_chunk=column_chunk, backend=backend,
                      flux_up_jac=flux_up_jac),
            sw_fluxes(model_sw, plev, tlay, gas_concs, sfc_alb, tsi, sza_deg,
                      top_at_1=top_at_1, column_chunk=column_chunk,
                      backend=backend))


def clamp_top_pressure(plev: np.ndarray, press_min: float,
                       top_at_1: bool = True) -> np.ndarray:
    """Driver-side input sanitising: the model cannot run below its minimum
    table pressure, so the top level is set just above it
    (ecckd_rfmip_lw.F90:87-94)."""
    plev = np.array(plev, copy=True)
    eps = (np.finfo(plev.dtype).eps
           if np.issubdtype(plev.dtype, np.floating)
           else np.finfo(np.float64).eps)
    if top_at_1:
        plev[:, 0] = press_min + eps
    else:
        plev[:, -1] = press_min + eps
    return plev
