"""Merged longwave + shortwave solve: the CUDA kernel and its plain version.

``lwsw_fluxes_cuda`` is the port of the JAX package's
``ops/pallas/lwsw.py::lwsw_fluxes_fused`` (TPU kernel ``_lwsw_kernel``):
both bands' broadband fluxes for one atmosphere over one shared
(p, T) interpolation grid, ``top_at_1``, 1-4 LW Gauss angles.  It takes
CUDA tensors and launches ``csrc/lwsw.cu`` (float32, or float64 through
the kernel's double instantiation), or raises.
``lwsw_fluxes_plain`` is the same computation in plain PyTorch, which takes
any dtype on any device and is what the kernel is tested against.

Both run on the same host preparation (ops/cuda/plan.py); the plain
version is ops/cuda/common.py's ``lw_plain`` + ``sw_plain``, the bodies
lw_fluxes_plain and sw_fluxes_plain run too, as the kernel runs
common.cuh's column bodies.  Returns (lw_up, lw_dn, sw_up, sw_dn), each
(ncol, nlay+1).

``lwsw_fluxes_cuda(..., flux_up_jac=True)`` launches the kernel's Jacobian
instantiation (csrc/lwsw.cu ``lwsw_jac_kernel``) and returns RTE's LW
surface-temperature Jacobian, d lw_up / d T_sfc (ncol, nlay+1), fifth.

Both take ``mxu_mode``, the JAX package's mode string
(``config.set_mxu_precision``; None reads the current one at the call): in
the fast mode the plain version interpolates the bf16 table and the
wrapper launches the kernel's fast entry point (``fast_launches``).

The kernel stages each column's sweep coefficients (csrc/common.cuh
"Per-column staging"), as the LW-only and SW-only kernels do on the same
body (csrc/staged.cuh); ops/cuda/staged.py sizes that staging and
launches any of the three.
"""
from __future__ import annotations

from typing import Optional

import torch

from ecckd_tpu_torch import config
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.ops.cuda import (binding, common, plan as plan_mod,
                                      staged)
from ecckd_tpu_torch.ops.cuda.binding import DEFAULT_COLUMN_CHUNK


def _kernel_core(atm: plan_mod.Atmosphere, lw: plan_mod.LwInputs,
                 sw: plan_mod.SwInputs, column_chunk: int,
                 **launch) -> tuple:
    """Launch csrc/lwsw.cu (staged.run_staged, which takes ``launch``, the
    Jacobian's ``jac`` among them) after the input checks, in the bands'
    table mode (both in one mode: plan.prepare)."""
    ncol, nlay = atm.tlay.shape
    lw_t, lw_s = binding.lw_shapes(lw, ncol, nlay, "lw_")
    sw_t, sw_s = binding.sw_shapes(sw, ncol, "sw_")
    binding.check_inputs("lwsw", atm, {**lw_t, **sw_t}, {**lw_s, **sw_s},
                         binding.mode_of(atm, lw))
    return tuple(staged.run_staged(atm, lw, sw, column_chunk,
                                   lwsw_fluxes_cuda, **launch))


def _plain_core(atm: plan_mod.Atmosphere, lw: plan_mod.LwInputs,
                sw: plan_mod.SwInputs,
                compute: torch.dtype = torch.float32,
                jac: bool = False) -> tuple:
    """(lw_up, lw_dn, sw_up, sw_dn), and with ``jac`` d lw_up / d T_sfc
    fifth, as the kernel orders them."""
    lw_out = common.lw_plain(atm, lw, compute, jac)
    return (*lw_out[:2], *common.sw_plain(atm, sw, compute), *lw_out[2:])


def _night_masked(sw: plan_mod.SwInputs, fluxes: tuple) -> tuple:
    """The SW pair masked at night; the LW pair and anything after the SW
    pair (the Jacobian) as they are."""
    lw_up, lw_dn, sw_up, sw_dn, *rest = fluxes
    return (lw_up, lw_dn, *common.night_masked(sw, sw_up, sw_dn), *rest)


def lwsw_fluxes_plain(model_lw: CKDModel, model_sw: CKDModel,
                      plev: torch.Tensor, tlay: torch.Tensor,
                      tlev: torch.Tensor, tsfc: torch.Tensor,
                      emis_gpt: torch.Tensor, gas_concs: GasConcs,
                      sfc_alb: torch.Tensor, tsi: torch.Tensor,
                      sza_deg: torch.Tensor, n_gauss_angles: int = 1,
                      mxu_mode: Optional[str] = None,
                      compute: torch.dtype = torch.float32,
                      flux_up_jac: bool = False) -> tuple:
    """The kernel's computation in plain PyTorch, in tlay's dtype on
    tlay's device.  Arguments as ``lwsw_fluxes_cuda``; ``compute`` is the
    compute type of the instantiation it stands for, whose constants it
    takes (common.py): float32 for the float one, float64 for the double
    one.  ``flux_up_jac``: the Jacobian instantiation's computation, d
    lw_up / d T_sfc fifth (common.lw_plain)."""
    atm, lw, sw = plan_mod.prepare(model_lw, model_sw, plev, tlay, tlev,
                                   tsfc, emis_gpt, gas_concs, sfc_alb, tsi,
                                   sza_deg, n_gauss_angles,
                                   config.is_fast(mxu_mode))
    return _night_masked(sw, _plain_core(atm, lw, sw, compute, flux_up_jac))


def lwsw_fluxes_cuda(model_lw: CKDModel, model_sw: CKDModel,
                     plev: torch.Tensor, tlay: torch.Tensor,
                     tlev: torch.Tensor, tsfc: torch.Tensor,
                     emis_gpt: torch.Tensor, gas_concs: GasConcs,
                     sfc_alb: torch.Tensor, tsi: torch.Tensor,
                     sza_deg: torch.Tensor, n_gauss_angles: int = 1,
                     column_chunk: int = DEFAULT_COLUMN_CHUNK,
                     mxu_mode: Optional[str] = None,
                     flux_up_jac: bool = False) -> tuple:
    """Both bands' broadband fluxes through the merged CUDA kernel.

    Args mirror pipeline.lw_sw_fluxes with the surface already per g-point:
      emis_gpt: (ncol, ngpt_lw) emissivity; sfc_alb: (ncol,) or
      (ncol, ngpt_sw) albedo; tsi (ncol,) [W m-2]; sza_deg (ncol,).
      column_chunk: columns per launch.  The kernel's staging does not
        grow with it: shared memory, or for a column too deep for that
        (``stage_plan``: nlay >~ 250 at 32 + 27 g-points; from nlay 124
        its LW rows) a device slice per persistent block.
      mxu_mode: table mode (None: config's, read now); the fast mode
        launches the fast entry point.
      flux_up_jac: launch the Jacobian instantiation, which also returns
        d lw_up / d T_sfc [W m-2 K-1] (ncol, nlay+1) fifth: float32, one
        angle, the shapes and routes ``staged.jac_refusal`` passes; a
        launch it refuses raises.

    Takes float32 CUDA tensors, or float64 ones in the exact table mode
    (the kernel's double instantiation: every value computed, staged and
    written in double), and launches the kernel; anything else raises
    (ValueError), CPU tensors, the fast mode at float64 and inputs that
    require grad included: ``lwsw_fluxes_plain`` is the version for those.
    Each launch adds one to ``lwsw_fluxes_cuda.launches`` (exact),
    ``.fast_launches`` (fast), ``.f64_launches`` (float64) or
    ``.jac_launches`` (the Jacobian instantiation, either table mode).  The shape
    and the card decide the staging, and no counter records it:
    ``staged.plan_for(atm, lw, sw)`` gives its ``.route`` (the split
    route at nlay 124-208 and one angle on an H100 at float32) and
    ``.prm_stage``, and ``LwInputs.n_gauss_angles`` the angles.
    """
    binding.require_cuda("lwsw_fluxes_cuda", tlay, plev, tlev, tsfc,
                         emis_gpt, gas_concs, sfc_alb, tsi, sza_deg)
    atm, lw, sw = plan_mod.prepare(model_lw, model_sw, plev, tlay, tlev,
                                   tsfc, emis_gpt, gas_concs, sfc_alb, tsi,
                                   sza_deg, n_gauss_angles,
                                   config.is_fast(mxu_mode))
    launch = {"jac": True} if flux_up_jac else {}
    return _night_masked(sw, _kernel_core(atm, lw, sw, column_chunk,
                                          **launch))


lwsw_fluxes_cuda.launches = 0
lwsw_fluxes_cuda.fast_launches = 0
lwsw_fluxes_cuda.f64_launches = 0
lwsw_fluxes_cuda.jac_launches = 0
