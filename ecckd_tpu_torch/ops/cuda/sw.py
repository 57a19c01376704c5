"""Shortwave-only solve: the CUDA kernel and its plain version.

``sw_fluxes_cuda`` is the port of the JAX package's
``ops/pallas/sw.py::sw_fluxes_fused`` (TPU kernel ``_sw_kernel``): one SW
model's broadband up and down fluxes, ``top_at_1``, on the model's own
(p, T) grid, with the TOA source renormalised to the requested TSI and
night columns (run with mu0 = 1) zeroed after the solve (sw.py:325).  It
takes CUDA tensors and launches ``csrc/sw.cu`` (float32 only), or raises.
``sw_fluxes_plain`` is the same computation in plain PyTorch
(ops/cuda/common.py's ``sw_plain``, which the merged plain version runs
too), any dtype on any device.  Returns (flux_up, flux_dn), each
(ncol, nlay+1).  Both take ``mxu_mode`` as ops/cuda/lwsw.py does (the fast
mode: the bf16 table, ``fast_launches``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ecckd_tpu_torch import config
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.ops.cuda import binding, common, plan as plan_mod
from ecckd_tpu_torch.ops.cuda.binding import DEFAULT_COLUMN_CHUNK

Fluxes2 = Tuple[torch.Tensor, torch.Tensor]


class _Args(ctypes.Structure):
    """Mirror of csrc/sw.cu's SwArgs."""
    _fields_ = [("atm", binding.Atmos), ("grid", binding.Grid),
                ("band", binding.Band), ("sw", binding.SwSolve)]


def _kernel_core(atm: plan_mod.Atmosphere, sw: plan_mod.SwInputs,
                 column_chunk: int) -> Fluxes2:
    """Launch csrc/sw.cu over column chunks on the current stream (before
    the night mask), in the band's table mode."""
    ncol, nlay = atm.tlay.shape
    fast = sw.arrays.fast
    binding.check_inputs("sw", atm, *binding.sw_shapes(sw, ncol), fast)
    dev = atm.tlay.device
    up, dn = (torch.zeros((ncol, nlay + 1), dtype=torch.float32, device=dev)
              for _ in range(2))
    if ncol == 0:
        return up, dn
    chunk = max(1, min(int(column_chunk), ncol))
    scratch = torch.empty((binding.sw_scratch_rows(nlay), chunk,
                           sw.plan.ngpt), dtype=torch.float32, device=dev)
    # The SW model's own grid: it need not be the LW model's.
    grid, band = binding.grid_struct(sw), binding.band_struct(sw)

    def make_args(c0: int, c1: int) -> _Args:
        return _Args(atm=binding.atmos_struct(atm, c0, c1), grid=grid,
                     band=band,
                     sw=binding.sw_struct(sw, c0, c1, up, dn, scratch))

    binding.launch_chunks("sw", _Args, ncol, chunk, make_args,
                          sw_fluxes_cuda, dev, fast)
    return up, dn


def sw_fluxes_plain(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
                    gas_concs: GasConcs, sfc_alb: torch.Tensor,
                    tsi: torch.Tensor, sza_deg: torch.Tensor,
                    mxu_mode: Optional[str] = None) -> Fluxes2:
    """The kernel's computation in plain PyTorch, in tlay's dtype on
    tlay's device.  Arguments as ``sw_fluxes_cuda``."""
    atm, sw = plan_mod.prepare_sw(model, plev, tlay, gas_concs, sfc_alb, tsi,
                                  sza_deg, config.is_fast(mxu_mode))
    return common.night_masked(sw, *common.sw_plain(atm, sw))


def sw_fluxes_cuda(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
                   gas_concs: GasConcs, sfc_alb: torch.Tensor,
                   tsi: torch.Tensor, sza_deg: torch.Tensor,
                   column_chunk: int = DEFAULT_COLUMN_CHUNK,
                   mxu_mode: Optional[str] = None) -> Fluxes2:
    """SW broadband fluxes through the CUDA kernel.

    Args mirror pipeline.sw_fluxes with the albedo spectrally constant
    (ncol,) or per g-point (ncol, ngpt); tsi (ncol,) [W m-2]; sza_deg
    (ncol,); column_chunk: columns per launch (bounds the scratch memory);
    mxu_mode: table mode (None: config's, read now).

    Takes float32 CUDA tensors and launches the kernel; anything else
    raises (ValueError), CPU tensors and inputs that require grad
    included: ``sw_fluxes_plain`` is the version for those.  Each launch
    adds one to ``sw_fluxes_cuda.launches`` (exact) or ``.fast_launches``
    (fast).
    """
    binding.require_cuda("sw_fluxes_cuda", tlay, plev, gas_concs, sfc_alb,
                         tsi, sza_deg)
    atm, sw = plan_mod.prepare_sw(model, plev, tlay, gas_concs, sfc_alb, tsi,
                                  sza_deg, config.is_fast(mxu_mode))
    return common.night_masked(sw, *_kernel_core(atm, sw, column_chunk))


sw_fluxes_cuda.launches = 0
sw_fluxes_cuda.fast_launches = 0
