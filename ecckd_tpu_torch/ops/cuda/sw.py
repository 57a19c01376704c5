"""Shortwave-only solve: the CUDA kernel and its plain version.

``sw_fluxes_cuda`` is the port of the JAX package's
``ops/pallas/sw.py::sw_fluxes_fused`` (TPU kernel ``_sw_kernel``): one SW
model's broadband up and down fluxes, ``top_at_1``, on the model's own
(p, T) grid, with the TOA source renormalised to the requested TSI and
night columns (run with mu0 = 1) zeroed after the solve (sw.py:325).  It
takes CUDA tensors and launches ``csrc/sw.cu`` (float32 only; the staged
body of csrc/staged.cuh with the SW band alone, sized by
ops/cuda/staged.py stage_plan), or raises.
``sw_fluxes_plain`` is the same computation in plain PyTorch
(ops/cuda/common.py's ``sw_plain``, which the merged plain version runs
too), any dtype on any device.  Returns (flux_up, flux_dn), each
(ncol, nlay+1).  Both take ``mxu_mode`` as ops/cuda/lwsw.py does (the fast
mode: the bf16 table, ``fast_launches``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ecckd_tpu_torch import config
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.ops.cuda import binding, common, plan as plan_mod, staged
from ecckd_tpu_torch.ops.cuda.binding import DEFAULT_COLUMN_CHUNK

Fluxes2 = Tuple[torch.Tensor, torch.Tensor]


def _kernel_core(atm: plan_mod.Atmosphere, sw: plan_mod.SwInputs,
                 column_chunk: int, **launch) -> Fluxes2:
    """Launch csrc/sw.cu (staged.run_staged, which takes ``launch``: the
    staged body with the SW band alone, on the SW model's own grid) after
    the input checks, in the band's table mode; before the night mask."""
    ncol = atm.tlay.shape[0]
    binding.check_inputs("sw", atm, *binding.sw_shapes(sw, ncol),
                         binding.mode_of(atm, sw))
    return tuple(staged.run_staged(atm, None, sw, column_chunk,
                                 sw_fluxes_cuda, **launch))


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
    (ncol,); column_chunk: columns per launch (the staging does not grow
    with it: shared memory, or a device slice per persistent block for
    columns too deep for that, nlay >~ 420 at 27 g-points); mxu_mode:
    table mode (None: config's, read now).

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
