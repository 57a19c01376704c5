"""Longwave-only solve: the CUDA kernel and its plain version.

``lw_fluxes_cuda`` is the port of the JAX package's
``ops/pallas/lw.py::lw_fluxes_fused`` (TPU kernel ``_lw_kernel``): one LW
model's broadband up and down fluxes, ``top_at_1``, 1-4 Gauss angles, on
the model's own (p, T) grid.  It takes CUDA tensors and launches
``csrc/lw.cu`` (float32 only; the staged body of csrc/staged.cuh with
the LW band alone, sized by ops/cuda/staged.py stage_plan), or raises.
``lw_fluxes_plain`` is the same computation in plain PyTorch
(ops/cuda/common.py's ``lw_plain``, which the merged plain version runs
too), any dtype on any device.  Returns
(flux_up, flux_dn), each (ncol, nlay+1).  Both take ``mxu_mode`` as
ops/cuda/lwsw.py does (the fast mode: the bf16 table, ``fast_launches``).
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


def _kernel_core(atm: plan_mod.Atmosphere, lw: plan_mod.LwInputs,
                 column_chunk: int, **launch) -> Fluxes2:
    """Launch csrc/lw.cu (staged.run_staged, which takes ``launch``: the
    staged body with the LW band alone) after the input checks, in the
    band's table mode."""
    ncol, nlay = atm.tlay.shape
    binding.check_inputs("lw", atm, *binding.lw_shapes(lw, ncol, nlay),
                         binding.mode_of(atm, lw))
    return tuple(staged.run_staged(atm, lw, None, column_chunk,
                                 lw_fluxes_cuda, **launch))


def lw_fluxes_plain(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
                    tlev: torch.Tensor, tsfc: torch.Tensor,
                    emis_gpt: torch.Tensor, gas_concs: GasConcs,
                    n_gauss_angles: int = 1,
                    mxu_mode: Optional[str] = None) -> Fluxes2:
    """The kernel's computation in plain PyTorch, in tlay's dtype on
    tlay's device.  Arguments as ``lw_fluxes_cuda``."""
    atm, lw = plan_mod.prepare_lw(model, plev, tlay, tlev, tsfc, emis_gpt,
                                  gas_concs, n_gauss_angles,
                                  config.is_fast(mxu_mode))
    return common.lw_plain(atm, lw)


def lw_fluxes_cuda(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
                   tlev: torch.Tensor, tsfc: torch.Tensor,
                   emis_gpt: torch.Tensor, gas_concs: GasConcs,
                   n_gauss_angles: int = 1,
                   column_chunk: int = DEFAULT_COLUMN_CHUNK,
                   mxu_mode: Optional[str] = None) -> Fluxes2:
    """LW broadband fluxes through the CUDA kernel.

    Args mirror pipeline.lw_fluxes with the emissivity already per
    g-point, emis_gpt (ncol, ngpt); column_chunk: columns per launch
    (the staging does not grow with it: shared memory, or a device slice
    per persistent block for columns too deep for that, nlay >~ 590 at
    32 g-points and one angle); mxu_mode: table mode (None: config's,
    read now).

    Takes float32 CUDA tensors and launches the kernel; anything else
    raises (ValueError), CPU tensors and inputs that require grad
    included: ``lw_fluxes_plain`` is the version for those.  Each launch
    adds one to ``lw_fluxes_cuda.launches`` (exact) or ``.fast_launches``
    (fast); ``staged.plan_for(atm, lw, None)`` gives the staging that the
    shape, the angles and the card decide.
    """
    binding.require_cuda("lw_fluxes_cuda", tlay, plev, tlev, tsfc, emis_gpt,
                         gas_concs)
    atm, lw = plan_mod.prepare_lw(model, plev, tlay, tlev, tsfc, emis_gpt,
                                  gas_concs, n_gauss_angles,
                                  config.is_fast(mxu_mode))
    return _kernel_core(atm, lw, column_chunk)


lw_fluxes_cuda.launches = 0
lw_fluxes_cuda.fast_launches = 0
