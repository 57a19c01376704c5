"""ecckd_tpu_torch: ecCKD gas optics + RTE flux solvers in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``ecckd_tpu`` (which stays in the repository as
the reference): the same module layout and function names, torch tensors
in place of JAX arrays.  On float32 CUDA tensors the flux pipelines run
hand-written CUDA kernels (``csrc/lwsw.cu``, ``lw.cu``, ``sw.cu``, built at
first use by ``ops/cuda/build.py``); everything else is plain PyTorch.
``capture.jit(fn)`` runs a pipeline function on the card as one CUDA
graph per shape, captured once and replayed (the JAX package's jit
unit).  This package imports neither ``jax`` nor ``ecckd_tpu``.
"""
from ecckd_tpu_torch.fluxes import FluxesBroadband, heating_rate
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel, ckd_from_jax
from ecckd_tpu_torch.models.gas_optics import (gas_optics, gas_optics_lw,
                                               gas_optics_sw)
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.optics import (OpticalProps1scl, OpticalProps2str,
                                    SourceFuncLW)
from ecckd_tpu_torch.pipeline import lw_fluxes, lw_sw_fluxes, sw_fluxes
from ecckd_tpu_torch.solvers.lw import rte_lw
from ecckd_tpu_torch.solvers.sw import rte_sw
from ecckd_tpu_torch.utils import capture

__version__ = "0.1.0"

__all__ = [
    "CKDModel", "GasConcs", "capture", "FluxesBroadband", "OpticalProps1scl",
    "OpticalProps2str", "SourceFuncLW", "ckd_from_jax", "gas_optics",
    "gas_optics_lw", "gas_optics_sw", "heating_rate", "load_ckd_model",
    "lw_fluxes", "lw_sw_fluxes", "rte_lw", "rte_sw", "sw_fluxes",
]
