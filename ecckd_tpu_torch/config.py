"""Precision policy and the fast table mode.

The reference chain computes in Fortran double precision.  The port's fast
path (and the only dtype the CUDA kernels take) is float32; float64 is the
validation precision, selected per call by the dtype of the inputs and of
the model (``CKDModel.astype``), or made the loader's default by
``enable_f64_validation_mode``.

``set_mxu_precision`` keeps the JAX package's mode names.  On the TPU they
choose how many bf16 passes each one-hot table contraction takes.  The
Hopper kernels gather table entries directly, so what is ported is what the
modes compute: ``"bf16x3"`` and ``"highest"`` interpolate the f32 tables
exactly; ``"bf16"`` (and its legacy alias ``"default"``) is the fast mode,
which interpolates tables rounded to bf16 with bf16-rounded corner weights
and f32 sums, as the TPU's single bf16 pass does (ops/cuda/common.py's
``gas_tau_plain``, csrc/common.cuh's ``gas_tau``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Working precision for the compute path."""

    dtype: torch.dtype

    @property
    def eps(self) -> float:
        return float(torch.finfo(self.dtype).eps)


F32 = Precision(torch.float32)
F64 = Precision(torch.float64)

MXU_MODES = ("bf16x3", "bf16", "highest", "default")
FAST_MODES = ("bf16", "default")

_F64_VALIDATION = False
_MXU_MODE = "bf16x3"


def default_precision() -> Precision:
    """float32, the working precision of the kernel path; float64 after
    ``enable_f64_validation_mode``.  Pass float64 explicitly (loader
    ``dtype=``, f64 inputs) for a single validation run."""
    return F64 if _F64_VALIDATION else F32


def enable_f64_validation_mode(enabled: bool = True) -> None:
    """Make float64 the default working precision (the loader's default
    dtype), so results can be compared against the Fortran
    double-precision chain.  Counterpart of the JAX package's switch,
    which turns on x64.  The CLIs keep their ``--precision`` flag, f32
    unless told otherwise, as the JAX CLIs do."""
    global _F64_VALIDATION
    _F64_VALIDATION = bool(enabled)


def set_mxu_precision(mode: str) -> None:
    """Select the table mode of the kernels and their plain versions.

    ``"bf16x3"`` (default) and ``"highest"``: exact f32 interpolation.
    ``"bf16"`` and its legacy alias ``"default"``: the fast mode (bf16
    table entries and interpolation weights, f32 sums; <= 5e-4 of the flux
    scale).  The mode is read at each call, not latched at a first trace,
    so a call after this one runs in the new mode.  The torch route
    (float64, CPU tensors, gradients, log interpolation) ignores it.
    """
    if mode not in MXU_MODES:
        raise ValueError(f"unknown MXU precision mode: {mode!r}")
    global _MXU_MODE
    _MXU_MODE = mode


def mxu_precision() -> str:
    """The current mode string (``set_mxu_precision``)."""
    return _MXU_MODE


def is_fast(mode: Optional[str] = None) -> bool:
    """Whether ``mode`` (None: the current one) is the fast table mode."""
    mode = _MXU_MODE if mode is None else mode
    if mode not in MXU_MODES:
        raise ValueError(f"unknown MXU precision mode: {mode!r}")
    return mode in FAST_MODES


def numpy_dtype(dtype: torch.dtype):
    """The numpy counterpart of a floating torch dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]
