"""Precision policy.

The reference chain computes in Fortran double precision.  The port's fast
path (and the only dtype the CUDA kernel takes) is float32; float64 is the
validation precision, selected per call by the dtype of the inputs and of
the model (``CKDModel.astype``).  The JAX package's MXU contraction-mode
switch has no counterpart here: the Hopper kernel gathers table entries
directly in f32, so there are no matrix-unit passes to trade.
"""
from __future__ import annotations

import dataclasses

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


def default_precision() -> Precision:
    """float32: the working precision of the kernel path.  Pass float64
    explicitly (loader ``dtype=``, f64 inputs) for validation runs."""
    return F32


def numpy_dtype(dtype: torch.dtype):
    """The numpy counterpart of a floating torch dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]
