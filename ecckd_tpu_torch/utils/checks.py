"""Numerical-safety checks (counterpart of ``ecckd_tpu.utils.checks``).

* ``validate_inputs``: host-side fail-fast checks of physical ranges,
  mirroring the reference's fail-fast ``stop_on_err`` error model
  (mo_simple_netcdf.F90:331-339);
* ``assert_all_finite``: a finiteness guard on a tensor.  PyTorch runs
  eagerly, so it checks at the call and raises there (reading one flag
  back from the device);
* ``enable_nan_debugging``: the counterpart of the JAX package's switch
  (``jax_debug_nans``, which checks every op's result).  Here the pipeline
  checks each stage's output (``check_stage``): gas optics and the solver
  on the torch route, the fluxes on the kernel routes, and raises at the
  stage that made the first non-finite value.  Each check reads one flag
  back from the device, so it is off by default.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class InputValidationError(ValueError):
    pass


_NAN_DEBUG = False


def enable_nan_debugging(enabled: bool = True) -> None:
    """Check every pipeline stage's output for NaN and infinity
    (``check_stage``); a FloatingPointError names the first stage that
    made one."""
    global _NAN_DEBUG
    _NAN_DEBUG = bool(enabled)


def nan_debugging() -> bool:
    """Whether NaN debugging is on (``enable_nan_debugging``)."""
    return _NAN_DEBUG


def check_stage(stage: str, **tensors: torch.Tensor) -> None:
    """With NaN debugging on, ``assert_all_finite`` on each tensor, named
    "<stage> <name>"; a no-op otherwise."""
    if _NAN_DEBUG:
        for name, x in tensors.items():
            assert_all_finite(x, f"{stage} {name}")


def validate_inputs(plev: np.ndarray, tlay: np.ndarray,
                    tlev: Optional[np.ndarray] = None,
                    press_min: Optional[float] = None,
                    press_max: Optional[float] = None) -> None:
    """Fail fast on unphysical driver inputs (host-side, before the
    solve)."""
    plev = np.asarray(plev)
    tlay = np.asarray(tlay)
    if plev.ndim != 2 or tlay.ndim != 2 or plev.shape[1] != tlay.shape[1] + 1:
        raise InputValidationError(
            f"plev must be (ncol, nlay+1) and tlay (ncol, nlay); got "
            f"{plev.shape} and {tlay.shape}")
    if not np.isfinite(plev).all() or not np.isfinite(tlay).all():
        raise InputValidationError("non-finite pressures or temperatures")
    dp = np.diff(plev, axis=1)
    if not ((dp > 0).all() or (dp < 0).all()):
        raise InputValidationError(
            "level pressures must be strictly monotonic in the same "
            "direction for every column")
    if (tlay <= 0).any():
        raise InputValidationError("non-positive layer temperatures")
    if tlev is not None and (np.asarray(tlev) <= 0).any():
        raise InputValidationError("non-positive level temperatures")
    # Tolerance: one f32 ulp of press_min, not a fixed 1e-12 relative:
    # clamp_top_pressure stores press_min + eps into an f32 array, and in
    # binades where the f32 ulp exceeds 2*eps the stored value legally
    # rounds up to 0.5 ulp below press_min; a 1e-12 tolerance would then
    # reject inputs the clamp itself produced.
    if press_min is not None:
        floor = np.float64(np.nextafter(np.float32(press_min),
                                        np.float32(0.0)))
        if plev.min() < floor:
            raise InputValidationError(
                f"pressure {plev.min():g} Pa below table minimum "
                f"{press_min:g} Pa; apply clamp_top_pressure first")
    if press_max is not None and plev.max() > press_max * (1 + 0.25):
        raise InputValidationError(
            f"pressure {plev.max():g} Pa far above table maximum "
            f"{press_max:g} Pa")


def assert_all_finite(x: torch.Tensor, name: str = "array") -> torch.Tensor:
    """Raise FloatingPointError if ``x`` holds a NaN or an infinity;
    return ``x`` unchanged otherwise."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x
