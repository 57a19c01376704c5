"""The ring checker's build of the staged kernels (csrc/ring_check.cuh).

The staged body (csrc/staged.cuh) hands each column slot from its optics
warps to its sweep warps and back through named barriers.  Built with
``-DECCKD_CHECK_RING`` the same body asserts that hand-over on the card:
per slot, ledgers of the rounds staged and swept, checked after every
wait; NaN written over a slot's rows by their last reader, so a read of
stale staging shows in the outputs; guard words after every slot; and a
seeded jitter at the hand-over points.  ``-DECCKD_PLANT_SKIP_FREE`` adds
a planted fault (once, the optics warps stage a slot without waiting for
its sweeps, and join its FREE only after), which the checker must
report.

This module builds and binds those libraries (``library``), sizes their
staging (``guarded``: the plan with the guard words) and reads their
error record (``errors``).  The launch paths never load them:
``binding.library`` builds without defines, and only a caller that passes
``lib=`` to ``staged.run_staged`` (tools/cuda_sanitize.py ``--checked``,
chip_smoke.py phase 15) launches one.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

from ecckd_tpu_torch.ops.cuda import binding
from ecckd_tpu_torch.ops.cuda.staged import StagePlan

CHECK_DEFINE = "ECCKD_CHECK_RING"
PLANT_DEFINE = "ECCKD_PLANT_SKIP_FREE"
RING_GUARD_FLOATS = 32
"""Guard words after each slot (csrc/ring_check.cuh RING_GUARD)."""
CHECKS = ("full", "free", "canary")
"""The checks of the record, in csrc/ring_check.cuh's RingCheckKind order."""


def defines(plant: bool = False) -> Tuple[str, ...]:
    """The checked build's defines; with ``plant`` also the planted
    fault's."""
    return (CHECK_DEFINE, PLANT_DEFINE) if plant else (CHECK_DEFINE,)


@functools.lru_cache(maxsize=None)
def library(name: str, plant: bool = False) -> ctypes.CDLL:
    """Build (first use) and bind the checked ``csrc/<name>.cu`` (with the
    planted fault if ``plant``): the launch entry points as
    ``binding.bind`` binds them, and ``ecckd_<name>_ring_config`` /
    ``_ring_errors``."""
    from ecckd_tpu_torch.ops.cuda import build
    lib = binding.bind(build.load(name, defines(plant)), name,
                       binding.ARGS[name])
    config = getattr(lib, f"ecckd_{name}_ring_config")
    config.argtypes = [ctypes.c_uint, ctypes.c_uint]
    config.restype = ctypes.c_int
    read = getattr(lib, f"ecckd_{name}_ring_errors")
    read.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    read.restype = ctypes.c_int
    return lib


def guarded(plan: StagePlan) -> StagePlan:
    """``plan`` with the checker's guard words after every slot: the same
    C, S and threads, each slot ``RING_GUARD_FLOATS`` floats longer."""
    return dataclasses.replace(plan, guard_floats=RING_GUARD_FLOATS)


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.ecckd_cuda_error_string(rc).decode()})")


def configure(lib: ctypes.CDLL, name: str, seed: int,
              jitter_ns: int) -> None:
    """Set the jitter of the next launches: a delay of up to
    ``jitter_ns`` ns at each hand-over point, from ``seed`` (0: none)."""
    _check(lib, getattr(lib, f"ecckd_{name}_ring_config")(seed, jitter_ns),
           f"ecckd_{name}_ring_config")


def errors(lib: ctypes.CDLL, name: str, reset: bool = True) -> dict:
    """The violations recorded since the last reset (call after the
    launches have finished): their count, the count per check
    (``CHECKS``) and the first one's block, column, slot and check (None
    while there is none); ``reset`` clears the record."""
    out = (ctypes.c_int * 8)()
    _check(lib, getattr(lib, f"ecckd_{name}_ring_errors")(out, int(reset)),
           f"ecckd_{name}_ring_errors")
    count, *by_check = out[:4]
    block, column, slot, check = out[4:]
    return {"count": count, **dict(zip(CHECKS, by_check)),
            "first": None if count == 0 else {
                "block": block, "column": column, "slot": slot,
                "check": CHECKS[check]}}
