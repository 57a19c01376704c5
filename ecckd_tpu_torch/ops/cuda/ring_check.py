"""The ring checker's build of the staged kernels (csrc/ring_check.cuh).

The staged body (csrc/staged.cuh) hands each column slot from its optics
warps to its sweep warps and back through named barriers (FULL, FREE);
with the parameter stage the set's LW sweep warps write the layer
parameters of the slot's next column before they free it, or on the
split route the optics warps compute them into a place of their own
before they wait for FREE.  Built with
``-DECCKD_CHECK_RING`` the same body asserts that hand-over on the card:
per slot, ledgers of the rounds staged, swept and (the stage) of
parameters written, checked after every wait; NaN written over a slot's
rows by their last reader (0 over the layer parameters' places), so a
read of stale staging shows in the outputs; guard words after every
slot; and a seeded jitter at the hand-over points.  Two planted faults,
which the checker must report: ``-DECCKD_PLANT_SKIP_FREE`` (once, the
optics warps stage a slot without waiting for its sweeps, and join its
FREE only after) and ``-DECCKD_PLANT_SKIP_PRM`` (once, the LW sweep
warps free a slot before they write its next column's parameters, and
write them late; on the split route the optics warps compute a slot's
parameters ahead already in its second round, while its last optics
warp stages the first late; only launches with the stage).

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
PLANT_DEFINES = {"free": "ECCKD_PLANT_SKIP_FREE",
                 "prm": "ECCKD_PLANT_SKIP_PRM"}
"""The planted faults' defines by name."""
RING_GUARD_FLOATS = 32
"""Guard words after each slot (csrc/ring_check.cuh RING_GUARD)."""
CHECKS = ("full", "free", "canary", "prm")
"""The checks of the record, in csrc/ring_check.cuh's RingCheckKind order."""


def defines(plant: str = "") -> Tuple[str, ...]:
    """The checked build's defines; with ``plant`` (a name of
    ``PLANT_DEFINES``) also that planted fault's."""
    return (CHECK_DEFINE, PLANT_DEFINES[plant]) if plant else (CHECK_DEFINE,)


@functools.lru_cache(maxsize=None)
def library(name: str, plant: str = "") -> ctypes.CDLL:
    """Build (first use) and bind the checked ``csrc/<name>.cu`` (with the
    planted fault ``plant`` if given): the launch entry points as
    ``binding.bind`` binds them, and ``ecckd_<name>_ring_config`` /
    ``_ring_errors``."""
    from ecckd_tpu_torch.ops.cuda import build
    lib = binding.bind(build.load(name, defines(plant)), name)
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
    n = len(CHECKS)
    out = (ctypes.c_int * (n + 5))()
    _check(lib, getattr(lib, f"ecckd_{name}_ring_errors")(out, int(reset)),
           f"ecckd_{name}_ring_errors")
    count, *by_check = out[:n + 1]
    block, column, slot, check = out[n + 1:]
    return {"count": count, **dict(zip(CHECKS, by_check)),
            "first": None if count == 0 else {
                "block": block, "column": column, "slot": slot,
                "check": CHECKS[check]}}
