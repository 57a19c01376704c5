"""The role clock: a timed build of the merged kernel (csrc/role_clock.cuh).

The staged body (csrc/staged.cuh) runs three warp roles: optics warps,
which stage a column slot and then wait for its sweeps (FREE); LW sweep
warps, which wait for a staged slot (FULL) and for their set's other
angles (LW_DONE); and the SW sweep warp, which waits at FULL.  Built with
``-DECCKD_TIME_ROLES`` the same body counts, per warp, the cycles of each
wait and phase and its total, and adds them at its end into one device
record by role.  ``shares`` turns the record into each role's share of
its cycles spent waiting: the optics warps' at FREE (high: the sweeps set
the pace), the LW sweep warps' at FULL and LW_DONE, the SW sweep warps' at
FULL (high: the optics set the pace).

This module builds and binds the timed library of ``csrc/lwsw.cu``
(``library``; its defines enter its key, so it never takes the plain
build's place), reads and clears its record (``read``), and runs eager
calls with every merged-kernel launch on it (``timed``).  Two planted
faults, for the instrument's own test: ``-DECCKD_PLANT_SLOW_SW`` (the SW
sweep warp spins a fixed number of cycles per column) and
``-DECCKD_PLANT_SLOW_OPTICS`` (each optics warp does, per column).

The launch paths never load the timed build: ``binding.library`` builds
without defines, and only ``timed`` hands this build to
``staged.run_staged``, by replacing that function while it is open;
outside it the launch path is the plain one.  It refuses to run under
graph capture, whose replays would launch the plain build.  The timed
build takes the plain build's plan (C, S, threads, shared bytes):
``stage_plan`` does not see the define.  Nothing here runs at import.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch

from ecckd_tpu_torch.ops.cuda import binding, staged

NAME = "lwsw"
"""The kernel the timed build is made of: the merged kernel (K1, K2)."""
TIME_DEFINE = "ECCKD_TIME_ROLES"
PLANT_DEFINES = {"slow_sw": "ECCKD_PLANT_SLOW_SW",
                 "slow_optics": "ECCKD_PLANT_SLOW_OPTICS"}
"""The planted faults' defines by name."""
ROLES = ("optics", "lw_sweep", "sw_sweep", "lw_chunk1")
"""The record's roles, in csrc/role_clock.cuh's RoleKind order: the last
counts the LW sweep warps of g-chunk 1 a second time, where a set gives
an angle one LW warp per g-chunk (``StagePlan.lw_warps`` 2), so each
chunk's walk reads apart (``sweep_cycles``); ``lw_sweep`` counts both."""
COUNTERS = ("total", "free", "full", "lw_done", "params", "optics", "sweep",
            "warps", "over")
"""Each role's counters, in csrc/role_clock.cuh's RoleCounter order:
cycles in total and in each wait and phase, the role's warps, and the
warps whose counted cycles exceed their total (0 unless the instrument is
at fault)."""
SPANS = COUNTERS[1:7]
"""The counters of a warp's waits and phases."""
WAITS = {"optics": ("free",), "lw_sweep": ("full", "lw_done"),
         "sw_sweep": ("full",)}
"""The waits that each role's share counts."""

Record = Dict[str, Dict[str, int]]


def defines(plant: str = "") -> Tuple[str, ...]:
    """The timed build's defines; with ``plant`` (a name of
    ``PLANT_DEFINES``) also that planted fault's."""
    return (TIME_DEFINE, PLANT_DEFINES[plant]) if plant else (TIME_DEFINE,)


def library(plant: str = "") -> ctypes.CDLL:
    """Build (first use) and bind the timed ``csrc/lwsw.cu`` (with the
    planted fault ``plant`` if given): the launch entry points as
    ``binding.bind`` binds them, and ``ecckd_lwsw_role_clock``.
    ``build.load`` loads a build once; binding it again costs a few
    calls."""
    from ecckd_tpu_torch.ops.cuda import build
    lib = binding.bind(build.load(NAME, defines(plant)), NAME)
    words = getattr(lib, f"ecckd_{NAME}_role_words")
    words.argtypes = []
    words.restype = ctypes.c_int
    if words() != len(ROLES) * len(COUNTERS):
        raise RuntimeError(f"role record layout mismatch: C {words()} words "
                           f"vs Python {len(ROLES) * len(COUNTERS)}")
    clock = getattr(lib, f"ecckd_{NAME}_role_clock")
    clock.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    clock.restype = ctypes.c_int
    return lib


def parse(words) -> Record:
    """The record's words (role by role, ``COUNTERS`` each) by role and
    counter."""
    n = len(COUNTERS)
    return {role: dict(zip(COUNTERS, (int(w) for w in words[r * n:(r + 1)
                                                              * n])))
            for r, role in enumerate(ROLES)}


def read(lib: ctypes.CDLL, reset: bool = True) -> Record:
    """The record since the last reset (call after the launches have
    finished); ``reset`` clears it."""
    out = (ctypes.c_ulonglong * (len(ROLES) * len(COUNTERS)))()
    rc = getattr(lib, f"ecckd_{NAME}_role_clock")(out, int(reset))
    if rc != 0:
        raise RuntimeError(f"ecckd_{NAME}_role_clock failed: CUDA error {rc} "
                           f"({lib.ecckd_cuda_error_string(rc).decode()})")
    return parse(out)


def shares(record: Record) -> Dict[str, Optional[float]]:
    """Per role, its waits' cycles (``WAITS``) over its total cycles, in %;
    None for a role with no cycles."""
    out = {}
    for role, waits in WAITS.items():
        c = record[role]
        out[role] = (100.0 * sum(c[w] for w in waits) / c["total"]
                     if c["total"] else None)
    return out


def sweep_cycles(record: Record, ncol: int) -> Dict[str, Optional[float]]:
    """Each sweep warp's ``sweep`` cycles a column, from a record of
    launches over ``ncol`` columns: the SW sweep warp's (``sw_sweep``),
    the LW sweep warps' of g-chunk 0 (``lw_chunk0``: each angle's warp
    where a set has one an angle) and of g-chunk 1 (``lw_chunk1``, None
    where no set splits its chunks).  A set has one SW warp, so the SW
    warps count the sets; each warp of a role walks ``ncol`` over that
    many columns."""
    sets = record["sw_sweep"]["warps"]
    lw, hi = record["lw_sweep"], record["lw_chunk1"]
    per = lambda cycles, warps: (cycles * sets / (warps * ncol) if warps
                                 else None)
    return {"sw_sweep": per(record["sw_sweep"]["sweep"], sets),
            "lw_chunk0": per(lw["sweep"] - hi["sweep"],
                             lw["warps"] - hi["warps"]),
            "lw_chunk1": per(hi["sweep"], hi["warps"])}


def capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class Timing:
    """What ``timed`` yields: once the block has ended, the record of its
    launches (``record``) and the roles' wait shares (``shares``)."""

    def __init__(self):
        self.record: Optional[Record] = None

    @property
    def shares(self) -> Dict[str, Optional[float]]:
        return shares(self.record)


@contextlib.contextmanager
def timed(plant: str = ""):
    """Within the block, every merged-kernel launch that
    ``staged.run_staged`` makes (an eager ``pipeline.lw_sw_fluxes`` or
    ``lwsw_fluxes_cuda`` call, ``lwsw._kernel_core``) runs on the timed
    build (with the planted fault ``plant`` if given); the LW-only and
    SW-only kernels stay plain.  Yields a ``Timing``, filled when the
    block ends: the block's launches synchronized, the record read and
    cleared.  Raises RuntimeError under graph capture, at entry or at a
    launch."""
    if capturing():
        raise RuntimeError("role_clock.timed: the stream is capturing a "
                           "graph, whose replays launch the plain build")
    lib = library(plant)
    read(lib)
    timing = Timing()
    run_staged = staged.run_staged

    def timed_run(atm, lw, sw, *args, **launch):
        if capturing():
            raise RuntimeError("role_clock.timed: a launch under graph "
                               "capture")
        if lw is None or sw is None:
            return run_staged(atm, lw, sw, *args, **launch)
        return run_staged(atm, lw, sw, *args, **dict(launch, lib=lib))

    staged.run_staged = timed_run
    try:
        yield timing
    finally:
        staged.run_staged = run_staged
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    timing.record = read(lib)
