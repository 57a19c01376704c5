"""Shared by the three readers of K1's warp roles' wait shares
(``lwsw_optics_wait_share``, ``lwsw_lw_sweep_wait_share``,
``lwsw_sw_sweep_wait_share``): not a metric of its own (no entry under
``per_layer`` names it).

The shares come from the program's timed build of the merged kernel
(``ecckd_tpu_torch/ops/cuda/role_clock.py``, ``csrc/role_clock.cuh``), in
which every warp counts the cycles of its waits and phases.  The window's
launches stay graph replays of the plain build, which count nothing.  So
after the window ``shares`` sets up the cell's own traffic kind again at
one launch chunk (the cell's ``column_chunk`` columns, one input variant,
the configuration's ckd files written anew, inputs from ``SEED``), with
the program's ``capture.jit`` standing aside so that its warm-up calls
run eagerly and capture nothing, then makes one eager call of the cell's
entry (``pipeline.lw_sw_fluxes`` on the traffic's own arguments) through
``role_clock.timed``: one launch of the timed build at the cell's shape,
plan and kind of inputs.  The result is kept for the run, so the three
readers cost one call.  It prints the seconds it took and the shares to
standard error.

None where the run has no CUDA card, and where the program has no timed
build (no ``role_clock`` module).
"""
from __future__ import annotations

import contextlib
import importlib
import sys
import tempfile
import time

import torch

from radbench import solve

SEED = 1
"""The inputs' seed: the shares describe the kernel's pace at the cell's
shape, and nothing compares these outputs."""
MODULE = "ecckd_tpu_torch.ops.cuda.role_clock"

_kept = (None, None)          # (the run, its shares)


def program_role_clock():
    """The program's ``role_clock`` module, or None where it has none."""
    try:
        return importlib.import_module(MODULE)
    except ModuleNotFoundError as e:
        if e.name != MODULE:
            raise
        return None


@contextlib.contextmanager
def eager_calls():
    """The program's ``capture.jit`` as the identity while the block runs:
    a traffic kind's calls then run eagerly and capture no graph."""
    from ecckd_tpu_torch.utils import capture
    jit = capture.jit
    capture.jit = lambda fn: fn
    try:
        yield
    finally:
        capture.jit = jit


def measure(run, device, role_clock) -> dict:
    """The roles' wait shares of one eager call of the cell's traffic kind
    at one launch chunk on ``device`` through ``role_clock.timed``."""
    kind = run.cell["traffic"]
    traffic = importlib.import_module(f"radbench.traffic.{kind}")
    p = run.cell["params"]
    cell = dict(run.cell, params=dict(p, ncol=p["column_chunk"], variants=1))
    with tempfile.TemporaryDirectory() as work:
        paths = solve.write_ckd_files(run.config, work)
        with eager_calls():
            t = traffic.Traffic(cell, run.config, paths, SEED, [device])
    try:
        with torch.cuda.device(device), role_clock.timed() as timing:
            t.program(t.args[0])
    finally:
        t.close()
    return timing.shares


def shares(run):
    """{role: its wait share in %} of the run's cell (see the module
    docstring), computed once per run; None without a card or a timed
    build."""
    global _kept
    if _kept[0] is run:
        return _kept[1]
    out = None
    device = torch.device(run.devices[0]) if run.devices else None
    if torch.cuda.is_available() and device is not None \
            and device.type == "cuda":
        role_clock = program_role_clock()
        if role_clock is not None:
            t0 = time.perf_counter()
            out = measure(run, device, role_clock)
            print(f"# role clock: set-up and one timed call in "
                  f"{time.perf_counter() - t0:.3f} s; wait shares "
                  + ", ".join(f"{k} {v}" for k, v in out.items()),
                  file=sys.stderr)
    _kept = (run, out)
    return out


def share(run, role: str):
    """Role ``role``'s wait share, or None."""
    s = shares(run)
    return None if s is None else s[role]
