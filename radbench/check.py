"""The comparison that decides ``correct``.

Each answer held from the window (a call's or a chunk's flux profiles
at the held columns) is compared with the plain reference
(radbench/reference), which reads the ckd files itself and works from the
benchmark's own inputs at those columns; the traffic kind names the
outputs and gives their reference.  The outputs come in pairs, the up
and down fluxes of one band.

A column's error is the largest over the outputs of max |program -
reference| over its levels, divided by the band's flux scale: the
largest |reference| of that band's up and down fluxes at the held
columns of its inputs.  Where several held answers share their inputs, a
column reads the worst of them.  A non-finite output reads as infinity.
The number compared, ``flux_err_p99``, is the 99th percentile of the
errors of all held columns.  Not their largest: in float32 the direct
beam's two-stream terms lose digits near the resonance 1 - (k mu0)^2 = 0,
so about one column in 10,000 reads 1e-5 or more while the others read
under 1e-6 (PERF.md gives the readings).  A fault that reaches one
column in a hundred or more moves the percentile.  Each cell's file
gives the limit (``limits``); PERF.md gives the readings it was set
from.
"""
from __future__ import annotations

import math

import numpy as np
import torch

QUANTILE = 99.0


def column_errors(got, ref) -> torch.Tensor:
    """Each column's error (see the module docstring), float64 on the
    CPU, and each output's largest."""
    per_output = []
    for band in range(0, len(ref), 2):
        scale = max(float(ref[band].abs().max()),
                    float(ref[band + 1].abs().max()))
        for k in (band, band + 1):
            g = got[k].to(ref[k].device, torch.float64)
            e = (g - ref[k]).abs().amax(dim=1) / scale
            per_output.append(torch.where(torch.isfinite(g).all(dim=1), e,
                                          torch.full_like(e, math.inf)))
    per_output = torch.stack(per_output).cpu()
    return per_output.amax(dim=0), per_output.amax(dim=1)


def judge(answers: list, reference, outputs: tuple, limits: dict) -> dict:
    """The numbers compared, each beside its limit; ``answers`` as a
    traffic kind's ``answers()`` gives them, ``reference(inputs)`` the
    reference's ``outputs`` at those inputs.  ``failed``: where the run is
    not correct, the held answers with a column over the limit."""
    limit = limits["flux_err_p99"]
    columns, over = [], []
    worst = torch.zeros(len(outputs), dtype=torch.float64)
    for b, outs in answers:
        if not outs:
            continue
        ref = reference(b)
        group = None
        for got in outs:
            cols, per_output = column_errors(got, ref)
            worst = torch.maximum(worst, per_output)
            over.append(bool((cols > limit).any()))
            group = cols if group is None else torch.maximum(group, cols)
        columns.append(group)
    errs = torch.cat(columns).numpy() if columns else np.zeros(0)
    value = (float(np.percentile(errs, QUANTILE)) if errs.size
             and np.isfinite(errs).all() else math.inf)
    numbers = {"flux_err_p99": {"value": value, "limit": limit}}
    correct = bool(over) and all(n["value"] <= n["limit"]
                                 for n in numbers.values())
    return {"numbers": numbers, "held": len(over),
            "failed": 0 if correct else sum(over), "columns": errs.size,
            "per_output": dict(zip(outputs, worst.tolist())),
            "correct": correct}
