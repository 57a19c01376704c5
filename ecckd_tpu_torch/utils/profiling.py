"""Device traces, spans on the trace's clock, and the card's label
(counterpart of ``ecckd_tpu.utils.profiling``).

PyTorch returns from a CUDA call before the card has run it, so a host
timer around device work must end with a barrier: ``barrier`` waits for
all work queued on the CUDA devices that the given tensors live on.  On
CPU tensors the work is already done and it returns at once.

* ``trace``: a ``torch.profiler`` trace (CPU and, with a card, CUDA
  activity) written as a Chrome trace file.
* ``spans_on``, ``steps``: named ranges in that trace, on the clock of
  its CUDA activity, that exist only while a ``torch.profiler`` records.
  The program keeps and writes nothing itself: the profiler keeps them
  in memory and writes them with its trace.  A span's parent is the span
  that encloses it on the same thread.  A hot path reads ``steps()``
  once per call and runs each of its steps as ``run(name, fn, *args)``:
  with the profiler off that is a bare call, with no range and no
  context entered, and the span's name is never built.
* ``card_name``: the card's name and power limit, the label kept beside
  every device number.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
from typing import Callable, Iterator

import torch
import torch.autograd.profiler

TRACE_FILE = "trace.json"

_RANGE = torch._C._profiler._RecordFunctionFast
"""The profiler range a span enters: the fast form of
``torch.profiler.record_function`` (a ``cpu_op`` event in the trace
rather than a ``user_annotation``), which costs about an eighth of it
while the profiler records."""


def barrier(*tensors: torch.Tensor) -> None:
    """Wait until the CUDA work on every device of ``tensors`` is done."""
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write the Chrome trace to
    ``<log_dir>/trace.json``.  Yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def spans_on() -> bool:
    """Whether a ``torch.profiler`` records now.  Read as the module's
    attribute: the profiler sets and clears it."""
    return torch.autograd.profiler._is_profiler_enabled


def _run_in_span(name: str, fn: Callable, *args, card=None):
    """``fn(*args)`` inside a profiler range named ``name``, or
    ``<name>.card<i>`` where ``card`` gives a device (``i`` its CUDA
    index, 0 on the CPU)."""
    if card is not None:
        name = f"{name}.card{torch.device(card).index or 0}"
    with _RANGE(name):
        return fn(*args)


def _run_bare(name: str, fn: Callable, *args, card=None):
    """``fn(*args)``; the name goes unused (spans off)."""
    return fn(*args)


def steps() -> Callable:
    """How a hot path runs its steps in this call: ``run(name, fn, *args,
    card=None)``, in a span while a profiler records, else bare.  One read
    of ``spans_on`` per call."""
    return _run_in_span if spans_on() else _run_bare


def card_name() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them; a
    card may be set below its maximum power and then runs slower."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]
