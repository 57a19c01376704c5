"""Timers, device traces and throughput metrics (counterpart of
``ecckd_tpu.utils.profiling``).

PyTorch returns from a CUDA call before the card has run it, so a host
timer around device work must end with a barrier: ``barrier`` waits for
all work queued on the CUDA devices that the given tensors live on.  On
CPU tensors the work is already done and it returns at once.

* ``device_timer``: CUDA events around a block of device work on a card,
  the host clock on the CPU.
* ``trace``: a ``torch.profiler`` trace (CPU and, with a card, CUDA
  activity) written as a Chrome trace file.
* ``time_fn``: steady-state seconds per call, ending with the barrier.
* ``throughput_metrics``: the columns/s record, with the JAX keys.
* ``card_name``: the card's name and power limit, the label kept beside
  every device number.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time
from typing import Dict, Iterator, Optional

import torch

from ecckd_tpu_torch.utils.tree import tree_leaves

TRACE_FILE = "trace.json"


def barrier(*tensors: torch.Tensor) -> None:
    """Wait until the CUDA work on every device of ``tensors`` is done."""
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Timing:
    label: str
    seconds: float

    @property
    def ms(self) -> float:
        return self.seconds * 1e3


@contextlib.contextmanager
def device_timer(label: str, result_holder: Optional[list] = None
                 ) -> Iterator[None]:
    """Time a block of device work; append ``Timing(label, seconds)`` to
    ``result_holder``.

    Where there is a card, the time is between two CUDA events recorded
    on the current card's current stream before and after the block, so
    it covers the device work the block queued there; the timer waits for
    the second event.  On the CPU the work is done when the block
    returns, and the host clock times it."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result_holder is not None:
                result_holder.append(Timing(label,
                                            time.perf_counter() - t0))
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        yield
    finally:
        end.record()
        end.synchronize()
        if result_holder is not None:
            result_holder.append(Timing(label,
                                        start.elapsed_time(end) / 1e3))


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


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Steady-state seconds per call of ``fn(*args)``: ``warmup`` calls,
    then ``iters`` calls back to back on the host clock, ending with the
    barrier on the last call's outputs."""
    def done(out):
        barrier(*(t for t in tree_leaves(out) if isinstance(t, torch.Tensor)))

    for _ in range(warmup):
        done(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    done(out)
    return (time.perf_counter() - t0) / iters


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


def throughput_metrics(ncol: int, seconds_per_step: float,
                       n_devices: int = 1) -> Dict[str, float]:
    cols_per_sec = ncol / seconds_per_step
    return {
        "columns_per_sec": cols_per_sec,
        "columns_per_sec_per_chip": cols_per_sec / max(n_devices, 1),
        "step_ms": seconds_per_step * 1e3,
    }
