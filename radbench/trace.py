"""The traced sub-window of a ``--trace 1`` run, and what is read from it.

``Tracer.unit(i)`` is called by a traffic kind before unit i (a call or
a pass) of its window.  With tracing on, the profiler
(``torch.profiler``, CPU and CUDA activity) starts before unit ``skip``,
which absorbs the profiler's own first-use costs, and the traced
sub-window runs from unit ``skip + 1`` for ``units`` units; each end is
marked after a barrier on every card of the run, so the sub-window holds
exactly the device work of its units.  The Chrome trace goes to a
temporary directory under ``TMPDIR`` and is read and deleted at once.

``busy_idle`` is the union of the device events (kernels, copies,
memsets) over an interval, as chip_smoke.py computes it.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

from radbench.solve import sync

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
MARK = "radbench.traced"


class Window:
    """The traced sub-window: its units, its interval (trace clock, us),
    and its device events, by device index."""

    def __init__(self, units: int, t0: float, t1: float, device_events,
                 host_events):
        self.units, self.t0, self.t1 = units, t0, t1
        self.device_events = device_events      # {device: [event]}
        self.host_events = host_events

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self, device) -> float:
        return busy_idle(self.device_events.get(device, []), self.t0,
                         self.t1)[0] / 1e6

    def kernel_s(self) -> float:
        """Device seconds of every kernel in the sub-window (copies and
        memsets left out), over all devices."""
        return sum(e["dur"] for evs in self.device_events.values()
                   for e in evs if e["cat"] == "kernel") / 1e6


def busy_idle(events, t0: float, t1: float):
    """(device-busy microseconds, idle share) of [t0, t1] from a Chrome
    trace's device events (the union of their intervals)."""
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in events)
    busy, end = 0.0, t0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy, 1.0 - busy / (t1 - t0)


class Tracer:
    """See the module docstring.  Disabled, ``unit`` returns False and
    records nothing."""

    def __init__(self, enabled: bool, skip: int, units: int, devices):
        self.enabled, self.skip, self.units = enabled, skip, units
        self.devices = devices
        self.prof = None
        self.first = None
        self.seen = -1
        self.window: Optional[Window] = None

    def _mark(self) -> None:
        sync(self.devices)
        with torch.profiler.record_function(MARK):
            pass

    def open(self) -> bool:
        """Whether the traced sub-window is still to come or running: the
        window does not close before it has."""
        return self.enabled and self.window is None

    def unit(self, i: int) -> bool:
        """Called before unit ``i``; whether unit i is profiled."""
        if not self.enabled or self.window is not None:
            return False
        self.seen = i
        if i == self.skip:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if any(torch.device(d).type == "cuda" for d in self.devices):
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            sync(self.devices)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif i == self.skip + 1:
            self._mark()
            self.first = i
        elif self.first is not None and i == self.first + self.units:
            self._finish(self.units)
            return False
        return self.prof is not None

    def close(self) -> None:
        """End the traced sub-window at the window's end, if it is still
        open: its units are those run since it began."""
        if self.prof is not None:
            self._finish(0 if self.first is None
                         else self.seen - self.first + 1)

    def _finish(self, units: int) -> None:
        if units:
            self._mark()
        self.prof.stop()
        with tempfile.TemporaryDirectory() as work:
            path = os.path.join(work, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
        self.prof = None
        marks = sorted(e["ts"] for e in events
                       if e.get("cat") == "user_annotation"
                       and e.get("name") == MARK)
        if units == 0 or len(marks) < 2:
            self.window = Window(0, 0.0, 1.0, {}, [])
            return
        t0, t1 = marks[0], marks[-1]
        device = defaultdict(list)
        for e in events:
            if (e.get("cat") in DEVICE_CATS and e["ts"] < t1
                    and e["ts"] + e["dur"] > t0):
                device[e.get("args", {}).get("device", 0)].append(e)
        end = max([e["ts"] + e["dur"] for evs in device.values()
                   for e in evs] + [t0])
        host = [e for e in events if e.get("cat") in HOST_CATS
                and e["ts"] < end and e["ts"] + e["dur"] > t0]
        # The second mark follows a barrier: the last device event ends
        # the sub-window.
        self.window = Window(units, t0, min(t1, end) if end > t0 else t1,
                             dict(device), host)


def breakdown(w: Window) -> dict:
    """The device operations that took most time, and the longest idle
    stretches of the first device summed by what the host was doing then
    (the innermost host event under a stretch's middle), at most 10 of
    each, in seconds."""
    ops = defaultdict(float)
    for evs in w.device_events.values():
        for e in evs:
            ops[e["name"]] += e["dur"] / 1e6
    first = sorted(w.device_events)[0] if w.device_events else None
    gaps = defaultdict(float)
    spans = sorted((e["ts"], e["ts"] + e["dur"])
                   for e in w.device_events.get(first, []))
    end = w.t0
    holes: List[tuple] = []
    for a, b in spans + [(w.t1, w.t1)]:
        if a > end:
            holes.append((end, min(a, w.t1)))
        end = max(end, b)
    # The longest holes, each under the innermost host event at its middle.
    holes = sorted(holes, key=lambda h: h[0] - h[1])[:2000]
    ts = np.array([e["ts"] for e in w.host_events])
    te = ts + np.array([e["dur"] for e in w.host_events])
    for a, b in holes:
        mid = 0.5 * (a + b)
        under = np.nonzero((ts <= mid) & (te >= mid))[0]
        name = (w.host_events[min(under, key=lambda k: te[k] - ts[k])]["name"]
                if under.size else "python, no traced op")
        gaps[name] += (b - a) / 1e6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def idle_percent(w: Optional[Window], devices) -> Optional[float]:
    """The share of the traced sub-window, in %, in which no device
    event runs, averaged over ``devices``; None without a traced
    sub-window holding device events."""
    if w is None or not w.units or not w.device_events:
        return None
    keys = [torch.device(d).index or 0 for d in devices]
    return 100.0 * sum(busy_idle(w.device_events.get(k, []), w.t0, w.t1)[1]
                       for k in keys) / len(keys)
