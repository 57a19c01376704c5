"""Capture and host prep: the time a card is idle while the host is
inside the program's call (a ``capture.call`` span of
``utils/capture.jit``), in ms per call, averaged over the cell's cards.

Over the traced sub-window [t0, t1], the union of the card's device
events (kernels, copies, memsets) is inverted into its idle stretches
and intersected with the union of the ``capture.call`` spans; the total
is divided by the sub-window's calls.  The rest of the card's idle time
(``device_idle_share.calls``) falls while the host is outside the
program: in the harness's loop."""
import torch


def union(intervals):
    """The union of [a, b) intervals, sorted, as disjoint [a, b] lists."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> float:
    """The length of the intersection of two unions."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    w = run.trace
    if w is None or not w.units or not w.device_events:
        return None
    clip = lambda e: (max(e["ts"], w.t0), min(e["ts"] + e["dur"], w.t1))
    held = union(clip(e) for e in w.host_events
                 if e["name"] == "capture.call")
    if not held:
        return None
    inside = sum(b - a for a, b in held)
    keys = [torch.device(d).index or 0 for d in run.devices]
    idle = sum(inside - overlap(held, union(
        clip(e) for e in w.device_events.get(k, []))) for k in keys)
    return idle / len(keys) / 1e3 / w.units
