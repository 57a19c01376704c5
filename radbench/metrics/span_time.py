"""Shared by the metrics that total the program's spans: not a metric of
its own (no entry under ``per_layer`` names it)."""


def span_ms_per_unit(run, names) -> float:
    """The total of the spans named in ``names`` (host events of any
    category that start inside the traced sub-window), in ms per unit of
    the sub-window; None without tracing or without such spans."""
    w = run.trace
    if w is None or not w.units:
        return None
    us = [e["dur"] for e in w.host_events
          if e["name"] in names and w.t0 <= e["ts"] < w.t1]
    return sum(us) / 1e3 / w.units if us else None
