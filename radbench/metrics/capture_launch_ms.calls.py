"""Capture and host prep: the program's ``capture.replay`` spans
(``utils/capture.jit``: ``graph.replay()``, the graph's launch), in ms
per call of the traced sub-window (metrics/span_time.py)."""
from radbench.metrics.span_time import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("capture.replay",))
