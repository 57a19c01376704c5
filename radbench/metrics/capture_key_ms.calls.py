"""Capture and host prep: the program's ``capture.key`` spans
(``utils/capture.jit``: ``_tensors``, ``_card``, ``key`` and the entry's
lookup), in ms per call of the traced sub-window (metrics/span_time.py)."""
from radbench.metrics.span_time import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("capture.key",))
