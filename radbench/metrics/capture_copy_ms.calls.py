"""Capture and host prep: the program's ``capture.copy_in`` and
``capture.copy_out`` spans (``utils/capture.jit``: the inputs' copy into
the static buffers, the outputs' ``empty_like``s and copy out), in ms per
call of the traced sub-window (metrics/span_time.py)."""
from radbench.metrics.span_time import span_ms_per_unit


def read(run):
    return span_ms_per_unit(run, ("capture.copy_in", "capture.copy_out"))
