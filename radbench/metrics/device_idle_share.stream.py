"""Device: the share of the traced sub-window in which no kernel, copy or
memset runs on a card (the union of the device events), in %, averaged
over the cell's cards."""
from radbench import trace


def read(run):
    return trace.idle_percent(run.trace, run.devices)
