"""The whole call's share of the card's float32 peak, in %: the float
operations of the traced sub-window's calls (the frozen count) over
67 TFLOP/s times the sub-window's length.  It bounds every kernel's
roofline share from below, whichever kernels run."""
from radbench import count


def read(run):
    w = run.trace
    if w is None or not w.units or not w.device_events:
        return None
    return (100.0 * w.units * run.work["ops"] / count.PEAK_F32_FLOPS
            / w.seconds)
