"""Kernels: the merged LW + SW solve's share of its roofline, in %.

The least time an H100 could take for the calls of the traced sub-window
(``count.least_seconds`` of the frozen count, per call, times the calls),
over the device time of every kernel those calls ran.  Kernels are taken
by the trace's ``kernel`` category, not by name; copies and memsets are
left out.  Today the kernel is K1, ``csrc/lwsw.cu`` over
``csrc/staged.cuh``, launched by ``ops/cuda/lwsw.py``."""
from radbench import count


def read(run):
    w = run.trace
    if w is None or not w.units or w.kernel_s() <= 0:
        return None
    return 100.0 * w.units * count.least_seconds(run.work) / w.kernel_s()
