"""Kernels: the merged LW + SW solve's share of its roofline at float64,
in %.

``lwsw_roofline``'s reading at the card's float64 peaks: the least time
an H100 could take for the calls of the traced sub-window, the larger of
the frozen count's operations over 34 TFLOP/s (the H100 SXM data sheet's
FP64 rate outside the tensor cores, at 700 W) and its bytes at 8 B a
value (the count's float32 bytes x 2) over 3.35 TB/s, per call, times
the calls, over the device time of every kernel those calls ran.
Kernels are taken by the trace's ``kernel`` category, not by name; copies
and memsets are left out.  Today the kernel is K1's double instantiation
(``lwsw_f64_kernel``, ``csrc/lwsw.cu``)."""
from radbench import count

PEAK_F64_FLOPS = 34e12


def read(run):
    w = run.trace
    if w is None or not w.units or w.kernel_s() <= 0:
        return None
    least = max(run.work["ops"] / PEAK_F64_FLOPS,
                2 * run.work["bytes"] / count.PEAK_HBM_BYTES)
    return 100.0 * w.units * least / w.kernel_s()
