"""Kernels: the merged LW + SW solve's share of its roofline with RTE's LW
surface-temperature Jacobian, in %.

``lwsw_roofline``'s reading with the Jacobian's work added to the frozen
count (``count.lwsw_work``), at ``count.py``'s rates (``count.py`` itself
is not changed): per (column, LW g-point) the surface's Planck difference
and its emissivity product, 12 + 2; per (column, level, LW g-point, Gauss
angle) the recurrence's multiply and its g-sum's add, 1 + 1; and the
bytes of one more (ncol, nlay + 1) float32 output.  The least time an
H100 could take for the calls of the traced sub-window over the device
time of every kernel they ran, kernels taken by the trace's ``kernel``
category.  Today the kernel is K1's Jacobian instantiation
(``lwsw_jac_kernel``, ``csrc/lwsw.cu``)."""
from radbench import count

JAC_SURFACE = 12 + 2
JAC_LEVEL = 1 + 1


def jac_work(run) -> dict:
    """The work of one unit with the Jacobian's added."""
    ncol, nlev = run.unit_columns, run.config["nlay"] + 1
    ngpt, n_ang = run.lw.ngpt, run.config["n_gauss_angles"]
    ops = ncol * ngpt * (JAC_SURFACE + nlev * n_ang * JAC_LEVEL)
    return {"ops": run.work["ops"] + ops,
            "bytes": run.work["bytes"] + ncol * nlev * count.F32}


def read(run):
    w = run.trace
    if w is None or not w.units or w.kernel_s() <= 0:
        return None
    return 100.0 * w.units * count.least_seconds(jac_work(run)) / w.kernel_s()
