"""Kernels: the share of K1's optics warps' cycles spent waiting at FREE
for a slot's sweeps, in % (high: the sweeps set the pace).  From one
eager call of the timed build at the cell's launch chunk, after the
window (metrics/role_shares.py)."""
from radbench.metrics.role_shares import share


def read(run):
    return share(run, "optics")
