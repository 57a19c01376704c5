"""Kernels: the share of K1's SW sweep warps' cycles spent waiting at FULL
for a staged slot, in % (high: the optics set the pace).  From one eager
call of the timed build at the cell's launch chunk, after the window
(metrics/role_shares.py)."""
from radbench.metrics.role_shares import share


def read(run):
    return share(run, "sw_sweep")
