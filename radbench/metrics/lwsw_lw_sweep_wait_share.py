"""Kernels: the share of K1's LW sweep warps' cycles spent waiting at FULL
for a staged slot and at LW_DONE for their set's other angles, in %.
From one eager call of the timed build at the cell's launch chunk, after
the window (metrics/role_shares.py)."""
from radbench.metrics.role_shares import share


def read(run):
    return share(run, "lw_sweep")
