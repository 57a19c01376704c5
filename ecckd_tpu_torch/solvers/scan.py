"""Layer-recurrence primitives for the flux solvers (counterpart of
``ecckd_tpu.solvers.scan``).

The radiative-transfer sweeps are first-order linear recurrences over the
layer axis, x[k+1] = a[k] * x[k] + b[k].  PyTorch runs eagerly, so each
sweep is a Python loop over the (short) layer axis with the column x
g-point axes vectorized; the broadband form emits only the g-point sums,
never the per-level per-g-point cube.
"""
from __future__ import annotations

from typing import Tuple

import torch


def affine_scan(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                dim: int) -> torch.Tensor:
    """All n+1 states of x[k+1] = a[k] * x[k] + b[k] with x[0] = init;
    ``a``/``b`` hold n steps along ``dim``, the result n+1 states."""
    states = [init]
    x = init
    for k in range(a.shape[dim]):
        x = a.select(dim, k) * x + b.select(dim, k)
        states.append(x)
    return torch.stack(states, dim=dim)


def affine_scan_reverse(a: torch.Tensor, b: torch.Tensor, init: torch.Tensor,
                        dim: int) -> torch.Tensor:
    """All n+1 states of x[k] = a[k] * x[k+1] + b[k] with x[n] = init."""
    flip = lambda t: torch.flip(t, dims=(dim,))
    return flip(affine_scan(flip(a), flip(b), init, dim))


def affine_sweep_broadband(a: torch.Tensor, b: torch.Tensor,
                           init: torch.Tensor, reverse: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affine layer sweep emitting only g-point-summed per-level values.

    Args:
      a, b: (ncol, nlay, ngpt) coefficients of x[k+1] = a[k] x[k] + b[k]
        (forward) or x[k] = a[k] x[k+1] + b[k] (reverse).
      init: (ncol, ngpt) boundary state (top for forward, surface for
        reverse).
    Returns:
      (levels, final): levels (ncol, nlay+1) broadband sums at every level
      in the input's layer order, final (ncol, ngpt) state at the far
      boundary.
    """
    nlay = a.shape[1]
    order = range(nlay - 1, -1, -1) if reverse else range(nlay)
    x = init
    sums = [torch.sum(init, dim=-1)]
    for k in order:
        x = a[:, k] * x + b[:, k]
        sums.append(torch.sum(x, dim=-1))
    if reverse:
        sums.reverse()
    return torch.stack(sums, dim=1), x
