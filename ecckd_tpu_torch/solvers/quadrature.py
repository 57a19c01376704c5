"""First-order Gaussian quadrature over zenith angle for the longwave solver.

Secants (diffusivity factors) and weights of the standard quadrature used by
the external ``rte_lw`` solver the reference links against
(call site: rte-ecckd example/rfmip-rad-irf/ecckd_rfmip_lw.F90:130-135,
``n_gauss_angles`` = 1 or 3 selected by the ``-p`` physics flag).  The
one-angle set is the classic 1.66 diffusivity approximation; weights sum to
1/2 so that an isotropic intensity B integrates to a flux of pi*B under
flux = 2*pi * sum_i w_i * I_i.
"""
from __future__ import annotations

from typing import Tuple

GAUSS_SECANTS: Tuple[Tuple[float, ...], ...] = (
    (1.66,),
    (1.18350343, 2.81649655),
    (1.09719858, 1.69338507, 4.70941630),
    (1.06056257, 1.38282560, 2.40148179, 7.15513024),
)

GAUSS_WEIGHTS: Tuple[Tuple[float, ...], ...] = (
    (0.5,),
    (0.3180413817, 0.1819586183),
    (0.2009319137, 0.2292411064, 0.0698269799),
    (0.1355069134, 0.2034645680, 0.1298475476, 0.0311809710),
)


def gauss_angles(n: int) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """(secants, weights) for an n-angle quadrature, n in 1..4."""
    if not 1 <= n <= 4:
        raise ValueError(f"n_gauss_angles must be in 1..4, got {n}")
    return GAUSS_SECANTS[n - 1], GAUSS_WEIGHTS[n - 1]
