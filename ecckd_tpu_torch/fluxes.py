"""Broadband flux container and the heating-rate diagnostic
(counterparts of ``ecckd_tpu.fluxes``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ecckd_tpu_torch import constants


@dataclasses.dataclass(frozen=True)
class FluxesBroadband:
    flux_up: torch.Tensor  # (ncol, nlev) [W m-2]
    flux_dn: torch.Tensor  # (ncol, nlev) [W m-2]
    # LW only, where asked for (pipeline ``flux_up_jac``): RTE's
    # flux_up_Jac, d flux_up / d T_sfc at every level [W m-2 K-1], as the
    # change of flux_up over a 1 K warmer surface, everything else fixed.
    flux_up_jac: Optional[torch.Tensor] = None  # (ncol, nlev)

    @property
    def flux_net(self) -> torch.Tensor:
        """Net downward flux."""
        return self.flux_dn - self.flux_up


def heating_rate(flux_up: torch.Tensor, flux_dn: torch.Tensor,
                 plev: torch.Tensor) -> torch.Tensor:
    """Layer heating rate [K/day] from broadband level fluxes:
    dT/dt = -(g / cp) * dF_net / dp, written as a signed difference
    quotient so it is independent of the level orientation."""
    fnet = flux_dn - flux_up
    dfnet = fnet[:, 1:] - fnet[:, :-1]
    dp = plev[:, 1:] - plev[:, :-1]
    k_per_s = -(constants.GRAVITY / constants.CP_DRY_AIR) * dfnet / dp
    return k_per_s * constants.SECONDS_PER_DAY
