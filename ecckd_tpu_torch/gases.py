"""Named gas volume-mixing-ratio store.

Counterpart of ``ecckd_tpu.gases.GasConcs`` (rte-rrtmgp's
``ty_gas_concs``).  Values may be scalars, (ncol,) rows or (ncol, nlay)
profiles; ``get_vmr`` broadcasts to (ncol, nlay) like the reference's
scalar broadcast.  Insertion order is preserved: the requested-gas order
decides which composite-only gas counts (ops/optical_depth.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def _as_tensor(value, device=None) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value if device is None else value.to(device)
    return torch.as_tensor(value, device=device)


@dataclasses.dataclass(frozen=True)
class GasConcs:
    values: Tuple[torch.Tensor, ...]
    names: Tuple[str, ...]

    @classmethod
    def create(cls, concs: Mapping[str, Scalar] | Iterable[Tuple[str, Scalar]],
               device=None) -> "GasConcs":
        items = concs.items() if isinstance(concs, Mapping) else list(concs)
        names, values = [], []
        for name, value in items:
            names.append(name.strip().lower())
            values.append(_as_tensor(value, device))
        return cls(values=tuple(values), names=tuple(names))

    def set_vmr(self, name: str, value: Scalar) -> "GasConcs":
        """Functional update; replaces an existing entry or appends."""
        name = name.strip().lower()
        value = _as_tensor(value)
        if name in self.names:
            vals = list(self.values)
            vals[self.names.index(name)] = value
            return GasConcs(values=tuple(vals), names=self.names)
        return GasConcs(values=self.values + (value,),
                        names=self.names + (name,))

    def get_num_gases(self) -> int:
        return len(self.names)

    def get_gas_names(self) -> Tuple[str, ...]:
        return self.names

    def __contains__(self, name: str) -> bool:
        return name.strip().lower() in self.names

    def get_vmr(self, name: str, ncol: int, nlay: int) -> torch.Tensor:
        """VMR broadcast to (ncol, nlay), mirroring ty_gas_concs%get_vmr:
        a scalar fills everything, an (ncol,) row is constant in height."""
        v = self.values[self.names.index(name.strip().lower())]
        if v.ndim == 1:
            v = v[:, None]
        return v.expand(ncol, nlay)
