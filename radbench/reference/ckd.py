"""Reading a ckd-definition file for the reference.

The registration rules are those of rte-ecckd's loader
(example/rfmip-rad-irf/mo_load_coefficients.F90): each token of the
global attribute ``constituent_id`` other than "composite" is a gas with a
table of its own; each token of ``composite_constituent_id`` not already
registered is a gas that reads the composite table and counts once among
the gases requested; a gas with a 1-D ``<gas>_mole_fraction`` variable is
a look-up-table gas (tri-linear in mole fraction, pressure, temperature),
and any other carries a concentration-dependence code: 0 none, 1 linear,
3 relative-linear with ``<gas>_reference_mole_fraction``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.io import netcdf_file

NONE, LINEAR, LUT, RELATIVE_LINEAR = 0, 1, 2, 3


@dataclasses.dataclass
class Gas:
    name: str
    code: int                    # NONE, LINEAR, LUT or RELATIVE_LINEAR
    table: np.ndarray            # (p, T, g), or (mf, p, T, g) for LUT
    composite_only: bool = False
    reference_mf: float = 0.0
    mf_grid: Optional[np.ndarray] = None


@dataclasses.dataclass
class Ckd:
    pressure: np.ndarray         # (np,) [Pa]
    temperature: np.ndarray      # (np, nT) [K]
    gases: Dict[str, Gas]
    ngpt: int
    planck_temperature: Optional[np.ndarray] = None   # (nP,)
    planck_function: Optional[np.ndarray] = None      # (nP, g) [W m-2]
    solar_irradiance: Optional[np.ndarray] = None     # (g,) [W m-2]
    rayleigh: Optional[np.ndarray] = None             # (g,) [m2 mol-1]

    @property
    def shortwave(self) -> bool:
        return self.solar_irradiance is not None

    def contributions(self, requested) -> List[Gas]:
        """The gases that add optical depth for the requested names: in
        request order, unknown names skipped, the composite table once."""
        out, composite = [], False
        for name in requested:
            gas = self.gases.get(name)
            if gas is None:
                continue
            if gas.composite_only:
                if composite:
                    continue
                composite = True
            out.append(gas)
        return out

    def gas_counts(self, requested) -> Tuple[int, int]:
        """(table gases, look-up-table gases) among the contributions."""
        gases = self.contributions(requested)
        n_lut = sum(g.code == LUT for g in gases)
        return len(gases) - n_lut, n_lut


def read_ckd(path: str) -> Ckd:
    """The ckd-definition file at ``path``, in float64."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        v = {k: np.array(x[...], dtype=np.float64)
             for k, x in f.variables.items()}
        attrs = {k: (x.decode() if isinstance(x, bytes) else str(x))
                 for k, x in f._attributes.items()}
    finally:
        f.close()
    tokens = attrs["constituent_id"].split()
    composite_tokens = (attrs.get("composite_constituent_id", "").split()
                        if "composite" in tokens else [])
    pt = lambda a: np.moveaxis(a, -3, -2)       # (.., T, p, g) -> (.., p, T, g)
    gases: Dict[str, Gas] = {}

    def register(name: str, source: str, composite_only: bool) -> None:
        table = pt(v[f"{source}_molar_absorption_coeff"])
        mf = v.get(f"{source}_mole_fraction")
        if mf is not None and mf.ndim == 1:
            gases[name] = Gas(name, LUT, table, composite_only, mf_grid=mf)
            return
        code = int(v[f"{source}_conc_dependence_code"])
        if code not in (NONE, LINEAR, RELATIVE_LINEAR):
            raise ValueError(f"{path}: code {code} for gas {source}")
        ref = (float(v[f"{source}_reference_mole_fraction"])
               if code == RELATIVE_LINEAR else 0.0)
        gases[name] = Gas(name, code, table, composite_only, ref)

    for tok in tokens:
        if tok != "composite":
            register(tok, tok, False)
    for tok in composite_tokens:
        if tok not in gases:
            register(tok, "composite", True)
    sw = "solar_irradiance" in v
    return Ckd(pressure=v["pressure"], temperature=v["temperature"].T,
               gases=gases, ngpt=int(v["band_number"].shape[0]),
               planck_temperature=None if sw else v["temperature_planck"],
               planck_function=None if sw else v["planck_function"],
               solar_irradiance=v["solar_irradiance"] if sw else None,
               rayleigh=(v["rayleigh_molar_scattering_coeff"] if sw
                         else None))
