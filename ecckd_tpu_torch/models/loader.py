"""ckd-definition netCDF file loader.

Counterpart of ``ecckd_tpu.models.loader`` with the same schema and the
same gas-registration semantics (rte-ecckd
example/rfmip-rad-irf/mo_load_coefficients.F90:19-203):

* every non-"composite" token of the global attribute ``constituent_id``
  becomes a gas with its own absorption table;
* every token of ``composite_constituent_id`` not already registered
  becomes a gas pointing at the composite table with
  ``composite_only=True``;
* a gas with a 1-D ``<gas>_mole_fraction`` variable is a look-up-table gas
  (code 2) with a 4-D table; otherwise the scalar
  ``<gas>_conc_dependence_code`` selects none/linear/relative-linear with a
  3-D table.

``tables_nonneg`` and ``grid_key`` are computed exactly as the JAX loader
computes them (the same content hash of the same dtype-cast grid arrays),
so ``grid_key`` equality means the same thing in both packages.  Files are
netCDF3-classic, read through io/rfmip.py's ``_NcFile``: the native engine
where it can be built, scipy otherwise, with the same values bit for bit
either way.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ecckd_tpu_torch import constants
from ecckd_tpu_torch.config import default_precision, numpy_dtype
from ecckd_tpu_torch.io.rfmip import _NcFile
from ecckd_tpu_torch.models.ckd import CKDModel

COMPOSITE = "composite"


def _content_hash(a: np.ndarray) -> int:
    """Deterministic cross-process 64-bit content hash of an array."""
    h = hashlib.blake2b(np.ascontiguousarray(a).tobytes(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def load_ckd_model(path: str, dtype: Optional[torch.dtype] = None,
                   device=None) -> CKDModel:
    """Load a ckd-definition file into a CKDModel.

    Args:
      path: ckd-definition netCDF file (netCDF3 classic).
      dtype: working dtype of the tables (default: precision policy, f32;
        f64 after config.enable_f64_validation_mode).
      device: where the tables live (default: CPU).
    """
    if dtype is None:
        dtype = default_precision().dtype
    f = _NcFile(path)
    try:
        fields = _read_fields(f, numpy_dtype(dtype))
    finally:
        f.close()
    return CKDModel.from_numpy(fields, device=device)


def _read_fields(f: _NcFile, np_dtype) -> Dict[str, object]:
    pressure = f.read("pressure")                     # (np,) [Pa]
    log_pressure = np.log(pressure)
    # File stores (temperature, pressure); the model indexes (p, T).
    temperature_grid = f.read("temperature").T        # (np, nT)

    wn1 = f.read("wavenumber1_band")
    wn2 = f.read("wavenumber2_band")
    band_number = f.read("band_number").astype(np.int64)  # 0-based per gpt
    band2gpt: List[Tuple[int, int]] = []
    for b in range(wn1.shape[0]):
        gpts = np.nonzero(band_number == b)[0]
        band2gpt.append((int(gpts[0]), int(gpts[-1])))
    band_limits = tuple((float(a), float(b)) for a, b in zip(wn1, wn2))
    gpoint_fraction = f.read("gpoint_fraction")       # (ngpt, n_wavenumber)

    shortwave = f.has("solar_irradiance")
    solar_irradiance = rayleigh_coeff = None
    planck_temperature = planck_function = None
    total_solar_irradiance = 0.0
    if shortwave:
        solar_irradiance = f.read("solar_irradiance")
        total_solar_irradiance = float(solar_irradiance.sum())
        rayleigh_coeff = f.read("rayleigh_molar_scattering_coeff")
    else:
        planck_temperature = f.read("temperature_planck")
        planck_function = f.read("planck_function")   # (n_planck_T, ngpt)

    # --- gas registration (mo_load_coefficients.F90:103-144) ---------------
    tokens = f.attr_tokens("constituent_id")
    composite_tokens = (f.attr_tokens("composite_constituent_id")
                        if COMPOSITE in tokens else [])

    gas_names: List[str] = []
    gas_codes: List[int] = []
    gas_table_idx: List[int] = []
    gas_composite_only: List[bool] = []
    gas_reference_mf: List[float] = []
    dense_tables: List[np.ndarray] = []
    lut_tables: List[np.ndarray] = []
    lut_mf_grids: List[Tuple[float, ...]] = []
    dense_row_of: Dict[str, int] = {}

    def read_gas(name: str, file_gas: str, composite_only: bool) -> None:
        mf_var = f"{file_gas}_mole_fraction"
        if f.has(mf_var) and f.ndims(mf_var) == 1:
            mf = f.read(mf_var)
            coeff = f.read(f"{file_gas}_molar_absorption_coeff")
            # file (mf, T, p, gpt) -> (mf, p, T, gpt)
            lut_tables.append(np.ascontiguousarray(coeff.transpose(0, 2, 1, 3)))
            gas_names.append(name)
            gas_codes.append(constants.CONC_LUT)
            gas_table_idx.append(len(lut_tables) - 1)
            gas_composite_only.append(composite_only)
            gas_reference_mf.append(0.0)
            lut_mf_grids.append(tuple(float(x) for x in mf))
            return
        code = int(f.read(f"{file_gas}_conc_dependence_code"))
        if code not in (constants.CONC_NONE, constants.CONC_LINEAR,
                        constants.CONC_RELATIVE_LINEAR):
            raise ValueError(
                f"bad concentration dependence code {code} for gas {file_gas}")
        ref_mf = 0.0
        if code == constants.CONC_RELATIVE_LINEAR:
            ref_mf = float(f.read(f"{file_gas}_reference_mole_fraction"))
        if file_gas not in dense_row_of:
            coeff = f.read(f"{file_gas}_molar_absorption_coeff")
            if coeff.ndim != 3:
                raise ValueError(
                    f"absorption coefficient for {file_gas} is not 3-D")
            # file (T, p, gpt) -> (p, T, gpt)
            dense_tables.append(np.ascontiguousarray(coeff.transpose(1, 0, 2)))
            dense_row_of[file_gas] = len(dense_tables) - 1
        gas_names.append(name)
        gas_codes.append(code)
        gas_table_idx.append(dense_row_of[file_gas])
        gas_composite_only.append(composite_only)
        gas_reference_mf.append(ref_mf)

    for tok in tokens:
        if tok != COMPOSITE:
            read_gas(tok, tok, composite_only=False)
    for tok in composite_tokens:
        if tok not in gas_names:
            read_gas(tok, COMPOSITE, composite_only=True)

    arr = lambda x: np.asarray(x, dtype=np_dtype)
    opt = lambda x: None if x is None else arr(x)
    return dict(
        log_pressure=arr(log_pressure),
        temperature_grid=arr(temperature_grid),
        coeff_dense=arr(np.stack(dense_tables, axis=0)),
        coeff_lut=tuple(arr(t) for t in lut_tables),
        gpoint_fraction=arr(gpoint_fraction),
        planck_temperature=opt(planck_temperature),
        planck_function=opt(planck_function),
        solar_irradiance=opt(solar_irradiance),
        rayleigh_coeff=opt(rayleigh_coeff),
        gas_names=tuple(gas_names),
        gas_codes=tuple(gas_codes),
        gas_table_idx=tuple(gas_table_idx),
        gas_composite_only=tuple(gas_composite_only),
        gas_reference_mf=tuple(gas_reference_mf),
        lut_mf_grids=tuple(lut_mf_grids),
        shortwave=shortwave,
        total_solar_irradiance=total_solar_irradiance,
        band_limits=band_limits,
        band2gpt=tuple(band2gpt),
        gpt2band=tuple(int(b) for b in band_number),
        num_composite_gases=len(composite_tokens),
        press_min=float(np.exp(log_pressure[0])),
        press_max=float(np.exp(log_pressure[-1])),
        temp_min=float(temperature_grid.min()),
        temp_max=float(temperature_grid.max()),
        tables_nonneg=bool(min([t.min() for t in dense_tables]
                               + [t.min() for t in lut_tables]) >= 0.0),
        grid_key=(_content_hash(arr(log_pressure)),
                  _content_hash(arr(temperature_grid))),
    )
