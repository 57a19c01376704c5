"""CKD gas-optics model container.

Counterpart of ``ecckd_tpu.models.ckd.CKDModel`` (the reference's
``ty_gas_optics_ecckd``): the lookup tables are tensors, and everything
that decides program structure (gas names, concentration-dependence
codes, band maps, the grid fingerprint) is plain Python metadata with the
same names and meanings as in the JAX package, so the two packages agree
field by field (``ckd_from_jax`` converts one into the other).

Table axis conventions (C-order):
  dense coefficients   (table, pressure, temperature, gpoint)
  LUT coefficients     (mole_fraction, pressure, temperature, gpoint)
  temperature grid     (pressure, temperature)
  planck function      (planck_temperature, gpoint)

Host preparation for the CUDA kernel (flattened tables, resolved gas
slices) is cached on the instance (``_cache``), keyed by device and
request, so it is built once per model and not per call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ecckd_tpu_torch import constants

ARRAY_FIELDS = ("log_pressure", "temperature_grid", "coeff_dense",
                "gpoint_fraction", "planck_temperature", "planck_function",
                "solar_irradiance", "rayleigh_coeff")
"""Tensor fields (besides the ``coeff_lut`` tuple)."""

META_FIELDS = ("gas_names", "gas_codes", "gas_table_idx",
               "gas_composite_only", "gas_reference_mf", "lut_mf_grids",
               "shortwave", "total_solar_irradiance", "band_limits",
               "band2gpt", "gpt2band", "num_composite_gases", "press_min",
               "press_max", "temp_min", "temp_max", "tables_nonneg",
               "grid_key")
"""Static metadata fields, identical in meaning to the JAX model's."""


@dataclasses.dataclass(frozen=True)
class CKDModel:
    # --- tensors ------------------------------------------------------------
    log_pressure: torch.Tensor
    """ln(pressure grid [Pa]); uniform spacing (np,)."""
    temperature_grid: torch.Tensor
    """Temperature grid [K], (np, nT); its origin varies with pressure."""
    coeff_dense: torch.Tensor
    """Stacked bi-linear absorption tables [m2 mol-1],
    (n_dense_tables, np, nT, ngpt)."""
    coeff_lut: Tuple[torch.Tensor, ...]
    """Per-LUT-gas tri-linear tables, each (n_mf, np, nT, ngpt) (h2o)."""
    gpoint_fraction: torch.Tensor
    """(ngpt, n_wavenumber); only its first extent is used at run time."""
    planck_temperature: Optional[torch.Tensor]
    """LW only: Planck temperature axis [K], (n_planck_T,)."""
    planck_function: Optional[torch.Tensor]
    """LW only: Planck flux into a horizontal plane [W m-2],
    (n_planck_T, ngpt)."""
    solar_irradiance: Optional[torch.Tensor]
    """SW only: per-g-point solar irradiance [W m-2], (ngpt,)."""
    rayleigh_coeff: Optional[torch.Tensor]
    """SW only: Rayleigh molar scattering coefficient [m2 mol-1], (ngpt,)."""

    # --- static metadata ----------------------------------------------------
    gas_names: Tuple[str, ...]
    gas_codes: Tuple[int, ...]
    gas_table_idx: Tuple[int, ...]
    """Per gas: row into coeff_dense, or index into coeff_lut (LUT gases)."""
    gas_composite_only: Tuple[bool, ...]
    gas_reference_mf: Tuple[float, ...]
    """Reference mole fraction (relative-linear gases; else 0.0)."""
    lut_mf_grids: Tuple[Tuple[float, ...], ...]
    """Per-LUT-gas mole-fraction axis (log-uniform)."""
    shortwave: bool
    total_solar_irradiance: float
    band_limits: Tuple[Tuple[float, float], ...]
    band2gpt: Tuple[Tuple[int, int], ...]
    """Per-band inclusive 0-based (first_gpt, last_gpt)."""
    gpt2band: Tuple[int, ...]
    num_composite_gases: int
    press_min: float
    press_max: float
    temp_min: float
    temp_max: float
    tables_nonneg: bool = True
    """True if every coefficient table entry is >= 0 (checked at load).
    Informational in the port: the CUDA kernel clamps per gas and per
    g-point, as the reference does, so it does not need it."""
    grid_key: Tuple[int, ...] = ()
    """Content hash of the (pressure, temperature) grid, set at load time
    exactly as the JAX loader sets it; equal keys mean the two models
    share interpolation indices (the merged LW+SW path)."""

    _cache: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    # --- accessors (ty_gas_optics_ecckd parity) ------------------------------
    @property
    def ngpt(self) -> int:
        return int(self.gpoint_fraction.shape[0])

    @property
    def nband(self) -> int:
        return len(self.band_limits)

    @property
    def device(self) -> torch.device:
        return self.log_pressure.device

    @property
    def dtype(self) -> torch.dtype:
        return self.coeff_dense.dtype

    def get_nband(self) -> int:
        return self.nband

    def get_ngpt(self) -> int:
        return self.ngpt

    def get_ngas(self) -> int:
        return len(self.gas_names)

    def get_gases(self) -> Tuple[str, ...]:
        return self.gas_names

    def source_is_internal(self) -> bool:
        """True if loaded from a longwave (Planck-source) file."""
        return self.planck_temperature is not None

    def source_is_external(self) -> bool:
        """True if loaded from a shortwave (solar-source) file."""
        return self.solar_irradiance is not None

    def get_press_min(self) -> float:
        return self.press_min

    def get_press_max(self) -> float:
        return self.press_max

    def get_temp_min(self) -> float:
        return self.temp_min

    def get_temp_max(self) -> float:
        return self.temp_max

    def gpt_weights_per_band(self, per_band: torch.Tensor) -> torch.Tensor:
        """Expand a per-band array (..., nband) to per-g-point (..., ngpt).
        The index is made once per device and cached, so a later call
        copies nothing from the host (utils/capture.py captures it)."""
        key = ("gpt2band", per_band.device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                self.gpt2band, dtype=torch.long, device=per_band.device)
        return torch.index_select(per_band, -1, self._cache[key])

    def weight_scale_offset(self, gas_index: int) -> Tuple[float, float]:
        """(a, b) such that the mass-path weight of gas ``g`` is
        ``simple_weight * (a * vmr + b)``: none -> (0, 1), linear -> (1, 0),
        relative-linear -> (1, -reference_mole_fraction)."""
        code = self.gas_codes[gas_index]
        if code == constants.CONC_NONE:
            return 0.0, 1.0
        if code == constants.CONC_LINEAR:
            return 1.0, 0.0
        if code == constants.CONC_RELATIVE_LINEAR:
            return 1.0, -self.gas_reference_mf[gas_index]
        raise ValueError(f"gas {gas_index} is a LUT gas; no affine weight")

    # --- conversions ---------------------------------------------------------
    def _map(self, fn) -> "CKDModel":
        opt = lambda x: None if x is None else fn(x)
        return dataclasses.replace(
            self, coeff_lut=tuple(fn(x) for x in self.coeff_lut),
            **{name: opt(getattr(self, name)) for name in ARRAY_FIELDS})

    def astype(self, dtype: torch.dtype) -> "CKDModel":
        """Cast all floating-point tables to ``dtype``."""
        return self._map(lambda x: x.to(dtype=dtype))

    def to(self, device) -> "CKDModel":
        """Move all tables to ``device``."""
        return self._map(lambda x: x.to(device=device))

    @classmethod
    def from_numpy(cls, fields: Mapping[str, Any], device=None,
                   dtype: Optional[torch.dtype] = None) -> "CKDModel":
        """Build from a mapping of field name -> numpy array / metadata
        (the loader's output, or a converted JAX model)."""
        def tensor(x):
            if x is None:
                return None
            t = torch.from_numpy(np.array(x, copy=True))
            return t.to(device=device, dtype=dtype)
        kwargs = {name: tensor(fields[name]) for name in ARRAY_FIELDS}
        kwargs["coeff_lut"] = tuple(tensor(x) for x in fields["coeff_lut"])
        for name in META_FIELDS:
            kwargs[name] = fields[name]
        return cls(**kwargs)


def ckd_from_jax(model, device=None,
                 dtype: Optional[torch.dtype] = None) -> CKDModel:
    """Convert a JAX ``CKDModel`` (or any object with its fields) into the
    port's model: ``np.asarray`` on each array field, metadata copied as
    is.  Imports nothing of JAX, so both packages can run one model
    instance in the tests."""
    fields = {name: (None if getattr(model, name) is None
                     else np.asarray(getattr(model, name)))
              for name in ARRAY_FIELDS}
    fields["coeff_lut"] = tuple(np.asarray(x) for x in model.coeff_lut)
    for name in META_FIELDS:
        fields[name] = getattr(model, name)
    return CKDModel.from_numpy(fields, device=device, dtype=dtype)
