"""Host preparation for the CUDA kernels (ops/cuda/lwsw.py, lw.py, sw.py).

Takes the place of the JAX package's ``build_plan`` / ``split_vmrs_multi``
(ops/pallas/plan.py:86,203), ``models_mergeable`` (ops/pallas/lwsw.py:299),
``surface_prep`` (ops/pallas/sw.py:148-174) and the host halves of
``lw_fluxes_fused`` / ``sw_fluxes_fused`` (lw.py:307, sw.py:177).  What it
builds:

* a per-model gas plan: one slice per contributing gas (kind, first table
  row, vmr slot, affine weight a/b or the LUT mole-fraction axis), dense
  gases first in request order, then the LUT gas;
* the model's tables flattened in natural (gas, [mole fraction,] p, T, g)
  order with g fastest, so the kernel's per-warp gather at one grid corner
  is one contiguous ngpt-entry row; in the fast mode (config.is_fast) the
  same table rounded to bf16;
* the stacked vmr rows shared by the models of one solve: (ncol, n_prof,
  nlay) profiles and (ncol, n_col) well-mixed rows, each gas stored once;
* TSI scale, mu0 and the night mask; emissivity and albedo per g-point.

A solve's inputs are one ``Atmosphere`` (per-column, shared) and one
``LwInputs`` and/or ``SwInputs`` per band, each carrying its own model's
arrays and grid: ``prepare_lw`` / ``prepare_sw`` build the single-band
solves, ``prepare`` the merged one (a mergeable pair only).

The gas plan and the model arrays are cached on the model object (keyed
by request / dtype / device / table mode); the per-call arrays are rebuilt
per call.
Unlike the TPU plan there is no ``tables_nonneg`` or one-LUT-gas
precondition: the kernel clamps per gas and g-point as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ecckd_tpu_torch import constants
from ecckd_tpu_torch.config import numpy_dtype
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.ops.optical_depth import resolve_contributions

KIND_DENSE, KIND_LUT = 0, 1
VMR_NONE, VMR_PROFILE, VMR_COLUMN = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class GasSlice:
    """One contributing gas of one model."""
    kind: int            # KIND_DENSE or KIND_LUT
    row0: int            # first (p*n_t + t) row of its table in the flat table
    vmr_slot: int        # index into GasPlan.vmr_names; -1: no vmr (composite)
    a: float = 0.0       # dense weight = simple_weight * (a*vmr + b)
    b: float = 0.0
    mf_grid: Tuple[float, ...] = ()   # LUT mole-fraction axis (log-uniform)


@dataclasses.dataclass(frozen=True)
class GasPlan:
    slices: Tuple[GasSlice, ...]
    vmr_names: Tuple[str, ...]
    ngpt: int


def models_mergeable(model_lw: CKDModel, model_sw: CKDModel) -> bool:
    """The merged kernel shares one (p, T) interpolation grid: equal
    load-time grid fingerprints and grid shapes (true for the shipped
    ecckd-1.2 file pairs and the synthetic pair)."""
    return (bool(model_lw.grid_key) and bool(model_sw.grid_key)
            and model_lw.grid_key == model_sw.grid_key
            and model_lw.log_pressure.shape == model_sw.log_pressure.shape
            and model_lw.temperature_grid.shape
            == model_sw.temperature_grid.shape)


def build_plan(model: CKDModel, gas_names: Tuple[str, ...]) -> GasPlan:
    """Resolve the requested gases (order kept, unknown skipped, composite
    once) into slices of the model's flat table.  Cached per request."""
    key = ("plan", tuple(gas_names))
    if key in model._cache:
        return model._cache[key]
    contributions = resolve_contributions(model, gas_names)
    n_pt = model.log_pressure.shape[0] * model.temperature_grid.shape[1]
    lut_row0 = [model.coeff_dense.shape[0] * n_pt]
    for lut in model.coeff_lut:
        lut_row0.append(lut_row0[-1] + lut.shape[0] * n_pt)

    vmr_names = []

    def vmr_slot(name: str) -> int:
        if name not in vmr_names:
            vmr_names.append(name)
        return vmr_names.index(name)

    dense, luts = [], []
    for c in contributions:
        gi = c.gas_index
        ti = model.gas_table_idx[gi]
        if model.gas_codes[gi] == constants.CONC_LUT:
            luts.append(GasSlice(KIND_LUT, lut_row0[ti], vmr_slot(c.name),
                                 mf_grid=model.lut_mf_grids[ti]))
        else:
            a, b = model.weight_scale_offset(gi)
            dense.append(GasSlice(KIND_DENSE, ti * n_pt,
                                  vmr_slot(c.name) if a != 0.0 else -1,
                                  a=a, b=b))
    plan = GasPlan(tuple(dense + luts), tuple(vmr_names), model.ngpt)
    model._cache[key] = plan
    return plan


@dataclasses.dataclass(frozen=True)
class ModelArrays:
    """A model's arrays in one working dtype on one device.  In the fast
    mode the table is bfloat16 and the (p, T) grid and its constants are
    float32 at every working dtype (model_arrays)."""
    table: torch.Tensor                  # (rows, ngpt) flat tables
    temperature_grid: torch.Tensor       # (n_p, n_t)
    t_first: torch.Tensor                # (n_p,) its first column
    planck_temperature: Optional[torch.Tensor]
    planck_function: Optional[torch.Tensor]   # (n_planck, ngpt)
    solar: Optional[torch.Tensor]        # (ngpt,)
    rayleigh: Optional[torch.Tensor]     # (ngpt,)
    log_p0: float
    d_log_p: float
    dt: float
    planck_t0: float = 0.0
    planck_dt: float = 0.0

    @property
    def fast(self) -> bool:
        """Whether the table is the fast mode's bf16 one."""
        return self.table.dtype == torch.bfloat16


def model_arrays(model: CKDModel, dtype: torch.dtype, device,
                 fast: bool = False) -> ModelArrays:
    """Flattened tables and grid constants, cached per (dtype, device,
    mode).

    In the fast mode, whatever the working dtype, the table is the float32
    table rounded to bf16 (nearest even), and the (p, T) grid and its
    constants are float32: the fast mode's corner weights are rounded to
    bf16 from the kernels' float32 interpolation weights.  Computed in
    float64 instead, they differ from those by ~1e-6, which moves about
    one product in a thousand across a bf16 rounding boundary (a whole
    bf16 step) and the fluxes by up to ~2e-4 of their scale.  The Planck,
    solar and Rayleigh arrays stay in the working dtype."""
    device = torch.device(device)
    key = ("arrays", dtype, device, fast)
    if key in model._cache:
        return model._cache[key]
    cast = lambda x, dt=dtype: None if x is None else x.to(
        device=device, dtype=dt).contiguous()
    ng = model.ngpt
    table = torch.cat([model.coeff_dense.reshape(-1, ng)]
                      + [t.reshape(-1, ng) for t in model.coeff_lut])
    grid_dtype = torch.float32 if fast else dtype
    lp = cast(model.log_pressure, grid_dtype)
    tg = cast(model.temperature_grid, grid_dtype)
    pt = cast(model.planck_temperature)
    table = (table.to(device=device, dtype=torch.float32).to(
        torch.bfloat16).contiguous() if fast else cast(table))
    arrays = ModelArrays(
        table=table, temperature_grid=tg,
        t_first=tg[:, 0].contiguous(),
        planck_temperature=pt,
        planck_function=cast(model.planck_function),
        solar=cast(model.solar_irradiance),
        rayleigh=cast(model.rayleigh_coeff),
        log_p0=float(lp[0]), d_log_p=float(lp[1] - lp[0]),
        dt=float(tg[0, 1] - tg[0, 0]),
        planck_t0=0.0 if pt is None else float(pt[0]),
        planck_dt=0.0 if pt is None else float(pt[1] - pt[0]))
    model._cache[key] = arrays
    return arrays


def stack_vmrs(plans: Tuple[GasPlan, ...], gas_concs: GasConcs, ncol: int,
               nlay: int, dtype: torch.dtype, device):
    """Stack the vmr rows of several plans, each gas once.  Profiles
    ((ncol, nlay) values) go to (ncol, n_prof, nlay); scalars and (ncol,)
    rows stay per column in (ncol, n_col).  Returns (prof, col,
    kinds_per_plan) with kinds_per_plan[m][slot] = (VMR_PROFILE|VMR_COLUMN,
    row)."""
    prof, col, index = [], [], {}
    kinds_all = []
    for plan in plans:
        kinds = []
        for name in plan.vmr_names:
            if name not in index:
                v = gas_concs.values[gas_concs.names.index(name)].to(
                    device=device, dtype=dtype)
                if v.ndim == 2:
                    index[name] = (VMR_PROFILE, len(prof))
                    prof.append(v)
                else:
                    index[name] = (VMR_COLUMN, len(col))
                    col.append(v.reshape(-1).expand(ncol))
            kinds.append(index[name])
        kinds_all.append(tuple(kinds))
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    prof_t = (torch.stack(prof, dim=1).contiguous() if prof
              else zeros(ncol, 1, nlay))
    col_t = torch.stack(col, dim=1).contiguous() if col else zeros(ncol, 1)
    return prof_t, col_t, tuple(kinds_all)


def surface_prep(solar: torch.Tensor, sfc_alb: torch.Tensor,
                 tsi: torch.Tensor, sza_deg: torch.Tensor, ngpt: int,
                 dtype: torch.dtype):
    """SW semantics of the reference RFMIP program (ecckd_rfmip_sw.F90:
    103-145): TSI scale = the requested TSI over the model's irradiance
    sum; a column is daytime iff sza < 90 - 2*spacing(90) in working
    precision, and night columns run with mu0 = 1 and are zeroed
    afterwards; albedo (ncol,) or (ncol, ngpt) expanded to (ncol, ngpt).
    Returns (tsi_scale, usecol, mu0, alb_gpt)."""
    ncol = sza_deg.shape[0]
    tsi_scale = tsi.to(dtype) / torch.sum(solar)
    spacing90 = float(np.spacing(np.asarray(90.0, dtype=numpy_dtype(dtype))))
    sza = sza_deg.to(dtype)
    usecol = sza < (90.0 - 2.0 * spacing90)
    deg_to_rad = float(np.arccos(-1.0) / 180.0)
    mu0 = torch.where(usecol, torch.cos(sza * deg_to_rad),
                      torch.ones_like(sza))
    alb = sfc_alb.to(dtype)
    alb_gpt = alb if alb.ndim == 2 else alb[:, None].expand(ncol, ngpt)
    return tsi_scale, usecol, mu0, alb_gpt.contiguous()


@dataclasses.dataclass(frozen=True)
class Atmosphere:
    """The per-column inputs the bands of one solve share, in one dtype on
    one device; column-major outermost so a column chunk is a contiguous
    slice."""
    plev: torch.Tensor        # (ncol, nlay+1)
    tlay: torch.Tensor        # (ncol, nlay)
    vmr_prof: torch.Tensor    # (ncol, n_prof, nlay)
    vmr_col: torch.Tensor     # (ncol, n_col)


@dataclasses.dataclass(frozen=True)
class BandInputs:
    """One model's part of a solve: its gas plan, where each of its vmr
    slots sits in the Atmosphere's stacks, and its arrays (tables and its
    own (p, T) grid)."""
    plan: GasPlan
    vmr_kinds: Tuple[Tuple[int, int], ...]
    arrays: ModelArrays

    @property
    def n_p(self) -> int:
        return self.arrays.temperature_grid.shape[0]

    @property
    def n_t(self) -> int:
        return self.arrays.temperature_grid.shape[1]


@dataclasses.dataclass(frozen=True)
class LwInputs(BandInputs):
    """A LW band: the model's part plus the LW solve's per-column terms.
    The same type serves the LW-only and the merged solve."""
    tlev: torch.Tensor       # (ncol, nlay+1)
    tsfc: torch.Tensor       # (ncol,)
    emis: torch.Tensor       # (ncol, ngpt)
    n_gauss_angles: int = 1


@dataclasses.dataclass(frozen=True)
class SwInputs(BandInputs):
    """A SW band: the model's part plus the SW solve's per-column terms.
    The same type serves the SW-only and the merged solve."""
    alb: torch.Tensor        # (ncol, ngpt)
    mu0: torch.Tensor        # (ncol,)
    tsi_scale: torch.Tensor  # (ncol,)
    usecol: torch.Tensor     # (ncol,) bool: daytime columns


def _atmosphere(models, gas_concs: GasConcs, plev: torch.Tensor,
                tlay: torch.Tensor):
    """The shared Atmosphere of a solve over ``models`` (each gas's vmr
    stored once) and, per model, (plan, vmr_kinds)."""
    dtype, device = tlay.dtype, tlay.device
    ncol, nlay = tlay.shape
    plans = tuple(build_plan(m, gas_concs.names) for m in models)
    prof, col, kinds = stack_vmrs(plans, gas_concs, ncol, nlay, dtype,
                                  device)
    f = lambda x: x.to(device=device, dtype=dtype).contiguous()
    atm = Atmosphere(plev=f(plev), tlay=f(tlay), vmr_prof=prof, vmr_col=col)
    return atm, tuple(zip(plans, kinds))


def _lw_inputs(model: CKDModel, plan_kinds, tlay: torch.Tensor,
               tlev: torch.Tensor, tsfc: torch.Tensor, emis_gpt: torch.Tensor,
               n_gauss_angles: int, fast: bool) -> LwInputs:
    if not 1 <= n_gauss_angles <= 4:
        raise ValueError(f"n_gauss_angles must be in 1..4, got "
                         f"{n_gauss_angles}")
    dtype, device = tlay.dtype, tlay.device
    f = lambda x: x.to(device=device, dtype=dtype).contiguous()
    return LwInputs(*plan_kinds, model_arrays(model, dtype, device, fast),
                    tlev=f(tlev), tsfc=f(tsfc), emis=f(emis_gpt),
                    n_gauss_angles=n_gauss_angles)


def _sw_inputs(model: CKDModel, plan_kinds, tlay: torch.Tensor,
               sfc_alb: torch.Tensor, tsi: torch.Tensor,
               sza_deg: torch.Tensor, fast: bool) -> SwInputs:
    dtype, device = tlay.dtype, tlay.device
    f = lambda x: x.to(device=device, dtype=dtype).contiguous()
    arrays = model_arrays(model, dtype, device, fast)
    tsi_scale, usecol, mu0, alb = surface_prep(
        arrays.solar, f(sfc_alb), f(tsi), f(sza_deg), model.ngpt, dtype)
    return SwInputs(*plan_kinds, arrays, alb=alb, mu0=mu0.contiguous(),
                    tsi_scale=tsi_scale.contiguous(), usecol=usecol)


def prepare_lw(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
               tlev: torch.Tensor, tsfc: torch.Tensor, emis_gpt: torch.Tensor,
               gas_concs: GasConcs, n_gauss_angles: int = 1,
               fast: bool = False) -> Tuple[Atmosphere, LwInputs]:
    """The LW-only solve's inputs in tlay's dtype on tlay's device (the
    fast mode's bf16 table if ``fast``)."""
    if not model.source_is_internal():
        raise ValueError("the LW path takes a longwave ckd model")
    atm, (pk,) = _atmosphere((model,), gas_concs, plev, tlay)
    return atm, _lw_inputs(model, pk, tlay, tlev, tsfc, emis_gpt,
                           n_gauss_angles, fast)


def prepare_sw(model: CKDModel, plev: torch.Tensor, tlay: torch.Tensor,
               gas_concs: GasConcs, sfc_alb: torch.Tensor, tsi: torch.Tensor,
               sza_deg: torch.Tensor, fast: bool = False
               ) -> Tuple[Atmosphere, SwInputs]:
    """The SW-only solve's inputs in tlay's dtype on tlay's device (the
    fast mode's bf16 table if ``fast``)."""
    if not model.source_is_external():
        raise ValueError("the SW path takes a shortwave ckd model")
    atm, (pk,) = _atmosphere((model,), gas_concs, plev, tlay)
    return atm, _sw_inputs(model, pk, tlay, sfc_alb, tsi, sza_deg, fast)


def prepare(model_lw: CKDModel, model_sw: CKDModel, plev: torch.Tensor,
            tlay: torch.Tensor, tlev: torch.Tensor, tsfc: torch.Tensor,
            emis_gpt: torch.Tensor, gas_concs: GasConcs,
            sfc_alb: torch.Tensor, tsi: torch.Tensor, sza_deg: torch.Tensor,
            n_gauss_angles: int = 1, fast: bool = False
            ) -> Tuple[Atmosphere, LwInputs, SwInputs]:
    """The merged solve's inputs in tlay's dtype on tlay's device: one
    Atmosphere (both plans' vmrs, each gas once) and both bands, in one
    table mode."""
    if not model_lw.source_is_internal() or not model_sw.source_is_external():
        raise ValueError("the merged path takes a longwave and a shortwave "
                         "ckd model, in that order")
    if not models_mergeable(model_lw, model_sw):
        raise ValueError("models do not share a (p, T) grid; the merged "
                         "path does not apply")
    atm, (pk_lw, pk_sw) = _atmosphere((model_lw, model_sw), gas_concs, plev,
                                      tlay)
    return (atm, _lw_inputs(model_lw, pk_lw, tlay, tlev, tsfc, emis_gpt,
                            n_gauss_angles, fast),
            _sw_inputs(model_sw, pk_sw, tlay, sfc_alb, tsi, sza_deg, fast))
