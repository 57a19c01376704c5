"""RFMIP RAD-IRF input/output (counterpart of ``ecckd_tpu.io.rfmip``).

The reference RFMIP I/O module (example/rfmip-rad-irf/mo_rfmip_io.F90):

* reads the CMIP6 RFMIP atmosphere file (``site`` x ``layer``/``level`` x
  ``expt``), including the quirk that each gas variable's ``units``
  attribute is parsed *as a number* and multiplied into the stored values
  (``read_scaling``, mo_rfmip_io.F90:266-282);
* flattens (expt, site) into one column axis in the reference's blocking
  order (site fastest, mo_rfmip_io.F90:209-210);
* writes CMIP-format flux files (``rlu``/``rld``/``rsu``/``rsd``, dims
  (expt, site, level)) into an existing template, as ``unblock_and_write``
  does (mo_rfmip_io.F90:288-317), or into a fresh file;
* writes a synthetic RFMIP-format file, so the drivers run and are tested
  without the original data.

Arrays are numpy; files are netCDF3.  They are read through ``_NcFile``
and written, as in the JAX package, through the native C++ engine
(io/nc3_native.py, built at first use) where it can be built, and through
``scipy.io.netcdf_file`` where it cannot (no C++ compiler).  Both give the
same arrays bit for bit (``_NcFile``); ``io_engine`` names the one in use.
The synthetic file is written with scipy, as the JAX package writes it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np
from scipy.io import netcdf_file

from ecckd_tpu_torch.io import nc3_native

# RFMIP long-name mapping for the fixed 6-gas request list
# (utils.f90:41-70); forcing index 2 swaps cfc11 -> cfc11eq.
KDIST_GAS_NAMES = ("co2", "ch4", "n2o", "o2", "cfc11", "cfc12")


def rfmip_gas_names(forcing_index: int) -> Tuple[Tuple[str, ...],
                                                 Tuple[str, ...]]:
    """(names_in_kdist, names_in_rfmip) for a forcing index (1 or 2)."""
    if forcing_index == 1:
        rfmip = ("carbon_dioxide", "methane", "nitrous_oxide", "oxygen",
                 "cfc11", "cfc12")
    elif forcing_index == 2:
        rfmip = ("carbon_dioxide", "methane", "nitrous_oxide", "oxygen",
                 "cfc11eq", "cfc12")
    else:
        raise ValueError("forcing index must equal 1 or 2")
    return KDIST_GAS_NAMES, rfmip


@dataclasses.dataclass
class RFMIPData:
    """All RFMIP fields flattened to one column axis of length
    nsite * nexp (site fastest, the reference's block order)."""
    nsite: int
    nlay: int
    nexp: int
    play: np.ndarray  # (ncol, nlay) [Pa]
    plev: np.ndarray  # (ncol, nlay+1) [Pa]
    tlay: np.ndarray  # (ncol, nlay) [K]
    tlev: np.ndarray  # (ncol, nlay+1) [K]
    sfc_emis: np.ndarray  # (ncol,)
    sfc_t: np.ndarray  # (ncol,)
    sfc_alb: np.ndarray  # (ncol,)
    tsi: np.ndarray  # (ncol,) [W m-2]
    sza: np.ndarray  # (ncol,) [deg]
    gases_3d: Dict[str, np.ndarray]  # h2o/o3 (ncol, nlay) [mol mol-1]
    gases_scalar: Dict[str, np.ndarray]  # kdist name -> (ncol,) [mol mol-1]

    @property
    def ncol(self) -> int:
        return self.nsite * self.nexp

    @property
    def top_at_1(self) -> bool:
        return bool(self.play[0, 0] < self.play[0, -1])


def _read(var) -> np.ndarray:
    """A variable in its file dtype, native byte order."""
    data = np.asarray(var.data)
    return data.astype(data.dtype.newbyteorder("="), copy=True)


def io_engine() -> str:
    """The netCDF engine this process reads and writes with: "native"
    (io/nc3_native.py) or "scipy" (no C++ compiler to build it)."""
    return "native" if nc3_native.load_library() is not None else "scipy"


def _text(raw) -> str:
    return raw.decode() if isinstance(raw, bytes) else raw


class _NcFile:
    """Reader facade over the native engine (where it can be built) or
    scipy.io.netcdf (counterpart of the JAX package's ``_NcFile``).

    Reads return each variable in its FILE dtype whichever engine parsed
    it (the native engine decodes to float64 and ``read_exact`` converts
    back losslessly), so every computation on them (units scaling, np.log,
    content hashes) gives the same bits with either engine.  The ckd
    loader (models/loader.py) reads through it too."""

    def __init__(self, path: str):
        self._native = self._scipy = None
        if nc3_native.load_library() is not None:
            self._native = nc3_native.NativeReader(path)
        else:
            self._scipy = netcdf_file(path, mmap=False)

    def close(self) -> None:
        (self._native or self._scipy).close()

    def dim(self, name: str) -> int:
        if self._native:
            return self._native.dimensions[name]
        return self._scipy.dimensions[name]

    def has(self, name: str) -> bool:
        if self._native:
            return self._native.has_var(name)
        return name in self._scipy.variables

    def ndims(self, name: str) -> int:
        if self._native:
            return self._native.var_ndims(name)
        return len(self._scipy.variables[name].dimensions)

    def read(self, name: str) -> np.ndarray:
        if self._native:
            return self._native.read_exact(name)
        return _read(self._scipy.variables[name])

    def attr_tokens(self, name: str) -> List[str]:
        """Whitespace tokens of a global text attribute."""
        if self._native:
            raw = self._native.att_text(None, name)
            if raw is None:
                raise AttributeError(name)
            return raw.split()
        return _text(getattr(self._scipy, name)).split()

    def read_scaled(self, name: str) -> np.ndarray:
        """Gas variable with its numeric ``units`` attribute multiplied in
        (mo_rfmip_io.F90:266-282)."""
        if self._native:
            units = self._native.att_text(name, "units")
        else:
            units = _text(self._scipy.variables[name].units)
        return self.read(name) * float(units)


def _spread_expt(site_field: np.ndarray, nexp: int) -> np.ndarray:
    """Tile an experiment-invariant per-site field over experiments and
    flatten (expt, site) -> columns, site fastest."""
    return np.tile(site_field, (nexp,) + (1,) * (site_field.ndim - 1)
                   ).reshape((-1,) + site_field.shape[1:]) \
        if site_field.ndim > 1 else np.tile(site_field, nexp)


def read_rfmip(path: str, forcing_index: int = 1) -> RFMIPData:
    """Load an RFMIP atmosphere file (schema: SURVEY.md section 2.7)."""
    f = _NcFile(path)
    try:
        nsite, nlay, nlev, nexp = (f.dim(n) for n in ("site", "layer",
                                                      "level", "expt"))
        if nlev != nlay + 1:
            raise ValueError("number of levels should be nlay+1")
        read = f.read

        # Pressures are experiment-invariant; temperatures are not.
        play = np.tile(read("pres_layer"), (nexp, 1))        # (site, layer)
        plev = np.tile(read("pres_level"), (nexp, 1))        # (site, level)
        tlay = read("temp_layer").reshape(nexp * nsite, nlay)
        tlev = read("temp_level").reshape(nexp * nsite, nlev)

        sfc_emis = _spread_expt(read("surface_emissivity"), nexp)
        sfc_t = read("surface_temperature").reshape(-1)
        sfc_alb = _spread_expt(read("surface_albedo"), nexp)
        tsi = _spread_expt(read("total_solar_irradiance"), nexp)
        sza = _spread_expt(read("solar_zenith_angle"), nexp)

        gases_3d = {
            "h2o": f.read_scaled("water_vapor").reshape(nexp * nsite, nlay),
            "o3": f.read_scaled("ozone").reshape(nexp * nsite, nlay),
        }
        _, rfmip_names = rfmip_gas_names(forcing_index)
        gases_scalar = {}
        for kname, fname in zip(KDIST_GAS_NAMES, rfmip_names):
            per_exp = f.read_scaled(f"{fname}_GM")  # (expt,)
            gases_scalar[kname] = np.repeat(per_exp, nsite)
        # no2 is known to some k-distributions but absent from RFMIP;
        # hard-set to zero (mo_rfmip_io.F90:256-260).
        gases_scalar["no2"] = np.zeros(nexp * nsite)

        return RFMIPData(
            nsite=nsite, nlay=nlay, nexp=nexp, play=play, plev=plev,
            tlay=tlay, tlev=tlev, sfc_emis=sfc_emis, sfc_t=sfc_t,
            sfc_alb=sfc_alb, tsi=tsi, sza=sza, gases_3d=gases_3d,
            gases_scalar=gases_scalar)
    finally:
        f.close()


def _write_new(path: str, varname: str, data: np.ndarray, third_dim: str,
               units: str) -> None:
    """A fresh file holding ``data`` (expt, site, third_dim) as float64."""
    dims = ("expt", "site", third_dim)
    if nc3_native.load_library() is not None:
        w = nc3_native.NativeWriter(path)
        for name, size in zip(dims, data.shape):
            w.def_dim(name, size)
        w.def_var(varname, "d", dims)
        w.put_att(varname, "units", units)
        w.put_var(varname, data)
        w.finish()
        return
    f = netcdf_file(path, "w")
    try:
        for name, size in zip(("expt", "site", third_dim), data.shape):
            f.createDimension(name, size)
        var = f.createVariable(varname, "f8", dims)
        var[:] = data
        var.units = units
    finally:
        f.close()


def write_fluxes(path: str, varname: str, fluxes: np.ndarray, nsite: int,
                 nexp: int) -> None:
    """Write broadband fluxes (ncol, nlev) to a CMIP-format file.

    If ``path`` exists, fills its existing variable like the reference's
    ``unblock_and_write``; otherwise creates a minimal file with dims
    (expt, site, level).
    """
    data = fluxes.reshape(nexp, nsite, fluxes.shape[1])
    if os.path.exists(path):
        if nc3_native.load_library() is not None:
            nc3_native.update_var(path, varname, data)
            return
        f = netcdf_file(path, "a", mmap=False)
        try:
            var = f.variables[varname]
            var[:] = data.astype(var.data.dtype)
        finally:
            f.close()
        return
    _write_new(path, varname, data, "level", "W m-2")


def write_heating_rates(path: str, varname: str, hr: np.ndarray,
                        nsite: int, nexp: int) -> None:
    """Write layer heating rates (ncol, nlay) [K/day] to a netCDF file with
    dims (expt, site, layer).  An extension of the reference, which writes
    fluxes only; its ckd files' accuracy contract is stated as heating-rate
    tolerances (SURVEY.md section 6)."""
    _write_new(path, varname, hr.reshape(nexp, nsite, hr.shape[1]), "layer",
               "K d-1")


def read_fluxes(path: str, varname: str) -> np.ndarray:
    """Read fluxes back as (ncol, nlev), column order matching RFMIPData."""
    f = netcdf_file(path, mmap=False)
    try:
        data = _read(f.variables[varname])
        nexp, nsite, nlev = data.shape
        return data.reshape(nexp * nsite, nlev)
    finally:
        f.close()


def write_synthetic_rfmip(path: str, nsite: int = 100, nlay: int = 60,
                          nexp: int = 18, seed: int = 0,
                          p_top: float = 1.0e-3) -> None:
    """Create a physically plausible RFMIP-format atmosphere file
    (ecckd_tpu.io.rfmip.write_synthetic_rfmip, line for line: the same
    seed gives the same file contents).

    It has the real file's structure, including ppm/ppb storage with
    numeric ``units`` attributes (the reader's unit scaling) and the
    1e-3 Pa top level that forces the drivers' pressure clamp
    (ecckd_rfmip_lw.F90:87-94).
    """
    rng = np.random.default_rng(seed)
    # Level pressures: log-spaced from near-space to surface, with per-site
    # surface-pressure variation; top level at p_top like the real file.
    p_sfc = rng.uniform(0.95e5, 1.04e5, nsite)
    frac = np.linspace(0.0, 1.0, nlay + 1)[None, :]
    plev = np.exp(np.log(2.0) + (np.log(p_sfc)[:, None] - np.log(2.0)) * frac)
    plev[:, 0] = p_top
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])

    t_sfc_site = rng.uniform(240.0, 305.0, nsite)
    dt_exp = np.linspace(-2.0, 6.0, nexp)
    t_sfc = t_sfc_site[None, :] + dt_exp[:, None]  # (expt, site)
    tlay = (t_sfc[:, :, None]
            - 55.0 * np.exp(-((np.log(np.maximum(play, 1e-3))
                               - np.log(1.5e4)) ** 2) / 4.0)[None, :, :])
    tlev = (t_sfc[:, :, None]
            - 55.0 * np.exp(-((np.log(np.maximum(plev, 1e-3))
                               - np.log(1.5e4)) ** 2) / 4.0)[None, :, :])

    h2o = 0.02 * np.exp(-((np.log(1.05e5) - np.log(np.maximum(play, 1e-3)))
                          / 1.1)) + 2e-6
    h2o = np.broadcast_to(h2o, (nexp, nsite, nlay)) * \
        rng.uniform(0.8, 1.2, (nexp, 1, 1))
    o3 = 10.0 ** (-5.2 - 1.5 * np.abs(np.log10(np.maximum(play, 1e-3) / 2e3)))
    o3 = np.broadcast_to(o3, (nexp, nsite, nlay)).copy()

    f = netcdf_file(path, "w")
    try:
        f.createDimension("expt", nexp)
        f.createDimension("site", nsite)
        f.createDimension("layer", nlay)
        f.createDimension("level", nlay + 1)

        def mk(name, dims, data, units=None):
            var = f.createVariable(name, "f8", dims)
            var[:] = data
            if units is not None:
                var.units = units

        mk("pres_layer", ("site", "layer"), play, "Pa")
        mk("pres_level", ("site", "level"), plev, "Pa")
        mk("temp_layer", ("expt", "site", "layer"), tlay, "K")
        mk("temp_level", ("expt", "site", "level"), tlev, "K")
        mk("surface_temperature", ("expt", "site"), t_sfc + 1.5, "K")
        mk("surface_emissivity", ("site",),
           rng.uniform(0.94, 1.0, nsite), "1")
        mk("surface_albedo", ("site",), rng.uniform(0.05, 0.3, nsite), "1")
        mk("total_solar_irradiance", ("site",),
           np.full(nsite, 1361.0), "W m-2")
        # Mix of day and night columns to exercise the night mask.
        mk("solar_zenith_angle", ("site",),
           rng.uniform(0.0, 130.0, nsite), "degree")
        # Stored in ppmv/ppbv style with numeric units attributes.
        mk("water_vapor", ("expt", "site", "layer"), h2o * 1e3, "1e-03")
        mk("ozone", ("expt", "site", "layer"), o3 * 1e6, "1e-06")

        exp_scale = np.linspace(1.0, 2.0, nexp)
        gm = dict(carbon_dioxide=(397.547, "1e-06"),
                  methane=(1831.47, "1e-09"),
                  nitrous_oxide=(326.99, "1e-09"),
                  oxygen=(0.2095, "1"),
                  cfc11=(233.042, "1e-12"),
                  cfc11eq=(653.47, "1e-12"),
                  cfc12=(520.581, "1e-12"))
        for name, (value, units) in gm.items():
            scale = exp_scale if name == "carbon_dioxide" else np.ones(nexp)
            mk(f"{name}_GM", ("expt",), value * scale, units)
    finally:
        f.close()
