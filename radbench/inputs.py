"""The benchmark's inputs, made from a seed: ckd-definition files and
column batches.

Both generators are frozen copies kept with the benchmark, so a change to
the program's own generators cannot move what the benchmark runs.

* ``write_ckd`` is ``ecckd_tpu_torch.io.synthetic.write_synthetic_ckd``
  as it stood when the benchmark was written: a netCDF3 ckd-definition
  file with the schema of the shipped ecCKD 1.2 files at their exact
  dimensions (lw_fsck 32 g-points in 1 band, lw_rrtmgp 36 in 16 bands,
  sw_wide 27 in 5 bands, all on one 53 x 6 (p, T) grid with a 12-point
  h2o mole-fraction axis).  The values are plausible, not physical.
* ``make_batch`` draws an RFMIP-shaped batch on the device from a
  ``torch.Generator``: levels uniform in ln p from 2 Pa to 101,300 Pa with
  a per-column pressure jitter, a temperature profile shifted per column,
  surface temperature, emissivity, albedo, TSI and solar zenith angle
  (night included) per column, and per-column gas amounts.

``make_batch`` returns a dict of tensors (``concs``: a dict of gas name ->
tensor, in the order the program receives them).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.io import netcdf_file

MOLES_PER_PA = 1.0 / (9.80665 * 0.001 * 28.970)
CONC_NONE, CONC_LINEAR, CONC_RELATIVE_LINEAR = 0, 1, 3
N_PRESSURE, N_TEMPERATURE, N_MOLE_FRACTION = 53, 6, 12
KINDS = {
    # kind: (ngpt, band sizes, wavenumber count, gases with own tables)
    "lw_fsck": (32, (32,), 326,
                ("h2o", "o3", "co2", "ch4", "n2o", "cfc11", "cfc12")),
    "lw_rrtmgp": (36, (3, 3, 3) + (2,) * 12 + (3,), 326,
                  ("h2o", "o3", "co2", "ch4", "n2o", "cfc11", "cfc12")),
    "sw_wide": (27, (5, 6, 5, 6, 5), 995, ("h2o", "o3", "co2", "ch4", "n2o")),
}
BAND_EDGES = {"lw_fsck": (0.0, 3260.0),
              "lw_rrtmgp": (10.0, 250.0, 500.0, 630.0, 700.0, 820.0, 980.0,
                            1080.0, 1180.0, 1390.0, 1480.0, 1800.0, 2080.0,
                            2250.0, 2390.0, 2680.0, 3250.0),
              "sw_wide": (250.0, 2600.0, 4000.0, 8050.0, 12850.0, 50000.0)}
REFERENCE_MF = {"ch4": 1.921e-6, "n2o": 3.32e-7}
TYPICAL_VMR = {"composite": 1.0, "h2o": 3e-3, "o3": 1e-6, "co2": 4e-4,
               "ch4": 1e-7, "n2o": 3e-8, "cfc11": 2e-10, "cfc12": 5e-10}
SIGMA = 5.670374419e-8

GASES = ("co2", "ch4", "n2o", "o2", "cfc11", "cfc12", "h2o", "o3")
"""The gases a batch carries, in the order the program is given them
(RFMIP's well-mixed gases, then the two profiles)."""


def _grids(n_pressure: int):
    pressure = np.exp(np.linspace(np.log(0.694), np.log(1.1e5), n_pressure))
    t_first = 138.46 + 70.0 * np.linspace(0.0, 1.0, n_pressure)
    temperature = (t_first[None, :]
                   + 20.0 * np.arange(N_TEMPERATURE)[:, None])  # (T, p)
    mole_fraction = np.exp(np.linspace(np.log(1.61e-7), np.log(5.08e-2),
                                       N_MOLE_FRACTION))
    return pressure, temperature, mole_fraction


def _absorption(rng, gases, ngpt, pressure, temperature, mole_fraction):
    column_moles = 1.0e5 * MOLES_PER_PA
    target = 10.0 ** np.linspace(-4.0, 3.0, ngpt)
    rng.shuffle(target)
    names = ("composite",) + tuple(gases)
    major = rng.integers(0, len(names), ngpt)
    p_shape = (pressure / 1.0e5)[None, :, None]
    t_rel = (temperature / 250.0)[:, :, None]
    tables = {}
    for k, name in enumerate(names):
        minor = 10.0 ** -rng.uniform(1.0, 4.0, ngpt)
        strength = target * np.where(major == k, 1.0, minor)
        k_g = strength / (column_moles * TYPICAL_VMR[name])
        alpha = rng.uniform(0.0, 0.8, ngpt)[None, None, :]
        beta = rng.uniform(-1.5, 1.5, ngpt)[None, None, :]
        table = k_g[None, None, :] * p_shape ** alpha * t_rel ** beta
        if name == "h2o":
            table = (table[None]
                     * (1.0 + mole_fraction / 1e-2)[:, None, None, None])
        tables[name] = table
    return tables


def write_ckd(path: str, kind: str, seed: int,
              n_pressure: int = N_PRESSURE) -> None:
    """Write the synthetic ckd-definition file of ``kind`` made from
    ``seed`` to ``path``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    ngpt, band_sizes, n_wn, gases = KINDS[kind]
    rng = np.random.default_rng(seed)
    pressure, temperature, mole_fraction = _grids(n_pressure)
    tables = _absorption(rng, gases, ngpt, pressure, temperature,
                         mole_fraction)
    band_number = np.repeat(np.arange(len(band_sizes)), band_sizes)

    f = netcdf_file(path, "w", version=1)
    try:
        for name, size in (("g_point", ngpt), ("pressure", n_pressure),
                           ("temperature", N_TEMPERATURE),
                           ("wavenumber", n_wn), ("band", len(band_sizes)),
                           ("h2o_mole_fraction", N_MOLE_FRACTION),
                           ("composite_gas", 4)):
            f.createDimension(name, size)

        def var(name, typ, dims, data):
            f.createVariable(name, typ, dims)[...] = data

        var("pressure", "f8", ("pressure",), pressure)
        var("temperature", "f8", ("temperature", "pressure"), temperature)
        edges = BAND_EDGES[kind]
        var("wavenumber1_band", "f8", ("band",), edges[:-1])
        var("wavenumber2_band", "f8", ("band",), edges[1:])
        var("band_number", "i4", ("g_point",), band_number)
        owner = rng.integers(0, ngpt, n_wn)
        var("gpoint_fraction", "f4", ("g_point", "wavenumber"),
            (owner[None, :] == np.arange(ngpt)[:, None]).astype(np.float32))
        if kind.startswith("sw"):
            solar = rng.uniform(0.5, 1.5, ngpt)
            var("solar_irradiance", "f8", ("g_point",),
                1361.0 * solar / solar.sum())
            var("rayleigh_molar_scattering_coeff", "f8", ("g_point",),
                10.0 ** rng.uniform(-9.0, -6.0, ngpt))
        else:
            f.createDimension("temperature_planck", 231)
            t_planck = np.linspace(120.0, 350.0, 231)
            centre = rng.uniform(150.0, 330.0, ngpt)
            frac = np.exp(-((t_planck[:, None] - centre[None, :]) / 80.0) ** 2)
            frac /= frac.sum(axis=1, keepdims=True)
            var("temperature_planck", "f8", ("temperature_planck",),
                t_planck)
            var("planck_function", "f8", ("temperature_planck", "g_point"),
                SIGMA * t_planck[:, None] ** 4 * frac)

        f.constituent_id = "composite " + " ".join(gases)
        f.composite_constituent_id = "o2 n2 n2o ch4"
        var("n_gases", "i4", (), len(gases) + 1)
        var("composite_mole_fraction", "f8", ("composite_gas", "pressure"),
            np.tile([[0.2095], [0.7808], [3.2e-7], [1.8e-6]],
                    (1, n_pressure)))
        var("composite_conc_dependence_code", "i2", (), CONC_NONE)
        var("composite_molar_absorption_coeff", "f4",
            ("temperature", "pressure", "g_point"), tables["composite"])
        for gas in gases:
            if gas == "h2o":
                var("h2o_mole_fraction", "f8", ("h2o_mole_fraction",),
                    mole_fraction)
                var("h2o_molar_absorption_coeff", "f4",
                    ("h2o_mole_fraction", "temperature", "pressure",
                     "g_point"), tables["h2o"])
                continue
            code = (CONC_RELATIVE_LINEAR if gas in REFERENCE_MF
                    else CONC_LINEAR)
            var(f"{gas}_conc_dependence_code", "i2", (), code)
            if gas in REFERENCE_MF:
                var(f"{gas}_reference_mole_fraction", "f8", (),
                    REFERENCE_MF[gas])
            var(f"{gas}_molar_absorption_coeff", "f4",
                ("temperature", "pressure", "g_point"), tables[gas])
    finally:
        f.close()


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any
    non-negative integer below 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 64)
    return g


def make_batch(ncol: int, nlay: int, gen: torch.Generator,
               device) -> dict:
    """A float32 RFMIP-shaped batch of ``ncol`` columns of ``nlay`` layers
    drawn from ``gen`` on ``device`` (see the module docstring)."""
    f32 = torch.float32

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (ncol,), generator=gen,
                                           device=device, dtype=f32)

    base = torch.exp(torch.linspace(math.log(2.0), math.log(101300.0),
                                    nlay + 1, device=device,
                                    dtype=torch.float64)).to(f32)
    jitter = 1.0 + 0.03 * torch.randn((ncol, 1), generator=gen,
                                      device=device, dtype=f32)
    plev = base[None, :] * jitter
    shift = u(-15.0, 15.0, ncol, 1)

    def temperature(p):
        bump = torch.exp(-((torch.log(p) - math.log(1.5e4)) ** 2) / 4.0)
        return 288.0 + shift - 55.0 * bump

    tlay = temperature(0.5 * (plev[:, 1:] + plev[:, :-1]))
    tlev = temperature(plev)
    tsfc = tlev[:, -1] + u(-5.0, 10.0)
    h2o = (0.02 * torch.exp(-torch.log(1.05e5 / plev[:, 1:]) / 1.1) + 2e-6
           ) * u(0.2, 1.5, ncol, 1)
    o3 = 3e-7 * u(0.5, 2.0, ncol, 1) * torch.ones((1, nlay), device=device,
                                                  dtype=f32)
    concs = {"co2": u(280e-6, 1120e-6), "ch4": u(0.7e-6, 2.5e-6),
             "n2o": u(2.7e-7, 3.3e-7),
             "o2": torch.full((ncol,), 0.2095, device=device, dtype=f32),
             "cfc11": u(0.0, 250e-12), "cfc12": u(0.0, 550e-12),
             "h2o": h2o, "o3": o3.contiguous()}
    return dict(plev=plev.contiguous(), tlay=tlay.contiguous(),
                tlev=tlev.contiguous(), tsfc=tsfc.contiguous(),
                emis=u(0.9, 1.0), alb=u(0.05, 0.4), tsi=u(1340.0, 1380.0),
                sza=u(0.0, 110.0), concs=concs)


def take_columns(batch: dict, idx: torch.Tensor) -> dict:
    """The columns ``idx`` of ``batch`` (every leaf has a leading column
    axis), on ``idx``'s device."""
    pick = lambda t: t.index_select(0, idx.to(t.device))
    out = {k: pick(v) for k, v in batch.items() if k != "concs"}
    out["concs"] = {k: pick(v) for k, v in batch["concs"].items()}
    return out
