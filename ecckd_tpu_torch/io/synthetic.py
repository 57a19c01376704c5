"""Synthetic inputs: an RFMIP-shaped column batch and ckd-definition files.

* ``example_flux_batch`` is ``ecckd_tpu.io.synthetic.example_flux_batch``
  line for line, so both packages take the same batch.
* ``write_synthetic_ckd`` writes a netCDF3 ckd-definition file with the
  schema of the shipped ecCKD 1.2 files (SURVEY.md section 2.6) at their
  exact dimensions: ``lw_fsck`` has 32 g-points in 1 band and a 231-point
  Planck table; ``lw_rrtmgp`` 36 g-points in the 16 RRTMGP bands and the
  same Planck table; ``sw_wide`` has 27 g-points in 5 bands; all share a
  53-pressure x 6-temperature grid and a 12-point h2o mole-fraction axis,
  so any LW + SW pair is mergeable.  ``n_pressure`` puts a file on another
  pressure grid over the same range (a pair that is not mergeable).  Gas
  registration follows the shipped files:
  composite (code 0) with o2/n2 composite-only, h2o a LUT gas,
  o3/co2 (and LW cfc11/cfc12) linear, ch4/n2o relative-linear
  (1.921e-6, 3.32e-7).  The values are plausible, not physical: each
  g-point has a column optical depth between ~1e-4 and ~1e3 carried by one
  major gas, LW Planck rows sum over g to sigma*T^4, and the solar
  irradiance sums to 1361 W m-2.  All tables are >= 0 unless
  ``negative_entry=True``, which makes some co2 and h2o entries negative.

Usage: python -m ecckd_tpu_torch.io.synthetic out.nc --kind lw_fsck [--seed S]
       [--negative-entry] [--n-pressure N]
"""
from __future__ import annotations

import argparse

import numpy as np
from scipy.io import netcdf_file

from ecckd_tpu_torch import constants

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
              # The 16 RRTMGP longwave bands [cm-1].
              "lw_rrtmgp": (10.0, 250.0, 500.0, 630.0, 700.0, 820.0, 980.0,
                            1080.0, 1180.0, 1390.0, 1480.0, 1800.0, 2080.0,
                            2250.0, 2390.0, 2680.0, 3250.0),
              "sw_wide": (250.0, 2600.0, 4000.0, 8050.0, 12850.0, 50000.0)}
LINEAR, RELATIVE_LINEAR = constants.CONC_LINEAR, constants.CONC_RELATIVE_LINEAR
REFERENCE_MF = {"ch4": 1.921e-6, "n2o": 3.32e-7}
TYPICAL_VMR = {"composite": 1.0, "h2o": 3e-3, "o3": 1e-6, "co2": 4e-4,
               "ch4": 1e-7, "n2o": 3e-8, "cfc11": 2e-10, "cfc12": 5e-10}
"""Mole fraction (or, relative-linear, its excess over the reference) at
which a gas's table gives its target column optical depth."""
SIGMA = 5.670374419e-8


def example_flux_batch(ncol: int, nlay: int, dtype, device=None):
    """RFMIP-shaped in-memory column batch for benchmarks and dry runs.

    Deterministic per-column jitter keeps columns heterogeneous.  Arrays
    are numpy; the gas concentrations a torch GasConcs (on ``device``).
    """
    from ecckd_tpu_torch.gases import GasConcs
    base = np.exp(np.linspace(np.log(2.0), np.log(101300.0), nlay + 1))
    rng = np.random.default_rng(0)
    jitter = 1.0 + 0.03 * rng.standard_normal((ncol, 1))
    plev = (base[None, :] * jitter).astype(dtype)
    logp = np.log(0.5 * (plev[:, 1:] + plev[:, :-1]))
    tlay = (288.0 - 55.0 * np.exp(-((logp - np.log(1.5e4)) ** 2) / 4.0)
            ).astype(dtype)
    tlev = (288.0 - 55.0 * np.exp(-((np.log(plev) - np.log(1.5e4)) ** 2)
                                  / 4.0)).astype(dtype)
    tsfc = np.full(ncol, 294.0, dtype)
    emis = np.full(ncol, 0.98, dtype)
    alb = np.full(ncol, 0.1, dtype)
    tsi = np.full(ncol, 1361.0, dtype)
    sza = np.linspace(10.0, 120.0, ncol).astype(dtype)
    h2o = (0.02 * np.exp(-(np.log(1.05e5 / np.maximum(plev[:, 1:], 1e-3))
                           / 1.1)) + 2e-6).astype(dtype)
    o3 = np.full((ncol, nlay), 3e-7, dtype)
    concs = GasConcs.create([
        ("co2", np.full(ncol, 397.5e-6, dtype)),
        ("ch4", np.full(ncol, 1831e-9, dtype)),
        ("n2o", np.full(ncol, 327e-9, dtype)),
        ("o2", np.full(ncol, 0.2095, dtype)),
        ("cfc11", np.full(ncol, 233e-12, dtype)),
        ("cfc12", np.full(ncol, 520e-12, dtype)),
        ("h2o", h2o), ("o3", o3)], device=device)
    return dict(plev=plev, tlay=tlay, tlev=tlev, tsfc=tsfc, emis=emis,
                alb=alb, tsi=tsi, sza=sza, concs=concs)


def _grids(n_pressure: int = N_PRESSURE):
    """Pressure (0.694 Pa .. 1.1e5 Pa, uniform in ln p) and the (T, p)
    temperature grid: 20 K steps from an origin rising with pressure."""
    pressure = np.exp(np.linspace(np.log(0.694), np.log(1.1e5), n_pressure))
    t_first = 138.46 + 70.0 * np.linspace(0.0, 1.0, n_pressure)
    temperature = (t_first[None, :]
                   + 20.0 * np.arange(N_TEMPERATURE)[:, None])  # (T, p)
    mole_fraction = np.exp(np.linspace(np.log(1.61e-7), np.log(5.08e-2),
                                       N_MOLE_FRACTION))
    return pressure, temperature, mole_fraction


def _absorption(rng, gases, ngpt, pressure, temperature, mole_fraction):
    """Per-gas tables (T, p, g) [(mf, T, p, g) for h2o]: log-uniform in
    g-point strength, one major gas per g-point, smooth in p and T."""
    column_moles = 1.0e5 * constants.MOLES_PER_PA
    target = 10.0 ** np.linspace(-4.0, 3.0, ngpt)         # column tau per g
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
        if name == "h2o":   # self-broadening: grows with mole fraction
            table = (table[None]
                     * (1.0 + mole_fraction / 1e-2)[:, None, None, None])
        tables[name] = table
    return tables


def write_synthetic_ckd(path: str, kind: str = "lw_fsck", seed: int = 0,
                        negative_entry: bool = False,
                        n_pressure: int = N_PRESSURE) -> None:
    """Write a synthetic ckd-definition file of ``kind`` ("lw_fsck",
    "lw_rrtmgp" or "sw_wide") on an ``n_pressure``-point pressure grid; see
    the module docstring."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    ngpt, band_sizes, n_wn, gases = KINDS[kind]
    rng = np.random.default_rng(seed)
    pressure, temperature, mole_fraction = _grids(n_pressure)
    tables = _absorption(rng, gases, ngpt, pressure, temperature,
                         mole_fraction)
    if negative_entry:
        # Negative entries in a linear gas and the LUT gas: the per-gas,
        # per-g-point clamp (not a clamp on the weight) is then what keeps
        # the optical depth non-negative.
        tables["co2"][:3, :, :4] *= -0.5
        tables["h2o"][:, :2, -10:, -3:] *= -0.5
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
            # Fractions of sigma*T^4 per g-point, smooth in T.
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
        var("composite_conc_dependence_code", "i2", (),
            constants.CONC_NONE)
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
            code = RELATIVE_LINEAR if gas in REFERENCE_MF else LINEAR
            var(f"{gas}_conc_dependence_code", "i2", (), code)
            if gas in REFERENCE_MF:
                var(f"{gas}_reference_mole_fraction", "f8", (),
                    REFERENCE_MF[gas])
            var(f"{gas}_molar_absorption_coeff", "f4",
                ("temperature", "pressure", "g_point"), tables[gas])
    finally:
        f.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ecckd_tpu_torch.io.synthetic")
    p.add_argument("output")
    p.add_argument("--kind", choices=sorted(KINDS), default="lw_fsck")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--negative-entry", action="store_true")
    p.add_argument("--n-pressure", type=int, default=N_PRESSURE)
    args = p.parse_args(argv)
    write_synthetic_ckd(args.output, args.kind, args.seed,
                        args.negative_entry, args.n_pressure)
    print(f"wrote {args.output}: synthetic {args.kind}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
