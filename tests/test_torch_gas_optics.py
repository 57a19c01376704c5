"""PyTorch port: gas optics against the JAX package at float64.

Optical depth, Planck, Rayleigh and the gas_optics_* entry points on the
same synthetic models and the same numpy inputs; bound rtol <= 1e-10
(the two packages run the same float64 arithmetic, reordered at most).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (atmosphere, both, ckd_paths, jax_concs,  # noqa: F401
                          load_both, torch_concs)
from ecckd_tpu.models import gas_optics as jgo
from ecckd_tpu.ops.optical_depth import gas_optical_depth as j_tau
from ecckd_tpu.ops.planck import planck_source as j_planck
from ecckd_tpu.ops.rayleigh import rayleigh_optical_depth as j_rayleigh
from ecckd_tpu_torch.models import gas_optics as tgo
from ecckd_tpu_torch.ops.optical_depth import gas_optical_depth as t_tau
from ecckd_tpu_torch.ops.planck import planck_source as t_planck
from ecckd_tpu_torch.ops.rayleigh import rayleigh_optical_depth as t_rayleigh

torch.set_num_threads(2)
RTOL = 1e-10


def edge_batch():
    """(plev, tlay, gases) hitting every clamp edge of the synthetic grid
    (0.694..1.1e5 Pa, T origin 138.46..208.46 K in 20 K steps, h2o axis
    1.61e-7..5.08e-2) plus generic columns.  Columns: 0 generic, 1 above
    the table top, 2 below the surface end, 3 T below the origin, 4 T above
    the grid, 5 h2o below the floor, 6 h2o beyond the LUT top, 7 ch4 below
    its reference mole fraction."""
    ncol, nlay = 8, 6
    atm, gases = atmosphere(ncol, nlay, seed=11)
    plev, tlay = atm["plev"].copy(), atm["tlay"].copy()
    plev[1] = np.geomspace(0.01, 0.5, nlay + 1)
    plev[2] = np.geomspace(1.2e5, 3.0e5, nlay + 1)
    tlay[3] = np.linspace(80.0, 120.0, nlay)
    tlay[4] = 420.0
    gases["h2o"] = gases["h2o"].copy()
    gases["h2o"][5] = 1e-9
    gases["h2o"][6] = 0.2
    gases["ch4"] = np.full(ncol, 2.5e-6)
    gases["ch4"][7] = 5e-7
    return plev, tlay, gases


GAS_SETS = {
    "rfmip": None,  # every gas of the batch
    "unknown_gas_skipped": ("no2", "co2", "h2o", "xyz"),
    "o2_n2_composite_once": ("o2", "n2", "co2"),
    "n2_before_o2": ("n2", "h2o", "o2"),
    "lut_only": ("h2o",),
    "all_unknown": ("no2", "xyz"),
    "ch4_relative_linear": ("ch4", "n2o"),
}


def _request(gases, names):
    if names is None:
        return gases
    extra = dict(no2=1e-9, xyz=3e-6, n2=0.7808, o2=0.2095)
    return {n: gases.get(n, extra.get(n)) for n in names}


@pytest.mark.parametrize("set_name", sorted(GAS_SETS))
@pytest.mark.parametrize("key", ["lw", "sw", "lw_neg"])
def test_gas_optical_depth_matches_jax(ckd_paths, key, set_name):
    jm, tm = load_both(ckd_paths[key])
    plev, tlay, gases = edge_batch()
    req = _request(gases, GAS_SETS[set_name])
    (jp, tp), (jt, tt) = both(plev), both(tlay)
    ref = np.asarray(j_tau(jm, jp, jt, jax_concs(req)))
    got = t_tau(tm, tp, tt, torch_concs(req)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    if set_name == "all_unknown":
        assert not got.any()
    assert (got >= 0).all()


@pytest.mark.parametrize("key", ["lw", "sw"])
def test_logarithmic_interpolation_matches_jax(ckd_paths, key):
    jm, tm = load_both(ckd_paths[key])
    plev, tlay, gases = edge_batch()
    (jp, tp), (jt, tt) = both(plev), both(tlay)
    ref = np.asarray(j_tau(jm, jp, jt, jax_concs(gases),
                           logarithmic_interpolation=True))
    got = t_tau(tm, tp, tt, torch_concs(gases),
                logarithmic_interpolation=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def test_planck_and_rayleigh_match_jax(ckd_paths):
    jl, tl = load_both(ckd_paths["lw"])
    js, ts = load_both(ckd_paths["sw"])
    # Below the table (scaled row 0), inside, and above (extrapolated).
    temps = np.array([[60.0, 119.9, 120.0, 200.5], [288.3, 349.99, 350.0,
                                                    371.2]])
    jT, tT = both(temps)
    np.testing.assert_allclose(
        t_planck(tT, tl.planck_temperature, tl.planck_function).numpy(),
        np.asarray(j_planck(jT, jl.planck_temperature, jl.planck_function)),
        rtol=RTOL, atol=0)
    plev = atmosphere(5, 7, seed=2)[0]["plev"]
    jp, tp = both(plev)
    np.testing.assert_allclose(
        t_rayleigh(tp, ts.rayleigh_coeff).numpy(),
        np.asarray(j_rayleigh(jp, js.rayleigh_coeff)), rtol=RTOL, atol=0)


@pytest.mark.parametrize("key", ["lw", "lw_neg"])
def test_gas_optics_lw_matches_jax(ckd_paths, key):
    jm, tm = load_both(ckd_paths[key])
    atm, gases = atmosphere(6, 9, seed=4)
    a = {k: both(atm[k]) for k in ("plev", "tlay", "tlev", "tsfc")}
    jprops, jsrc = jgo.gas_optics_lw(jm, a["plev"][0], a["tlay"][0],
                                     a["tsfc"][0], jax_concs(gases),
                                     a["tlev"][0])
    tprops, tsrc = tgo.gas_optics(tm, a["plev"][1], a["tlay"][1],
                                  torch_concs(gases), tsfc=a["tsfc"][1],
                                  tlev=a["tlev"][1])
    np.testing.assert_allclose(tprops.tau.numpy(), np.asarray(jprops.tau),
                               rtol=RTOL, atol=0)
    for name in ("lay_source", "lev_source_inc", "lev_source_dec",
                 "sfc_source"):
        np.testing.assert_allclose(getattr(tsrc, name).numpy(),
                                   np.asarray(getattr(jsrc, name)),
                                   rtol=RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("key", ["sw", "sw_neg"])
def test_gas_optics_sw_matches_jax(ckd_paths, key):
    jm, tm = load_both(ckd_paths[key])
    atm, gases = atmosphere(6, 9, seed=5)
    (jp, tp), (jt, tt) = both(atm["plev"]), both(atm["tlay"])
    jprops, jtoa = jgo.gas_optics(jm, jp, jt, jax_concs(gases))
    tprops, ttoa = tgo.gas_optics_sw(tm, tp, tt, torch_concs(gases))
    for name in ("tau", "ssa", "g"):
        np.testing.assert_allclose(getattr(tprops, name).numpy(),
                                   np.asarray(getattr(jprops, name)),
                                   rtol=RTOL, atol=0, err_msg=name)
    np.testing.assert_array_equal(ttoa.numpy(), np.asarray(jtoa))


def test_wrong_model_errors_match_jax(ckd_paths):
    jl, tl = load_both(ckd_paths["lw"])
    js, ts = load_both(ckd_paths["sw"])
    atm, gases = atmosphere(2, 3)
    (jp, tp), (jt, tt) = both(atm["plev"]), both(atm["tlay"])
    (jT, tT), (jv, tv) = both(atm["tsfc"]), both(atm["tlev"])
    jc, tc = jax_concs(gases), torch_concs(gases)
    cases = [
        (lambda go, m, p, t, c, s, v: go.gas_optics_lw(m, p, t, s, c, v),
         "sw", "requires a longwave"),
        (lambda go, m, p, t, c, s, v: go.gas_optics_sw(m, p, t, c),
         "lw", "requires a shortwave"),
        (lambda go, m, p, t, c, s, v: go.gas_optics(m, p, t, c),
         "lw", "requires tsfc and tlev"),
        (lambda go, m, p, t, c, s, v: go.gas_optics(m, p, t, c, tsfc=s),
         "sw", "takes no tsfc/tlev"),
    ]
    for call, which, msg in cases:
        jm, tm = (jl, tl) if which == "lw" else (js, ts)
        with pytest.raises(ValueError, match=msg):
            call(jgo, jm, jp, jt, jc, jT, jv)
        with pytest.raises(ValueError, match=msg):
            call(tgo, tm, tp, tt, tc, tT, tv)
