"""PyTorch port: ckd model container and loader against the JAX package.

Both loaders read the same synthetic ckd-definition files; arrays and
metadata must agree exactly (bound: exact equality).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import KINDS, ckd_paths, load_both  # noqa: F401
from ecckd_tpu_torch.models.ckd import (ARRAY_FIELDS, META_FIELDS,
                                        ckd_from_jax)
from ecckd_tpu_torch.io.synthetic import SIGMA

torch.set_num_threads(2)


def _assert_same_model(jm, tm):
    for name in ARRAY_FIELDS:
        a, b = getattr(jm, name), getattr(tm, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)
    assert len(jm.coeff_lut) == len(tm.coeff_lut)
    for a, b in zip(jm.coeff_lut, tm.coeff_lut):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for name in META_FIELDS:
        assert getattr(jm, name) == getattr(tm, name), name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("key", sorted(KINDS))
def test_loaders_agree(ckd_paths, key, dtype):
    jm, tm = load_both(ckd_paths[key], dtype)
    assert tm.dtype == dtype
    _assert_same_model(jm, tm)
    assert tm.tables_nonneg == (not key.endswith("_neg"))


@pytest.mark.parametrize("key", ["lw", "sw"])
def test_ckd_from_jax_round_trips(ckd_paths, key):
    jm, tm = load_both(ckd_paths[key])
    _assert_same_model(jm, ckd_from_jax(jm))
    conv32 = ckd_from_jax(jm, dtype=torch.float32)
    assert conv32.dtype == torch.float32
    _assert_same_model(jm.astype(jnp.float32), tm.astype(torch.float32))


def test_synthetic_pair_has_the_shipped_dimensions(ckd_paths):
    lw = load_both(ckd_paths["lw"])[1]
    sw = load_both(ckd_paths["sw"])[1]
    assert (lw.ngpt, lw.nband, lw.planck_function.shape[0]) == (32, 1, 231)
    assert (sw.ngpt, sw.nband) == (27, 5)
    for m in (lw, sw):
        assert tuple(m.temperature_grid.shape) == (53, 6)
        assert [len(g) for g in m.lut_mf_grids] == [12]
    assert lw.grid_key == sw.grid_key
    assert lw.gas_names == ("h2o", "o3", "co2", "ch4", "n2o", "cfc11",
                            "cfc12", "o2", "n2")
    assert lw.gas_codes == (2, 1, 1, 3, 3, 1, 1, 0, 0)
    assert lw.gas_reference_mf[3:5] == (1.921e-6, 3.32e-7)
    assert lw.gas_composite_only[-2:] == (True, True)
    # Planck rows sum over g-points to sigma T^4; solar sums to 1361.
    t = lw.planck_temperature.numpy()
    np.testing.assert_allclose(lw.planck_function.numpy().sum(axis=1),
                               SIGMA * t ** 4, rtol=1e-12)
    assert sw.total_solar_irradiance == pytest.approx(1361.0, rel=1e-12)
    neg = load_both(ckd_paths["lw_neg"])[1]
    assert float(neg.coeff_dense.min()) < 0 and float(
        neg.coeff_lut[0].min()) < 0
    # The rrtmgp-shaped LW model: 36 g-points in 16 contiguous bands, on
    # the shared grid; sw_p47 sits on another pressure grid.
    rr = load_both(ckd_paths["lw_rrtmgp"])[1]
    assert (rr.ngpt, rr.nband, rr.planck_function.shape[0]) == (36, 16, 231)
    assert sorted(g for a, b in rr.band2gpt
                  for g in range(a, b + 1)) == list(range(36))
    assert rr.grid_key == sw.grid_key
    p47 = load_both(ckd_paths["sw_p47"])[1]
    assert tuple(p47.temperature_grid.shape) == (47, 6)
    assert p47.grid_key != lw.grid_key
    assert p47.get_press_min() == pytest.approx(lw.get_press_min())


@pytest.mark.parametrize("key", ["lw", "sw", "lw_rrtmgp", "sw_p47"])
def test_accessors_match_jax(ckd_paths, key):
    jm, tm = load_both(ckd_paths[key])
    for name in ("ngpt", "nband"):
        assert getattr(jm, name) == getattr(tm, name)
    for name in ("get_ngpt", "get_nband", "get_ngas", "get_gases",
                 "source_is_internal", "source_is_external", "get_press_min",
                 "get_press_max", "get_temp_min", "get_temp_max"):
        assert getattr(jm, name)() == getattr(tm, name)(), name
    for gi, code in enumerate(tm.gas_codes):
        if code == 2:
            for m in (jm, tm):
                with pytest.raises(ValueError, match="LUT gas"):
                    m.weight_scale_offset(gi)
        else:
            assert jm.weight_scale_offset(gi) == tm.weight_scale_offset(gi)
    per_band = np.random.default_rng(1).uniform(0.1, 1.0, (3, tm.nband))
    np.testing.assert_array_equal(
        np.asarray(jm.gpt_weights_per_band(jnp.asarray(per_band))),
        tm.gpt_weights_per_band(torch.as_tensor(per_band)).numpy())
    moved = tm.to("cpu").astype(torch.float32)
    assert moved.dtype == torch.float32 and moved.device.type == "cpu"
    assert moved.grid_key == tm.grid_key and moved._cache == {}
