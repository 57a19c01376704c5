"""PyTorch port: RFMIP I/O and the RFMIP drivers against the JAX package.

* ``io/rfmip.py``: the port's reader gives the JAX reader's arrays exactly
  on the same file (forcing indices 1 and 2); a file the port writes reads
  back in the JAX reader as the JAX writer's file does.
* The CLIs at f64 on the CPU (``--device cpu``): the port's rlu/rld/rsu/rsd
  and heating-rate files agree with the JAX CLIs' files at rtol <= 1e-10,
  the pipelines' parity class (both run the same f64 arithmetic, reordered
  at most).  SW night columns are exactly 0, the combined driver's files
  equal the separate drivers', a wrong-band ckd file returns 1, and
  ``--device cuda`` without a card raises instead of falling back.
* ``utils/checks.py`` (the drivers' ``--validate``): ``validate_inputs``
  accepts and refuses what the JAX one does, with the same message;
  ``assert_all_finite`` raises on NaN and infinity.
"""
import os

import numpy as np
import pytest
import torch

from torch_parity import ckd_paths  # noqa: F401
from ecckd_tpu.cli import ecckd_rfmip_lw as j_lw, ecckd_rfmip_sw as j_sw
from ecckd_tpu.io import rfmip as jrfmip
from ecckd_tpu_torch.cli import (ecckd_rfmip as t_lwsw,
                                 ecckd_rfmip_lw as t_lw,
                                 ecckd_rfmip_sw as t_sw)
from ecckd_tpu_torch.io import rfmip as trfmip

torch.set_num_threads(2)
RTOL = 1e-10
STEM = "_Efx_RTE-ecckd_rad-irf_r1i1p{p}f{f}_gn.nc"


@pytest.fixture(scope="module")
def rfmip_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rfmip") / "rfmip_synth.nc")
    jrfmip.write_synthetic_rfmip(path, nsite=8, nlay=24, nexp=2, seed=7)
    return path


def _assert_same_data(a, b):
    for name in ("nsite", "nlay", "nexp", "ncol", "top_at_1"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("play", "plev", "tlay", "tlev", "sfc_emis", "sfc_t",
                 "sfc_alb", "tsi", "sza"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for field in ("gases_3d", "gases_scalar"):
        x, y = getattr(a, field), getattr(b, field)
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("forcing", [1, 2])
def test_read_rfmip_matches_jax(rfmip_file, forcing):
    _assert_same_data(trfmip.read_rfmip(rfmip_file, forcing),
                      jrfmip.read_rfmip(rfmip_file, forcing))
    assert trfmip.rfmip_gas_names(forcing) == jrfmip.rfmip_gas_names(forcing)
    with pytest.raises(ValueError, match="forcing index"):
        trfmip.rfmip_gas_names(3)


def test_write_synthetic_rfmip_reads_back_in_jax(rfmip_file, tmp_path):
    path = str(tmp_path / "port.nc")
    trfmip.write_synthetic_rfmip(path, nsite=8, nlay=24, nexp=2, seed=7)
    for forcing in (1, 2):
        _assert_same_data(jrfmip.read_rfmip(path, forcing),
                          jrfmip.read_rfmip(rfmip_file, forcing))


def test_flux_files_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    fluxes = rng.uniform(0.0, 400.0, (6, 5))
    path = str(tmp_path / "rlu.nc")
    trfmip.write_fluxes(path, "rlu", fluxes, nsite=3, nexp=2)
    np.testing.assert_array_equal(jrfmip.read_fluxes(path, "rlu"), fluxes)
    # An existing file is filled in place, as unblock_and_write does.
    trfmip.write_fluxes(path, "rlu", 2.0 * fluxes, nsite=3, nexp=2)
    np.testing.assert_array_equal(trfmip.read_fluxes(path, "rlu"),
                                  2.0 * fluxes)
    hr = rng.uniform(-5.0, 5.0, (6, 4))
    trfmip.write_heating_rates(str(tmp_path / "hrl.nc"), "hrl", hr, 3, 2)
    np.testing.assert_array_equal(
        trfmip.read_fluxes(str(tmp_path / "hrl.nc"), "hrl"), hr)


def _run(main, args, out_dir):
    rc = main([*args, "--output-dir", str(out_dir), "--precision", "f64",
               "--heating-rates"])
    assert rc == 0


def _read(out_dir, var, p, f):
    return trfmip.read_fluxes(os.path.join(str(out_dir),
                                           var + STEM.format(p=p, f=f)), var)


@pytest.fixture(scope="module")
def jax_runs(rfmip_file, ckd_paths, tmp_path_factory):
    """The JAX CLIs' output files: LW -p 1 -f 1, LW -p 2 -f 2, SW -f 1."""
    d = tmp_path_factory.mktemp("jax_cli")
    for p, f in ((1, 1), (2, 2)):
        _run(j_lw.main, [rfmip_file, ckd_paths["lw"], "-p", str(p), "-f",
                         str(f), "--no-shard"], d)
    _run(j_sw.main, [rfmip_file, ckd_paths["sw"], "--no-shard"], d)
    return d


def _assert_files_close(got_dir, ref_dir, names):
    for var, p, f in names:
        got, ref = _read(got_dir, var, p, f), _read(ref_dir, var, p, f)
        assert got.shape == ref.shape and np.isfinite(got).all(), var
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0,
                                   err_msg=f"{var} p{p} f{f}")


@pytest.mark.parametrize("p,f", [(1, 1), (2, 2)])
def test_lw_cli_matches_jax(rfmip_file, ckd_paths, jax_runs, tmp_path, p, f):
    _run(t_lw.main, [rfmip_file, ckd_paths["lw"], "-p", str(p), "-f", str(f),
                     "--device", "cpu", "--validate"], tmp_path)
    _assert_files_close(tmp_path, jax_runs,
                        [("rlu", p, f), ("rld", p, f), ("hrl", p, f)])
    assert (_read(tmp_path, "rld", p, f)[:, 0] == 0).all()   # no TOA down


def test_sw_cli_matches_jax(rfmip_file, ckd_paths, jax_runs, tmp_path):
    metrics = str(tmp_path / "m.json")
    _run(t_sw.main, [rfmip_file, ckd_paths["sw"], "--device", "cpu",
                     "--metrics-json", metrics], tmp_path)
    _assert_files_close(tmp_path, jax_runs,
                        [("rsu", 1, 1), ("rsd", 1, 1), ("hrs", 1, 1)])
    data = trfmip.read_rfmip(rfmip_file)
    night = data.sza >= 90.0
    assert night.any() and (~night).any()
    for var in ("rsu", "rsd"):
        assert not _read(tmp_path, var, 1, 1)[night].any()
    assert os.path.exists(metrics)


@pytest.mark.parametrize("p,f", [(1, 1), (2, 2)])
def test_combined_cli_equals_separate_clis(rfmip_file, ckd_paths, tmp_path,
                                           p, f):
    args = ["-p", str(p), "-f", str(f), "--device", "cpu"]
    _run(t_lwsw.main, [rfmip_file, ckd_paths["lw"], ckd_paths["sw"], *args],
         tmp_path / "both")
    _run(t_lw.main, [rfmip_file, ckd_paths["lw"], *args], tmp_path / "sep")
    _run(t_sw.main, [rfmip_file, ckd_paths["sw"], *args], tmp_path / "sep")
    for var, pp in (("rlu", p), ("rld", p), ("hrl", p), ("rsu", 1),
                    ("rsd", 1), ("hrs", 1)):   # SW files are always p1
        np.testing.assert_array_equal(_read(tmp_path / "both", var, pp, f),
                                      _read(tmp_path / "sep", var, pp, f))


def test_cli_refusals(rfmip_file, ckd_paths, tmp_path):
    cpu = ["--device", "cpu", "--output-dir", str(tmp_path)]
    assert t_lw.main([rfmip_file, ckd_paths["sw"], *cpu]) == 1
    assert t_sw.main([rfmip_file, ckd_paths["lw"], *cpu]) == 1
    assert t_lwsw.main([rfmip_file, ckd_paths["sw"], ckd_paths["lw"],
                        *cpu]) == 1
    assert not os.listdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_lw.main([rfmip_file, ckd_paths["lw"], "--output-dir",
                       str(tmp_path)])
    with pytest.raises(SystemExit):
        t_lw.main([rfmip_file, ckd_paths["lw"], "--backend", "fused"])


def _validation_cases():
    """(plev, tlay, tlev, press_min, press_max) cases of the drivers'
    --validate: accepted ones and one per refusal."""
    ok = np.array([[0.694 + 1e-7, 50.0, 5000.0, 1.0e5]])
    t = np.full((1, 3), 260.0)
    return [
        (ok.astype(np.float32), t, None, 0.694, 1.1e5),   # clamp's own f32
        (np.array([[4.1 * 0.5, 8.2, 41.0]]), t[:, :2], None, 4.1, None),
        (np.array([[100.0, 50.0, 1000.0, 2000.0]]), t, None, None, None),
        (ok, -t, None, None, None),
        (ok, t, np.zeros((1, 4)), None, None),
        (ok, t, None, None, 5.0e4),
        (np.array([[np.nan, 50.0, 5000.0, 1.0e5]]), t, None, None, None),
        (ok[:, :3], t, None, None, None),
    ]


@pytest.mark.parametrize("case", range(8))
def test_validate_inputs_matches_jax(case):
    """The drivers' --validate: the port accepts and refuses what the JAX
    package accepts and refuses, with the same message."""
    from ecckd_tpu.utils import checks as jchecks
    from ecckd_tpu_torch.utils import checks as tchecks
    plev, tlay, tlev, pmin, pmax = _validation_cases()[case]
    results = []
    for mod in (jchecks, tchecks):
        try:
            mod.validate_inputs(plev, tlay, tlev, press_min=pmin,
                                press_max=pmax)
            results.append(None)
        except mod.InputValidationError as e:
            results.append(str(e))
    assert results[0] == results[1]
    assert (results[0] is None) == (case == 0)


def test_assert_all_finite():
    from ecckd_tpu_torch.utils.checks import assert_all_finite
    x = torch.arange(4.0)
    assert assert_all_finite(x) is x
    for bad in (float("nan"), float("inf")):
        with pytest.raises(FloatingPointError, match="non-finite values in "
                                                     "fluxes"):
            assert_all_finite(torch.tensor([1.0, bad]), "fluxes")
