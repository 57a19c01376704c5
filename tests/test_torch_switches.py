"""PyTorch port: the JAX package's two debugging switches.

* ``config.enable_f64_validation_mode`` (JAX: x64 on): float64 becomes
  the default working precision, so the loader's default model is the
  float64 one, equal to an explicit ``dtype=torch.float64`` load.
* ``utils.checks.enable_nan_debugging`` (JAX: ``jax_debug_nans``): the
  pipeline checks each stage's output and raises at the first stage that
  made a non-finite value, naming it; off, a NaN flows through silently.
"""
import numpy as np
import pytest
import torch

from torch_parity import ckd_paths, flux_batch, torch_concs  # noqa: F401
from ecckd_tpu_torch import config, pipeline
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.utils import checks

torch.set_num_threads(2)


@pytest.fixture
def restore_switches(monkeypatch):
    monkeypatch.setattr(config, "_F64_VALIDATION", config._F64_VALIDATION)
    monkeypatch.setattr(checks, "_NAN_DEBUG", checks._NAN_DEBUG)


def test_f64_validation_mode(ckd_paths, restore_switches):
    assert config.default_precision().dtype == torch.float32
    assert load_ckd_model(ckd_paths["lw"]).dtype == torch.float32
    config.enable_f64_validation_mode()
    assert config.default_precision() == config.F64
    m = load_ckd_model(ckd_paths["lw"])
    ref = load_ckd_model(ckd_paths["lw"], dtype=torch.float64)
    assert m.dtype == torch.float64
    assert torch.equal(m.coeff_dense, ref.coeff_dense)
    assert all(torch.equal(a, b) for a, b in zip(m.coeff_lut, ref.coeff_lut))
    # An explicit dtype still wins.
    assert load_ckd_model(ckd_paths["lw"],
                          dtype=torch.float32).dtype == torch.float32
    config.enable_f64_validation_mode(False)
    assert config.default_precision() == config.F32


def _nan_batch(gas):
    b = flux_batch(4, 6, seed=3, dtype=torch.float64)
    b["gases"][gas] = np.array(b["gases"][gas], copy=True)
    b["gases"][gas][1, 2] = np.nan
    return b


@pytest.mark.parametrize("band", ["lw", "sw"])
def test_nan_debugging_names_the_first_stage(ckd_paths, band,
                                             restore_switches):
    model = load_ckd_model(ckd_paths[band], dtype=torch.float64)
    b = _nan_batch("o3")
    T = lambda k: torch.as_tensor(b[k])

    def run():
        if band == "lw":
            return pipeline.lw_fluxes(model, T("plev"), T("tlay"), T("tlev"),
                                      T("tsfc"), T("emis"),
                                      torch_concs(b["gases"]))
        return pipeline.sw_fluxes(model, T("plev"), T("tlay"),
                                  torch_concs(b["gases"]), T("alb"),
                                  T("tsi"), T("sza"))

    off = run()
    assert not torch.isfinite(off.flux_dn).all()      # silent when off
    checks.enable_nan_debugging()
    with pytest.raises(FloatingPointError,
                       match=f"non-finite values in gas_optics_{band} tau"):
        run()
    checks.enable_nan_debugging(False)
    assert torch.equal(torch.isnan(run().flux_dn), torch.isnan(off.flux_dn))


def test_nan_debugging_passes_finite_runs_and_checks_the_solver(
        ckd_paths, restore_switches):
    model = load_ckd_model(ckd_paths["lw"], dtype=torch.float64)
    b = flux_batch(4, 6, seed=3, dtype=torch.float64)
    T = lambda k: torch.as_tensor(b[k])
    args = (model, T("plev"), T("tlay"), T("tlev"), T("tsfc"))
    ref = pipeline.lw_fluxes(*args, T("emis"), torch_concs(b["gases"]))
    checks.enable_nan_debugging()
    got = pipeline.lw_fluxes(*args, T("emis"), torch_concs(b["gases"]))
    assert torch.equal(got.flux_up, ref.flux_up)
    # An emissivity of NaN enters only at the solver.
    emis = T("emis").clone()
    emis[0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match="non-finite values in rte_lw flux_up"):
        pipeline.lw_fluxes(*args, emis, torch_concs(b["gases"]))
    checks.check_stage("anything", x=torch.ones(2))
    with pytest.raises(FloatingPointError, match="stage y"):
        checks.check_stage("stage", y=torch.tensor([float("inf")]))
