"""The plain reference against the port's torch path at float64 on the
CPU, and the frozen generators against the port's."""
import filecmp

import pytest
import torch

from radbench import inputs, solve
from radbench.reference import rte


@pytest.mark.parametrize("kind", sorted(inputs.KINDS))
def test_frozen_ckd_writer_is_the_ports(tmp_path, kind):
    from ecckd_tpu_torch.io.synthetic import write_synthetic_ckd
    inputs.write_ckd(str(tmp_path / "frozen.nc"), kind, 7)
    write_synthetic_ckd(str(tmp_path / "port.nc"), kind, seed=7)
    assert filecmp.cmp(tmp_path / "frozen.nc", tmp_path / "port.nc",
                       shallow=False)


@pytest.mark.parametrize("config_name", ["ecckd12_l60_rfmip",
                                         "ecckd12_l137_ifs"])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_reference_matches_the_ports_torch_path_f64(tmp_path, config_name,
                                                   n_angles):
    """LW and SW, every level, on each configuration's generator: the
    reference and the port's torch route at float64 agree to 1e-10 of
    the band flux scale."""
    from radbench import run
    from ecckd_tpu_torch import pipeline
    from ecckd_tpu_torch.models.loader import load_ckd_model
    _, config = run.load_cell({"ecckd12_l60_rfmip": "l60_batch",
                               "ecckd12_l137_ifs": "l137_batch"}[config_name])
    paths = solve.write_ckd_files(config, str(tmp_path))
    b = inputs.make_batch(40, config["nlay"], inputs.generator(5, "cpu"),
                          "cpu")
    assert bool((b["sza"] >= 90).any()) and bool((b["sza"] < 90).any())
    lw, sw = solve.read_reference_ckd(paths)
    ref = rte.fluxes(lw, sw, b, n_angles, block=16)
    d = lambda x: x.double()
    b64 = {k: d(v) for k, v in b.items() if k != "concs"}
    b64["concs"] = {k: d(v) for k, v in b["concs"].items()}
    models = [load_ckd_model(paths[k], dtype=torch.float64)
              for k in ("lw", "sw")]
    f_lw, f_sw = pipeline.lw_sw_fluxes(
        *models, b64["plev"], b64["tlay"], b64["tlev"], b64["tsfc"],
        b64["emis"], solve.gas_concs(b64), b64["alb"], b64["tsi"],
        b64["sza"], n_gauss_angles=n_angles, backend="torch")
    port = (f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn)
    for band in (0, 2):
        scale = float(ref[band].abs().max().clamp(min=ref[band + 1].abs()
                                                  .max()))
        assert scale > 100.0
        for k in (band, band + 1):
            assert float((ref[k] - port[k]).abs().max()) <= 1e-10 * scale


def test_night_columns_read_zero_sw():
    from radbench.reference import ckd  # noqa: F401
    b = inputs.make_batch(200, 8, inputs.generator(3, "cpu"), "cpu")
    night = b["sza"] >= rte.NIGHT_SZA
    assert 0 < int(night.sum()) < 200


def test_batches_repeat_per_seed_and_differ_across_seeds():
    a = inputs.make_batch(16, 8, inputs.generator(2 ** 31 + 3, "cpu"), "cpu")
    b = inputs.make_batch(16, 8, inputs.generator(2 ** 31 + 3, "cpu"), "cpu")
    c = inputs.make_batch(16, 8, inputs.generator(2 ** 31 + 4, "cpu"), "cpu")
    assert torch.equal(a["tsfc"], b["tsfc"]) and torch.equal(
        a["concs"]["h2o"], b["concs"]["h2o"])
    assert not torch.equal(a["tsfc"], c["tsfc"])
