"""PyTorch port: the RFMIP physics-index-2 deployment (3 Gauss angles) as
the benchmark runs it, against the benchmark's plain float64 reference.

The configuration is the one the cell ``l60_3ang`` names
(radbench/configs/ecckd12_l60_rfmip_p2.json), loaded by the cell's name;
its ckd files are written from their seeds, and a small batch of its
60-layer columns is drawn with the benchmark's own generator.  The port's
``lw_sw_fluxes`` on its torch route, at the configuration's angles, is
held against ``radbench/reference``:

* at float64 within 1e-10 of the band's flux scale, the tolerance of
  radbench/tests/test_radbench_reference.py (both run the same f64
  arithmetic, reordered);
* at float32 within 5e-5 of the band's flux scale, the chip-parity metric
  the CUDA kernels are held to (tools/chip_parity.py): the float32 path
  loses digits in the sweeps' recurrences and near the two-stream
  resonance, and reads a few 1e-7 here;
* at one angle the same float64 comparison fails on the LW band: the
  comparison tells the deployment's quadrature from physics index 1's.

This file imports nothing of the JAX package.
"""
import pytest
import torch

from radbench import inputs, run, solve
from radbench.reference import rte
from ecckd_tpu_torch import pipeline
from ecckd_tpu_torch.models.loader import load_ckd_model

torch.set_num_threads(2)
CELL = "l60_3ang"
NCOL = 16
F64_TOL = 1e-10
F32_TOL = 5e-5
SEEDS = [5, 2 ** 31 + 17, 2 ** 33 + 3]


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """(configuration, ckd paths, reference ckd (lw, sw))."""
    _, config = run.load_cell(CELL)
    paths = solve.write_ckd_files(
        config, str(tmp_path_factory.mktemp("ckd_p2")))
    return config, paths, solve.read_reference_ckd(paths)


@pytest.fixture(scope="module")
def reference(deployment):
    """seed -> (batch, reference fluxes at the configuration's angles)."""
    config, _, (lw, sw) = deployment
    out = {}

    def get(seed):
        if seed not in out:
            b = inputs.make_batch(NCOL, config["nlay"],
                                  inputs.generator(seed, "cpu"), "cpu")
            out[seed] = b, rte.fluxes(lw, sw, b, config["n_gauss_angles"],
                                      block=NCOL)
        return out[seed]
    return get


def port_fluxes(paths: dict, b: dict, dtype, n_angles: int) -> tuple:
    """The port's (lw_up, lw_dn, sw_up, sw_dn) on its torch route."""
    cast = lambda x: x.to(dtype)
    bt = {k: cast(v) for k, v in b.items() if k != "concs"}
    bt["concs"] = {k: cast(v) for k, v in b["concs"].items()}
    models = [load_ckd_model(paths[k], dtype=dtype) for k in ("lw", "sw")]
    f_lw, f_sw = pipeline.lw_sw_fluxes(
        *models, bt["plev"], bt["tlay"], bt["tlev"], bt["tsfc"], bt["emis"],
        solve.gas_concs(bt), bt["alb"], bt["tsi"], bt["sza"],
        n_gauss_angles=n_angles, backend="torch")
    return f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn


def band_errors(ref: tuple, got: tuple) -> list:
    """Per band (LW, SW): max |got - ref| over both directions and every
    level, over the band's flux scale."""
    errs = []
    for band in (0, 2):
        scale = float(max(ref[band].abs().max(), ref[band + 1].abs().max()))
        assert scale > 100.0
        errs.append(max(float((g.double() - r).abs().max())
                        for g, r in zip(got[band:band + 2],
                                        ref[band:band + 2])) / scale)
    return errs


def test_the_cell_runs_the_deployment_at_three_angles(deployment):
    config, _, _ = deployment
    assert (config["name"], config["n_gauss_angles"], config["nlay"],
            config["precision"], config["top_at_1"]) == (
        "ecckd12_l60_rfmip_p2", 3, 60, "float32", True)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, F64_TOL),
                                        (torch.float32, F32_TOL)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_reference_at_three_angles(deployment, reference,
                                                    seed, dtype, tol):
    config, paths, _ = deployment
    b, ref = reference(seed)
    assert bool((b["sza"] >= rte.NIGHT_SZA).any())
    got = port_fluxes(paths, b, dtype, config["n_gauss_angles"])
    for g in got:
        assert g.dtype == dtype and tuple(g.shape) == (NCOL,
                                                        config["nlay"] + 1)
    lw_err, sw_err = band_errors(ref, got)
    assert lw_err <= tol and sw_err <= tol, (lw_err, sw_err)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_angle_fails_the_three_angle_comparison(deployment, reference,
                                                    seed):
    """Physics index 1's quadrature misses the reference of index 2 by
    orders of magnitude more than the f64 tolerance on the LW band; the SW
    band, which takes no angles, still matches."""
    _, paths, _ = deployment
    b, ref = reference(seed)
    lw_err, sw_err = band_errors(ref, port_fluxes(paths, b, torch.float64,
                                                  1))
    assert lw_err > 1e4 * F64_TOL, lw_err
    assert sw_err <= F64_TOL, sw_err
