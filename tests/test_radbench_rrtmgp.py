"""The RRTMGP-band deployment ``ecckd12_l60_rrtmgp`` and its cell
``l60_rrtmgp_batch`` on the CPU.

* The banded reference (``radbench/reference/rte_banded.py``) against the
  port's torch path at float64 on ``write_ckd``'s lw_rrtmgp (36 g-points
  in 16 bands) + sw_wide, 32 columns x 60 layers, with the emissivity
  given per band: within 1e-10 of each band's flux scale.  The float64
  solves differ only by rounding (the reference's own order of sums and
  library calls); the port's torch path in float32 reads 1e-7 and more
  there, so the bound fails a float32 solve.
* Two bands' emissivities swapped in the program's input alone: the
  comparison fails, by the bound and by the cell's limit.
* The traffic kind's warm-up check of the emissivity a launch got.
* K1's staging plan at 36 LW g-points, nlay 60: the split route in two
  blocks of 512 threads per SM, the plan the cell's warm-up asserts.
* Through the harness's own ``run_cell`` at a test's size (the port's
  torch route on the CPU) the cell is ``correct``.
* BENCHMARK.json: one new configuration and cell, on the four metric
  lists of a batch cell.

This file imports nothing of the JAX package.
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from radbench import check, inputs, run, solve
from radbench.reference import rte_banded
from radbench.traffic import batch_banded

torch.set_num_threads(2)
CELL, CONFIG = "l60_rrtmgp_batch", "ecckd12_l60_rrtmgp"
BENCH = json.loads((Path(run.__file__).parent.parent
                    / "BENCHMARK.json").read_text())
TOL = 1e-10
H100 = (232_448, 233_472)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The configuration's files, a 32 x 60 batch with a banded
    emissivity drawn after it, the file's bands, the reference's models
    and fluxes, and the port's models at float64."""
    from ecckd_tpu_torch.models.loader import load_ckd_model
    _, config = run.load_cell(CELL)
    paths = solve.write_ckd_files(config, str(tmp_path_factory.mktemp("ckd")))
    gen = inputs.generator(2 ** 31 + 5, "cpu")
    b = inputs.make_batch(32, config["nlay"], gen, "cpu")
    bands = rte_banded.band_of_gpt(paths["lw"])
    b["emis"] = batch_banded.banded_emissivity(32, int(bands.max()) + 1, gen,
                                               "cpu")
    lw, sw = solve.read_reference_ckd(paths)
    ref = rte_banded.fluxes(lw, sw, b, config["n_gauss_angles"], bands,
                            block=16)
    models = {dt: [load_ckd_model(paths[k], dtype=dt) for k in ("lw", "sw")]
              for dt in (torch.float32, torch.float64)}
    return dict(config=config, b=b, bands=bands, ref=ref, models=models)


def port_fluxes(case, emis, dtype=torch.float64):
    from ecckd_tpu_torch import pipeline
    b = case["b"]
    d = lambda x: x.to(dtype)
    bd = {k: d(v) for k, v in b.items() if k != "concs"}
    bd["concs"] = {k: d(v) for k, v in b["concs"].items()}
    f_lw, f_sw = pipeline.lw_sw_fluxes(
        *case["models"][dtype], bd["plev"], bd["tlay"], bd["tlev"],
        bd["tsfc"], d(emis), solve.gas_concs(bd), bd["alb"], bd["tsi"],
        bd["sza"], n_gauss_angles=case["config"]["n_gauss_angles"],
        backend="torch")
    return (f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn)


def errors(ref, got):
    """max |got - ref| / the band's flux scale, per output."""
    out = []
    for band in (0, 2):
        scale = max(float(ref[band].abs().max()),
                    float(ref[band + 1].abs().max()))
        assert scale > 100.0
        out += [float((got[k].double() - ref[k]).abs().max()) / scale
                for k in (band, band + 1)]
    return out


def test_the_file_has_36_gpoints_in_16_bands(case):
    bands = case["bands"]
    assert bands.shape == (36,) and bands.min() == 0 and bands.max() == 15
    assert list(np.bincount(bands)) == [3, 3, 3] + [2] * 12 + [3]
    assert tuple(case["b"]["emis"].shape) == (32, 16)
    assert bool((case["b"]["emis"] >= 0.9).all()) and bool(
        (case["b"]["emis"] <= 1.0).all())


def test_reference_matches_the_ports_torch_path_f64(case):
    """Every level of all four outputs within TOL; and the same solve in
    float32 fails TOL, so the bound is tight enough to catch a float32
    reference."""
    ref = case["ref"]
    assert bool((case["b"]["sza"] >= 90).any()) and bool(
        (case["b"]["sza"] < 90).any())
    assert max(errors(ref, port_fluxes(case, case["b"]["emis"]))) <= TOL
    f32 = errors(ref, port_fluxes(case, case["b"]["emis"], torch.float32))
    assert min(f32[:2]) > TOL


def test_swapped_bands_fail_the_comparison(case):
    """The emissivities of two bands swapped in the program's input alone:
    the LW fluxes leave the bound, and the cell's check fails."""
    emis = case["b"]["emis"]
    swapped = emis.clone()
    swapped[:, [3, 10]] = emis[:, [10, 3]]
    got = port_fluxes(case, swapped)
    assert errors(case["ref"], got)[0] > 1e3 * TOL
    cell, _ = run.load_cell(CELL)
    verdict = check.judge([(case["b"], [got])], lambda b: case["ref"],
                          batch_banded.Traffic.OUTPUTS, cell["limits"])
    assert not verdict["correct"]
    same = check.judge([(case["b"], [port_fluxes(case, emis)])],
                       lambda b: case["ref"], batch_banded.Traffic.OUTPUTS,
                       cell["limits"])
    assert same["correct"]


def test_the_warm_up_check_of_the_launchs_emissivity(case):
    emis, bands = case["b"]["emis"], case["bands"]
    index = torch.as_tensor(bands)
    batch_banded.check_banded(emis[:, index], emis, bands)
    with pytest.raises(RuntimeError, match="one value a column"):
        flat = emis[:, :1].expand(-1, 36).contiguous()
        batch_banded.check_banded(flat, flat[:, :16], bands)
    swapped = emis.clone()
    swapped[:, [3, 10]] = emis[:, [10, 3]]
    with pytest.raises(RuntimeError, match="not the banded"):
        batch_banded.check_banded(swapped[:, index], emis, bands)


def test_k1s_plan_at_36_gpoints_is_the_cells():
    """K1's block shape at lw_rrtmgp + sw_wide under the RFMIP gases, nlay
    60, one angle, float32, at an H100's limits: whole columns (59,512 B)
    leave one block of 1024 threads per SM (2 columns); split, two blocks
    of two columns of 33,592 B each and 512 threads (4 columns, 8 sweep
    warps per SM), with the parameter stage's own place 39,832 B, and
    with one LW sweep warp per g-chunk in each set (the second warp's
    accumulators) 40,320 B: 12 sweep warps and 20 optics warps per SM.
    The rule follows the kernel's lane layout
    (``staged.pairs``, csrc/common.cuh PAIRS): where the instantiation
    keeps the g-chunk loop, and at 2-4 angles, it is the 32-g-point one;
    the chunk warps only where the second warp's accumulators leave the
    plan's C, blocks per SM and parameter stage as they were."""
    from ecckd_tpu_torch.ops.cuda import staged
    blocks, slots, sets = staged.SHAPES["lwsw"]
    plan = lambda nlay, n_ang=1, gases=(7, 1), **kw: staged.stage_plan(
        nlay, 36, 27, n_ang, gases, (5, 1), *H100, blocks_per_sm=blocks,
        max_slots=slots, sets=sets, **kw)
    p = plan(60)
    assert (p.route, p.slots, p.sets, p.threads) == ("split", 2, 2, 512)
    assert (p.sm_blocks, p.prm_stage, p.bytes_per_column,
            p.slice_floats, p.lw_warps) == (2, True, 40320, 6480, 2)
    assert p.report == ("split, C = 2, S = 2, 512 threads, 2 blocks and 4 "
                        "columns per SM, stage on, 2 LW sweep warps an "
                        "angle (one per g-chunk)")
    assert plan(60, lw_warps=1).bytes_per_column == 39832
    assert plan(60, lw_warps=1).report == (
        "split, C = 2, S = 2, 512 threads, 2 blocks and 4 columns per SM, "
        "stage on")
    assert plan(60, param_stage=False, lw_warps=1).bytes_per_column == 33592
    assert plan(60, param_stage=False).lw_warps == 2
    # Where the second warp's accumulators would cost the stage (nlay 87,
    # 174-175) or the block's two columns (103, 206-208), the pairs stay;
    # where the stage is declined anyway (88-102, 176-205) they do not.
    for nlay, warps, stage, threads in ((59, 2, True, 512),
                                        (86, 2, True, 512),
                                        (87, 1, True, 512),
                                        (91, 2, False, 512),
                                        (103, 1, False, 512),
                                        (118, 2, True, 1024),
                                        (137, 2, True, 1024),
                                        (173, 2, True, 1024),
                                        (175, 1, True, 1024),
                                        (190, 2, False, 1024),
                                        (206, 1, False, 1024)):
        q = plan(nlay)
        assert (q.route, q.lw_warps, q.prm_stage, q.threads, q.slots) == (
            "split", warps, stage, threads, 2), nlay
        assert q.sm_blocks * (q.shared_bytes + 1024) <= H100[1]
        one = plan(nlay, lw_warps=1)
        assert one.prm_stage == q.prm_stage and one.threads == q.threads
        if warps == 1:
            assert one == q
            with pytest.raises(ValueError):
                plan(nlay, lw_warps=2)
    # Never at 2-4 angles, whole columns, float64 or a run-time shape;
    # asked for there, it raises.
    for args, kw in (((60, 3), {}), ((60,), dict(split=False)),
                     ((80,), dict(word_bytes=8)), ((60,), dict(gases=(4, 1)))):
        assert plan(*args, **kw).lw_warps == 1
        with pytest.raises(ValueError):
            plan(*args, **kw, lw_warps=2)
    whole = plan(60, split=False)
    assert (whole.route, whole.threads, whole.sm_blocks,
            whole.bytes_per_column) == ("shared", 1024, 1, 59512)
    # Where whole columns keep two blocks per SM, they stay whole.
    assert (plan(58).route, plan(58).sm_blocks) == ("shared", 2)
    assert (plan(59).route, plan(59).sm_blocks) == ("split", 2)
    # The g-chunk loop: float64 (nlay 47 whole in one block of 768), a
    # run-time shape (another gas set, another temperature grid); and 2-4
    # angles: whole columns, one block of 1024 threads per SM.
    nt = staged.SHIPPED_NT
    assert staged.pairs(36, 27, (7, 1), (5, 1), nt, 4)
    assert staged.pairs(36, 0, (7, 1), (0, 0), nt, 4)          # K3
    assert not any((staged.pairs(32, 27, (7, 1), (5, 1), nt, 4),
                    staged.pairs(36, 27, (7, 1), (5, 1), nt, 8),
                    staged.pairs(36, 27, (7, 1), (4, 1), nt, 4),
                    staged.pairs(36, 27, (7, 1), (5, 1), nt - 1, 4)))
    f64 = plan(47, word_bytes=8)
    assert (f64.route, f64.threads, f64.sm_blocks) == ("shared", 768, 1)
    for other in (plan(60, gases=(4, 1)), plan(60, n_t=5), plan(60, 2),
                  plan(60, 3), plan(60, 4)):
        assert (other.route, other.threads, other.sm_blocks) == (
            "shared", 1024, 1)
    # K3 at 36 g-points keeps its plan: nothing to split.
    lw_blocks, lw_slots, lw_sets = staged.SHAPES["lw"]
    k3 = staged.stage_plan(60, 36, 0, 1, (7, 1), (0, 0), *H100,
                           blocks_per_sm=lw_blocks, max_slots=lw_slots,
                           sets=lw_sets)
    assert (k3.route, k3.threads, k3.prm_floats) == ("shared", 512, 18 * 60)


def test_the_cell_runs_correct_on_the_cpu():
    from radbench.tests.helpers import SEED, SMALL
    cell, config = run.load_cell(CELL)
    cell["params"].update(SMALL["batch"])
    r = run.run_cell(CELL, cell, config, SEED, 0.3, False, ["cpu"],
                     t_start=time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert r["metrics"]["columns_per_s"]["value"] > 0
    assert r["check"]["flux_err_p99"]["value"] <= cell["limits"][
        "flux_err_p99"]


def test_the_manifest_adds_one_configuration_and_one_cell():
    (cfg,) = [c for c in BENCH["configs"] if c["name"] == CONFIG]
    (cell,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "batch_banded", 1)
    # Each at the end of its list as it added them, after the four
    # configurations and seven cells before them.
    assert cfg["reduced"] == [] and BENCH["configs"].index(cfg) == 4
    assert BENCH["workloads"].index(cell) == 7
    lists = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
             if CELL in m.get("workloads", [])}
    assert lists == {"columns_per_s", "lwsw_roofline", "step_mfu",
                     "device_idle_share.batch", "lwsw_optics_wait_share",
                     "lwsw_lw_sweep_wait_share", "lwsw_sw_sweep_wait_share"}
    _, config = run.load_cell(CELL)
    assert (config["ckd"]["lw"]["kind"], config["ckd"]["sw"]["kind"],
            config["nlay"], config["n_gauss_angles"],
            config["precision"]) == ("lw_rrtmgp", "sw_wide", 60, 1,
                                     "float32")
