"""PyTorch port: RFMIP at float64, the deployment the cell ``l60_f64_batch``
names (radbench/configs/ecckd12_l60_rfmip_f64.json), on the CPU.

* The configuration is ``ecckd12_l60_rfmip`` at float64: every key equal
  but the name, the source, the deployment, the precision and what it
  assumes; nothing cut.
* The reference at a stated precision (radbench/reference/rte_precision.py)
  is ``rte.fluxes`` with the night rule of that precision: at float32 it is
  ``rte.fluxes`` bit for bit; at float64 a column between the two
  thresholds (90 - 2 spacing(90) in float32 and in float64) is day, every
  other column as ``rte.fluxes`` has it, and the LW is unchanged.
* The cell's traffic kind at a test's size on the CPU (the kernel has no
  CPU mode, so the port's torch route runs) is ``correct``, and its held
  answers are float64.
* ``lwsw_f64_roofline`` reads the frozen count at the float64 peaks.

This file imports nothing of the JAX package.
"""
import time

import numpy as np
import pytest
import torch

from radbench import count, inputs, run, solve
from radbench.reference import rte, rte_precision

torch.set_num_threads(2)
CELL = "l60_f64_batch"


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """(configuration, reference ckd (lw, sw))."""
    _, config = run.load_cell(CELL)
    paths = solve.write_ckd_files(
        config, str(tmp_path_factory.mktemp("ckd_f64")))
    return config, solve.read_reference_ckd(paths)


def test_the_configuration_is_rfmip_at_float64():
    _, config = run.load_cell(CELL)
    _, base = run.load_cell("l60_batch")
    differ = {k for k in set(config) | set(base)
              if config.get(k) != base.get(k)}
    assert differ == {"name", "source", "deployment", "precision",
                      "assumed"}
    assert (config["precision"], base["precision"]) == ("float64",
                                                         "float32")
    assert config["reduced"] == [] and config["nlay"] == 60
    assert any("widened to float64" in a for a in config["assumed"])


def test_night_thresholds_follow_the_precision():
    s32, s64 = (rte_precision.night_sza(p) for p in ("float32", "float64"))
    assert s32 == rte.NIGHT_SZA
    assert s32 < s64 < 90.0
    assert s64 == 90.0 - 2.0 * float(np.spacing(90.0))


def test_the_night_rule_at_float64_against_rte(deployment):
    """Columns either side of both thresholds: at float32 the copy is
    ``rte.fluxes`` bit for bit; at float64 only the columns between the
    thresholds change (day: SW nonzero, where rte zeroes them)."""
    config, (lw, sw) = deployment
    s32, s64 = (rte_precision.night_sza(p) for p in ("float32", "float64"))
    sza = torch.tensor([45.0, np.nextafter(s32, 0.0), s32,
                        0.5 * (s32 + s64), np.nextafter(s64, 0.0), s64,
                        90.0, 100.0], dtype=torch.float64)
    b = inputs.make_batch(len(sza), 12, inputs.generator(7, "cpu"), "cpu")
    b = {k: (v.double() if k != "concs" else
             {g: x.double() for g, x in v.items()}) for k, v in b.items()}
    b["sza"] = sza
    ref = rte.fluxes(lw, sw, b, 1, block=4)
    at32 = rte_precision.fluxes(lw, sw, b, 1, "float32", block=4)
    at64 = rte_precision.fluxes(lw, sw, b, 1, "float64", block=4)
    assert all(torch.equal(x, y) for x, y in zip(ref, at32))
    assert all(torch.equal(x, y) for x, y in zip(ref[:2], at64[:2]))
    day32 = (sza < s32).tolist()
    day64 = (sza < s64).tolist()
    assert day32 == [True, True] + [False] * 6
    assert day64 == [True, True, True, True, True] + [False] * 3
    for c in range(len(sza)):
        for k in (2, 3):
            if day32[c]:
                assert torch.equal(at64[k][c], ref[k][c])
            if not day64[c]:
                assert not at64[k][c].any() and not ref[k][c].any()
            if day64[c] and not day32[c]:
                assert not ref[k][c].any()
                assert bool((at64[k][c] != 0).any()), (c, k)


def test_the_cell_runs_correct_on_the_cpu():
    """``batch_f64`` at a test's size through the harness's own
    ``run_cell`` (the port's torch route on the CPU): correct, the held
    answers in float64 and far inside the cell's limit, the traced run's
    roofline reader silent without a card's kernels."""
    from radbench.tests.helpers import SEED, SMALL
    from radbench.traffic import batch_f64
    cell, config = run.load_cell(CELL)
    cell["params"].update(SMALL["batch"])
    held = {}
    answers = batch_f64.Traffic.answers

    def keep(self):
        held["answers"] = answers(self)
        return held["answers"]

    batch_f64.Traffic.answers = keep
    try:
        r = run.run_cell(CELL, cell, config, SEED, 0.3, False, ["cpu"],
                         t_start=time.perf_counter())
    finally:
        batch_f64.Traffic.answers = answers
    assert r["correct"] and r["failed"] == 0
    assert r["check"]["flux_err_p99"]["value"] <= 1e-3 * cell["limits"][
        "flux_err_p99"]
    assert set(r["metrics"]) == {"columns_per_s", "setup_s"}
    outs = [o for _, group in held["answers"] for out in group for o in out]
    assert outs and all(o.dtype == torch.float64 for o in outs)
    b, _ = held["answers"][0]
    assert b["tlay"].dtype == torch.float64


def test_the_f64_roofline_reads_the_f64_peaks():
    import importlib.util
    import types
    from pathlib import Path
    path = Path(run.__file__).parent / "metrics" / "lwsw_f64_roofline.py"
    spec = importlib.util.spec_from_file_location("f64_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.PEAK_F64_FLOPS == 34e12
    window = types.SimpleNamespace(units=4, kernel_s=lambda: 0.05)
    ops = dict(ops=51.4e9 * 8, bytes=162e6 * 8)
    got = mod.read(types.SimpleNamespace(trace=window, work=ops))
    least = max(ops["ops"] / 34e12, 2 * ops["bytes"] / count.PEAK_HBM_BYTES)
    assert got == pytest.approx(100.0 * 4 * least / 0.05)
    assert least == ops["ops"] / 34e12            # operations bound it
    assert mod.read(types.SimpleNamespace(trace=None, work=ops)) is None


def test_kernel_bound_at_f64_is_the_f64_roofline_count(deployment, tmp_path):
    """chip_smoke.kernel_bound on float64 inputs: the same operations as
    the frozen count, its bytes at 8 B a value (the count's twice) and
    the time at the FP64 peak, which ``lwsw_f64_roofline`` reads too."""
    import chip_smoke
    from ecckd_tpu_torch.gases import GasConcs
    from ecckd_tpu_torch.models.loader import load_ckd_model
    from ecckd_tpu_torch.ops.cuda import plan
    config, (lw, sw) = deployment
    paths = solve.write_ckd_files(config, str(tmp_path))
    ncol, nlay, f64 = 256, 60, torch.float64
    b = inputs.make_batch(ncol, nlay, inputs.generator(1, "cpu"), "cpu")
    b = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
         else v for k, v in b.items()}
    concs = solve.gas_concs(b)
    concs = GasConcs(values=tuple(v.double() for v in concs.values),
                     names=concs.names)
    lw_m, sw_m = (load_ckd_model(paths[k], dtype=f64) for k in ("lw", "sw"))
    emis = b["emis"][:, None].expand(ncol, lw_m.ngpt)
    prep = plan.prepare(lw_m, sw_m, b["plev"], b["tlay"], b["tlev"],
                        b["tsfc"], emis, concs, b["alb"], b["tsi"], b["sza"],
                        1)
    bound = chip_smoke.kernel_bound(prep)
    work = count.lwsw_work(lw, sw, solve.gas_sizes(b), ncol, nlay, 1)
    assert bound["ops"] == work["ops"]
    assert bound["bytes"] == 2 * work["bytes"]
    assert bound["bound_ms"] == pytest.approx(1e3 * max(
        work["ops"] / chip_smoke.PEAK_F64_FLOPS,
        2 * work["bytes"] / chip_smoke.PEAK_HBM_BYTES), rel=1e-12)
    assert chip_smoke.PEAK_F64_FLOPS == 34e12
