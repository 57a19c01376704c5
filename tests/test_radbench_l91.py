"""The ECMWF L91 deployment ``ecckd12_l91_ifs`` and its cells ``l91_batch``
and ``l91_jac_batch`` on the CPU.

* The configuration is ``ecckd12_l137_ifs`` at 91 layers: the same ckd
  files, angle and precision, nothing cut.
* K1's plan at nlay 91: whole columns, C = 2 in one block of 1024 threads
  per SM, the regime no other cell reaches; with the Jacobian one more
  row a slot and the same plan.
* Through the harness's own ``run_cell`` at a test's size (the port's
  torch route on the CPU) both cells are ``correct``; the Jacobian cell
  holds six outputs a call, its J and a zero down-Jacobian, and asks for
  the Jacobian on every call.
* ``lwsw_jac_roofline`` counts the Jacobian's work on top of the frozen
  count, and reads nothing without a trace.
* BENCHMARK.json: one new configuration, two cells and one metric at the
  ends of their lists, and the new cells on the lists of the metrics
  they report.

This file imports nothing of the JAX package.
"""
import json
import time
import types
from pathlib import Path

import pytest
import torch

from radbench import count, run
from radbench.tests.helpers import SEED, SMALL
from radbench.traffic import batch_jac

torch.set_num_threads(2)
CONFIG = "ecckd12_l91_ifs"
CELLS = ("l91_batch", "l91_jac_batch")
BENCH = json.loads((Path(run.__file__).parent.parent
                    / "BENCHMARK.json").read_text())
H100 = (232_448, 233_472)


def test_the_configuration_is_l137_at_91_layers():
    _, config = run.load_cell("l91_batch")
    _, base = run.load_cell("l137_batch")
    differ = {k for k in set(config) | set(base)
              if config.get(k) != base.get(k)}
    assert differ == {"name", "source", "deployment", "nlay", "assumed"}
    assert (config["nlay"], config["reduced"]) == (91, [])
    assert "flux_up_Jac" in config["source"]
    assert len(config["source"]) <= 200


def test_k1s_plan_at_91_layers():
    from ecckd_tpu_torch.ops.cuda import staged
    blocks, slots, sets = staged.SHAPES["lwsw"]
    plan = lambda **kw: staged.stage_plan(
        91, 32, 27, 1, (7, 1), (5, 1), *H100, blocks_per_sm=blocks,
        max_slots=slots, sets=sets, **kw)
    for p, size in ((plan(), 85772), (plan(jac=True), 86140)):
        assert (p.route, p.slots, p.sets, p.threads, p.sm_blocks,
                p.prm_stage, p.bytes_per_column) == (
            "shared", 2, 2, 1024, 1, True, size)


@pytest.mark.parametrize("name", CELLS)
def test_the_cell_runs_correct_on_the_cpu(name):
    cell, config = run.load_cell(name)
    cell["params"].update(SMALL["batch"])
    r = run.run_cell(name, cell, config, SEED, 0.3, False, ["cpu"],
                     t_start=time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert r["metrics"]["columns_per_s"]["value"] > 0
    assert r["check"]["flux_err_p99"]["value"] < 1e-6


def test_the_jacobian_cell_holds_j_and_a_zero_pair(monkeypatch):
    seen = []
    original = batch_jac.JacProgram.__call__

    def call(self, args):
        seen.append(dict(self.kwargs))
        return original(self, args)
    monkeypatch.setattr(batch_jac.JacProgram, "__call__", call)
    cell, config = run.load_cell("l91_jac_batch")
    cell["params"].update(SMALL["batch"])
    t = batch_jac.Traffic(cell, config, _paths(config), SEED, ["cpu"])
    t.keep(0, t.program(t.args[0]))
    (_, held), = t.kept
    assert len(held) == len(t.OUTPUTS) == 6
    assert not bool(held[5].any()) and bool((held[4] > 0).all())
    assert all(k["flux_up_jac"] is True for k in seen)
    assert t.OUTPUTS[4:] == ("lw_up_jac", "lw_dn_jac")


def _paths(config):
    import tempfile
    from radbench import solve
    return solve.write_ckd_files(config, tempfile.mkdtemp())


def test_the_jacobian_roofline_counts_the_jacobians_work():
    import importlib.util
    path = Path(run.__file__).parent / "metrics" / "lwsw_jac_roofline.py"
    spec = importlib.util.spec_from_file_location("jac_roofline", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    r = types.SimpleNamespace(
        unit_columns=1000, config={"nlay": 91, "n_gauss_angles": 1},
        lw=types.SimpleNamespace(ngpt=32), work={"ops": 1e9, "bytes": 1e6},
        trace=None)
    w = m.jac_work(r)
    assert w["ops"] == 1e9 + 1000 * 32 * (14 + 92 * 2)
    assert w["bytes"] == 1e6 + 1000 * 92 * count.F32
    assert m.read(r) is None
    r.trace = types.SimpleNamespace(units=4, kernel_s=lambda: 2.0)
    assert m.read(r) == pytest.approx(100 * 4 * count.least_seconds(w) / 2)


def test_the_manifest_adds_one_configuration_two_cells_and_a_metric():
    cfg = BENCH["configs"][-1]
    assert (cfg["name"], cfg["reduced"], cfg["file"]) == (
        CONFIG, [], f"radbench/configs/{CONFIG}.json")
    assert [w["name"] for w in BENCH["workloads"][-2:]] == list(CELLS)
    for w in BENCH["workloads"][-2:]:
        assert (w["config"], w["chips"]) == (CONFIG, 1)
    assert [w["traffic"] for w in BENCH["workloads"][-2:]] == [
        "batch", "batch_jac"]
    metric = BENCH["per_layer"][-1]
    assert metric == {"name": "lwsw_jac_roofline", "unit": "%",
                      "better": "higher", "source": "device_trace",
                      "layer": "kernels", "moves": "columns_per_s",
                      "workloads": ["l91_jac_batch"]}
    lists = {cell: {m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]
                    if cell in m.get("workloads", [])} for cell in CELLS}
    shared = {"columns_per_s", "device_idle_share.batch",
              "lwsw_optics_wait_share", "lwsw_lw_sweep_wait_share",
              "lwsw_sw_sweep_wait_share"}
    assert lists == {"l91_batch": shared | {"lwsw_roofline", "step_mfu"},
                     "l91_jac_batch": shared | {"lwsw_jac_roofline"}}
    for name in CELLS:
        cell, _ = run.load_cell(name)
        assert cell["limits"] == {"flux_err_p99": 1e-5}
        assert cell["params"] == {
            "ncol": 524288, "column_chunk": 65536, "variants": 4,
            "in_flight": 2, "check_columns_per_chunk": 14,
            "check_every": 7, "trace_skip": 4, "trace_units": 10}
