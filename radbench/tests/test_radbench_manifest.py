"""BENCHMARK.json against the manifest's rules of form, and the harness
finding every cell's files by name."""
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from radbench import run

ROOT = Path(run.__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["radbench"]
    assert BENCH["command"] == ["python3", "-m", "radbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_text_fields():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.fullmatch(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"),
                          entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (entry["name"], key)
            if "unit" in entry:
                assert UNIT.fullmatch(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    metrics = [n for is_metric, n in names if is_metric]
    assert len(set(metrics)) == len(metrics)
    for section in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[section]]
        assert len(set(ns)) == len(ns)


def test_entries_have_just_the_manifest_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("radbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert [m["bound"] for m in BENCH["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_cells_and_configs_are_found_by_name():
    """Every cell's file, configuration, traffic kind and per-layer
    readers are found from the names in BENCHMARK.json alone."""
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        cell, config = run.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"],
                cell["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
        assert config["name"] == w["config"]
        c = configs[w["config"]]
        assert (ROOT / c["file"]).is_file()
        assert config["reduced"] == c["reduced"]
        assert config["source"] == c["source"]
        used.add(w["config"])
        traffic = importlib.import_module(f"radbench.traffic.{w['traffic']}")
        assert hasattr(traffic, "Traffic")
        assert set(cell["limits"]) == {"flux_err_p99"}
        for m in run.cell_metrics(BENCH, w["name"], "per_layer"):
            assert callable(run.reader(m["name"]))
    assert used == set(configs)


def test_held_calls_cover_every_variant():
    """A call cell's ``check_every`` has no factor in common with its
    ``variants``, and a cell that breaks the rule is refused at set-up."""
    import math
    from radbench.tests.helpers import run_small, small_cell
    for w in BENCH["workloads"]:
        p = run.load_cell(w["name"])[0]["params"]
        if "variants" in p:
            assert math.gcd(p["check_every"], p["variants"]) == 1, w["name"]
    cell, config = small_cell("l60_batch")
    cell["params"]["check_every"] = 2
    with pytest.raises(ValueError, match="shares a factor"):
        run.run_cell("l60_batch", cell, config, 1, 0.1, False, ["cpu"])
    assert run_small("l60_batch")["correct"]


def test_the_traffic_kind_gives_the_reference_and_the_work(monkeypatch):
    """run.py takes the outputs' reference and a unit's work from the
    traffic kind, and hands a per-layer reader what it needs to count
    work of its own."""
    from radbench import solve
    from radbench.tests.helpers import run_small
    seen = {}
    reference = solve.LwSwSolve.reference

    def work(lw, sw, gases, ncol, config):
        seen["ncol"] = ncol
        return {"ops": 1.0, "bytes": 1.0}

    def reader(name):
        def read(r):
            seen["run"] = r
        return read

    monkeypatch.setattr(solve.LwSwSolve, "work", staticmethod(work))
    monkeypatch.setattr(solve.LwSwSolve, "reference", staticmethod(
        lambda lw, sw, b, config: tuple(1.01 * x for x in
                                        reference(lw, sw, b, config))))
    monkeypatch.setattr(run, "reader", reader)
    r = run_small("l60_batch", traced=True)
    assert not r["correct"]
    got = seen["run"]
    assert seen["ncol"] == got.unit_columns == 64
    assert got.work == {"ops": 1.0, "bytes": 1.0}
    assert (got.lw.ngpt, got.sw.ngpt) == (32, 27)
    assert got.gases["h2o"] == 60


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(BENCH, w["name"],
                                                    "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = run.cell_metrics(BENCH, w["name"], "per_layer")
        assert per_layer
        for m in per_layer:
            assert m["moves"] in e2e


def test_per_layer_moves_is_reported_by_all_its_cells():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in run.cell_metrics(BENCH, cell,
                                                        "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)


def test_layer_names_are_listed_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_a_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-m", "radbench.run", "--workload", "l60_batch",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_run_refuses_with_fewer_cards_than_the_cell(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "l60_stream_4card_c262k", "--seed", "1",
                  "--seconds", "1"])
    assert "4 CUDA cards" in str(e.value.code)
