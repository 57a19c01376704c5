"""The one-card stream cell ``l60_stream_1card`` on the CPU.

* BENCHMARK.json gives each pair of configuration and traffic once: the
  one-card cell runs ``ecckd12_l60_rfmip`` under ``stream_1card``, the
  ``stream`` kind under a name of its own, since the four-card stream
  runs the same configuration under ``stream``.
* At a test's size through the harness's own ``run_cell`` (the port's
  torch route on one CPU piece) the cell is ``correct``, with its passes'
  columns delivered and its stream metrics read.

This file imports nothing of the JAX package.
"""
import json
import time
from pathlib import Path

import torch

from radbench import run

torch.set_num_threads(2)
CELL = "l60_stream_1card"
BENCH = json.loads((Path(run.__file__).parent.parent
                    / "BENCHMARK.json").read_text())


def test_each_pair_of_configuration_and_traffic_is_given_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    (cell,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "ecckd12_l60_rfmip", "stream_1card", 1)


def test_the_one_card_traffic_is_the_stream_kind():
    from radbench.traffic import stream, stream_1card
    assert stream_1card.Traffic is stream.Traffic
    one, _ = run.load_cell(CELL)
    four, _ = run.load_cell("l60_stream_4card_c262k")
    assert one["config"] == four["config"]
    assert one["params"]["chunk"] * 4 == four["params"]["chunk"]
    assert (one["params"]["chunk"] * one["params"]["n_chunks"]
            == four["params"]["chunk"] * four["params"]["n_chunks"])


def test_the_cell_runs_correct_on_the_cpu():
    from radbench.tests.helpers import SEED, SMALL
    cell, config = run.load_cell(CELL)
    cell["params"].update(SMALL["stream"])
    r = run.run_cell(CELL, cell, config, SEED, 0.3, False, ["cpu"],
                     t_start=time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert r["metrics"]["delivered_columns_per_s"]["value"] > 0
    assert r["check"]["flux_err_p99"]["value"] <= cell["limits"][
        "flux_err_p99"]
