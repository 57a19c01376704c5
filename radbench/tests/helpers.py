"""Shared pieces of the benchmark's CPU tests: the cells at a size a test
run holds, run on the CPU through the harness's own ``run_cell`` (the
look for a card is the one step left out)."""
from __future__ import annotations

import time

from radbench import run

SMALL = {
    "batch": dict(ncol=64, column_chunk=16, check_columns_per_chunk=2,
                  check_every=1, trace_skip=1, trace_units=2),
    "calls": dict(ncol=24, check_columns_per_chunk=4, check_every=1,
                  trace_skip=1, trace_units=3),
    "stream": dict(chunk=32, n_chunks=3, check_every=2, trace_skip=1,
                   trace_units=2),
}
SEED = 2 ** 31 + 11
CELLS = ("l60_batch", "l137_batch", "l60_rfmip_calls",
         "l60_stream_4card_c262k")


def small_cell(name: str) -> tuple:
    """(cell, configuration) of ``name`` cut to a test's size."""
    cell, config = run.load_cell(name)
    cell["params"].update(SMALL[cell["traffic"]])
    return cell, config


def run_small(name: str, traced: bool = False, seconds: float = 0.3,
              seed: int = SEED) -> dict:
    """The result line of one CPU run of cell ``name`` at a test's size,
    on as many CPU pieces as the cell has cards."""
    cell, config = small_cell(name)
    return run.run_cell(name, cell, config, seed, seconds, traced,
                        ["cpu"] * cell["chips"],
                        t_start=time.perf_counter())
