"""Run one cell of the benchmark once.

    python -m radbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run is one process.  It finds the cell's file
(``radbench/workloads/<cell>.json``), its configuration
(``radbench/configs/<config>.json``) and its traffic kind
(``radbench/traffic/<kind>.py``) by name, and which metrics to report
from ``BENCHMARK.json``.  It needs the cell's ``chips`` CUDA cards and
fails without them.  It writes the configuration's ckd files from their
seeds into a temporary directory (under ``TMPDIR``), sets up the traffic
(models, inputs made from ``--seed`` on the card, the warm-up that builds
and captures every shape the window uses), measures for ``--seconds``,
then compares the answers held from the window with the plain reference
and prints one JSON line: the end-to-end metrics with ``--trace 0``, the
per-layer metrics (``radbench/metrics/<metric>.py``, read from the traced
sub-window) with ``--trace 1``.

``setup_s`` runs from the start of this module to the start of the
window.  The last lines on standard error, and the line's last key
``check``, give each number compared beside its limit.  A run in which a
module of JAX or of the JAX package is loaded once the window has closed
prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

import torch  # noqa: E402

from radbench import check, solve, trace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ecckd_tpu")
"""Top-level module names no run may load: JAX and the JAX package."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> tuple:
    """(cell, configuration) of the cell ``name``, found by name."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    return cell, load_json(HERE / "configs" / f"{cell['config']}.json")


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that cell
    ``name`` reports: those that list it under ``workloads``, and the
    end-to-end metrics that list no cells (``setup_s``).  Every per-layer
    metric lists its cells."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if name in m.get("workloads", [name])]
    return [m for m in bench["per_layer"] if name in m["workloads"]]


def reader(metric: str):
    """The ``read(run)`` of ``radbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "radbench.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader gets: the cell, its configuration,
    the window's record (``units``, ``window_s``, ``spans``,
    ``counters``), the traced sub-window (``trace.Window``, or None
    without tracing), the work of one unit (the traffic kind's
    ``work``), the cell's devices, and what a reader needs to count work
    of its own: the ckd files as the reference reads them (``lw``,
    ``sw``), the gases' values per column and the columns of a unit."""
    cell: dict
    config: dict
    window: dict
    trace: Optional[trace.Window]
    work: dict
    devices: list
    lw: object
    sw: object
    gases: dict
    unit_columns: int


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("radbench: torch.cuda.is_available() is false; "
                         "the benchmark measures CUDA cards only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"radbench: the cell needs {chips} CUDA cards, "
                         f"{torch.cuda.device_count()} are visible")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limits(n: int) -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return [float(x) for x in out.stdout.split()[:n]] if out.returncode == 0 \
        else []


def run_cell(name: str, cell: dict, config: dict, seed: int, seconds: float,
             traced: bool, devices: list, t_start: float = T_START) -> dict:
    """One run of the cell on ``devices``; the result line's fields (see
    the module docstring)."""
    bench = manifest()
    kind = "per_layer" if traced else "end_to_end"
    metrics = cell_metrics(bench, name, kind)
    traffic = importlib.import_module(f"radbench.traffic.{cell['traffic']}")
    p = cell["params"]
    with tempfile.TemporaryDirectory() as work:
        paths = solve.write_ckd_files(config, work)
        t = traffic.Traffic(cell, config, paths, seed, devices)
        gases, unit_columns = t.gases, t.unit_columns
        tracer = trace.Tracer(traced, p["trace_skip"], p["trace_units"],
                              devices)
        launched = solve.launches()
        setup_s = time.perf_counter() - t_start
        record = t.window(seconds, tracer)
        done = solve.launches()
        print(f"# window: {record['units']} units in {record['window_s']:.6f}"
              f" s; merged-kernel launches {launched} before, {done} after",
              file=sys.stderr)
        cuda = [torch.device(d) for d in devices
                if torch.device(d).type == "cuda"]
        peak = max([torch.cuda.max_memory_allocated(d) for d in cuda] + [0])
        answers = t.answers()
        t.close()
        del t
        gc.collect()
        for d in cuda:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
        lw, sw = solve.read_reference_ckd(paths)
    solver = traffic.Traffic
    verdict = check.judge(answers,
                          lambda b: solver.reference(lw, sw, b, config),
                          solver.OUTPUTS, cell["limits"])
    run = Run(cell, config, record, tracer.window,
              solver.work(lw, sw, gases, unit_columns, config), devices,
              lw, sw, gases, unit_columns)
    values = dict(record["metrics"], setup_s=setup_s)
    out_metrics = {}
    for m in metrics:
        v = reader(m["name"])(run) if traced else values[m["name"]]
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": peak}
    if cuda:
        device["power_limit_w"] = power_limits(len(cuda))
    result = {"correct": verdict["correct"], "attempted": record["attempted"],
              "failed": verdict["failed"], "metrics": out_metrics,
              "device": device}
    if traced and tracer.window is not None:
        w = tracer.window
        keys = sorted(w.device_events) or [0]
        device["busy_s"] = sum(w.busy_s(k) for k in keys) / len(devices)
        device["window_s"] = w.seconds
        result["breakdown"] = trace.breakdown(w)
    print("# check: largest error per output " + ", ".join(
        f"{k} {v:.6e}" for k, v in verdict["per_output"].items())
        + f"; {verdict['held']} answers held, {verdict['columns']} columns"
        f", {verdict['failed']} answers failed", file=sys.stderr)
    for k, n in verdict["numbers"].items():
        print(f"check: {k} {n['value']:.6e} limit {n['limit']:.6e}",
              file=sys.stderr)
    result["check"] = verdict["numbers"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m radbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config = load_cell(args.workload)
    require_cards(cell["chips"])
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    result = run_cell(args.workload, cell, config, args.seed, args.seconds,
                      bool(args.trace), devices)
    bad = forbidden_modules()
    if bad:
        print(f"radbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
