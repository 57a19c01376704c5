#!/usr/bin/env python3
"""Throughput benchmark of the PyTorch/CUDA port (``ecckd_tpu_torch``) on
one NVIDIA card: the port's counterpart of bench.py.

    python bench_cuda.py [--mode headline|configs|cpu_baseline] [--fast]
                         [--ncol N]

Each mode prints one JSON line on stdout (notes on stderr).

* ``headline`` (default): the merged LW+SW solve as a user repeats it,
  ``capture.jit(pipeline.lw_sw_fluxes)`` (bench.py's ``jax.jit`` step),
  at 524,288 columns x 60 layers, 1 Gauss angle, float32, lw_fsck +
  sw_wide, ``column_chunk`` 65,536 (``COLUMN_CHUNK``, the kernels'
  ``DEFAULT_COLUMN_CHUNK``: eight launches of the merged kernel per step;
  every mode runs at this chunk).  bench.py's protocol:
  2 warm-up steps (the eager call and the capture), then 20 replayed
  steps back to back, each step's scalar from both outputs summed on the
  card and read with one ``.item()``, the barrier.  The metric is
  ``rfmip_lw+sw_flux_solve_throughput`` in columns/s/chip, and
  ``vs_baseline`` is over ``CPU_SERIAL_BASELINE_COLS_PER_SEC``.
* ``configs``: bench.py's six configurations (``CONFIGS``) at 65,536 x 60
  through ``capture.jit`` of ``lw_sw_fluxes`` or ``lw_fluxes``: every case
  warmed (eager call, capture), then the best of 3 interleaved epochs of
  8 steps per case.
* ``cpu_baseline``: the headline's step on the CPU at float64 (the torch
  route), one thread, 2048 columns, 1 warm-up and 3 steps: the serial
  execution model of the Fortran reference.  The median of three runs in
  one session on the card machine's host is pinned below, with their
  range.

``--fast`` runs a mode in the fast table mode
(``config.set_mxu_precision("bf16")``, the kernels' bf16 tables).

The gate.  Before any timing, headline and configs run each timed case's
own program (the same ``capture.jit`` callable with the same keyword
arguments, three calls: eager, capture, replay) on the adversarial batch
of tools/cuda_parity.py, 293 x 60, and hold it against the port's plain
versions at float64 on the card: max|d| / flux scale <= 5e-5 per output;
in the fast mode <= 5e-5 from the fast plain version and <= 5e-4 and > 0
from the exact one (tools/cuda_parity.py ``BOUNDS``).  Per-band errors go
to stderr.  After the timed window each case is held once more at the
shape it was timed at: one more replay of the timed graph, whose columns
at the start of every launch chunk and at the batch's end (``GATE``
columns each) go against the plain versions at float64 on the same
columns, with the same bounds (``"parity_timed"``).  A case outside its
bounds, at either stage, prints the line with ``"value": 0.0``,
``"parity_ok": false`` and ``"parity_stage"``, exits 1 and writes
nothing.  Neither stage has an off switch.

Artifacts.  Only a run at exactly the protocol (``HEADLINE``, ``CONFIGS``
sizes and steps) writes its artifact into ``artifact_dir`` (the
repository root): ``BENCH_CUDA.json``, ``BENCH_CUDA_FAST.json``,
``BENCH_CUDA_CONFIGS.json``, ``BENCH_CUDA_CONFIGS_bf16.json``, which
tools/check_cuda_perf_claims.py holds README's H100 rows to.  Every line
carries ``ncol``, ``column_chunk``, the date and ``"protocol"``; an
off-protocol run writes nothing.

No fallback hides the device: headline and configs exit non-zero without
a CUDA card; ``cpu_baseline`` is the one mode that runs on the CPU.

The ckd files are synthetic (``ecckd_tpu_torch.io.synthetic``, seed 7) at
the shipped ecCKD 1.2 files' dimensions; the shipped files are not in the
repository.  This script imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ecckd_tpu_torch import capture, config, pipeline
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.io.synthetic import (example_flux_batch,
                                          write_synthetic_ckd)
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.ops.cuda.binding import DEFAULT_COLUMN_CHUNK
from ecckd_tpu_torch.utils.profiling import card_name
from tools import cuda_parity

REPO = os.path.dirname(os.path.abspath(__file__))

# Single-thread CPU columns/s of the headline's step at float64 (the torch
# route): the median, and the range, of three runs of
# `python bench_cuda.py --mode cpu_baseline` in one session on the host CPU
# of the H100 machine, as that session's lscpu names it.
CPU_SERIAL_BASELINE_COLS_PER_SEC = 371.8036216926033
CPU_SERIAL_BASELINE_RANGE = (352.06995638835195, 387.81471508532513)
CPU_SERIAL_BASELINE_HOST = ("GenuineIntel family 6 model 207 (lscpu gives "
                            "no model name), 8 CPUs")

METRIC = "rfmip_lw+sw_flux_solve_throughput"
NLAY = 60
HEADLINE_CASE = "lw_fsck+sw_wide_1ang"
COLUMN_CHUNK = DEFAULT_COLUMN_CHUNK     # columns per launch, every mode
# The protocols: only runs at exactly these sizes and steps write the
# committed artifacts.
HEADLINE = dict(ncol=524288, steps=20, warmup=2)
CONFIGS_PROTOCOL = dict(ncol=65536, steps=8, epochs=3)
CPU_BASELINE = dict(ncol=2048, steps=3, warmup=1)
GATE = dict(ncol=293, nlay=NLAY, seed=293)

MODEL_KINDS = {"fsck": "lw_fsck", "rrtmgp": "lw_rrtmgp", "wide": "sw_wide"}
MODEL_SEED = 7

# Every timed configuration: (program, LW model, Gauss angles).  The
# configs mode times exactly the cases it gated (bench.py GATE_CASES).
CONFIGS = {
    "lw_fsck+sw_wide_1ang": ("merged", "fsck", 1),
    "lw_fsck+sw_wide_3ang": ("merged", "fsck", 3),
    "lw_rrtmgp+sw_wide_1ang": ("merged", "rrtmgp", 1),
    "lw_fsck_3ang": ("lw", "fsck", 3),
    "lw_rrtmgp_1ang": ("lw", "rrtmgp", 1),
    "lw_rrtmgp_3ang": ("lw", "rrtmgp", 3),
}


@dataclasses.dataclass
class Case:
    """One timed program: a ``capture.jit`` callable, its models and its
    keyword arguments."""
    fn: Callable
    models: tuple
    kwargs: dict

    def __call__(self, b: dict) -> List[torch.Tensor]:
        """The fluxes on batch ``b``: [lw up, lw dn] (+ [sw up, sw dn])."""
        if len(self.models) == 2:
            f_lw, f_sw = self.fn(*self.models, b["plev"], b["tlay"],
                                 b["tlev"], b["tsfc"], b["emis"], b["concs"],
                                 b["alb"], b["tsi"], b["sza"], **self.kwargs)
            return [f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn]
        f = self.fn(self.models[0], b["plev"], b["tlay"], b["tlev"],
                    b["tsfc"], b["emis"], b["concs"], **self.kwargs)
        return [f.flux_up, f.flux_dn]

    def step(self, b: dict) -> torch.Tensor:
        """One step's scalar, from every band's output (bench.py)."""
        outs = self(b)
        return sum(o[:, 0].sum() for o in outs[::2])


def card():
    """(device, nvidia-smi's name and power limit) of the card a device
    mode measures.  Without a card it exits non-zero: a CPU number must
    never pass as a card's."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_cuda: no CUDA card (torch.cuda.is_available()"
                         " is false); headline and configs measure the card,"
                         " --mode cpu_baseline is the CPU reference")
    return torch.device("cuda", torch.cuda.current_device()), card_name()


def write_models(work: str) -> Dict[str, str]:
    """The synthetic ckd files the bench runs on, written into ``work``."""
    paths = {}
    for name, kind in MODEL_KINDS.items():
        paths[name] = os.path.join(work, f"{name}.nc")
        write_synthetic_ckd(paths[name], kind, seed=MODEL_SEED)
    return paths


def load_models(paths: Dict[str, str], dtype, device) -> dict:
    return {name: load_ckd_model(path, dtype=dtype, device=device)
            for name, path in paths.items()}


def batch(ncol: int, nlay: int, dtype, device) -> dict:
    """bench.py's batch (``__graft_entry__._example_batch``, the same
    values) as tensors on ``device``."""
    b = example_flux_batch(ncol, nlay, dtype, device=device)
    out = {k: torch.as_tensor(v, device=device) for k, v in b.items()
           if k != "concs"}
    out["concs"] = b["concs"]
    return out


def build_cases(names, models: dict) -> Dict[str, Case]:
    """The cases ``names`` on ``models``: one ``capture.jit`` callable per
    program (bench.py's two ``jax.jit`` steps), shared by its cases."""
    programs = {"merged": capture.jit(pipeline.lw_sw_fluxes),
                "lw": capture.jit(pipeline.lw_fluxes)}
    cases = {}
    for name in names:
        program, lw_name, n_ang = CONFIGS[name]
        kwargs = {"n_gauss_angles": n_ang, "column_chunk": COLUMN_CHUNK}
        models_ = ((models[lw_name], models["wide"]) if program == "merged"
                   else (models[lw_name],))
        cases[name] = Case(programs[program], models_, kwargs)
    return cases


def hold(name: str, stage: str, calls, plain: Callable) -> dict:
    """The errors of ``calls`` (each one call's outputs) against the plain
    versions at float64, ``plain(table_mode)``, within the gate's bounds
    (see the module docstring); printed per band on stderr."""
    mode = config.mxu_precision()
    same = plain(mode)
    rel = [max(r) for r in zip(*(cuda_parity.flux_errors(c, same)[0]
                                 for c in calls))]
    r = {"max_rel": max(rel), "lw": max(rel[:2])}
    if len(rel) == 4:
        r["sw"] = max(rel[2:])
    finite = all(bool(torch.isfinite(o).all()) for c in calls for o in c)
    ok = finite and r["max_rel"] <= cuda_parity.SAME_MODE_BOUND
    if config.is_fast():
        exact = plain("bf16x3")
        r["vs_exact"] = max(max(cuda_parity.flux_errors(c, exact)[0])
                            for c in calls)
        ok = ok and 0.0 < r["vs_exact"] <= cuda_parity.BOUNDS[mode]
    r["ok"] = ok
    bands = " ".join(f"{k} {r[k]:.3e}" for k in ("lw", "sw") if k in r)
    print(f"# bench_cuda parity {stage} [{name}] ({mode}): max_rel "
          f"{r['max_rel']:.3e} ({bands}; bound "
          f"{cuda_parity.SAME_MODE_BOUND:.0e})"
          + (f", vs exact {r['vs_exact']:.3e} (bound "
             f"{cuda_parity.BOUNDS[mode]:.0e}, > 0)" if "vs_exact" in r
             else "") + f" {'OK' if ok else 'FAILED'}", file=sys.stderr)
    return r


def plain_of(name: str, models64: dict, b64: dict) -> Callable:
    """Case ``name``'s plain version at float64 on batch ``b64`` (the
    kernels' arguments: ``emis`` per g-point), by table mode."""
    program, lw_name, n_ang = CONFIGS[name]
    kernel = "lwsw" if program == "merged" else "lw"
    sw64 = models64["wide"] if program == "merged" else None
    return lambda table_mode: cuda_parity.solve(
        kernel, "plain", models64[lw_name], sw64, b64, n_gauss_angles=n_ang,
        mxu_mode=table_mode)


def refuse(stage: str, results: dict, device_label: str) -> None:
    """Print the failure line (bench.py's) and exit 1 if any case of
    ``results`` is outside its bounds."""
    if all(r["ok"] for r in results.values()):
        return
    print(json.dumps({"metric": METRIC, "value": 0.0,
                      "unit": "columns/s/chip", "vs_baseline": 0.0,
                      "parity_ok": False, "parity_stage": stage,
                      "parity_max_rel": max(r["max_rel"]
                                            for r in results.values()),
                      "parity_cases": {k: r["max_rel"]
                                       for k, r in results.items()},
                      "mxu_precision": config.mxu_precision(),
                      "device": device_label}))
    raise SystemExit(1)


def parity_gate(cases: Dict[str, Case], models64: dict, device,
                device_label: str) -> dict:
    """Each case's program (eager, capture, replay) on the adversarial
    batch against the plain versions at float64 on ``device``; {case:
    errors}.  Exits 1 after printing the failure line if any case is
    outside its bounds."""
    arrays, gases = cuda_parity.adversarial_batch(GATE["ncol"], GATE["nlay"],
                                                  GATE["seed"])
    results = {}
    for name, case in cases.items():
        ngpt = models64[CONFIGS[name][1]].ngpt
        b32, b64 = (cuda_parity.on_card(arrays, gases, dt, ngpt, device)
                    for dt in (torch.float32, torch.float64))
        b32["emis"] = b32["emis_col"]
        calls = [case(b32) for _ in range(3)]    # eager, capture, replay
        results[name] = hold(name, "gate", calls,
                             plain_of(name, models64, b64))
    refuse("gate", results, device_label)
    return results


def timed_columns(ncol: int) -> torch.Tensor:
    """The columns held after timing: ``GATE["ncol"]`` from the start of
    each launch chunk and the batch's last ones."""
    width = GATE["ncol"]
    starts = set(range(0, ncol, COLUMN_CHUNK)) | {max(ncol - width, 0)}
    return torch.unique(torch.cat([torch.arange(c0, min(c0 + width, ncol))
                                   for c0 in sorted(starts)]))


def timed_parity(cases: Dict[str, Case], b: dict, ncol: int,
                 models64: dict, device_label: str) -> dict:
    """Each case at the shape it was timed at: one more replay on the
    timed batch ``b``, its ``timed_columns`` against the plain versions at
    float64 on the same columns; {case: errors}.  Exits 1 as the gate
    does."""
    idx = timed_columns(ncol).to(b["tlay"].device)
    pick = lambda v: (v[idx] if v.ndim >= 1 and v.shape[0] == ncol
                      else v).double()
    b64 = {k: pick(v) for k, v in b.items() if k != "concs"}
    b64["concs"] = GasConcs(values=tuple(pick(v) for v in b["concs"].values),
                            names=b["concs"].names)
    results = {}
    for name, case in cases.items():
        outs = [o[idx] for o in case(b)]
        ngpt = models64[CONFIGS[name][1]].ngpt
        b64_case = dict(b64, emis=b64["emis"][:, None].expand(-1, ngpt))
        results[name] = hold(name, "timed", [outs],
                             plain_of(name, models64, b64_case))
        results[name]["columns"] = int(idx.numel())
    refuse("timed", results, device_label)
    return results


def time_steps(step: Callable[[], torch.Tensor], iters: int,
               warmup: int) -> float:
    """Seconds per step (bench.py's protocol): the steps' scalars are
    summed on the device and one ``.item()`` is the barrier."""
    for _ in range(warmup):
        step().item()
    t0 = time.perf_counter()
    acc = step()
    for _ in range(iters - 1):
        acc = acc + step()
    acc.item()
    return (time.perf_counter() - t0) / iters


def cpu_model() -> str:
    """The host CPU as ``lscpu`` names it, with its CPU count; where lscpu
    gives no model name (as in some virtual machines), its vendor, family
    and model numbers."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown (no lscpu)"
    fields = {}
    for line in out.splitlines():
        key, _, value = line.partition(":")
        fields[key.strip()] = value.strip()
    name = fields.get("Model name", "")
    if name in ("", "-", "unknown"):
        name = (f"{fields.get('Vendor ID', '?')} family "
                f"{fields.get('CPU family', '?')} model "
                f"{fields.get('Model', '?')} (lscpu gives no model name)")
    return f"{name}, {fields.get('CPU(s)', '?')} CPUs"


def write_artifact(out: dict, name: str, artifact_dir: str) -> None:
    with open(os.path.join(artifact_dir, name), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def on_the_card():
    """(device, its label, float32 models, float64 models) for a device
    mode; exits without a card (``card``)."""
    device, label = card()
    with tempfile.TemporaryDirectory() as work:
        paths = write_models(work)
        return (device, label, load_models(paths, torch.float32, device),
                load_models(paths, torch.float64, device))


def baseline_fields() -> dict:
    """The pinned CPU baseline, as every card line carries it."""
    return {"baseline_cols_per_sec": CPU_SERIAL_BASELINE_COLS_PER_SEC,
            "baseline_cols_per_sec_range": list(CPU_SERIAL_BASELINE_RANGE),
            "baseline_cpu": CPU_SERIAL_BASELINE_HOST}


def run_headline(ncol: int, steps: int, artifact_dir: str) -> dict:
    device, label, models32, models64 = on_the_card()
    mode = config.mxu_precision()
    cases = build_cases([HEADLINE_CASE], models32)
    parity = parity_gate(cases, models64, device, label)
    b = batch(ncol, NLAY, np.float32, device)
    case = cases[HEADLINE_CASE]
    dt = time_steps(lambda: case.step(b), steps, HEADLINE["warmup"])
    timed = timed_parity(cases, b, ncol, models64, label)
    value = ncol / dt
    protocol = (ncol, steps) == (HEADLINE["ncol"], HEADLINE["steps"])
    out = {"metric": METRIC, "value": value, "unit": "columns/s/chip",
           "vs_baseline": value / CPU_SERIAL_BASELINE_COLS_PER_SEC,
           "device": label, "parity_ok": True,
           "parity_max_rel": max(r["max_rel"] for r in
                                 (*parity.values(), *timed.values())),
           "parity": parity, "parity_timed": timed, "mxu_precision": mode,
           "ncol": ncol, "nlay": NLAY, "column_chunk": COLUMN_CHUNK,
           "steps": steps, "seconds_per_step": dt, **baseline_fields(),
           "protocol": protocol,
           "date": datetime.date.today().isoformat()}
    name = "BENCH_CUDA_FAST.json" if config.is_fast() else "BENCH_CUDA.json"
    if protocol:
        write_artifact(out, name, artifact_dir)
    else:
        print(f"# off-protocol run (ncol={ncol}, steps={steps}): {name} not "
              "written", file=sys.stderr)
    return out


def run_configs(ncol: int, steps: int, artifact_dir: str) -> dict:
    device, label, models32, models64 = on_the_card()
    epochs = CONFIGS_PROTOCOL["epochs"]
    mode = config.mxu_precision()
    cases = build_cases(CONFIGS, models32)
    # The timed set is the gated set: both are `cases`.
    parity = parity_gate(cases, models64, device, label)
    b = batch(ncol, NLAY, np.float32, device)
    for case in cases.values():          # warm every case: eager, capture
        case.step(b).item()
        case.step(b).item()
    best = dict.fromkeys(cases, float("inf"))
    # Interleaved epochs: drift between windows hits every case alike.
    for _ in range(epochs):
        for name, case in cases.items():
            best[name] = min(best[name],
                             time_steps(lambda: case.step(b), steps, 0))
    timed = timed_parity(cases, b, ncol, models64, label)
    values = {name: ncol / best[name] for name in cases}
    for name, v in values.items():
        print(f"# {name}: {v:,.0f} columns/s/chip on {label}",
              file=sys.stderr)
    protocol = (ncol, steps) == (CONFIGS_PROTOCOL["ncol"],
                                 CONFIGS_PROTOCOL["steps"])
    out = {"metric": "rfmip_flux_solve_throughput_by_config",
           "unit": "columns/s/chip", "configs": values,
           "vs_baseline": {k: v / CPU_SERIAL_BASELINE_COLS_PER_SEC
                           for k, v in values.items()},
           "device": label, "parity_ok": True,
           "parity_max_rel": {k: max(r["max_rel"], timed[k]["max_rel"])
                              for k, r in parity.items()},
           "parity": parity, "parity_timed": timed, "mxu_precision": mode,
           "ncol": ncol, "nlay": NLAY, "column_chunk": COLUMN_CHUNK,
           "steps": steps, "epochs": epochs, **baseline_fields(),
           "protocol": protocol,
           "date": datetime.date.today().isoformat()}
    name = ("BENCH_CUDA_CONFIGS.json" if mode == "bf16x3"
            else f"BENCH_CUDA_CONFIGS_{mode}.json")
    if protocol:
        write_artifact(out, name, artifact_dir)
    else:
        print(f"# off-protocol configs run (ncol={ncol}, steps={steps}, "
              f"epochs={epochs}): {name} not written", file=sys.stderr)
    return out


def run_cpu_baseline(ncol: int, steps: int) -> dict:
    """The headline's step on one CPU thread at float64."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        device = torch.device("cpu")
        with tempfile.TemporaryDirectory() as work:
            models = load_models(write_models(work), torch.float64, device)
        case = build_cases([HEADLINE_CASE], models)[HEADLINE_CASE]
        b = batch(ncol, NLAY, np.float64, device)
        dt = time_steps(lambda: case.step(b), steps, CPU_BASELINE["warmup"])
    finally:
        torch.set_num_threads(threads)
    value = ncol / dt
    print(f"# cpu_baseline: {value:.1f} columns/s ({ncol} columns x {steps}"
          f" steps, {dt:.3f} s/step)", file=sys.stderr)
    return {"metric": "cpu_serial_baseline_columns_per_sec", "value": value,
            "unit": "columns/s", "vs_baseline": 1.0, "cpu": cpu_model(),
            "threads": 1, "precision": "float64", "ncol": ncol,
            "nlay": NLAY, "steps": steps, "seconds_per_step": dt,
            "date": datetime.date.today().isoformat()}


def run_bench(mode: str = "headline", fast: bool = False, ncol=None,
              steps=None, artifact_dir: str = REPO) -> dict:
    """Run one mode and return its JSON record (see the module
    docstring); None picks the mode's protocol value.  The table mode is
    restored afterwards."""
    if mode == "cpu_baseline":
        return run_cpu_baseline(ncol or CPU_BASELINE["ncol"],
                                steps or CPU_BASELINE["steps"])
    if mode not in ("headline", "configs"):
        raise ValueError(f"unknown mode {mode!r}")
    previous = config.mxu_precision()
    config.set_mxu_precision("bf16" if fast else "bf16x3")
    try:
        if mode == "headline":
            return run_headline(ncol or HEADLINE["ncol"],
                                steps or HEADLINE["steps"], artifact_dir)
        return run_configs(ncol or CONFIGS_PROTOCOL["ncol"],
                           steps or CONFIGS_PROTOCOL["steps"], artifact_dir)
    finally:
        config.set_mxu_precision(previous)


def main(argv=None, artifact_dir: str = REPO) -> int:
    ap = argparse.ArgumentParser(prog="bench_cuda.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="headline",
                    choices=("headline", "configs", "cpu_baseline"))
    ap.add_argument("--fast", action="store_true",
                    help="the fast table mode (bf16 tables, K5)")
    ap.add_argument("--ncol", type=int, default=None,
                    help="columns (default: the mode's protocol)")
    args = ap.parse_args(argv)
    out = run_bench(args.mode, args.fast, args.ncol,
                    artifact_dir=artifact_dir)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
