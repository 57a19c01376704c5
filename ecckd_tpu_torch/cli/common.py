"""Shared driver plumbing for the RFMIP CLI entry points (counterpart of
``ecckd_tpu.cli.common``).

The reference drivers' structure (example/rfmip-rad-irf/ecckd_rfmip_lw.F90,
ecckd_rfmip_sw.F90, utils.f90): the whole column batch is one call of the
pipeline, split over the columns of the local cards (or, with
``--num-processes``, of the processes' devices) instead of a serial block
loop.  A failed kernel build or launch raises and the run exits non-zero:
there is no fallback to another compute path.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import sys
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from ecckd_tpu_torch.config import mxu_precision, set_mxu_precision
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.io.rfmip import (RFMIPData, io_engine, read_rfmip,
                                      rfmip_gas_names)
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.parallel import mesh as pmesh


def make_parser(prog: str) -> argparse.ArgumentParser:
    """CLI compatible with the reference's parse_args (utils.f90:74-134),
    plus the framework's extensions."""
    p = argparse.ArgumentParser(
        prog=prog, description="ecCKD RFMIP flux driver (PyTorch/CUDA)")
    p.add_argument("rfmip_file", help="RFMIP input file")
    p.add_argument("ecckd_file", help="ecckd ckd-definition input file")
    p.add_argument("-f", dest="forcing_index", type=int, default=1,
                   choices=(1, 2), help="Forcing index")
    p.add_argument("-p", dest="physics_index", type=int, default=1,
                   choices=(1, 2), help="Physics index")
    p.add_argument("--output-dir", default=".", help="Flux output directory")
    p.add_argument("--precision", default="f32", choices=("f32", "f64"),
                   help="Working precision (f64 for Fortran-parity runs)")
    p.add_argument("--no-shard", action="store_true",
                   help="One call on one device instead of the column split "
                        "over the local cards")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "torch", "cuda"),
                   help="Compute path: the CUDA kernels, plain PyTorch, or "
                        "auto (the kernels on a CUDA device at f32)")
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (default cuda; raises if "
                        "CUDA is absent; cpu runs the plain torch path)")
    p.add_argument("--metrics-json", default=None,
                   help="Write run metrics (columns/s, flux ranges, "
                        "config) as one JSON file")
    p.add_argument("--heating-rates", action="store_true",
                   help="Also write layer heating rates [K/day] "
                        "(hrl/hrs files; framework extension)")
    p.add_argument("--coordinator", default=None,
                   help="Process-group address host:port (torch.distributed, "
                        "NCCL on cards, Gloo on the CPU); one process if "
                        "omitted")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Processes that split the columns (one device each; "
                        "rank 0 writes the files)")
    p.add_argument("--process-id", type=int, default=None,
                   help="This process's rank, 0 .. num-processes - 1")
    p.add_argument("--validate", action="store_true",
                   help="Validate physical input ranges and check output "
                        "finiteness (utils/checks.py)")
    p.add_argument("--fast", action="store_true",
                   help="Fast table mode of the CUDA kernels: bf16 table "
                        "entries and interpolation weights, f32 sums; "
                        "<= 5e-4 of the flux scale (inside the ckd models' "
                        "stated heating-rate tolerance); see "
                        "config.set_mxu_precision.  The torch route "
                        "ignores it")
    return p


def torch_device(name: str) -> torch.device:
    """The requested device; a CUDA device that is not there raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def setup_distributed(args) -> None:
    """Join the process group of ``--num-processes`` processes (no-op for
    one process; the group is left at exit): after this each rank
    computes its piece of the columns (split_call) on its own device."""
    if getattr(args, "num_processes", None):
        pmesh.init_distributed(args.coordinator, args.num_processes,
                               args.process_id, torch_device(args.device))
        if torch.distributed.is_initialized():
            atexit.register(_leave_process_group)


def _leave_process_group() -> None:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def setup_precision(precision: str) -> torch.dtype:
    return torch.float64 if precision == "f64" else torch.float32


def rank_device(device: torch.device) -> torch.device:
    """This process's device: in a process group of several ranks, rank r
    takes local card r mod the card count (and makes it the current
    card, which NCCL's communicator follows)."""
    rank, size = pmesh.world()
    if device.type == "cuda" and device.index is None and size > 1:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def load_inputs(args) -> Tuple[RFMIPData, CKDModel, torch.device]:
    device = torch_device(args.device)
    setup_distributed(args)
    device = rank_device(device)
    if getattr(args, "fast", False):
        set_mxu_precision("bf16")
    data = read_rfmip(args.rfmip_file, args.forcing_index)
    print(f" Using 1 batch of {data.ncol} columns ({data.nsite} sites x "
          f"{data.nexp} experiments) on {device}", file=sys.stderr)
    _, rfmip_names = rfmip_gas_names(args.forcing_index)
    print(" Calculation uses RFMIP gases: " + " ".join(rfmip_names),
          file=sys.stderr)
    model = load_ckd_model(args.ecckd_file,
                           dtype=setup_precision(args.precision),
                           device=device)
    return data, model, device


def build_gas_concs(data: RFMIPData, dtype, device) -> GasConcs:
    """Requested-gas list in reference order: the 6 scalar gases, then h2o,
    o3, no2 (mo_rfmip_io.F90:199-260)."""
    items = [(name, data.gases_scalar[name].astype(dtype))
             for name in ("co2", "ch4", "n2o", "o2", "cfc11", "cfc12")]
    items += [("h2o", data.gases_3d["h2o"].astype(dtype)),
              ("o3", data.gases_3d["o3"].astype(dtype)),
              ("no2", data.gases_scalar["no2"].astype(dtype))]
    return GasConcs.create(items, device=device)


def on_device(arrays, device) -> List[torch.Tensor]:
    return [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in arrays]


def split_call(fn: Callable, args: tuple, ncol: int, device: torch.device,
               no_shard: bool, replicated_argnums=()) -> Tuple[object, int]:
    """``fn(*args)`` over the column axis (counterpart of the JAX drivers'
    ``place_on_mesh``): across the process group when it has several
    ranks (mesh.distributed_columns_call), else across every local card
    (mesh.shard_columns_call) unless ``no_shard``, else one call.
    ``replicated_argnums`` are whole arguments (the models).  Returns
    (outputs on ``device``, number of devices the columns were split
    over)."""
    _, size = pmesh.world()
    if size > 1:
        return pmesh.distributed_columns_call(
            fn, device, args, ncol,
            replicated_argnums=replicated_argnums), size
    if no_shard:
        return fn(*args), 1
    devices = (pmesh.make_column_mesh()
               if device.type == "cuda" and device.index is None
               else [device])
    return pmesh.shard_columns_call(
        fn, devices, args, ncol,
        replicated_argnums=replicated_argnums), len(devices)


def writes_files() -> bool:
    """Only rank 0 of a process group writes the output files."""
    return pmesh.world()[0] == 0


class Timer:
    """Wall timer of a block; the block ends with the completion barrier
    (utils/profiling.barrier) so device work is inside the time."""

    def __init__(self, label: str):
        self.label = label
        self.seconds = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        print(f" {self.label}: {self.seconds*1e3:.1f} ms", file=sys.stderr)


def write_metrics(path, *, ncol: int, seconds: float, args, fluxes,
                  n_devices: int = 1, extra=None) -> None:
    """Per-run metrics JSON: throughput, flux sanity ranges, the table
    mode and the netCDF engine that read and wrote the files."""
    up = fluxes.flux_up.detach().cpu().numpy()
    dn = fluxes.flux_dn.detach().cpu().numpy()
    m = {
        "columns": int(ncol),
        "seconds": round(seconds, 6),
        "columns_per_sec": round(ncol / max(seconds, 1e-12), 1),
        "n_devices": int(n_devices),
        "device": str(fluxes.flux_up.device),
        "backend_requested": args.backend,
        "precision": args.precision,
        "mxu_precision": mxu_precision(),
        "io_engine": io_engine(),
        "flux_up_range": [float(up.min()), float(up.max())],
        "flux_dn_range": [float(dn.min()), float(dn.max())],
        "all_finite": bool(np.isfinite(up).all() and np.isfinite(dn).all()),
    }
    if extra:
        m.update(extra)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(m, f, indent=1)
    print(f" Wrote metrics to {path}", file=sys.stderr)
