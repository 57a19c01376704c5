"""The ``batch`` kind at float64: the same closed loop of large calls
back to back (``traffic/batch.py``'s window), with every input and model
in float64, the working precision of the configuration.

The set-up is ``solve.VariantCalls``' with two changes: the models are
loaded at float64, and ``inputs.make_batch``'s float32 draws are widened
with ``.double()``, so the variants hold the same values as the float32
cells' on the same seed.  On a card the warm-up must run the merged
kernel's f64 entry point (``lwsw_fluxes_cuda.f64_launches`` grows), or
set-up fails; a program without that count fails at once.  The
reference is ``reference/rte_precision.py`` at the configuration's
precision (the night rule at float64, as ``pipeline.sw_fluxes`` applies
it); the work is ``count.lwsw_work``, as for the float32 cells.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from radbench import inputs
from radbench.reference import rte_precision
from radbench.solve import Program, check_columns, gas_sizes, sync
from radbench.traffic import batch


def load_models(paths: dict, device, dtype) -> tuple:
    """The program's (lw, sw) models in ``dtype`` on ``device``."""
    from ecckd_tpu_torch.models.loader import load_ckd_model
    return tuple(load_ckd_model(paths[b], dtype=dtype, device=device)
                 for b in ("lw", "sw"))


def widened(batch_: dict, dtype) -> dict:
    """Every tensor of ``batch_`` in ``dtype``."""
    out = {k: v.to(dtype) for k, v in batch_.items() if k != "concs"}
    out["concs"] = {k: v.to(dtype) for k, v in batch_["concs"].items()}
    return out


def f64_launches() -> int:
    """The merged kernel's f64 launch count; raises on a program that has
    none (no f64 entry point)."""
    from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda
    return lwsw_fluxes_cuda.f64_launches


class Traffic(batch.Traffic):

    def __init__(self, cell: dict, config: dict, paths: dict, seed: int,
                 devices: list):
        dtype = getattr(torch, config["precision"])
        launched = f64_launches()
        p = self.cell_params = cell["params"]
        self.device = torch.device(devices[0])
        self.devices = [self.device]
        self.ncol, self.nlay = p["ncol"], config["nlay"]
        models = load_models(paths, self.device, dtype)
        gen = inputs.generator(seed, self.device)
        self.batches = [widened(inputs.make_batch(self.ncol, self.nlay, gen,
                                                  self.device), dtype)
                        for _ in range(p["variants"])]
        self.program = Program(models, config, p["column_chunk"])
        self.args = [self.program.args(b) for b in self.batches]
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        self.cols = torch.as_tensor(
            check_columns(self.ncol, p["column_chunk"],
                          p["check_columns_per_chunk"], rng),
            device=self.device)
        self.every = p["check_every"]
        if math.gcd(self.every, p["variants"]) != 1:
            raise ValueError(f"check_every {self.every} shares a factor "
                             f"with variants {p['variants']}: the held "
                             f"calls would miss variants")
        self.offset = int(rng.integers(0, self.every))
        self.kept = []
        self.gases = gas_sizes(self.batches[0])
        self.unit_columns = self.ncol
        for v in range(len(self.args) + 1):
            self.program(self.args[v % len(self.args)])
        sync(self.devices)
        if self.device.type == "cuda" and f64_launches() == launched:
            raise RuntimeError("the warm-up ran no f64 launch of the merged "
                               "kernel: the calls took another path")

    @staticmethod
    def reference(lw, sw, b: dict, config: dict) -> tuple:
        return rte_precision.fluxes(lw, sw, b, config["n_gauss_angles"],
                                    config["precision"])
