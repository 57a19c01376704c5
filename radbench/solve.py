"""What the call-shaped traffic kinds share: the configuration's models,
the seeded input variants, the program's timed entry, and the columns
held for the check.

The timed entry is the port's main path as a climate model calls it:
``capture.jit(pipeline.lw_sw_fluxes)`` (one CUDA graph per shape,
captured at the second call and replayed) with the configuration's Gauss
angles and the cell's ``column_chunk``.  The benchmark makes the inputs;
the program receives only the tensors.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from radbench import count, inputs
from radbench.reference import ckd as ref_ckd
from radbench.reference import rte


def write_ckd_files(config: dict, work: str) -> dict:
    """The configuration's two ckd files, written into ``work`` from their
    seeds; {"lw": path, "sw": path}."""
    paths = {}
    for band in ("lw", "sw"):
        spec = config["ckd"][band]
        paths[band] = os.path.join(work, f"{band}.nc")
        inputs.write_ckd(paths[band], spec["kind"], spec["seed"])
    return paths


def read_reference_ckd(paths: dict) -> tuple:
    return ref_ckd.read_ckd(paths["lw"]), ref_ckd.read_ckd(paths["sw"])


def load_models(paths: dict, device) -> tuple:
    """The program's (lw, sw) models, float32 on ``device``."""
    from ecckd_tpu_torch.models.loader import load_ckd_model
    return tuple(load_ckd_model(paths[b], dtype=torch.float32, device=device)
                 for b in ("lw", "sw"))


def gas_concs(batch: dict):
    """The batch's gases as the program's ``GasConcs``, in the order
    ``inputs.GASES``."""
    from ecckd_tpu_torch.gases import GasConcs
    return GasConcs.create([(k, batch["concs"][k]) for k in inputs.GASES])


def gas_sizes(batch: dict) -> dict:
    """name -> values per column of each gas of ``batch``."""
    return {k: (v.shape[1] if v.ndim == 2 else 1)
            for k, v in batch["concs"].items()}


class LwSwSolve:
    """What a traffic kind that drives the merged LW + SW solve gives the
    harness besides its traffic: the names of the outputs its answers
    hold (pairs of up and down fluxes, one pair per band), their plain
    reference, and the work of one unit.  A traffic kind of another entry
    (LW or SW alone) overrides the three."""

    OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn")

    @staticmethod
    def reference(lw, sw, b: dict, config: dict) -> tuple:
        """The outputs at the columns of ``b``, from the reference."""
        return rte.fluxes(lw, sw, b, config["n_gauss_angles"])

    @staticmethod
    def work(lw, sw, gases: dict, ncol: int, config: dict) -> dict:
        """Operations and bytes of one unit of ``ncol`` columns."""
        return count.lwsw_work(lw, sw, gases, ncol, config["nlay"],
                               config["n_gauss_angles"])


class Program:
    """The timed entry on one device: ``call(batch)`` returns the four flux
    profiles (lw_up, lw_dn, sw_up, sw_dn), each (ncol, nlay + 1)."""

    def __init__(self, models: tuple, config: dict, column_chunk: int):
        from ecckd_tpu_torch import pipeline
        from ecckd_tpu_torch.utils import capture
        self.models = models
        self.fn = capture.jit(pipeline.lw_sw_fluxes)
        self.kwargs = dict(n_gauss_angles=config["n_gauss_angles"],
                           column_chunk=column_chunk)

    def args(self, b: dict) -> tuple:
        return (*self.models, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                b["emis"], gas_concs(b), b["alb"], b["tsi"], b["sza"])

    def __call__(self, args: tuple) -> tuple:
        f_lw, f_sw = self.fn(*args, **self.kwargs)
        return f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn


def check_columns(ncol: int, chunk: int, per_chunk: int,
                  rng: np.random.Generator) -> np.ndarray:
    """The columns held for the check: in every block of ``chunk`` columns
    (a launch chunk, or a card's piece) its first and last and
    ``per_chunk`` more drawn from ``rng``."""
    cols = set()
    for c0 in range(0, ncol, chunk):
        c1 = min(c0 + chunk, ncol)
        cols |= {c0, c1 - 1}
        cols |= set(int(c) for c in rng.integers(c0, c1, per_chunk))
    return np.array(sorted(cols), dtype=np.int64)


def sync(devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def launches() -> dict:
    """The merged kernel's launch counts (exact and fast entry points)."""
    from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda
    return {"lwsw": lwsw_fluxes_cuda.launches,
            "lwsw_fast": lwsw_fluxes_cuda.fast_launches}


class VariantCalls(LwSwSolve):
    """Set-up, check and clean-up of a closed loop of calls on one device
    over ``variants`` input batches made from the seed and cycled call by
    call, so no call can reuse another's result.

    Cell parameters: ``ncol``, ``column_chunk``, ``variants``,
    ``check_columns_per_chunk`` and ``check_every`` (a call is held for
    the check where its number, less an offset drawn from the seed, is a
    multiple of it; the last call is always held).  ``check_every`` has
    no factor in common with ``variants``, so any ``variants``
    consecutive held calls are one of each variant, and the window stays
    open until every variant has a held call (``covered``): a step that
    keeps answering with one variant's outputs is caught whatever the
    offset.  A traffic kind subclasses it with its ``window``."""

    def __init__(self, cell: dict, config: dict, paths: dict, seed: int,
                 devices: list):
        p = self.cell_params = cell["params"]
        self.device = torch.device(devices[0])
        self.devices = [self.device]
        self.ncol, self.nlay = p["ncol"], config["nlay"]
        models = load_models(paths, self.device)
        gen = inputs.generator(seed, self.device)
        self.batches = [inputs.make_batch(self.ncol, self.nlay, gen,
                                          self.device)
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
        self.kept = []                # (variant, the held columns' fluxes)
        self.gases = gas_sizes(self.batches[0])
        self.unit_columns = self.ncol
        # Warm-up: the eager call, the capture, and a replay of each
        # variant; the launch counts then say the kernel path ran.
        for v in range(len(self.args) + 1):
            self.program(self.args[v % len(self.args)])
        sync(self.devices)

    def held(self, i: int) -> bool:
        return i % self.every == self.offset

    def covered(self) -> bool:
        """Whether every variant has a held call."""
        return len({v for v, _ in self.kept}) == len(self.args)

    def keep(self, i: int, out: tuple) -> None:
        self.kept.append((i % len(self.args),
                          [o.index_select(0, self.cols) for o in out]))

    def answers(self) -> list:
        """[(the inputs at the held columns, [fluxes of each held call of
        that variant])]."""
        return [(inputs.take_columns(b, self.cols),
                 [out for v_, out in self.kept if v_ == v])
                for v, b in enumerate(self.batches)]

    def close(self) -> None:
        self.batches = self.args = self.program = self.kept = None
