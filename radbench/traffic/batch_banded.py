"""The ``batch`` kind with the surface emissivity given per LW band: the
same closed loop of large calls back to back (``traffic/batch.py``'s
window), with the emissivity an (ncol, nband) array, as RTE's ``rte_lw``
takes it (``sfc_emis(nband, ncol)``) and a coupled model passes it.

The set-up is ``solve.VariantCalls``' with one change: after the
variants' ``inputs.make_batch`` draws, the same generator draws each
variant's emissivity, uniform in [0.9, 1.0] per column and band, so every
other input equals the ``batch`` cells' on the same seed.  The number of
bands, and which g-points each holds, come from the LW ckd file itself
(``reference/rte_banded.band_of_gpt``).

On a card the warm-up's first call, which runs eagerly, must show two
things, or set-up fails:
* the merged kernel ran (its launches grew, in either table mode);
* the emissivity the launch got is the banded one, each band's value on
  that band's g-points, and not one value spread over them all.
Which staging plan the launch takes is the program's to choose.
The reference is ``reference/rte_banded.py``; the work is
``count.lwsw_work``, as for the other cells.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from radbench import inputs
from radbench.reference import rte_banded
from radbench.solve import (Program, check_columns, gas_sizes, launches,
                            load_models, sync)
from radbench.traffic import batch

EMIS_RANGE = (0.9, 1.0)


def banded_emissivity(ncol: int, nband: int, gen: torch.Generator,
                      device) -> torch.Tensor:
    """(ncol, nband) float32 emissivity, uniform in ``EMIS_RANGE``."""
    lo, hi = EMIS_RANGE
    return lo + (hi - lo) * torch.rand((ncol, nband), generator=gen,
                                       device=device, dtype=torch.float32)


def check_banded(emis_gpt: torch.Tensor, emis_band: torch.Tensor,
                 bands: np.ndarray) -> None:
    """Raise unless ``emis_gpt`` (ncol, ngpt), what a launch got, holds
    each column's band values of ``emis_band`` (ncol, nband) on the
    g-points of ``bands``, and differs across the g-points of a column."""
    index = torch.as_tensor(bands, dtype=torch.long, device=emis_band.device)
    want = emis_band.index_select(1, index)
    if emis_gpt.shape != want.shape or not torch.equal(
            emis_gpt.to(want.device, want.dtype), want):
        raise RuntimeError("the launch's emissivity is not the banded "
                           "emissivity spread over each band's g-points")
    if bool((emis_gpt == emis_gpt[:, :1]).all()):
        raise RuntimeError("the launch's emissivity is one value a column: "
                           "the bands did not reach the kernel")


class Traffic(batch.Traffic):

    def __init__(self, cell: dict, config: dict, paths: dict, seed: int,
                 devices: list):
        p = self.cell_params = cell["params"]
        self.device = torch.device(devices[0])
        self.devices = [self.device]
        self.ncol, self.nlay = p["ncol"], config["nlay"]
        self.bands = rte_banded.band_of_gpt(paths["lw"])
        models = load_models(paths, self.device)
        gen = inputs.generator(seed, self.device)
        self.batches = [inputs.make_batch(self.ncol, self.nlay, gen,
                                          self.device)
                        for _ in range(p["variants"])]
        for b in self.batches:
            b["emis"] = banded_emissivity(self.ncol, int(self.bands.max())
                                          + 1, gen, self.device)
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
        if self.device.type == "cuda":
            self.watched_first_call()
        for v in range(len(self.args) + 1):
            self.program(self.args[v % len(self.args)])
        sync(self.devices)

    def watched_first_call(self) -> None:
        """The first (eager) call with its kernel launch watched: raises
        unless K1 ran with the banded emissivity."""
        from ecckd_tpu_torch.ops.cuda import staged
        seen = []
        run_staged = staged.run_staged

        def watched(atm, lw, sw, *a, **kw):
            seen.append(lw.emis)
            return run_staged(atm, lw, sw, *a, **kw)

        launched = sum(launches().values())
        staged.run_staged = watched
        try:
            self.program(self.args[0])
        finally:
            staged.run_staged = run_staged
        sync(self.devices)
        if sum(launches().values()) == launched or not seen:
            raise RuntimeError("the warm-up ran no launch of the merged "
                               "kernel: the calls took another path")
        for emis_gpt in seen:
            check_banded(emis_gpt, self.batches[0]["emis"], self.bands)

    def answers(self) -> list:
        return [(dict(b, bands=self.bands), outs)
                for b, outs in super().answers()]

    @staticmethod
    def reference(lw, sw, b: dict, config: dict) -> tuple:
        inputs_ = {k: v for k, v in b.items() if k != "bands"}
        return rte_banded.fluxes(lw, sw, inputs_, config["n_gauss_angles"],
                                 b["bands"])
