"""The ``batch`` kind with RTE's LW surface-temperature Jacobian asked for
on every call: the same closed loop of large calls back to back
(``traffic/batch.py``'s window), each call ``pipeline.lw_sw_fluxes(...,
flux_up_jac=True)``, whose LW result then carries ``flux_up_jac``, the
derivative of the upward LW flux at every level with respect to the
surface temperature.  The IFS uses that derivative to update the LW
fluxes every time step between radiation calls.

The set-up is ``solve.VariantCalls``' with one change: the program asks
for the Jacobian.  On a card the warm-up must run the merged kernel's
Jacobian instantiation (``lwsw_fluxes_cuda.jac_launches`` grows), or
set-up fails; a program without that count fails at once.

The check compares outputs in pairs, up and down, each pair against its
own scale.  The Jacobian is its own pair: the program's J and a zero
down-Jacobian (the down flux does not depend on the surface temperature),
so its scale is the largest |J| of the reference at the held columns.  The
reference is ``reference/rte_jac.py``; the work is ``count.lwsw_work``, as
for the other cells (``metrics/lwsw_jac_roofline.py`` adds the
Jacobian's).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from radbench import inputs
from radbench.reference import rte_jac
from radbench.solve import (Program, check_columns, gas_sizes, load_models,
                            sync)
from radbench.traffic import batch


def jac_launches() -> int:
    """The merged kernel's Jacobian launch count; raises on a program that
    has none."""
    from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda
    return lwsw_fluxes_cuda.jac_launches


class JacProgram(Program):
    """``solve.Program`` asking for the Jacobian: a call returns the four
    flux profiles and d lw_up / d T_sfc, each (ncol, nlay + 1)."""

    def __init__(self, models: tuple, config: dict, column_chunk: int):
        super().__init__(models, config, column_chunk)
        self.kwargs["flux_up_jac"] = True

    def __call__(self, args: tuple) -> tuple:
        f_lw, f_sw = self.fn(*args, **self.kwargs)
        return (f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn,
                f_lw.flux_up_jac)


class Traffic(batch.Traffic):

    OUTPUTS = ("lw_up", "lw_dn", "sw_up", "sw_dn", "lw_up_jac", "lw_dn_jac")

    def __init__(self, cell: dict, config: dict, paths: dict, seed: int,
                 devices: list):
        launched = jac_launches()
        p = self.cell_params = cell["params"]
        self.device = torch.device(devices[0])
        self.devices = [self.device]
        self.ncol, self.nlay = p["ncol"], config["nlay"]
        models = load_models(paths, self.device)
        gen = inputs.generator(seed, self.device)
        self.batches = [inputs.make_batch(self.ncol, self.nlay, gen,
                                          self.device)
                        for _ in range(p["variants"])]
        self.program = JacProgram(models, config, p["column_chunk"])
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
        if self.device.type == "cuda" and jac_launches() == launched:
            raise RuntimeError("the warm-up ran no launch of the merged "
                               "kernel's Jacobian instantiation: the calls "
                               "took another path")

    def keep(self, i: int, out: tuple) -> None:
        """The held columns' outputs and, sixth, the zero down-Jacobian
        that pairs with the program's J."""
        super().keep(i, out)
        held = self.kept[-1][1]
        held.append(torch.zeros_like(held[4]))

    @staticmethod
    def reference(lw, sw, b: dict, config: dict) -> tuple:
        return rte_jac.fluxes(lw, sw, b, config["n_gauss_angles"])
