"""Passes of an offline run that streams columns to host memory, split
over the cards: the rate at which fluxes reach the host.

A pass streams ``n_chunks`` chunks of ``chunk`` columns through the
port's stream, ``parallel.scale.run_weak_scaling`` over every card of the
cell, with ``capture.jit(cli.scale_bench.make_step(outputs))`` as the
step and ``depth`` chunks in flight.  The pass's ``n_chunks * chunk``
distinct columns are made from the seed and placed over the cards once
(``parallel.scale.place_pytree``: a quarter per card on four cards), so
the cards hold the whole pass as an offline run holds it.  Chunk i is
every card's i-th slice of ``chunk / cards`` of its columns: row r of
chunk i's output is column ``(r // per) * span + i * per + r % per`` of
the pass, with ``per = chunk / cards`` and ``span`` the columns a card
holds.  The benchmark builds chunk i of pass p where its pieces lie, by
its own rule: every card adds ``shift[(p * n_chunks + i) mod
len(shift)]`` to its slice's surface temperature, the shifts drawn from
the seed in float32, so passes differ too.  Passes run back to back
until the window closes; ``delivered_columns_per_s`` is every pass's
columns over the whole window, each pass ending when all its outputs are
in pinned host memory.

The sink keeps, for the passes held for the check (pass numbers that,
less an offset drawn from the seed, are multiples of ``check_every``,
and the last), the held rows of each of their chunks: in every card's
piece its first and last and ``check_columns_per_card`` more.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from radbench import inputs
from radbench.solve import (LwSwSolve, check_columns, gas_concs, gas_sizes,
                            load_models)

N_SHIFTS = 61
"""Entries of the shift table: a prime, so chunk i of pass p and chunk i
of pass p + 1 read different shifts."""
COUNTERS = ("wall_s", "dispatch_s", "d2h_issue_s", "drain_wait_s")


def chunk_pieces(placed, i: int, per: int, chunk: int):
    """Chunk i's arguments as views of the placed pass: on every card the
    rows [i * per, (i + 1) * per) of its batch leaves, the models whole."""
    from ecckd_tpu_torch.gases import GasConcs
    from ecckd_tpu_torch.parallel.mesh import ColumnShards
    from ecckd_tpu_torch.parallel.scale import call_placed
    s = slice(i * per, (i + 1) * per)

    def cut(lw, sw, *leaves):
        *arrays, concs = leaves
        return (lw, sw, *(a[s] for a in arrays),
                GasConcs(values=tuple(v[s] for v in concs.values),
                         names=concs.names))

    pieces = call_placed(cut, placed)
    if isinstance(pieces, ColumnShards):
        pieces = dataclasses.replace(
            pieces, ncol=chunk,
            offsets=tuple(d * per for d in range(len(pieces.devices))))
    return pieces


class Traffic(LwSwSolve):

    def __init__(self, cell: dict, config: dict, paths: dict, seed: int,
                 devices: list):
        from ecckd_tpu_torch.cli.scale_bench import make_step
        from ecckd_tpu_torch.parallel.scale import call_placed, place_pytree
        from ecckd_tpu_torch.utils import capture
        p = cell["params"]
        self.devices = [torch.device(d) for d in devices]
        n = len(self.devices)
        self.chunk, self.n_chunks = p["chunk"], p["n_chunks"]
        self.depth, self.every = p["depth"], p["check_every"]
        self.unit_columns = self.chunk * self.n_chunks
        if self.chunk % n:
            raise ValueError(f"chunk {self.chunk} is not split evenly over "
                             f"{n} cards")
        per, span = self.chunk // n, self.unit_columns // n
        home = self.devices[0]
        lw, sw = load_models(paths, home)
        gen = inputs.generator(seed, home)
        base = inputs.make_batch(self.unit_columns, config["nlay"], gen, home)
        self.gases = gas_sizes(base)
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        self.shifts = rng.uniform(-2.0, 2.0, N_SHIFTS).astype(np.float32)
        self.offset = int(rng.integers(0, self.every))
        self.cols = check_columns(self.chunk, per,
                                  p["check_columns_per_card"], rng)
        rows = torch.as_tensor(self.cols, device=home)
        # The held rows' inputs of every chunk, before its shift.
        self.held_inputs = [
            inputs.take_columns(base, (rows // per) * span + i * per
                                + rows % per)
            for i in range(self.n_chunks)]
        placed = place_pytree(
            (lw, sw, base["plev"], base["tlay"], base["tlev"], base["tsfc"],
             base["emis"], base["alb"], base["tsi"], base["sza"],
             gas_concs(base)), self.devices, self.unit_columns)
        del base
        pieces = [chunk_pieces(placed, i, per, self.chunk)
                  for i in range(self.n_chunks)]
        self.pass_number = -1

        def chunk_builder(i):
            k = self.pass_number * self.n_chunks + i
            delta = float(self.shifts[k % N_SHIFTS])
            return call_placed(lambda *a: (*a[:5], a[5] + delta, *a[6:]),
                               pieces[i])

        self.chunk_builder = chunk_builder
        self.step = capture.jit(make_step(p["outputs"]))
        self.kept = []     # ((chunk, shift index), the held rows' fluxes)
        self.counters = dict.fromkeys(COUNTERS, 0.0)
        self.run_pass()    # warm-up: eager, capture, pinned ring
        self.kept = []
        self.pass_number = 0

    def run_pass(self) -> dict:
        """One pass; the sink keeps the held rows of every chunk."""
        from ecckd_tpu_torch.parallel.scale import run_weak_scaling
        number = self.pass_number

        def sink(host, i):
            k = (number * self.n_chunks + i) % N_SHIFTS
            self.kept.append(((i, k), [torch.from_numpy(h[self.cols])
                                       for h in host]))

        return run_weak_scaling(self.step, self.chunk_builder, self.n_chunks,
                                self.chunk, mesh=self.devices, consume=sink,
                                warmup=0, depth=self.depth)

    def window(self, seconds: float, tracer) -> dict:
        last = []
        t0 = time.perf_counter()
        while True:
            traced = tracer.unit(self.pass_number)
            held = self.pass_number % self.every == self.offset
            before = len(self.kept)
            m = self.run_pass()
            last = []
            if not held:
                # Of the passes not held only the newest stays, in case
                # it is the last.
                last = self.kept[before:]
                del self.kept[before:]
            if not traced:
                for k in COUNTERS:
                    self.counters[k] += m[k]
            self.pass_number += 1
            if time.perf_counter() - t0 >= seconds and not tracer.open():
                break
        self.kept += last
        window_s = time.perf_counter() - t0
        tracer.close()
        columns = self.pass_number * self.unit_columns
        return {"units": self.pass_number,
                "attempted": self.pass_number * self.n_chunks,
                "window_s": window_s,
                "metrics": {"delivered_columns_per_s": columns / window_s},
                "counters": dict(self.counters)}

    def answers(self) -> list:
        """[(chunk i's held rows' inputs with shift k applied, [fluxes of
        each held chunk i that read shift k])]."""
        out = []
        for i, k in sorted({key for key, _ in self.kept}):
            b = self.held_inputs[i]
            b = dict(b, tsfc=b["tsfc"] + float(self.shifts[k]))
            out.append((b, [f for key, f in self.kept if key == (i, k)]))
        return out

    def close(self) -> None:
        self.step = self.chunk_builder = self.kept = None
