"""Closed loop, one caller, large calls back to back: the throughput of
the radiation call on a large block of columns.

Calls of ``ncol`` columns cycle over the input variants.  The caller
keeps ``in_flight`` calls queued: it issues a call, then waits for the
one issued ``in_flight`` calls before, so the card always has the next
call and the host never runs far ahead.  The window ends at a barrier
after the last call, once ``seconds`` have passed and every variant has
a held call; ``columns_per_s`` is every call's columns over the whole
window.
"""
from __future__ import annotations

import time

import torch

from radbench.solve import VariantCalls, sync


class Traffic(VariantCalls):

    def window(self, seconds: float, tracer) -> dict:
        depth = self.cell_params["in_flight"]
        pending = []
        i = 0
        t0 = time.perf_counter()
        while True:
            tracer.unit(i)
            out = self.program(self.args[i % len(self.args)])
            if self.held(i):
                self.keep(i, out)
            if self.device.type == "cuda":
                pending.append(torch.cuda.Event())
                pending[-1].record()
                if len(pending) > depth:
                    pending.pop(0).synchronize()
            i += 1
            if time.perf_counter() - t0 >= seconds and not tracer.open() \
                    and self.covered():
                break
        if not self.held(i - 1):
            self.keep(i - 1, out)
        sync(self.devices)
        window_s = time.perf_counter() - t0
        tracer.close()
        return {"units": i, "attempted": i, "window_s": window_s,
                "metrics": {"columns_per_s": i * self.ncol / window_s}}
