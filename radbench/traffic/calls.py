"""Closed loop, one caller, each call waiting for its outputs: the wait a
model's time step sees on its radiation call.

Calls of ``ncol`` columns cycle over the input variants.  Each call is
timed on the host clock from entry until its outputs are ready on the
card (a synchronize), and only then is the next one issued.
The window closes once ``seconds`` have passed and every variant has a
held call.  ``call_ms_p95`` is the 95th percentile over all calls of the
window.
The harness's span from entry to return, before the barrier, is the
host's issue time of the call (``call_issue_s``).
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from radbench.solve import VariantCalls, sync


class Traffic(VariantCalls):

    def window(self, seconds: float, tracer) -> dict:
        waits, issue = [], []
        i = 0
        t0 = time.perf_counter()
        while True:
            traced = tracer.unit(i)
            ta = time.perf_counter()
            out = self.program(self.args[i % len(self.args)])
            tb = time.perf_counter()
            sync(self.devices)
            tc = time.perf_counter()
            waits.append(tc - ta)
            if not traced:
                issue.append(tb - ta)
            if self.held(i):
                self.keep(i, out)
            i += 1
            if tc - t0 >= seconds and not tracer.open() \
                    and self.covered():
                break
        if not self.held(i - 1):
            self.keep(i - 1, out)
        window_s = time.perf_counter() - t0
        tracer.close()
        ms = 1e3 * np.asarray(waits)
        print(f"# calls: {i}, call ms median {statistics.median(ms):.6f} "
              f"p95 {np.percentile(ms, 95):.6f} max {ms.max():.6f}",
              file=sys.stderr)
        return {"units": i, "attempted": i, "window_s": window_s,
                "metrics": {"call_ms_p95": float(np.percentile(ms, 95))},
                "spans": {"call_issue_s": issue}}
