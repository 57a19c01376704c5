"""Runs of each traffic kind with the timed path broken underneath: the
comparison has to find every fault the cell can have.  The runs go
through the harness's ``run_cell`` on the CPU at a test's size (the look
for a card is the one step left out), so the check is the one the
benchmark makes."""
import time

import pytest
import torch

from radbench import run, solve
from radbench.tests.helpers import SEED, run_small, small_cell

CALL_CELLS = ("l60_batch", "l137_batch", "l60_rfmip_calls")


def stale(outs_fn):
    """A step that returns its state unchanged: every call answers with
    the first call's outputs."""
    first = []

    def fn(*a, **k):
        out = outs_fn(*a, **k)
        if not first:
            first.append(tuple(o.clone() for o in out))
        return first[0]
    return fn


def half(outs_fn):
    """Half of the batch left out: the second half's columns never
    computed (zeros)."""
    def fn(*a, **k):
        out = tuple(o.clone() for o in outs_fn(*a, **k))
        for o in out:
            o[o.shape[0] // 2:] = 0.0
        return out
    return fn


def altered(outs_fn):
    """An answer altered where it is produced: the LW upward flux at the
    top of every column 0.1 % high."""
    def fn(*a, **k):
        out = tuple(o.clone() for o in outs_fn(*a, **k))
        out[0][:, 0] *= 1.001
        return out
    return fn


FAULTS = {"stale": stale, "half": half, "altered": altered}


@pytest.mark.parametrize("name", CALL_CELLS)
def test_sound_run_is_correct(name):
    r = run_small(name)
    assert r["correct"] and r["failed"] == 0
    assert r["check"]["flux_err_p99"]["value"] < 1e-5


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CALL_CELLS)
def test_call_faults_are_caught(monkeypatch, name, fault):
    original = solve.Program.__call__
    broken = {}

    def call(self, args):
        if self not in broken:
            broken[self] = FAULTS[fault](lambda a: original(self, a))
        return broken[self](args)

    monkeypatch.setattr(solve.Program, "__call__", call)
    r = run_small(name)
    assert not r["correct"], r["check"]
    assert r["failed"] > 0


@pytest.mark.parametrize("name", CALL_CELLS)
def test_stale_step_is_caught_whatever_the_offset(monkeypatch, name):
    """With the cell's own ``check_every``, the offset at 0 and a step
    that keeps answering with variant 0's outputs, the held calls are
    still one of each variant in turn."""
    init = solve.VariantCalls.__init__

    def at_zero(self, *a, **k):
        init(self, *a, **k)
        self.offset = 0

    original = solve.Program.__call__
    broken = {}

    def call(self, args):
        if self not in broken:
            broken[self] = stale(lambda a: original(self, a))
        return broken[self](args)

    monkeypatch.setattr(solve.VariantCalls, "__init__", at_zero)
    monkeypatch.setattr(solve.Program, "__call__", call)
    cell, config = small_cell(name)
    cell["params"]["check_every"] = run.load_cell(name)[0]["params"][
        "check_every"]
    r = run.run_cell(name, cell, config, SEED, 0.1, False, ["cpu"],
                     t_start=time.perf_counter())
    assert not r["correct"], r["check"]
    assert r["failed"] > 0


def _break_step(monkeypatch, fault):
    from ecckd_tpu_torch.cli import scale_bench
    make_step = scale_bench.make_step

    def broken_make_step(mode):
        return FAULTS[fault](make_step(mode))

    monkeypatch.setattr(scale_bench, "make_step", broken_make_step)


def test_stream_sound_run_is_correct():
    r = run_small("l60_stream_4card_c262k")
    assert r["correct"] and r["failed"] == 0
    assert r["device"]["count"] == 4


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_stream_faults_are_caught(monkeypatch, fault):
    _break_step(monkeypatch, fault)
    r = run_small("l60_stream_4card_c262k")
    assert not r["correct"], r["check"]


def test_stream_exchange_left_out_is_caught(monkeypatch):
    """The exchange between cards left out: the second card's piece of
    each chunk never reaches host memory (its rows stay zero)."""
    from ecckd_tpu_torch.parallel import scale
    fetch = scale._PinnedRing.fetch

    def broken_fetch(self, outs, n):
        host, events = fetch(self, outs, n)
        lo, hi = outs.span(1)
        host = tuple(h.clone() for h in host)
        for h in host:
            h[lo:hi] = 0.0
        return host, events

    monkeypatch.setattr(scale._PinnedRing, "fetch", broken_fetch)
    r = run_small("l60_stream_4card_c262k")
    assert not r["correct"], r["check"]


def test_traced_runs_read_their_host_metrics():
    r = run_small("l60_rfmip_calls", traced=True)
    assert r["correct"]
    assert r["metrics"]["host_issue_ms.calls"]["value"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    s = run_small("l60_stream_4card_c262k", traced=True)
    assert s["correct"]
    assert 0 < s["metrics"]["stream_issue_share"]["value"] <= 100
    assert s["metrics"]["stream_drain_wait_share"]["value"] >= 0
    # No device here: the device readers find nothing and are left out.
    assert "device_idle_share.stream" not in s["metrics"]
    assert torch.cuda.is_available() or "busy_s" in s["device"]


@pytest.mark.parametrize("bad, correct", [(0, True), (1, True), (2, True),
                                          (13, False), (128, False)])
def test_one_column_near_resonance_passes_a_fault_in_more_does_not(
        bad, correct):
    """The number compared is the 99th percentile of the held columns'
    errors: of 256 columns, one or two far off (a column near the
    two-stream resonance) pass, 5 % or half of them fail, and so does a
    single non-finite value."""
    from radbench import check
    gen = torch.Generator().manual_seed(5)
    ref = tuple(100.0 + torch.rand((256, 61), generator=gen,
                                   dtype=torch.float64) for _ in range(4))
    got = [r.float() for r in ref]
    got[3][:bad] += 1.0
    limits = {"flux_err_p99": 1e-5}
    v = check.judge([({}, [tuple(got)])], lambda b: ref,
                    solve.LwSwSolve.OUTPUTS, limits)
    assert v["correct"] is correct and v["columns"] == 256
    assert (v["failed"] > 0) is (not correct)
    got[0][7, 3] = float("nan")
    v = check.judge([({}, [tuple(got)])], lambda b: ref,
                    solve.LwSwSolve.OUTPUTS, limits)
    assert not v["correct"]
