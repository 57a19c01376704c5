"""The Jacobian reference and the check of ``l91_jac_batch``.

* ``reference/rte_jac.py`` against the finite difference of
  ``reference/rte.py`` at float64: its J is rte's flux_up at T_sfc + 1 K
  less at T_sfc, to rounding, at 1 and 3 angles; its other outputs are
  rte's, bit for bit; its Planck change is rte.planck's across the
  table's ends.
* Through the harness's own ``run_cell`` on the CPU at a test's size, a
  sound run of ``l91_jac_batch`` is ``correct``, and a Jacobian that is
  wrong is not: J from a 1 K colder surface, J zeroed, and J as the
  difference of two float32 solves (the cancelling form).
"""
import time

import pytest
import torch

from radbench import inputs, run, solve
from radbench.reference import rte, rte_jac
from radbench.tests.helpers import SEED, SMALL
from radbench.traffic import batch_jac

torch.set_num_threads(2)
CELL = "l91_jac_batch"


@pytest.fixture(scope="module")
def ckd(tmp_path_factory):
    _, config = run.load_cell(CELL)
    paths = solve.write_ckd_files(config, str(tmp_path_factory.mktemp("j")))
    return solve.read_reference_ckd(paths)


@pytest.mark.parametrize("n_ang", [1, 3])
def test_rte_jac_is_the_finite_difference_of_rte(ckd, n_ang):
    lw, sw = ckd
    b = inputs.make_batch(12, 91, inputs.generator(3, "cpu"), "cpu")
    got = rte_jac.fluxes(lw, sw, b, n_ang, block=5)
    base = rte.fluxes(lw, sw, b, n_ang, block=5)
    warm = rte.fluxes(lw, sw, dict(b, tsfc=b["tsfc"].double() + 1.0), n_ang,
                      block=5)
    assert all(torch.equal(g, r) for g, r in zip(got[:4], base))
    fd = warm[0] - base[0]
    err = (got[4] - fd).abs().amax(1) / got[4].abs().amax(1)
    assert float(err.max()) <= 1e-10
    assert torch.equal(warm[1], base[1])
    assert not bool(got[5].any()) and bool((got[4] > 0).all())


def test_planck_change_is_rte_planck_at_one_kelvin_apart(ckd):
    lw, _ = ckd
    t0, t1 = float(lw.planck_temperature[0]), float(lw.planck_temperature[-1])
    temps = torch.tensor([50.0, t0 - 1.5, t0 - 1.0, t0 - 0.25, t0, 250.7,
                          t1 - 1.2, t1 - 0.5, t1, t1 + 3.0],
                         dtype=torch.float64)
    got = rte_jac.planck_change(lw, temps)
    want = rte.planck(lw, temps + 1.0) - rte.planck(lw, temps)
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-11


def run_small(seed=SEED):
    cell, config = run.load_cell(CELL)
    cell["params"].update(SMALL["batch"], ncol=256, column_chunk=64,
                          check_columns_per_chunk=30)
    return run.run_cell(CELL, cell, config, seed, 0.2, False, ["cpu"],
                        t_start=time.perf_counter())


def test_a_sound_run_is_correct():
    r = run_small()
    assert r["correct"] and r["failed"] == 0
    assert r["check"]["flux_err_p99"]["value"] < 1e-6


def _shifted(args, dt):
    a = list(args)
    a[5] = a[5] + dt          # (lw model, sw model, plev, tlay, tlev, tsfc, ...)
    return tuple(a)


FAULTS = {
    "colder": lambda call, args: call(args)[:4] + (
        call(_shifted(args, -1.0))[4],),
    "zeroed": lambda call, args: call(args)[:4] + (
        torch.zeros_like(call(args)[4]),),
    "cancelling": lambda call, args: call(args)[:4] + (
        call(_shifted(args, 1.0))[0] - call(args)[0],),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_wrong_jacobian_is_caught(monkeypatch, fault):
    original = batch_jac.JacProgram.__call__
    monkeypatch.setattr(
        batch_jac.JacProgram, "__call__",
        lambda self, args: FAULTS[fault](lambda a: original(self, a), args))
    r = run_small()
    assert not r["correct"], r["check"]
    assert r["failed"] > 0
