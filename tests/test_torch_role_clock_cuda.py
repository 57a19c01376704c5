"""PyTorch port on a CUDA card: the merged kernel's timed build
(ops/cuda/role_clock.py, csrc/role_clock.cuh), in which every warp
counts the cycles of its waits and phases by role.

At the launch shapes of the seven batch cells of the benchmark (65,536
columns; nlay 60, 91 and 137, 1 and 3 LW angles, float32 and float64, 32
and 36 LW g-points with the emissivity per band, and at nlay 91 the
Jacobian instantiation, whose LW sweep carries the Jacobian):

* the timed build's fluxes equal the plain build's bit for bit, on the
  same plan and the same blocks per SM;
* every role has the warps the plan gives it (at 36 LW g-points one LW
  sweep warp per g-chunk: per block 10 optics, 4 LW sweep and 2 SW sweep
  warps, the g-chunk 1 warps counted once more on their own row), every
  share lies in [0, 100] %, and no warp's counted waits and phases
  exceed its total;
* the two planted faults, each in the timed build alone, move the shares
  their way at nlay 60 by at least 10 percentage points: a slower SW
  sweep (``slow_sw``) raises the optics warps' wait and lowers the SW
  sweep warps', a slower optics (``slow_optics``) the reverse.

These tests need a card and skip without one (marker ``cuda``); they
import neither jax nor tests/conftest.py:

    python -m pytest tests/test_torch_role_clock_cuda.py --noconftest -q -s

(``-s`` shows each case's record and shares.)
"""

import os

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.io.synthetic import (example_flux_batch,
                                          write_synthetic_ckd)
from ecckd_tpu_torch.models.loader import load_ckd_model

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
NCOL = 65536
CELLS = {
    # cell: (LW kind, nlay, LW angles, dtype)
    "l60_batch": ("lw_fsck", 60, 1, torch.float32),
    "l137_batch": ("lw_fsck", 137, 1, torch.float32),
    "l60_3ang": ("lw_fsck", 60, 3, torch.float32),
    "l60_f64_batch": ("lw_fsck", 60, 1, torch.float64),
    "l60_rrtmgp_batch": ("lw_rrtmgp", 60, 1, torch.float32),
    "l91_batch": ("lw_fsck", 91, 1, torch.float32),
    "l91_jac_batch": ("lw_fsck", 91, 1, torch.float32),
}
JAC = {"l91_jac_batch"}
"""The cells whose calls launch K1's Jacobian instantiation."""
PLANT_MOVE = 10.0
"""Percentage points that a plant must move the share it raises."""


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    d = tmp_path_factory.mktemp("ckd_role_clock")
    out = {}
    for kind in ("lw_fsck", "lw_rrtmgp", "sw_wide"):
        path = os.path.join(d, f"{kind}.nc")
        write_synthetic_ckd(path, kind, seed=7)
        for dt in (torch.float32, torch.float64):
            out[kind, dt] = load_ckd_model(path, dtype=dt, device="cuda")
    return out


def prepared(models, cell):
    """The merged kernel's prepared inputs at ``cell``'s launch shape."""
    from ecckd_tpu_torch.ops.cuda import plan
    kind, nlay, n_ang, dtype = CELLS[cell]
    lw, sw = models[kind, dtype], models["sw_wide", dtype]
    b = example_flux_batch(NCOL, nlay, np.dtype(str(dtype).split(".")[1]),
                           device="cuda")
    t = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()
         if k != "concs"}
    emis = t["emis"][:, None].expand(-1, lw.ngpt).contiguous()
    if lw.nband > 1:
        gen = torch.Generator(device="cuda").manual_seed(7)
        emis = lw.gpt_weights_per_band(0.9 + 0.1 * torch.rand(
            (NCOL, lw.nband), generator=gen, device="cuda",
            dtype=dtype)).contiguous()
    return plan.prepare(lw, sw, t["plev"], t["tlay"], t["tlev"], t["tsfc"],
                        emis, b["concs"], t["alb"], t["tsi"], t["sza"],
                        n_gauss_angles=n_ang)


def timed_run(prep, plant="", **launch):
    """(outputs, record, shares) of one launch on the timed build;
    ``launch``: ``jac`` for the Jacobian instantiation."""
    from ecckd_tpu_torch.ops.cuda import lwsw, role_clock
    with role_clock.timed(plant) as timing:
        out = lwsw._kernel_core(*prep, NCOL, **launch)
    return out, timing.record, timing.shares


@pytest.mark.parametrize("cell", list(CELLS))
def test_timed_build_counts_every_role_and_changes_no_bit(models, cell):
    from ecckd_tpu_torch.ops.cuda import binding, lwsw, role_clock, staged
    prep = prepared(models, cell)
    launch = {"jac": True} if cell in JAC else {}
    plain = lwsw._kernel_core(*prep, NCOL, **launch)
    got, record, shares = timed_run(prep, **launch)
    torch.cuda.synchronize()
    print(f"\n{cell}: shares {shares}\n{cell}: record {record}")
    assert len(got) == len(plain) == (5 if launch else 4)
    for g, p in zip(got, plain):
        assert torch.isfinite(g).all() and torch.equal(g, p)
    plan, per_sm = staged.occupancy(*prep, **launch)
    assert staged.occupancy(*prep, lib=role_clock.library(),
                            **launch) == (plan, per_sm)
    blocks = min(NCOL, per_sm * torch.cuda.get_device_properties(
        0).multi_processor_count)
    n_lw = CELLS[cell][2] * plan.lw_warps
    n_sweep = plan.sets * (n_lw + 1)
    assert plan.lw_warps == (2 if CELLS[cell][0] == "lw_rrtmgp" else 1)
    assert record["optics"]["warps"] == blocks * (plan.threads // 32
                                                  - n_sweep)
    assert record["lw_sweep"]["warps"] == blocks * plan.sets * n_lw
    assert record["sw_sweep"]["warps"] == blocks * plan.sets
    assert record["lw_chunk1"]["warps"] == blocks * plan.sets * (
        plan.lw_warps - 1)
    if cell == "l60_rrtmgp_batch":
        per_block = {r: record[r]["warps"] // blocks
                     for r in ("optics", "lw_sweep", "sw_sweep")}
        assert per_block == {"optics": 10, "lw_sweep": 4, "sw_sweep": 2}
    if CELLS[cell][0] == "lw_fsck":
        assert record["lw_chunk1"] == dict.fromkeys(role_clock.COUNTERS, 0)
    cycles = role_clock.sweep_cycles(record, NCOL)
    print(f"{cell}: sweep cycles a column and warp {cycles}")
    assert cycles["sw_sweep"] > 0 and cycles["lw_chunk0"] > 0
    assert (cycles["lw_chunk1"] is None) == (plan.lw_warps == 1)
    for role, c in record.items():
        assert c["over"] == 0, role
        assert sum(c[k] for k in role_clock.SPANS) <= c["total"], role
    for role in role_clock.WAITS:
        assert 0.0 <= shares[role] <= 100.0, role
    assert record["optics"]["optics"] > 0
    assert record["lw_sweep"]["sweep"] > 0 and record["sw_sweep"]["sweep"] > 0
    assert record["optics"]["full"] == record["sw_sweep"]["free"] == 0
    assert binding.library("lwsw") is not role_clock.library()


def test_plants_move_the_shares_their_way(models):
    prep = prepared(models, "l60_batch")
    plain, _, base = timed_run(prep)
    moved = {}
    for plant in ("slow_sw", "slow_optics"):
        got, record, moved[plant] = timed_run(prep, plant)
        print(f"\nl60_batch {plant}: shares {moved[plant]} against "
              f"{base}\nl60_batch {plant}: record {record}")
        for g, p in zip(got, plain):
            assert torch.equal(g, p)
        assert all(c["over"] == 0 for c in record.values())
    slow_sw, slow_optics = moved["slow_sw"], moved["slow_optics"]
    assert slow_sw["optics"] >= base["optics"] + PLANT_MOVE
    assert slow_sw["sw_sweep"] < base["sw_sweep"]
    assert slow_optics["sw_sweep"] >= base["sw_sweep"] + PLANT_MOVE
    assert slow_optics["optics"] < base["optics"]
