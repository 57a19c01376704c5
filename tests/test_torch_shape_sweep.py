"""PyTorch port: the on-card depth sweep (tools/shape_sweep_cuda.py).

The sweep runs only on a card; these tests hold what it stands on:

* its depths and column counts are tools/shape_sweep_chip.py's;
* its anchor, ``lwsw_fluxes_plain`` at float64, against the JAX package's
  XLA path at float64 (``pipeline.lw_fluxes`` / ``sw_fluxes``,
  ``backend="xla"``) at every sweep depth at 1 and 3 angles, 5 columns:
  the LW outputs within 1e-10 of the flux scale.  The SW outputs carry
  the plain version's float32 floors (the g = 0 two-stream's tau >= 1e-8
  and thin-layer thresholds, tests/test_torch_lwsw.py), which grow with
  the thin top layers of deep columns (1.7e-8 of the flux scale at nlay
  137): they are held at that test's 1e-7.  The port's torch route at
  float64 (``pipeline.lw_sw_fluxes(backend="torch")``), which has no such
  floors, is held element by element at rtol 1e-10;
* ``stage_plan`` at each depth gives the staging regime counted by hand
  from the bytes per column on an H100's shared memory;
* the table mode picks both the bounds and the artifact's name;
* the tool exits 1 when a leg is outside its bounds, and raises without
  a card.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_lwsw_tiling import GASES_LW, GASES_SW, H100
from torch_parity import (ckd_paths, flux_batch, jax_concs,  # noqa: F401
                          load_both, torch_concs)
from ecckd_tpu import pipeline as jpipe
from ecckd_tpu_torch import pipeline as tpipe
from ecckd_tpu_torch.ops.cuda import staged
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_plain
from tools import shape_sweep_chip, shape_sweep_cuda

torch.set_num_threads(2)

LEGS = [(nlay, ang) for nlay, _ in shape_sweep_cuda.SHAPES for ang in (1, 3)]


def test_the_sweep_runs_the_jax_sweeps_shapes():
    assert shape_sweep_cuda.SHAPES == shape_sweep_chip.SHAPES
    assert shape_sweep_cuda.NCOL_TIME == shape_sweep_chip.NCOL_TIME
    assert all(ncol % 2 == 1 for _, ncol in shape_sweep_cuda.SHAPES)


def _jax_and_batch(ckd_paths, nlay, ang):
    jl, tl = load_both(ckd_paths["lw"])
    js, ts = load_both(ckd_paths["sw"])
    b = flux_batch(5, nlay, seed=nlay, dtype=torch.float64)
    J = lambda k: jnp.asarray(b[k])
    jc = jax_concs(b["gases"])
    ref_lw = jpipe.lw_fluxes(jl, J("plev"), J("tlay"), J("tlev"), J("tsfc"),
                             J("emis"), jc, n_gauss_angles=ang,
                             backend="xla")
    ref_sw = jpipe.sw_fluxes(js, J("plev"), J("tlay"), jc, J("alb"),
                             J("tsi"), J("sza"), backend="xla")
    ref = [np.asarray(x) for x in (ref_lw.flux_up, ref_lw.flux_dn,
                                   ref_sw.flux_up, ref_sw.flux_dn)]
    T = lambda k: torch.as_tensor(b[k])
    args = (T("plev"), T("tlay"), T("tlev"), T("tsfc"))
    surface = (torch_concs(b["gases"], torch.float64), T("alb"), T("tsi"),
               T("sza"))
    return tl, ts, args, T("emis"), surface, ref


@pytest.mark.parametrize("nlay,ang", LEGS)
def test_plain_f64_matches_jax_xla_at_sweep_depths(ckd_paths, nlay, ang):
    tl, ts, args, emis, surface, ref = _jax_and_batch(ckd_paths, nlay, ang)
    got = lwsw_fluxes_plain(tl, ts, *args, emis[:, None].expand(5, tl.ngpt),
                            *surface, n_gauss_angles=ang)
    assert all(g.shape == (5, nlay + 1) for g in got)
    for band, bound in ((0, 1e-10), (2, 1e-7)):
        scale = max(np.abs(r).max() for r in ref[band:band + 2])
        for g, r in zip(got[band:band + 2], ref[band:band + 2]):
            err = float(np.abs(g.numpy() - r).max() / scale)
            assert err <= bound, (nlay, ang, band, err)


@pytest.mark.parametrize("nlay,ang", LEGS)
def test_torch_route_f64_matches_jax_xla_at_sweep_depths(ckd_paths, nlay,
                                                         ang):
    tl, ts, args, emis, surface, ref = _jax_and_batch(ckd_paths, nlay, ang)
    f_lw, f_sw = tpipe.lw_sw_fluxes(tl, ts, *args, emis, *surface,
                                    n_gauss_angles=ang, backend="torch")
    for g, r in zip((f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up,
                     f_sw.flux_dn), ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-10, atol=0)


def _regime_by_hand(nlay: int, n_ang: int):
    """K1's (C, S, threads) from the bytes per column (csrc/common.cuh's
    rows: LW 3 nlay (+1 at 2-4 angles) x 32, SW (5 nlay + 2) x 27, 2
    (nlay + 1) accumulators per sweep, the layer parameters in the SW
    rows) and an H100's 232,448 / 233,472 B per block / SM with 1,024 B
    reserved per block: two slots per block where they fit, two blocks of
    512 threads where both fit in the SM, one slot where only one does."""
    floats = ((3 * nlay + (n_ang > 1)) * 32 + (5 * nlay + 2) * 27
              + 2 * (n_ang + 1) * (nlay + 1))
    col = 4 * floats
    block, sm = H100
    if 2 * col > block:
        return 1, 1, 1024
    return 2, 2, 512 if 2 * (2 * col + 1024) <= sm else 1024


@pytest.mark.parametrize("nlay,ang", LEGS + [(61, 1), (62, 1), (123, 1),
                                             (124, 1), (247, 1)])
def test_stage_plan_at_sweep_depths_is_the_regime_by_hand(nlay, ang):
    blocks, slots, sets = staged.SHAPES["lwsw"]
    p = staged.stage_plan(nlay, 32, 27, ang, GASES_LW, GASES_SW, *H100,
                          blocks_per_sm=blocks, max_slots=slots, sets=sets)
    assert p.shared
    assert (p.slots, p.sets, p.threads) == _regime_by_hand(nlay, ang)


def test_the_sweeps_regimes():
    """The three regimes the sweep's depths span at 1 angle."""
    blocks, slots, sets = staged.SHAPES["lwsw"]
    got = {nlay: staged.stage_plan(nlay, 32, 27, 1, GASES_LW, GASES_SW,
                                   *H100, blocks_per_sm=blocks,
                                   max_slots=slots, sets=sets)
           for nlay, _ in shape_sweep_cuda.SHAPES}
    assert {n: (p.slots, p.threads) for n, p in got.items()} == {
        30: (2, 512), 47: (2, 512), 60: (2, 512), 91: (2, 1024),
        137: (1, 1024)}
    assert got[137].bytes_per_column == 940 * 137 + 232


def test_the_mode_picks_the_bounds_and_the_artifact():
    assert shape_sweep_cuda.artifact("bf16x3") == "SHAPES_CUDA.json"
    assert shape_sweep_cuda.artifact("highest") == "SHAPES_CUDA.json"
    assert shape_sweep_cuda.artifact("bf16") == "SHAPES_CUDA_FAST.json"
    assert shape_sweep_cuda.artifact("default") == "SHAPES_CUDA_FAST.json"
    assert shape_sweep_cuda.bounds("bf16x3") == {"same_mode": 5e-5}
    assert shape_sweep_cuda.bounds("bf16") == {"same_mode": 5e-5,
                                               "vs_exact": 5e-4}


def _leg(rel=1e-6, vs_exact=None, cols=1e6):
    parity = {"max_rel": rel}
    if vs_exact is not None:
        parity["vs_exact"] = vs_exact
    return {"parity": dict(parity), "parity_timed": dict(parity),
            "columns_per_sec": cols}


def test_judge_holds_each_bound():
    j = shape_sweep_cuda.judge
    assert j(_leg(), "bf16x3")
    assert not j(_leg(rel=6e-5), "bf16x3")
    assert not j(_leg(rel=float("nan")), "bf16x3")
    assert not j(_leg(cols=0.0), "bf16x3")
    assert j(_leg(vs_exact=2e-4), "bf16")
    assert not j(_leg(vs_exact=0.0), "bf16")
    assert not j(_leg(vs_exact=6e-4), "bf16")
    timed_off = _leg()
    timed_off["parity_timed"]["max_rel"] = 1e-4
    assert not j(timed_off, "bf16x3")


def _stub_card(monkeypatch, legs):
    """The tool's card work replaced: a named card, a built library, and
    a sweep that returns ``legs`` for the first depth."""
    from ecckd_tpu_torch.ops.cuda import build
    monkeypatch.setattr(shape_sweep_cuda, "card",
                        lambda: "Stub card, 700.00 W")
    monkeypatch.setattr(build, "build", lambda name, defines=(): None)
    seen = {}

    def sweep(**kw):
        from ecckd_tpu_torch import config
        seen["mode"] = config.mxu_precision()
        return {"nlay30_ncol293": {"nlay": 30, "parity_ncol": 293,
                                   "angles": legs}}
    monkeypatch.setattr(shape_sweep_cuda, "sweep", sweep)
    return seen


@pytest.mark.parametrize("fast", [False, True])
def test_the_tool_writes_its_modes_artifact(monkeypatch, tmp_path, fast):
    from ecckd_tpu_torch import config
    seen = _stub_card(monkeypatch, {
        "1": _leg(vs_exact=2e-4 if fast else None)})
    argv = ["--fast"] if fast else []
    assert shape_sweep_cuda.main(argv, out_dir=str(tmp_path)) == 0
    name = "SHAPES_CUDA_FAST.json" if fast else "SHAPES_CUDA.json"
    assert [p.name for p in tmp_path.iterdir()] == [name]
    rec = json.loads((tmp_path / name).read_text())
    assert rec["pass"] and rec["device"] == "Stub card, 700.00 W"
    assert rec["mxu_precision"] == ("bf16" if fast else "bf16x3")
    assert seen["mode"] == rec["mxu_precision"]
    assert config.mxu_precision() == "bf16x3"    # restored


def test_the_tool_exits_1_when_a_leg_exceeds_its_bound(monkeypatch,
                                                       tmp_path):
    _stub_card(monkeypatch, {"1": _leg(), "3": _leg(rel=7e-5)})
    assert shape_sweep_cuda.main([], out_dir=str(tmp_path)) == 1
    rec = json.loads((tmp_path / "SHAPES_CUDA.json").read_text())
    assert rec["pass"] is False
    # Off the protocol's columns nothing is written.
    _stub_card(monkeypatch, {"1": _leg()})
    off = tmp_path / "off"
    off.mkdir()
    assert shape_sweep_cuda.main(["--ncol", "4096"], out_dir=str(off)) == 0
    assert list(off.iterdir()) == []


def test_the_tool_raises_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        shape_sweep_cuda.main([], out_dir=str(tmp_path))
    assert list(tmp_path.iterdir()) == []
