"""PyTorch port: the staging of the LW-only and SW-only kernels (K3
csrc/lw.cu and K4 csrc/sw.cu, the body of csrc/staged.cuh with one band),
their argument layout, and their plain versions on columns too deep for
shared memory.

The kernels run only on a card; these tests hold what the host decides
for them:

* ``staged.stage_plan`` with one band (``ngpt = 0`` for the other): floats
  per column, C, shared memory or a device slice, threads per block and
  where the layer parameters go, against counts written out here by hand
  from csrc/common.cuh's row layout, on an H100's and an A100's shared
  memory; no parameter stage for either;
* the ctypes mirrors of ``LwArgs`` and ``SwArgs``: field order as
  csrc/lw.cu and csrc/sw.cu declare it, offsets and size by hand;
* ``lw_fluxes_plain`` and ``sw_fluxes_plain`` at float64 at the depth the
  kernels stage in device memory, against JAX's XLA ``lw_fluxes`` /
  ``sw_fluxes``: max|d| / flux scale <= 1e-7, so the reference the card
  holds those cases against is itself held.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_lwsw_tiling import GASES_LW, GASES_SW, H100, c_fields
from torch_parity import (ckd_paths, flux_batch, jax_concs,  # noqa: F401
                          load_both, torch_concs)
from ecckd_tpu import pipeline as jpipe
from ecckd_tpu_torch.ops.cuda import binding, lw, plan, staged, sw

torch.set_num_threads(2)

A100 = (166_912, 167_936)
# Depths the single-band kernels stage in device memory (a column does not
# fit in an H100's 232,448 B per block): LW at 32 g-points and 1 angle
# from nlay 593, SW at 27 g-points from nlay 424.
DEVICE_DEPTH = {"lw": 600, "sw": 430}


def by_hand(kernel, nlay, ngpt, n_ang, limits):
    """(floats per column, C, shared, shared bytes, threads, parameters in
    rows) of a single-band launch, from csrc/common.cuh's layout."""
    if kernel == "lw":
        rows = 3 * nlay if n_ang == 1 else 3 * nlay + 1  # tr/src or tau/B
        per_layer = 4 + 4 + GASES_LW[0] + 3 * GASES_LW[1]
        sweeps = n_ang
    else:
        rows = 5 * nlay + 2        # r_dif, t_dif, r_dir+1, t_dir, t+1
        per_layer = 4 + GASES_SW[0] + 3 * GASES_SW[1]
        sweeps = 1
    in_rows = ngpt <= 32 and per_layer <= ngpt
    floats = (rows * ngpt + 2 * (nlay + 1) * sweeps
              + (0 if in_rows else per_layer * nlay))
    fit = limits[0] // (4 * floats)
    if fit == 0:
        return floats, 2, False, 0, 512, in_rows
    c = min(fit, 2)
    smem = c * 4 * floats
    threads = 512 if 2 * (smem + 1024) <= limits[1] else 1024
    return floats, c, True, smem, threads, in_rows


def single_plan(kernel, nlay, ngpt, n_ang, limits):
    if kernel == "lw":
        return staged.stage_plan(nlay, ngpt, 0, n_ang, GASES_LW, (0, 0),
                               *limits)
    return staged.stage_plan(nlay, 0, ngpt, 1, (0, 0), GASES_SW, *limits)


CASES = ([("lw", n_ang) for n_ang in (1, 2, 3, 4)] + [("sw", 1)])


@pytest.mark.parametrize("limits", [H100, A100], ids=["h100", "a100"])
@pytest.mark.parametrize("ngpt", [27, 32, 36])
@pytest.mark.parametrize("nlay", [1, 2, 8, 60, 137, 300, "device"])
@pytest.mark.parametrize("kernel,n_ang", CASES)
def test_single_band_stage_plan_matches_the_count_by_hand(kernel, n_ang,
                                                          nlay, ngpt,
                                                          limits):
    nlay = DEVICE_DEPTH[kernel] if nlay == "device" else nlay
    p = single_plan(kernel, nlay, ngpt, n_ang, limits)
    floats, c, shared, smem, threads, in_rows = by_hand(kernel, nlay, ngpt,
                                                        n_ang, limits)
    assert p.col_floats == floats and p.bytes_per_column == 4 * floats
    assert (p.slots, p.shared, p.shared_bytes, p.threads) == (c, shared,
                                                             smem, threads)
    assert (p.prm_floats == 0) == in_rows
    band_floats = floats - p.acc_floats - p.prm_floats
    assert (p.lw_floats, p.sw_floats) == ((band_floats, 0) if kernel == "lw"
                                          else (0, band_floats))
    # The parameters sit in the layer's first row of the band, else after
    # the accumulators.
    if in_rows:
        assert (p.prm_base, p.prm_stride) == (0, ngpt)
    else:
        assert p.prm_base == band_floats + p.acc_floats
    assert p.prm_sw == (8 + GASES_LW[0] + 3 * GASES_LW[1] if kernel == "lw"
                        else 4)


def test_single_band_stage_plan_at_the_main_path_and_the_device_depth():
    """Literal numbers: nlay 60 at one angle stages 23,528 B per LW column
    (32 g-points) and 33,104 B per SW column (27), two per block, two
    blocks of 512 threads per SM; the device depth is the first that does
    not fit one column in an H100's block."""
    k3 = single_plan("lw", 60, 32, 1, H100)
    assert (k3.bytes_per_column, k3.slots, k3.shared_bytes, k3.threads) == (
        23528, 2, 47056, 512)
    k4 = single_plan("sw", 60, 27, 1, H100)
    assert (k4.bytes_per_column, k4.slots, k4.shared_bytes, k4.threads) == (
        33104, 2, 66208, 512)
    for kernel, depth, ngpt in (("lw", 593, 32), ("sw", 424, 27)):
        assert single_plan(kernel, depth - 1, ngpt, 1, H100).shared
        assert not single_plan(kernel, depth, ngpt, 1, H100).shared
    # lw_rrtmgp's 36 g-points: a second g-chunk, so the parameters get a
    # place of their own.
    rr = single_plan("lw", 60, 36, 1, H100)
    assert rr.prm_floats == 60 * (8 + 7 + 3) and rr.prm_stride == 18


def test_block_shape_follows_the_sweep_warps_and_shared_memory():
    """Blocks of 1024 / blocks_per_sm threads where that many fit; half as
    many blocks where the sweep warps and one optics warp would not fit in
    a block, or the blocks' shared memory not in the SM."""
    base = dict(nlay=60, ngpt_lw=32, ngpt_sw=0, n_angles=1,
                gases_lw=GASES_LW, gases_sw=(0, 0), block_shared=H100[0],
                sm_shared=H100[1])
    threads = lambda blocks, **kw: staged.stage_plan(
        blocks_per_sm=blocks, **{**base, **kw}).threads
    assert threads(4) == 256
    assert threads(4, n_angles=4) == 256        # 4 sweep + 1 optics warps
    # Eight blocks of 47,056 B do not fit in 233,472 B; four do.
    assert threads(8) == 256
    # At nlay 8 eight fit, but 4 warps cannot hold 4 sweep warps + 1.
    assert threads(8, nlay=8) == 128
    assert threads(8, nlay=8, n_angles=4) == 256
    # The merged kernel's two columns of 56,632 B: two blocks per SM; at 4
    # angles (58,224 B) one.
    merged = dict(ngpt_sw=27, gases_sw=GASES_SW)
    assert threads(4, **merged) == 512
    assert threads(4, n_angles=4, **merged) == 1024
    assert staged.stage_plan(blocks_per_sm=2, max_slots=3, **base).slots == 3
    # S sets of sweep warps: the most up to the request that divide C,
    # and blocks large enough to hold them and one optics warp.
    sets = lambda **kw: staged.stage_plan(**{**base, **kw}).sets
    assert sets(max_slots=4, sets=4) == 4 and sets(max_slots=4, sets=3) == 2
    assert sets(max_slots=3, sets=2) == 1 and sets(sets=2) == 2
    assert threads(4, n_angles=4, sets=2) == 512     # 2 x 4 + 1 > 8 warps
    assert threads(2, n_angles=4, max_slots=4, sets=4) == 1024
    with pytest.raises(ValueError, match="max_slots"):
        staged.stage_plan(max_slots=5, **base)


@pytest.mark.parametrize("kernel,n_ang", CASES)
@pytest.mark.parametrize("nlay", [30, 60, 137, 300])
def test_single_band_kernels_have_no_parameter_stage(kernel, n_ang, nlay):
    """The stage is the merged kernel's: its LW sweep warps write the next
    column's layer parameters beside the SW sweep.  K3's LW sweep warps
    are its only sweeps, so the passes would lengthen each slot's turn (2
    to 30 % slower where an H100 timed it, PERF.md §6), and K4 has no LW
    sweep warps.  ``stage_plan`` gives neither a stage, and asked for one
    it raises; the plan is the same as without the request."""
    blocks, slots, sets = staged.SHAPES[kernel]
    ng_lw, ng_sw = (32, 0) if kernel == "lw" else (0, 27)
    ask = lambda **kw: staged.stage_plan(
        nlay, ng_lw, ng_sw, n_ang, GASES_LW if ng_lw else (0, 0),
        GASES_SW if ng_sw else (0, 0), *H100, blocks_per_sm=blocks,
        max_slots=slots, sets=sets, **kw)
    assert not ask().prm_stage and ask() == ask(param_stage=False)
    with pytest.raises(ValueError, match="parameter stage"):
        ask(param_stage=True)


@pytest.mark.parametrize("name", ["LwArgs", "SwArgs"])
def test_single_band_args_mirror_the_c_structs(name):
    args = getattr(binding, name)
    source = {"LwArgs": "lw.cu", "SwArgs": "sw.cu"}[name]
    assert [f for f, _ in args._fields_] == c_fields(name, source)
    # Atmos 48, Grid 40, Band 728, then LwSolve 96 or SwSolve 56 bytes,
    # then the 64-byte Tile.
    solve = 96 if name == "LwArgs" else 56
    assert args.tile.offset == 48 + 40 + 728 + solve
    assert ctypes.sizeof(args) == 48 + 40 + 728 + solve + 64
    assert binding.ARGS[source[:-3]] is args


def test_the_kernel_for_the_prepared_bands():
    lw_in = plan.LwInputs.__new__(plan.LwInputs)
    sw_in = plan.SwInputs.__new__(plan.SwInputs)
    assert staged.kernel_name(lw_in, None) == "lw"
    assert staged.kernel_name(None, sw_in) == "sw"
    assert staged.kernel_name(lw_in, sw_in) == "lwsw"
    # Each names its wrapper module's kernel and its argument mirror.
    assert {n: binding.ARGS[n].__name__ for n in ("lw", "sw", "lwsw")} == {
        "lw": "LwArgs", "sw": "SwArgs", "lwsw": "LwswArgs"}


def _scale_err(got, refs):
    scale = max(float(np.abs(np.asarray(r)).max()) for r in refs)
    return max(float(np.abs(g.numpy() - np.asarray(r)).max())
               for g, r in zip(got, refs)) / scale


@pytest.mark.parametrize("n_angles", [1, 3])
def test_lw_plain_f64_at_the_device_depth_matches_jax_xla(ckd_paths,
                                                          n_angles):
    nlay = DEVICE_DEPTH["lw"]
    jl, tl = load_both(ckd_paths["lw"])
    b = flux_batch(2, nlay, seed=12, dtype=torch.float64)
    J = lambda k: jnp.asarray(b[k])
    ref = jpipe.lw_fluxes(jl, J("plev"), J("tlay"), J("tlev"), J("tsfc"),
                          J("emis"), jax_concs(b["gases"]),
                          n_gauss_angles=n_angles, backend="xla")
    T = lambda k: torch.as_tensor(b[k])
    got = lw.lw_fluxes_plain(tl, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                             T("emis")[:, None].expand(2, tl.ngpt),
                             torch_concs(b["gases"]),
                             n_gauss_angles=n_angles)
    assert all(tuple(g.shape) == (2, nlay + 1) for g in got)
    err = _scale_err(got, (ref.flux_up, ref.flux_dn))
    assert err <= 1e-7, err
    # That depth is the one K3 stages in device memory.
    assert not single_plan("lw", nlay, tl.ngpt, n_angles, H100).shared


def test_sw_plain_f64_at_the_device_depth_matches_jax_xla(ckd_paths):
    nlay = DEVICE_DEPTH["sw"]
    js, ts = load_both(ckd_paths["sw"])
    b = flux_batch(2, nlay, seed=13, dtype=torch.float64)
    J = lambda k: jnp.asarray(b[k])
    ref = jpipe.sw_fluxes(js, J("plev"), J("tlay"), jax_concs(b["gases"]),
                          J("alb"), J("tsi"), J("sza"), backend="xla")
    T = lambda k: torch.as_tensor(b[k])
    got = sw.sw_fluxes_plain(ts, T("plev"), T("tlay"),
                             torch_concs(b["gases"]), T("alb"), T("tsi"),
                             T("sza"))
    assert all(tuple(g.shape) == (2, nlay + 1) for g in got)
    err = _scale_err(got, (ref.flux_up, ref.flux_dn))
    assert err <= 1e-7, err
    assert not single_plan("sw", nlay, ts.ngpt, 1, H100).shared
