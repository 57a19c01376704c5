"""PyTorch port on a CUDA card: the merged LW+SW, LW and SW kernels (one
staged body, csrc/staged.cuh), their routing, the stream
(parallel/scale.py; the sharded stream as three pieces on one card),
captured calls on every card (two or more) and the refusal of inputs
that require grad.

These tests need a card and skip without one (marker ``cuda``).  They
import neither jax nor tests/conftest.py, so on a machine with a card and
no JAX they run with:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel (float32) is held against its plain PyTorch version at float64
on the card: <= 5e-5 of the flux scale per output, the chip-parity metric.
The merged kernel's double instantiation (float64 inputs) is held against
the same plain version with float64's constants (``compute=float64``)
within ``F64_BOUND``, which the float32 kernel on the same inputs must
fail.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ecckd_tpu_torch import pipeline
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.io.synthetic import write_synthetic_ckd
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.ops.cuda.lw import lw_fluxes_cuda, lw_fluxes_plain
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda, lwsw_fluxes_plain
from ecckd_tpu_torch.ops.cuda.sw import sw_fluxes_cuda, sw_fluxes_plain

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
BOUND = 5e-5
F64_BOUND = 1e-10
"""The f64 kernel's largest column error / flux scale against the plain
version at f64: rounding in double (it reads ~1e-14), where the float32
kernel reads ~1e-7 on every column."""


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    d = tmp_path_factory.mktemp("ckd_cuda")
    out = {}
    for key, kind, neg, n_p in (
            ("lw", "lw_fsck", False, 53), ("sw", "sw_wide", False, 53),
            ("lw_neg", "lw_fsck", True, 53), ("sw_neg", "sw_wide", True, 53),
            ("lw_rrtmgp", "lw_rrtmgp", False, 53),
            ("sw_p47", "sw_wide", False, 47)):
        path = str(d / f"{key}.nc")
        write_synthetic_ckd(path, kind, seed=3, negative_entry=neg,
                            n_pressure=n_p)
        for dt in (torch.float32, torch.float64):
            out[key, dt] = load_ckd_model(path, dtype=dt, device="cuda")
    return out


def batch(ncol, nlay, dtype, seed=0, drop=()):
    """Heterogeneous columns on the card: pressures over two decades at the
    surface, h2o over five decades, ch4 below its reference, day, grazing
    and night suns; the gases in ``drop`` left out.  Values are rounded to
    float32 once for both dtypes."""
    rng = np.random.default_rng(seed)
    p_sfc = np.logspace(np.log10(500.0), np.log10(1.05e5), ncol)
    plev = np.stack([np.geomspace(1.0, s, nlay + 1) for s in p_sfc])
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        device="cuda", dtype=dtype)
    gases = dict(h2o=10.0 ** rng.uniform(-6.8, -1.5, (ncol, nlay)),
                 o3=10.0 ** rng.uniform(-8.0, -5.2, (ncol, nlay)),
                 co2=np.full(ncol, 4.0e-4), ch4=np.full(ncol, 1.2e-6),
                 n2o=np.full(ncol, 3.3e-7), o2=np.full(ncol, 0.2095),
                 cfc11=np.full(ncol, 2e-10), cfc12=np.full(ncol, 5e-10))
    gases = {k: v for k, v in gases.items() if k not in drop}
    return dict(
        plev=t(plev), tlay=t(rng.uniform(150.0, 320.0, (ncol, nlay))),
        tlev=t(rng.uniform(150.0, 320.0, (ncol, nlay + 1))),
        tsfc=t(rng.uniform(200.0, 330.0, ncol)),
        emis=t(np.linspace(0.7, 1.0, ncol)),
        alb=t(np.linspace(0.02, 0.9, ncol)), tsi=t(np.full(ncol, 1361.0)),
        sza=t(np.linspace(0.0, 120.0, ncol)),
        concs=GasConcs.create([(k, t(v)) for k, v in gases.items()]))


def solve(fn, lw, sw, b, emis, **kw):
    return fn(lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"], emis,
              b["concs"], b["alb"], b["tsi"], b["sza"], **kw)


@pytest.mark.parametrize("pair", ["", "_neg"])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_kernel_matches_plain_f64(models, n_angles, pair):
    lw, sw = models["lw" + pair, torch.float32], models["sw" + pair,
                                                         torch.float32]
    ncol, nlay = 301, 23
    b32, b64 = batch(ncol, nlay, torch.float32), batch(ncol, nlay,
                                                       torch.float64)
    expand = lambda e: e[:, None].expand(ncol, lw.ngpt).contiguous()
    before = lwsw_fluxes_cuda.launches
    got = solve(lwsw_fluxes_cuda, lw, sw, b32, expand(b32["emis"]),
                n_gauss_angles=n_angles, column_chunk=128)
    torch.cuda.synchronize()
    assert lwsw_fluxes_cuda.launches == before + 3      # 128 + 128 + 45
    ref = solve(lwsw_fluxes_plain, models["lw" + pair, torch.float64],
                models["sw" + pair, torch.float64], b64, expand(b64["emis"]),
                n_gauss_angles=n_angles)
    for band in (slice(0, 2), slice(2, 4)):
        scale = max(float(r.abs().max()) for r in ref[band])
        for g, r in zip(got[band], ref[band]):
            assert g.dtype == torch.float32 and torch.isfinite(g).all()
            err = float((g.double() - r).abs().max()) / scale
            assert err <= BOUND, err


def column_errors(got, ref):
    """Each column's largest |got - ref| over levels and outputs, over the
    band's flux scale (radbench's check)."""
    out = []
    for band in (0, 2):
        scale = max(float(ref[band].abs().max()),
                    float(ref[band + 1].abs().max()))
        out += [(got[k].double() - ref[k]).abs().amax(1) / scale
                for k in (band, band + 1)]
    return torch.stack(out).amax(0).cpu().numpy()


@pytest.mark.parametrize("nlay", [47, 60, 91, 137])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_f64_kernel_matches_plain_f64(models, nlay, n_angles):
    """The merged kernel's double instantiation at every f64 route (nlay
    47 and 60 in shared memory, 91 split, 137 in the device slice) against
    its plain version at f64, on 1037 columns in chunks of 512: the 99th
    percentile and the largest column within F64_BOUND; the float32
    kernel on the same inputs reads 100 times more and fails it."""
    from ecckd_tpu_torch.ops.cuda import plan, staged
    f32, f64 = torch.float32, torch.float64
    ncol = 1037
    b32, b64 = batch(ncol, nlay, f32, seed=nlay), batch(ncol, nlay, f64,
                                                         seed=nlay)
    expand = lambda b: b["emis"][:, None].expand(ncol, 32).contiguous()
    kw = dict(n_gauss_angles=n_angles)
    counts = lambda: (lwsw_fluxes_cuda.launches,
                      lwsw_fluxes_cuda.fast_launches,
                      lwsw_fluxes_cuda.f64_launches)
    before = counts()
    got = solve(lwsw_fluxes_cuda, models["lw", f64], models["sw", f64], b64,
                expand(b64), column_chunk=512, **kw)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 3)
    assert all(g.dtype == f64 and torch.isfinite(g).all() for g in got)
    ref = solve(lwsw_fluxes_plain, models["lw", f64], models["sw", f64], b64,
                expand(b64), compute=f64, **kw)
    got32 = solve(lwsw_fluxes_cuda, models["lw", f32], models["sw", f32],
                  b32, expand(b32), column_chunk=512, **kw)
    e64, e32 = column_errors(got, ref), column_errors(got32, ref)
    p64, p32 = np.percentile(e64, 99), np.percentile(e32, 99)
    assert e64.max() <= F64_BOUND, (p64, e64.max(), int(e64.argmax()))
    assert p32 >= 100 * p64 and p32 > F64_BOUND and e32.max() > F64_BOUND
    # The route the f64 plan takes at 8 B a word.
    atm, lw_in, sw_in = plan.prepare(
        models["lw", f64], models["sw", f64], b64["plev"], b64["tlay"],
        b64["tlev"], b64["tsfc"], expand(b64), b64["concs"], b64["alb"],
        b64["tsi"], b64["sza"], n_angles)
    p = staged.plan_for(atm, lw_in, sw_in)
    assert p.word_bytes == 8
    assert p.route == {47: "shared", 60: "shared", 91: "split",
                       137: "device"}[nlay]


def test_captured_f64_calls_replay_the_eager_call(models):
    """capture.jit of lw_sw_fluxes at float64: every call (eager, capture,
    replays) counts ceil(ncol / chunk) launches in ``f64_launches`` and
    none elsewhere, and each replay equals the eager call on its inputs
    bit for bit."""
    from ecckd_tpu_torch.utils import capture
    f64 = torch.float64
    lw, sw = models["lw", f64], models["sw", f64]
    args = lambda b: (lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                      b["emis"], b["concs"], b["alb"], b["tsi"], b["sza"])
    leaves = lambda o: [o[0].flux_up, o[0].flux_dn, o[1].flux_up,
                        o[1].flux_dn]
    batches = [batch(1037, 60, f64, seed=s) for s in (0, 1, 2, 0)]
    refs = [leaves(pipeline.lw_sw_fluxes(*args(b), column_chunk=512))
            for b in batches]
    jitted = capture.jit(pipeline.lw_sw_fluxes)
    counts = lambda: (lwsw_fluxes_cuda.launches,
                      lwsw_fluxes_cuda.fast_launches,
                      lwsw_fluxes_cuda.f64_launches)
    for b, ref in zip(batches, refs):
        before = counts()
        got = leaves(jitted(*args(b), column_chunk=512))
        torch.cuda.synchronize()
        assert counts() == (before[0], before[1], before[2] + 3)
        assert all(g.dtype == f64 and torch.equal(g, r)
                   for g, r in zip(got, ref))
    (entry,) = jitted.entries.values()
    assert entry.graph is not None


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_kernel_splits_the_staging_at_nlay137(models, n_angles, mode):
    """nlay 137: one whole column fits in a block's shared memory, two do
    not, two without their LW rows do.  The merged kernel keeps two slots
    per block on the split route (each slot's LW rows in a device slice,
    ops/cuda/staged.py stage_plan), with the parameter stage at one angle
    (in a place of its own), counts each launch once in ``launches``
    (``fast_launches``) and matches the plain version at f64 in its table
    mode; at nlay 60 the plan stages whole columns in shared memory."""
    from ecckd_tpu_torch.ops.cuda import plan, staged
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    ncol, nlay = 1037, 137
    b32, b64 = batch(ncol, nlay, torch.float32, seed=4), batch(
        ncol, nlay, torch.float64, seed=4)
    expand = lambda e: e[:, None].expand(e.shape[0], lw.ngpt).contiguous()
    prep = plan.prepare(lw, sw, b32["plev"], b32["tlay"], b32["tlev"],
                        b32["tsfc"], expand(b32["emis"]), b32["concs"],
                        b32["alb"], b32["tsi"], b32["sza"], n_angles,
                        fast=mode == "bf16")
    stage, per_sm = staged.occupancy(*prep)
    assert (stage.route, stage.prm_stage, stage.slots, stage.sets,
            stage.threads) == ("split", n_angles == 1, 2, 2, 1024)
    assert per_sm == 1
    counter = "fast_launches" if mode == "bf16" else "launches"
    launches = lambda: getattr(lwsw_fluxes_cuda, counter)
    before = launches()
    got = solve(lwsw_fluxes_cuda, lw, sw, b32, expand(b32["emis"]),
                n_gauss_angles=n_angles, column_chunk=512, mxu_mode=mode)
    torch.cuda.synchronize()
    assert launches() == before + 3                     # 512 + 512 + 13
    ref = solve(lwsw_fluxes_plain, models["lw", torch.float64],
                models["sw", torch.float64], b64, expand(b64["emis"]),
                n_gauss_angles=n_angles, mxu_mode=mode)
    for band in (slice(0, 2), slice(2, 4)):
        assert_close(got[band], ref[band])
    shallow = batch(301, 60, torch.float32)
    shallow_plan = staged.plan_for(*plan.prepare(
        lw, sw, shallow["plev"], shallow["tlay"], shallow["tlev"],
        shallow["tsfc"], expand(shallow["emis"]), shallow["concs"],
        shallow["alb"], shallow["tsi"], shallow["sza"], n_angles,
        fast=mode == "bf16"))
    assert (shallow_plan.route, shallow_plan.prm_stage) == (
        "shared", n_angles == 1)
    before = launches()
    solve(lwsw_fluxes_cuda, lw, sw, shallow, expand(shallow["emis"]),
          n_gauss_angles=n_angles, mxu_mode=mode)
    torch.cuda.synchronize()
    assert launches() == before + 1


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_parameter_stage_changes_no_bit(models, n_angles, mode):
    """At nlay 60 the merged kernel at one angle takes the parameter stage
    (ops/cuda/staged.py stage_plan: the sets' LW sweep warps write each
    slot's next layer parameters), counts each launch once in
    ``launches`` (``fast_launches``), and gives the outputs of the plan
    without it bit for bit; at 3 angles the plan declines it."""
    from ecckd_tpu_torch.ops.cuda import lwsw, plan, staged
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    ncol, nlay = 1037, 60
    b = batch(ncol, nlay, torch.float32, seed=5)
    expand = lambda e: e[:, None].expand(e.shape[0], lw.ngpt).contiguous()
    prep = plan.prepare(lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                        expand(b["emis"]), b["concs"], b["alb"], b["tsi"],
                        b["sza"], n_angles, fast=mode == "bf16")
    default = staged.plan_for(*prep)
    assert (default.route, default.prm_stage) == ("shared", n_angles == 1)
    counter = "fast_launches" if mode == "bf16" else "launches"
    before = getattr(lwsw_fluxes_cuda, counter)
    got = solve(lwsw_fluxes_cuda, lw, sw, b, expand(b["emis"]),
                n_gauss_angles=n_angles, column_chunk=512, mxu_mode=mode)
    torch.cuda.synchronize()
    assert getattr(lwsw_fluxes_cuda, counter) == before + 3  # 512, 512, 13
    if n_angles == 1:
        props = torch.cuda.get_device_properties(b["tlay"].device)
        off = staged.stage_plan(
            nlay, lw.ngpt, sw.ngpt, 1, staged.band_gases(prep[1].plan),
            staged.band_gases(prep[2].plan),
            props.shared_memory_per_block_optin,
            props.shared_memory_per_multiprocessor, *staged.SHAPES["lwsw"],
            param_stage=False)
        assert off == dataclasses.replace(
            default, prm_stage=False, prm_base=off.prm_base,
            prm_stride=off.prm_stride)
        plain = lwsw._kernel_core(*prep, 512, plan=off)
        torch.cuda.synchronize()
        for g, r in zip(got, lwsw._night_masked(prep[2], tuple(plain))):
            assert torch.equal(g, r)


@pytest.mark.parametrize("nlay,dtype,mode", [
    (124, torch.float32, "bf16x3"), (137, torch.float32, "bf16x3"),
    (175, torch.float32, "bf16x3"), (137, torch.float32, "bf16"),
    (80, torch.float64, "bf16x3")])
def test_split_parameter_stage_changes_no_bit(models, nlay, dtype, mode):
    """On the split route at one angle the merged kernel takes the
    parameter stage (the layer parameters in a place of their own after
    each slot's accumulators, computed by the optics warps before they
    wait for the slot) and gives the outputs of the same plan without it:
    bit for bit at float32 in both table modes (nlay 124-175), within
    1e-14 of the flux scale at float64 (nlay 80), whose outputs may differ
    in the last bits between plans."""
    from ecckd_tpu_torch.ops.cuda import lwsw, plan, staged
    lw, sw = models["lw", dtype], models["sw", dtype]
    ncol = 2003
    b = batch(ncol, nlay, dtype, seed=8)
    expand = lambda e: e[:, None].expand(e.shape[0], lw.ngpt).contiguous()
    prep = plan.prepare(lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                        expand(b["emis"]), b["concs"], b["alb"], b["tsi"],
                        b["sza"], 1, fast=mode == "bf16")
    on = staged.plan_for(*prep)
    assert (on.route, on.prm_stage, on.slots, on.sets) == ("split", True, 2,
                                                          2)
    assert (on.prm_base, on.prm_stride, on.prm_floats) == (
        on.sw_floats + on.acc_floats, 26, 26 * nlay)
    props = torch.cuda.get_device_properties(b["tlay"].device)
    off = staged.stage_plan(
        nlay, lw.ngpt, sw.ngpt, 1, staged.band_gases(prep[1].plan),
        staged.band_gases(prep[2].plan), props.shared_memory_per_block_optin,
        props.shared_memory_per_multiprocessor, *staged.SHAPES["lwsw"],
        param_stage=False, word_bytes=b["tlay"].element_size())
    assert off == dataclasses.replace(on, prm_stage=False, prm_floats=0,
                                      prm_base=off.prm_base,
                                      prm_stride=off.prm_stride)
    got = lwsw._kernel_core(*prep, ncol, plan=on)
    ref = lwsw._kernel_core(*prep, ncol, plan=off)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        if dtype == torch.float32:
            assert torch.equal(g, r)
        else:
            err = float((g - r).abs().max() / r.abs().max())
            assert err <= 1e-14, err


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_kernel_stages_deep_columns_in_device_memory(models, n_angles, mode):
    """nlay 300 does not fit in shared memory: the merged kernel stages
    it in a device slice per block (ops/cuda/staged.py stage_plan) and
    still matches the plain version at f64 in its table mode."""
    from ecckd_tpu_torch.ops.cuda import plan, staged
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    ncol, nlay = 61, 300
    b32, b64 = batch(ncol, nlay, torch.float32, seed=2), batch(
        ncol, nlay, torch.float64, seed=2)
    expand = lambda e: e[:, None].expand(ncol, lw.ngpt).contiguous()
    prep = plan.prepare(lw, sw, b32["plev"], b32["tlay"], b32["tlev"],
                        b32["tsfc"], expand(b32["emis"]), b32["concs"],
                        b32["alb"], b32["tsi"], b32["sza"], n_angles,
                        fast=mode == "bf16")
    stage, per_sm = staged.occupancy(*prep)
    assert not stage.shared and stage.shared_bytes == 0 and per_sm >= 1
    counter = "fast_launches" if mode == "bf16" else "launches"
    before = getattr(lwsw_fluxes_cuda, counter)
    got = solve(lwsw_fluxes_cuda, lw, sw, b32, expand(b32["emis"]),
                n_gauss_angles=n_angles, mxu_mode=mode)
    torch.cuda.synchronize()
    assert getattr(lwsw_fluxes_cuda, counter) == before + 1
    ref = solve(lwsw_fluxes_plain, models["lw", torch.float64],
                models["sw", torch.float64], b64, expand(b64["emis"]),
                n_gauss_angles=n_angles, mxu_mode=mode)
    for band in (slice(0, 2), slice(2, 4)):
        assert_close(got[band], ref[band])


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("kernel,n_angles", [("lw", 1), ("lw", 3),
                                             ("sw", 1)])
def test_single_band_kernels_stage_deep_columns_in_device_memory(
        models, kernel, n_angles, mode):
    """nlay 600 (LW) and 430 (SW) do not fit in shared memory: K3 and K4
    stage them in a device slice per block (ops/cuda/staged.py stage_plan)
    and still match their plain versions at f64 in the table mode."""
    from ecckd_tpu_torch.ops.cuda import plan, staged
    ncol, nlay = 61, {"lw": 600, "sw": 430}[kernel]
    b32, b64 = batch(ncol, nlay, torch.float32, seed=5), batch(
        ncol, nlay, torch.float64, seed=5)
    fast = mode == "bf16"
    if kernel == "lw":
        m = lambda dt: models["lw", dt]
        emis = lambda b: b["emis"][:, None].expand(
            ncol, m(torch.float32).ngpt).contiguous()
        run = lambda fn, dt, b, **kw: fn(
            m(dt), b["plev"], b["tlay"], b["tlev"], b["tsfc"], emis(b),
            b["concs"], n_gauss_angles=n_angles, mxu_mode=mode, **kw)
        prep = plan.prepare_lw(m(torch.float32), b32["plev"], b32["tlay"],
                               b32["tlev"], b32["tsfc"], emis(b32),
                               b32["concs"], n_angles, fast=fast)
        cuda_fn, plain_fn = lw_fluxes_cuda, lw_fluxes_plain
        bands = (prep[1], None)
    else:
        m = lambda dt: models["sw", dt]
        run = lambda fn, dt, b, **kw: fn(
            m(dt), b["plev"], b["tlay"], b["concs"], b["alb"], b["tsi"],
            b["sza"], mxu_mode=mode, **kw)
        prep = plan.prepare_sw(m(torch.float32), b32["plev"], b32["tlay"],
                               b32["concs"], b32["alb"], b32["tsi"],
                               b32["sza"], fast=fast)
        cuda_fn, plain_fn = sw_fluxes_cuda, sw_fluxes_plain
        bands = (None, prep[1])
    stage, per_sm = staged.occupancy(prep[0], *bands)
    assert not stage.shared and stage.shared_bytes == 0 and per_sm >= 1
    counter = "fast_launches" if fast else "launches"
    before = getattr(cuda_fn, counter)
    got = run(cuda_fn, torch.float32, b32)
    torch.cuda.synchronize()
    assert getattr(cuda_fn, counter) == before + 1
    assert_close(got, run(plain_fn, torch.float64, b64))


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("kernel,lw_key,n_angles", [
    ("lwsw", "lw", 1), ("lwsw", "lw_rrtmgp", 3), ("lw", "lw", 1),
    ("lw", "lw_rrtmgp", 3), ("sw", None, 1)])
def test_kernels_on_other_band_shapes_in_shared_memory(models, kernel,
                                                       lw_key, n_angles,
                                                       mode):
    """Without cfc11, cfc12 and n2o both bands have 4 dense gases, not the
    shipped shapes' 7 (LW) and 5 (SW) that the kernels instantiate as
    template constants (csrc/staged.cuh), so each kernel takes its
    run-time instantiation, here staged in shared memory; it matches the
    plain version at f64 in the table mode."""
    from ecckd_tpu_torch.ops.cuda import plan, staged
    ncol, nlay, fast = 301, 23, mode == "bf16"
    drop = ("cfc11", "cfc12", "n2o")
    b32, b64 = (batch(ncol, nlay, dt, seed=4, drop=drop)
                for dt in (torch.float32, torch.float64))
    sw_key = None if kernel == "lw" else "sw"
    m = lambda key, dt: models[key, dt] if key else None
    ngpt = m(lw_key, torch.float32).ngpt if lw_key else 1
    emis = lambda b: b["emis"][:, None].expand(ncol, ngpt).contiguous()
    lw_args = lambda b: (b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                         emis(b), b["concs"])
    sw_args = lambda b: (b["plev"], b["tlay"], b["concs"], b["alb"],
                         b["tsi"], b["sza"])
    lw32, sw32 = m(lw_key, torch.float32), m(sw_key, torch.float32)
    if kernel == "lwsw":
        atm, lw_in, sw_in = plan.prepare(lw32, sw32, *lw_args(b32),
                                         *sw_args(b32)[3:], n_angles,
                                         fast=fast)
        run = lambda fn, dt, b: solve(fn, m(lw_key, dt), m(sw_key, dt), b,
                                      emis(b), n_gauss_angles=n_angles,
                                      mxu_mode=mode)
        cuda_fn, plain_fn, bands = (lwsw_fluxes_cuda, lwsw_fluxes_plain,
                                    (slice(0, 2), slice(2, 4)))
    elif kernel == "lw":
        (atm, lw_in), sw_in = plan.prepare_lw(lw32, *lw_args(b32), n_angles,
                                              fast=fast), None
        run = lambda fn, dt, b: fn(m(lw_key, dt), *lw_args(b),
                                   n_gauss_angles=n_angles, mxu_mode=mode)
        cuda_fn, plain_fn, bands = (lw_fluxes_cuda, lw_fluxes_plain,
                                    (slice(0, 2),))
    else:
        lw_in, (atm, sw_in) = None, plan.prepare_sw(sw32, *sw_args(b32),
                                                    fast=fast)
        run = lambda fn, dt, b: fn(m(sw_key, dt), *sw_args(b),
                                   mxu_mode=mode)
        cuda_fn, plain_fn, bands = (sw_fluxes_cuda, sw_fluxes_plain,
                                    (slice(0, 2),))
    for band in (lw_in, sw_in):
        assert band is None or staged.band_gases(band.plan) == (4, 1)
    stage, per_sm = staged.occupancy(atm, lw_in, sw_in)
    assert stage.shared and per_sm >= 1
    counter = "fast_launches" if fast else "launches"
    before = getattr(cuda_fn, counter)
    got = run(cuda_fn, torch.float32, b32)
    torch.cuda.synchronize()
    assert getattr(cuda_fn, counter) == before + 1
    ref = run(plain_fn, torch.float64, b64)
    for band in bands:
        assert_close(got[band], ref[band])


def test_kernel_with_layer_parameters_in_their_own_place(models,
                                                        monkeypatch):
    """A SW band of more than 32 g-points, or more layer parameters than
    one r_dif row holds, puts the layer parameters after the accumulators
    (stage_plan); forced here on the synthetic pair, whose parameters fit
    in the row."""
    import dataclasses
    from ecckd_tpu_torch.ops.cuda import staged
    plan_for = staged.plan_for

    def own_place(atm, lw_in, sw_in):
        p = plan_for(atm, lw_in, sw_in)
        per_layer = p.prm_sw + sum(
            1 if n == 0 else 3 for n in
            (s.kind for s in sw_in.plan.slices))
        nlay = atm.tlay.shape[1]
        return dataclasses.replace(
            p, prm_floats=per_layer * nlay, prm_stride=per_layer,
            prm_base=p.lw_floats + p.sw_floats + p.acc_floats)

    monkeypatch.setattr(staged, "plan_for", own_place)
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    ncol, nlay = 301, 23
    b32, b64 = batch(ncol, nlay, torch.float32), batch(ncol, nlay,
                                                       torch.float64)
    expand = lambda e: e[:, None].expand(ncol, lw.ngpt).contiguous()
    got = solve(lwsw_fluxes_cuda, lw, sw, b32, expand(b32["emis"]))
    torch.cuda.synchronize()
    ref = solve(lwsw_fluxes_plain, models["lw", torch.float64],
                models["sw", torch.float64], b64, expand(b64["emis"]))
    for band in (slice(0, 2), slice(2, 4)):
        assert_close(got[band], ref[band])


def assert_close(got, ref):
    """max|d| over the flux scale of the outputs, per output."""
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        err = float((g.double() - r).abs().max()) / scale
        assert err <= BOUND, err


@pytest.mark.parametrize("model", ["lw", "lw_neg", "lw_rrtmgp"])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_lw_kernel_matches_plain_f64(models, n_angles, model):
    ncol, nlay = 301, 23
    b32, b64 = batch(ncol, nlay, torch.float32), batch(ncol, nlay,
                                                       torch.float64)
    lw = models[model, torch.float32]
    expand = lambda e: e[:, None].expand(ncol, lw.ngpt).contiguous()
    run = lambda fn, m, b, **kw: fn(m, b["plev"], b["tlay"], b["tlev"],
                                    b["tsfc"], expand(b["emis"]), b["concs"],
                                    n_gauss_angles=n_angles, **kw)
    before = lw_fluxes_cuda.launches
    got = run(lw_fluxes_cuda, lw, b32, column_chunk=128)
    torch.cuda.synchronize()
    assert lw_fluxes_cuda.launches == before + 3      # 128 + 128 + 45
    assert_close(got, run(lw_fluxes_plain, models[model, torch.float64], b64))


@pytest.mark.parametrize("model", ["sw", "sw_neg", "sw_p47"])
def test_sw_kernel_matches_plain_f64(models, model):
    ncol, nlay = 301, 23
    b32, b64 = batch(ncol, nlay, torch.float32), batch(ncol, nlay,
                                                       torch.float64)
    run = lambda fn, m, b, **kw: fn(m, b["plev"], b["tlay"], b["concs"],
                                    b["alb"], b["tsi"], b["sza"], **kw)
    before = sw_fluxes_cuda.launches
    got = run(sw_fluxes_cuda, models[model, torch.float32], b32,
              column_chunk=128)
    torch.cuda.synchronize()
    assert sw_fluxes_cuda.launches == before + 3
    assert_close(got, run(sw_fluxes_plain, models[model, torch.float64], b64))
    night = b32["sza"] >= 90.0
    assert not got[0][night].any() and not got[1][night].any()


def test_single_band_kernels_equal_the_merged_kernel(models):
    """One device body per band (csrc/common.cuh): on a mergeable pair the
    LW and SW kernels give the merged kernel's fluxes."""
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    b = batch(257, 19, torch.float32, seed=4)
    emis = b["emis"][:, None].expand(-1, lw.ngpt).contiguous()
    merged = solve(lwsw_fluxes_cuda, lw, sw, b, emis)
    single = (*lw_fluxes_cuda(lw, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                              emis, b["concs"]),
              *sw_fluxes_cuda(sw, b["plev"], b["tlay"], b["concs"], b["alb"],
                              b["tsi"], b["sza"]))
    torch.cuda.synchronize()
    for s, m in zip(single, merged):
        assert torch.equal(s, m)


def test_pipeline_routes_to_the_kernel(models):
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    b = batch(64, 9, torch.float32)
    call = lambda m_lw, m_sw, bb, **kw: pipeline.lw_sw_fluxes(
        m_lw, m_sw, bb["plev"], bb["tlay"], bb["tlev"], bb["tsfc"],
        bb["emis"], bb["concs"], bb["alb"], bb["tsi"], bb["sza"], **kw)
    counts = lambda: (lwsw_fluxes_cuda.launches, lw_fluxes_cuda.launches,
                      sw_fluxes_cuda.launches)
    delta = lambda before: tuple(a - b for a, b in zip(counts(), before))
    for backend, launched in (("auto", (1, 0, 0)), ("cuda", (1, 0, 0)),
                              ("torch", (0, 0, 0))):
        before = counts()
        call(lw, sw, b, backend=backend)
        assert delta(before) == launched, backend
    # A pair on two grids takes the LW and the SW kernel, not the merged one.
    sw47 = models["sw_p47", torch.float32]
    for backend in ("auto", "cuda"):
        before = counts()
        call(lw, sw47, b, backend=backend)
        assert delta(before) == (0, 1, 1), backend
    # lw_fluxes / sw_fluxes alone, banded surfaces included.
    before = counts()
    rr = models["lw_rrtmgp", torch.float32]
    pipeline.lw_fluxes(rr, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                       b["emis"][:, None].expand(-1, rr.nband), b["concs"],
                       n_gauss_angles=3)
    pipeline.sw_fluxes(sw, b["plev"], b["tlay"], b["concs"],
                       b["alb"][:, None].expand(-1, sw.nband), b["tsi"],
                       b["sza"], backend="cuda")
    assert delta(before) == (0, 1, 1)
    # float64 runs the merged kernel's double instantiation under auto and
    # cuda; K3 and K4 have none: a pair on two grids, or LW alone, takes
    # the torch path under auto and is refused under cuda.
    b64 = batch(64, 9, torch.float64)
    lw64, sw64 = models["lw", torch.float64], models["sw", torch.float64]
    for backend in ("auto", "cuda"):
        before, f64 = counts(), lwsw_fluxes_cuda.f64_launches
        call(lw64, sw64, b64, backend=backend)
        assert delta(before) == (0, 0, 0)
        assert lwsw_fluxes_cuda.f64_launches == f64 + 1
    before, f64 = counts(), lwsw_fluxes_cuda.f64_launches
    call(lw64, models["sw_p47", torch.float64], b64)
    pipeline.lw_fluxes(lw64, b64["plev"], b64["tlay"], b64["tlev"],
                       b64["tsfc"], b64["emis"], b64["concs"])
    assert delta(before) == (0, 0, 0)
    assert lwsw_fluxes_cuda.f64_launches == f64
    with pytest.raises(ValueError, match="K3.*float64"):
        call(lw64, models["sw_p47", torch.float64], b64, backend="cuda")
    with pytest.raises(ValueError, match="top_at_1"):
        call(lw, sw47, b, backend="cuda", top_at_1=False)
    with pytest.raises(ValueError, match="float32"):
        call(lw, sw, batch(64, 9, torch.float16), backend="cuda")
    # The fast mode has no float64 entry point: the wrapper raises.
    with pytest.raises(ValueError, match="fast mode"):
        solve(lwsw_fluxes_cuda, lw64, sw64, b64,
              b64["emis"][:, None].expand(64, lw.ngpt), mxu_mode="bf16")


def test_stream_through_the_merged_kernel(models):
    """parallel/scale.py on the card: every chunk's outputs, copied back
    through the pinned ring, equal the same step run unstreamed, and each
    chunk is one merged-kernel launch."""
    from ecckd_tpu_torch.parallel.scale import run_weak_scaling
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    chunks = [batch(512, 19, torch.float32, seed=10 + i) for i in range(5)]

    def step(b):
        flw, fsw = pipeline.lw_sw_fluxes(
            lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"], b["emis"],
            b["concs"], b["alb"], b["tsi"], b["sza"])
        return flw.flux_up, flw.flux_dn, fsw.flux_up, fsw.flux_dn

    seen = []
    before = lwsw_fluxes_cuda.launches
    m = run_weak_scaling(step, lambda i: (chunks[i],), 5, 512,
                         mesh=[torch.device("cuda", 0)], warmup=0,
                         consume=lambda host, i: seen.append(
                             (i, [a.copy() for a in host])), depth=2)
    assert lwsw_fluxes_cuda.launches - before == 5
    assert m["n_chunks"] == 5 and [i for i, _ in seen] == list(range(5))
    for i, host in seen:
        for h, ref in zip(host, step(chunks[i])):
            np.testing.assert_array_equal(h, ref.cpu().numpy())


@pytest.mark.parametrize("mode", ["full", "toa-net"])
def test_sharded_stream_equals_one_card(models, mode):
    """The sharded stream (scale_bench.resident_chunks, capture.jit of its
    step, the pinned ring's per-piece rows) as three pieces on card 0, the
    last one padded, equals the same chunks on one card bit for bit; one
    merged-kernel launch per chunk per piece."""
    from ecckd_tpu_torch.cli import scale_bench
    from ecckd_tpu_torch.io.synthetic import example_flux_batch
    from ecckd_tpu_torch.parallel.scale import run_weak_scaling
    from ecckd_tpu_torch.utils import capture
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    ncol, n_chunks = 1000, 4
    streams, launched = [], []
    for mesh in ([torch.device("cuda", 0)], [torch.device("cuda", 0)] * 3):
        seen = []
        before = lwsw_fluxes_cuda.launches
        run_weak_scaling(
            capture.jit(scale_bench.make_step(mode)),
            scale_bench.resident_chunks(lw, sw, example_flux_batch(
                ncol, 19, np.float32), mesh, ncol),
            n_chunks, ncol, mesh=mesh, warmup=1,
            consume=lambda host, i: seen.append((i, [a.copy()
                                                     for a in host])))
        launched.append(lwsw_fluxes_cuda.launches - before)
        streams.append(seen)
    assert launched == [n_chunks + 1, 3 * (n_chunks + 1)]
    one, three = streams
    assert [i for i, _ in three] == [i for i, _ in one] == list(
        range(n_chunks))
    for (_, got), (_, ref) in zip(three, one):
        for g, r in zip(got, ref):
            assert g.shape[0] == ncol and np.isfinite(g).all()
            np.testing.assert_array_equal(g, r)


def test_captured_calls_on_every_card(models):
    """capture.jit of lw_sw_fluxes on the same batch on every local card
    (two or more): warm-up, capture and replay on each card equal card
    0's eager call bit for bit, one entry and one graph per card."""
    from ecckd_tpu_torch.utils import capture
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more cards")
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    b = batch(512, 19, torch.float32)
    ref = [f.cpu() for out in solve(pipeline.lw_sw_fluxes, lw, sw, b,
                                    b["emis"])
           for f in (out.flux_up, out.flux_dn)]
    jitted = capture.jit(pipeline.lw_sw_fluxes)
    for d in range(n_cards):
        card = torch.device("cuda", d)
        on = {k: (GasConcs(values=tuple(v.to(card) for v in x.values),
                           names=x.names) if isinstance(x, GasConcs)
                  else x.to(card)) for k, x in b.items()}
        ml, ms = (lw.to(card), sw.to(card)) if d else (lw, sw)
        for _ in range(3):
            out = solve(jitted, ml, ms, on, on["emis"])
            got = [f.cpu() for o in out for f in (o.flux_up, o.flux_dn)]
            assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert len(jitted.entries) == n_cards
    assert all(e.graph is not None for e in jitted.entries.values())


def test_inputs_that_require_grad_keep_the_kernels_out(models):
    lw = models["lw", torch.float32]
    b = batch(64, 9, torch.float32)
    tlay = b["tlay"].clone().requires_grad_()
    call = lambda **kw: pipeline.lw_fluxes(
        lw, b["plev"], tlay, b["tlev"], b["tsfc"], b["emis"], b["concs"],
        **kw)
    before = lw_fluxes_cuda.launches
    call().flux_dn[:, -1].sum().backward()
    assert lw_fluxes_cuda.launches == before
    assert torch.isfinite(tlay.grad).all() and float(tlay.grad.sum()) > 0
    with pytest.raises(ValueError, match="requires grad"):
        call(backend="cuda")
    with pytest.raises(ValueError, match="requires grad"):
        lw_fluxes_cuda(lw, b["plev"], tlay, b["tlev"], b["tsfc"],
                       b["emis"][:, None].expand(-1, lw.ngpt), b["concs"])
    with torch.no_grad():        # no graph wanted: the kernel runs
        call()
    assert lw_fluxes_cuda.launches == before + 1


@pytest.mark.parametrize("kernel,lw_key,sw_key", [
    ("lwsw", "lw", "sw"), ("lwsw", "lw_neg", "sw_neg"), ("lw", "lw", None),
    ("lw", "lw_rrtmgp", None), ("sw", None, "sw"), ("sw", None, "sw_p47")])
def test_fast_kernels_match_the_fast_plain_version(models, kernel, lw_key,
                                                   sw_key):
    """The fast entry points (bf16 tables): within 5e-5 of the fast plain
    version at f64, within 5e-4 of the exact one and not equal to it; the
    fast launches are counted apart; an exact call after a fast one on the
    same model is the exact kernel's result bit for bit."""
    f32, f64 = torch.float32, torch.float64
    ncol, nlay = 301, 23
    b32, b64 = batch(ncol, nlay, f32, seed=6), batch(ncol, nlay, f64, seed=6)
    ng = models[lw_key, f32].ngpt if lw_key else 1
    emis = lambda b: b["emis"][:, None].expand(ncol, ng).contiguous()
    fns = {"lwsw": (lwsw_fluxes_cuda, lwsw_fluxes_plain),
           "lw": (lw_fluxes_cuda, lw_fluxes_plain),
           "sw": (sw_fluxes_cuda, sw_fluxes_plain)}[kernel]

    def run(fn, dt, b, **kw):
        lw = models[lw_key, dt] if lw_key else None
        sw = models[sw_key, dt] if sw_key else None
        if kernel == "lwsw":
            return solve(fn, lw, sw, b, emis(b), **kw)
        if kernel == "lw":
            return fn(lw, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                      emis(b), b["concs"], **kw)
        return fn(sw, b["plev"], b["tlay"], b["concs"], b["alb"], b["tsi"],
                  b["sza"], **kw)

    cuda_fn, plain_fn = fns
    exact_before = run(cuda_fn, f32, b32)
    before = (cuda_fn.launches, cuda_fn.fast_launches)
    fast = run(cuda_fn, f32, b32, mxu_mode="bf16", column_chunk=128)
    torch.cuda.synchronize()
    assert (cuda_fn.launches, cuda_fn.fast_launches) == (before[0],
                                                         before[1] + 3)
    exact_after = run(cuda_fn, f32, b32)
    assert all(torch.equal(a, e) for a, e in zip(exact_after, exact_before))
    ref_fast = run(plain_fn, f64, b64, mxu_mode="bf16")
    ref_exact = run(plain_fn, f64, b64)
    for band in range(0, len(fast), 2):
        sl = slice(band, band + 2)
        assert_close(fast[sl], ref_fast[sl])
        scale = max(float(r.abs().max()) for r in ref_exact[sl])
        err = max(float((g.double() - r).abs().max())
                  for g, r in zip(fast[sl], ref_exact[sl])) / scale
        assert 0.0 < err <= 5e-4, err


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("path", ["lw_sw_fluxes", "lw_fluxes", "sw_fluxes"])
def test_captured_calls_replay_the_eager_call(models, path, mode):
    """utils/capture.jit on the card: the first call runs eagerly, the
    second captures, every later one replays.  Each equals the eager call
    on its own inputs bit for bit, returns fresh tensors (an earlier
    result is not overwritten), and the launch counts grow by the kernel
    launches that ran, in the table mode's counter only."""
    from ecckd_tpu_torch import config
    from ecckd_tpu_torch.utils import capture
    f32 = torch.float32
    lw, sw = models["lw", f32], models["sw", f32]
    fn = getattr(pipeline, path)
    args = {"lw_sw_fluxes": lambda b: (
                lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                b["emis"], b["concs"], b["alb"], b["tsi"], b["sza"]),
            "lw_fluxes": lambda b: (
                lw, b["plev"], b["tlay"], b["tlev"], b["tsfc"], b["emis"],
                b["concs"]),
            "sw_fluxes": lambda b: (
                sw, b["plev"], b["tlay"], b["concs"], b["alb"], b["tsi"],
                b["sza"])}[path]
    wrapper = {"lw_sw_fluxes": lwsw_fluxes_cuda, "lw_fluxes": lw_fluxes_cuda,
               "sw_fluxes": sw_fluxes_cuda}[path]
    counter = "fast_launches" if mode == "bf16" else "launches"
    other = "launches" if mode == "bf16" else "fast_launches"
    leaves = lambda out: [x for f in (out if isinstance(out, tuple)
                                      else (out,))
                          for x in (f.flux_up, f.flux_dn)]
    jitted = capture.jit(fn)
    batches = [batch(301, 23, f32, seed=s) for s in (0, 1, 2, 0)]
    config.set_mxu_precision(mode)
    try:
        refs = [leaves(fn(*args(b))) for b in batches]
        outs = []
        for b in batches:
            before = (getattr(wrapper, counter), getattr(wrapper, other))
            outs.append(leaves(jitted(*args(b))))
            torch.cuda.synchronize()
            assert (getattr(wrapper, counter), getattr(wrapper, other)) == (
                before[0] + 1, before[1])
    finally:
        config.set_mxu_precision("bf16x3")
    for got, ref in zip(outs, refs):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    ptrs = [o.data_ptr() for out in outs for o in out]
    assert len(set(ptrs)) == len(ptrs)
    (entry,) = jitted.entries.values()
    assert entry.graph is not None


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
def test_captured_multi_angle_calls_count_every_launch(models, mode):
    """RFMIP physics index 2 on the main path: capture.jit of lw_sw_fluxes
    at 3 angles on 65,536 x 60 columns.  The plan stages whole columns in
    shared memory without the parameter stage (at 1 angle with it); the
    eager call, the capture and each replay count every launch of the
    merged kernel once in ``launches`` (``fast_launches``); the replay
    matches the plain version at f64 in its table mode (computed in
    blocks)."""
    from ecckd_tpu_torch import config
    from ecckd_tpu_torch.ops.cuda import plan, staged
    from ecckd_tpu_torch.utils import capture
    lw, sw = models["lw", torch.float32], models["sw", torch.float32]
    ncol, nlay, chunk = 65_536, 60, 16_384
    b32 = batch(ncol, nlay, torch.float32, seed=6)
    emis = b32["emis"][:, None].expand(ncol, lw.ngpt).contiguous()
    for n, stage in ((3, False), (1, True)):
        p = staged.plan_for(*plan.prepare(
            lw, sw, b32["plev"], b32["tlay"], b32["tlev"], b32["tsfc"],
            emis, b32["concs"], b32["alb"], b32["tsi"], b32["sza"], n,
            fast=mode == "bf16"))
        assert (p.route, p.prm_stage) == ("shared", stage)
    counter = "fast_launches" if mode == "bf16" else "launches"
    launches = lambda: getattr(lwsw_fluxes_cuda, counter)
    jitted = capture.jit(pipeline.lw_sw_fluxes)
    call = lambda n: jitted(lw, sw, b32["plev"], b32["tlay"], b32["tlev"],
                            b32["tsfc"], b32["emis"], b32["concs"],
                            b32["alb"], b32["tsi"], b32["sza"],
                            n_gauss_angles=n, column_chunk=chunk)
    config.set_mxu_precision(mode)
    try:
        for _ in range(3):              # eager, capture, replay
            before = launches()
            f_lw, f_sw = call(3)
            torch.cuda.synchronize()
            assert launches() == before + 4
        before = launches()
        call(1)
        torch.cuda.synchronize()
        assert launches() == before + 4
    finally:
        config.set_mxu_precision("bf16x3")
    got = (f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn)
    b64 = batch(ncol, nlay, torch.float64, seed=6)
    lw64, sw64 = models["lw", torch.float64], models["sw", torch.float64]
    parts = []
    for c0 in range(0, ncol, 8192):
        sl = slice(c0, c0 + 8192)
        part = {k: v[sl] for k, v in b64.items() if k != "concs"}
        part["concs"] = GasConcs.create(
            [(k, v[sl]) for k, v in zip(b64["concs"].names,
                                        b64["concs"].values)])
        emis = part["emis"][:, None].expand(-1, lw64.ngpt).contiguous()
        parts.append(solve(lwsw_fluxes_plain, lw64, sw64, part, emis,
                           n_gauss_angles=3, mxu_mode=mode))
    ref = tuple(torch.cat(p) for p in zip(*parts))
    for band in (slice(0, 2), slice(2, 4)):
        assert_close(got[band], ref[band])


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("nlay", [60, 137])
def test_split_parameter_stage_at_36_gpoints_changes_no_bit(models, nlay,
                                                            mode):
    """lw_rrtmgp's 36 LW g-points (pairs over the lanes) on the split
    route at one angle, the emissivity per band: K1 with the parameter
    stage (two blocks of 512 threads per SM at nlay 60, one of 1024 at
    137) gives the four flux outputs of the same plan without it bit for
    bit, in both table modes."""
    from ecckd_tpu_torch.ops.cuda import lwsw, plan, staged
    lw, sw = models["lw_rrtmgp", torch.float32], models["sw", torch.float32]
    ncol = 4096
    b = batch(ncol, nlay, torch.float32, seed=8)
    rng = np.random.default_rng(nlay)
    band = torch.as_tensor(rng.uniform(0.9, 1.0, (ncol, lw.nband)),
                           dtype=torch.float32, device="cuda")
    prep = plan.prepare(lw, sw, b["plev"], b["tlay"], b["tlev"], b["tsfc"],
                        lw.gpt_weights_per_band(band).contiguous(),
                        b["concs"], b["alb"], b["tsi"], b["sza"], 1,
                        fast=mode == "bf16")
    on = staged.plan_for(*prep)
    assert (on.route, on.prm_stage, on.slots, on.sets, on.threads) == (
        "split", True, 2, 2, 512 if nlay == 60 else 1024)
    assert (on.prm_base, on.prm_stride, on.prm_floats) == (
        on.sw_floats + on.acc_floats, 26, 26 * nlay)
    props = torch.cuda.get_device_properties(b["tlay"].device)
    off = staged.stage_plan(
        nlay, lw.ngpt, sw.ngpt, 1, staged.band_gases(prep[1].plan),
        staged.band_gases(prep[2].plan), props.shared_memory_per_block_optin,
        props.shared_memory_per_multiprocessor, *staged.SHAPES["lwsw"],
        param_stage=False)
    assert off == dataclasses.replace(on, prm_stage=False, prm_floats=0,
                                      prm_base=off.prm_base,
                                      prm_stride=off.prm_stride)
    got = lwsw._kernel_core(*prep, ncol, plan=on)
    ref = lwsw._kernel_core(*prep, ncol, plan=off)
    torch.cuda.synchronize()
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all() and torch.equal(g, r)


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("nlay", [60, 91, 137])
def test_chunk_warps_at_36_gpoints_match_the_pairs(models, nlay, mode):
    """lw_rrtmgp's 36 LW g-points on the split route at one angle, the
    emissivity per band: the plan gives each set one LW sweep warp per
    g-chunk (``lw_warps`` 2: at nlay 60 and 137 with the parameter stage,
    at 91 without), and K1 on it matches the plain version at f64 in its
    table mode within BOUND, as does the same plan with one LW warp over
    the pairs (``lw_warps`` 1), asked of ``stage_plan``; the SW outputs of
    the two are equal bit for bit, the LW ones within BOUND of each other
    (the chunks' level sums add after the g-sum, the pairs per lane before
    it)."""
    from ecckd_tpu_torch.ops.cuda import lwsw, plan, staged
    lw, sw = models["lw_rrtmgp", torch.float32], models["sw", torch.float32]
    ncol = 2003
    b32, b64 = (batch(ncol, nlay, dt, seed=9)
                for dt in (torch.float32, torch.float64))
    rng = np.random.default_rng(nlay)
    band = torch.as_tensor(rng.uniform(0.9, 1.0, (ncol, lw.nband)),
                           dtype=torch.float64, device="cuda")
    prep = plan.prepare(lw, sw, b32["plev"], b32["tlay"], b32["tlev"],
                        b32["tsfc"],
                        lw.gpt_weights_per_band(band.float()).contiguous(),
                        b32["concs"], b32["alb"], b32["tsi"], b32["sza"], 1,
                        fast=mode == "bf16")
    two = staged.plan_for(*prep)
    assert (two.route, two.lw_warps, two.prm_stage, two.slots,
            two.sets) == ("split", 2, nlay != 91, 2, 2)
    props = torch.cuda.get_device_properties(b32["tlay"].device)
    one = staged.stage_plan(
        nlay, lw.ngpt, sw.ngpt, 1, staged.band_gases(prep[1].plan),
        staged.band_gases(prep[2].plan), props.shared_memory_per_block_optin,
        props.shared_memory_per_multiprocessor, *staged.SHAPES["lwsw"],
        lw_warps=1)
    assert (one.route, one.lw_warps, one.prm_stage, one.threads) == (
        "split", 1, two.prm_stage, two.threads)
    assert one.acc_floats == two.acc_floats - 2 * (nlay + 1)
    got = lwsw._night_masked(prep[2], lwsw._kernel_core(*prep, ncol,
                                                        plan=two))
    pairs = lwsw._night_masked(prep[2], lwsw._kernel_core(*prep, ncol,
                                                          plan=one))
    torch.cuda.synchronize()
    lw64, sw64 = models["lw_rrtmgp", torch.float64], models["sw",
                                                           torch.float64]
    ref = solve(lwsw_fluxes_plain, lw64, sw64, b64,
                lw64.gpt_weights_per_band(band).contiguous(), mxu_mode=mode)
    for out in (got, pairs):
        for k in range(2):
            assert_close(out[2 * k:2 * k + 2], ref[2 * k:2 * k + 2])
    assert_close(got[:2], [p.double() for p in pairs[:2]])
    for g, q in zip(got[2:], pairs[2:]):
        assert torch.equal(g, q)


def test_captured_banded_rrtmgp_calls_run_k1(models):
    """ecCKD's RRTMGP-band LW file (36 g-points in 16 bands) with sw_wide
    on the main path, the emissivity given per band (ncol, 16): capture.jit
    of lw_sw_fluxes runs K1 in the eager call, the capture and each
    replay, on the split route in two blocks of 512 threads per SM (the
    LW band is wider than a warp: csrc/common.cuh "Layout") with the
    parameter stage in the layer parameters' own place and one LW sweep
    warp per g-chunk in each set, and the
    replay matches the plain version at f64 on the same banded surface;
    the same banded values spread over the wrong bands do not."""
    from ecckd_tpu_torch.ops.cuda import plan, staged
    from ecckd_tpu_torch.utils import capture
    lw, sw = models["lw_rrtmgp", torch.float32], models["sw", torch.float32]
    ncol, nlay, chunk = 4096, 60, 1024
    b32 = batch(ncol, nlay, torch.float32, seed=8)
    rng = np.random.default_rng(8)
    band = torch.as_tensor(rng.uniform(0.9, 1.0, (ncol, lw.nband)),
                           dtype=torch.float32, device="cuda")
    emis_gpt = lw.gpt_weights_per_band(band).contiguous()
    p = staged.plan_for(*plan.prepare(
        lw, sw, b32["plev"], b32["tlay"], b32["tlev"], b32["tsfc"],
        emis_gpt, b32["concs"], b32["alb"], b32["tsi"], b32["sza"], 1))
    assert (p.route, p.slots, p.sets, p.threads, p.sm_blocks,
            p.prm_stage, p.lw_warps) == ("split", 2, 2, 512, 2, True, 2)
    assert p.bytes_per_column == 40320
    jitted = capture.jit(pipeline.lw_sw_fluxes)
    for _ in range(3):                   # eager, capture, replay
        before = lwsw_fluxes_cuda.launches
        f_lw, f_sw = jitted(lw, sw, b32["plev"], b32["tlay"], b32["tlev"],
                            b32["tsfc"], band, b32["concs"], b32["alb"],
                            b32["tsi"], b32["sza"], column_chunk=chunk)
        torch.cuda.synchronize()
        assert lwsw_fluxes_cuda.launches == before + ncol // chunk
    (entry,) = jitted.entries.values()
    assert entry.graph is not None
    got = (f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn)
    b64 = batch(ncol, nlay, torch.float64, seed=8)
    lw64, sw64 = models["lw_rrtmgp", torch.float64], models["sw",
                                                           torch.float64]
    ref = solve(lwsw_fluxes_plain, lw64, sw64, b64,
                lw64.gpt_weights_per_band(band.double()).contiguous())
    for k in range(2):
        assert_close(got[2 * k:2 * k + 2], ref[2 * k:2 * k + 2])
    wrong = solve(lwsw_fluxes_plain, lw64, sw64, b64,
                  band.double()[:, torch.as_tensor(
                      [(g + 5) % lw.nband for g in lw.gpt2band],
                      device="cuda")].contiguous())
    scale = max(float(r.abs().max()) for r in ref[:2])
    assert float((got[0].double() - wrong[0]).abs().max()) > 10 * (
        BOUND * scale)


def test_captured_call_checks_its_outputs_with_nan_debugging(models):
    """With NaN debugging on, a replay's outputs are checked as the stage
    "captured call" (the pipeline's own checks read the card and cannot
    run inside the graph).  A NaN TSI gives NaN SW fluxes by day."""
    from ecckd_tpu_torch.utils import capture, checks
    sw = models["sw", torch.float32]
    jitted = capture.jit(pipeline.sw_fluxes)
    b = batch(64, 9, torch.float32, seed=5)
    args = lambda tsi: (sw, b["plev"], b["tlay"], b["concs"], b["alb"], tsi,
                        b["sza"])
    checks.enable_nan_debugging()
    try:
        for _ in range(3):
            got = jitted(*args(b["tsi"]))
        eager = pipeline.sw_fluxes(*args(b["tsi"]))
        assert torch.equal(got.flux_dn, eager.flux_dn)
        with pytest.raises(FloatingPointError, match="captured call"):
            jitted(*args(torch.full_like(b["tsi"], float("nan"))))
    finally:
        checks.enable_nan_debugging(False)
