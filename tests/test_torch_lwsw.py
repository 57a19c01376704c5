"""PyTorch port: the merged LW+SW solve (ops/cuda/lwsw.py).

``lwsw_fluxes_plain`` is the CUDA kernel's computation in plain PyTorch,
built on the same host preparation (ops/cuda/plan.py).  It is held:

(a) at float64 against the JAX XLA path (lw_fluxes + sw_fluxes,
    backend="xla"): max|d|/flux-scale <= 1e-7.  Its g = 0 two-stream is an
    exact regrouping of solvers/two_stream.py; only its float32 floors
    differ (tau >= 1e-8, the eps_f32 resonance guard, the sqrt(eps_f32)
    thin-layer threshold), which move fluxes by <~ 1e-8 of their scale.
(b) at float32 against the TPU kernel itself, lwsw_fluxes_fused in
    interpret mode: <= 5e-5 of the flux scale, because the Pallas side
    carries its own bf16x3 contraction error (up to 3.3e-5 on the chip).
(c) its per-layer building blocks against ecckd_tpu.ops.pallas.common at
    float32: rtol <= 1e-5, since the JAX side uses a polynomial expm1
    (~2-3 ulp) where torch uses expm1.

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version there.  On CPU tensors
``lwsw_fluxes_cuda`` raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (atmosphere, ckd_paths, flux_batch,  # noqa: F401
                          jax_concs, load_both, torch_concs)
from ecckd_tpu import pipeline as jpipe
from ecckd_tpu.ops.pallas import common as jcommon
from ecckd_tpu.ops.pallas.lwsw import lwsw_fluxes_fused
from ecckd_tpu_torch.ops.cuda import common as tcommon, plan
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda, lwsw_fluxes_plain

torch.set_num_threads(2)


def run_plain(tl, ts, b, dtype, n_angles, fn=lwsw_fluxes_plain):
    T = lambda k: torch.as_tensor(b[k])
    ncol = b["tlay"].shape[0]
    emis = T("emis")[:, None].expand(ncol, tl.ngpt)
    return fn(tl, ts, T("plev"), T("tlay"), T("tlev"), T("tsfc"), emis,
              torch_concs(b["gases"], dtype), T("alb"), T("tsi"), T("sza"),
              n_gauss_angles=n_angles)


def assert_fluxes_close(got, ref, bound):
    """Per output, max|d| over the flux scale of its band."""
    scale_lw = max(np.abs(np.asarray(r)).max() for r in ref[:2])
    scale_sw = max(np.abs(np.asarray(r)).max() for r in ref[2:])
    for name, g, r, scale in zip(("lw_up", "lw_dn", "sw_up", "sw_dn"), got,
                                 ref, (scale_lw, scale_lw, scale_sw,
                                       scale_sw)):
        err = float(np.abs(np.asarray(g, np.float64)
                           - np.asarray(r, np.float64)).max() / scale)
        assert err <= bound, f"{name}: {err:.3e} > {bound:.0e}"


@pytest.mark.parametrize("pair", ["", "_neg"])
@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
def test_plain_f64_matches_jax_xla(ckd_paths, n_angles, pair):
    jl, tl = load_both(ckd_paths["lw" + pair])
    js, ts = load_both(ckd_paths["sw" + pair])
    b = flux_batch(7, 13, seed=n_angles, dtype=torch.float64)
    J = lambda k: jnp.asarray(b[k])
    jc = jax_concs(b["gases"])
    ref_lw = jpipe.lw_fluxes(jl, J("plev"), J("tlay"), J("tlev"), J("tsfc"),
                             J("emis"), jc, n_gauss_angles=n_angles,
                             backend="xla")
    ref_sw = jpipe.sw_fluxes(js, J("plev"), J("tlay"), jc, J("alb"),
                             J("tsi"), J("sza"), backend="xla")
    got = run_plain(tl, ts, b, torch.float64, n_angles)
    assert_fluxes_close(got, (ref_lw.flux_up, ref_lw.flux_dn,
                              ref_sw.flux_up, ref_sw.flux_dn), 1e-7)


@pytest.mark.parametrize("nlay", [1, 2, 8, 33])
def test_plain_f32_matches_pallas_interpret(ckd_paths, nlay):
    jl, tl = load_both(ckd_paths["lw"], torch.float32)
    js, ts = load_both(ckd_paths["sw"], torch.float32)
    b = flux_batch(9, nlay, seed=nlay, dtype=torch.float32)
    J = lambda k: jnp.asarray(b[k])
    emis = jnp.broadcast_to(J("emis")[:, None], (9, jl.ngpt))
    ref = lwsw_fluxes_fused(jl, js, J("plev"), J("tlay"), J("tlev"),
                            J("tsfc"), emis, jax_concs(b["gases"], np.float32),
                            J("alb"), J("tsi"), J("sza"), interpret=True)
    got = run_plain(tl, ts, b, torch.float32, 1)
    assert got[0].dtype == torch.float32
    assert_fluxes_close(got, ref, 5e-5)
    assert not got[2][-1].any() and not got[3][-1].any()   # night column


def test_cuda_wrapper_on_cpu_runs_the_plain_version(ckd_paths):
    """It does not: on CPU tensors the CUDA wrapper raises and names the
    plain version, which is what runs on the CPU (no silent fallback)."""
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw"])
    b = flux_batch(5, 6, seed=1, dtype=torch.float64)
    before = lwsw_fluxes_cuda.launches
    with pytest.raises(ValueError,
                       match="takes CUDA tensors.*lwsw_fluxes_plain"):
        run_plain(tl, ts, b, torch.float64, 3, fn=lwsw_fluxes_cuda)
    assert lwsw_fluxes_cuda.launches == before
    want = run_plain(tl, ts, b, torch.float64, 3)
    assert all(torch.isfinite(w).all() for w in want)


def _grid():
    tau = np.array([0.0, 1e-12, 1e-8, 1e-6, 1e-3, 0.05, 0.3, 1.0, 5.0,
                    30.0, 300.0])
    ssa = np.array([0.0, 1e-6, 0.1, 0.5, 0.9, 0.999, 1.0 - 1e-7, 1.0])
    mu0 = np.array([0.05, 0.3, 0.5, 0.86603, 1.0])
    return [x.ravel().astype(np.float32)
            for x in np.meshgrid(tau, ssa, mu0, indexing="ij")]


def _close_f32(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-7, err_msg=what)


def test_two_stream_g0_matches_pallas_common():
    tau, ssa, mu0 = _grid()
    u = (tau * ssa).astype(np.float32)
    inv = (1.0 / mu0).astype(np.float32)
    ref = jcommon.two_stream_g0(jnp.asarray(tau), jnp.asarray(u),
                                jnp.asarray(mu0), jnp.asarray(inv))
    T = torch.as_tensor
    got = tcommon.two_stream_g0(T(tau), T(u), T(mu0), T(inv))
    for name, g, r in zip(("r_dif", "t_dif", "r_dir", "t_dir", "t"), got,
                          ref):
        assert g.dtype == torch.float32
        _close_f32(g, r, name)


def test_layer_steps_match_pallas_common():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.uniform(0.0, 1.0, s).astype(np.float32)
    ts = (10.0 ** rng.uniform(-7, 2, 64)).astype(np.float32)
    lay, dec, inc = f(64), f(64), f(64)
    thresh = np.float32(np.sqrt(np.finfo(np.float32).eps))
    J, T = jnp.asarray, torch.as_tensor
    ref = jcommon.lw_layer_sources(J(ts), J(lay), J(dec), J(inc), thresh)
    got = tcommon.lw_layer_sources(T(ts), T(lay), T(dec), T(inc))
    for name, g, r in zip(("tr", "src_dn", "src_up"), got, ref):
        _close_f32(g, r, name)
    r_dif, t_dif = 0.5 * f(64), 0.5 * f(64)
    args = [r_dif, t_dif, f(64), f(64), f(64), f(64)]
    for g, r in zip(tcommon.sw_adding_up_step(*map(T, args)),
                    jcommon.sw_adding_up_step(*map(J, args))):
        _close_f32(g, r, "sw_adding_up_step")
    args = [t_dif, r_dif, 1.0 + f(64), f(64), f(64), f(64), f(64)]
    for g, r in zip(tcommon.sw_adding_dn_step(*map(T, args)),
                    jcommon.sw_adding_dn_step(*map(J, args))):
        _close_f32(g, r, "sw_adding_dn_step")


def test_plain_constants_follow_the_compute_type_not_the_dtype():
    """The plain path's floors are those of the kernel it stands for,
    given as ``compute``: float32's at every dtype by default (the float
    kernels' reference, also at float64), float64's only when asked for
    (the merged kernel's double instantiation)."""
    f64 = torch.float64
    eps32, eps64 = np.finfo(np.float32).eps, np.finfo(np.float64).eps
    assert tcommon.kernel_eps() == eps32 and tcommon.kernel_eps(f64) == eps64
    assert tcommon.thin_layer_tau() == float(np.sqrt(eps32))
    assert tcommon.thin_layer_tau(f64) == float(np.sqrt(eps64))
    assert tcommon.tau_floor() == 1e-8
    assert tcommon.tau_floor(f64) == 1e-8 * 2.0 ** -29
    # A layer below float32's tau floor, in float64 tensors: floored at
    # 1e-8 unless the compute type is float64.
    tau = torch.tensor([1e-10, 1e-3], dtype=f64)
    u, mu0 = 0.5 * tau, torch.full_like(tau, 0.5)
    default = tcommon.two_stream_g0(tau, u, mu0, 1.0 / mu0)
    at64 = tcommon.two_stream_g0(tau, u, mu0, 1.0 / mu0, f64)
    assert all(g.dtype == f64 for g in default)
    assert any(not torch.equal(a[0], b[0]) for a, b in zip(default, at64))
    assert all(torch.equal(a[1], b[1]) for a, b in zip(default, at64))


def test_build_plan_resolves_the_request(ckd_paths):
    _, tl = load_both(ckd_paths["lw"])
    names = ("xyz", "o3", "n2", "h2o", "co2", "o2", "ch4")
    p = plan.build_plan(tl, names)
    assert plan.build_plan(tl, names) is p          # cached on the model
    n_pt = 53 * 6
    kinds = [(s.kind, s.row0 // n_pt, s.vmr_slot) for s in p.slices]
    # Dense in request order (o3, composite via n2, co2, ch4), then the LUT;
    # unknown xyz skipped, o2 not counted twice.
    assert kinds == [(plan.KIND_DENSE, 0, 0), (plan.KIND_DENSE, 6, -1),
                     (plan.KIND_DENSE, 1, 2), (plan.KIND_DENSE, 2, 3),
                     (plan.KIND_LUT, 7, 1)]
    assert p.vmr_names == ("o3", "h2o", "co2", "ch4")
    assert p.slices[3].b == -1.921e-6 and p.slices[3].a == 1.0
    assert plan.build_plan(tl, ("h2o",)).slices[0].kind == plan.KIND_LUT
    assert plan.build_plan(tl, ("xyz",)).slices == ()


def test_stack_vmrs_stores_each_gas_once(ckd_paths):
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw"])
    _, gases = atmosphere(4, 3)
    concs = torch_concs(gases)
    plans = (plan.build_plan(tl, concs.names), plan.build_plan(ts, concs.names))
    prof, col, kinds = plan.stack_vmrs(plans, concs, 4, 3, torch.float64,
                                       "cpu")
    assert tuple(prof.shape) == (4, 2, 3)                # h2o, o3
    # co2 ch4 n2o cfc11 cfc12; o2 only selects the composite (no vmr).
    assert tuple(col.shape) == (4, 5)
    for p, k in zip(plans, kinds):
        for name, (kind, idx) in zip(p.vmr_names, k):
            v = torch.as_tensor(np.array(np.broadcast_to(
                np.asarray(gases[name], np.float64).reshape(
                    (4, -1) if np.ndim(gases[name]) else ()), (4, 3))))
            got = prof[:, idx] if kind == plan.VMR_PROFILE else \
                col[:, idx, None].expand(4, 3)
            assert torch.equal(got, v), name


def test_mergeability_and_refusals(ckd_paths):
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw"])
    assert plan.models_mergeable(tl, ts)
    other = dataclasses.replace(ts, grid_key=(1, 2))
    assert not plan.models_mergeable(tl, other)
    b = flux_batch(3, 4, seed=0, dtype=torch.float64)
    with pytest.raises(ValueError, match="do not share"):
        run_plain(tl, other, b, torch.float64, 1)
    with pytest.raises(ValueError, match="longwave and a shortwave"):
        run_plain(ts, tl, b, torch.float64, 1)
    with pytest.raises(ValueError, match="1..4"):
        run_plain(tl, ts, b, torch.float64, 5)

