"""PyTorch port: end-to-end pipelines against the JAX package at float64.

``lw_sw_fluxes`` / ``lw_fluxes`` / ``sw_fluxes`` on the CPU take the torch
path, the counterpart of the JAX XLA path; bound rtol <= 1e-10.  Also the
backend contracts of pipeline.py (the JAX package's :95-112,144-156
ValueErrors, with backends auto|torch|cuda) and the kernels' refusal
reasons.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (atmosphere, ckd_paths, jax_concs,  # noqa: F401
                          load_both, torch_concs)
from ecckd_tpu import fluxes as jfluxes, pipeline as jpipe
from ecckd_tpu_torch import fluxes as tfluxes, pipeline as tpipe
from ecckd_tpu_torch.ops.cuda import binding

torch.set_num_threads(2)
RTOL = 1e-10


def inputs(ncol=6, nlay=11, seed=0, banded=None):
    atm, gases = atmosphere(ncol, nlay, seed=seed)
    rng = np.random.default_rng(seed)
    d = dict(plev=atm["plev"], tlay=atm["tlay"], tlev=atm["tlev"],
             tsfc=atm["tsfc"], emis=rng.uniform(0.8, 1.0, ncol),
             alb=rng.uniform(0.05, 0.7, ncol), tsi=np.full(ncol, 1361.0),
             sza=np.linspace(5.0, 100.0, ncol))
    if banded:
        d["emis"] = rng.uniform(0.8, 1.0, (ncol, banded[0]))
        d["alb"] = rng.uniform(0.05, 0.7, (ncol, banded[1]))
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    j["concs"], t["concs"] = jax_concs(gases), torch_concs(gases)
    return j, t


def call(pipe, lw, sw, a, **kw):
    return pipe.lw_sw_fluxes(lw, sw, a["plev"], a["tlay"], a["tlev"],
                             a["tsfc"], a["emis"], a["concs"], a["alb"],
                             a["tsi"], a["sza"], **kw)


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("n_angles", [1, 3])
def test_lw_sw_fluxes_matches_jax(ckd_paths, n_angles, banded):
    jl, tl = load_both(ckd_paths["lw"])
    js, ts = load_both(ckd_paths["sw"])
    j, t = inputs(seed=n_angles, banded=(1, 5) if banded else None)
    ref = call(jpipe, jl, js, j, n_gauss_angles=n_angles, backend="xla")
    got = call(tpipe, tl, ts, t, n_gauss_angles=n_angles)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.flux_up.numpy(), np.asarray(r.flux_up),
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(g.flux_dn.numpy(), np.asarray(r.flux_dn),
                                   rtol=RTOL, atol=0)
    # TSI renormalisation and the night mask.
    sw_dn = got[1].flux_dn.numpy()
    day = t["sza"].numpy() < 90.0
    np.testing.assert_allclose(sw_dn[day, 0], 1361.0 * np.cos(np.deg2rad(
        t["sza"].numpy()[day])), rtol=1e-12)
    assert not sw_dn[~day].any() and not got[1].flux_up.numpy()[~day].any()


def test_top_at_1_false_and_column_chunks_match_jax(ckd_paths):
    jl, tl = load_both(ckd_paths["lw_neg"])
    js, ts = load_both(ckd_paths["sw_neg"])
    j, t = inputs(ncol=7, seed=5)
    flip = lambda a, f: {k: (f(v) if k in ("plev", "tlay", "tlev") else v)
                         for k, v in a.items()}
    jf = flip(j, lambda v: jnp.flip(v, axis=1))
    tf = flip(t, lambda v: torch.flip(v, dims=(1,)))
    # Flipped profiles need flipped gas profiles too.
    _, gases = atmosphere(7, 11, seed=5)
    gases = {k: (np.flip(v, axis=1) if np.ndim(v) == 2 else v)
             for k, v in gases.items()}
    jf["concs"], tf["concs"] = jax_concs(gases), torch_concs(gases)
    ref = call(jpipe, jl, js, jf, top_at_1=False, backend="xla")
    got = call(tpipe, tl, ts, tf, top_at_1=False, column_chunk=3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.flux_up.numpy(), np.asarray(r.flux_up),
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(g.flux_dn.numpy(), np.asarray(r.flux_dn),
                                   rtol=RTOL, atol=0)


def test_heating_rate_and_clamp_top_pressure_match_jax():
    rng = np.random.default_rng(2)
    up, dn = rng.uniform(100, 400, (2, 3, 6))
    plev = np.sort(rng.uniform(1.0, 1e5, (3, 6)), axis=1)
    np.testing.assert_allclose(
        tfluxes.heating_rate(*map(torch.as_tensor, (up, dn, plev))).numpy(),
        np.asarray(jfluxes.heating_rate(*map(jnp.asarray, (up, dn, plev)))),
        rtol=RTOL)
    assert tfluxes.FluxesBroadband(torch.as_tensor(up), torch.as_tensor(
        dn)).flux_net.numpy().tolist() == (dn - up).tolist()
    for top_at_1 in (True, False):
        np.testing.assert_array_equal(
            tpipe.clamp_top_pressure(plev, 0.694, top_at_1),
            jpipe.clamp_top_pressure(plev, 0.694, top_at_1))


def test_backend_contracts(ckd_paths):
    """Unknown backends raise everywhere (before any re-routing); the
    CUDA backend raises where its kernel does not apply (here: CPU
    tensors), naming the kernel; the log-space interpolation is torch-path
    only."""
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw"])
    _, t = inputs(ncol=3, nlay=4)
    lw = lambda **kw: tpipe.lw_fluxes(tl, t["plev"], t["tlay"], t["tlev"],
                                      t["tsfc"], t["emis"], t["concs"], **kw)
    sw = lambda **kw: tpipe.sw_fluxes(ts, t["plev"], t["tlay"], t["concs"],
                                      t["alb"], t["tsi"], t["sza"], **kw)
    both = lambda **kw: call(tpipe, tl, ts, t, **kw)
    for fn in (lw, sw, both):
        with pytest.raises(ValueError, match="unknown backend 'xla'"):
            fn(backend="xla")
    for fn in (lw, sw):
        with pytest.raises(ValueError, match="unknown backend"):
            fn(backend="fused", logarithmic_interpolation=True)
        with pytest.raises(ValueError, match="logarithmic_interpolation"):
            fn(backend="cuda", logarithmic_interpolation=True)
        with pytest.raises(ValueError, match="(LW|SW) kernel .*not a CUDA "
                                             "device"):
            fn(backend="cuda")
    with pytest.raises(ValueError, match="LW kernel .*not a CUDA device"):
        both(backend="cuda")
    # auto on the CPU takes the torch path for the single bands too.
    for fn in (lw, sw):
        a, b = fn(backend="auto"), fn(backend="torch")
        assert torch.equal(a.flux_up, b.flux_up)
        assert torch.equal(a.flux_dn, b.flux_dn)
    with pytest.raises(ValueError, match="unknown backend"):
        tpipe.lw_sw_fluxes(tl, ts, *[t[k] for k in (
            "plev", "tlay", "tlev", "tsfc", "emis", "concs", "alb", "tsi",
            "sza")], backend="Auto")
    # auto on the CPU takes the torch path, identical to backend="torch".
    for a, b in zip(both(backend="auto"), both(backend="torch")):
        assert torch.equal(a.flux_up, b.flux_up)
        assert torch.equal(a.flux_dn, b.flux_dn)
    log = lw(logarithmic_interpolation=True)
    assert torch.isfinite(log.flux_up).all()
    with pytest.raises(ValueError, match="bands"):
        lw_bad = dict(t, emis=torch.ones(3, 2, dtype=torch.float64))
        tpipe.lw_fluxes(tl, lw_bad["plev"], lw_bad["tlay"], lw_bad["tlev"],
                        lw_bad["tsfc"], lw_bad["emis"], lw_bad["concs"])


def test_kernel_refusal_reasons(ckd_paths):
    """Where the kernels do not apply, backend='cuda' says why; a pair
    that does not share a grid is no refusal (it takes the LW and the SW
    kernel instead of the merged one)."""
    import dataclasses
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw"])
    refusal = tpipe._kernel_refusal
    assert "not a CUDA device" in refusal(torch.zeros(2, 3), True, 1)
    # A stand-in for a CUDA tensor: the refusal reads device and dtype only.
    fake = type("T", (), {"device": torch.device("cuda"),
                          "dtype": torch.float16})()
    assert "float32" in refusal(fake, True)
    fake.dtype = torch.float32
    assert "top_at_1" in refusal(fake, False)
    assert "1..4" in refusal(fake, True, 5)
    assert refusal(fake, True, 4) is None and refusal(fake, True) is None
    other = dataclasses.replace(ts, grid_key=(1,))
    assert not tpipe.models_mergeable(tl, other)
    assert tpipe.models_mergeable(tl, ts)
    with pytest.raises(ValueError, match="backend='cuda' requested but the "
                                         "SW kernel .*top_at_1"):
        tpipe._refuse_cuda("cuda", "sw", refusal(fake, False))
    tpipe._refuse_cuda("auto", "sw", refusal(fake, False))   # no raise


def test_kernel_refusal_f64_rules():
    """float64 runs on the merged kernel's double instantiation alone, in
    the exact table mode: the merged solve is accepted; the LW-only (K3)
    and SW-only (K4) solves and the fast mode are refused, each with its
    reason, and backend='cuda' raises with it."""
    from ecckd_tpu_torch import config
    refusal = tpipe._kernel_refusal
    fake = type("T", (), {"device": torch.device("cuda"),
                          "dtype": torch.float64})()
    previous = config.mxu_precision()
    try:
        config.set_mxu_precision("bf16x3")
        assert refusal(fake, True) is None
        assert refusal(fake, True, 3, kernel="lwsw") is None
        for kernel, name in (("lw", "K3"), ("sw", "K4")):
            why = refusal(fake, True, kernel=kernel)
            assert name in why and "no float64" in why and "K1" in why
            with pytest.raises(ValueError, match=f"backend='cuda' requested "
                                                 f"but .*{name}.*float64"):
                tpipe._refuse_cuda("cuda", kernel, why)
        # The other rules hold at float64 too.
        assert "top_at_1" in refusal(fake, False)
        assert "1..4" in refusal(fake, True, 5)
        config.set_mxu_precision("bf16")
        assert "fast mode" in refusal(fake, True)
        assert "fast mode" in binding.FAST_F64_REFUSAL
        fake.dtype = torch.float32
        assert refusal(fake, True) is None      # the fast mode at float32
    finally:
        config.set_mxu_precision(previous)
