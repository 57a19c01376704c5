"""PyTorch port: flux solvers and scan primitives against the JAX package.

Random problems in the test_solver_lw.py pattern, the same numpy inputs to
both packages at float64; bound rtol <= 1e-10.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecckd_tpu import optics as jopt
from ecckd_tpu.solvers import scan as jscan
from ecckd_tpu.solvers.lw import rte_lw as j_rte_lw
from ecckd_tpu.solvers.sw import rte_sw as j_rte_sw
from ecckd_tpu.solvers.two_stream import two_stream as j_two_stream
from ecckd_tpu_torch import optics as topt
from ecckd_tpu_torch.solvers import scan as tscan
from ecckd_tpu_torch.solvers.lw import rte_lw as t_rte_lw
from ecckd_tpu_torch.solvers.quadrature import gauss_angles
from ecckd_tpu_torch.solvers.sw import rte_sw as t_rte_sw
from ecckd_tpu_torch.solvers.two_stream import two_stream as t_two_stream

torch.set_num_threads(2)
RTOL = 1e-10


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=0)


def lw_problem(ncol=3, nlay=14, ngpt=8, seed=0):
    rng = np.random.default_rng(seed)
    tau = 10.0 ** rng.uniform(-4, 1, (ncol, nlay, ngpt))
    tau[0, :2] = 1e-9          # thin-layer series branch
    lay = rng.uniform(0.5, 5.0, (ncol, nlay, ngpt))
    lev = rng.uniform(0.5, 5.0, (ncol, nlay + 1, ngpt))
    sfc = rng.uniform(0.5, 5.0, (ncol, ngpt))
    emis = rng.uniform(0.8, 1.0, (ncol, ngpt))
    inc = rng.uniform(0.0, 3.0, (ncol, ngpt))
    return tau, lay, lev, sfc, emis, inc


def _lw_args(pkg, tau, lay, lev, sfc, emis):
    arr = jnp.asarray if pkg is jopt else torch.as_tensor
    src = pkg.SourceFuncLW(lay_source=arr(lay), lev_source_inc=arr(lev[:, 1:]),
                           lev_source_dec=arr(lev[:, :-1]),
                           sfc_source=arr(sfc))
    return pkg.OpticalProps1scl(tau=arr(tau)), src, arr(emis)


@pytest.mark.parametrize("top_at_1", [True, False])
@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
def test_rte_lw_matches_jax(n_angles, top_at_1):
    tau, lay, lev, sfc, emis, inc = lw_problem(seed=n_angles)
    ref = j_rte_lw(*_lw_args(jopt, tau, lay, lev, sfc, emis),
                   top_at_1=top_at_1, n_gauss_angles=n_angles,
                   inc_flux_gpt=jnp.asarray(inc))
    got = t_rte_lw(*_lw_args(topt, tau, lay, lev, sfc, emis),
                   top_at_1=top_at_1, n_gauss_angles=n_angles,
                   inc_flux_gpt=torch.as_tensor(inc))
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("n_angles", [1, 3])
def test_rte_lw_transparent_returns_incident_flux(n_angles):
    """tau = 0, no emission: the isotropic incident flux F comes back at
    every level (the F/PI boundary-radiance convention)."""
    ncol, nlay, ngpt = 2, 5, 4
    zero = np.zeros((ncol, nlay, ngpt))
    inc = np.full((ncol, ngpt), 7.5)
    props, src, emis = _lw_args(topt, zero, zero, np.zeros((ncol, nlay + 1,
                                                           ngpt)),
                                np.zeros((ncol, ngpt)), np.ones((ncol, ngpt)))
    up, dn = t_rte_lw(props, src, emis, n_gauss_angles=n_angles,
                      inc_flux_gpt=torch.as_tensor(inc))
    np.testing.assert_allclose(dn.numpy(), 30.0, rtol=1e-12)
    np.testing.assert_allclose(up.numpy(), 0.0, atol=1e-12)


def sw_problem(ncol=5, nlay=12, ngpt=7, seed=0):
    rng = np.random.default_rng(seed)
    tau = 10.0 ** rng.uniform(-5, 1.5, (ncol, nlay, ngpt))
    ssa = rng.uniform(0.0, 1.0, (ncol, nlay, ngpt))
    ssa[0, 0] = 1.0            # conservative limit
    g = rng.uniform(0.0, 0.9, (ncol, nlay, ngpt))
    mu0 = np.array([0.8, 0.05, 1.0, -0.2, 0.45])[:ncol]   # one night column
    toa = rng.uniform(10.0, 80.0, (ncol, ngpt))
    alb_dir = rng.uniform(0.0, 1.0, (ncol, ngpt))
    alb_dif = rng.uniform(0.0, 1.0, (ncol, ngpt))
    return tau, ssa, g, mu0, toa, alb_dir, alb_dif


@pytest.mark.parametrize("top_at_1", [True, False])
def test_rte_sw_matches_jax(top_at_1):
    tau, ssa, g, mu0, toa, ad, af = sw_problem(seed=3)
    ref = j_rte_sw(jopt.OpticalProps2str(jnp.asarray(tau), jnp.asarray(ssa),
                                         jnp.asarray(g)),
                   jnp.asarray(mu0), jnp.asarray(toa), jnp.asarray(ad),
                   jnp.asarray(af), top_at_1=top_at_1)
    T = torch.as_tensor
    got = t_rte_sw(topt.OpticalProps2str(T(tau), T(ssa), T(g)), T(mu0),
                   T(toa), T(ad), T(af), top_at_1=top_at_1)
    for a, b in zip(got, ref):
        _close(a, b)
    assert not got[0][3].any() and not got[1][3].any()   # night column


def test_two_stream_matches_jax():
    tau, ssa, g, mu0, *_ = sw_problem(seed=9)
    mu0 = np.abs(mu0) + 0.01
    ref = j_two_stream(jnp.asarray(tau), jnp.asarray(ssa), jnp.asarray(g),
                       jnp.asarray(mu0))
    T = torch.as_tensor
    got = t_two_stream(T(tau), T(ssa), T(g), T(mu0))
    for name, a, b in zip(ref._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-15, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_primitives_match_jax(reverse):
    rng = np.random.default_rng(5)
    a = rng.uniform(0.0, 1.0, (3, 9, 4))
    b = rng.uniform(-1.0, 1.0, (3, 9, 4))
    init = rng.uniform(0.0, 2.0, (3, 4))
    T = torch.as_tensor
    jfn = jscan.affine_scan_reverse if reverse else jscan.affine_scan
    tfn = tscan.affine_scan_reverse if reverse else tscan.affine_scan
    _close(tfn(T(a), T(b), T(init), 1),
           jfn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(init), 1))
    got = tscan.affine_sweep_broadband(T(a), T(b), T(init), reverse=reverse)
    ref = jscan.affine_sweep_broadband(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(init), reverse=reverse)
    for g, r in zip(got, ref):
        _close(g, r)


def test_gauss_angles_match_jax():
    from ecckd_tpu.solvers.quadrature import gauss_angles as j_gauss
    for n in range(1, 5):
        assert gauss_angles(n) == j_gauss(n)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="1..4"):
            gauss_angles(bad)
