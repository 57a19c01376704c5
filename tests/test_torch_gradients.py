"""PyTorch port: gradients through the plain torch path (counterpart of
tests/test_gradients.py), on the synthetic models at float64 on the CPU.

* Torch autograd against ``jax.grad`` / ``jax.jacrev`` of the JAX XLA path
  on the same numpy inputs: max|d| <= 1e-7 of max|grad|.
* Central differences at the JAX test's bounds: 1e-4 for LW, 1e-3 for SW.
* Physics signs: warming a layer raises the surface downward flux; a
  brighter surface reflects more.
* The Jacobian of one column's flux profile has no cross-column entries
  (``torch.autograd.functional.jacobian``).
* The kernels define no backward, so an input that requires grad keeps
  them out: ``auto`` takes the torch path, ``backend="cuda"`` and the
  ``*_cuda`` wrappers raise (pipeline._kernel_refusal,
  binding.grad_refusal).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import RFMIP_VMRS, make_atmosphere
from torch_parity import ckd_paths, load_both  # noqa: F401
from ecckd_tpu.gases import GasConcs as JaxGasConcs
from ecckd_tpu.pipeline import lw_fluxes as j_lw_fluxes
from ecckd_tpu.pipeline import sw_fluxes as j_sw_fluxes
from ecckd_tpu_torch import pipeline as tpipe
from ecckd_tpu_torch.gases import GasConcs as TorchGasConcs
from ecckd_tpu_torch.ops.cuda.lw import lw_fluxes_cuda
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda
from ecckd_tpu_torch.ops.cuda.sw import sw_fluxes_cuda

torch.set_num_threads(2)
NCOL, NLAY = 2, 20
GRAD_RTOL = 1e-7
SCALAR_GASES = ("co2", "ch4", "n2o", "o2")


@pytest.fixture(scope="module")
def setup(ckd_paths):
    return (load_both(ckd_paths["lw"]), load_both(ckd_paths["sw"]),
            make_atmosphere(ncol=NCOL, nlay=NLAY, seed=1))


def _concs(atm, h2o, jax_side: bool):
    """The JAX test's gases: h2o (given), o3, and four well-mixed scalars
    at float64 on both sides."""
    items = [("h2o", h2o)]
    if jax_side:
        items += [("o3", jnp.asarray(atm["o3"]))]
        items += [(g, jnp.asarray(np.float64(RFMIP_VMRS[g])))
                  for g in SCALAR_GASES]
        return JaxGasConcs.create(items)
    items += [("o3", torch.as_tensor(atm["o3"]))]
    items += [(g, torch.as_tensor(np.float64(RFMIP_VMRS[g])))
              for g in SCALAR_GASES]
    return TorchGasConcs.create(items)


def _lw(lw_pair, atm, side, h2o=None, tlay=None, emis=None):
    """LW fluxes on one side ("jax": XLA path, "torch": backend auto)."""
    jx = side == "jax"
    arr = (lambda x: jnp.asarray(x)) if jx else (lambda x: torch.as_tensor(x))
    h2o = arr(atm["h2o"]) if h2o is None else h2o
    tlay = arr(atm["tlay"]) if tlay is None else tlay
    emis = arr(np.full(NCOL, 0.98)) if emis is None else emis
    args = (arr(atm["plev"]), tlay, arr(atm["tlev"]), arr(atm["tsfc"]), emis,
            _concs(atm, h2o, jx))
    if jx:
        return j_lw_fluxes(lw_pair[0], *args, backend="xla")
    return tpipe.lw_fluxes(lw_pair[1], *args, backend="auto")


def _sw(sw_pair, atm, side, h2o=None, alb=None):
    jx = side == "jax"
    arr = (lambda x: jnp.asarray(x)) if jx else (lambda x: torch.as_tensor(x))
    h2o = arr(atm["h2o"]) if h2o is None else h2o
    alb = arr(np.full(NCOL, 0.2)) if alb is None else alb
    args = (arr(atm["plev"]), arr(atm["tlay"]), _concs(atm, h2o, jx), alb,
            arr(np.full(NCOL, 1361.0)), arr(np.array([30.0, 70.0])))
    if jx:
        return j_sw_fluxes(sw_pair[0], *args, backend="xla")
    return tpipe.sw_fluxes(sw_pair[1], *args, backend="auto")


def _grad_vs_jax(t_fn, j_fn, x):
    """Torch autograd of t_fn at x against jax.grad of j_fn; returns the
    torch gradient (numpy)."""
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    t_fn(xt).backward()
    gt = xt.grad.numpy()
    gj = np.asarray(jax.grad(j_fn)(jnp.asarray(x)))
    assert np.isfinite(gt).all(), "non-finite adjoint"
    assert np.abs(gt - gj).max() <= GRAD_RTOL * np.abs(gj).max()
    return gt


def _check_fd(t_fn, x, g, eps, rtol, spots=((0, 10), (1, 3))):
    """Central differences of t_fn at a few entries against g."""
    for idx in spots:
        xp, xm = x.copy(), x.copy()
        xp[idx] += eps
        xm[idx] -= eps
        with torch.no_grad():
            fd = (float(t_fn(torch.as_tensor(xp)))
                  - float(t_fn(torch.as_tensor(xm)))) / (2 * eps)
        assert abs(g[idx] - fd) <= rtol * max(abs(fd), 1e-12), (
            f"adjoint {g[idx]:.6e} vs fd {fd:.6e} at {idx}")


def test_lw_olr_adjoint_wrt_h2o(setup):
    lw_pair, _, atm = setup
    t_olr = lambda h: _lw(lw_pair, atm, "torch", h2o=h).flux_up[:, 0].sum()
    j_olr = lambda h: jnp.sum(_lw(lw_pair, atm, "jax", h2o=h).flux_up[:, 0])
    g = _grad_vs_jax(t_olr, j_olr, atm["h2o"])
    _check_fd(t_olr, atm["h2o"], g, eps=1e-9, rtol=1e-4)


def test_lw_flux_adjoint_wrt_temperature(setup):
    """Temperature feeds both the table interpolation and the Planck
    sources; the adjoint must combine them."""
    lw_pair, _, atm = setup
    t_dn = lambda t: _lw(lw_pair, atm, "torch", tlay=t).flux_dn[:, -1].sum()
    j_dn = lambda t: jnp.sum(_lw(lw_pair, atm, "jax", tlay=t).flux_dn[:, -1])
    g = _grad_vs_jax(t_dn, j_dn, atm["tlay"])
    _check_fd(t_dn, atm["tlay"], g, eps=1e-4, rtol=1e-4)
    # Physics sign: warming a layer increases downward emission.
    assert g.sum() > 0.0


def test_lw_surface_emissivity_adjoint(setup):
    lw_pair, _, atm = setup
    t_olr = lambda e: _lw(lw_pair, atm, "torch", emis=e).flux_up[:, 0].sum()
    j_olr = lambda e: jnp.sum(_lw(lw_pair, atm, "jax", emis=e).flux_up[:, 0])
    g = _grad_vs_jax(t_olr, j_olr, np.full(NCOL, 0.95))
    with torch.no_grad():
        fd = (float(t_olr(torch.full((NCOL,), 0.95 + 1e-6,
                                     dtype=torch.float64)))
              - float(t_olr(torch.full((NCOL,), 0.95 - 1e-6,
                                       dtype=torch.float64)))) / 2e-6
    assert abs(g.sum() - fd) <= 1e-4 * abs(fd)


def test_sw_adjoints(setup):
    _, sw_pair, atm = setup
    t_up = lambda h: _sw(sw_pair, atm, "torch", h2o=h).flux_up[:, 0].sum()
    j_up = lambda h: jnp.sum(_sw(sw_pair, atm, "jax", h2o=h).flux_up[:, 0])
    g = _grad_vs_jax(t_up, j_up, atm["h2o"])
    # Step 1e-8, not the JAX test's 1e-9: on the synthetic sw model the
    # derivative at (1, 3) is -7.7e-3 W m-2 per unit vmr against a sum of
    # ~1e3 W m-2, so a 1e-9 step moves the sum by ~1e-11, within a few
    # float64 ulps of it, and the difference quotient is quantised
    # (1.35e-3 off at 1e-9, 3e-10 and 1e-10 alike; 1.3e-4 off at 1e-8).
    _check_fd(t_up, atm["h2o"], g, eps=1e-8, rtol=1e-3)
    t_alb = lambda a: _sw(sw_pair, atm, "torch", alb=a).flux_up[:, 0].sum()
    j_alb = lambda a: jnp.sum(_sw(sw_pair, atm, "jax", alb=a).flux_up[:, 0])
    g = _grad_vs_jax(t_alb, j_alb, np.full(NCOL, 0.2))
    assert (g > 0).all(), "brighter surface must reflect more"


def test_jacobian_column_independence(setup):
    """The Jacobian of column 0's upward flux profile with respect to the
    h2o of every column (the retrieval-operator shape): column 1's block
    is exactly zero, and the whole equals jax.jacrev."""
    lw_pair, _, atm = setup
    t_prof = lambda h2o: _lw(lw_pair, atm, "torch", h2o=h2o).flux_up[0]
    j_prof = lambda h2o: _lw(lw_pair, atm, "jax", h2o=h2o).flux_up[0]
    J = torch.autograd.functional.jacobian(
        t_prof, torch.as_tensor(atm["h2o"])).numpy()
    assert J.shape == (NLAY + 1, NCOL, NLAY)
    assert np.isfinite(J).all()
    assert np.abs(J[:, 1, :]).max() == 0.0
    Jj = np.asarray(jax.jacrev(j_prof)(jnp.asarray(atm["h2o"])))
    assert np.abs(J - Jj).max() <= GRAD_RTOL * np.abs(Jj).max()


def test_kernel_refusal_on_inputs_that_require_grad():
    refusal = tpipe._kernel_refusal
    tlay = torch.zeros(2, 3, requires_grad=True)
    assert "requires grad" in refusal(tlay, True)
    with torch.no_grad():        # no graph wanted: the grad rule is off
        assert "not a CUDA device" in refusal(tlay, True)
    concs = TorchGasConcs.create([("h2o", torch.ones(2, 3,
                                                     requires_grad=True))])
    assert "requires grad" in refusal(torch.zeros(2, 3), True,
                                      inputs=(concs,))
    assert "not a CUDA device" in refusal(torch.zeros(2, 3), True,
                                          inputs=(torch.ones(2),))


@pytest.mark.parametrize("entry", ["lw_sw_fluxes", "lw_fluxes", "sw_fluxes"])
def test_grad_routes(setup, entry):
    """auto back-propagates through the torch path (the same fluxes as
    backend='torch'); backend='cuda' raises and names backend='torch'."""
    (_, tl), (_, ts), atm = setup
    t = {k: torch.as_tensor(atm[k]) for k in ("plev", "tlev", "tsfc")}
    concs = _concs(atm, torch.as_tensor(atm["h2o"]), jax_side=False)
    emis, alb = torch.full((NCOL,), 0.98, dtype=torch.float64), \
        torch.full((NCOL,), 0.2, dtype=torch.float64)
    tsi = torch.full((NCOL,), 1361.0, dtype=torch.float64)
    sza = torch.tensor([30.0, 70.0], dtype=torch.float64)

    def call(tlay, backend):
        if entry == "lw_sw_fluxes":
            return tpipe.lw_sw_fluxes(tl, ts, t["plev"], tlay, t["tlev"],
                                      t["tsfc"], emis, concs, alb, tsi, sza,
                                      backend=backend)
        if entry == "lw_fluxes":
            return (tpipe.lw_fluxes(tl, t["plev"], tlay, t["tlev"],
                                    t["tsfc"], emis, concs,
                                    backend=backend),)
        return (tpipe.sw_fluxes(ts, t["plev"], tlay, concs, alb, tsi, sza,
                                backend=backend),)

    tlay = torch.tensor(atm["tlay"], requires_grad=True)
    got = call(tlay, "auto")
    sum(f.flux_dn[:, -1].sum() for f in got).backward()
    assert tlay.grad is not None and torch.isfinite(tlay.grad).all()
    assert float(tlay.grad.abs().sum()) > 0.0
    with torch.no_grad():
        ref = call(torch.as_tensor(atm["tlay"]), "torch")
    for g, r in zip(got, ref):
        assert torch.equal(g.flux_up.detach(), r.flux_up)
        assert torch.equal(g.flux_dn.detach(), r.flux_dn)
    with pytest.raises(ValueError, match="requires grad.*backend='torch'"):
        call(tlay, "cuda")


@pytest.mark.parametrize("wrapper", ["lwsw", "lw", "sw"])
def test_cuda_wrappers_refuse_inputs_that_require_grad(setup, wrapper):
    """A direct caller cannot cut the graph either: each wrapper raises on
    a grad-carrying per-column input before anything else."""
    (_, tl), (_, ts), atm = setup
    t = {k: torch.as_tensor(atm[k]) for k in ("plev", "tlay", "tlev",
                                              "tsfc")}
    h2o = torch.tensor(atm["h2o"], requires_grad=True)
    concs = _concs(atm, h2o, jax_side=False)
    emis = torch.full((NCOL, tl.ngpt), 0.98, dtype=torch.float64)
    sun = (torch.full((NCOL,), 0.2, dtype=torch.float64),
           torch.full((NCOL,), 1361.0, dtype=torch.float64),
           torch.tensor([30.0, 70.0], dtype=torch.float64))
    calls = {
        "lwsw": lambda: lwsw_fluxes_cuda(tl, ts, t["plev"], t["tlay"],
                                         t["tlev"], t["tsfc"], emis, concs,
                                         *sun),
        "lw": lambda: lw_fluxes_cuda(tl, t["plev"], t["tlay"], t["tlev"],
                                     t["tsfc"], emis, concs),
        "sw": lambda: sw_fluxes_cuda(ts, t["plev"], t["tlay"], concs, *sun),
    }
    with pytest.raises(ValueError, match=f"{wrapper}_fluxes_cuda: an input "
                                         "requires grad"):
        calls[wrapper]()
    with torch.no_grad(), pytest.raises(ValueError, match="takes CUDA"):
        calls[wrapper]()
