"""PyTorch port on a CUDA card: K1's Jacobian instantiation, RTE's LW
surface-temperature Jacobian (``flux_up_jac``) on the merged kernel.

* At nlay 60, 91, 137 and 208 (two blocks of 512 threads whole, one of
  1024 whole, split with the parameter stage, whole with C = 1), in both
  table modes, its J matches the torch path at float64 (the exact mode
  within ``JAC_BOUND`` of the largest |J|, the fast mode within
  ``FAST_BOUND``), its four fluxes equal the plain instantiation's bit for
  bit, and each launch counts once in ``jac_launches``.
* Under ``capture.jit`` the replayed call equals the eager one bit for
  bit and adds its launches to ``jac_launches`` once per launch.
* What the instantiation leaves out takes the torch path on ``"auto"``
  (its J as the kernel's would be, no launch counted) and raises on
  ``"cuda"``: columns deep enough for the device slice, 3 angles, 36 LW
  g-points, float64.

These tests need a card and skip without one (marker ``cuda``); they
import neither jax nor tests/conftest.py:

    python -m pytest tests/test_torch_lw_jacobian_cuda.py --noconftest -q
"""

import os

import pytest
import torch

from ecckd_tpu_torch import config, pipeline
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.ops.cuda import staged
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda
from radbench import inputs, solve

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda
JAC_BOUND = 1e-5
"""The float32 kernel's J: max |J - J_f64| over the largest |J| (reads
~1e-6)."""
FAST_BOUND = 2e-3
"""The fast table mode's J against the exact float64 one (reads ~3e-4)."""


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    d = tmp_path_factory.mktemp("ckd_jac_cuda")
    out = {}
    for kind in ("lw_fsck", "lw_rrtmgp", "sw_wide"):
        path = os.path.join(d, f"{kind}.nc")
        inputs.write_ckd(path, kind, 7)
        for dt in (torch.float32, torch.float64):
            out[kind, dt] = load_ckd_model(path, dtype=dt, device="cuda")
    return out


def batch(ncol, nlay, dtype=torch.float32, seed=5):
    b = inputs.make_batch(ncol, nlay, inputs.generator(seed, "cuda"), "cuda")
    out = {k: v.to(dtype) for k, v in b.items() if k != "concs"}
    out["concs"] = {k: v.to(dtype) for k, v in b["concs"].items()}
    return out


def call(models, b, lw="lw_fsck", fn=pipeline.lw_sw_fluxes, **kw):
    dtype = b["tlay"].dtype
    return fn(models[lw, dtype], models["sw_wide", dtype], b["plev"],
              b["tlay"], b["tlev"], b["tsfc"], b["emis"], solve.gas_concs(b),
              b["alb"], b["tsi"], b["sza"], **kw)


def jac_error(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


ROUTES = {60: ("shared", 2, 512), 91: ("shared", 2, 1024),
          137: ("split", 2, 1024), 208: ("shared", 1, 1024)}


@pytest.mark.parametrize("mode", ["bf16x3", "bf16"])
@pytest.mark.parametrize("nlay", sorted(ROUTES))
def test_the_jacobian_kernel_matches_the_torch_path(models, nlay, mode):
    b = batch(3001, nlay)
    ref = call(models, {k: (v.double() if k != "concs" else
                            {g: x.double() for g, x in v.items()})
                        for k, v in b.items()},
               backend="torch", flux_up_jac=True)[0].flux_up_jac
    previous = config.mxu_precision()
    config.set_mxu_precision(mode)
    try:
        n0 = lwsw_fluxes_cuda.jac_launches
        lw, sw = call(models, b, backend="cuda", flux_up_jac=True,
                      column_chunk=1024)
        launched = lwsw_fluxes_cuda.jac_launches - n0
        plain = call(models, b, backend="cuda", column_chunk=1024)
    finally:
        config.set_mxu_precision(previous)
    torch.cuda.synchronize()
    assert launched == 3
    from ecckd_tpu_torch.ops.cuda import plan as plan_mod
    atm, lw_in, sw_in = plan_mod.prepare(
        models["lw_fsck", torch.float32], models["sw_wide", torch.float32],
        b["plev"], b["tlay"], b["tlev"], b["tsfc"],
        b["emis"][:, None].expand(-1, 32).contiguous(), solve.gas_concs(b),
        b["alb"], b["tsi"], b["sza"], 1)
    p = staged.plan_for(atm, lw_in, sw_in, jac=True)
    assert (p.route, p.slots, p.threads) == ROUTES[nlay]
    for got, want in zip((lw.flux_up, lw.flux_dn, sw.flux_up, sw.flux_dn),
                         (plain[0].flux_up, plain[0].flux_dn,
                          plain[1].flux_up, plain[1].flux_dn)):
        assert torch.equal(got, want)
    err = jac_error(lw.flux_up_jac, ref)
    print(f"\nnlay {nlay} {mode}: {p.report}; J error {err:.3e}")
    assert err <= (JAC_BOUND if mode == "bf16x3" else FAST_BOUND)
    if mode == "bf16x3":
        assert err > 0


def test_captured_jacobian_calls_replay_the_eager_call(models):
    from ecckd_tpu_torch.utils import capture
    b = batch(2 * 8192, 91)
    f = capture.jit(pipeline.lw_sw_fluxes)
    kw = dict(column_chunk=8192, flux_up_jac=True)
    eager = call(models, b, **kw)[0]
    outs, added = [], []
    for _ in range(4):
        n0 = lwsw_fluxes_cuda.jac_launches
        lw, _ = call(models, b, fn=f, **kw)
        torch.cuda.synchronize()
        added.append(lwsw_fluxes_cuda.jac_launches - n0)
        outs.append(lw)
    assert added == [2, 2, 2, 2]
    assert f.captures == 1 and f.replays == 3
    for lw in outs:
        assert torch.equal(lw.flux_up_jac, eager.flux_up_jac)
        assert torch.equal(lw.flux_up, eager.flux_up)
    # Another key: the flag enters it.
    call(models, b, fn=f, column_chunk=8192)
    assert len(f.entries) == 2


@pytest.mark.parametrize("case", ["deep", "3ang", "36g", "f64"])
def test_what_the_jacobian_leaves_out_takes_the_torch_path(models, case):
    nlay = 260 if case == "deep" else 30
    dtype = torch.float64 if case == "f64" else torch.float32
    b = batch(64, nlay, dtype)
    lw_kind = "lw_rrtmgp" if case == "36g" else "lw_fsck"
    kw = dict(flux_up_jac=True, n_gauss_angles=3 if case == "3ang" else 1)
    if case == "36g":
        gen = torch.Generator(device="cuda").manual_seed(3)
        b["emis"] = 0.9 + 0.1 * torch.rand((64, 16), generator=gen,
                                           device="cuda")
    n0 = lwsw_fluxes_cuda.jac_launches
    lw, _ = call(models, b, lw=lw_kind, **kw)
    assert lwsw_fluxes_cuda.jac_launches == n0
    torch_lw, _ = call(models, b, lw=lw_kind, backend="torch", **kw)
    assert torch.equal(lw.flux_up_jac, torch_lw.flux_up_jac)
    with pytest.raises(ValueError, match="backend='cuda' requested"):
        call(models, b, lw=lw_kind, backend="cuda", **kw)
