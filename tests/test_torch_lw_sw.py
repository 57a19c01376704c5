"""PyTorch port: the LW-only and SW-only solves (ops/cuda/lw.py, sw.py).

``lw_fluxes_plain`` / ``sw_fluxes_plain`` are the CUDA kernels'
computations in plain PyTorch, on the host preparation of
ops/cuda/plan.py.  They are held:

(a) at float64 against the JAX XLA path (lw_fluxes / sw_fluxes,
    backend="xla"): max|d|/flux-scale <= 1e-7, as the merged plain
    version (test_torch_lwsw.py); only the float32 floors of the g = 0
    two-stream differ.
(b) at float32 against the TPU kernels themselves, lw_fluxes_fused /
    sw_fluxes_fused in interpret mode: <= 5e-5 of the flux scale, since the
    Pallas side carries its own bf16x3 contraction error.  Default models
    only: those kernels require non-negative tables.
(c) against the merged plain version on a mergeable pair: equal, since
    the three plain versions run one body per band (ops/cuda/common.py).

Also the non-mergeable pair through the pipeline, the refusal of the
``*_cuda`` wrappers on CPU tensors, and the header-aware build hash.
The kernels themselves run only on a card: tests/test_torch_cuda.py and
chip_smoke.py hold them against these plain versions there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (ckd_paths, flux_batch,  # noqa: F401
                          jax_concs, load_both, torch_concs)
from ecckd_tpu import pipeline as jpipe
from ecckd_tpu.ops.pallas.lw import lw_fluxes_fused
from ecckd_tpu.ops.pallas.sw import sw_fluxes_fused
from ecckd_tpu_torch import pipeline as tpipe
from ecckd_tpu_torch.ops.cuda import build, plan
from ecckd_tpu_torch.ops.cuda.lw import lw_fluxes_cuda, lw_fluxes_plain
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_plain
from ecckd_tpu_torch.ops.cuda.sw import sw_fluxes_cuda, sw_fluxes_plain

torch.set_num_threads(2)


def lw_plain(model, b, dtype, n_angles=1, emis_gpt=None, fn=lw_fluxes_plain):
    T = lambda k: torch.as_tensor(b[k])
    if emis_gpt is None:
        emis_gpt = T("emis")[:, None].expand(-1, model.ngpt)
    return fn(model, T("plev"), T("tlay"), T("tlev"), T("tsfc"), emis_gpt,
              torch_concs(b["gases"], dtype), n_gauss_angles=n_angles)


def sw_plain(model, b, dtype, fn=sw_fluxes_plain):
    T = lambda k: torch.as_tensor(b[k])
    return fn(model, T("plev"), T("tlay"), torch_concs(b["gases"], dtype),
              T("alb"), T("tsi"), T("sza"))


def assert_close(got, ref, bound):
    """Per output, max|d| over the band's flux scale."""
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    for name, g, r in zip(("up", "dn"), got, ref):
        err = float(np.abs(np.asarray(g, np.float64)
                           - np.asarray(r, np.float64)).max() / scale)
        assert err <= bound, f"{name}: {err:.3e} > {bound:.0e}"


@pytest.mark.parametrize("model", ["lw", "lw_neg"])
@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
def test_lw_plain_f64_matches_jax_xla(ckd_paths, n_angles, model):
    jl, tl = load_both(ckd_paths[model])
    b = flux_batch(7, 13, seed=n_angles, dtype=torch.float64)
    J = lambda k: jnp.asarray(b[k])
    ref = jpipe.lw_fluxes(jl, J("plev"), J("tlay"), J("tlev"), J("tsfc"),
                          J("emis"), jax_concs(b["gases"]),
                          n_gauss_angles=n_angles, backend="xla")
    got = lw_plain(tl, b, torch.float64, n_angles)
    assert got[0].dtype == torch.float64
    assert_close(got, (ref.flux_up, ref.flux_dn), 1e-7)


@pytest.mark.parametrize("n_angles", [1, 3])
def test_lw_rrtmgp_plain_f64_banded_emissivity(ckd_paths, n_angles):
    """36 g-points in 16 bands: two chunks of 32 lanes on the card, and the
    band-to-g-point expansion of a banded emissivity."""
    jl, tl = load_both(ckd_paths["lw_rrtmgp"])
    assert (tl.ngpt, tl.nband) == (36, 16)
    b = flux_batch(6, 11, seed=10 + n_angles, dtype=torch.float64)
    emis = np.random.default_rng(n_angles).uniform(0.7, 1.0, (6, 16))
    J = lambda k: jnp.asarray(b[k])
    ref = jpipe.lw_fluxes(jl, J("plev"), J("tlay"), J("tlev"), J("tsfc"),
                          jnp.asarray(emis), jax_concs(b["gases"]),
                          n_gauss_angles=n_angles, backend="xla")
    emis_gpt = tl.gpt_weights_per_band(torch.as_tensor(emis))
    got = lw_plain(tl, b, torch.float64, n_angles, emis_gpt=emis_gpt)
    assert_close(got, (ref.flux_up, ref.flux_dn), 1e-7)


@pytest.mark.parametrize("model", ["sw", "sw_neg", "sw_p47"])
def test_sw_plain_f64_matches_jax_xla(ckd_paths, model):
    js, ts = load_both(ckd_paths[model])
    b = flux_batch(7, 13, seed=3, dtype=torch.float64)
    J = lambda k: jnp.asarray(b[k])
    ref = jpipe.sw_fluxes(js, J("plev"), J("tlay"), jax_concs(b["gases"]),
                          J("alb"), J("tsi"), J("sza"), backend="xla")
    got = sw_plain(ts, b, torch.float64)
    assert_close(got, (ref.flux_up, ref.flux_dn), 1e-7)
    assert not got[0][-1].any() and not got[1][-1].any()   # night column


@pytest.mark.parametrize("band", ["lw", "sw"])
@pytest.mark.parametrize("nlay", [1, 2, 8, 33])
def test_plain_f32_matches_pallas_interpret(ckd_paths, nlay, band):
    jm, tm = load_both(ckd_paths[band], torch.float32)
    b = flux_batch(9, nlay, seed=nlay, dtype=torch.float32)
    J = lambda k: jnp.asarray(b[k])
    jc = jax_concs(b["gases"], np.float32)
    if band == "lw":
        emis = jnp.broadcast_to(J("emis")[:, None], (9, jm.ngpt))
        ref = lw_fluxes_fused(jm, J("plev"), J("tlay"), J("tlev"), J("tsfc"),
                              emis, jc, interpret=True)
        got = lw_plain(tm, b, torch.float32)
    else:
        ref = sw_fluxes_fused(jm, J("plev"), J("tlay"), jc, J("alb"),
                              J("tsi"), J("sza"), interpret=True)
        got = sw_plain(tm, b, torch.float32)
    assert got[0].dtype == torch.float32
    assert_close(got, ref, 5e-5)


@pytest.mark.parametrize("n_angles", [1, 3])
def test_single_band_plain_equals_merged_plain(ckd_paths, n_angles):
    """One body per band: on a mergeable pair the LW-only and SW-only plain
    versions give exactly the merged plain version's fluxes."""
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw"])
    b = flux_batch(8, 10, seed=n_angles, dtype=torch.float64)
    T = lambda k: torch.as_tensor(b[k])
    emis = T("emis")[:, None].expand(-1, tl.ngpt)
    merged = lwsw_fluxes_plain(tl, ts, T("plev"), T("tlay"), T("tlev"),
                               T("tsfc"), emis, torch_concs(b["gases"]),
                               T("alb"), T("tsi"), T("sza"),
                               n_gauss_angles=n_angles)
    single = (*lw_plain(tl, b, torch.float64, n_angles),
              *sw_plain(ts, b, torch.float64))
    for s, m in zip(single, merged):
        assert torch.equal(s, m)


@pytest.mark.parametrize("n_angles", [1, 3])
def test_nonmergeable_pair_matches_jax(ckd_paths, n_angles):
    """lw_fsck with sw_wide on a 47-point pressure grid: no shared grid, so
    lw_sw_fluxes runs lw_fluxes + sw_fluxes, each on its own grid."""
    jl, tl = load_both(ckd_paths["lw"])
    js, ts = load_both(ckd_paths["sw_p47"])
    assert not plan.models_mergeable(tl, ts)
    b = flux_batch(6, 12, seed=20 + n_angles, dtype=torch.float64)
    J = lambda k: jnp.asarray(b[k])
    T = lambda k: torch.as_tensor(b[k])
    ref = jpipe.lw_sw_fluxes(jl, js, J("plev"), J("tlay"), J("tlev"),
                             J("tsfc"), J("emis"), jax_concs(b["gases"]),
                             J("alb"), J("tsi"), J("sza"),
                             n_gauss_angles=n_angles, backend="xla")
    got = tpipe.lw_sw_fluxes(tl, ts, T("plev"), T("tlay"), T("tlev"),
                             T("tsfc"), T("emis"), torch_concs(b["gases"]),
                             T("alb"), T("tsi"), T("sza"),
                             n_gauss_angles=n_angles, backend="auto")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.flux_up.numpy(), np.asarray(r.flux_up),
                                   rtol=1e-10, atol=0)
        np.testing.assert_allclose(g.flux_dn.numpy(), np.asarray(r.flux_dn),
                                   rtol=1e-10, atol=0)
    # The plain SW version on its own grid agrees too (the kernel's body).
    assert_close(sw_plain(ts, b, torch.float64),
                 (ref[1].flux_up, ref[1].flux_dn), 1e-7)
    with pytest.raises(ValueError, match="do not share"):
        lwsw_fluxes_plain(tl, ts, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                          T("emis")[:, None].expand(-1, tl.ngpt),
                          torch_concs(b["gases"]), T("alb"), T("tsi"),
                          T("sza"))


def test_cuda_wrappers_refuse_cpu_tensors(ckd_paths):
    """No ``*_cuda`` wrapper runs the plain version in its place."""
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw"])
    b = flux_batch(4, 5, seed=1, dtype=torch.float64)
    before = (lw_fluxes_cuda.launches, sw_fluxes_cuda.launches)
    with pytest.raises(ValueError, match="takes CUDA tensors.*lw_fluxes_plain"):
        lw_plain(tl, b, torch.float64, fn=lw_fluxes_cuda)
    with pytest.raises(ValueError, match="takes CUDA tensors.*sw_fluxes_plain"):
        sw_plain(ts, b, torch.float64, fn=sw_fluxes_cuda)
    assert (lw_fluxes_cuda.launches, sw_fluxes_cuda.launches) == before
    # The single-band preparation checks the band of the model.
    with pytest.raises(ValueError, match="longwave"):
        lw_plain(ts, b, torch.float64)
    with pytest.raises(ValueError, match="shortwave"):
        sw_plain(tl, b, torch.float64)
    with pytest.raises(ValueError, match="1..4"):
        lw_plain(tl, b, torch.float64, n_angles=5)


def test_single_band_prep_uses_the_bands_own_grid(ckd_paths):
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw_p47"])
    b = flux_batch(3, 4, seed=0, dtype=torch.float64)
    T = lambda k: torch.as_tensor(b[k])
    atm, sw = plan.prepare_sw(ts, T("plev"), T("tlay"),
                              torch_concs(b["gases"]), T("alb"), T("tsi"),
                              T("sza"))
    _, lw = plan.prepare_lw(tl, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                            T("emis")[:, None].expand(-1, tl.ngpt),
                            torch_concs(b["gases"]))
    assert (sw.n_p, sw.n_t, lw.n_p, lw.n_t) == (47, 6, 53, 6)
    assert sw.arrays.d_log_p != lw.arrays.d_log_p
    assert tuple(atm.vmr_prof.shape) == (3, 2, 4)      # h2o, o3
    assert tuple(sw.alb.shape) == (3, ts.ngpt) and sw.usecol.dtype == torch.bool


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """A kernel's library is keyed by its .cu AND the csrc headers it may
    include: touching common.cuh changes every library_path."""
    for src in build.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    names = ("lwsw", "lw", "sw")
    before = {n: build.library_path(n) for n in names}
    assert len(set(before.values())) == 3
    assert {n: build.library_path(n) for n in names} == before   # stable
    (tmp_path / "common.cuh").write_text(
        (tmp_path / "common.cuh").read_text() + "\n// touched\n")
    after = {n: build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (tmp_path / "lw.cu").write_text((tmp_path / "lw.cu").read_text() + " ")
    assert build.library_path("lw") != after["lw"]
    assert build.library_path("sw") == after["sw"]
