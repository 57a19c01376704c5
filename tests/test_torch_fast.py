"""PyTorch port: the fast table mode (config.set_mxu_precision, ``--fast``).

On the TPU the fast mode (``bf16``) contracts every table against the
bilinear one-hot in one bf16 MXU pass: both operands rounded to bf16,
f32 accumulation.  The port computes the same thing directly
(ops/cuda/common.py's ``_bilinear_fast``, csrc/common.cuh's bf16
``bilinear``).  The CPU cannot show the TPU's rounding (an interpret-mode
bf16 dot is exact f32), so the plain fast version is held against:

* a numpy reference built from the JAX package's own pieces: its bf16
  table operand ``common.split_bf16(table)[0]`` and its one-hot
  ``common.pt_onehot``, rounded with ml_dtypes (rtol <= 1e-12 at f64);
* the JAX XLA f64 path at the fast mode's contract, <= 5e-4 of the flux
  scale, and > 0 (tests/test_anchors.py's bf16 test).

Also the mode strings, the cache key (an exact call after a fast one is
exact bit for bit) and ``--fast`` on the drivers, whose torch route
ignores the mode.  The kernels themselves run on the card
(chip_smoke.py phase 12, tools/cuda_parity.py).
"""
import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (ckd_paths, flux_batch,  # noqa: F401
                          jax_concs, load_both, torch_concs)
from ecckd_tpu import pipeline as jpipe
from ecckd_tpu.cli import common as j_common, ecckd_rfmip as j_lwsw
from ecckd_tpu.io import rfmip as jrfmip
from ecckd_tpu.ops.pallas import common as jcommon
from ecckd_tpu_torch import config
from ecckd_tpu_torch.cli import ecckd_rfmip as t_lwsw
from ecckd_tpu_torch.io import rfmip as trfmip
from ecckd_tpu_torch.ops import interp
from ecckd_tpu_torch.ops.cuda import common, plan
from ecckd_tpu_torch.ops.cuda.lw import lw_fluxes_plain
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_plain
from ecckd_tpu_torch.ops.cuda.sw import sw_fluxes_plain

torch.set_num_threads(2)
BOUND = 5e-4        # tools/chip_parity.py BOUNDS["bf16"]
MODELS = ["lw", "sw", "lw_neg", "sw_neg", "lw_rrtmgp", "sw_p47"]


@pytest.fixture
def restore_modes(monkeypatch):
    """A test that sets a mode (or runs --fast) leaves both packages'
    modes as it found them."""
    monkeypatch.setattr(config, "_MXU_MODE", config._MXU_MODE)
    monkeypatch.setattr(jcommon, "_MXU_MODE", jcommon._MXU_MODE)


def flat_table(model):
    ng = model.ngpt
    return torch.cat([model.coeff_dense.reshape(-1, ng)]
                     + [t.reshape(-1, ng) for t in model.coeff_lut])


@pytest.mark.parametrize("key", MODELS)
def test_bf16_table_is_jax_bf16_operand(ckd_paths, key):
    """The fast table is the JAX bf16 operand of the f32 table, bit for
    bit, at both working dtypes (the f64 model's table is rounded from
    float32, never straight from float64)."""
    _, t32 = load_both(ckd_paths[key], torch.float32)
    _, t64 = load_both(ckd_paths[key], torch.float64)
    f32 = flat_table(t32).numpy()
    want = np.asarray(jcommon.split_bf16(jnp.asarray(f32))[0])
    for model, dtype in ((t32, torch.float32), (t64, torch.float64)):
        arrays = plan.model_arrays(model, dtype, "cpu", fast=True)
        assert arrays.fast and arrays.table.dtype == torch.bfloat16
        got = arrays.table.view(torch.int16).numpy()
        np.testing.assert_array_equal(got, want.view(np.int16))
        exact = plan.model_arrays(model, dtype, "cpu")
        assert not exact.fast and exact.table.dtype == dtype


def _onehot_bf16(n_p, n_t, p_iw, t_iw):
    """JAX's (n_p*n_t, C) bilinear one-hot at the port's float32 points
    (products in float32, as in the TPU kernel), each weight rounded to
    bf16 as the MXU's DEFAULT pass rounds it."""
    flat = lambda x: jnp.asarray(x.reshape(1, -1).numpy())
    oh = np.asarray(jcommon.pt_onehot(n_p * n_t, n_t, flat(p_iw.i0),
                                      flat(p_iw.w1), flat(t_iw.i0),
                                      flat(t_iw.w1)))
    return oh.astype(ml_dtypes.bfloat16).astype(np.float64)


def _tau_reference(atm, band, simple_w, table_bf16):
    """numpy gas optical depth from the JAX pieces: per gas, one
    contraction of the bf16 one-hot with the bf16 table slice (per
    mole-fraction slice for the LUT gas, whose weights come after), then
    the per-gas weight and clamp."""
    p_iw, t_iw = common.interp_points(atm, band)
    assert p_iw.w1.dtype == torch.float32      # the kernels' weights
    n_pt = band.n_p * band.n_t
    oh = _onehot_bf16(band.n_p, band.n_t, p_iw, t_iw)       # (n_pt, C)
    shape = (*atm.tlay.shape, band.plan.ngpt)
    contract = lambda row0: (oh.T @ table_bf16[row0:row0 + n_pt]).reshape(
        shape)

    def vmr(slot):
        kind, idx = band.vmr_kinds[slot]
        v = (atm.vmr_prof[:, idx, :] if kind == plan.VMR_PROFILE
             else atm.vmr_col[:, idx, None].expand(atm.tlay.shape))
        return v.numpy()

    sw = simple_w.numpy()
    tau = np.zeros(shape)
    for sl in band.plan.slices:
        if sl.kind == plan.KIND_DENSE:
            w = sw * sl.b if sl.vmr_slot < 0 else sw * (
                sl.a * vmr(sl.vmr_slot) + sl.b)
            coeff = contract(sl.row0)
        else:
            v = vmr(sl.vmr_slot)
            v_iw = interp.vmr_index(torch.as_tensor(v), sl.mf_grid)
            coeff = np.zeros(shape)
            for m in range(len(sl.mf_grid)):
                wv = (np.where(v_iw.i0.numpy() == m, 1.0 - v_iw.w1.numpy(), 0)
                      + np.where(v_iw.i0.numpy() + 1 == m, v_iw.w1.numpy(),
                                 0))
                coeff += wv[..., None] * contract(sl.row0 + m * n_pt)
            w = sw * v
        tau += np.maximum(w[..., None] * coeff, 0.0)
    return tau


@pytest.mark.parametrize("key", MODELS)
def test_gas_tau_plain_fast_matches_jax_operands(ckd_paths, key):
    _, t32 = load_both(ckd_paths[key], torch.float32)
    _, t64 = load_both(ckd_paths[key], torch.float64)
    b = flux_batch(6, 9, seed=5, dtype=torch.float64)
    T = lambda k: torch.as_tensor(b[k])
    concs = torch_concs(b["gases"])
    if t64.source_is_internal():
        atm, band = plan.prepare_lw(
            t64, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
            T("emis")[:, None].expand(-1, t64.ngpt), concs, fast=True)
    else:
        atm, band = plan.prepare_sw(t64, T("plev"), T("tlay"), concs,
                                    T("alb"), T("tsi"), T("sza"), fast=True)
    simple_w = common._simple_weight(atm)
    got = common.gas_tau_plain(atm, band, simple_w)
    assert got.dtype == torch.float64
    table = np.asarray(jcommon.split_bf16(jnp.asarray(
        flat_table(t32).numpy()))[0]).astype(np.float64)
    want = _tau_reference(atm, band, simple_w, table)
    assert (want > 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def _flux_err(got, ref):
    """max|d| / band flux scale over the outputs of each band."""
    errs = []
    for band in range(0, len(ref), 2):
        scale = max(np.abs(np.asarray(r)).max() for r in ref[band:band + 2])
        errs += [float(np.abs(np.asarray(g, np.float64) - np.asarray(r))
                       .max() / scale)
                 for g, r in zip(got[band:band + 2], ref[band:band + 2])]
    return max(errs)


def _jax_ref(path, jl, js, b, n_angles):
    J = lambda k: jnp.asarray(b[k])
    jc = jax_concs(b["gases"])
    if path == "lwsw":
        rl, rs = jpipe.lw_sw_fluxes(jl, js, J("plev"), J("tlay"), J("tlev"),
                                    J("tsfc"), J("emis"), jc, J("alb"),
                                    J("tsi"), J("sza"),
                                    n_gauss_angles=n_angles, backend="xla")
        return rl.flux_up, rl.flux_dn, rs.flux_up, rs.flux_dn
    if path == "lw":
        r = jpipe.lw_fluxes(jl, J("plev"), J("tlay"), J("tlev"), J("tsfc"),
                            J("emis"), jc, n_gauss_angles=n_angles,
                            backend="xla")
    else:
        r = jpipe.sw_fluxes(js, J("plev"), J("tlay"), jc, J("alb"), J("tsi"),
                            J("sza"), backend="xla")
    return r.flux_up, r.flux_dn


def _port_plain(path, tl, ts, b, dtype, n_angles, mode):
    T = lambda k: torch.as_tensor(b[k])
    concs = torch_concs(b["gases"], dtype)
    emis = T("emis")[:, None].expand(-1, tl.ngpt) if tl is not None else None
    if path == "lwsw":
        return lwsw_fluxes_plain(tl, ts, T("plev"), T("tlay"), T("tlev"),
                                 T("tsfc"), emis, concs, T("alb"), T("tsi"),
                                 T("sza"), n_gauss_angles=n_angles,
                                 mxu_mode=mode)
    if path == "lw":
        return lw_fluxes_plain(tl, T("plev"), T("tlay"), T("tlev"),
                               T("tsfc"), emis, concs,
                               n_gauss_angles=n_angles, mxu_mode=mode)
    return sw_fluxes_plain(ts, T("plev"), T("tlay"), concs, T("alb"),
                           T("tsi"), T("sza"), mxu_mode=mode)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path,lw_key,sw_key,n_angles", [
    ("lwsw", "lw", "sw", 1), ("lwsw", "lw_neg", "sw_neg", 3),
    ("lwsw", "lw_rrtmgp", "sw", 1), ("lw", "lw", None, 1),
    ("lw", "lw_rrtmgp", None, 3), ("lw", "lw_neg", None, 2),
    ("sw", None, "sw", 1), ("sw", None, "sw_neg", 1),
    ("sw", None, "sw_p47", 1)])
def test_fast_plain_within_contract_of_jax_xla(ckd_paths, path, lw_key,
                                               sw_key, n_angles, dtype):
    """The fast plain version within 5e-4 of the JAX XLA f64 fluxes, and
    not the exact result (tests/test_anchors.py:179-181)."""
    # JAX at f64 (the reference), the port at the working dtype.
    jl, tl, js, ts = None, None, None, None
    if lw_key:
        jl, tl = load_both(ckd_paths[lw_key])[0], load_both(
            ckd_paths[lw_key], dtype)[1]
    if sw_key:
        js, ts = load_both(ckd_paths[sw_key])[0], load_both(
            ckd_paths[sw_key], dtype)[1]
    b = flux_batch(7, 13, seed=11 + n_angles, dtype=dtype)
    b64 = {k: (v if k == "gases" else np.asarray(v, np.float64))
           for k, v in b.items()}
    ref = _jax_ref(path, jl, js, b64, n_angles)
    fast = _port_plain(path, tl, ts, b, dtype, n_angles, "bf16")
    exact = _port_plain(path, tl, ts, b, dtype, n_angles, "bf16x3")
    assert fast[0].dtype == dtype
    err = _flux_err(fast, ref)
    assert 0.0 < err <= BOUND, f"fast mode {err:.3e} (bound {BOUND:.0e})"
    assert _flux_err(exact, ref) <= (1e-7 if dtype == torch.float64 else 5e-5)
    assert any(not torch.equal(f, e) for f, e in zip(fast, exact))


def test_mode_strings(restore_modes):
    assert config.mxu_precision() == "bf16x3" and not config.is_fast()
    for mode, fast in (("bf16x3", False), ("highest", False), ("bf16", True),
                       ("default", True)):
        config.set_mxu_precision(mode)
        assert config.mxu_precision() == mode and config.is_fast() == fast
        assert config.is_fast(mode) == fast
    for bad in ("fast", "BF16", "", "f32"):
        with pytest.raises(ValueError, match="unknown MXU precision mode"):
            config.set_mxu_precision(bad)
        with pytest.raises(ValueError, match="unknown MXU precision mode"):
            config.is_fast(bad)
    assert config.mxu_precision() == "default"


def test_mode_read_at_call_and_cache_keyed_by_mode(ckd_paths, restore_modes):
    """The plain versions read the mode at each call; the model's cache
    holds one table per mode, so an exact call after a fast one on the
    same model is the exact result bit for bit."""
    _, tl = load_both(ckd_paths["lw"])
    _, ts = load_both(ckd_paths["sw"])
    b = flux_batch(5, 8, seed=2, dtype=torch.float64)
    run = lambda mode=None: _port_plain("lwsw", tl, ts, b, torch.float64, 1,
                                        mode)
    exact = run()
    fast = run("bf16")
    assert all(not torch.equal(f, e) for f, e in zip(fast, exact))
    again = run()
    assert all(torch.equal(a, e) for a, e in zip(again, exact))
    config.set_mxu_precision("default")
    assert all(torch.equal(a, f) for a, f in zip(run(), fast))
    config.set_mxu_precision("highest")
    assert all(torch.equal(a, e) for a, e in zip(run(), exact))
    keys = {k[-1] for k in tl._cache if k[0] == "arrays"}
    assert keys == {False, True}


def test_cli_fast_on_the_torch_route(ckd_paths, tmp_path, restore_modes):
    """``--fast --device cpu --precision f64`` runs the torch route, which
    ignores the mode: the files equal the run without ``--fast``, and the
    JAX CLI with the same flags writes the same files (rtol 1e-10)."""
    rfmip = str(tmp_path / "rfmip.nc")
    trfmip.write_synthetic_rfmip(rfmip, nsite=4, nlay=10, nexp=2, seed=3)
    base = [rfmip, ckd_paths["lw"], ckd_paths["sw"], "--precision", "f64"]
    for tag, extra in (("exact", []), ("fast", ["--fast"])):
        metrics = str(tmp_path / f"{tag}.json")
        assert t_lwsw.main([*base, "--device", "cpu", "--output-dir",
                            str(tmp_path / tag), "--metrics-json",
                            metrics, *extra]) == 0
        with open(metrics) as f:
            assert json.load(f)["mxu_precision"] == (
                "bf16" if extra else "bf16x3")
    assert config.mxu_precision() == "bf16"
    args = j_common.make_parser("ecckd_rfmip").parse_args(
        [rfmip, ckd_paths["lw"], "--fast", "--precision", "f64"])
    assert args.fast
    assert j_lwsw.main([*base, "--fast", "--no-shard", "--output-dir",
                        str(tmp_path / "jax")]) == 0
    for name in ("rlu", "rld", "rsu", "rsd"):
        stem = f"{name}_Efx_RTE-ecckd_rad-irf_r1i1p1f1_gn.nc"
        read = lambda d: trfmip.read_fluxes(str(tmp_path / d / stem), name)
        np.testing.assert_array_equal(read("fast"), read("exact"))
        np.testing.assert_allclose(read("fast"), jrfmip.read_fluxes(
            str(tmp_path / "jax" / stem), name), rtol=1e-10, atol=0)
