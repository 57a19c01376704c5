"""PyTorch port: ``utils/capture.jit``, the port's jit unit.

* ``capture.jit`` of ``lw_sw_fluxes``, ``lw_fluxes`` and ``sw_fluxes`` on
  CPU f64 tensors equals the eager call bit for bit over three calls (the
  CPU runs eagerly), and matches ``jax.jit`` of the JAX package's
  function (XLA, f64, CPU) at rtol 1e-10: the slice against the JAX jit
  unit.
* The key: equal shapes give one key whatever the values; a change of
  ncol, nlay, dtype, device, strides, gas names, a model,
  ``n_gauss_angles``, the table mode or the NaN switch gives a new one.
* A warm call's preparation (``plan.prepare``, ``prepare_lw``,
  ``prepare_sw``, ``pipeline._surface_to_gpt``) reads nothing back from
  the tensors and builds no cache: what capture needs on the card.
* Inputs that require grad while grad is enabled raise.
* Each entry captures on a capture stream made on its own card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (atmosphere, ckd_paths, jax_concs,  # noqa: F401
                          load_both, torch_concs)
from ecckd_tpu import pipeline as jpipe
from ecckd_tpu_torch import capture as exported, config, pipeline as tpipe
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.ops.cuda import plan
from ecckd_tpu_torch.utils import capture, checks

torch.set_num_threads(2)
RTOL = 1e-10
STATIC = ("top_at_1", "column_chunk", "backend")


def inputs(ncol=6, nlay=11, seed=0, dtype=np.float64):
    """The same atmosphere for both packages: (jax dict, torch dict)."""
    atm, gases = atmosphere(ncol, nlay, seed=seed)
    rng = np.random.default_rng(seed)
    d = dict(plev=atm["plev"], tlay=atm["tlay"], tlev=atm["tlev"],
             tsfc=atm["tsfc"], emis=rng.uniform(0.8, 1.0, ncol),
             alb=rng.uniform(0.05, 0.7, ncol), tsi=np.full(ncol, 1361.0),
             sza=np.linspace(5.0, 100.0, ncol))
    d = {k: np.asarray(v, dtype) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    j["concs"], t["concs"] = jax_concs(gases), torch_concs(gases)
    return j, t


def lw_sw_args(ml, ms, a):
    return (ml, ms, a["plev"], a["tlay"], a["tlev"], a["tsfc"], a["emis"],
            a["concs"], a["alb"], a["tsi"], a["sza"])


def lw_args(ml, ms, a):
    return (ml, a["plev"], a["tlay"], a["tlev"], a["tsfc"], a["emis"],
            a["concs"])


def sw_args(ml, ms, a):
    return (ms, a["plev"], a["tlay"], a["concs"], a["alb"], a["tsi"],
            a["sza"])


PATHS = {"lw_sw_fluxes": lw_sw_args, "lw_fluxes": lw_args,
         "sw_fluxes": sw_args}


def fluxes(out):
    """The flux arrays of a pipeline result, as numpy."""
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(x) for f in out for x in (f.flux_up, f.flux_dn)]


@pytest.mark.parametrize("name,n_angles", [
    ("lw_sw_fluxes", 1), ("lw_sw_fluxes", 3), ("lw_fluxes", 1),
    ("lw_fluxes", 3), ("sw_fluxes", None)])
def test_captured_call_equals_eager_and_jax_jit(ckd_paths, name, n_angles):
    jl, tl = load_both(ckd_paths["lw"])
    js, ts = load_both(ckd_paths["sw"])
    make = PATHS[name]
    kw = {} if n_angles is None else {"n_gauss_angles": n_angles}
    jitted = capture.jit(getattr(tpipe, name))
    j_jit = jax.jit(getattr(jpipe, name), static_argnames=STATIC + (
        () if n_angles is None else ("n_gauss_angles",)))
    assert jitted.__name__ == name
    for seed in range(3):
        j, t = inputs(seed=seed)
        got = jitted(*make(tl, ts, t), **kw)
        eager = getattr(tpipe, name)(*make(tl, ts, t), **kw)
        ref = j_jit(*make(jl, js, j), backend="xla", **kw)
        for g, e, r in zip(fluxes(got), fluxes(eager), fluxes(ref)):
            assert np.array_equal(g, e)
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=0)
    assert jitted.entries == {}        # the CPU runs eagerly


@pytest.fixture
def restore_switches():
    mode, nan = config.mxu_precision(), checks.nan_debugging()
    yield
    config.set_mxu_precision(mode)
    checks.enable_nan_debugging(nan)


def test_key_counts_shapes_and_never_values(ckd_paths, restore_switches):
    _, tl = load_both(ckd_paths["lw"], torch.float32)
    _, ts = load_both(ckd_paths["sw"], torch.float32)
    fn = tpipe.lw_sw_fluxes
    key = lambda a, ml=tl, **kw: capture.key(fn, lw_sw_args(ml, ts, a), kw)
    t = inputs(dtype=np.float32)[1]
    base = key(t)
    assert base == key(inputs(seed=4, dtype=np.float32)[1])
    assert base == key({k: (v.clone() if k != "concs" else v)
                        for k, v in t.items()})
    assert base[0] is fn and exported is capture

    as_meta = lambda x: torch.empty_like(x, device="meta")
    transposed = lambda x: x.t().contiguous().t()
    dropped = GasConcs(values=t["concs"].values[:-1],
                       names=t["concs"].names[:-1])
    renamed = GasConcs(values=t["concs"].values,
                       names=t["concs"].names[:-1] + ("cfc11",))
    other_lw = load_ckd_model(ckd_paths["lw"], dtype=torch.float32)
    changed = {
        "ncol": key(inputs(ncol=7, dtype=np.float32)[1]),
        "nlay": key(inputs(nlay=12, dtype=np.float32)[1]),
        "dtype": key(inputs()[1]),
        "device": key(dict(t, tlay=as_meta(t["tlay"]))),
        "strides": key(dict(t, plev=transposed(t["plev"]))),
        "gas names": key(dict(t, concs=dropped)),
        "gas renamed": key(dict(t, concs=renamed)),
        "model": key(t, ml=other_lw),
        "n_gauss_angles": key(t, n_gauss_angles=3),
        "backend": key(t, backend="cuda"),
    }
    config.set_mxu_precision("bf16")
    changed["table mode"] = key(t)
    config.set_mxu_precision("bf16x3")
    checks.enable_nan_debugging()
    changed["nan debugging"] = key(t)
    checks.enable_nan_debugging(False)
    assert key(t) == base
    keys = [base, *changed.values()]
    assert len(set(keys)) == len(keys), [
        k for k, v in changed.items() if v == base]


def test_key_refuses_what_it_cannot_key(ckd_paths):
    _, tl = load_both(ckd_paths["lw"], torch.float32)
    t = inputs(dtype=np.float32)[1]
    args = list(lw_args(tl, None, t))
    fn = tpipe.lw_fluxes
    with pytest.raises(TypeError, match="list of tensors"):
        capture.key(fn, (*args[:-1], [t["tsfc"]]), {})
    with pytest.raises(TypeError, match="neither a tensor"):
        capture.key(fn, (*args[:-1], {"a": 1}), {})


PATCHED = ("item", "__float__", "__int__", "__bool__", "tolist", "numpy",
           "cpu")


@pytest.mark.parametrize("fast", [False, True])
def test_warm_prep_is_sync_free(ckd_paths, monkeypatch, fast):
    """After one call, the preparation of every kernel route runs with the
    tensor methods that read values back to the host, and tensors made
    from host data, patched to raise, and leaves the models' caches as
    they were: nothing in it syncs the card, copies from the host or
    builds a table, so a CUDA graph can capture it."""
    _, tl = load_both(ckd_paths["lw"], torch.float32)
    _, ts = load_both(ckd_paths["sw"], torch.float32)
    t = inputs(dtype=np.float32)[1]
    ncol = t["tlay"].shape[0]
    rng = np.random.default_rng(3)
    banded = {k: torch.as_tensor(rng.uniform(0.1, 0.9, (ncol, m.nband)),
                                 dtype=torch.float32)
              for k, m in (("emis", tl), ("alb", ts))}

    def prep():
        emis = tpipe._surface_to_gpt(tl, banded["emis"], ncol,
                                     torch.float32, "cpu")
        alb = tpipe._surface_to_gpt(ts, banded["alb"], ncol, torch.float32,
                                    "cpu")
        emis_col = tpipe._surface_to_gpt(tl, t["emis"], ncol, torch.float32,
                                         "cpu")
        common = (t["plev"], t["tlay"])
        return (plan.prepare(tl, ts, *common, t["tlev"], t["tsfc"], emis,
                             t["concs"], alb, t["tsi"], t["sza"], 3,
                             fast=fast),
                plan.prepare_lw(tl, *common, t["tlev"], t["tsfc"], emis_col,
                                t["concs"], fast=fast),
                plan.prepare_sw(ts, *common, t["concs"], t["alb"], t["tsi"],
                                t["sza"], fast=fast))

    first = prep()
    caches = [dict(m._cache) for m in (tl, ts)]

    def refuse(name):
        def method(*args, **kwargs):
            raise AssertionError(f"Tensor.{name} in a warm call's prep")
        return method

    def device_only(name):
        make = getattr(torch, name)

        def method(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"torch.{name} of host data in a warm "
                                     "call's prep")
            return make(data, *args, **kwargs)
        return method

    with monkeypatch.context() as m:
        for name in PATCHED:
            m.setattr(torch.Tensor, name, refuse(name))
        for name in ("as_tensor", "tensor"):
            m.setattr(torch, name, device_only(name))
        warm = prep()
    for model, cache in zip((tl, ts), caches):
        assert model._cache.keys() == cache.keys()
        assert all(model._cache[k] is v for k, v in cache.items())
    assert warm[0][1].arrays is first[0][1].arrays
    assert torch.equal(warm[0][2].mu0, first[0][2].mu0)


def test_grad_inputs_are_refused(ckd_paths):
    _, tl = load_both(ckd_paths["lw"])
    t = inputs()[1]
    jitted = capture.jit(tpipe.lw_fluxes)
    tlay = t["tlay"].clone().requires_grad_()
    args = lambda tl_: (tl, t["plev"], tl_, t["tlev"], t["tsfc"], t["emis"],
                        t["concs"])
    with pytest.raises(ValueError, match="pipeline.lw_fluxes itself"):
        jitted(*args(tlay))
    with torch.no_grad():
        out = jitted(*args(tlay))
    assert torch.equal(out.flux_up, tpipe.lw_fluxes(*args(t["tlay"])).flux_up)
    with pytest.raises(ValueError, match="one card"):
        jitted(*args(torch.empty_like(t["tlay"], device="meta")))


def test_each_card_captures_on_a_stream_of_its_own(monkeypatch):
    """An entry captures on a capture stream made on its inputs' card.
    ``torch.cuda.graph``'s default capture stream is made once per
    process, on the card current at its first use; a capture for a second
    card on it left that card's kernels outside the capture, and the
    runtime refused them ("operation not permitted when stream is
    capturing", four H100s).  The CUDA calls are stood in for here: the
    stream each capture is handed, and the card it was made on."""
    made = []

    class Graph:
        def __init__(self, graph, stream=None, **kw):
            made.append(stream)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: ("stream", device))
    monkeypatch.setattr(torch.cuda, "Event", lambda: None)
    x = torch.ones(3)
    cards = [torch.device("cuda", d) for d in (0, 1, 3)]
    for card in cards:
        entry = capture._Entry((x,), {})
        entry.capture(lambda t: t * 2.0, (x,), {}, card)
        assert torch.equal(entry.outputs, x * 2.0)
    assert made == [("stream", card) for card in cards]
