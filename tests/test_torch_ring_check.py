"""PyTorch port: the ring checker's build of the staged kernels
(ops/cuda/ring_check.py, csrc/ring_check.cuh, tools/cuda_sanitize.py
``--checked``).

The checked kernels run only on a card (chip_smoke.py phase 15 and the
tool there); these tests hold what the host decides for them:

* defines enter a library's key and file name, so a checked or planted
  build never takes the plain build's place;
* ``binding.library``, the loader of every launch path, builds without
  defines, and the ``*_cuda`` wrappers pass no other build to the launch;
* the tool's ``--checked`` matrix reaches every staging regime of every
  kernel on an H100 (threads per block, C, S, shared or device staging;
  C = 1 and device staging among them), in both table modes, and its
  guarded plans fit the card;
* the tool's verdict fails on a missed plant and on any run with a
  violation, a NaN or outputs unequal to the plain build's (results
  stubbed);
* the Python mirrors of the C side (guard words, the record's checks) and
  the record's parsing.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_lwsw_tiling import H100
from torch_parity import ckd_paths  # noqa: F401
from ecckd_tpu_torch.io.synthetic import example_flux_batch
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.ops.cuda import (binding, build, lw, lwsw, plan,
                                      ring_check, staged, sw)
from tools import cuda_sanitize

torch.set_num_threads(2)

CSRC = Path(build.CSRC_DIR)


def test_defines_change_the_library_key():
    plain = build.library_path("lwsw")
    checked = build.library_path("lwsw", ring_check.defines())
    planted = build.library_path("lwsw", ring_check.defines(plant=True))
    assert len({plain, checked, planted}) == 3
    assert re.fullmatch(r"liblwsw-[0-9a-f]{16}\.so", plain.name)
    assert checked.name.startswith("liblwsw-ecckd_check_ring-")
    assert planted.name.startswith(
        "liblwsw-ecckd_check_ring-ecckd_plant_skip_free-")
    assert build.library_path("lwsw", ()) == plain
    assert build.define_flags(ring_check.defines(plant=True)) == (
        "-DECCKD_CHECK_RING", "-DECCKD_PLANT_SKIP_FREE")
    with pytest.raises(ValueError):
        build.library_path("lwsw", ("X=1; rm",))


class _Fn:
    """A stand-in for a ctypes function: takes argtypes and restype."""

    def __init__(self, result=0):
        self.result = result

    def __call__(self, *args):
        return self.result


def _fake_lib(name):
    lib = type("FakeLib", (), {})()
    for entry in (f"ecckd_{name}_launch", f"ecckd_{name}_launch_fast"):
        setattr(lib, entry, _Fn())
    setattr(lib, f"ecckd_{name}_args_size",
            _Fn(ctypes.sizeof(binding.ARGS[name])))
    lib.ecckd_cuda_error_string = _Fn(b"")
    return lib


def test_binding_loads_only_the_plain_build(monkeypatch):
    loads = []

    def load(name, defines=()):
        loads.append((name, tuple(defines)))
        return _fake_lib(name)
    monkeypatch.setattr(build, "load", load)
    binding.library.cache_clear()
    try:
        for name, args_type in binding.ARGS.items():
            binding.library(name, args_type)
    finally:
        binding.library.cache_clear()
    assert loads == [(name, ()) for name in binding.ARGS]


def test_the_wrappers_pass_no_other_build(ckd_paths, monkeypatch):
    """Each ``*_cuda`` wrapper reaches ``staged.run_staged`` without
    ``lib`` (the CUDA-only checks stood in, the launch recorded)."""
    calls = []

    def run_staged(atm, lw_in, sw_in, column_chunk, counted, **launch):
        calls.append(launch)
        n = 2 * ((lw_in is not None) + (sw_in is not None))
        return [torch.zeros(atm.tlay.shape[0], atm.tlay.shape[1] + 1)] * n

    monkeypatch.setattr(staged, "run_staged", run_staged)
    monkeypatch.setattr(binding, "require_cuda", lambda *a: None)
    monkeypatch.setattr(binding, "check_inputs", lambda *a: None)
    m_lw = load_ckd_model(ckd_paths["lw"], dtype=torch.float32)
    m_sw = load_ckd_model(ckd_paths["sw"], dtype=torch.float32)
    b = example_flux_batch(3, 5, np.float32)
    T = lambda k: torch.as_tensor(b[k])
    emis = T("emis")[:, None].expand(3, m_lw.ngpt).contiguous()
    lwsw.lwsw_fluxes_cuda(m_lw, m_sw, T("plev"), T("tlay"), T("tlev"),
                          T("tsfc"), emis, b["concs"], T("alb"),
                          T("tsi"), T("sza"))
    lw.lw_fluxes_cuda(m_lw, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                      emis, b["concs"])
    sw.sw_fluxes_cuda(m_sw, T("plev"), T("tlay"), b["concs"], T("alb"),
                      T("tsi"), T("sza"))
    assert calls == [{}, {}, {}]


def _gases(ckd_paths):
    names = example_flux_batch(1, 1, np.float32)["concs"].names
    out = {}
    for key in ("lw", "sw"):
        model = load_ckd_model(ckd_paths[key], dtype=torch.float32)
        out[key] = (model.ngpt, staged.band_gases(
            plan.build_plan(model, names)))
    return out


def _plan(gases, kernel, nlay, n_ang):
    (ng_lw, g_lw), (ng_sw, g_sw) = gases["lw"], gases["sw"]
    blocks, slots, sets = staged.SHAPES[kernel]
    return staged.stage_plan(
        nlay, ng_lw if kernel != "sw" else 0, ng_sw if kernel != "lw" else 0,
        n_ang, g_lw if kernel != "sw" else (0, 0),
        g_sw if kernel != "lw" else (0, 0), *H100, blocks_per_sm=blocks,
        max_slots=slots, sets=sets)


def _regime(p):
    return p.threads, p.slots, p.sets, p.shared


def test_the_checked_matrix_reaches_every_staging_regime(ckd_paths):
    gases = _gases(ckd_paths)
    for kernel in cuda_sanitize.KERNELS:
        angles = (1,) if kernel == "sw" else (1, 2, 3, 4)
        every = {_regime(_plan(gases, kernel, nlay, a))
                 for nlay in range(1, 1200) for a in angles}
        covered = {_regime(_plan(gases, k, nlay, a))
                   for k, nlay, a in cuda_sanitize.CHECKED if k == kernel}
        assert covered == every, kernel
        assert any(c == 1 for _, c, _, _ in covered), kernel
        assert any(not shared for *_, shared in covered), kernel
    # Both table modes, every configuration, and the plant in each kernel.
    import inspect
    defaults = inspect.signature(cuda_sanitize.run_checked).parameters
    assert defaults["modes"].default == (False, True)
    assert defaults["plant_configs"].default is cuda_sanitize.CHECKED
    seeds = {s for s, j, _ in cuda_sanitize.RUNS if j > 0}
    assert len(seeds) >= 3 and any(j == 0 for _, j, _ in cuda_sanitize.RUNS)
    # The reduced matrix of chip_smoke.py phase 15.
    import chip_smoke
    assert {k for k, _, _ in chip_smoke.RING_CHECKED} == {"lwsw", "lw", "sw"}
    assert {k for k, _, _ in chip_smoke.RING_PLANT} == {"lwsw"}


def test_guarded_plans_fit_the_card(ckd_paths):
    gases = _gases(ckd_paths)
    static = 2 * 4 * 4      # csrc/ring_check.cuh's two ledgers of 4 slots
    for kernel, nlay, n_ang in cuda_sanitize.CHECKED:
        p = _plan(gases, kernel, nlay, n_ang)
        g = ring_check.guarded(p)
        assert _regime(g) == _regime(p)
        assert g.col_floats == p.col_floats + ring_check.RING_GUARD_FLOATS
        if p.shared:
            assert g.shared_bytes == (p.shared_bytes
                                      + 4 * p.slots
                                      * ring_check.RING_GUARD_FLOATS)
            assert g.shared_bytes + static <= H100[0], (kernel, nlay)
        else:
            assert g.shared_bytes == 0


def test_the_python_side_mirrors_the_checker():
    src = (CSRC / "ring_check.cuh").read_text()
    guard = re.search(r"constexpr int RING_GUARD = (\d+);", src).group(1)
    assert int(guard) == ring_check.RING_GUARD_FLOATS
    kinds = re.search(r"enum RingCheckKind \{([^}]*)\}", src).group(1)
    assert [k.split("=")[0].strip().removeprefix("RING_").lower()
            for k in kinds.split(",")] == list(ring_check.CHECKS)
    staged_src = (CSRC / "staged.cuh").read_text()
    assert "#ifdef ECCKD_CHECK_RING" in staged_src
    assert "#ifdef ECCKD_PLANT_SKIP_FREE" in staged_src
    for name in ("lwsw", "lw", "sw"):
        assert f"RING_ENTRY_POINTS({name})" in (CSRC / f"{name}.cu"
                                               ).read_text()


def test_errors_reads_the_record():
    def record(values):
        def read(out, reset):
            for k, v in enumerate(values):
                out[k] = v
            return 0
        return read

    lib = type("FakeLib", (), {})()
    lib.ecckd_lw_ring_errors = record([0, 0, 0, 0, -1, -1, -1, -1])
    assert ring_check.errors(lib, "lw") == {
        "count": 0, "full": 0, "free": 0, "canary": 0, "first": None}
    lib.ecckd_lw_ring_errors = record([3, 0, 2, 1, 7, 1031, 0, 1])
    assert ring_check.errors(lib, "lw") == {
        "count": 3, "full": 0, "free": 2, "canary": 1,
        "first": {"block": 7, "column": 1031, "slot": 0, "check": "free"}}
    lib.ecckd_lw_ring_errors = lambda out, reset: 700
    lib.ecckd_cuda_error_string = lambda rc: b"an illegal memory access"
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ring_check.errors(lib, "lw")


def _run(count=0, finite=True, equal=True):
    return {"count": count, "finite": finite, "bitwise_equal": equal}


def _config(kernel, *runs, plant=False):
    return {"kernel": kernel, "plant": plant, "runs": list(runs)}


def test_the_verdict():
    v = cuda_sanitize.verdict
    checked = [_config(k, _run(), _run()) for k in ("lwsw", "lw", "sw")]
    planted = [_config(k, _run(), _run(count=2), plant=True)
               for k in ("lwsw", "lw", "sw")]
    ok = v(checked, planted)
    assert ok["pass"] and ok["clean"]
    assert ok["plant_caught"] == {"lw": True, "lwsw": True, "sw": True}
    # A plant that no run of one kernel reports.
    missed = planted[:2] + [_config("sw", _run(), _run(), plant=True)]
    assert not v(checked, missed)["pass"]
    assert v(checked, missed)["plant_caught"]["sw"] is False
    # A plant caught by its outputs alone: NaN, or unequal to the plain.
    for bad in (_run(finite=False), _run(equal=False)):
        assert v(checked, planted[:2] + [_config("sw", bad, plant=True)]
                 )["pass"]
    # Any checked run with a violation, a NaN or other outputs fails.
    for bad in (_run(count=1), _run(finite=False), _run(equal=False)):
        dirty = checked[:2] + [_config("sw", _run(), bad)]
        assert not v(dirty, planted)["pass"]
        assert not v(dirty, planted)["clean"]
    # No plant at all is no pass.
    assert not v(checked, [])["pass"]
