"""PyTorch port: the host side of the merged kernel's timed build
(ops/cuda/role_clock.py, csrc/role_clock.cuh) and the benchmark's
readers of its wait shares (radbench/metrics/role_shares.py and the three
``lwsw_*_wait_share`` readers).

The timed kernel runs only on a card (tests/test_torch_role_clock_cuda.py,
``tools/stage_sweep.py --roles``); these tests hold what the host decides
for it:

* the defines enter the library's key and file name, so the timed or a
  planted build never takes the plain build's place;
* ``binding.library`` and the ``*_cuda`` wrappers still load and pass only
  the plain build; inside ``role_clock.timed`` the merged kernel's
  launches, and only those, take the timed build, and after it the
  launch path is the plain one again;
* ``timed`` refuses under graph capture, at entry and at a launch;
* the record's parsing, its reset, the shares and each sweep warp's
  cycles a column on stubbed words, and the Python mirrors of the C
  side's roles, counters and defines;
* the helper sets up a cell's own traffic kind at one launch chunk with
  its calls eager and makes one call through ``timed`` (a stand-in for it
  on the CPU); it and the readers give None without a card or without a
  timed build in the program;
* the manifest's three entries list only existing batch cells and point
  at existing readers.
"""
import contextlib
import ctypes
import functools
import importlib.util
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.io.synthetic import (example_flux_batch,
                                          write_synthetic_ckd)
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.ops.cuda import (binding, build, lw, lwsw, ring_check,
                                      role_clock, staged, sw)
from radbench import run as bench_run
from radbench.metrics import role_shares

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path(build.CSRC_DIR)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = {"lwsw_optics_wait_share": "optics",
           "lwsw_lw_sweep_wait_share": "lw_sweep",
           "lwsw_sw_sweep_wait_share": "sw_sweep"}
BATCH_CELLS = ["l60_batch", "l137_batch", "l60_3ang", "l60_f64_batch",
               "l60_rrtmgp_batch", "l91_batch", "l91_jac_batch"]
WORDS = len(role_clock.ROLES) * len(role_clock.COUNTERS)


def test_defines_enter_the_library_key():
    plain = build.library_path("lwsw")
    timed = build.library_path("lwsw", role_clock.defines())
    slow_sw = build.library_path("lwsw", role_clock.defines("slow_sw"))
    slow_optics = build.library_path("lwsw",
                                     role_clock.defines("slow_optics"))
    checked = build.library_path("lwsw", ring_check.defines())
    assert len({plain, timed, slow_sw, slow_optics, checked}) == 5
    assert re.fullmatch(r"liblwsw-[0-9a-f]{16}\.so", plain.name)
    assert timed.name.startswith("liblwsw-ecckd_time_roles-")
    assert slow_sw.name.startswith(
        "liblwsw-ecckd_time_roles-ecckd_plant_slow_sw-")
    assert slow_optics.name.startswith(
        "liblwsw-ecckd_time_roles-ecckd_plant_slow_optics-")
    assert build.define_flags(role_clock.defines("slow_optics")) == (
        "-DECCKD_TIME_ROLES", "-DECCKD_PLANT_SLOW_OPTICS")
    assert build.library_path("lwsw", ()) == plain


class _Fn:
    """A stand-in for a ctypes function: takes argtypes and restype."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def _fake_lib(name, words=None, calls=None):
    """A stand-in for a bound build of ``csrc/<name>.cu``; with ``words``
    (the record's words), also the timed build's entry points, which
    return them and log each (reset) in ``calls``."""
    lib = types.SimpleNamespace()
    for suffix in binding.launch_suffixes(name):
        setattr(lib, f"ecckd_{name}_launch{suffix}", _Fn(lambda *a: 0))
    for tag, struct in binding.args_structs(name).items():
        size = ctypes.sizeof(struct)
        setattr(lib, f"ecckd_{name}{tag}_args_size",
                _Fn(lambda size=size: size))
    lib.ecckd_cuda_error_string = _Fn(lambda rc: b"stand-in")
    if words is not None:
        lib.ecckd_lwsw_role_words = _Fn(lambda: len(words))

        def clock(out, reset):
            for k, w in enumerate(words):
                out[k] = w
            if calls is not None:
                calls.append(reset)
            return 0
        lib.ecckd_lwsw_role_clock = _Fn(clock)
    return lib


@pytest.fixture
def loads(monkeypatch):
    """``build.load`` stood in for: each load is logged as (name,
    defines) and returns a stand-in library (the timed one's record
    holds the words 0, 1, ...)."""
    log = []

    @functools.lru_cache(maxsize=None)
    def load(name, defines=()):
        log.append((name, tuple(defines)))
        timed = role_clock.TIME_DEFINE in defines
        return _fake_lib(name, list(range(WORDS)) if timed else None)
    monkeypatch.setattr(build, "load", load)
    binding.library.cache_clear()
    yield log
    binding.library.cache_clear()


def test_only_the_role_clock_loads_the_timed_build(loads):
    for name in binding.ARGS:
        binding.library(name)
    assert loads == [(name, ()) for name in binding.ARGS]
    role_clock.library()
    role_clock.library("slow_sw")
    assert loads[-2:] == [
        ("lwsw", ("ECCKD_TIME_ROLES",)),
        ("lwsw", ("ECCKD_TIME_ROLES", "ECCKD_PLANT_SLOW_SW"))]


def test_a_record_of_another_layout_is_refused(monkeypatch):
    monkeypatch.setattr(build, "load",
                        lambda name, defines=(): _fake_lib(name, [0] * 3))
    with pytest.raises(RuntimeError, match="layout mismatch"):
        role_clock.library()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckd_role_clock")
    out = {}
    for key, kind in (("lw", "lw_fsck"), ("sw", "sw_wide")):
        path = str(d / f"{key}.nc")
        write_synthetic_ckd(path, kind, seed=3)
        out[key] = load_ckd_model(path, dtype=torch.float32)
    return out


def _call_every_wrapper(models):
    b = example_flux_batch(3, 5, np.float32)
    T = lambda k: torch.as_tensor(b[k])
    m_lw, m_sw = models["lw"], models["sw"]
    emis = T("emis")[:, None].expand(3, m_lw.ngpt).contiguous()
    lwsw.lwsw_fluxes_cuda(m_lw, m_sw, T("plev"), T("tlay"), T("tlev"),
                          T("tsfc"), emis, b["concs"], T("alb"),
                          T("tsi"), T("sza"))
    lw.lw_fluxes_cuda(m_lw, T("plev"), T("tlay"), T("tlev"), T("tsfc"),
                      emis, b["concs"])
    sw.sw_fluxes_cuda(m_sw, T("plev"), T("tlay"), b["concs"], T("alb"),
                      T("tsi"), T("sza"))


@pytest.fixture
def launches(monkeypatch, loads):
    """``staged.run_staged`` stood in for (each launch's kernel and
    ``lib`` logged) with the CUDA-only checks."""
    log = []

    def run_staged(atm, lw_in, sw_in, column_chunk, counted, **launch):
        log.append((staged.kernel_name(lw_in, sw_in), launch.get("lib")))
        n = 2 * ((lw_in is not None) + (sw_in is not None))
        return [torch.zeros(atm.tlay.shape[0], atm.tlay.shape[1] + 1)] * n

    monkeypatch.setattr(staged, "run_staged", run_staged)
    monkeypatch.setattr(binding, "require_cuda", lambda *a: None)
    monkeypatch.setattr(binding, "check_inputs", lambda *a: None)
    return log


def test_timed_hands_its_build_to_the_merged_kernel_alone(models, launches):
    plain_run = staged.run_staged
    with role_clock.timed() as timing:
        _call_every_wrapper(models)
    assert staged.run_staged is plain_run
    lib = role_clock.library()
    assert launches == [("lwsw", lib), ("lw", None), ("sw", None)]
    assert timing.record == role_clock.parse(list(range(WORDS)))
    del launches[:]
    _call_every_wrapper(models)
    assert launches == [("lwsw", None), ("lw", None), ("sw", None)]


def test_timed_refuses_under_capture(models, launches, monkeypatch):
    plain_run = staged.run_staged
    monkeypatch.setattr(role_clock, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capturing"):
        with role_clock.timed():
            pass
    assert staged.run_staged is plain_run
    capturing = [False]
    monkeypatch.setattr(role_clock, "capturing", lambda: capturing[0])
    with pytest.raises(RuntimeError, match="under graph capture"):
        with role_clock.timed():
            capturing[0] = True
            _call_every_wrapper(models)
    assert staged.run_staged is plain_run and launches == []


def test_read_parses_and_resets_the_record():
    words = list(range(100, 100 + WORDS))
    calls = []
    lib = _fake_lib("lwsw", words, calls)
    record = role_clock.read(lib)
    record_kept = role_clock.read(lib, reset=False)
    assert calls == [1, 0] and record == record_kept
    n = len(role_clock.COUNTERS)
    for r, role in enumerate(role_clock.ROLES):
        assert record[role] == dict(zip(role_clock.COUNTERS,
                                        words[r * n:(r + 1) * n]))
    lib.ecckd_lwsw_role_clock = _Fn(lambda out, reset: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        role_clock.read(lib)


def test_shares_of_a_stubbed_record():
    zero = dict.fromkeys(role_clock.COUNTERS, 0)
    record = {
        "optics": dict(zero, total=1000, free=250, params=100, optics=600,
                       warps=12),
        "lw_sweep": dict(zero, total=800, full=300, lw_done=100, sweep=300,
                         params=50, warps=2),
        "sw_sweep": dict(zero, total=400, full=100, sweep=250, warps=2)}
    assert role_clock.shares(record) == {"optics": 25.0, "lw_sweep": 50.0,
                                         "sw_sweep": 25.0}
    record["sw_sweep"] = dict(zero)
    assert role_clock.shares(record)["sw_sweep"] is None


def test_sweep_cycles_of_a_stubbed_record():
    """Each sweep warp's cycles a column: 4 sets (one SW warp each) over
    1000 columns walk 250 columns a warp; the LW sweep row counts both
    g-chunks' warps, the lw_chunk1 row the second chunk's again."""
    zero = dict.fromkeys(role_clock.COUNTERS, 0)
    record = {"optics": dict(zero, warps=40),
              "sw_sweep": dict(zero, sweep=4_000_000, warps=4),
              "lw_sweep": dict(zero, sweep=4_400_000, warps=8),
              "lw_chunk1": dict(zero, sweep=1_400_000, warps=4)}
    assert role_clock.sweep_cycles(record, 1000) == {
        "sw_sweep": 4000.0, "lw_chunk0": 3000.0, "lw_chunk1": 1400.0}
    record["lw_chunk1"] = dict(zero)
    assert role_clock.sweep_cycles(record, 1000) == {
        "sw_sweep": 4000.0, "lw_chunk0": 2200.0, "lw_chunk1": None}


def test_the_python_side_mirrors_the_c_side():
    src = (CSRC / "role_clock.cuh").read_text()
    kinds = re.search(r"enum RoleKind \{([^}]*)\}", src).group(1)
    assert [k.split("=")[0].strip().lower() for k in kinds.split(",")] == [
        "role_" + r for r in role_clock.ROLES]
    counters = re.search(r"enum RoleCounter \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"RC_(\w+) = (\d+)", counters)
    assert [n.lower() for n, _ in names] == list(role_clock.COUNTERS)
    assert [int(v) for _, v in names] == list(range(len(names)))
    for define in role_clock.PLANT_DEFINES.values():
        assert f"#ifdef {define}" in src
    staged_src = (CSRC / "staged.cuh").read_text()
    assert "#ifdef ECCKD_TIME_ROLES" in staged_src
    assert '#include "role_clock.cuh"' in staged_src
    # Every counter statement is the timed build's alone.
    body = staged_src.split("#endif", 2)[-1]
    assert "rc." not in re.sub(r"ROLE_CLOCK\((?:[^()]|\([^()]*\))*\)", "",
                                body)
    for name in ("lw", "sw"):
        assert "ROLE_CLOCK_ENTRY_POINTS" not in (CSRC / f"{name}.cu"
                                                 ).read_text()
    assert (CSRC / "lwsw.cu").read_text().rstrip().endswith(
        "ROLE_CLOCK_ENTRY_POINTS(lwsw)")


def _run_of(cell_name, devices):
    cell, config = bench_run.load_cell(cell_name)
    return bench_run.Run(cell, config, {}, None, {}, devices, None, None,
                         {}, cell["params"]["ncol"])


def _reader(metric):
    path = ROOT / "radbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_the_readers_give_none_without_a_card_or_a_timed_build(
        metric, monkeypatch):
    read = _reader(metric)
    measured = []
    monkeypatch.setattr(role_shares, "measure",
                        lambda *a: measured.append(a) or {})
    assert read(_run_of("l60_batch", [torch.device("cpu")])) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(role_shares, "program_role_clock", lambda: None)
    assert read(_run_of("l60_batch", [torch.device("cuda", 0)])) is None
    assert measured == []


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_the_readers_share_one_measurement(metric, monkeypatch):
    measured = []
    shares = {"optics": 12.5, "lw_sweep": 40.0, "sw_sweep": 55.0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(role_shares, "program_role_clock", lambda: "rc")
    monkeypatch.setattr(role_shares, "measure",
                        lambda *a: measured.append(a) or shares)
    run = _run_of("l60_batch", [torch.device("cuda", 0)])
    assert _reader(metric)(run) == shares[METRICS[metric]]
    assert [_reader(m)(run) for m in sorted(METRICS)] == [
        shares[METRICS[m]] for m in sorted(METRICS)]
    assert measured == [(run, torch.device("cuda", 0), "rc")]


def test_the_program_without_a_role_clock_reads_none(monkeypatch):
    real = importlib.import_module

    def import_module(name, *a):
        if name == role_shares.MODULE:
            raise ModuleNotFoundError(f"No module named {name!r}",
                                      name=name)
        return real(name, *a)
    monkeypatch.setattr(importlib, "import_module", import_module)
    assert role_shares.program_role_clock() is None


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_the_helper_times_one_eager_call_of_the_cells_traffic(cell,
                                                              monkeypatch):
    """On the CPU, at a chunk of 4 columns, with ``role_clock`` stood in
    for: the cell's traffic kind is set up at one launch chunk and one
    variant, its calls run eagerly (no ``capture.jit`` entry), and one
    call of the program runs inside ``timed``."""
    from ecckd_tpu_torch import pipeline
    from ecckd_tpu_torch.utils import capture
    jit = capture.jit
    calls = []
    inside = [False]
    real = pipeline.lw_sw_fluxes

    def counted(*a, **k):
        calls.append((inside[0], a[3].shape, k))
        return real(*a, **k)
    monkeypatch.setattr(pipeline, "lw_sw_fluxes", counted)

    @contextlib.contextmanager
    def timed():
        inside[0] = True
        yield types.SimpleNamespace(shares={"optics": 1.0})
        inside[0] = False
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    run = _run_of(cell, [torch.device("cpu")])
    run.cell["params"]["column_chunk"] = 4
    got = role_shares.measure(run, torch.device("cpu"),
                              types.SimpleNamespace(timed=timed))
    assert got == {"optics": 1.0}
    assert capture.jit is jit
    _, config = bench_run.load_cell(cell)
    shape = (4, config["nlay"])
    assert [c[:2] for c in calls] == [(False, shape)] * 2 + [(True, shape)]
    want = dict(n_gauss_angles=config["n_gauss_angles"], column_chunk=4)
    if run.cell["traffic"] == "batch_jac":
        want["flux_up_jac"] = True
    assert calls[-1][2] == want


def test_the_manifest_lists_the_shares_on_the_batch_cells():
    entries = [m for m in BENCH["per_layer"] if m["name"] in METRICS]
    assert [m["name"] for m in entries] == list(METRICS)
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for m in entries:
        assert m == {"name": m["name"], "unit": "%", "better": "lower",
                     "source": "program_counter", "layer": "kernels",
                     "moves": "columns_per_s", "workloads": BATCH_CELLS}
        for c in m["workloads"]:
            assert c in cells
            assert (ROOT / "radbench" / "workloads" / f"{c}.json").is_file()
            assert "columns_per_s" in {
                x["name"] for x in bench_run.cell_metrics(BENCH, c,
                                                          "end_to_end")}
        assert callable(bench_run.reader(m["name"]))
    assert "role_shares" not in {m["name"] for m in BENCH["per_layer"]}
    assert {m["layer"] for m in BENCH["per_layer"]
            if m["name"] == "lwsw_roofline"} == {"kernels"}


def test_stage_sweep_takes_the_roles_flag(capsys):
    from tools import stage_sweep
    if torch.cuda.is_available():
        pytest.skip("on a card the sweep would run")
    assert stage_sweep.main(["--roles", "--shapes", ""]) == 1
    assert "no CUDA card" in capsys.readouterr().err
