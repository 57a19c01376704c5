"""PyTorch port: bench_cuda.py, the port's counterpart of bench.py, on the
CPU at small sizes.

* Each of the six configurations' programs, built as the bench times them
  (``build_cases``: ``capture.jit`` of ``lw_sw_fluxes`` / ``lw_fluxes``,
  which runs eagerly on the CPU), at float64 against bench.py's program,
  the JAX package's function with ``backend="xla"`` at float64, on the
  same synthetic ckd files (both loaders) and the same
  ``example_flux_batch`` at 24 x 8: rtol 1e-10.
* The bench's batch is bench.py's (``__graft_entry__._example_batch``)
  bit for bit; its configurations are bench.py's, and the configs mode
  times exactly the cases it gated.
* The gate: a solve that moves an output by 1e-3 of the flux scale makes
  headline and configs print the ``"parity_ok": false`` line, exit 1 and
  write nothing, where the same run unperturbed writes its artifact.  A
  solve that is wrong only at the timed shape, in its last launch chunk,
  passes the gate and fails the check after the timed window alike; that
  check's columns cover every launch chunk.
  These runs stand the CPU in for the card (``bench_cuda.card``) and
  shrink the protocol, so that a run at protocol is cheap here.
* Off-protocol runs write nothing; without a card headline and configs
  exit non-zero and write nothing; ``cpu_baseline`` prints its line.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_cuda
from __graft_entry__ import _example_batch
from ecckd_tpu import pipeline as jpipe
from ecckd_tpu.models.loader import load_ckd_model as jax_load
from ecckd_tpu_torch import config, pipeline
from ecckd_tpu_torch.fluxes import FluxesBroadband

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The bench's synthetic files, loaded by both packages at float64."""
    paths = bench_cuda.write_models(str(tmp_path_factory.mktemp("bench")))
    return (bench_cuda.load_models(paths, torch.float64, "cpu"),
            {k: jax_load(p, dtype=np.float64) for k, p in paths.items()})


@pytest.mark.parametrize("name", list(bench_cuda.CONFIGS))
def test_bench_programs_match_bench_py(models, name):
    torch_models, jax_models = models
    case = bench_cuda.build_cases([name], torch_models)[name]
    b = bench_cuda.batch(24, 8, np.float64, "cpu")
    got = case(b)
    assert len(got) == (4 if len(case.models) == 2 else 2)
    j = _example_batch(24, 8, np.float64)
    program, lw_name, n_ang = bench_cuda.CONFIGS[name]
    jlw = jax_models[lw_name]
    if program == "merged":
        f_lw, f_sw = jpipe.lw_sw_fluxes(
            jlw, jax_models["wide"], j["plev"], j["tlay"], j["tlev"],
            j["tsfc"], j["emis"], j["concs"], j["alb"], j["tsi"], j["sza"],
            n_gauss_angles=n_ang, backend="xla")
        ref = [f_lw.flux_up, f_lw.flux_dn, f_sw.flux_up, f_sw.flux_dn]
    else:
        f = jpipe.lw_fluxes(jlw, j["plev"], j["tlay"], j["tlev"], j["tsfc"],
                            j["emis"], j["concs"], n_gauss_angles=n_ang,
                            backend="xla")
        ref = [f.flux_up, f.flux_dn]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=0)
    step = case.step(b)
    assert float(step) == pytest.approx(
        sum(float(np.asarray(r)[:, 0].sum()) for r in ref[::2]), rel=RTOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bench_batch_is_bench_py_batch(dtype):
    got = bench_cuda.batch(37, 9, dtype, "cpu")
    ref = _example_batch(37, 9, dtype)
    for k in ("plev", "tlay", "tlev", "tsfc", "emis", "alb", "tsi", "sza"):
        assert got[k].dtype == torch.from_numpy(ref[k]).dtype
        assert np.array_equal(got[k].numpy(), ref[k]), k
    assert got["concs"].names == tuple(ref["concs"].names)
    for g, r in zip(got["concs"].values, ref["concs"].values):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.fixture
def on_cpu(monkeypatch):
    """The CPU stands in for the card, and the protocols shrink so that a
    run at protocol is cheap here."""
    monkeypatch.setattr(bench_cuda, "card",
                        lambda: (torch.device("cpu"), "CPU stand-in"))
    monkeypatch.setitem(bench_cuda.HEADLINE, "ncol", 32)
    monkeypatch.setitem(bench_cuda.HEADLINE, "steps", 2)
    monkeypatch.setitem(bench_cuda.CONFIGS_PROTOCOL, "ncol", 16)
    monkeypatch.setitem(bench_cuda.CONFIGS_PROTOCOL, "steps", 1)
    monkeypatch.setitem(bench_cuda.CONFIGS_PROTOCOL, "epochs", 1)
    monkeypatch.setitem(bench_cuda.GATE, "ncol", 40)
    monkeypatch.setattr(bench_cuda, "COLUMN_CHUNK", 16)   # two at headline
    mode = config.mxu_precision()
    yield
    assert config.mxu_precision() == mode


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_configs_times_exactly_the_gated_cases(on_cpu, tmp_path, capsys,
                                               monkeypatch):
    assert bench_cuda.CONFIGS == bench.GATE_CASES
    gated = []
    real_gate = bench_cuda.parity_gate

    def recording_gate(cases, *args):
        gated.append(set(cases))
        return real_gate(cases, *args)

    monkeypatch.setattr(bench_cuda, "parity_gate", recording_gate)
    assert bench_cuda.main(["--mode", "configs"],
                           artifact_dir=str(tmp_path)) == 0
    out = last_line(capsys)
    assert gated == [set(bench_cuda.CONFIGS)]
    assert (set(out["configs"]) == set(out["parity"])
            == set(out["parity_timed"]) == gated[0])
    assert out["protocol"] and out["parity_ok"]
    assert os.listdir(tmp_path) == ["BENCH_CUDA_CONFIGS.json"]


def perturbed(solve, timed_shape_only=False):
    """``solve`` with its LW up flux moved by 1e-3 of the LW flux scale;
    with ``timed_shape_only`` only off the gate's shape, and there only in
    the last launch chunk."""
    def run(*args, **kwargs):
        f_lw, *rest = solve(*args, **kwargs)
        ncol = f_lw.flux_up.shape[0]
        scale = torch.maximum(f_lw.flux_up.abs().max(),
                              f_lw.flux_dn.abs().max())
        shift = torch.full_like(f_lw.flux_up, 1e-3) * scale
        if timed_shape_only:
            if ncol == bench_cuda.GATE["ncol"]:
                return (f_lw, *rest)
            chunk = bench_cuda.COLUMN_CHUNK
            shift[:(ncol - 1) // chunk * chunk] = 0.0
        return (FluxesBroadband(f_lw.flux_up + shift, f_lw.flux_dn), *rest)
    return run


@pytest.mark.parametrize("mode,artifact", [
    ("headline", "BENCH_CUDA.json"), ("configs", "BENCH_CUDA_CONFIGS.json")])
def test_gate_failure_exits_1_and_writes_nothing(on_cpu, tmp_path, capsys,
                                                 monkeypatch, mode, artifact):
    good = tmp_path / "good"
    bad = tmp_path / "bad"
    good.mkdir()
    bad.mkdir()
    assert bench_cuda.main(["--mode", mode], artifact_dir=str(good)) == 0
    assert os.listdir(good) == [artifact]       # the same run, unperturbed
    assert last_line(capsys)["parity_ok"]
    monkeypatch.setattr(pipeline, "lw_sw_fluxes",
                        perturbed(pipeline.lw_sw_fluxes))
    with pytest.raises(SystemExit) as exit_:
        bench_cuda.main(["--mode", mode], artifact_dir=str(bad))
    assert exit_.value.code == 1
    out = last_line(capsys)
    assert out["parity_ok"] is False and out["value"] == 0.0
    assert out["parity_stage"] == "gate"
    assert 9e-4 < out["parity_cases"]["lw_fsck+sw_wide_1ang"] < 2e-3
    assert os.listdir(bad) == []


@pytest.mark.parametrize("mode", ["headline", "configs"])
def test_timed_shape_fault_fails_after_timing(on_cpu, tmp_path, capsys,
                                              monkeypatch, mode):
    monkeypatch.setattr(pipeline, "lw_sw_fluxes",
                        perturbed(pipeline.lw_sw_fluxes,
                                  timed_shape_only=True))
    with pytest.raises(SystemExit) as exit_:
        bench_cuda.main(["--mode", mode], artifact_dir=str(tmp_path))
    assert exit_.value.code == 1
    err = capsys.readouterr()
    out = json.loads(err.out.strip().splitlines()[-1])
    assert "parity gate [lw_fsck+sw_wide_1ang]" in err.err   # it passed
    assert out["parity_ok"] is False and out["value"] == 0.0
    assert out["parity_stage"] == "timed"
    assert 9e-4 < out["parity_cases"]["lw_fsck+sw_wide_1ang"] < 2e-3
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("ncol", [524288, 65536, 65537, 100])
def test_timed_columns_cover_every_chunk(ncol):
    cols = bench_cuda.timed_columns(ncol).tolist()
    width, chunk = bench_cuda.GATE["ncol"], bench_cuda.COLUMN_CHUNK
    assert cols == sorted(set(cols)) and 0 <= cols[0] and cols[-1] == ncol - 1
    for c0 in range(0, ncol, chunk):
        assert set(range(c0, min(c0 + width, ncol))) <= set(cols)
    assert len(cols) <= width * (-(-ncol // chunk) + 1)


@pytest.mark.parametrize("argv", [["--mode", "headline", "--ncol", "16"],
                                  ["--mode", "headline", "--ncol", "44"],
                                  ["--mode", "configs", "--ncol", "8"]])
def test_off_protocol_runs_write_nothing(on_cpu, tmp_path, capsys, argv):
    assert bench_cuda.main(argv, artifact_dir=str(tmp_path)) == 0
    out = last_line(capsys)
    assert out["protocol"] is False and out["parity_ok"]
    assert {"ncol", "column_chunk", "date"} <= set(out)
    assert os.listdir(tmp_path) == []


def artifacts():
    return {name: os.stat(os.path.join(REPO, name)).st_mtime_ns
            for name in os.listdir(REPO) if name.startswith("BENCH_CUDA")}


@pytest.mark.parametrize("mode", ["headline", "configs"])
def test_no_card_exits_nonzero_and_writes_nothing(tmp_path, monkeypatch,
                                                  mode):
    card_here = torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_:
        bench_cuda.main(["--mode", mode], artifact_dir=str(tmp_path))
    assert exit_.value.code not in (0, None)
    assert os.listdir(tmp_path) == []
    if not card_here:                   # the script itself, without a card
        before = artifacts()
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "bench_cuda.py"), "--mode",
             mode], cwd=tmp_path, capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode != 0 and proc.stdout == ""
        assert "no CUDA card" in proc.stderr
        assert artifacts() == before


def test_cpu_baseline_prints_its_line(capsys):
    threads = torch.get_num_threads()
    assert bench_cuda.main(["--mode", "cpu_baseline", "--ncol", "32"]) == 0
    out = last_line(capsys)
    assert out["metric"] == "cpu_serial_baseline_columns_per_sec"
    assert out["unit"] == "columns/s" and out["value"] > 0
    assert (out["ncol"], out["nlay"], out["threads"]) == (32, 60, 1)
    assert out["precision"] == "float64" and out["cpu"]
    assert torch.get_num_threads() == threads
