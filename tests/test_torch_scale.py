"""PyTorch port: the weak-scaling stream (parallel/scale.py), scale_bench
and profiling on the CPU.

* ``stream_chunks`` drains every chunk exactly once, in order, at depths
  1, 2, 3 and 7, with at most depth + 1 chunks live, and reports the
  per-phase budget keys (as tests/test_scale.py does for the JAX one).
* ``run_weak_scaling``: each chunk's streamed outputs bitwise equal to the
  same step unstreamed; over two CPU "devices", equal to the unstreamed
  column split; the ``batch_leaf`` hatch at a chunk of 53 columns.
* The port's ``scale_bench --device cpu`` files against the JAX
  ``scale_bench``'s on the same synthetic ckd files: rlu, rld, rsu, rsd
  within 5e-5 of each band's flux scale (both float32); ``--resume``
  bitwise; its fail-fast refusals.
* ``trace`` runs on the CPU and writes its file.
"""
import json

import numpy as np
import pytest
import torch

from torch_parity import (atmosphere, ckd_paths, load_both,  # noqa: F401
                          torch_concs)
from ecckd_tpu_torch import pipeline as tpipe
from ecckd_tpu_torch.cli import scale_bench as t_bench
from ecckd_tpu_torch.parallel import mesh as tmesh
from ecckd_tpu_torch.parallel.scale import (place_pytree, run_weak_scaling,
                                            stream_chunks)
from ecckd_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)
BOUND = 5e-5
BUDGET = ("dispatch_s", "d2h_issue_s", "drain_wait_s", "consume_s", "wall_s")


@pytest.mark.parametrize("depth", [1, 2, 3, 7])
def test_stream_chunks_depth_semantics(depth):
    inflight = {"now": 0, "max": 0}
    drained = []

    def step(i):
        inflight["now"] += 1
        inflight["max"] = max(inflight["max"], inflight["now"])
        return {"val": torch.full((4,), float(i)),
                "id": torch.tensor(i, dtype=torch.int32)}

    def consume(host, meta):
        inflight["now"] -= 1
        assert isinstance(host["val"], np.ndarray)
        assert float(host["val"][0]) == float(meta) == int(host["id"])
        drained.append(int(meta))

    n = 5
    m = stream_chunks(step, (((i,), i) for i in range(n)), consume=consume,
                      depth=depth)
    assert drained == list(range(n))
    assert m["n_chunks"] == n
    # At most depth+1 chunks live at once: the one being dispatched plus
    # depth waiting behind the drain point.
    assert inflight["max"] <= min(depth + 1, n)
    for key in BUDGET:
        assert m[key] >= 0.0


def _lw_chunks(n_chunks, chunk, nlay=12):
    out = []
    for i in range(n_chunks):
        atm, gases = atmosphere(chunk, nlay, seed=100 + i)
        t = {k: torch.as_tensor(atm[k]) for k in ("plev", "tlay", "tlev",
                                                  "tsfc")}
        out.append((t["plev"], t["tlay"], t["tlev"], t["tsfc"],
                    torch.full((chunk,), 0.97, dtype=torch.float64),
                    torch_concs(gases)))
    return out


def _step(m, plev, tlay, tlev, tsfc, emis, concs):
    f = tpipe.lw_fluxes(m, plev, tlay, tlev, tsfc, emis, concs)
    return (f.flux_up, f.flux_dn)


@pytest.mark.parametrize("n_dev", [1, 2])
def test_run_weak_scaling_matches_unstreamed(ckd_paths, n_dev):
    _, model = load_both(ckd_paths["lw"])
    chunk, n_chunks = 16, 4
    chunks = _lw_chunks(n_chunks, chunk)
    mesh = [torch.device("cpu")] * n_dev
    seen = []
    metrics = run_weak_scaling(
        _step, lambda i: (model,) + chunks[i], n_chunks, chunk, mesh=mesh,
        consume=lambda host, i: seen.append((i, [a.copy() for a in host])),
        warmup=1, chunk_ids=[0, 2, 3, 1])
    assert metrics["n_chunks"] == n_chunks
    assert metrics["n_devices"] == n_dev
    assert metrics["total_columns"] == chunk * n_chunks
    assert metrics["columns_per_sec_per_device"] == pytest.approx(
        metrics["columns_per_sec"] / n_dev)
    assert 0.0 <= metrics["host_consume_fraction"] <= 1.0
    assert [i for i, _ in seen] == [0, 2, 3, 1]     # chunk_ids, in order
    for i, (up, dn) in seen:
        args = (model,) + chunks[i]
        ref = (_step(*args) if n_dev == 1 else
               tmesh.shard_columns_call(_step, mesh, args, chunk))
        np.testing.assert_array_equal(up, ref[0].numpy())
        np.testing.assert_array_equal(dn, ref[1].numpy())


def test_place_pytree_batch_leaf_hatch():
    """A replicated leaf whose leading extent equals the chunk (53, the
    shipped files' pressure-grid length) stays whole when the caller marks
    batch leaves explicitly; the shape rule alone would split it."""
    mesh = [torch.device("cpu")] * 2
    ncol = 53
    model_like = {"log_pressure": torch.arange(ncol, dtype=torch.float32),
                  "table": torch.ones((ncol, 4))}
    batch = {"tlay": torch.ones((ncol, 8))}
    model_ids = {id(v) for v in model_like.values()}

    def batch_leaf(x):
        return (id(x) not in model_ids and getattr(x, "ndim", 0) >= 1
                and x.shape[0] == ncol)

    placed = place_pytree((model_like, batch), mesh, ncol,
                          batch_leaf=batch_leaf)
    for m, b in placed.trees:
        assert b["tlay"].shape == (27, 8)
        assert m["table"].shape == (ncol, 4)
        assert m["log_pressure"].shape == (ncol,)
    split = place_pytree((model_like, batch), mesh, ncol)
    assert split.trees[0][0]["table"].shape == (27, 4)
    # One device: everything whole, numpy leaves become tensors.
    one = place_pytree((np.zeros(3), model_like), [torch.device("cpu")], 3)
    assert isinstance(one[0], torch.Tensor)
    assert one[1]["table"] is model_like["table"]


@pytest.fixture(scope="module")
def bench_runs(ckd_paths, tmp_path_factory):
    """The port's and the JAX scale_bench at 64 x 8 in chunks of 16, both
    with --out-dir, on the synthetic lw_fsck and sw_wide files."""
    from ecckd_tpu.cli import common as jcommon, scale_bench as j_bench
    d = tmp_path_factory.mktemp("scale_bench")
    argv = ["--columns", "64", "--chunk", "16", "--nlay", "8", "--lw-file",
            ckd_paths["lw"], "--sw-file", ckd_paths["sw"]]
    assert t_bench.main(argv + ["--device", "cpu", "--out-dir",
                                str(d / "torch")]) == 0
    # The JAX driver sets a persistent compile cache under HOME; the tests
    # keep theirs (tests/conftest.py).
    cache = jcommon.setup_compilation_cache
    jcommon.setup_compilation_cache = lambda: None
    try:
        assert j_bench.main(argv + ["--no-shard", "--out-dir",
                                    str(d / "jax")]) == 0
    finally:
        jcommon.setup_compilation_cache = cache
    return d, argv


def test_scale_bench_matches_jax(bench_runs):
    d, _ = bench_runs
    load = lambda who, v: np.load(d / who / f"{v}.npy")
    for band in (("rlu", "rld"), ("rsu", "rsd")):
        scale = max(float(np.abs(load("jax", v)).max()) for v in band)
        for v in band:
            got, ref = load("torch", v), load("jax", v)
            assert got.dtype == ref.dtype == np.float32
            assert got.shape == ref.shape == (64, 9)
            assert np.isfinite(got).all()
            err = float(np.abs(got.astype(np.float64) - ref).max()) / scale
            assert err <= BOUND, (v, err)
    np.testing.assert_array_equal(load("torch", "rld")[:, 0], 0.0)
    prog = json.loads((d / "torch" / "progress.json").read_text())
    assert prog["done"] == [0, 1, 2, 3]
    assert prog["config"] == {"columns": 64, "chunk": 16, "nlay": 8,
                              "outputs": "full"}


def test_scale_bench_resume_bitwise(bench_runs, tmp_path, capsys):
    d, argv = bench_runs
    out = tmp_path / "flx"
    run = lambda *extra: t_bench.main(argv + ["--device", "cpu", "--out-dir",
                                              str(out), *extra])
    assert run() == 0
    full = {v: np.load(out / f"{v}.npy") for v in ("rlu", "rld", "rsu",
                                                   "rsd")}
    for v, arr in full.items():
        np.testing.assert_array_equal(arr, np.load(d / "torch" / f"{v}.npy"))
    # An interrupted run: chunks 2 and 3 never completed, rows zeroed.
    prog = json.loads((out / "progress.json").read_text())
    (out / "progress.json").write_text(json.dumps(dict(prog, done=[0, 1])))
    for v in full:
        arr = np.lib.format.open_memmap(out / f"{v}.npy", mode="r+")
        arr[32:] = 0.0
        arr.flush()
        del arr
    capsys.readouterr()
    assert run("--resume") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n_chunks"] == 2 and line["total_columns"] == 32
    assert json.loads((out / "progress.json").read_text())["done"] == [
        0, 1, 2, 3]
    for v, arr in full.items():
        np.testing.assert_array_equal(np.load(out / f"{v}.npy"), arr)


@pytest.mark.parametrize("extra,message", [
    (["--resume"], "requires --out-dir"),
    (["--columns", "40"], "divisible"),
    (["--out-dir", "{out}", "--repeats", "2"], "conflicts"),
    (["--out-dir", "{out}", "--resume", "--nlay", "9"], "config mismatch"),
    (["--out-dir", "{out}", "--resume", "--columns", "32"], "config mismatch"),
])
def test_scale_bench_refusals(bench_runs, tmp_path, capsys, extra, message):
    """Fail-fast: a resume must not mix fluxes of another grid or
    chunking into one artifact; journaled writes stream once."""
    import shutil
    d, argv = bench_runs
    shutil.copytree(d / "torch", tmp_path / "flx")
    extra = [x.format(out=tmp_path / "flx") for x in extra]
    with pytest.raises(SystemExit):
        t_bench.main(argv + ["--device", "cpu", *extra])
    assert message in capsys.readouterr().err


def test_scale_bench_fresh_run_drops_a_stale_journal(bench_runs, tmp_path):
    import shutil
    d, argv = bench_runs
    out = tmp_path / "flx"
    shutil.copytree(d / "torch", out)
    (out / "progress.json").write_text(json.dumps({"done": [0, 1, 2, 3]}))
    assert t_bench.main(argv + ["--device", "cpu", "--columns", "32",
                                "--out-dir", str(out),
                                "--outputs", "toa-net"]) == 0
    prog = json.loads((out / "progress.json").read_text())
    assert prog == {"done": [0, 1], "config": {
        "columns": 32, "chunk": 16, "nlay": 8, "outputs": "toa-net"}}
    assert np.load(out / "toa_net.npy").shape == (32,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_bench.main(argv)


def test_profiling_on_the_cpu(tmp_path):
    x = torch.linspace(0.0, 1.0, 10_000)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with torch.profiler.record_function("block"):
            x.exp()
    assert any(e.key == "block" for e in prof.key_averages())
    with open(tmp_path / "tr" / tprof.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "block" in names
