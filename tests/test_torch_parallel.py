"""PyTorch port: the column split (parallel/mesh.py) on the CPU.

* ``pad_columns`` / ``pad_to_mesh`` give the JAX rule's arrays on odd
  column counts, on numpy arrays and on tensors.
* ``shard_columns_call`` over four CPU "devices": each device's piece is
  bitwise equal to a one-process call on the same rows (equal shapes:
  torch's CPU kernels vectorise the body of a tensor and may take a scalar
  path on its tail, so a column can round differently in a batch of
  another length), and the joined whole equals the unsplit call at
  rtol <= 1e-12 at float64.  The escape hatches keep a table whose
  leading extent equals ncol (53, the shipped pressure grid's length)
  whole.
* Two Gloo processes (``init_distributed`` + ``distributed_columns_call``,
  and ``ecckd_rfmip_lw --num-processes 2``) against one process, in
  subprocesses with a 120 s timeout that are killed on failure.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import (atmosphere, ckd_paths, load_both,  # noqa: F401
                          torch_concs)
from ecckd_tpu.parallel import mesh as jmesh
from ecckd_tpu_torch import pipeline as tpipe
from ecckd_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = [torch.device("cpu")] * 4


@pytest.mark.parametrize("ncol,n_dev", [(11, 4), (53, 8), (16, 4), (1, 3)])
def test_pad_to_mesh_matches_jax(ncol, n_dev):
    assert tmesh.pad_columns(ncol, n_dev) == jmesh.pad_columns(ncol, n_dev)
    a = np.random.default_rng(ncol).uniform(size=(ncol, 3, 2))
    ref = jmesh.pad_to_mesh(a, n_dev)
    np.testing.assert_array_equal(tmesh.pad_to_mesh(a, n_dev), ref)
    np.testing.assert_array_equal(
        tmesh.pad_to_mesh(torch.as_tensor(a), n_dev).numpy(), ref)
    v = np.arange(ncol, dtype=np.float32)
    np.testing.assert_array_equal(
        tmesh.pad_to_mesh(torch.as_tensor(v), n_dev).numpy(),
        jmesh.pad_to_mesh(v, n_dev))


def test_make_column_mesh_and_shard_batch():
    assert tmesh.make_column_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmesh.make_column_mesh()
    a = np.arange(22.0).reshape(11, 2)
    pieces, ncol = tmesh.shard_batch([a, a[:, 0]], CPUS)
    assert ncol == 11 and len(pieces) == 4
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in pieces]).numpy(), jmesh.pad_to_mesh(a, 4))
    assert all(p[1].shape == (3,) for p in pieces)


def _lw_inputs(ncol, nlay=20, seed=42):
    atm, gases = atmosphere(ncol, nlay, seed=seed)
    t = {k: torch.as_tensor(atm[k]) for k in ("plev", "tlay", "tlev",
                                              "tsfc")}
    return (t["plev"], t["tlay"], t["tlev"], t["tsfc"],
            torch.full((ncol,), 0.98, dtype=torch.float64),
            torch_concs(gases))


def _rows(args, lo, hi, ncol, n_dev):
    """Columns [lo, hi) of the batch arguments padded for ``n_dev`` pieces:
    the one-process call on the rows a piece holds."""
    from ecckd_tpu_torch.utils.tree import tree_map
    return tree_map(lambda x: tmesh.pad_to_mesh(x, n_dev)[lo:hi].clone()
                    if isinstance(x, torch.Tensor) and x.ndim
                    and x.shape[0] == ncol else x, args)


@pytest.mark.parametrize("ncol", [16, 11])
def test_shard_columns_call_four_cpu_devices(ckd_paths, ncol):
    _, model = load_both(ckd_paths["lw"])
    args = (model,) + _lw_inputs(ncol)

    def fn(m, *a):
        f = tpipe.lw_fluxes(m, *a)
        return f.flux_up, f.flux_dn

    up, dn = tmesh.shard_columns_call(fn, CPUS, args, ncol,
                                      replicated_argnums=(0,))
    ref = fn(*args)
    assert up.shape == ref[0].shape and dn.shape == ref[1].shape
    for g, r in zip((up, dn), ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12, atol=0)
    # Each piece bitwise against the one-process call on its rows (the
    # padded last piece repeats column ncol-1).
    per = tmesh.pad_columns(ncol, 4) // 4
    shards = tmesh.split_columns(args, CPUS, ncol, replicated_argnums=(0,))
    for d in range(4):
        lo, hi = d * per, min((d + 1) * per, ncol)
        local = fn(*_rows(args, lo, lo + per, ncol, 4))
        for p, loc, whole in zip(fn(*shards.trees[d]), local, (up, dn)):
            assert torch.equal(p, loc)
            assert torch.equal(whole[lo:hi], loc[:hi - lo])
    # The model went whole to every device: the same object.
    assert all(t[0] is model for t in shards.trees)


def test_split_escape_hatches_keep_tables_whole_at_ncol_53():
    """A replicated table whose leading extent equals ncol must not be
    split: the shape rule alone cannot tell it from a batch array (53 is
    the length of the shipped files' pressure grid)."""
    ncol = 53
    table = torch.arange(ncol * 3, dtype=torch.float64).reshape(ncol, 3)
    cols = torch.linspace(0.0, 1.0, ncol, dtype=torch.float64)

    def fn(table, cols):
        # every column reads the WHOLE table: wrong if the table was split
        return cols[:, None] + table.sum() + torch.zeros(cols.shape[0], 1,
                                                         dtype=cols.dtype)

    expect = fn(table, cols)
    got = tmesh.shard_columns_call(fn, CPUS, (table, cols), ncol,
                                   replicated_argnums=(0,))
    assert torch.equal(got, expect)
    got = tmesh.shard_columns_call(fn, CPUS, (table, cols), ncol,
                                   batch_leaf=lambda x: x is cols)
    assert torch.equal(got, expect)
    # ...and the shape rule alone WOULD have split it.
    split = tmesh.shard_columns_call(fn, CPUS, (table, cols), ncol)
    assert not torch.allclose(split, expect)


def test_init_distributed_is_a_no_op_for_one_process():
    tmesh.init_distributed(None, None, None)
    tmesh.init_distributed(None, 1, 0)
    assert not torch.distributed.is_initialized()
    assert tmesh.world() == (0, 1)
    with pytest.raises(ValueError, match="--coordinator"):
        tmesh.init_distributed(None, 2, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.init_distributed("127.0.0.1:1", 2, 0)
        assert not torch.distributed.is_initialized()


WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from ecckd_tpu_torch import pipeline
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.parallel import mesh
rank = int(sys.argv[1])
mesh.init_distributed("127.0.0.1:" + sys.argv[2], 2, rank, device="cpu")
assert mesh.world() == (rank, 2)
d = np.load(sys.argv[4])
ncol = d["tlay"].shape[0]
model = load_ckd_model(sys.argv[3], dtype=torch.float64)
T = lambda k: torch.as_tensor(d[k])
concs = GasConcs.create([("h2o", T("h2o")), ("o3", T("o3")),
                         ("co2", T("co2"))])
args = (model, T("plev"), T("tlay"), T("tlev"), T("tsfc"), T("emis"), concs)
fn = lambda m, *a: pipeline.lw_fluxes(m, *a)
out = mesh.distributed_columns_call(fn, "cpu", args, ncol,
                                    replicated_argnums=(0,))
ref = fn(*args)
for g, r in ((out.flux_up, ref.flux_up), (out.flux_dn, ref.flux_dn)):
    assert g.shape == r.shape
    np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12, atol=0)
# Bitwise per piece, against the one-process call on the same rows of
# the padded batch.
per = mesh.pad_columns(ncol, 2) // 2
for r in range(2):
    lo, hi = r * per, min((r + 1) * per, ncol)
    cut = lambda x: (mesh.pad_to_mesh(x, 2)[lo:lo + per].clone()
                     if x.ndim and x.shape[0] == ncol else x)
    local = fn(model, *(cut(x) for x in args[1:6]),
               GasConcs(values=tuple(cut(v) for v in concs.values),
                        names=concs.names))
    assert torch.equal(out.flux_up[lo:hi], local.flux_up[:hi - lo])
    assert torch.equal(out.flux_dn[lo:hi], local.flux_dn[:hi - lo])
torch.distributed.destroy_process_group()
print("MP_OK", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(make_argvs, timeout=120):
    """Start one process per argv of ``make_argvs(port)`` on a free port;
    wait up to ``timeout`` s; kill what is left on any failure.  Picking a
    port and binding it later leaves a window in which another process
    can take it, so a bind failure gets one retry on a new port.  Returns
    [(returncode, output)]."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for attempt in range(2):
        procs = [subprocess.Popen(argv, env=env, cwd=REPO,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for argv in make_argvs(str(_free_port()))]
        try:
            results = [(p.returncode, out) for p, out in
                       ((p, p.communicate(timeout=timeout)[0])
                        for p in procs)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if attempt or not any(rc and "address already in use" in out.lower()
                              for rc, out in results):
            return results


def test_two_gloo_processes_split_columns(ckd_paths, tmp_path):
    ncol = 9      # odd: rank 1's piece carries one padded column
    atm, gases = atmosphere(ncol, 12, seed=3)
    batch = str(tmp_path / "batch.npz")
    np.savez(batch, plev=atm["plev"], tlay=atm["tlay"], tlev=atm["tlev"],
             tsfc=atm["tsfc"], emis=np.linspace(0.8, 1.0, ncol),
             h2o=gases["h2o"], o3=gases["o3"], co2=gases["co2"])
    results = _run_ranks(lambda port: [
        [sys.executable, "-c", WORKER, str(rank), port, ckd_paths["lw"],
         batch] for rank in range(2)])
    for rank, (rc, out) in enumerate(results):
        assert rc == 0 and f"MP_OK {rank}" in out, out[-3000:]


def test_two_gloo_processes_rfmip_lw_cli(ckd_paths, tmp_path):
    from ecckd_tpu_torch.cli import ecckd_rfmip_lw
    from ecckd_tpu_torch.io.rfmip import read_fluxes, write_synthetic_rfmip
    rfmip = str(tmp_path / "rfmip.nc")
    write_synthetic_rfmip(rfmip, nsite=3, nlay=10, nexp=3, seed=5)
    common = [rfmip, ckd_paths["lw"], "--device", "cpu", "--precision",
              "f64", "-p", "2"]
    assert ecckd_rfmip_lw.main(common + ["--no-shard", "--output-dir",
                                         str(tmp_path / "one")]) == 0
    results = _run_ranks(lambda port: [
        [sys.executable, "-m", "ecckd_tpu_torch.cli.ecckd_rfmip_lw", *common,
         "--output-dir", str(tmp_path / "two"), "--metrics-json",
         str(tmp_path / "two" / "m.json"), "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(rank)] for rank in range(2)])
    for rc, out in results:
        assert rc == 0, out[-3000:]
    stem = "_Efx_RTE-ecckd_rad-irf_r1i1p2f1_gn.nc"
    assert sorted(os.listdir(tmp_path / "two")) == sorted(
        ["m.json", "rlu" + stem, "rld" + stem])     # rank 0 wrote, once
    for var in ("rlu", "rld"):
        got = read_fluxes(str(tmp_path / "two" / (var + stem)), var)
        ref = read_fluxes(str(tmp_path / "one" / (var + stem)), var)
        assert got.shape == ref.shape == (9, 11)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    import json
    assert json.loads((tmp_path / "two" / "m.json").read_text())[
        "n_devices"] == 2
