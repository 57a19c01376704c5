"""PyTorch port: the sharded stream (parallel/mesh.py resident pieces,
parallel/scale.py, cli/scale_bench.resident_chunks) on a CPU mesh.

* Over three CPU "devices" the stream of scale_bench's chunks (its
  ``resident_chunks`` and ``make_step``, captured with ``capture.jit``,
  which runs CPU tensors eagerly) equals the one-device stream bit for
  bit at float64, in every output mode, on a chunk that three divides
  (51 columns) and one that it does not (50: one padded column, dropped).
* The same stream against the JAX package's sharded stream
  (``ecckd_tpu.parallel.scale.run_weak_scaling`` on a mesh of three of
  conftest's virtual CPU devices, the JAX scale_bench's chunks and step)
  on the same synthetic models carried across with ``ckd_from_jax``:
  rtol 1e-10 at float64.
* After placement a chunk moves no leaf but tsfc: every other piece is
  the same tensor in every chunk, on its device.
* The host view is the whole chunk in column order, whatever order the
  pieces are listed in; the pieces' offsets and padding spans.
"""
import numpy as np
import pytest
import torch

import jax

from torch_parity import ckd_paths  # noqa: F401
from ecckd_tpu.gases import GasConcs as JaxGasConcs
from ecckd_tpu.models.loader import load_ckd_model as jax_load
from ecckd_tpu.parallel import mesh as jmesh
from ecckd_tpu.parallel import scale as jscale
from ecckd_tpu.pipeline import lw_sw_fluxes as jax_lw_sw_fluxes
from ecckd_tpu_torch.cli import scale_bench
from ecckd_tpu_torch.io.synthetic import example_flux_batch
from ecckd_tpu_torch.models.ckd import ckd_from_jax
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.parallel import mesh as tmesh
from ecckd_tpu_torch.parallel.scale import (_PinnedRing, run_weak_scaling,
                                            stream_chunks)
from ecckd_tpu_torch.utils import capture

torch.set_num_threads(2)
CPU3 = [torch.device("cpu")] * 3
NLAY, N_CHUNKS = 8, 3
MODES = ("full", "boundary", "toa-net")


def _stream(lw, sw, mesh, ncol, mode, chunk_ids=None):
    """scale_bench's stream at float64: (chunk id, host outputs) of every
    chunk, in the order consumed."""
    chunk = scale_bench.resident_chunks(
        lw, sw, example_flux_batch(ncol, NLAY, np.float64), mesh, ncol)
    seen = []
    m = run_weak_scaling(
        capture.jit(scale_bench.make_step(mode)), chunk, N_CHUNKS, ncol,
        mesh=mesh, warmup=1, chunk_ids=chunk_ids,
        consume=lambda host, i: seen.append((i, [a.copy() for a in host])))
    assert m["n_chunks"] == len(seen) and m["n_devices"] == len(mesh)
    return seen


@pytest.fixture(scope="module")
def models64(ckd_paths):
    return (load_ckd_model(ckd_paths["lw"], dtype=torch.float64),
            load_ckd_model(ckd_paths["sw"], dtype=torch.float64))


@pytest.mark.parametrize("ncol", [51, 50])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_stream_equals_the_one_device_stream(models64, mode, ncol):
    lw, sw = models64
    ids = [2, 0, 1]
    one = _stream(lw, sw, [torch.device("cpu")], ncol, mode, ids)
    three = _stream(lw, sw, CPU3, ncol, mode, ids)
    assert [i for i, _ in three] == [i for i, _ in one] == ids
    lead = {"full": (ncol, NLAY + 1)}.get(mode, (ncol,))
    for (_, got), (_, ref) in zip(three, one):
        assert len(got) == len(ref) == (1 if mode == "toa-net" else 4)
        for g, r in zip(got, ref):
            assert g.shape == r.shape == lead and g.dtype == np.float64
            assert np.isfinite(g).all()
            np.testing.assert_array_equal(g, r)
    # The chunks differ (tsfc + 0.01 K (i mod 7)).
    assert not np.array_equal(three[0][1][0], three[1][1][0])


def _jax_stream(jlw, jsw, ncol, mode):
    """The JAX scale_bench's stream (its chunks and step) over three
    virtual CPU devices, at float64."""
    mesh = jmesh.make_column_mesh(jax.devices()[:3])
    assert mesh.devices.size == 3
    lw = jscale.place_pytree(jlw, mesh, -1)
    sw = jscale.place_pytree(jsw, mesh, -1)

    @jax.jit
    def step(lw_m, sw_m, plev, tlay, tlev, tsfc, emis, alb, tsi, sza, concs):
        flw, fsw = jax_lw_sw_fluxes(lw_m, sw_m, plev, tlay, tlev, tsfc, emis,
                                    concs, alb, tsi, sza, n_gauss_angles=1)
        if mode == "full":
            return (flw.flux_up, flw.flux_dn, fsw.flux_up, fsw.flux_dn)
        if mode == "boundary":
            return (flw.flux_up[:, 0], flw.flux_dn[:, -1],
                    fsw.flux_up[:, 0], fsw.flux_dn[:, -1])
        return (fsw.flux_dn[:, 0] - fsw.flux_up[:, 0] - flw.flux_up[:, 0],)

    base = example_flux_batch(ncol, NLAY, np.float64)
    concs = JaxGasConcs.create([
        (n, v.numpy()) for n, v in zip(base["concs"].names,
                                       base["concs"].values)])
    batch = jscale.place_pytree(
        (base["plev"], base["tlay"], base["tlev"], base["tsfc"], base["emis"],
         base["alb"], base["tsi"], base["sza"], concs), mesh, ncol)
    model_ids = {id(x) for x in jax.tree_util.tree_leaves((lw, sw))}

    def chunk(i):
        tsfc = base["tsfc"] + np.float64(0.01) * np.float64(i % 7)
        return (lw, sw, batch[0], batch[1], batch[2], tsfc, *batch[4:])

    seen = []
    jscale.run_weak_scaling(
        step, chunk, N_CHUNKS, ncol, mesh=mesh, warmup=1,
        consume=lambda host, i: seen.append(
            (i, [np.asarray(a) for a in host])),
        batch_leaf=lambda x: (id(x) not in model_ids
                              and getattr(x, "ndim", 0) >= 1
                              and x.shape[0] == ncol))
    return seen


@pytest.mark.parametrize("mode", MODES)
def test_sharded_stream_matches_the_jax_sharded_stream(ckd_paths, mode):
    ncol = 51
    jlw = jax_load(ckd_paths["lw"], dtype=np.float64)
    jsw = jax_load(ckd_paths["sw"], dtype=np.float64)
    ref = _jax_stream(jlw, jsw, ncol, mode)
    got = _stream(ckd_from_jax(jlw), ckd_from_jax(jsw), CPU3, ncol, mode)
    assert [i for i, _ in got] == [i for i, _ in ref] == list(range(N_CHUNKS))
    for (_, g), (_, r) in zip(got, ref):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)


def test_a_chunk_moves_no_leaf_but_tsfc(models64):
    lw, sw = models64
    ncol = 50
    chunk = scale_bench.resident_chunks(
        lw, sw, example_flux_batch(ncol, NLAY, np.float64), CPU3, ncol)
    first, later = chunk(1), chunk(4)
    assert isinstance(first, tmesh.ColumnShards)
    assert first.offsets == later.offsets == (0, 17, 34)
    for a, b in zip(first.trees, later.trees):
        leaves = list(zip(a[:5] + a[6:10], b[:5] + b[6:10]))
        leaves += list(zip(a[10].values, b[10].values))
        assert all(x is y for x, y in leaves)
        assert a[0] is lw and a[1] is sw
        assert a[2].shape == (17, NLAY + 1)
        assert a[5] is not b[5]
        np.testing.assert_allclose((b[5] - a[5]).numpy(), 0.03, rtol=1e-9)
    # The last piece repeats column 49 once (padding).
    tlay = first.trees[2][3]
    assert torch.equal(tlay[-2:], tlay[-1:].expand(2, -1))


def _pieces(ncol, n, offsets_order):
    """Outputs of n pieces of a ncol-column batch, listed in the order of
    ``offsets_order`` (piece indices), as a ColumnShards: leaf 0 holds the
    column index (padding rows -1), leaf 1 its square by row."""
    split = tmesh.split_columns((torch.arange(ncol, dtype=torch.float64),),
                                [torch.device("cpu")] * n, ncol)
    rows = []
    for d in offsets_order:
        lo, hi = split.span(d)
        col = torch.full((split.per,), -1.0, dtype=torch.float64)
        col[:hi - lo] = split.trees[d][0][:hi - lo]
        rows.append((col, (col ** 2)[:, None].expand(-1, 2).clone()))
    return tmesh.ColumnShards(
        trees=tuple(rows), devices=split.devices, ncol=ncol,
        offsets=tuple(split.offsets[d] for d in offsets_order))


@pytest.mark.parametrize("ncol,n", [(50, 3), (51, 3), (1, 3), (7, 4)])
def test_host_view_is_in_column_order_without_padding(ncol, n):
    split = tmesh.split_columns((np.zeros(ncol),), [torch.device("cpu")] * n,
                                ncol)
    per = tmesh.pad_columns(ncol, n) // n
    assert split.per == per
    assert split.offsets == tuple(d * per for d in range(n))
    assert [split.span(d) for d in range(n)] == [
        (d * per, max(d * per, min((d + 1) * per, ncol))) for d in range(n)]
    want = np.arange(ncol, dtype=np.float64)
    for order in (list(range(n)), list(reversed(range(n)))):
        outs = _pieces(ncol, n, order)
        host, events = _PinnedRing(3).fetch(outs, 0)
        assert events == []
        np.testing.assert_array_equal(host[0].numpy(), want)
        np.testing.assert_array_equal(host[1].numpy(),
                                      np.stack([want ** 2] * 2, axis=1))
        seen = []
        stream_chunks(lambda o: o, [((outs,), 0), ((outs,), 1)],
                      consume=lambda h, i: seen.append((i, h[0].copy())))
        assert [i for i, _ in seen] == [0, 1]
        for _, col in seen:
            np.testing.assert_array_equal(col, want)
        joined = tmesh.join_shards(outs)
        np.testing.assert_array_equal(joined[0].numpy(), want)


def test_map_shards_leaves_outputs_on_their_pieces():
    x = torch.arange(10.0)
    shards = tmesh.split_columns((x,), CPU3, 10)
    out = tmesh.map_shards(lambda a: (a * 2, a[:, None] + 1), shards)
    assert isinstance(out, tmesh.ColumnShards)
    assert (out.devices, out.ncol, out.offsets) == (shards.devices, 10,
                                                    (0, 4, 8))
    assert [t[0].shape for t in out.trees] == [(4,)] * 3
    np.testing.assert_array_equal(out.trees[2][0].numpy(), [16, 18, 18, 18])
    whole = tmesh.call_shards(lambda a: (a * 2, a[:, None] + 1), shards)
    assert torch.equal(whole[0], x * 2) and whole[1].shape == (10, 1)
