"""PyTorch port: the program's spans (utils/profiling.py) and the readers
of the benchmark's span metrics.

* With the profiler off, ``steps()`` runs each step bare and the hot
  paths (``capture.jit``'s call on a card, ``stream_chunks``,
  ``map_shards``) enter no profiler range: a stand-in for the range
  counts its uses.  With it on, nested spans appear in a CPU
  ``torch.profiler`` trace under their names, the inner one inside the
  outer one.
* ``capture.jit`` on a stood-in card (the CUDA calls stood in for, as in
  tests/test_torch_capture.py) records its spans in order, and keeps
  ``captures`` and ``replays`` true across a key change.  With its graph
  made to run the captured call again on replay (``graphed``), replayed
  calls return the eager result whichever tensors change, positional,
  in a ``GasConcs`` or keywords; the lookup's one pass lists the tensors
  in ``tree_leaves``' order; and with ``tree_leaves`` and ``tree_map``
  made to raise inside ``capture.key``, calls with the calls cell's
  argument types still replay.
* ``stream_chunks`` over ``map_shards`` on CPU pieces records the
  stream's spans in order, with one ``shards.card<i>`` per piece; on a
  card, a stream's trace holds ``stream.fetch.card0`` (marked ``cuda``).
  A span given a device is named by the device's CUDA index.
* Each reader under radbench/metrics/ that reads spans gives the right
  value on a hand-made traced sub-window, and None on one without its
  spans or without tracing.
"""
import contextlib
import functools
import json
import types

import numpy as np
import pytest
import torch

from ecckd_tpu_torch import pipeline
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.io.synthetic import (example_flux_batch,
                                          write_synthetic_ckd)
from ecckd_tpu_torch.models.loader import load_ckd_model
from ecckd_tpu_torch.parallel import mesh as tmesh
from ecckd_tpu_torch.parallel.scale import stream_chunks
from ecckd_tpu_torch.utils import capture, profiling
from ecckd_tpu_torch.utils.tree import tree_leaves
from radbench import run as bench_run
from radbench import trace as bench_trace


class Ranges:
    """A stand-in for the profiler range: each use logged by name."""

    def __init__(self):
        self.log = []

    def __call__(self, name):
        log = self.log

        class Range:
            def __enter__(self):
                log.append(("enter", name))

            def __exit__(self, *exc):
                log.append(("exit", name))
                return False

        return Range()

    def entered(self):
        return [name for what, name in self.log if what == "enter"]

    def open(self, name):
        """Whether a range named ``name`` is entered and not yet left."""
        depth = 0
        for what, n in self.log:
            if n == name:
                depth += 1 if what == "enter" else -1
        return depth > 0


@pytest.fixture
def ranges(monkeypatch):
    """The stand-in range; the profiler stays off."""
    r = Ranges()
    monkeypatch.setattr(profiling, "_RANGE", r)
    return r


@pytest.fixture
def spans_recording(monkeypatch, ranges):
    """The stand-in range, with ``spans_on`` reading true."""
    monkeypatch.setattr(profiling, "spans_on", lambda: True)
    return ranges


class Replays(list):
    """A stood-in card's replays, one item per ``graph.replay()``;
    ``capturing`` is the graph being captured, or None."""
    capturing = None


@pytest.fixture
def card(monkeypatch):
    """A stood-in card: every call with tensors is a card's, and the CUDA
    calls of a capture and a replay do nothing but count replays and run
    again the work ``graphed`` recorded in the graph."""
    replayed = Replays()

    class Graph:
        def __init__(self):
            self.work = []

        def replay(self):
            replayed.append(1)
            for work in self.work:
                work()

    class Capturing:
        def __init__(self, graph, stream=None, **kw):
            self.graph = graph

        def __enter__(self):
            replayed.capturing = self.graph
            return self

        def __exit__(self, *exc):
            replayed.capturing = None
            return False

    class Marker:
        def record(self, stream=None):
            pass

    class Stream:
        def wait_event(self, event):
            pass

    device = torch.device("cuda", 0)
    monkeypatch.setattr(capture, "_card", lambda fn, tensors, devices:
                        device if tensors else None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capturing)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "Event", Marker)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    return replayed


def double(x):
    return (x * 2.0,)


def stream_on_cpu_pieces(n_chunks=2):
    shards = tmesh.split_columns((torch.arange(8.0),),
                                 [torch.device("cpu")] * 2, 8)
    drained = []
    stream_chunks(lambda s: tmesh.map_shards(double, s),
                  (((shards,), i) for i in range(n_chunks)),
                  consume=lambda host, meta: drained.append(meta), depth=1)
    return drained


def test_steps_off_run_bare(ranges):
    assert not profiling.spans_on()
    run = profiling.steps()
    assert run is profiling.steps()
    assert run("x", lambda a, b: (a, b), 3, 4) == (3, 4)
    assert run("x", lambda a: a, 5, card=torch.device("cuda", 2)) == 5
    assert ranges.log == []


@pytest.mark.parametrize("path", ["capture", "stream", "map_shards"])
def test_hot_paths_enter_no_range_when_off(ranges, card, path):
    x = torch.ones(3)
    if path == "capture":
        jitted = capture.jit(double)
        for _ in range(3):
            jitted(x)
        assert (jitted.captures, jitted.replays) == (1, 2)
    elif path == "stream":
        assert stream_on_cpu_pieces() == [0, 1]
    else:
        shards = tmesh.split_columns((x,), [torch.device("cpu")] * 3, 3)
        assert torch.equal(tmesh.call_shards(double, shards)[0], x * 2.0)
    assert ranges.log == []


def test_nested_spans_in_a_cpu_trace(tmp_path):
    jitted = capture.jit(double)
    with profiling.trace(str(tmp_path)):
        assert profiling.spans_on()
        run = profiling.steps()
        run("outer", run, "inner", lambda: torch.ones(4).exp())
        jitted(torch.ones(4))
    assert not profiling.spans_on()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"}
    for name in ("outer", "inner", "capture.call", "capture.key"):
        assert name in events
        assert events[name]["cat"] in bench_trace.HOST_CATS
    for child, parent in (("inner", "outer"), ("capture.key", "capture.call"),
                          ("aten::exp", "inner")):
        c, p = events[child], events[parent]
        assert p["ts"] <= c["ts"] and \
            c["ts"] + c["dur"] <= p["ts"] + p["dur"]


def test_capture_spans_and_counters_on_a_stood_in_card(spans_recording,
                                                       card):
    jitted = capture.jit(double)
    x, y = torch.arange(3.0), torch.arange(4.0)
    for _ in range(3):
        out = jitted(x)
    assert torch.equal(out[0], x * 2.0)
    assert (len(jitted.entries), jitted.captures, jitted.replays) == (1, 1, 2)
    calls = [n for n in spans_recording.entered() if n != "capture.call"]
    replay = ["capture.copy_in", "capture.replay", "capture.copy_out"]
    assert calls == ["capture.key"] + (["capture.key"] + replay) * 2
    assert spans_recording.entered().count("capture.call") == 3
    # A span's children close before it does.
    assert spans_recording.log[:4] == [
        ("enter", "capture.call"), ("enter", "capture.key"),
        ("exit", "capture.key"), ("exit", "capture.call")]
    for _ in range(3):
        jitted(y)
    assert (len(jitted.entries), jitted.captures, jitted.replays) == (2, 2, 4)
    jitted(x)
    assert (jitted.captures, jitted.replays) == (2, 5)
    assert len(card) == 5


def graphed(fn, card):
    """``fn`` as the stood-in card's graph records it: a call made while a
    graph is captured is made again by each of its replays, on the same
    arguments (the static buffers), the outputs written in place, as a
    CUDA graph replays its kernels."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        if card.capturing is not None:
            def again():
                for o, n in zip(tree_leaves(out),
                                tree_leaves(fn(*args, **kwargs))):
                    o.copy_(n)
            card.capturing.work.append(again)
        return out
    return call


@pytest.fixture(scope="module")
def calls_models(tmp_path_factory):
    """The calls cell's two models, from synthetic ckd files on the CPU."""
    d = tmp_path_factory.mktemp("ckd_spans")
    models = []
    for kind in ("lw_fsck", "sw_wide"):
        path = str(d / f"{kind}.nc")
        write_synthetic_ckd(path, kind, seed=3)
        models.append(load_ckd_model(path, dtype=torch.float64))
    return tuple(models)


def calls_args(models, seed):
    """The calls cell's argument types (radbench/solve.py ``Program``): two
    models, eight tensors, a ``GasConcs`` and two ints, 4 x 5 columns on
    the CPU, every tensor's values (the gases' too) drawn from ``seed``."""
    b = example_flux_batch(4, 5, np.float64)
    g = torch.Generator().manual_seed(seed)

    def draw(x):
        x = torch.as_tensor(x)
        return x * (1.0 + 0.02 * torch.rand(x.shape, generator=g,
                                            dtype=x.dtype))
    t = {k: torch.as_tensor(b[k]) if k == "plev" else draw(b[k])
         for k in ("plev", "tlay", "tlev", "tsfc", "emis", "alb", "tsi",
                   "sza")}
    concs = GasConcs(values=tuple(draw(v) for v in b["concs"].values),
                     names=b["concs"].names)
    return ((*models, t["plev"], t["tlay"], t["tlev"], t["tsfc"], t["emis"],
             concs, t["alb"], t["tsi"], t["sza"]),
            dict(n_gauss_angles=1, column_chunk=65536))


def mixed(a, concs, b, *, shift, scale):
    """Each tensor weighed by a factor of its own, so a static buffer
    filled from another tensor of its shape shows in the outputs."""
    out = a + 2.0 * b + 3.0 * scale + 5.0 * shift
    for i, v in enumerate(concs.values):
        out = out + (7.0 + i) * v
    return out, a * b


def mixed_args(models, seed):
    """Tensors of one shape passed positionally, in a ``GasConcs`` and as
    keywords, which come in either order."""
    g = torch.Generator().manual_seed(seed)
    draw = lambda: torch.rand(3, 4, generator=g, dtype=torch.float64)
    concs = GasConcs(values=(draw(), draw(), draw()),
                     names=("h2o", "o3", "co2"))
    kwargs = (dict(shift=draw(), scale=draw()) if seed % 2
              else dict(scale=draw(), shift=draw()))
    return (draw(), concs, draw()), kwargs


CALLS = {"mixed": (mixed, mixed_args),
         "calls cell": (pipeline.lw_sw_fluxes, calls_args)}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_replays_copy_each_tensor_into_its_own_buffer(card, calls_models,
                                                      case):
    """Replayed calls return the eager result when the values change in
    every tensor, wherever it is passed; and the one pass lists the
    tensors in the order the static buffers were built in, which is
    ``tree_leaves``' over the positional and the sorted keyword
    arguments."""
    fn, make = CALLS[case]
    jitted = capture.jit(graphed(fn, card))
    before = None
    for seed in range(4):
        args, kwargs = make(calls_models, seed)
        got = tree_leaves(jitted(*args, **kwargs))
        want = tree_leaves(fn(*args, **kwargs))
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert before is None or not torch.equal(got[0], before[0])
        before = got
        leaves = tree_leaves((args, dict(sorted(kwargs.items()))))
        former = [t for t in leaves if isinstance(t, torch.Tensor)]
        walked = capture._walk(fn, args, kwargs)[0]
        assert [id(t) for t in walked] == [id(t) for t in former]
    assert (len(jitted.entries), jitted.captures, jitted.replays) == (1, 1, 3)
    assert len(card) == 3


def test_lookup_walks_no_tree(spans_recording, card, calls_models,
                              monkeypatch):
    """``capture.key``'s lookup takes the calls cell's argument types
    (models, tensors, a ``GasConcs``, ints) by their type alone:
    ``tree_leaves`` and ``tree_map``, made to raise while the span is
    open, are never reached there, and replayed calls still return the
    eager result."""
    def refuse(name):
        real = getattr(capture, name)

        def tree(*args, **kwargs):
            if spans_recording.open("capture.key"):
                raise AssertionError(f"{name} in capture.key's lookup")
            return real(*args, **kwargs)
        return tree

    for name in ("tree_leaves", "tree_map"):
        monkeypatch.setattr(capture, name, refuse(name))
    jitted = capture.jit(graphed(pipeline.lw_sw_fluxes, card))
    for seed in range(4):
        args, kwargs = calls_args(calls_models, seed)
        got = tree_leaves(jitted(*args, **kwargs))
        want = tree_leaves(pipeline.lw_sw_fluxes(*args, **kwargs))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (jitted.captures, jitted.replays) == (1, 3)
    assert spans_recording.entered().count("capture.key") == 4


def test_stream_and_map_shards_spans_on_cpu_pieces(spans_recording):
    assert stream_on_cpu_pieces() == [0, 1]
    dispatch = ["stream.dispatch", "shards.card0", "shards.card0"]
    assert spans_recording.entered() == dispatch * 2
    run = profiling.steps()
    run("shards", lambda: None, card=torch.device("cuda", 3))
    run("stream.fetch", lambda: None, card=torch.device("cpu"))
    assert spans_recording.entered()[-2:] == ["shards.card3",
                                               "stream.fetch.card0"]


@pytest.mark.cuda
@pytest.mark.parametrize("pieces", [0, 2])
def test_stream_fetch_spans_on_a_card(tmp_path, pieces):
    """One tree, or ``pieces`` pieces of a ``ColumnShards`` all on card 0:
    a ``stream.fetch.card0`` span per piece and chunk, and the host
    outputs whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copies to pinned memory")
    x = torch.arange(64.0, device="cuda").reshape(16, 4)
    if pieces:
        args = (tmesh.split_columns((x,), [torch.device("cuda", 0)] * pieces,
                                    16),)
        step = lambda s: tmesh.map_shards(double, s)
    else:
        args, step = (x,), double
    got = []
    with profiling.trace(str(tmp_path)):
        stream_chunks(step, ((args, i) for i in range(3)),
                      consume=lambda host, meta: got.append(host[0].copy()),
                      depth=1)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]
    assert names.count("stream.fetch.card0") == 3 * max(pieces, 1)
    assert names.count("shards.card0") == 3 * pieces
    assert names.count("stream.dispatch") == 3
    for host in got:
        np.testing.assert_array_equal(host, (x * 2.0).cpu().numpy())


def ev(name, ts, dur, cat="cpu_op"):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


def calls_window():
    """Two calls in [0, 1000) us on card 0, and a span past the end."""
    host = []
    for start, parts in ((100, (50, 50, 60, 120)), (500, (40, 60, 50, 130))):
        t = start
        for name, dur in zip(("capture.key", "capture.copy_in",
                              "capture.replay", "capture.copy_out"), parts):
            host.append(ev(name, t, dur))
            t += dur
        host.append(ev("capture.call", start, 300))
    host.append(ev("capture.key", 1200, 500))
    device = {0: [ev("k", 210, 240, "kernel"), ev("k", 660, 240, "kernel")]}
    return bench_trace.Window(2, 0.0, 1000.0, device, host)


def stream_window():
    """One pass of two chunks on cards 0 and 1; the chunk builder's piece
    spans lie outside ``stream.dispatch``."""
    host = [ev("stream.dispatch", 0, 100), ev("stream.dispatch", 300, 100),
            ev("shards.card0", 10, 30), ev("shards.card1", 40, 50),
            ev("shards.card0", 310, 20), ev("shards.card1", 330, 60),
            ev("stream.fetch.card0", 110, 20),
            ev("stream.fetch.card1", 130, 40),
            ev("stream.fetch.card0", 410, 10),
            ev("stream.fetch.card1", 420, 30),
            ev("shards.card0", 200, 90), ev("shards.card1", 460, 500)]
    device = {0: [ev("k", 50, 400, "kernel")], 1: [ev("k", 60, 400, "kernel")]}
    return bench_trace.Window(1, 0.0, 600.0, device, host)


READERS = {
    # metric: (window, value in ms)
    "capture_key_ms.calls": (calls_window, (50 + 40) / 2e3),
    "capture_copy_ms.calls": (calls_window, (50 + 120 + 60 + 130) / 2e3),
    "capture_launch_ms.calls": (calls_window, (60 + 50) / 2e3),
    # Card 0 idle inside the calls: [100, 210) and [500, 660).
    "host_held_idle_ms.calls": (calls_window, (110 + 160) / 2e3),
    # Card 1: (50 + 60 + 40 + 30) us over 2 chunks; card 0 reads 40 us.
    "stream_card_issue_ms": (stream_window, 180 / 2e3),
}


def reader_run(window, devices):
    return types.SimpleNamespace(
        trace=window, devices=devices,
        cell={"params": {"n_chunks": 2}})


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader_value(metric):
    make, want = READERS[metric]
    devices = [torch.device("cuda", i) for i in range(2 if make is
                                                       stream_window else 1)]
    got = bench_run.reader(metric)(reader_run(make(), devices))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader_none_without_spans(metric):
    make, _ = READERS[metric]
    full = make()
    read = bench_run.reader(metric)
    devices = [torch.device("cuda", 0)]
    bare = bench_trace.Window(full.units, full.t0, full.t1,
                              full.device_events, [])
    assert read(reader_run(bare, devices)) is None
    assert read(reader_run(bench_trace.Window(0, 0.0, 1.0, {}, []),
                           devices)) is None
    assert read(reader_run(None, devices)) is None
    assert np.isfinite(read(reader_run(full, devices)))
