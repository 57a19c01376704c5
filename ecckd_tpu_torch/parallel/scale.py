"""Weak-scaling harness: chunked million-column runs with output overlap
(counterpart of ``ecckd_tpu.parallel.scale``).

Scale the RFMIP workload to ~1M replicated columns, split over the local
devices, and stream the broadband flux outputs back to the host
*overlapped* with the next chunk's compute.

Over several cards the stream runs as the JAX package's sharded one:
the inputs are placed over the cards once and stay there (place_pytree,
a ``mesh.ColumnShards``), each chunk is built from them on every card,
``step`` runs on every card's piece, and each card's outputs go to the
host over that card's own link.  Nothing passes through the first card.

How the overlap works on a card (a CUDA call returns before it runs):

  for each chunk i:
    1. build chunk i's inputs          (on the cards, from resident ones)
    2. step(*args) on every piece      (queued on each card's current
                                        stream)
    3. on each card a copy stream waits on the current stream and copies
       that card's outputs into its rows of one pinned host buffer per
       output (non_blocking); ``record_stream`` keeps the caching
       allocator from handing the device outputs to a later chunk before
       the copy has run; an event per card marks its copies' end
    4. drain chunk i-depth             (wait on its events only, then
       ``consume`` while the cards compute chunks i-depth+1 .. i)

The pinned buffers are a ring of depth + 1 slots: chunk i's slot is
reused by chunk i + depth + 1, which is issued only after chunk i's
``consume`` has returned.  The host never waits on in-flight compute.
On the CPU the step's outputs are the host outputs (pieces joined in
column order) and the same loop runs without copies.

What the host does is counted and, while a profiler records, named.
``stream_chunks`` returns four host-clock counters summed over its
chunks (``dispatch_s``, ``d2h_issue_s``, ``drain_wait_s``,
``consume_s``) and ``wall_s``.  While a ``torch.profiler`` records, the
issue of each chunk is spanned per card (utils/profiling.py, on the
clock of the trace's CUDA activity): ``stream.dispatch`` around ``step``
(on several cards holding a ``shards.card<i>`` span per piece, from
``mesh.map_shards``, and each piece's ``capture.call``), and a
``stream.fetch.card<i>`` span around each card's queued copies (``i``
its CUDA index).  The wait on the copies and ``consume`` are timed by
their counters alone.  Spans exist only while a profiler records;
otherwise no range is entered.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ecckd_tpu_torch.parallel import mesh as pmesh
from ecckd_tpu_torch.utils import profiling
from ecckd_tpu_torch.utils.tree import tree_leaves, tree_map


def place_pytree(tree, mesh: Optional[Sequence[torch.device]], ncol: int,
                 batch_leaf=None):
    """Place a tree of arguments: with one device (``mesh`` as from
    mesh.make_column_mesh) every leaf goes to it; with several, the
    leaves with a leading ``ncol`` axis are split over them and the rest
    replicated, into resident pieces (a ``mesh.ColumnShards``; pieces
    already placed over ``mesh`` are returned as they are).  No mesh:
    numpy leaves become CPU tensors and tensors stay where they are.
    Pass ``batch_leaf`` (leaf -> bool) to mark batch leaves explicitly
    when a replicated leaf's leading extent could coincide with
    ``ncol``."""
    if not mesh:
        return tree_map(lambda x: torch.as_tensor(x)
                        if isinstance(x, np.ndarray) else x, tree)
    devices = tuple(torch.device(d) for d in mesh)
    if isinstance(tree, pmesh.ColumnShards):
        if tree.devices != devices:
            raise ValueError(f"place_pytree: pieces on {tree.devices}, "
                             f"not on the mesh {devices}")
        return tree
    if len(devices) == 1:
        return tree_map(lambda x: pmesh.place_leaf(x, devices[0]), tree)
    return pmesh.split_columns(tree, devices, ncol, batch_leaf=batch_leaf)


def call_placed(fn: Callable, placed):
    """``fn`` on arguments from place_pytree: one call, or one per device
    with each output left on its device (mesh.map_shards, a
    ``ColumnShards`` with the pieces' column offsets).  The stream's
    step, and a chunk builder that changes the resident pieces on their
    devices."""
    if isinstance(placed, pmesh.ColumnShards):
        return pmesh.map_shards(fn, placed)
    return fn(*placed)


def _host_view(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else x


def _is_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_cuda


class _PinnedRing:
    """``size`` sets of pinned host buffers, one set per chunk in flight,
    and one copy stream per device."""

    def __init__(self, size: int):
        self.slots = [dict() for _ in range(size)]
        self.streams = {}

    def fetch(self, outs, n: int):
        """Queue the D2H copy of chunk ``n``'s CUDA outputs into its slot:
        one pinned buffer per output leaf, which ends up holding the
        whole chunk in column order without padding.  Each device's
        outputs (a ``ColumnShards``' pieces: their rows ``span``) are
        copied on that device's copy stream, after its current stream's
        work, in one ``stream.fetch.card<i>`` span per device.  Returns
        (host tree, one event per device that marks its copies' end)."""
        shards = outs if isinstance(outs, pmesh.ColumnShards) else None
        first = next((x for x in tree_leaves(
            shards.trees if shards else outs) if _is_card(x)), None)
        if first is None:
            return (pmesh.join_shards(shards) if shards else outs), []
        parts = ([(t, shards.span(d), shards.devices[d])
                  for d, t in enumerate(shards.trees)]
                 if shards else [(outs, None, first.device)])
        slot = self.slots[n % len(self.slots)]
        keys = itertools.count()

        def buffer(x):
            if not _is_card(x):
                return x
            k = next(keys)
            shape = (shards.ncol, *x.shape[1:]) if shards else x.shape
            if k not in slot or slot[k].shape != shape \
                    or slot[k].dtype != x.dtype:
                # Every slot at once: the ring is allocated in the first
                # chunk, not inside a timed pass.
                for s in self.slots:
                    s[k] = torch.empty(shape, dtype=x.dtype,
                                       pin_memory=True)
            return slot[k]

        host = tree_map(buffer, parts[0][0])
        used = {}       # device -> its copy stream, after a wait

        def stream(device):
            if device not in used:
                if device not in self.streams:
                    self.streams[device] = torch.cuda.Stream(device)
                used[device] = self.streams[device]
                used[device].wait_stream(torch.cuda.current_stream(device))
            return used[device]

        def queue(tree, rows):
            for dst, x in zip(tree_leaves(host), tree_leaves(tree)):
                if not _is_card(x):
                    continue
                if rows is not None:
                    lo, hi = rows
                    if hi == lo:
                        continue            # a piece of padding only
                    dst, x = dst[lo:hi], x[:hi - lo]
                s = stream(x.device)
                with torch.cuda.device(x.device), torch.cuda.stream(s):
                    dst.copy_(x, non_blocking=True)
                x.record_stream(s)

        run = profiling.steps()
        for tree, rows, device in parts:
            run("stream.fetch", queue, tree, rows, card=device)
        events = []
        for s in used.values():
            events.append(torch.cuda.Event())
            events[-1].record(s)
        return host, events


def stream_chunks(step: Callable, chunks: Iterable[Tuple[tuple, object]],
                  consume: Optional[Callable] = None,
                  depth: int = 2) -> dict:
    """Run ``step(*args)`` over a stream of placed input chunks with device
    compute overlapped against host-side output consumption.

    Args:
      step: returns a tree of tensors (the chunk's outputs).
      chunks: iterable of ``(args, meta)``; ``args`` already placed (see
        place_pytree).
      consume: ``consume(host_outputs, meta)`` called for every chunk,
        ``depth`` chunks behind the device (the overlap window); order is
        preserved.  ``host_outputs`` is the output tree as numpy arrays;
        on a card they are views of pinned buffers that a later chunk
        reuses once ``consume`` has returned, so a consumer that keeps
        them copies them.  None = outputs are fetched and dropped.
      depth: chunks in flight behind the drain point.  depth=2 keeps the
        card busy (step i queued, step i-1 running, copy i-2 in transit)
        while the host waits on chunk i-2's copy.

    Returns timing metrics: total wall seconds plus a per-phase host
    budget: dispatch_s (inside the ``step`` calls: host prep and kernel
    launches), d2h_issue_s (queueing the copies), drain_wait_s (waiting
    for a chunk's copy to end) and consume_s (host-side writes), so a
    below-compute streaming rate can be attributed to a pipeline phase.
    While a profiler records, the issue is also spanned (the module
    docstring)."""
    t0 = time.perf_counter()
    dispatch_s = d2h_issue_s = drain_wait_s = consume_s = 0.0
    n_chunks = 0
    ring = _PinnedRing(max(depth, 0) + 1)
    inflight: list = []  # (host outputs, copy events, meta), oldest first
    run = profiling.steps()

    def drain(host, events, meta):
        nonlocal drain_wait_s, consume_s
        tw = time.perf_counter()
        for event in events:
            event.synchronize()
        tc = time.perf_counter()
        drain_wait_s += tc - tw
        if consume is not None:
            consume(tree_map(_host_view, host), meta)
        consume_s += time.perf_counter() - tc

    for args, meta in chunks:
        td = time.perf_counter()
        outs = run("stream.dispatch", step, *args)
        te = time.perf_counter()
        dispatch_s += te - td
        host, events = ring.fetch(outs, n_chunks)
        del outs
        d2h_issue_s += time.perf_counter() - te
        inflight.append((host, events, meta))
        if len(inflight) > max(depth, 0):
            drain(*inflight.pop(0))
        n_chunks += 1
    while inflight:
        drain(*inflight.pop(0))
    return {"wall_s": time.perf_counter() - t0,
            "dispatch_s": dispatch_s, "d2h_issue_s": d2h_issue_s,
            "drain_wait_s": drain_wait_s,
            "consume_s": consume_s, "n_chunks": n_chunks}


def run_weak_scaling(step: Callable, chunk_builder: Callable[[int], tuple],
                     n_chunks: int, chunk_cols: int,
                     mesh: Optional[Sequence[torch.device]] = None,
                     consume: Optional[Callable] = None,
                     warmup: int = 1,
                     chunk_ids: Optional[Sequence] = None,
                     depth: int = 2, batch_leaf=None) -> dict:
    """Chunked weak-scaling run.  Every chunk's output reaches the
    ``consume`` sink exactly once, in order (the invariant the restart
    journal depends on); best-of-N measurement passes belong in the
    caller (cli/scale_bench.py interleaves them with its compute
    reference).

    Args:
      step: flux step taking the chunk args.
      chunk_builder: ``i -> args`` for chunk i: a host or device tuple
        (leading column axis = chunk_cols on the batch leaves), which is
        placed over ``mesh``, or arguments already placed there (the
        resident pieces of place_pytree, changed on their devices with
        call_placed), which are used as they are.
      n_chunks: chunks to stream (total columns = n_chunks * chunk_cols).
      mesh: optional list of devices to place (one) or split (several)
        each chunk over; see place_pytree.  Over several devices ``step``
        runs on every piece, and ``consume`` sees the whole chunk.
      consume: optional host output sink (overlapped; see stream_chunks).
      warmup: untimed pre-run chunks (kernel build, caches, pinned ring).
      chunk_ids: explicit chunk ids to process (restart-at-chunk: pass the
        not-yet-completed subset; defaults to range(n_chunks)).
      depth: chunks in flight behind the drain point (see stream_chunks).
      batch_leaf: optional leaf -> bool forwarded to place_pytree, for
        chunk args holding replicated leaves whose leading extent could
        coincide with chunk_cols.

    Returns metrics incl. columns/s and columns/s/device.
    """
    n_dev = len(mesh) if mesh else 1
    ids = list(range(n_chunks)) if chunk_ids is None else list(chunk_ids)

    def placed(i):
        return (place_pytree(chunk_builder(i), mesh, chunk_cols,
                             batch_leaf=batch_leaf),)

    run = lambda p: call_placed(step, p)
    if warmup and ids:
        stream_chunks(run, ((placed(ids[i % len(ids)]), None)
                            for i in range(warmup)), depth=depth)
    m = stream_chunks(run, ((placed(i), i) for i in ids),
                      consume=consume, depth=depth)
    total_cols = len(ids) * chunk_cols
    cols_per_sec = total_cols / m["wall_s"]
    return {**m, "total_columns": total_cols, "n_devices": n_dev,
            "columns_per_sec": cols_per_sec,
            "columns_per_sec_per_device": cols_per_sec / n_dev,
            "host_consume_fraction": m["consume_s"] / m["wall_s"]}
