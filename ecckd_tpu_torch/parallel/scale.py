"""Weak-scaling harness: chunked million-column runs with output overlap
(counterpart of ``ecckd_tpu.parallel.scale``).

Scale the RFMIP workload to ~1M replicated columns, split over the local
devices, and stream the broadband flux outputs back to the host
*overlapped* with the next chunk's compute.

How the overlap works on a card (a CUDA call returns before it runs):

  for each chunk i:
    1. place chunk i's inputs          (H2D of what changed)
    2. step(*args)                     (queued on the current stream)
    3. a copy stream waits on the current stream and copies every output
       into pinned host buffers (non_blocking); ``record_stream`` keeps
       the caching allocator from handing the device outputs to a later
       chunk before the copy has run; an event marks the copy's end
    4. drain chunk i-depth             (wait on its event only, then
       ``consume`` while the card computes chunks i-depth+1 .. i)

The pinned buffers are a ring of depth + 1 slots: chunk i's slot is
reused by chunk i + depth + 1, which is issued only after chunk i's
``consume`` has returned.  The host never waits on in-flight compute.
On the CPU the step's outputs are the host outputs and the same loop
runs without copies.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ecckd_tpu_torch.parallel import mesh as pmesh
from ecckd_tpu_torch.utils.tree import tree_leaves, tree_map


def place_pytree(tree, mesh: Optional[Sequence[torch.device]], ncol: int,
                 batch_leaf=None):
    """Place a tree of arguments: with one device (``mesh`` as from
    mesh.make_column_mesh) every leaf goes to it; with several, the
    leaves with a leading ``ncol`` axis are split over them and the rest
    replicated (a ``mesh.ColumnShards``).  No mesh: numpy leaves become
    CPU tensors and tensors stay where they are.  Pass ``batch_leaf``
    (leaf -> bool) to mark batch leaves explicitly when a replicated
    leaf's leading extent could coincide with ``ncol``."""
    if not mesh:
        return tree_map(lambda x: torch.as_tensor(x)
                        if isinstance(x, np.ndarray) else x, tree)
    if len(mesh) == 1:
        device = torch.device(mesh[0])
        return tree_map(lambda x: pmesh.place_leaf(x, device), tree)
    return pmesh.split_columns(tree, mesh, ncol, batch_leaf=batch_leaf)


def call_placed(step: Callable, placed):
    """``step`` on arguments from place_pytree: one call, or one per
    device with the outputs joined (mesh.call_shards)."""
    if isinstance(placed, pmesh.ColumnShards):
        return pmesh.call_shards(step, placed)
    return step(*placed)


def _host_view(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else x


class _PinnedRing:
    """``size`` sets of pinned host buffers, one set per chunk in flight,
    and one copy stream per device."""

    def __init__(self, size: int):
        self.slots = [dict() for _ in range(size)]
        self.streams = {}

    def fetch(self, outs, n: int):
        """Queue the D2H copy of chunk ``n``'s CUDA outputs into its slot.
        Returns (host tree, events that mark the copies' end)."""
        devices = {x.device for x in tree_leaves(outs)
                   if isinstance(x, torch.Tensor) and x.is_cuda}
        if not devices:
            return outs, []
        for device in devices:
            if device not in self.streams:
                self.streams[device] = torch.cuda.Stream(device)
            self.streams[device].wait_stream(
                torch.cuda.current_stream(device))
        slot = self.slots[n % len(self.slots)]
        keys = itertools.count()

        def copy(x):
            if not (isinstance(x, torch.Tensor) and x.is_cuda):
                return x
            k = next(keys)
            if k not in slot or slot[k].shape != x.shape \
                    or slot[k].dtype != x.dtype:
                # Every slot at once: the ring is allocated in the first
                # chunk, not inside a timed pass.
                for s in self.slots:
                    s[k] = torch.empty(x.shape, dtype=x.dtype,
                                       pin_memory=True)
            stream = self.streams[x.device]
            with torch.cuda.stream(stream):
                slot[k].copy_(x, non_blocking=True)
            x.record_stream(stream)
            return slot[k]

        host = tree_map(copy, outs)
        events = []
        for device in devices:
            events.append(torch.cuda.Event())
            events[-1].record(self.streams[device])
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
    """
    t0 = time.perf_counter()
    dispatch_s = d2h_issue_s = drain_wait_s = consume_s = 0.0
    n_chunks = 0
    ring = _PinnedRing(max(depth, 0) + 1)
    inflight: list = []  # (host outputs, copy events, meta), oldest first

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
        outs = step(*args)
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
      chunk_builder: ``i -> args tuple`` for chunk i (leading column axis
        = chunk_cols on the batch leaves).
      n_chunks: chunks to stream (total columns = n_chunks * chunk_cols).
      mesh: optional list of devices to place (one) or split (several)
        each chunk over; see place_pytree.
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
