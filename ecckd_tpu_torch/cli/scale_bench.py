"""Weak-scaling benchmark driver: ~1M-column RFMIP workload, chunked
(counterpart of ``ecckd_tpu.cli.scale_bench``).

Replicate RFMIP-shaped columns to ``--columns`` total and stream them
through the combined LW+SW flux solve in ``--chunk``-column chunks, split
over the local cards, with host-side output writes overlapped against
device compute (parallel/scale.py).  The base chunk is placed over the
cards once; each card builds every chunk from its resident piece, runs
the step captured per card (utils/capture.jit, the JAX step's
``@jax.jit``), and copies its outputs to the host itself.  On a card at
f32 each chunk is one launch of the merged kernel (csrc/lwsw.cu) per
card.  Prints one JSON metrics line.

Example:
    python -m ecckd_tpu_torch.cli.scale_bench --columns 1048576 --chunk 65536
    python -m ecckd_tpu_torch.cli.scale_bench --columns 65536 --out-dir flx
    python -m ecckd_tpu_torch.cli.scale_bench --device cpu --columns 64 \\
        --chunk 16 --nlay 8 --lw-file lw.nc --sw-file sw.nc
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

# The shipped ecCKD 1.2 files (not in the repository; pass their paths).
LW_FILE = "ecckd-1.2_lw_ckd-definition_climate_fsck-tol0.0161.nc"
SW_FILE = "ecckd-1.2_sw_ckd-definition_climate_wide-tol0.05.nc"

REF_ITERS = 8
"""Batched steps per compute-reference epoch (one barrier at the end)."""


def make_step(outputs_mode: str) -> Callable:
    """The benchmark's step on one chunk: the merged LW+SW solve, reduced
    to the streamed outputs of ``outputs_mode`` (--outputs).  The step
    runs eagerly; ``main`` streams utils/capture.jit of it."""
    from ecckd_tpu_torch.pipeline import lw_sw_fluxes

    def step(lw_m, sw_m, plev, tlay, tlev, tsfc, emis, alb, tsi, sza, concs):
        # The merged kernel on a card (one launch per chunk); the plain
        # torch path elsewhere.
        flw, fsw = lw_sw_fluxes(lw_m, sw_m, plev, tlay, tlev, tsfc, emis,
                                concs, alb, tsi, sza, n_gauss_angles=1,
                                backend="auto")
        if outputs_mode == "full":
            return (flw.flux_up, flw.flux_dn, fsw.flux_up, fsw.flux_dn)
        if outputs_mode == "boundary":
            # OLR, LW surface heating, reflected SW, SW surface insolation.
            return (flw.flux_up[:, 0], flw.flux_dn[:, -1],
                    fsw.flux_up[:, 0], fsw.flux_dn[:, -1])
        # toa-net: net downward radiation at TOA (the climate diagnostic).
        return (fsw.flux_dn[:, 0] - fsw.flux_up[:, 0] - flw.flux_up[:, 0],)

    return step


def resident_chunks(lw, sw, base: dict, mesh, ncol: int) -> Callable:
    """The stream's inputs: ``base`` (example_flux_batch) and the models
    placed over ``mesh`` once (parallel/scale.place_pytree: one tree per
    card when there are several), and ``chunk(i)``, chunk i's arguments
    built from the resident ones where they lie: every card adds 0.01 K
    times (i mod 7) to its own tsfc piece (so chunks are not
    byte-identical, which guards against result caching) and nothing
    crosses cards.  The models are whole leaves, so the column split
    never reaches their tables, whatever ``ncol`` is."""
    from ecckd_tpu_torch.parallel.scale import call_placed, place_pytree
    placed = place_pytree(
        (lw, sw, base["plev"], base["tlay"], base["tlev"], base["tsfc"],
         base["emis"], base["alb"], base["tsi"], base["sza"],
         base["concs"]), mesh, ncol)
    dtype = base["tsfc"].dtype.type

    def chunk(i):
        delta = dtype(0.01) * dtype(i % 7)
        return call_placed(lambda *a: (*a[:5], a[5] + delta, *a[6:]),
                           placed)

    return chunk


def main(argv=None, consume: Optional[Callable] = None) -> int:
    """Run the benchmark.  ``consume(host_outputs, chunk_id)``, where
    given, sees every streamed chunk of every measured pass after the
    ``--out-dir`` writes (a hook for checks; see stream_chunks for the
    lifetime of ``host_outputs``)."""
    p = argparse.ArgumentParser(
        prog="scale_bench",
        description="Chunked weak-scaling LW+SW flux benchmark (PyTorch/CUDA)")
    p.add_argument("--columns", type=int, default=1_048_576,
                   help="Total columns to process")
    p.add_argument("--chunk", type=int, default=65_536,
                   help="Columns per streamed chunk")
    p.add_argument("--nlay", type=int, default=60)
    p.add_argument("--lw-file", default=LW_FILE)
    p.add_argument("--sw-file", default=SW_FILE)
    p.add_argument("--out-dir", default=None,
                   help="If set, write rlu/rld/rsu/rsd .npy memmaps there "
                        "(host writes overlap device compute)")
    p.add_argument("--no-shard", action="store_true",
                   help="Run every chunk on one device instead of splitting "
                        "it over the local cards")
    p.add_argument("--outputs", default="full",
                   choices=("full", "boundary", "toa-net"),
                   help="Streamed outputs per column: 'full' = all four "
                        "broadband flux profiles (976 B/col at 60 layers), "
                        "'boundary' = OLR / surface-down per band (16 "
                        "B/col), 'toa-net' = net TOA radiation (4 B/col).  "
                        "The reduced modes measure the overlap where "
                        "compute, not the D2H copy, is the bottleneck; the "
                        "machinery under test (queued steps, the copy "
                        "stream, consumption depth chunks behind) is the "
                        "same in every mode")
    p.add_argument("--depth", type=int, default=2,
                   help="Chunks in flight behind the host drain point "
                        "(parallel/scale.py stream_chunks); 1 gives the "
                        "single-deep pipeline for A/B")
    p.add_argument("--resume", action="store_true",
                   help="Restart-at-chunk: skip chunks recorded as done in "
                        "<out-dir>/progress.json (requires --out-dir)")
    p.add_argument("--repeats", type=int, default=None,
                   help="Best-of-N streamed passes.  Default: 4 for pure "
                        "measurement runs, forced to 1 with --out-dir "
                        "(real writes must stream each chunk once)")
    p.add_argument("--device", default="cuda",
                   help="Torch device (default cuda; raises if CUDA is "
                        "absent; cpu runs the plain torch path)")
    args = p.parse_args(argv)
    if args.resume and not args.out_dir:
        p.error("--resume requires --out-dir")
    if args.columns % args.chunk:
        p.error("--columns must be divisible by --chunk")
    if args.out_dir and args.repeats is not None and args.repeats > 1:
        p.error("--repeats > 1 conflicts with --out-dir: journaled "
                "writes must stream each chunk exactly once")

    from ecckd_tpu_torch.cli.common import torch_device
    from ecckd_tpu_torch.io.synthetic import example_flux_batch
    from ecckd_tpu_torch.models.loader import load_ckd_model
    from ecckd_tpu_torch.parallel import mesh as pmesh
    from ecckd_tpu_torch.parallel.scale import call_placed, run_weak_scaling
    from ecckd_tpu_torch.utils import capture

    device = torch_device(args.device)
    mesh = [device]
    if device.type == "cuda" and device.index is None:
        # Every local card, or the current one with --no-shard.
        mesh = ([torch.device("cuda", torch.cuda.current_device())]
                if args.no_shard else pmesh.make_column_mesh())
    home = mesh[0]

    dtype = np.float32
    lw = load_ckd_model(args.lw_file, dtype=torch.float32, device=home)
    sw = load_ckd_model(args.sw_file, dtype=torch.float32, device=home)
    outputs_mode = args.outputs

    # One graph per card, captured at the second call on its pieces.
    step = capture.jit(make_step(outputs_mode))
    # Weak-scaling input: one RFMIP-shaped base chunk, placed ONCE over
    # the cards; per chunk each card perturbs its surface temperature.
    # This models the production streaming pattern where each card
    # receives only its chunk's deltas while it computes.
    chunk_builder = resident_chunks(
        lw, sw, example_flux_batch(args.chunk, args.nlay, dtype), mesh,
        args.chunk)

    n_chunks = args.columns // args.chunk
    sinks = [consume] if consume is not None else []
    done: set = set()
    maps = {}
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        nlev = args.nlay + 1
        # Checkpoint/restart: completed chunk ids are journaled so an
        # interrupted million-column run resumes at the first unfinished
        # chunk instead of recomputing everything.
        progress_path = os.path.join(args.out_dir, "progress.json")
        run_cfg = {"columns": args.columns, "chunk": args.chunk,
                   "nlay": args.nlay, "outputs": outputs_mode}
        if args.resume and os.path.exists(progress_path):
            with open(progress_path) as f:
                journal = json.load(f)
            done = set(journal.get("done", []))
            # The reduced-output shapes don't encode nlay, so the memmap
            # shape check below cannot catch a wrong --nlay resume there;
            # the journaled run config is the fail-fast for every mode
            # (a resume must not mix fluxes from different grids or
            # chunkings into one artifact).
            prev_cfg = journal.get("config")
            if prev_cfg is not None and prev_cfg != run_cfg:
                p.error(f"--resume config mismatch: journal has {prev_cfg}"
                        f", this run is {run_cfg}")
            print(f"# resuming: {len(done)}/{n_chunks} chunks already done",
                  file=sys.stderr)
        elif os.path.exists(progress_path):
            # Fresh (non --resume) run: the memmaps are about to be
            # truncated, so a stale journal from a previous run must not
            # survive: a crash before the first write would otherwise let
            # a later --resume skip chunks whose rows were zeroed.
            os.remove(progress_path)
        mode = "r+" if (args.resume and done) else "w+"
        out_spec = {
            "full": (("rlu", "rld", "rsu", "rsd"), (args.columns, nlev)),
            "boundary": (("olr", "rlds", "rsut", "rsds"), (args.columns,)),
            "toa-net": (("toa_net",), (args.columns,)),
        }[outputs_mode]
        maps = {name: np.lib.format.open_memmap(
                    os.path.join(args.out_dir, f"{name}.npy"), mode=mode,
                    dtype=dtype, shape=out_spec[1])
                for name in out_spec[0]}
        for name, m in maps.items():
            # open_memmap(mode="r+") keeps the existing on-disk header: a
            # resume with different --columns/--nlay must fail fast, not
            # IndexError hours into the run (or silently keep stale rows).
            if m.shape != out_spec[1]:
                p.error(f"{name}.npy has shape {m.shape}; this run needs "
                        f"{out_spec[1]}: wrong --columns (or --nlay, in "
                        "full mode) for --resume")

        def write(host_outs, i):
            s = slice(i * args.chunk, (i + 1) * args.chunk)
            for name, arr in zip(out_spec[0], host_outs):
                maps[name][s] = arr
            done.add(int(i))
            with open(progress_path, "w") as f:
                json.dump({"done": sorted(done), "config": run_cfg}, f)

        sinks.insert(0, write)

    def sink(host_outs, i):
        for s in sinks:
            s(host_outs, i)

    pending = [i for i in range(n_chunks) if i not in done]

    # In-process COMPUTE reference: the same captured step on the same
    # resident chunk, on every card, REF_ITERS steps queued back to back
    # with one 4-byte fetch per card as the barrier, and no join and no
    # D2H of the outputs.  streamed / compute_ref is the overlap
    # efficiency, measured in the same process and interleaved with the
    # streamed passes.
    ref_args = chunk_builder(0)

    def _ref_step():
        """One 4-byte sum per card of the step's first output."""
        outs = call_placed(step, ref_args)
        pieces = (outs.trees if isinstance(outs, pmesh.ColumnShards)
                  else (outs,))
        return [o[0][..., 0].sum() if o[0].ndim > 1 else o[0].sum()
                for o in pieces]

    def barrier(sums):
        for s in sums:
            float(s)

    barrier(_ref_step())        # the eager warm-up
    barrier(_ref_step())        # the capture, on every card

    def ref_epoch() -> float:
        t0 = time.perf_counter()
        acc = _ref_step()
        for _ in range(REF_ITERS - 1):
            acc = [a + b for a, b in zip(acc, _ref_step())]
        barrier(acc)
        return (time.perf_counter() - t0) / REF_ITERS

    rounds = 1 if args.out_dir else \
        (4 if args.repeats is None else max(args.repeats, 1))
    # INTERLEAVED A/B rounds (ref epoch, then streamed pass), best-of
    # each: measuring all ref epochs before all streamed passes would let
    # a slow window under one and a fast one under the other push
    # overlap_efficiency past 1.0.  Each round re-streams every pending
    # chunk; the exactly-once write contract holds because rounds == 1
    # whenever --out-dir journaling is active.
    best_ref = 1e30
    metrics = None
    for k in range(rounds):
        best_ref = min(best_ref, ref_epoch())
        m = run_weak_scaling(step, chunk_builder, n_chunks, args.chunk,
                             mesh=mesh, consume=sink if sinks else None,
                             warmup=1 if k == 0 else 0,
                             chunk_ids=pending, depth=args.depth)
        if metrics is None or m["wall_s"] < metrics["wall_s"]:
            metrics = m
    compute_ref = args.chunk / best_ref
    metrics["streamed_repeats_best_of"] = rounds
    metrics["compute_ref_cols_per_sec"] = compute_ref
    metrics["overlap_efficiency"] = (metrics["columns_per_sec"]
                                     / compute_ref)
    for m in maps.values():
        m.flush()

    metrics = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in metrics.items()}
    print(json.dumps({"metric": "weak_scaling_lw+sw_throughput",
                      "unit": "columns/s", "outputs": outputs_mode,
                      "device": (torch.cuda.get_device_name(home)
                                 if home.type == "cuda" else "cpu"),
                      **metrics}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
