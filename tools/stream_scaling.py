#!/usr/bin/env python3
"""Time the port's stream (``ecckd_tpu_torch.cli.scale_bench``) of one or
more checkouts in turns, over every local card, and on one card.

Each run is its own process (``python -m ecckd_tpu_torch.cli.scale_bench``
with the checkout as working directory and ``PYTHONPATH``), so each
checkout builds and loads its own kernels.  For every cell (output mode x
chunk) the checkouts run in the order given, so two checkouts are
compared in turns within one machine, e.g. parent, change, change,
parent.  ``--one-card`` adds, per cell, one ``--no-shard`` run of each
distinct checkout at 65,536 columns per chunk.  ``--check`` first holds
this checkout's stream over every card against the same chunks on one
card, in this process (``check``).  The synthetic ckd files (lw_fsck and
sw_wide, seed 7, as chip_smoke.py writes them) are written once by this
checkout.

Usage (on a machine with one or more cards):
  python tools/stream_scaling.py --trees _archive/parent . . _archive/parent
      [--outputs full,toa-net] [--chunks 65536,262144] [--one-card]
      [--check] [--out chiprun_out/stream_scaling.json]

Every run streams 16 chunks of 60 layers (``CHUNKS`` x chunk columns),
as chip_smoke.py's 1,048,576 x 60 stream does at 65,536 per chunk.

Prints the cards (nvidia-smi's name and power limit), the check, one line
per run and one JSON line with all of it; writes the same JSON to
``--out``.  Exits non-zero when there is no card, the check fails or a
run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

CHUNKS, NLAY = 16, 60
KEYS = ("n_devices", "n_chunks", "columns_per_sec", "compute_ref_cols_per_sec",
        "overlap_efficiency", "wall_s", "dispatch_s", "d2h_issue_s",
        "drain_wait_s", "consume_s")


def cards() -> list:
    """nvidia-smi's name and power limit of every card, one per line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def run_stream(tree: str, argv: list, timeout: float) -> dict:
    """scale_bench in ``tree`` with ``argv``: its JSON line's KEYS."""
    tree = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run(
        [sys.executable, "-m", "ecckd_tpu_torch.cli.scale_bench", *argv],
        cwd=tree, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"scale_bench in {tree} {' '.join(argv)} exited "
                           f"{proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: line.get(k) for k in KEYS}


def check(files: dict, chunk: int = 65536) -> dict:
    """This checkout's scale_bench (one streamed pass, full outputs) over
    every local card against the same chunks on one card (--no-shard):
    every chunk bit for bit, the merged kernel launched once per step call
    per card (every chunk, the compute reference's steps, the warm-ups)
    and no other entry point."""
    import contextlib
    import io

    import numpy as np
    import torch
    from ecckd_tpu_torch.cli import scale_bench
    from ecckd_tpu_torch.ops.cuda import lw, lwsw, sw
    wrappers = (lwsw.lwsw_fluxes_cuda, lw.lw_fluxes_cuda, sw.sw_fluxes_cuda)
    argv = ["--columns", str(chunk * CHUNKS), "--chunk", str(chunk),
            "--nlay", str(NLAY), "--outputs", "full", "--repeats", "1",
            "--lw-file", files["lw"], "--sw-file", files["sw"]]
    kept, equal = {}, []

    def keep(host, i):
        kept[i] = [a.copy() for a in host]

    def same(host, i):
        equal.append(all(np.array_equal(a, b)
                         for a, b in zip(host, kept.get(i, ()))))

    runs = {}
    for name, extra, sink in (("cards", [], keep),
                              ("one_card", ["--no-shard"], same)):
        for w in wrappers:
            w.launches = w.fast_launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            rc = scale_bench.main(argv + extra, consume=sink)
        runs[name] = {"rc": rc, "launches": [w.launches for w in wrappers],
                      "fast_launches": sum(w.fast_launches for w in wrappers)}
    n_cards = torch.cuda.device_count()
    calls = 3 + scale_bench.REF_ITERS + CHUNKS
    ok = (len(kept) == len(equal) == CHUNKS and all(equal)
          and runs["cards"]["launches"] == [n_cards * calls, 0, 0]
          and runs["one_card"]["launches"] == [calls, 0, 0]
          and all(r["rc"] == 0 and r["fast_launches"] == 0
                  for r in runs.values()))
    return {"ok": ok, "n_cards": n_cards, "step_calls_per_card": calls,
            "chunks_bitwise_equal": sum(equal), "n_chunks": CHUNKS,
            **runs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stream_scaling", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--trees", nargs="+", default=["."],
                   help="checkout roots, run in this order in every cell")
    p.add_argument("--outputs", default="full,toa-net")
    p.add_argument("--chunks", default="65536,262144",
                   help="columns per chunk (over all cards)")
    p.add_argument("--one-card", action="store_true",
                   help="also run each checkout with --no-shard at 65,536 "
                        "columns per chunk")
    p.add_argument("--check", action="store_true",
                   help="first hold the stream over every card against one "
                        "card, bit for bit (check)")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("stream_scaling: no CUDA card", file=sys.stderr)
        return 1
    from ecckd_tpu_torch.io.synthetic import write_synthetic_ckd
    found = cards()
    print(f"cards: {len(found)} | " + " | ".join(found), flush=True)
    runs, result = [], {"cards": found}
    with tempfile.TemporaryDirectory() as work:
        files = {}
        for band, kind in (("lw", "lw_fsck"), ("sw", "sw_wide")):
            files[band] = os.path.join(work, f"{band}.nc")
            write_synthetic_ckd(files[band], kind, seed=7)
        if args.check:
            result["check"] = check(files)
            print("check: " + json.dumps(result["check"]), flush=True)
            if not result["check"]["ok"]:
                print(json.dumps(result))
                return 1
        for outputs in args.outputs.split(","):
            cells = [(int(c), []) for c in args.chunks.split(",")]
            if args.one_card:
                cells.append((65536, ["--no-shard"]))
            for chunk, extra in cells:
                trees = (list(dict.fromkeys(args.trees)) if extra
                         else args.trees)
                for tree in trees:
                    argv_run = ["--columns", str(chunk * CHUNKS),
                                "--chunk", str(chunk), "--nlay", str(NLAY),
                                "--outputs", outputs,
                                "--lw-file", files["lw"], "--sw-file",
                                files["sw"], *extra]
                    rec = {"tree": tree, "outputs": outputs, "chunk": chunk,
                           "no_shard": bool(extra),
                           **run_stream(tree, argv_run, args.timeout)}
                    runs.append(rec)
                    print("run: " + json.dumps(rec), flush=True)
    result["runs"] = runs
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
