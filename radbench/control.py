"""The readings a cell's limits are set from, in one process on the card.

    python -m radbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out readings.json]

For each of ``--seeds`` it runs the cell as the benchmark does (set-up,
a window of ``--seconds`` at the cell's own load, the comparison with the
reference) and reads each number compared: the program as the
configuration states it.  Then it switches on the program's own path of
lower precision, the fast table mode (``config.set_mxu_precision("bf16")``:
bf16 tables and interpolation weights), which serves as the control, and
does the same for each of ``--control-seeds``.  It prints, and writes to
``--out``, every reading, the largest of the program's (the lower
reading) and the smallest of the control's (the upper one).  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from radbench import run


def readings(name: str, seeds, seconds: float, fast: bool) -> list:
    from ecckd_tpu_torch import config as port_config
    cell, config = run.load_cell(name)
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    previous = port_config.mxu_precision()
    port_config.set_mxu_precision("bf16" if fast else "bf16x3")
    try:
        out = []
        for seed in seeds:
            r = run.run_cell(name, cell, config, seed, seconds, False,
                             devices, t_start=time.perf_counter())
            out.append({"seed": seed, "correct": r["correct"],
                        **{k: n["value"] for k, n in r["check"].items()}})
            print(json.dumps(out[-1]), file=sys.stderr, flush=True)
        return out
    finally:
        port_config.set_mxu_precision(previous)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m radbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell, _ = run.load_cell(args.workload)
    run.require_cards(cell["chips"])
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",")]
    sound = readings(args.workload, seeds, args.seconds, fast=False)
    control = readings(args.workload, control_seeds, args.seconds, fast=True)
    numbers = [k for k in sound[0] if k not in ("seed", "correct")]
    summary = {"workload": args.workload, "sound": sound, "control": control,
               "lower": {k: max(r[k] for r in sound) for k in numbers},
               "upper": {k: min(r[k] for r in control) for k in numbers},
               "device": torch.cuda.get_device_name(0),
               "power_limit_w": run.power_limits(cell["chips"])}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
