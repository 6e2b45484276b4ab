"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m perfbench.calibrate --workload NAME --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 2] [--out FILE]

For each of --seeds, one run of the cell as `perfbench.run` makes it
(short windows); for each of --control-seeds, one run of the control:
the program with TF32 on for its float32 products, the nearest precision
below the float32 the configurations state. With --fault, every run has
that fault of perfbench.faults planted. Each run prints one JSON
line with the numbers its check compared (`checks`), and is appended to
--out. The limits in perfbench/workloads/<cell>.json lie between the
program's largest reading and the control's smallest.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from perfbench.faults import FAULTS
from perfbench.run import benchmark, forbidden_modules, load_cell, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None,
                   help="a fault of perfbench.faults planted in every run, for its readings")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.calibrate reads the card; CUDA is not available", file=sys.stderr)
        return 1
    bench = benchmark()
    kind = load_cell(args.workload, bench).kind
    plant = FAULTS[kind][args.fault] if args.fault else contextlib.nullcontext
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, tf32 in runs:
        with plant():
            r = run_cell(args.workload, seed, args.seconds, False, tf32=tf32, bench=bench)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "run": "control_tf32" if tf32 else (args.fault or "program"),
                           "correct": r["correct"], "checks": r["checks"],
                           "readings": r["extra"]["readings"], "units": r["attempted"],
                           "setup_s": r["extra"]["setup_s"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    if forbidden_modules():
        print(f"loaded {forbidden_modules()}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
