"""The readings that a cell's limits are set from: short runs of a cell on
the card, each through the harness's own set-up, timed path and judge, as a
sound run and with each named fault planted in the timed path
(hbench/faults.py), on several seeds in one process.

    python3 hbench/readings.py --workload <name> --seeds 1,2,3 --seconds 3 \
        [--faults stale,rows_swapped] [--fault-seeds 2]

prints one JSON line a run: the seed, the fault (null for a sound run),
whether it came out correct, and every number the comparison read.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="", help="comma-separated names of hbench/faults.py")
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="how many of the seeds also run with each fault")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from hbench.run import set_environment

    set_environment()
    import torch

    from hbench import faults, harness, spec

    if not torch.cuda.is_available():
        print("hbench readings: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    names = [f for f in args.faults.split(",") if f]

    t0 = time.perf_counter()
    runs = [(s, None) for s in seeds] + [(s, f) for f in names for s in seeds[:args.fault_seeds]]
    for seed, fault in runs:
        with faults.plant(fault) if fault else contextlib.nullcontext():
            out = harness.run_cell(cell, seed, args.seconds, False, "cuda", lambda: 0.0)
        print(json.dumps({"workload": cell.name, "seed": seed, "fault": fault,
                          "correct": out["correct"], "compared": out["compared"],
                          "numbers": out["numbers"],
                          "elapsed_s": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
