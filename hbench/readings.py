"""The readings that a cell's limits are set from: short runs of a cell on
the card, each through the harness's own set-up, timed path and judge, as a
sound run and with each named fault planted in the timed path
(hbench/faults.py), on several seeds in one process.

    python3 hbench/readings.py --workload <name> --seeds 1,2,3 --seconds 3 \
        [--faults stale,rows_swapped] [--fault-seeds 2] [--fault-rank 1]

prints one JSON line a run: the seed, the fault (null for a sound run),
whether it came out correct, and every number the comparison read. A cell
over several cards runs each time on one rank a card (hbench/ranks.py),
the fault planted in rank `--fault-rank`'s timed path for the window; its
line also gives the ranks' exit codes and the processes they left behind
(`exits`, of hbench/faults.py's ENDINGS, ends that rank: no result).
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
    ap.add_argument("--fault-rank", type=int, default=1,
                    help="the rank that takes the fault, in a cell over several cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from hbench.run import set_environment

    set_environment()
    import torch

    from hbench import faults, harness, ranks, spec

    if not torch.cuda.is_available():
        print("hbench readings: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    names = [f for f in args.faults.split(",") if f]

    t0 = time.perf_counter()
    runs = [(s, None) for s in seeds] + [(s, f) for f in names for s in seeds[:args.fault_seeds]]
    for seed, fault in runs:
        line = {"workload": cell.name, "seed": seed, "fault": fault}
        if cell.chips > 1:
            got = ranks.launch(cell, seed, args.seconds, False, "cuda", ranks.boot_now(),
                               fault=fault, fault_rank=args.fault_rank)
            out = got.out or {"correct": None, "compared": 0, "numbers": None}
            line.update(rcs=got.rcs, left_behind=ranks.leftovers(got.pids))
        else:
            with faults.plant(fault) if fault else contextlib.nullcontext():
                out = harness.run_cell(cell, seed, args.seconds, False, "cuda", lambda: 0.0)
        line.update(correct=out["correct"], compared=out["compared"], numbers=out["numbers"],
                    elapsed_s=round(time.perf_counter() - t0, 1))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
