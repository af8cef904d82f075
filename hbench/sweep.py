"""The knee of a served cell: the highest offered rate at which the program
keeps up, with no backlog growing over the window.

    python3 hbench/sweep.py --workload <name> --seed <n> --seconds <s> \
        --rates 150,175,200,225,250 --repeat 2

sets the cell up once and runs its open loop at each rate in turn, `repeat`
rounds over the rates, printing one JSON line a rate and round: requests
sent and answered, p50 and p95 latency, and the backlog's growth: the slope
of a least-squares line through each request's latency against when it was
due, in ms of latency gained a second of window. Where the program keeps up
the slope is about 0; past its capacity c, at rate r, a request waits
1 - c / r seconds longer for each second later it comes. A rate is kept up
with where every round's slope is under MAX_SLOPE (2 ms/s, 0.1 s
over a 51-s window, above the -0.3 to 1.7 ms/s that yolov5s-640 read on an
H100 at rates well below its capacity); the last line names the knee, the
highest rate kept up with where every lower one is too. The cell's traffic
file holds the rate the benchmark then offers.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SLOPE = 2.0  # ms of latency gained a second of window


def growth_ms_per_s(due_s, latencies_s) -> float:
    """The slope of latency against due time, in ms a second."""
    import numpy as np

    t, y = np.asarray(due_s, np.float64), np.asarray(latencies_s, np.float64)
    return 1e3 * float(np.polyfit(t, y, 1)[0])


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from hbench.run import set_environment

    set_environment()
    import torch

    from hbench import harness, spec, traffic

    if not torch.cuda.is_available():
        print("hbench sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if cell.traffic["kind"] != "open":
        print(f"hbench sweep: {cell.name} is not served", file=sys.stderr)
        return 2
    rates = [float(r) for r in args.rates.split(",")]
    kept = {r: True for r in rates}
    pr = harness.prepare(cell, args.seed, torch.device("cuda"))
    pr.loop.setup()
    try:
        for rnd in range(args.repeat):
            for rate in rates:
                pr.loop.tr["rate_rps"] = rate
                due = pr.loop.schedule(args.seconds)
                w = pr.loop.window(args.seconds, None)
                slope = growth_ms_per_s(due, w.latencies_s)
                kept[rate] &= slope < MAX_SLOPE and w.failed == 0
                print(json.dumps({
                    "round": rnd, "rate_rps": rate, "sent": w.attempted, "answered": w.images,
                    "failed": w.failed, "p50_ms": 1e3 * traffic.percentile(w.latencies_s, 50),
                    "p95_ms": 1e3 * traffic.percentile(w.latencies_s, 95),
                    "growth_ms_per_s": slope,
                    "rows_per_batch": w.server["requests"] / max(1, w.server["batches"])}),
                    flush=True)
    finally:
        pr.loop.close()
    knee = None
    for rate in sorted(rates):
        if not kept[rate]:
            break
        knee = rate
    print(json.dumps({"knee_rps": knee, "max_slope_ms_per_s": MAX_SLOPE,
                      "kept_up": {str(r): kept[r] for r in sorted(rates)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
