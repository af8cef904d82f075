"""The benchmark of tengine_tpu_torch: one run of one cell.

    python3 hbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (BENCHMARK.json names its configuration and its
traffic mix), measures for --seconds, compares the program's answers with
the plain reference (hbench/reference/), and prints one JSON line last on
standard output: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
breakdown, and checks (each compared number beside its limit, also the last
lines on standard error).

A cell that asks for several cards runs one process a card
(hbench/ranks.py) and prints the result of rank 0, which judges.

Needs the NVIDIA cards the cell asks for: without them it exits non-zero
and prints no result. It exits non-zero too, printing no result, where a
rank failed, or where jax, jaxlib, flax or the JAX package has been loaded
(in this process, or in any rank).
"""

from __future__ import annotations

import faulthandler
import os
import sys
import time
from typing import Callable

T_IMPORT = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tengine_tpu")


def process_seconds() -> float:
    """Seconds since this process began (/proc's start time, 10 ms
    resolution), or since this module was imported where /proc lacks it."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: the program's own name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment() -> None:
    """The route a user gets by default, whatever this host's environment
    says: no TT_* variable; the program's and PyTorch's kernel caches inside
    the checkout, at fixed paths."""
    for k in [k for k in os.environ if k.startswith("TT_")]:
        del os.environ[k]
    cache = os.path.join(ROOT, "build", "hbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(cache, "torch_kernels")


def power_limit_w(cards: int = 1) -> str:
    """The power limit of each card the run used, in watts ("/" between)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits",
                              "-i", ",".join(str(i) for i in range(cards))],
                             capture_output=True, text=True, timeout=20)
        return "/".join(out.stdout.split()) or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_environment()
    # a run that hangs prints every thread's stack and exits before the
    # caller's own time limit
    faulthandler.dump_traceback_later(330, exit=True)
    sys.path.insert(0, ROOT)
    import torch

    from hbench import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"hbench: cell {cell.name} needs {cell.chips} CUDA card(s), found {n}; "
                    "no result")
        return 2
    return report(cell, args.seed, args.seconds, bool(args.trace), "cuda", process_seconds)


def report(cell, seed: int, seconds: float, trace: bool, device: str,
           setup_clock: Callable[[], float], **launch_kw) -> int:
    """Runs `cell`, in this process or, where it asks for more than one
    card, on one rank a card (hbench/ranks.py: `launch_kw` goes there), and
    prints its result line; non-zero and no result where a rank failed or a
    forbidden module is loaded."""
    import json

    from hbench import harness, result

    if cell.chips > 1:
        from hbench import ranks

        origin = ranks.boot_now() - setup_clock()
        out = ranks.launch(cell, seed, seconds, trace, device, origin, **launch_kw).out
        if out is None:
            return 1
        kind, count = out["kind"], out["ranks"]
    else:
        import torch

        out = harness.run_cell(cell, seed, seconds, trace, device, setup_clock)
        kind, count = torch.cuda.get_device_name(0), cell.chips
    device = {
        "platform": "gpu",
        "kind": kind,
        "count": count,
        "memory_peak_bytes": out["peak"],
        "power_limit_w": power_limit_w(count),
    }
    line = result.assemble(cell, out, device, trace)
    bad = forbidden_modules()
    if bad:
        harness.log(f"hbench: forbidden modules loaded: {', '.join(bad)}; no result")
        return 3
    for c in out["checks"]:
        harness.log(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r}): "
                    f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
