"""One run of a cell over several cards: one process a card.

The process that the benchmark's command started (the launcher, `launch`)
starts one rank a place of the traffic mix's mesh, on a free localhost port,
and waits. Each rank (`main`, run as `python3 -m hbench.ranks <args>`) joins
the process group through the port's own init_distributed (NCCL on card
`rank`, gloo on the CPU), runs the harness's run_cell with the mix's loop,
and checks its own modules for JAX. Rank 0 judges the answers and hands its
result to the launcher as a file; the launcher prints the one result line.

At the first rank that fails, or at the deadline, the launcher stops every
rank (SIGTERM, on which a rank prints its threads' stacks, then SIGKILL to
the rank's whole session) and gives no result. A rank whose launcher has
gone ends itself.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
# from the launcher's start: the ranks are stopped here, inside the 330-s
# limit at which the launcher's faulthandler ends it
DEADLINE_S = 300.0
LOG_LINES = 200  # of each rank's log, printed by the launcher


def boot_now() -> float:
    """A clock that every process of the machine shares."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def world_of(cell) -> int:
    """The ranks a run of `cell` takes: one a place of its mesh."""
    n = 1
    for v in cell.traffic.get("mesh", [cell.chips]):
        n *= int(v)
    return n


@dataclasses.dataclass
class Launched:
    out: Optional[dict]  # rank 0's result; None where a rank failed
    rcs: List[Optional[int]]  # each rank's exit code (negative: killed)
    pids: List[int]


def launch(cell, seed: int, seconds: float, trace: bool, device: str, origin: float,
           fault: Optional[str] = None, fault_rank: int = 1,
           deadline_s: float = DEADLINE_S) -> Launched:
    """Runs `cell` on one rank a place of its mesh and waits for them all.
    `origin` is when the run began, on boot_now()'s clock: set-up counts
    from it. `fault` (hbench/faults.py) is planted in rank `fault_rank`'s
    timed path for the window (in every rank's where `fault_rank` is -1)."""
    world = world_of(cell)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="hbench_ranks_") as d:
        result = Path(d) / "result.pkl"
        args = {"workload": cell.name, "config": cell.config, "traffic": cell.traffic,
                "seed": seed, "seconds": seconds, "trace": trace, "device": device,
                "port": port, "world": world, "origin": origin, "end": origin + deadline_s,
                "fault": fault, "fault_rank": fault_rank, "result": str(result)}
        logs = [Path(d) / f"rank{r}.log" for r in range(world)]
        procs: List[subprocess.Popen] = []
        try:
            for r, path in enumerate(logs):
                with open(path, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "hbench.ranks", json.dumps(dict(args, rank=r))],
                        cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, start_new_session=True))
            log(f"hbench: {world} ranks started at {boot_now() - origin:.3f} s of the run")
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or boot_now() > args["end"]:
                    break
                time.sleep(0.1)
        finally:
            _stop(procs)
            for r, path in enumerate(logs):
                if path.is_file():
                    for line in path.read_text(errors="replace").splitlines()[-LOG_LINES:]:
                        log(f"[rank {r}] {line}")
        rcs = [p.returncode for p in procs]
        out = None
        if rcs == [0] * world and result.is_file():
            with open(result, "rb") as f:  # written by rank 0 of this run
                out = pickle.load(f)
        else:
            log(f"hbench: the ranks exited {rcs} (negative: killed); no result")
    return Launched(out, rcs, [p.pid for p in procs])


def _signal_session(p: subprocess.Popen, sig: int) -> None:
    try:
        os.killpg(p.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass  # the session has ended


def _stop(procs: List[subprocess.Popen], grace_s: float = 3.0) -> None:
    """Ends every rank and whatever it started, and waits for each."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        _signal_session(p, signal.SIGTERM)
    end = time.monotonic() + grace_s
    while any(p.poll() is None for p in live) and time.monotonic() < end:
        time.sleep(0.05)
    for p in procs:
        _signal_session(p, signal.SIGKILL)
    for p in procs:
        p.wait()


def leftovers(pids: List[int]) -> List[int]:
    """Processes still alive in the sessions of ranks `pids` (Linux /proc)."""
    left = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) in pids and fields[0] != "Z":
            left.append(int(stat.parent.name))
    return left


def _watch_parent() -> None:
    """Ends this rank when its launcher has gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(70)

    threading.Thread(target=watch, daemon=True).start()


def main(argv: List[str]) -> int:
    a = json.loads(argv[0])
    rank, world = int(a["rank"]), int(a["world"])
    _watch_parent()
    faulthandler.register(signal.SIGTERM, all_threads=True)
    faulthandler.dump_traceback_later(max(1.0, a["end"] + 10.0 - boot_now()), exit=True)
    sys.path.insert(0, str(ROOT))
    import gc

    import torch
    import torch.distributed as dist

    from hbench import harness, spec
    from hbench.run import forbidden_modules, process_seconds
    from tengine_tpu_torch.parallel.distributed import (
        init_distributed, shutdown_distributed, state,
    )

    origin = float(a["origin"])
    began, imported = boot_now() - origin - process_seconds(), boot_now() - origin

    # the card's host cores shared among the ranks
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    cuda = a["device"] == "cuda"
    device = f"cuda:{rank}" if cuda else "cpu"
    init_distributed(f"localhost:{a['port']}", world, rank, device=device)
    log(f"hbench: rank {rank}, s of the run: began {began:.3f}, imports done {imported:.3f}, "
        f"process group {boot_now() - origin:.3f}")
    try:
        cell = spec.load_cell(a["workload"], config_over=a["config"], traffic_over=a["traffic"])
        fault = a["fault"] if a["fault_rank"] in (rank, -1) else None
        out = harness.run_cell(cell, int(a["seed"]), float(a["seconds"]), bool(a["trace"]),
                               device, lambda: boot_now() - origin, window_fault=fault)
        if out is not None and rank == 0:
            out["kind"] = torch.cuda.get_device_name(device) if cuda else "cpu"
            out["ranks"] = world
            tmp = a["result"] + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, a["result"])
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
        dist.barrier(group=state().control)
    finally:
        shutdown_distributed()
    bad = forbidden_modules()
    if bad:
        log(f"hbench: rank {rank}: forbidden modules loaded: {', '.join(bad)}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
