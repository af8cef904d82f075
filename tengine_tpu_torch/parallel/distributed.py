"""Multi-host bring-up on torch.distributed: process group + global mesh +
failure detection (PyTorch port of tengine_tpu/parallel/distributed.py).

The reference is single-process/single-node (SURVEY §2.3); scale-out is new
design. The JAX package runs one process per host; the port runs one
process per card, torch's norm. Topology model:

  * a host is a run of `ranks_per_host` consecutive ranks (torchrun's
    LOCAL_WORLD_SIZE, or init_distributed's argument);
  * the "model" (TP) axis never crosses a host, so weight-sharded
    collectives (all-gathers of channel slices) ride the host's own links
    (NVLink);
  * the "data" (DP) axis spans hosts, so the only cross-host traffic is
    request scatter/gather, not per-layer collectives.

The data path's backend is NCCL on the card and gloo on the CPU, or the one
the caller names; nothing switches backend or device when one fails. The
multi-host server's control messages (stop and has-work flags) ride a gloo
group of their own, whatever the data path's backend.

Failure detection (SURVEY §5: reference has none): a heartbeat thread per
rank writes its liveness into the job's TCPStore; `check_peers` reports the
ranks whose beat is older than the timeout, so a supervisor can restart the
job (weights are stateless for inference: a restart is a re-init).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..executor.engine import resolve_device
from ..utils.log import logger
from .mesh import make_mesh


@dataclasses.dataclass
class DistState:
    """What init_distributed set up for this process: its rank in a world,
    the ranks a host, the data path's device and backend, the job's store
    (the heartbeat's key-value space) and the gloo group of the server's
    control messages."""

    rank: int
    world: int
    ranks_per_host: int
    device: Optional[torch.device]  # None: no process group yet, the card by default
    backend: str
    store: Optional[dist.Store] = None
    control: Optional[dist.ProcessGroup] = None


_STATE: Optional[DistState] = None  # one process group a process, as torch keeps it


def state() -> DistState:
    """This process's distributed state: init_distributed's, or a world of
    one without a process group. A process group that the caller initialized
    itself raises: it has neither the gloo control group of the multi-host
    server nor the store of the heartbeat."""
    if _STATE is not None:
        return _STATE
    if dist.is_initialized():
        raise RuntimeError("this process group was not set up by init_distributed: the "
                           "mesh server and the heartbeat need init_distributed's control "
                           "group and store")
    return DistState(0, 1, 1, None, "none")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
    ranks_per_host: Optional[int] = None,
) -> bool:
    """torch.distributed.init_process_group over a TCPStore that rank 0
    hosts at `coordinator_address` ("host:port"); a no-op that returns False
    without an address (single process).

    num_processes and process_id default to torchrun's WORLD_SIZE and RANK.
    device: the card unless named ("cpu" for the CPU); a rank takes card
    `rank % ranks_per_host` unless the device names its index. backend:
    NCCL on the card and gloo on the CPU unless named. ranks_per_host:
    LOCAL_WORLD_SIZE, else the whole world (one host)."""
    global _STATE
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if ranks_per_host is None:
        ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if num_processes % ranks_per_host:
        raise ValueError(f"ranks_per_host={ranks_per_host} must divide the world "
                         f"{num_processes}")
    local_rank = process_id % ranks_per_host
    dev = torch.device(device) if device is not None else None
    if dev is None or (dev.type == "cuda" and dev.index is None):
        resolve_device(None)  # raises without a card
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")

    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timedelta(seconds=300))
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes)
    control = dist.new_group(backend="gloo")
    _STATE = DistState(process_id, num_processes, ranks_per_host, dev, backend, store, control)
    logger.info(
        "distributed initialized: rank %d/%d (%s on %s), local rank %d of %d ranks a host",
        process_id, num_processes, backend, dev, local_rank, ranks_per_host,
    )
    return True


def shutdown_distributed() -> None:
    """Destroy the process group init_distributed made (and its groups).
    Drop first every ShardedGraph (and server) whose CUDA graphs captured
    NCCL collectives: with such graphs alive, destroying the communicators
    hung every rank on four cards."""
    global _STATE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None


def global_mesh(tp: Optional[int] = None):
    """Global (data, model) mesh: "model" never crosses a host boundary so
    TP collectives stay on the host's links; "data" spans hosts. Ranks are
    host-major (a host's ranks are consecutive), so rows of tp consecutive
    ranks lie inside one host."""
    st = state()
    local = st.ranks_per_host
    if tp is None:
        tp = local  # TP within the host by default
    if local % tp != 0:
        raise ValueError(f"tp={tp} must divide local device count {local}")
    return make_mesh(list(range(st.world)), shape=(st.world // tp, tp), device=st.device)


def host_local_batch_to_global(x, mesh):
    """A DP-sharded global batch from each data group's local rows
    (continuous batching across hosts: every host contributes its queue's
    rows; nothing moves, each shard stays on its own ranks): a DTensor of
    placements (Shard(0), Replicate()) over (data, model), whose local
    tensor is `x` on the mesh's device. For the boundary only: the sharded
    forward (parallel/sharding.py) takes it and returns its outputs so."""
    from torch.distributed.tensor import DTensor

    from .mesh import data_sharding

    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if mesh.device_type == "cuda":
        t = t.to(state().device)
    return DTensor.from_local(t, mesh, data_sharding(mesh, t.ndim), run_check=False)


class Heartbeat:
    """Per-rank liveness for failure detection (no reference analog —
    SURVEY §5 row 'Failure detection').

    Each rank's beat thread overwrites `/tt/heartbeat/<rank>` in the job's
    TCPStore with its time_ns (the JAX package's coordination service lists
    a directory of keys per beat; the store keeps one key a rank);
    `check_peers` reads every expected rank's key and reports any rank whose
    beat is older than `timeout_s`, or absent. A dead or wedged process stops
    publishing, so survivors detect it within one timeout window."""

    def __init__(self, interval_s: float = 5.0, timeout_s: float = 15.0):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self._last_seen = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        st = state()
        self._rank, self._world, self._store = st.rank, st.world, st.store

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    @staticmethod
    def _key(rank: int) -> str:
        return f"/tt/heartbeat/{rank}"

    def _beat(self):
        while not self._stop.is_set():
            now = time.time_ns()
            if self._store is not None:
                try:
                    self._store.set(self._key(self._rank), str(now))
                except RuntimeError as e:  # the store's host is gone
                    logger.warning("heartbeat of rank %d not published: %s", self._rank, e)
            self._last_seen[self._rank] = now / 1e9
            self._stop.wait(self.interval_s)

    def peer_last_seen(self) -> dict:
        """Newest heartbeat timestamp (seconds, wall clock) per rank, read
        from the store."""
        seen = dict(self._last_seen)
        if self._store is None:
            return seen
        for p in range(self._world):
            key = self._key(p)
            try:
                if self._store.check([key]):
                    seen[p] = max(seen.get(p, 0.0), int(self._store.get(key)) / 1e9)
            except RuntimeError as e:
                logger.warning("heartbeat of rank %d not read: %s", p, e)
        return seen

    def check_peers(self) -> Tuple[bool, list]:
        """Returns (healthy, missing_ranks). Single process: always healthy.
        Otherwise every rank of the world must have a beat newer than
        timeout_s; missing or stale ranks are reported for a supervisor's
        restart."""
        if self._world == 1:
            return True, []
        now = time.time()
        seen = self.peer_last_seen()
        missing = [p for p in range(self._world) if now - seen.get(p, 0.0) > self.timeout_s]
        return not missing, missing
