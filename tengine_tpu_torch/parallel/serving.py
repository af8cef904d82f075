"""Continuous-batching inference server (PyTorch port of
tengine_tpu/parallel/serving.py).

The reference is single-request synchronous (run_graph blocks on one
image; its only pipelining is the app-level actor framework in
examples/pipeline). For serving, the engine adds:

  * a dynamic batcher: requests arriving within a small window are padded
    into power-of-two batch buckets and dispatched as one forward. Each
    bucket has its own CompiledGraph, compiled with Options.batch_size set
    to the bucket (kernel routes follow the batch: the depthwise kernel's
    gate needs 32), and on a CUDA card its own CUDA graph, captured at the
    bucket's first call. The buckets share their device weights where
    their params are equal (ParamStore.upload);
  * DP and TP over a mesh (parallel/sharding.py): a bucket the data axis
    divides runs B/data-size rows on each data group, its conv/FC weights
    split over the model axis;
  * multi-host: with init_distributed (distributed.py) and a global mesh,
    the same server runs on every rank in lockstep, each data group's
    queue feeding its rows of one global batch.

Latency/throughput knobs: max_batch (bucket cap) and max_wait_ms (batching
window) — the standard continuous-batching tradeoff.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..executor.engine import CompiledGraph, compile_graph, resolve_device
from ..graph.ir import Graph
from ..ops.qmath import TORCH_DTYPES
from ..utils import trace
from ..utils.config import Options
from ..utils.log import logger
from .distributed import host_local_batch_to_global, state
from .sharding import broadcast_from, shard_compiled


@dataclass
class _Request:
    x: np.ndarray
    future: Future
    enqueued_at: float  # time.perf_counter(), the span recorder's clock in seconds
    rid: int  # the id the request's spans share


def _ns(seconds: float) -> int:
    return int(seconds * 1e9)


def _record_queue(batch: List[_Request]) -> int:
    """Each request's server.queue span, from its submit to now; now, in
    the span recorder's ns."""
    t = trace.now()
    for r in batch:
        trace.record(trace.SERVER_QUEUE, _ns(r.enqueued_at), t, ids=(r.rid,))
    return t


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class InferenceServer:
    """Dynamic-batching server over a graph, on the engine's device (the
    card unless `device` names another).

    Example:
        server = InferenceServer(graph, options=Options(), max_batch=32)
        server.start()
        fut = server.submit(image)          # [C, H, W] or [1, C, H, W]
        result = fut.result()
    """

    def __init__(
        self,
        graph: Graph,
        options: Optional[Options] = None,
        mesh=None,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        device=None,
    ):
        self.options = options or Options.from_env()
        self.mesh = mesh
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.graph = graph
        self.device = resolve_device(device)  # raises without a card unless named
        if mesh is not None and self.device.type != mesh.device_type:
            raise ValueError(f"the server's device {self.device} is not on the mesh "
                             f"({mesh.device_type})")
        if mesh is not None:
            state()  # raises on a process group that init_distributed did not set up

        # one CompiledGraph per bucket, compiled at the bucket's first batch
        self._compiled: Dict[int, CompiledGraph] = {}
        self._base_shape = [int(d) for d in graph.tensors[graph.input_tensors[0]].shape]
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.stats = {"batches": 0, "requests": 0, "padded": 0}
        self._stop_requested = False
        # in a TP group, the rank at model coordinate 0 holds the queue
        self._leader = None
        if mesh is not None and mesh.size(1) > 1:
            self._leader = dist.get_global_rank(mesh.get_group(1), 0)
        self._latencies: List[float] = []  # seconds, submit -> result set
        self._lat_cap = 100_000
        self._rids = itertools.count()

    def _get_compiled(self, batch: int) -> CompiledGraph:
        cg = self._compiled.get(batch)
        if cg is None:
            opts = dataclasses.replace(self.options, batch_size=batch)
            # a param equal to the first bucket's takes its device tensor
            share = next(iter(self._compiled.values()), None)
            cg = compile_graph(self.graph, opts, device=self.device, share=share)
            if self.mesh is not None and batch % self.mesh.size(0) == 0:
                cg = shard_compiled(cg, self.mesh, share=share)
            self._compiled[batch] = cg
        return cg

    # -- multi-host mode ----------------------------------------------------
    #
    # With init_distributed and a global mesh, serving runs in SPMD
    # lockstep: each data group's queue (held by its rank at model
    # coordinate 0, which broadcasts the bucket to its TP group) drains into
    # a fixed local bucket (max_batch rows, zero-padded); the buckets are
    # one DP-sharded global batch (host_local_batch_to_global: nothing
    # moves, each group's rows stay on its ranks), and every rank runs the
    # same sharded forward. Fixed bucket size is what makes the lockstep
    # coordination-free (ranks never need to agree on a bucket), at the
    # price of padding under low load.

    def _multihost(self) -> bool:
        return self.mesh is not None and dist.get_world_size() > 1

    def _loop_multihost(self):
        control = state().control
        world = dist.get_world_size()
        local_b = self.max_batch
        cg = self._get_compiled(local_b * self.mesh.size(0))
        t_in = self.graph.tensors[self.graph.input_tensors[0]]
        bucket_dtype = TORCH_DTYPES[t_in.dtype]
        bucket_shape = (local_b,) + tuple(self._base_shape[1:])
        holds_queue = self._leader in (None, dist.get_rank())
        while self._running:
            # Stop + has-work protocol, in-band with the SPMD lockstep: every
            # round all ranks all-gather [stop_flag, queue_depth] on the gloo
            # control group (itself a collective, so it is the round
            # barrier); the loop exits only when the stop decision is
            # unanimous, which every rank observes in the same round. No
            # store state: nothing to race on or leak across server
            # lifecycles.
            mine = torch.tensor([int(self._stop_requested), self._queue.qsize()], dtype=torch.int32)
            flags = torch.empty(2 * world, dtype=torch.int32)
            dist.all_gather_into_tensor(flags, mine, group=control)
            flags = flags.reshape(world, 2)
            if int(flags[:, 0].sum()) >= world:
                break
            if int(flags[:, 1].sum()) == 0:
                # No rank has work: skip the padded full-size dispatch. The
                # decision is uniform across ranks (a collective's result),
                # so lockstep holds; the short sleep bounds the idle
                # all-gather rate.
                self.stats["idle_rounds"] = self.stats.get("idle_rounds", 0) + 1
                time.sleep(min(self.max_wait_s, 0.005))
                continue
            batch = self._collect(self.max_wait_s) if holds_queue else []
            t = _record_queue(batch)
            with trace.span(trace.SERVER_BATCH, start_ns=t,
                            ids=tuple(r.rid for r in batch)) as held:
                n = len(batch)
                x = torch.zeros(bucket_shape, dtype=bucket_dtype)
                if n:
                    x[:n] = torch.from_numpy(np.concatenate([r.x for r in batch], axis=0))
                self.stats["padded"] += local_b - n if holds_queue else 0
                try:
                    x = x.to(self.device)
                    if self._leader is not None:  # the TP group's rows, from its queue
                        x = broadcast_from(x, self._leader, self.mesh.get_group(1))
                    outs = cg(host_local_batch_to_global(x, self.mesh))
                    outs = [o.to_local().cpu().numpy() for o in outs]
                except Exception as e:  # the loop serves on; the callers get the error
                    logger.exception("multihost serving batch failed: %s", e)
                    for r in batch:
                        r.future.set_exception(e)
                    continue
                self.stats["batches"] += 1
                self.stats["requests"] += n
                held.end_at(_ns(self._reply(batch, outs)))

    def _reply(self, batch: List[_Request], outs) -> float:
        """Each request's rows of the outputs to its future; the time the
        last was set, which ends each request's latency sample and the
        batch's span."""
        for i, r in enumerate(batch):
            r.future.set_result([o[i : i + 1] for o in outs])
        done = time.perf_counter()
        for r in batch:
            if len(self._latencies) < self._lat_cap:
                self._latencies.append(done - r.enqueued_at)
        return done

    # -- public API --------------------------------------------------------

    def start(self):
        self._running = True
        self._stop_requested = False
        target = self._loop_multihost if self._multihost() else self._loop
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()

    def stop(self):
        if self._multihost() and self._thread and self._thread.is_alive():
            # distributed shutdown: ranks may have run different numbers of
            # rounds, and a rank that simply exits strands its peers at the
            # lockstep's collective. Announce stop in-band and keep serving
            # empty rounds until every rank has announced.
            self._stop_requested = True
            self._thread.join(timeout=60)
            self._running = False
        else:
            self._running = False
            if self._thread:
                self._thread.join(timeout=5)

    def submit(self, x: np.ndarray) -> Future:
        if self._leader is not None and self._leader != dist.get_rank():
            raise RuntimeError(f"rank {dist.get_rank()} takes no requests: rank {self._leader} "
                               "holds its TP group's queue")
        x = np.asarray(x)
        if x.ndim == len(self._base_shape) - 1:
            x = x[None]
        if x.shape[0] != 1:
            raise ValueError("submit one request at a time; batching is internal")
        fut: Future = Future()
        self._queue.put(_Request(x=x, future=fut, enqueued_at=time.perf_counter(),
                                 rid=next(self._rids)))
        return fut

    def __call__(self, x: np.ndarray):
        return self.submit(x).result()

    # -- batching loop -----------------------------------------------------

    def _collect(self, first_wait_s: float) -> List[_Request]:
        """Up to max_batch queued requests: the first waited for up to
        first_wait_s, the rest until max_wait_s after the first's arrival."""
        try:
            first = self._queue.get(timeout=first_wait_s)
        except queue.Empty:
            return []
        batch = [first]
        deadline = first.enqueued_at + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                # Deadline passed (e.g. a long compute round backed up the
                # queue): still drain everything already available so a
                # sustained-load round batches max_batch requests instead of
                # collapsing to 1 request/round with an unbounded queue.
                try:
                    while len(batch) < self.max_batch:
                        batch.append(self._queue.get_nowait())
                except queue.Empty:
                    pass
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while self._running:
            batch = self._collect(0.05)
            if not batch:
                continue
            t = _record_queue(batch)
            with trace.span(trace.SERVER_BATCH, start_ns=t,
                            ids=tuple(r.rid for r in batch)) as held:
                n = len(batch)
                b = _bucket(n, self.max_batch)
                with trace.span(trace.SERVER_FORM):
                    x = np.concatenate([r.x for r in batch], axis=0)
                    if b > n:  # pad to the bucket size
                        pad = np.zeros((b - n,) + x.shape[1:], x.dtype)
                        x = np.concatenate([x, pad], axis=0)
                        self.stats["padded"] += b - n
                try:
                    cg = self._get_compiled(b)
                    outs = cg.run(x)
                except Exception as e:  # the loop serves on; the callers get the error
                    logger.exception("serving batch failed: %s", e)
                    for r in batch:
                        r.future.set_exception(e)
                    continue
                self.stats["batches"] += 1
                self.stats["requests"] += n
                with trace.span(trace.SERVER_REPLY):
                    held.end_at(_ns(self._reply(batch, outs)))

    def latency_stats(self) -> dict:
        """End-to-end request latency percentiles in ms (p50 is the
        BASELINE.json serving metric)."""
        if not self._latencies:
            return {}
        a = np.asarray(self._latencies) * 1e3
        return {
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)),
            "p99_ms": float(np.percentile(a, 99)),
        }
