"""Continuous-batching inference server on one device (PyTorch port of
tengine_tpu/parallel/serving.py, its single-device half).

The reference is single-request synchronous (run_graph blocks on one
image; its only pipelining is the app-level actor framework in
examples/pipeline). For serving, the engine adds a dynamic batcher:
requests arriving within a small window are padded into power-of-two
batch buckets and dispatched as one forward. Each bucket has its own
CompiledGraph, compiled with Options.batch_size set to the bucket (kernel
routes follow the batch: the depthwise kernel's gate needs 32), and on a
CUDA card its own CUDA graph, captured at the bucket's first call. The
buckets share their device weights where their params are equal
(ParamStore.upload).

Latency/throughput knobs: max_batch (bucket cap) and max_wait_ms (batching
window) — the standard continuous-batching tradeoff.

Not ported yet (ROADMAP queue 1 item 12b): the mesh, data-parallel
sharding of a bucket across cards and the multi-host loop.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..executor.engine import CompiledGraph, compile_graph, resolve_device
from ..graph.ir import Graph
from ..utils.config import Options
from ..utils.log import logger


@dataclass
class _Request:
    x: np.ndarray
    future: Future
    enqueued_at: float


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
        if mesh is not None:
            raise NotImplementedError(
                "InferenceServer(mesh=...) is not ported yet: the mesh, sharding and the "
                "multi-host loop are ROADMAP queue 1 item 12b")
        self.options = options or Options.from_env()
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.graph = graph
        self.device = resolve_device(device)  # raises without a card unless named

        # one CompiledGraph per bucket, compiled at the bucket's first batch
        self._compiled: Dict[int, CompiledGraph] = {}
        self._base_shape = [int(d) for d in graph.tensors[graph.input_tensors[0]].shape]
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.stats = {"batches": 0, "requests": 0, "padded": 0}
        self._latencies: List[float] = []  # seconds, submit -> result set
        self._lat_cap = 100_000

    def _get_compiled(self, batch: int) -> CompiledGraph:
        cg = self._compiled.get(batch)
        if cg is None:
            opts = dataclasses.replace(self.options, batch_size=batch)
            # a param equal to the first bucket's takes its device tensor
            share = next(iter(self._compiled.values()), None)
            cg = compile_graph(self.graph, opts, device=self.device, share=share)
            self._compiled[batch] = cg
        return cg

    # -- public API --------------------------------------------------------

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)

    def submit(self, x: np.ndarray) -> Future:
        x = np.asarray(x)
        if x.ndim == len(self._base_shape) - 1:
            x = x[None]
        if x.shape[0] != 1:
            raise ValueError("submit one request at a time; batching is internal")
        fut: Future = Future()
        self._queue.put(_Request(x=x, future=fut, enqueued_at=time.perf_counter()))
        return fut

    def __call__(self, x: np.ndarray):
        return self.submit(x).result()

    # -- batching loop -----------------------------------------------------

    def _collect(self) -> List[_Request]:
        try:
            first = self._queue.get(timeout=0.05)
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
            batch = self._collect()
            if not batch:
                continue
            n = len(batch)
            b = _bucket(n, self.max_batch)
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
            done = time.perf_counter()
            for i, r in enumerate(batch):
                r.future.set_result([o[i : i + 1] for o in outs])
                if len(self._latencies) < self._lat_cap:
                    self._latencies.append(done - r.enqueued_at)

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
