"""The one traffic generator and the loops that drive the program with it.

A traffic mix is a file of parameters (hbench/traffic/<name>.json) whose
`kind` picks one of three loops:

  offline  batches of `batch` images dispatched back to back through
           CompiledGraph.__call__ from a ring of `ring` distinct batches
           already on the card, at most `inflight` batches queued ahead;
           the window ends at a synchronize;
  closed   one client at batch 1 through CompiledGraph.run (a host array
           in, host arrays out), its next call when the last returns, over
           a pool of `pool` images in an order drawn from the seed;
  open     one client thread sending single frames from a pool of `pool`
           to InferenceServer(max_batch, max_wait_ms) at `rate_rps`, open
           loop: every seed gets the same inter-arrival gaps (the quantiles
           of an exponential distribution at that rate) in another order,
           so the work does not change with the seed; each request is
           timed from when it was due to its future's result.

Every loop takes explicit Options(quant_mode="fast", batch_size=b): the
route a user gets by default.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from hbench import trace as tracing


@dataclasses.dataclass
class Window:
    seconds: float
    images: int  # images answered in the window (padding rows not counted)
    attempted: int
    failed: int
    latencies_s: Optional[List[float]] = None
    server: Optional[Dict[str, int]] = None  # stats gained over the window


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _options(batch: Optional[int]):
    from tengine_tpu_torch.utils.config import Options

    return Options(quant_mode="fast", batch_size=batch)


class Loop:
    """Common state: the quantized graph, the device, the mix, the seeded
    inputs (`make(n)` gives n quantized images on the device)."""

    def __init__(self, qg, device, traffic: dict, make: Callable, rng: np.random.Generator):
        self.qg, self.device, self.tr, self.make, self.rng = qg, device, traffic, make, rng
        self.batch = int(traffic.get("batch", 1))

    def slice_at(self, seconds: float) -> tracing.Slice:
        """The traced slice: `trace_slice_s` in the middle of the window."""
        length = min(float(self.tr["trace_slice_s"]), 0.5 * seconds)
        return tracing.Slice(0.5 * (seconds - length), length, self.device)


class Offline(Loop):
    def setup(self) -> float:
        from tengine_tpu_torch.executor.engine import compile_graph

        b, r = self.batch, int(self.tr["ring"])
        x = self.make(b * r)
        self.ring = [x[i * b:(i + 1) * b].contiguous() for i in range(r)]
        t = time.perf_counter()
        self.cg = compile_graph(self.qg, _options(b), device=self.device)
        self.cg(self.ring[0])  # warm-up forward and the capture
        _sync(self.device)
        compile_s = time.perf_counter() - t
        for _ in range(2):
            for xb in self.ring:
                self.cg(xb)
        _sync(self.device)
        self.window(float(self.tr["warm_s"]), None)
        return compile_s

    def window(self, seconds: float, sl: Optional[tracing.Slice]) -> Window:
        cuda = self.device.type == "cuda"
        inflight = int(self.tr["inflight"])
        self.last = [None] * len(self.ring)
        pending: List = []
        calls = 0
        t0 = time.perf_counter()
        while True:
            el = time.perf_counter() - t0
            if el >= seconds:
                break
            if sl is not None:
                sl.tick(el)
            i = calls % len(self.ring)
            with record_function("hbench.call"):
                self.last[i] = self.cg(self.ring[i])
            calls += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > inflight:
                    with record_function("hbench.wait"):
                        pending.pop(0).synchronize()
        _sync(self.device)
        t1 = time.perf_counter()
        if sl is not None:
            sl.stop()
        n = calls * self.batch
        return Window(seconds=t1 - t0, images=n, attempted=n, failed=0)

    def answers(self):
        """(integer inputs, outputs) of the last call on each ring batch."""
        return [(x.cpu(), [o.cpu() for o in outs])
                for x, outs in zip(self.ring, self.last) if outs is not None]

    def per_forward(self) -> dict:
        n = int(self.tr["profile_forwards"])
        return tracing.per_forward(lambda: self.cg(self.ring[0]), n, self.device)

    def close(self) -> None:
        self.cg = self.ring = self.last = None


class Closed(Loop):
    def setup(self) -> float:
        from tengine_tpu_torch.executor.engine import compile_graph

        self.pool = self.make(int(self.tr["pool"])).cpu().numpy()
        t = time.perf_counter()
        self.cg = compile_graph(self.qg, _options(1), device=self.device)
        self.cg.run(self.pool[:1])  # warm-up forward and the capture
        compile_s = time.perf_counter() - t
        for i in range(len(self.pool)):
            self.cg.run(self.pool[i:i + 1])
        self.window(float(self.tr["warm_s"]), None)
        return compile_s

    def window(self, seconds: float, sl: Optional[tracing.Slice]) -> Window:
        n = len(self.pool)
        order = self.rng.permutation(n)
        self.last: Dict[int, list] = {}
        lat = []
        t0 = time.perf_counter()
        k = 0
        while True:
            el = time.perf_counter() - t0
            if el >= seconds:
                break
            if sl is not None:
                sl.tick(el)
            i = int(order[k % n])
            k += 1
            ts = time.perf_counter()
            with record_function("hbench.run"):
                outs = self.cg.run(self.pool[i:i + 1])
            lat.append(time.perf_counter() - ts)
            self.last[i] = outs
        t1 = time.perf_counter()
        if sl is not None:
            sl.stop()
        return Window(seconds=t1 - t0, images=len(lat), attempted=len(lat), failed=0,
                      latencies_s=lat)

    def answers(self):
        return [(torch.from_numpy(self.pool[i:i + 1]), [torch.from_numpy(o) for o in outs])
                for i, outs in sorted(self.last.items())]

    def per_forward(self) -> dict:
        x, n = self.pool[:1], int(self.tr["profile_forwards"])
        return tracing.per_forward(lambda: self.cg.run(x), n, self.device)

    def close(self) -> None:
        self.cg = self.pool = self.last = None


class Open(Loop):
    def setup(self) -> float:
        from tengine_tpu_torch.parallel.serving import InferenceServer

        self.pool = self.make(int(self.tr["pool"])).cpu().numpy()
        self.server = InferenceServer(self.qg, options=_options(None),
                                      max_batch=int(self.tr["max_batch"]),
                                      max_wait_ms=float(self.tr["max_wait_ms"]),
                                      device=self.device)
        self.server.start()
        t = time.perf_counter()
        # each bucket's batch compiles and captures at its first burst
        for b in self.tr["buckets"]:
            for _ in range(2):
                futs = [self.server.submit(self.pool[j]) for j in range(b)]
                for f in futs:
                    f.result(timeout=600)
        compile_s = time.perf_counter() - t
        # the served path's host side reaches its steady state under load
        self.window(float(self.tr["warm_s"]), None)
        return compile_s

    def schedule(self, seconds: float) -> np.ndarray:
        """When each request is due, in seconds from the window's start: the
        quantiles of an exponential distribution at `rate_rps` as the gaps,
        in an order drawn from the mix's own `schedule_seed`, so that every
        run offers the same arrivals and only the frames' content follows
        --seed."""
        rate = float(self.tr["rate_rps"])
        n = max(1, int(round(rate * seconds)))
        q = (np.arange(n) + 0.5) / n
        order = np.random.default_rng(int(self.tr["schedule_seed"])).permutation(n)
        gaps = (-np.log1p(-q) / rate)[order]
        return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])

    def window(self, seconds: float, sl: Optional[tracing.Slice]) -> Window:
        due_off = self.schedule(seconds)
        n = len(due_off)
        frames = self.rng.integers(0, len(self.pool), n)
        keep = set(self.rng.choice(n, size=min(n, int(self.tr["sample"])), replace=False).tolist())
        # a request's future is dropped once answered, as a client drops it
        # after reading: only the sampled answers are kept for the check
        done_t: List[Optional[float]] = [None] * n
        ok: List[bool] = [False] * n
        kept: Dict[int, list] = {}
        lock, all_done, left = threading.Lock(), threading.Event(), [n]

        def on_done(i, fut):
            done_t[i] = time.perf_counter()
            ok[i] = not fut.cancelled() and fut.exception() is None
            if ok[i] and i in keep:
                kept[i] = fut.result()
            with lock:
                left[0] -= 1
                if not left[0]:
                    all_done.set()

        def quiesce():
            """Wait until every request sent so far is answered."""
            end = time.perf_counter() + 10.0
            while n - left[0] < sent[0] and time.perf_counter() < end:
                time.sleep(0.0005)

        if sl is not None:
            sl.quiesce = quiesce
        before = dict(self.server.stats)
        sent = [0]
        t0 = time.perf_counter()
        for i in range(n):
            due = t0 + due_off[i]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if sl is not None:
                sl.tick(time.perf_counter() - t0)
            with record_function("hbench.submit"):
                f = self.server.submit(self.pool[frames[i]])
            f.add_done_callback(lambda fut, i=i: on_done(i, fut))
            sent[0] += 1
        deadline = t0 + seconds + float(self.tr["grace_s"])
        all_done.wait(timeout=max(0.0, deadline - time.perf_counter()))
        if sl is not None:
            sl.stop()
        lat, failed, answered, last = [], 0, 0, t0
        for i in range(n):
            t = done_t[i]
            if ok[i] and t is not None:
                answered += 1
                last = max(last, t)
                lat.append(t - (t0 + due_off[i]))
            else:  # slower than every answered request
                failed += 1
                lat.append(deadline - (t0 + due_off[i]))
        after = dict(self.server.stats)
        if n >= 8:
            q = [1e3 * float(np.median(lat[k * n // 4:(k + 1) * n // 4])) for k in range(4)]
            print(f"hbench: open loop, median ms by quarter of the window {q}", file=sys.stderr)
        self.kept, self.frames = kept, frames
        gained = {k: after.get(k, 0) - before.get(k, 0) for k in ("batches", "requests", "padded")}
        return Window(seconds=max(last, t0 + seconds) - t0, images=answered, attempted=n,
                      failed=failed, latencies_s=lat, server=gained)

    def answers(self):
        return [(torch.from_numpy(self.pool[self.frames[i]][None]),
                 [torch.from_numpy(np.asarray(o)) for o in outs])
                for i, outs in sorted(self.kept.items())]

    def per_forward(self) -> Optional[dict]:
        return None  # served: the traced slice of the window says it

    def close(self) -> None:
        if self.server is not None:
            self.server.stop()
        self.server = self.pool = self.kept = None


KINDS = {"offline": Offline, "closed": Closed, "open": Open}


def loop_for(kind: str):
    if kind not in KINDS:
        raise KeyError(f"unknown traffic kind {kind!r} (known: {', '.join(KINDS)})")
    return KINDS[kind]


def percentile(values: List[float], pct: float) -> float:
    """numpy's linear percentile."""
    return float(np.percentile(np.asarray(values, np.float64), pct))
