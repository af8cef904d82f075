"""The one traffic generator and the loops that drive the program with it.

A traffic mix is a file of parameters (hbench/traffic/<name>.json) whose
`kind` picks one of three loops:

  offline  batches of `batch` images dispatched back to back through
           CompiledGraph.__call__ from a ring of `ring` distinct batches
           already on the card, at most `inflight` batches queued ahead;
           the window ends at a synchronize;
  offline_dp
           the same over the ranks of a (data, model) `mesh`, one process
           a card (hbench/ranks.py): every rank holds the ring of global
           batches and calls the port's ShardedGraph (shard_compiled) on
           them, which runs the rank's rows and all-gathers the outputs;
           every rank makes the same number of calls, agreed before the
           window from rank 0's rate so far; rank 0's clock times it, and
           every rank traces the slice (the cards' readings averaged);
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
route a user gets by default. A loop that runs over several ranks also
compares their readings (Loop.across).
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

    ranks = 1  # processes that run the window, one a card

    @property
    def rows(self) -> int:
        """The rows of one rank's forward."""
        return self.batch

    def slice_at(self, seconds: float) -> tracing.Slice:
        """The traced slice: `trace_slice_s` in the middle of the window."""
        length = min(float(self.tr["trace_slice_s"]), 0.5 * seconds)
        return tracing.Slice(0.5 * (seconds - length), length, self.device)

    def across(self, peak: int, sliced: Optional[dict]):
        """The peak memory of the fullest card, the traced slice's reduction
        with its busy and traced seconds averaged over the cards, and the
        numbers that compare the ranks' readings with rank 0's (none on one
        card; None on a rank that leaves the judging to rank 0)."""
        return peak, sliced, {}


class Offline(Loop):
    def setup(self) -> float:
        from tengine_tpu_torch.executor.engine import compile_graph

        b, r = self.batch, int(self.tr["ring"])
        x = self.make(b * r)
        self.ring = [x[i * b:(i + 1) * b].contiguous() for i in range(r)]
        t = time.perf_counter()
        self.cg = self.compiled(compile_graph(self.qg, _options(b), device=self.device))
        self.cg(self.ring[0])  # warm-up forward and the capture
        _sync(self.device)
        compile_s = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(2):
            for xb in self.ring:
                self.cg(xb)
        _sync(self.device)
        self.rate = 2 * r / (time.perf_counter() - t)  # calls a second so far
        self.window(float(self.tr["warm_s"]), None)
        return compile_s

    def compiled(self, cg):
        """What the loop calls: the CompiledGraph itself."""
        return cg

    def window(self, seconds: float, sl: Optional[tracing.Slice]) -> Window:
        return self.drive(lambda calls, el: el < seconds, sl)

    def drive(self, more: Callable[[int, float], bool], sl: Optional[tracing.Slice]) -> Window:
        """Calls back to back while `more(calls made, seconds elapsed)`."""
        cuda = self.device.type == "cuda"
        inflight = int(self.tr["inflight"])
        self.last = [None] * len(self.ring)
        pending: List = []
        calls = 0
        t0 = time.perf_counter()
        while True:
            el = time.perf_counter() - t0
            if not more(calls, el):
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


class OfflineDP(Offline):
    """offline_dp: the offline loop on every rank of a process group that
    init_distributed set up, through shard_compiled on the mix's mesh."""

    def setup(self) -> float:
        import torch.distributed as dist

        self.rank, self.ranks = dist.get_rank(), dist.get_world_size()
        # the harness's own messages (counts, readings) go by the host
        self.host = dist.new_group(backend="gloo")
        self.grid_diffs = self._grids_differ()  # before the window
        return super().setup()

    @property
    def rows(self) -> int:
        """The rank's share of the batch: the rows split over the mesh's
        data axis."""
        return self.batch // int(self.tr["mesh"][0])

    def compiled(self, cg):
        """The rank's program on the mix's mesh."""
        from tengine_tpu_torch.parallel.mesh import make_mesh
        from tengine_tpu_torch.parallel.sharding import shard_compiled

        return shard_compiled(cg, make_mesh(shape=tuple(int(v) for v in self.tr["mesh"])))

    def _to_rank0(self, obj) -> Optional[list]:
        import torch.distributed as dist

        got = [None] * self.ranks if self.rank == 0 else None
        dist.gather_object(obj, got, dst=0, group=self.host)
        return got

    def _grids_differ(self) -> Optional[int]:
        """On rank 0: the quantized tensors whose grid (scales and zero
        points) differs on some rank from rank 0's; each rank calibrated on
        its own card."""
        mine = {t.name: (np.asarray(t.quant.scales).tobytes(),
                         np.asarray(t.quant.zero_points).tobytes())
                for t in self.qg.tensors if t.quant is not None}
        got = self._to_rank0(mine)
        if got is None:
            return None
        return len({k for g in got[1:] for k in set(g) | set(mine) if g.get(k) != mine.get(k)})

    def window(self, seconds: float, sl: Optional[tracing.Slice]) -> Window:
        """`seconds` at rank 0's rate so far, as a number of calls that
        rank 0 gives every rank; the window starts at a barrier."""
        import torch.distributed as dist

        n = [max(1, round(self.rate * seconds))]
        dist.broadcast_object_list(n, src=0, group=self.host)
        dist.barrier(group=self.host)
        w = self.drive(lambda calls, el: calls < n[0], sl)
        self.calls = n[0]
        self.rate = n[0] / w.seconds
        return w

    def answers(self):
        return super().answers() if self.rank == 0 else []

    def per_forward(self) -> Optional[dict]:
        """Rank 0 profiles its calls; every other rank makes the same calls."""
        if self.rank == 0:
            return super().per_forward()
        for _ in range(int(self.tr["profile_forwards"]) + 1):
            self.cg(self.ring[0])
        _sync(self.device)
        return None

    def across(self, peak: int, sliced: Optional[dict]):
        """The fullest card's peak; on rank 0, rank 0's slice with every
        card's busy and traced seconds and ms an all-gather averaged (every
        rank traces the same slice of the window), and how far the other
        ranks lie from rank 0: the spread of the window's calls, the
        tensors whose grid differs, and the widest gap between a rank's
        gathered outputs of the last call on each ring batch and rank 0's,
        in steps of the output grid."""
        outs = [None if o is None else [t.cpu() for t in o] for o in self.last]
        keys = ("busy_s", "window_s", "gather_ms")
        times = {k: sliced[k] for k in keys if k in sliced} if sliced else None
        got = self._to_rank0((peak, self.calls, times, outs))
        if got is None:
            return peak, sliced, None
        if sliced and all(g[2] for g in got):
            by_rank = {k: [g[2].get(k) for g in got] for k in keys}
            print(f"hbench: traced slice by rank, {by_rank}", file=sys.stderr, flush=True)
            sliced = {k: v for k, v in sliced.items() if k not in keys}
            sliced.update({k: float(np.mean(v)) for k, v in by_rank.items() if None not in v})
        gap = max((_steps_apart(a, b) for g in got[1:] for a, b in zip(outs, g[3])),
                  default=0.0)
        calls = [g[1] for g in got]
        return max(g[0] for g in got), sliced, {
            "ranks_calls_spread": float(max(calls) - min(calls)),
            "ranks_grid_diffs": float(self.grid_diffs),
            "ranks_out_gap": gap,
        }

    def close(self) -> None:
        super().close()
        self.host = None


def _steps_apart(a: Optional[list], b: Optional[list]) -> float:
    """The widest gap between two calls' outputs in steps of their integer
    grid: infinite where one is missing or their shapes differ."""
    if a is None and b is None:
        return 0.0
    if a is None or b is None or len(a) != len(b) or any(x.shape != y.shape
                                                         for x, y in zip(a, b)):
        return float("inf")
    return max((float((x.long() - y.long()).abs().max()) for x, y in zip(a, b)), default=0.0)


KINDS = {"offline": Offline, "offline_dp": OfflineDP, "closed": Closed, "open": Open}


def loop_for(kind: str):
    if kind not in KINDS:
        raise KeyError(f"unknown traffic kind {kind!r} (known: {', '.join(KINDS)})")
    return KINDS[kind]


def percentile(values: List[float], pct: float) -> float:
    """numpy's linear percentile."""
    return float(np.percentile(np.asarray(values, np.float64), pct))
