"""Spans of the port's host work, kept in memory while recording is on.

    from tengine_tpu_torch.utils import trace

    trace.start()
    ...                      # compile, run, serve
    t = trace.stop()         # a Trace
    t.summary()              # per name: count, total_ms, self_ms, mean_ms

Off, the default, a span site costs one check of a module global and
returns a shared no-op context. On, a span records its name, its start and
end on time.perf_counter_ns, an id, the id of the span open around it on
the same thread, and the thread; attributes ride along (`ids`: the
requests a server span served, so that the spans of one request share its
id). While a torch.profiler session is open in the process, each span
except server.queue also enters torch.profiler.record_function(name): it
then lies on the profiler's host timeline, on the clock of the card's
kernels and copies, and an exported chrome trace carries it. The session's
flag is read, not torch.autograd._profiler_enabled(), which is true only on
the thread that opened the session: a span on another thread (the server's
loop) is recorded where the session profiles every thread
(_ExperimentalConfig(profile_all_threads=True)).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

# Every span name, declared here once.
ENGINE_CALL = "engine.call"  # CompiledGraph.__call__, the whole call
ENGINE_COPY_IN = "engine.copy_in"  # inputs as tensors, the upload into the static inputs
ENGINE_CAPTURE = "engine.capture"  # a signature's warm-up forward and its capture
ENGINE_REPLAY = "engine.replay"  # the CUDA graph's launch
ENGINE_CLONE = "engine.clone"  # the outputs cloned out of the graph's buffers
ENGINE_FORWARD = "engine.forward"  # the eager forward (CPU, debug_nans)
ENGINE_RUN = "engine.run"  # CompiledGraph.run: the call and the download
ENGINE_DOWNLOAD = "engine.download"  # outputs to host arrays, waiting for the forward
SERVER_QUEUE = "server.queue"  # a request's submit to its batch's collection
SERVER_BATCH = "server.batch"  # a batch's collection to its last future set
SERVER_FORM = "server.form"  # the batch's inputs concatenated and padded
SERVER_REPLY = "server.reply"  # the batch's futures set
COMPILE_PASSES = "compile.passes"  # compile_graph's graph passes
COMPILE_PREPARE = "compile.prepare"  # the forward built and its prepare pass
COMPILE_UPLOAD = "compile.upload"  # the compile-time params to the device
QUANTIZE_COLLECT = "quantize.collect"  # calibration's activation ranges
QUANTIZE_PREPARE = "quantize.prepare"  # the fp32 forward built, prepared, uploaded
QUANTIZE_FORWARD = "quantize.forward"  # one calibration batch's forward
QUANTIZE_OBSERVE = "quantize.observe"  # one batch's ranges (and histograms) read
QUANTIZE_REWRITE = "quantize.rewrite"  # grids set, weights and biases quantized

# server.queue is a request's wait, not host activity: it is not mirrored
MIRRORED = frozenset({
    ENGINE_CALL, ENGINE_COPY_IN, ENGINE_CAPTURE, ENGINE_REPLAY, ENGINE_CLONE, ENGINE_FORWARD,
    ENGINE_RUN, ENGINE_DOWNLOAD, SERVER_BATCH, SERVER_FORM, SERVER_REPLY, COMPILE_PASSES,
    COMPILE_PREPARE, COMPILE_UPLOAD, QUANTIZE_COLLECT, QUANTIZE_PREPARE, QUANTIZE_FORWARD,
    QUANTIZE_OBSERVE, QUANTIZE_REWRITE,
})

now = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the span open around it on its thread
    thread: int
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Trace:
    """The spans of one recording, by start."""

    def __init__(self, spans: List[Span]):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, s.id))

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per name: count, total_ms, self_ms (each span's duration less the
        part of it its child spans cover) and mean_ms."""
        children = defaultdict(list)
        for s in self.spans:
            if s.parent is not None:
                children[s.parent].append(s)
        out: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            covered, end = 0, s.start_ns
            for c in children[s.id]:  # by start
                lo, hi = max(c.start_ns, end), min(c.end_ns, s.end_ns)
                if hi > lo:
                    covered += hi - lo
                    end = hi
            row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += s.ms
            row["self_ms"] += (s.end_ns - s.start_ns - covered) / 1e6
        for row in out.values():
            row["mean_ms"] = row["total_ms"] / row["count"]
        return out


class _Recorder:
    def __init__(self):
        self.spans: List[tuple] = []  # Span's fields: a tuple is cheaper to make
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> List[int]:
        """The ids of the spans open on this thread, innermost last."""
        try:
            return self.local.stack
        except AttributeError:
            st = self.local.stack = []
            return st


_recording: Optional[_Recorder] = None


class _Off:
    """The context every span site returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end_at(self, end_ns: int) -> None:
        pass


OFF = _Off()


class _On:
    __slots__ = ("rec", "name", "start_ns", "end_ns", "attrs", "id", "parent", "stack", "mirror")

    def __init__(self, rec: _Recorder, name: str, start_ns: Optional[int], attrs: dict):
        self.rec, self.name, self.start_ns, self.attrs = rec, name, start_ns, attrs
        self.end_ns = self.mirror = None

    def __enter__(self):
        stack = self.stack = self.rec.stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec.ids)
        stack.append(self.id)
        if self.name in MIRRORED and _profiler._is_profiler_enabled:
            self.mirror = torch.profiler.record_function(self.name)
            self.mirror.__enter__()
        if self.start_ns is None:
            self.start_ns = now()
        return self

    def __exit__(self, *exc):
        end = now() if self.end_ns is None else self.end_ns
        if self.mirror is not None:
            self.mirror.__exit__(None, None, None)
        self.stack.pop()
        self.rec.spans.append((self.name, self.start_ns, end, self.id, self.parent,
                               threading.get_ident(), self.attrs))
        return False

    def end_at(self, end_ns: int) -> None:
        """Ends the span at `end_ns` rather than at its exit."""
        self.end_ns = end_ns


def span(name: str, start_ns: Optional[int] = None, **attrs):
    """The context of span `name`, from `start_ns` where given, else from
    its entry, to its exit or the time its end_at() gives; OFF while
    recording is off."""
    rec = _recording
    if rec is None:
        return OFF
    return _On(rec, name, start_ns, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """A finished span with explicit ends and no mirror (a request's wait),
    inside the span open on this thread."""
    rec = _recording
    if rec is None:
        return
    stack = rec.stack()
    rec.spans.append((name, start_ns, end_ns, next(rec.ids), stack[-1] if stack else None,
                      threading.get_ident(), attrs))


def start() -> None:
    """Starts a recording, dropping one underway."""
    global _recording
    _recording = _Recorder()


def stop() -> Trace:
    """Ends the recording: its finished spans (none if none was underway).
    A span still open on another thread is left out."""
    global _recording
    rec, _recording = _recording, None
    return Trace([Span._make(s) for s in rec.spans] if rec is not None else [])
