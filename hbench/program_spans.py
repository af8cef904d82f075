"""The program's own spans (tengine_tpu_torch/utils/trace.py) in a run: the
recording of the measured window, the device's idle time split by the
program span the host was in, and the numbers read from both.

    rec = program_spans.start()            # right before the window
    window = loop.window(seconds, slice)
    run.program = program_spans.stop(rec)  # the program's Trace, or None

    slice_dict["idle_by_span"] = program_spans.idle_in_slice(prof, device_spans)

The harness calls none of this yet: BENCHMARK.json names no metric that
reads it, and a metric needs the two calls above in hbench/harness.py and
hbench/trace.py (PERF.md, Open questions). Against a program without the
recorder, start() returns None, the names are none, every idle piece goes
to "none", and each reader returns None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

NONE = "none"  # idle with no program span on any traced thread
# the program spans whose idle time a metric reads
TRANSFER = ("engine.copy_in", "engine.download")
REPLAY = ("engine.replay",)


def start():
    """Starts the program's recorder: the recorder's module, or None where
    the program has none."""
    try:
        from tengine_tpu_torch.utils import trace
    except ImportError:
        return None
    trace.start()
    return trace


def stop(recorder):
    """The recording's Trace, or None without a recorder."""
    return recorder.stop() if recorder is not None else None


def mirrored_names() -> frozenset:
    """The names of the program spans that lie on torch.profiler's host
    timeline; none where the program has no recorder."""
    try:
        from tengine_tpu_torch.utils.trace import MIRRORED
    except ImportError:
        return frozenset()
    return MIRRORED


def _innermost(host: Iterable[Tuple[float, float, str]], names) -> List[Tuple[float, float, str]]:
    """The timeline cut at every edge of the host events named in `names`:
    disjoint (lo, hi, name) pieces, by start, each under the innermost
    event that covers it (the latest start; on a tie the shorter)."""
    ev = sorted((s, e, n) for s, e, n in host if n in names and e > s)
    points = sorted({p for s, e, _ in ev for p in (s, e)})
    out: List[Tuple[float, float, str]] = []
    active: List[Tuple[float, float, str]] = []
    i = 0
    for lo, hi in zip(points, points[1:]):
        while i < len(ev) and ev[i][0] <= lo:
            active.append(ev[i])
            i += 1
        active = [a for a in active if a[1] > lo]
        if not active:
            continue
        name = max(active, key=lambda a: (a[0], -a[1]))[2]
        if out and out[-1][2] == name and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi, name)
        else:
            out.append((lo, hi, name))
    return out


def idle_by_span(device_spans: Sequence[Tuple[float, float]],
                 host_events: Iterable[Tuple[float, float, str]], names) -> Dict[str, float]:
    """The device's idle time, in seconds, by program span: every gap
    between the device operations `device_spans` ((start, end) in us, by
    start; hbench.trace.union's gaps) cut exactly at the edges of the host
    events (start, end, name) named in `names`, each piece to the innermost
    one that covers it, else to "none". The parts sum to the idle time."""
    from hbench.trace import union

    _, gaps = union(list(device_spans))
    segs = _innermost(host_events, names)
    out: Dict[str, float] = defaultdict(float)
    out[NONE] = 0.0
    j = 0
    for lo, hi in gaps:
        while j < len(segs) and segs[j][1] <= lo:
            j += 1
        t, k = lo, j
        while t < hi:
            if k < len(segs) and segs[k][0] < hi:
                s_lo, s_hi, name = segs[k]
                if s_lo > t:
                    out[NONE] += s_lo - t
                    t = s_lo
                end = min(s_hi, hi)
                out[name] += end - t
                t = end
                k += 1
            else:
                out[NONE] += hi - t
                t = hi
    return {k: v / 1e6 for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def idle_in_slice(prof, device_spans: Sequence[Tuple[float, float]]) -> Dict[str, float]:
    """idle_by_span over a traced slice: `prof` its torch.profiler session,
    `device_spans` the device operations' intervals that the slice's
    busy time is the union of."""
    from hbench.trace import _host_events

    host = [(e.time_range.start, e.time_range.end, e.name) for e in _host_events(prof)]
    return idle_by_span(device_spans, host, mirrored_names())


def _trace(run):
    return getattr(run, "program", None)


def mean_span_ms(run, name: str) -> Optional[float]:
    """The mean duration of the window's spans `name`, in ms."""
    t = _trace(run)
    spans = t.named(name) if t is not None else []
    return sum(s.ms for s in spans) / len(spans) if spans else None


def queue_wait_ms(run) -> Optional[float]:
    """server.queue_wait_ms: a request's mean wait from submit to its
    batch's collection (the batching window included)."""
    return mean_span_ms(run, "server.queue")


def batch_ms(run) -> Optional[float]:
    """server.batch_ms: the mean time the server's loop holds a batch, from
    its collection to its last future set."""
    return mean_span_ms(run, "server.batch")


def idle_pct_under(run, names: Sequence[str]) -> Optional[float]:
    """The share of the traced slice, in %, that the device sat idle while
    the host was inside one of the program spans `names` (innermost)."""
    s = run.slice
    if _trace(run) is None or not s or "idle_by_span" not in s or s["window_s"] <= 0:
        return None
    return 100.0 * sum(s["idle_by_span"].get(n, 0.0) for n in names) / s["window_s"]
