"""Arithmetic the metric readers share (hbench/metrics/<name>.py)."""

from __future__ import annotations

from typing import Optional

from hbench.counts import PEAK_INT8_OPS
from hbench.traffic import percentile


def mfu_pct(run) -> Optional[float]:
    """The window's int8 operations over the published peak of the cards
    it ran on: the frozen operations of one image times the images answered
    (padding rows not counted) over the window's seconds."""
    w = run.window
    if w is None or w.seconds <= 0 or not w.images:
        return None
    return 100.0 * run.counts.ops_per_image * w.images / w.seconds / (PEAK_INT8_OPS * run.chips)


def latency_ms(run, pct: float) -> Optional[float]:
    """A percentile of the window's request latencies, in ms (a failed
    request counts as slower than every answered one)."""
    lat = run.window.latencies_s if run.window is not None else None
    return 1e3 * percentile(lat, pct) if lat else None


def idle_pct(run) -> Optional[float]:
    """1 - busy / span over the traced slice of the window."""
    s = run.slice
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def per_fwd(run, key: str) -> Optional[float]:
    return run.per_fwd.get(key) if run.per_fwd else None
