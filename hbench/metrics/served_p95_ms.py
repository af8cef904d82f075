"""served_p95_ms: the 95th percentile of the open loop's requests, each timed
from when it was due to its future's result (host clock)."""

from hbench.reduce import latency_ms


def read(run):
    return latency_ms(run, 95.0)
