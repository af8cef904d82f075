"""b1_p95_ms: the 95th percentile of one client's closed loop at batch 1
through CompiledGraph.run, host clock."""

from hbench.reduce import latency_ms


def read(run):
    return latency_ms(run, 95.0)
