"""fwd_roofline: the forward's least time on the published peaks,
max(ops / 1,979 TOP/s, bytes / 3.35 TB/s) from hbench/counts.py, over the
device-busy time of one forward (the union of its device operations); on a
mesh, of rank 0's forward over its share of the rows."""

from hbench.reduce import per_fwd


def read(run):
    busy = per_fwd(run, "busy_ms")
    if not busy:
        return None
    return 100.0 * run.counts.least_s(run.rows or run.batch) / (busy / 1e3)
