"""launches_per_fwd: device operations of one call, from a trace of calls
made back to back after the window (copies in and out included)."""

from hbench.reduce import per_fwd


def read(run):
    return per_fwd(run, "launches")
