"""device_idle_pct: 1 - the union of the device operations' intervals over
their span, in a traced slice of the window."""

from hbench.reduce import idle_pct


def read(run):
    return idle_pct(run)
