"""Faults planted in the timed path to show that the comparison catches
them: each wraps the outputs of CompiledGraph.__call__ (the call that every
traffic mix's loop reaches, the server's included). `plant(name)` returns a
context manager that swaps the call for a broken one and restores it."""

from __future__ import annotations

import contextlib


def stale(outs, state):
    """A step that returns its state unchanged: every call answers with the
    first call's outputs."""
    if "first" not in state:
        state["first"] = tuple(o.clone() for o in outs)
    return state["first"]


def half_batch(outs, state):
    """Half of the batch left out: the second half's rows never computed."""
    res = []
    for o in outs:
        o = o.clone()
        o[o.shape[0] // 2:] = 0
        res.append(o)
    return tuple(res)


def altered(outs, state):
    """An answer altered where it is produced: the first row's values put
    in reverse order."""
    res = []
    for o in outs:
        o = o.clone()
        o[0] = o[0].flatten().flip(0).reshape(o[0].shape)
        res.append(o)
    return tuple(res)


def rows_swapped(outs, state):
    """Each request given another request's row of the batch."""
    return tuple(o.roll(1, dims=0) for o in outs)


FAULTS = {"stale": stale, "half_batch": half_batch, "altered": altered,
          "rows_swapped": rows_swapped}


@contextlib.contextmanager
def plant(name: str):
    """CompiledGraph.__call__ broken by fault `name` inside the block."""
    from tengine_tpu_torch.executor.engine import CompiledGraph

    real, fault, state = CompiledGraph.__call__, FAULTS[name], {}

    def broken(self, *inputs):
        return fault(real(self, *inputs), state)

    CompiledGraph.__call__ = broken
    try:
        yield
    finally:
        CompiledGraph.__call__ = real
