"""Faults planted in the program to show that the comparison catches them:
each of FAULTS wraps the outputs of CompiledGraph.__call__ (the call that
every traffic mix's loop reaches, the server's and each rank's
ShardedGraph's included); `no_exchange` leaves out the exchange between
cards; `calib_minmax` breaks the program's calibration, and is planted
around the whole run, its set-up included. `plant(name)` returns a context
manager that swaps the call for a broken one and restores it. The ENDINGS
end the process instead."""

from __future__ import annotations

import contextlib
import os


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


def exits(outs, state):
    """A process that ends mid-run, at its third call: a run over several
    cards has to end without a result, leaving no process behind."""
    state["calls"] = state.get("calls", 0) + 1
    if state["calls"] >= 3:
        os._exit(13)
    return outs


# faults that no comparison reads: the run has to fail
ENDINGS = {"exits": exits}


def no_exchange(x, dim, group, size):
    """The exchange between cards left out: in place of the mesh's
    all-gather, this rank's own rows in every rank's place."""
    import torch

    return torch.cat([x] * size, dim) if size > 1 else x


@contextlib.contextmanager
def _swapped(owner, attr: str, value):
    real = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, real)


def plant(name: str):
    """A context manager inside which CompiledGraph.__call__ is broken by
    fault `name`, or, for `no_exchange`, the mesh's all-gather
    (parallel/sharding.py:all_gather_dim, which ShardedGraph calls) left
    out, or, for `calib_minmax`, the program's KL thresholds replaced by
    MinMax's (every grid of a KL configuration at max |x|)."""
    if name == "calib_minmax":
        from tengine_tpu_torch.quantize import quantizer

        return _swapped(quantizer, "kl_int8", quantizer.minmax_int8)
    if name == "no_exchange":
        from tengine_tpu_torch.parallel import sharding

        return _swapped(sharding, "all_gather_dim", no_exchange)
    from tengine_tpu_torch.executor.engine import CompiledGraph

    real, fault, state = CompiledGraph.__call__, {**FAULTS, **ENDINGS}[name], {}

    def broken(self, *inputs):
        return fault(real(self, *inputs), state)

    return _swapped(CompiledGraph, "__call__", broken)
