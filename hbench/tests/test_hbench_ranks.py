"""A cell over several cards, on the CPU: two gloo ranks on mesh (2, 1)
through the launcher (hbench/ranks.py) and the offline_dp loop. A sound run
prints one result line, correct, with the same number of calls on both
ranks; a fault planted in one rank's timed path, or the exchange between
the cards left out, turns `correct` false; a rank that exits mid-window
ends the run without a result and leaves no process behind."""

from __future__ import annotations

import json
import os
import time

import pytest

from hbench import harness, ranks, reduce, run, spec
from hbench.counts import PEAK_INT8_OPS, Counts
from hbench.faults import FAULTS
from hbench.tests.small import SEED, small_cell
from hbench.traffic import Window

NAME = "mnv1-u8-dp4-b128"


def _launch(fault=None, fault_rank=1, seed=SEED) -> ranks.Launched:
    return ranks.launch(small_cell(NAME), seed, 0.4, False, "cpu", ranks.boot_now(),
                        fault=fault, fault_rank=fault_rank, deadline_s=240.0)


def test_two_ranks_correct_one_result_line(capfd):
    t0 = time.perf_counter()
    rc = run.report(small_cell(NAME), SEED, 0.4, False, "cpu", lambda: time.perf_counter() - t0)
    out, err = capfd.readouterr()
    assert rc == 0, err[-3000:]
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 2
    assert set(line["metrics"]) == {"img_per_s", "setup_s"}
    checks = line["checks"]
    # both ranks made the window's calls, calibrated alike and answered alike
    for name in ("ranks_calls_spread", "ranks_grid_diffs", "ranks_out_gap"):
        assert checks[name] == {"value": 0.0, "limit": 0}, checks
    assert line["attempted"] > 0 and line["attempted"] % 4 == 0
    assert "[rank 1]" in err


# each fault the cell can have, in rank 1's timed path; the exchange between
# the cards left out on every rank (on one alone, its peers would wait for it)
@pytest.mark.parametrize("fault,fault_rank", [(f, 1) for f in sorted(FAULTS)]
                         + [("no_exchange", -1)])
def test_broken_timed_path_is_not_correct(fault, fault_rank):
    got = _launch(fault=fault, fault_rank=fault_rank)
    assert got.rcs == [0, 0] and got.out is not None
    assert not got.out["correct"], got.out["checks"]
    assert got.out["numbers"]["ranks_calls_spread"] == 0


def test_rank_that_exits_mid_window_ends_the_run(capfd):
    got = _launch(fault="exits")
    err = capfd.readouterr().err
    assert got.out is None
    assert got.rcs[1] == 13 and got.rcs[0] != 0, got.rcs
    assert "no result" in err
    assert ranks.leftovers(got.pids) == []
    for pid in got.pids:  # reaped as well
        with pytest.raises(ChildProcessError):
            os.waitpid(pid, os.WNOHANG)


@pytest.mark.parametrize("chips", [1, 4])
def test_mfu_pct_over_the_cards(chips):
    """One card reads what it read before cards were counted; four read a
    quarter of that."""
    r = harness.Run(cell="x", batch=128, counts=Counts(1_137_000_000, 1, 1), chips=chips,
                    window=Window(seconds=51.37, images=510_592, attempted=510_592, failed=0))
    before = 100.0 * r.counts.ops_per_image * r.window.images / r.window.seconds / PEAK_INT8_OPS
    if chips == 1:
        assert reduce.mfu_pct(r) == before
    else:
        assert reduce.mfu_pct(r) == pytest.approx(before / 4, rel=1e-15)


def test_gather_ms_leaves_out_the_slice_ends():
    """One collective's device ms over the traced slice: the few at each end,
    which wait on a peer's tracer starting or stopping, are left out."""
    from hbench import trace

    spans = [(1000.0 * i, 1000.0 * i + 20.0) for i in range(40)]
    spans[0], spans[-1] = (0.0, 900.0), (39000.0, 39800.0)
    assert trace.gather_ms(list(reversed(spans))) == pytest.approx(0.020)
    assert trace.gather_ms(spans[:2 * trace.EDGE_GATHERS]) is None


@pytest.mark.parametrize("rows", [None, 128, 32])
def test_fwd_roofline_over_the_rows_of_a_rank(rows):
    """On a mesh the roofline is of rank 0's share of the rows; a cell on one
    card reads what it read before ranks had rows."""
    read = spec.load_reader("fwd_roofline")
    c = Counts(1_137_000_000, 9_000_000, 4_200_000)
    r = harness.Run(cell="x", batch=128, counts=c, rows=rows, per_fwd={"busy_ms": 3.2})
    assert read(r) == 100.0 * c.least_s(rows or r.batch) / (3.2 / 1e3)


def test_gather_ms_reads_the_slice():
    read = spec.load_reader("gather_ms")
    r = harness.Run(cell="x", batch=128, counts=None, per_fwd={"busy_ms": 3.2})
    assert read(r) is None
    r.slice = {"busy_s": 1.9, "window_s": 2.0, "gather_ms": 0.0123}
    assert read(r) == 0.0123


def test_steps_apart():
    import torch

    from hbench.traffic import _steps_apart

    a = [torch.tensor([[3, 200]], dtype=torch.uint8)]
    assert _steps_apart(a, [a[0].clone()]) == 0.0
    assert _steps_apart(a, [torch.tensor([[3, 197]], dtype=torch.uint8)]) == 3.0
    assert _steps_apart(a, [torch.zeros((2, 2), dtype=torch.uint8)]) == float("inf")
    assert _steps_apart(a, None) == float("inf") and _steps_apart(None, None) == 0.0
