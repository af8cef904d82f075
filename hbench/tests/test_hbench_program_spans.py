"""The program's spans as the benchmark reads them (hbench/program_spans.py):
the device's idle time split by program span on synthetic intervals, the
readers on hand-made runs, and a program without the recorder."""

from __future__ import annotations

import sys

import pytest
import torch

from hbench import harness, program_spans, result
from hbench.tests.small import SEED, run_small, small_cell

# device operations (us): idle 10-20, 30-50, 60-100
DEVICE = [(0.0, 10.0), (20.0, 30.0), (50.0, 60.0), (100.0, 110.0)]
NAMES = {"engine.run", "engine.replay", "engine.download"}


def test_idle_by_span_nested_straddling_and_uncovered():
    host = [
        (5.0, 45.0, "engine.run"),
        (12.0, 18.0, "engine.replay"),  # inside engine.run
        (40.0, 70.0, "engine.download"),  # the gap 30-50 straddles run and download
        (0.0, 200.0, "cudaMemcpyAsync"),  # not a program span
    ]
    got = program_spans.idle_by_span(DEVICE, host, NAMES)
    assert got == pytest.approx({"engine.run": 14e-6, "engine.replay": 6e-6,
                                 "engine.download": 20e-6, "none": 30e-6}, abs=1e-15)
    assert sum(got.values()) == pytest.approx(70e-6, rel=1e-12)


def test_idle_by_span_without_program_spans():
    got = program_spans.idle_by_span(DEVICE, [(0.0, 200.0, "hbench.run")], NAMES)
    assert got == {"none": pytest.approx(70e-6)}
    assert program_spans.idle_by_span(DEVICE, [], frozenset()) == {"none": pytest.approx(70e-6)}


def test_idle_by_span_overlapping_threads_and_edges():
    """Spans of two threads overlap: the later start is innermost. A span
    that ends where a gap begins, or begins where it ends, takes none of
    it; the parts still sum to the idle time exactly."""
    device = [(0.0, 1.0), (4.0, 5.0), (9.0, 9.5)]
    host = [(1.0, 9.0, "server.batch"), (2.0, 3.0, "engine.copy_in"),
            (2.5, 8.0, "engine.download"), (0.5, 1.0, "engine.replay"),
            (9.0, 9.5, "engine.replay")]
    got = program_spans.idle_by_span(device, host, program_spans.mirrored_names())
    assert got == pytest.approx({"server.batch": 1.0e-6 + 1.0e-6, "engine.copy_in": 0.5e-6,
                                 "engine.download": 1.5e-6 + 3.0e-6, "none": 0.0}, abs=1e-15)
    assert sum(got.values()) == pytest.approx(7.0e-6, rel=1e-12)


def _hand_made_run():
    from tengine_tpu_torch.utils import trace

    S = trace.Span
    run = harness.Run(cell="x", batch=1, counts=None)
    run.program = trace.Trace([
        S("server.queue", 0, 4_000_000, 1, None, 1, {"ids": (0,)}),
        S("server.queue", 1_000_000, 4_000_000, 2, None, 1, {"ids": (1,)}),
        S("server.batch", 4_000_000, 24_000_000, 3, None, 1, {"ids": (0, 1)}),
        S("server.queue", 20_000_000, 30_000_000, 4, None, 1, {"ids": (2,)}),
        S("server.batch", 30_000_000, 40_000_000, 5, None, 1, {"ids": (2,)}),
    ])
    run.slice = {"busy_s": 0.6, "window_s": 2.0, "device_ops": [], "idle_gaps": [],
                 "idle_by_span": {"engine.copy_in": 0.05, "engine.download": 0.15,
                                  "engine.replay": 0.1, "engine.call": 0.02, "none": 1.08}}
    return run


def test_readers_on_a_hand_made_run():
    run = _hand_made_run()
    assert program_spans.queue_wait_ms(run) == pytest.approx((4.0 + 3.0 + 10.0) / 3)
    assert program_spans.batch_ms(run) == pytest.approx(15.0)
    assert program_spans.idle_pct_under(run, program_spans.TRANSFER) == pytest.approx(10.0)
    assert program_spans.idle_pct_under(run, program_spans.REPLAY) == pytest.approx(5.0)
    # the split covers the slice's idle time
    assert 100.0 * sum(run.slice["idle_by_span"].values()) / run.slice["window_s"] == \
        pytest.approx(100.0 * (1.0 - run.slice["busy_s"] / run.slice["window_s"]))


def test_readers_find_nothing_to_read():
    run = _hand_made_run()
    run.program = None  # a program without the recorder
    for read in (program_spans.queue_wait_ms, program_spans.batch_ms):
        assert read(run) is None
    assert program_spans.idle_pct_under(run, program_spans.TRANSFER) is None
    bare = harness.Run(cell="x", batch=1, counts=None)  # the harness as it stands
    assert program_spans.queue_wait_ms(bare) is None
    assert program_spans.idle_pct_under(bare, program_spans.REPLAY) is None
    run = _hand_made_run()
    del run.slice["idle_by_span"]
    assert program_spans.idle_pct_under(run, program_spans.REPLAY) is None


def test_without_the_recorder(monkeypatch):
    """With the recorder's import failing, start() and stop() give None,
    no span is mirrored, the new readers read None, and the old readers of
    a run read what they read with the recorder there."""
    import tengine_tpu_torch.utils

    before = run_small("mnv1-u8-b1", seed=SEED)["run"]
    monkeypatch.setitem(sys.modules, "tengine_tpu_torch.utils.trace", None)
    monkeypatch.delattr(tengine_tpu_torch.utils, "trace")
    rec = program_spans.start()
    assert rec is None and program_spans.stop(rec) is None
    assert program_spans.mirrored_names() == frozenset()
    out = run_small("mnv1-u8-b1", seed=SEED)
    run = out["run"]
    run.program = program_spans.stop(rec)
    assert program_spans.queue_wait_ms(run) is None and program_spans.batch_ms(run) is None
    cell = small_cell("mnv1-u8-b1")
    assert set(result.metrics(cell, run, True)) == set(result.metrics(cell, before, True))
    assert out["correct"]


@pytest.mark.parametrize("name", ["mnv1-u8-b1", "yolov5s-i8-served"])
def test_window_recorded(name):
    """The window's spans as the harness would record them: one engine.run
    a b1 call; one server.queue a served request and each request in one
    server.batch."""
    cell = small_cell(name)
    pr = harness.prepare(cell, SEED, torch.device("cpu"))
    loop = pr.loop
    try:
        loop.setup()
        rec = program_spans.start()
        w = loop.window(0.3, None)
        t = program_spans.stop(rec)
    finally:
        loop.close()
    assert t is not None
    run = harness.Run(cell=name, batch=loop.batch, counts=None, window=w)
    run.program = t
    if name == "mnv1-u8-b1":
        assert len(t.named("engine.run")) == w.attempted
        assert len(t.named("engine.download")) == w.attempted
        assert program_spans.queue_wait_ms(run) is None
    else:
        ids = sorted(s.attrs["ids"][0] for s in t.named("server.queue"))
        assert len(ids) == w.attempted == len(set(ids))
        assert sorted(i for b in t.named("server.batch") for i in b.attrs["ids"]) == ids
        assert program_spans.queue_wait_ms(run) > 0 and program_spans.batch_ms(run) > 0
