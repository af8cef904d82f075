"""The port's span recorder (utils/trace.py) and the spans inside its
engine, calibration and server, on the CPU.

Off, the default, a span site returns the shared no-op and nothing is
kept. On, spans carry their parents (self time is the duration less the
children's cover), every served request has one server.queue span and one
batch, and queue + batch is the request's latency as the server times it.
Under torch.profiler the spans are mirrored as record_function ranges with
the same names and nesting; without it nothing is mirrored. No test here
asserts a duration. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_trace.py
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from tengine_tpu_torch.executor.engine import compile_graph  # noqa: E402
from tengine_tpu_torch.graph.ir import DType, Graph, TensorType  # noqa: E402
from tengine_tpu_torch.parallel.serving import InferenceServer  # noqa: E402
from tengine_tpu_torch.quantize.quantizer import quantize_graph  # noqa: E402
from tengine_tpu_torch.utils import trace  # noqa: E402
from tengine_tpu_torch.utils.config import Options  # noqa: E402

N_REQUESTS = 24


@pytest.fixture(autouse=True)
def no_recording():
    trace.stop()
    yield
    trace.stop()


def conv_graph(rng) -> Graph:
    """data [1, 3, 8, 8] -> 3x3 conv to 4 channels, float."""
    g = Graph(name="trace_conv")
    x = g.add_tensor("data", DType.FP32, (1, 3, 8, 8), TensorType.INPUT)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    wt = g.add_tensor("w", DType.FP32, w.shape, TensorType.CONST, data=w)
    bt = g.add_tensor("b", DType.FP32, b.shape, TensorType.CONST, data=b)
    y = g.add_tensor("y", DType.FP32, [], TensorType.VAR)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    g.add_node("Convolution", "conv", [x.idx, wt.idx, bt.idx], [y.idx],
               params=dict(kernel_h=3, kernel_w=3, stride_h=1, stride_w=1, dilation_h=1,
                           dilation_w=1, input_channel=3, output_channel=4, group=1,
                           activation=-1, pad_h0=1, pad_w0=1, pad_h1=1, pad_w1=1))
    g.inputs = [inp.idx]
    g.outputs = [g.nodes[-1].idx]
    return g


def images(rng, n):
    return [rng.standard_normal((1, 3, 8, 8)).astype(np.float32) for _ in range(n)]


def test_off_records_nothing():
    rng = np.random.default_rng(0)
    assert trace.span(trace.ENGINE_CALL) is trace.OFF
    assert trace.span(trace.SERVER_BATCH, start_ns=trace.now(), ids=(1,)) is trace.OFF
    with trace.span(trace.ENGINE_RUN) as s:
        assert s is trace.OFF
    trace.record(trace.SERVER_QUEUE, 0, 1, ids=(0,))
    cg = compile_graph(conv_graph(rng), Options(), device="cpu")
    cg.run(images(rng, 1)[0])
    assert trace.stop().spans == []


def test_parents_and_self_time_nested():
    trace.start()
    with trace.span(trace.ENGINE_RUN) as run:
        with trace.span(trace.ENGINE_CALL) as call:
            with trace.span(trace.ENGINE_REPLAY):
                pass
        with trace.span(trace.ENGINE_DOWNLOAD):
            pass
    t = trace.stop()
    assert trace.span(trace.ENGINE_RUN) is trace.OFF
    by = {s.name: s for s in t.spans}
    assert by[trace.ENGINE_RUN].parent is None
    assert by[trace.ENGINE_CALL].parent == run.id == by[trace.ENGINE_RUN].id
    assert by[trace.ENGINE_REPLAY].parent == call.id
    assert by[trace.ENGINE_DOWNLOAD].parent == run.id
    for s in t.spans:
        assert s.end_ns >= s.start_ns
    summ = t.summary()
    ns = {s.name: s.end_ns - s.start_ns for s in t.spans}
    want_run = ns[trace.ENGINE_RUN] - ns[trace.ENGINE_CALL] - ns[trace.ENGINE_DOWNLOAD]
    assert summ[trace.ENGINE_RUN]["self_ms"] == pytest.approx(want_run / 1e6, abs=1e-9)
    assert summ[trace.ENGINE_REPLAY]["self_ms"] == summ[trace.ENGINE_REPLAY]["total_ms"]


def test_summary_of_hand_made_spans():
    """Self time is the duration less the union of the children's cover,
    clipped to the parent; count, total and mean per name."""
    S = trace.Span
    t = trace.Trace([
        S("b", 0, 100_000_000, 1, None, 0, {}),
        S("c", 10_000_000, 30_000_000, 2, 1, 0, {}),
        S("c", 20_000_000, 50_000_000, 3, 1, 1, {}),  # overlaps its sibling
        S("c", 90_000_000, 120_000_000, 4, 1, 1, {}),  # past the parent's end
        S("b", 200_000_000, 210_000_000, 5, None, 0, {}),
    ])
    s = t.summary()
    assert s["b"] == {"count": 2, "total_ms": 110.0, "self_ms": 110.0 - 40.0 - 10.0,
                      "mean_ms": 55.0}
    assert s["c"]["count"] == 3 and s["c"]["total_ms"] == pytest.approx(80.0)
    assert s["c"]["self_ms"] == pytest.approx(80.0)
    assert [x.id for x in t.named("c")] == [2, 3, 4]


def test_engine_and_compile_spans_on_the_cpu():
    rng = np.random.default_rng(1)
    g = conv_graph(rng)
    trace.start()
    qg = quantize_graph(g, images(rng, 2), scheme="uint8", device="cpu")  # two batches
    cg = compile_graph(qg, Options(quant_mode="fast"), device="cpu")
    cg.run(np.full((1, 3, 8, 8), 128, np.uint8))
    t = trace.stop()
    by_id = {s.id: s for s in t.spans}
    names = Counter(s.name for s in t.spans)
    assert names[trace.QUANTIZE_COLLECT] == 1 and names[trace.QUANTIZE_REWRITE] == 1
    assert names[trace.QUANTIZE_PREPARE] == 1
    assert names[trace.QUANTIZE_FORWARD] == names[trace.QUANTIZE_OBSERVE] == 2
    for s in t.spans:
        if s.name in (trace.QUANTIZE_PREPARE, trace.QUANTIZE_FORWARD, trace.QUANTIZE_OBSERVE):
            assert by_id[s.parent].name == trace.QUANTIZE_COLLECT
    assert names[trace.COMPILE_PASSES] == names[trace.COMPILE_PREPARE] == 1
    assert names[trace.COMPILE_UPLOAD] == 1
    # the CPU runs the forward eagerly: no capture, replay or clone
    parents = {s.name: by_id[s.parent].name for s in t.spans if s.parent is not None
               and s.name.startswith("engine.")}
    assert parents == {trace.ENGINE_CALL: trace.ENGINE_RUN, trace.ENGINE_COPY_IN: trace.ENGINE_CALL,
                       trace.ENGINE_FORWARD: trace.ENGINE_CALL,
                       trace.ENGINE_DOWNLOAD: trace.ENGINE_RUN}
    assert not names[trace.ENGINE_REPLAY] and not names[trace.ENGINE_CAPTURE]


def test_server_queue_and_batch_spans():
    """One server.queue span per request, each request in one batch, and
    queue + batch = the request's latency as latency_stats samples it."""
    rng = np.random.default_rng(2)
    server = InferenceServer(conv_graph(rng), options=Options(), max_batch=4, max_wait_ms=2.0,
                             device="cpu")
    xs = images(rng, N_REQUESTS)
    server.start()
    try:
        server.submit(xs[0]).result(timeout=60)  # the buckets' compile stays outside
        server._latencies.clear()
        trace.start()
        for k in range(0, N_REQUESTS, 3):  # bursts of 3: batches of 1 to 4
            futs = [server.submit(x) for x in xs[k:k + 3]]
            for f in futs:
                f.result(timeout=60)
    finally:
        server.stop()
    assert not server._thread.is_alive()
    t = trace.stop()
    queue = t.named(trace.SERVER_QUEUE)
    batches = t.named(trace.SERVER_BATCH)
    rids = [s.attrs["ids"][0] for s in queue]
    assert len(queue) == N_REQUESTS and sorted(rids) == list(range(1, N_REQUESTS + 1))
    assert all(len(s.attrs["ids"]) == 1 and s.parent is None for s in queue)
    in_batches = [i for b in batches for i in b.attrs["ids"]]
    assert sorted(in_batches) == sorted(rids)
    assert len(batches) < N_REQUESTS
    assert server.stats["requests"] == N_REQUESTS + 1
    by_id = {s.id: s for s in t.spans}
    for s in t.spans:
        if s.name in (trace.SERVER_FORM, trace.SERVER_REPLY, trace.ENGINE_RUN):
            assert by_id[s.parent].name == trace.SERVER_BATCH
    q_of = {s.attrs["ids"][0]: s for s in queue}
    lat = iter(server._latencies)
    for b in batches:  # latencies are kept batch by batch, in the batch's order
        for rid in b.attrs["ids"]:
            q = q_of[rid]
            assert q.end_ns == b.start_ns
            assert q.ms + b.ms == pytest.approx(1e3 * next(lat), abs=0.5)
    assert next(lat, None) is None


def test_mirrored_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    cg = compile_graph(conv_graph(rng), Options(), device="cpu")
    x = images(rng, 1)[0]
    cg.run(x)
    trace.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cg.run(x)
        trace.record(trace.SERVER_QUEUE, trace.now() - 1000, trace.now(), ids=(0,))
    t = trace.stop()
    spans = {s.name: s for s in t.spans}
    by_id = {s.id: s for s in t.spans}
    events = {e.name: e for e in prof.events() if e.name in trace.MIRRORED
              or e.name == trace.SERVER_QUEUE}
    assert set(events) == set(spans) - {trace.SERVER_QUEUE}
    for name, e in events.items():
        parent = by_id[spans[name].parent].name if spans[name].parent else None
        assert (e.cpu_parent.name if e.cpu_parent is not None else None) == parent, name


def test_nothing_mirrored_without_the_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"{name} mirrored with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rng = np.random.default_rng(4)
    cg = compile_graph(conv_graph(rng), Options(), device="cpu")
    trace.start()
    cg.run(images(rng, 1)[0])
    assert {s.name for s in trace.stop().spans} >= {trace.ENGINE_RUN, trace.ENGINE_CALL}
