"""The PyTorch port's continuous-batching server (parallel/serving.py) on
the CPU against the JAX package's InferenceServer and against a batch-1
CompiledGraph.

Graphs: tests/test_execute_small.py's conv graph, float with small-integer
weights and inputs (every product and sum exact in float32, so both
engines and every batch size give the same bits), and UINT8 (quantized by
the JAX package, read by the port from its tmfile bytes). Twelve requests
each, answered at 0 LSB equal to the JAX server's answers and to the
port's batch-1 forward; the requests share fewer than twelve batches.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.parallel.serving import InferenceServer as JaxServer  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402
from tengine_tpu.utils.config import Options as JaxOptions  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.parallel.serving import InferenceServer, _bucket  # noqa: E402

from test_execute_small import make_conv_graph  # noqa: E402

N_REQUESTS = 12


@pytest.mark.parametrize("n,max_batch,want", [(1, 32, 1), (3, 32, 4), (32, 32, 32),
                                              (60, 32, 32), (5, 4, 4), (2, 1, 1)])
def test_bucket(n, max_batch, want):
    assert _bucket(n, max_batch) == want


def _float_graph(rng):
    jg, _, _ = make_conv_graph(in_shape=(1, 3, 8, 8), out_c=4, rng=rng)
    for t in jg.tensors:
        if t.data is not None:
            t.data = rng.integers(-3, 4, t.data.shape).astype(np.float32)
    xs = [rng.integers(-4, 5, (1, 3, 8, 8)).astype(np.float32) for _ in range(N_REQUESTS)]
    return jg, xs, dict(precision="fp32")


def _uint8_graph(rng):
    jg, _, _ = make_conv_graph(in_shape=(1, 3, 8, 8), out_c=8, rng=rng)
    calib = [rng.standard_normal((1, 3, 8, 8)).astype(np.float32) for _ in range(2)]
    jqg = jax_quantize(jg, calib, scheme="uint8")
    t_in = jqg.tensors[jqg.input_tensors[0]]
    xs = [jq.quantize_np(rng.standard_normal((1, 3, 8, 8)).astype(np.float32), t_in.quant,
                         t_in.dtype) for _ in range(N_REQUESTS)]
    return jqg, xs, dict(quant_mode="fast")


def _serve(server, xs):
    server.start()
    try:
        futs = [server.submit(x) for x in xs]
        return [f.result(timeout=120) for f in futs]
    finally:
        server.stop()


@pytest.mark.parametrize("graph", ["float", "uint8"])
def test_server_answers_equal_jax_and_batch_1(graph, rng):
    jg, xs, opts = {"float": _float_graph, "uint8": _uint8_graph}[graph](rng)
    g = pt.load_tm_bytes(graph_to_tm_bytes(jg))
    server = InferenceServer(g, pt.Options(**opts), max_batch=8, max_wait_ms=20.0,
                             device="cpu")
    answers = _serve(server, xs)
    want = _serve(JaxServer(jg, JaxOptions(**opts), max_batch=8, max_wait_ms=20.0), xs)
    one = pt.compile_graph(g, pt.Options(**opts, batch_size=1), device="cpu")
    assert server.stats["requests"] == N_REQUESTS
    assert server.stats["batches"] < N_REQUESTS, "requests should have been batched"
    for x, got, w in zip(xs, answers, want):
        (o,) = got
        (b,) = one.run(x)
        assert o.shape == b.shape and o.dtype == b.dtype
        np.testing.assert_array_equal(o, b)
        np.testing.assert_array_equal(o, np.asarray(w[0]))
    assert all(cg.options.batch_size == b for b, cg in server._compiled.items())


@pytest.mark.parametrize("graph", ["float", "uint8"])
def test_buckets_share_equal_params(graph, rng):
    """Each bucket compiles at its batch size; a param equal to the first
    bucket's is the first bucket's tensor, and only an equal one is."""
    jg, _, opts = {"float": _float_graph, "uint8": _uint8_graph}[graph](rng)
    server = InferenceServer(pt.load_tm_bytes(graph_to_tm_bytes(jg)), pt.Options(**opts),
                             device="cpu")
    first, second = server._get_compiled(1), server._get_compiled(4)
    assert (first.options.batch_size, second.options.batch_size) == (1, 4)
    shared = [k for k, v in second.params.items() if v is first.params.get(k)]
    assert shared
    for k, v in second.params.items():
        if k in first.params:
            assert (v is first.params[k]) == torch.equal(v, first.params[k]), k


def test_latency_stats_have_the_jax_keys(rng):
    jg, xs, opts = _float_graph(rng)
    server = InferenceServer(pt.load_tm_bytes(graph_to_tm_bytes(jg)), pt.Options(**opts),
                             max_batch=4, max_wait_ms=1.0, device="cpu")
    assert server.latency_stats() == {}
    _serve(server, xs)
    jserver = JaxServer(jg, JaxOptions(**opts), max_batch=4, max_wait_ms=1.0)
    _serve(jserver, xs)
    st = server.latency_stats()
    assert st.keys() == jserver.latency_stats().keys()
    assert st["count"] == N_REQUESTS
    assert 0 < st["p50_ms"] <= st["p90_ms"] <= st["p99_ms"]


def test_submit_takes_one_request(rng):
    jg, xs, opts = _float_graph(rng)
    server = InferenceServer(pt.load_tm_bytes(graph_to_tm_bytes(jg)), pt.Options(**opts),
                             device="cpu")
    with pytest.raises(ValueError, match="one request"):
        server.submit(np.zeros((2, 3, 8, 8), np.float32))
    answer = _serve(server, [xs[0][0]])  # [C, H, W] takes a batch axis
    assert answer[0][0].shape == (1, 4, 8, 8)


def test_a_failed_batch_fails_its_requests_and_the_loop_serves_on(rng):
    jg, xs, opts = _float_graph(rng)
    server = InferenceServer(pt.load_tm_bytes(graph_to_tm_bytes(jg)), pt.Options(**opts),
                             max_batch=1, device="cpu")
    server.start()
    try:
        bad = server.submit(np.zeros((1, 5, 8, 8), np.float32))  # 5 channels, not 3
        with pytest.raises(Exception):
            bad.result(timeout=120)
        (o,) = server.submit(xs[0]).result(timeout=120)
    finally:
        server.stop()
    np.testing.assert_array_equal(o, pt.compile_graph(server.graph, pt.Options(**opts),
                                                      device="cpu").run(xs[0])[0])
