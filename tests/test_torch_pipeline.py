"""The PyTorch port's actor pipeline (utils/pipeline.py, a copy of the JAX
package's) on the CPU: tests/test_pipeline.py's four cases, and stages
that call the port's CompiledGraph against the same stages on the JAX
engine. The ReLU stage's outputs are compared exactly: it computes no sum.
The UINT8 conv stage is compared at 0 LSB: both engines run the quantized
conv's integer arithmetic to the same codes on this graph
(tests/test_torch_tm2_writer.py's quantized round trip holds the same).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.graph.ir import DType, Graph, TensorType  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402
from tengine_tpu.utils.pipeline import Pipeline as JaxPipeline  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.utils.pipeline import Pipeline  # noqa: E402

from test_execute_small import make_conv_graph  # noqa: E402


def test_pipeline_stages_and_order():
    p = Pipeline()
    src = p.source(range(10))
    doubled = p.node(lambda x: x * 2, src, name="double")
    shifted = p.node(lambda x: x + 1, doubled, name="inc")
    assert p.run_to_list(shifted) == [i * 2 + 1 for i in range(10)]


def test_pipeline_filter_and_fanout():
    p = Pipeline()
    src = p.source(range(8))
    evens = p.node(lambda x: x if x % 2 == 0 else None, src)  # filter
    dup = p.node(lambda x: [x, x], evens)  # fan-out
    assert p.run_to_list(dup) == [0, 0, 2, 2, 4, 4, 6, 6]


def test_pipeline_error_propagates():
    p = Pipeline()
    src = p.source([1, 2, 3])

    def boom(x):
        if x == 2:
            raise ValueError("boom")
        return x

    out_e = p.node(boom, src)
    with pytest.raises(ValueError, match="boom"):
        p.run_to_list(out_e)


def _relu_graph():
    g = Graph(name="pipe")
    x = g.add_tensor("x", DType.FP32, [1, 4], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    y = g.add_tensor("y", DType.FP32, [], TensorType.VAR)
    g.add_node("ReLu", "r", [x.idx], [y.idx], params=dict(negative_slope=0.0))
    g.inputs, g.outputs = [inp.idx], [g.nodes[-1].idx]
    return g


def _run(pipeline_cls, frames, pre, infer):
    p = pipeline_cls()
    src = p.source(frames)
    staged = p.node(pre, src, name="pre")
    return p.run_to_list(p.node(infer, staged, name="infer"))


def test_pipeline_with_compiled_graph(rng):
    """Stage 2 runs the port's compiled forward on the CPU, the JAX
    package's test case on the port, and equals the JAX pipeline."""
    jg = _relu_graph()
    cg = pt.compile_graph(pt.load_tm_bytes(graph_to_tm_bytes(jg)), device="cpu")
    jcg = jt.compile_graph(jg, jt.Options())
    frames = [rng.standard_normal((1, 4)).astype(np.float32) for _ in range(5)]
    outs = _run(Pipeline, frames, lambda f: f * 2.0, lambda f: cg.run(f)[0])
    want = _run(JaxPipeline, frames, lambda f: f * 2.0, lambda f: np.asarray(jcg.run(f)[0]))
    assert len(outs) == len(want) == 5
    for f, o, w in zip(frames, outs, want):
        np.testing.assert_array_equal(o, np.maximum(f * 2.0, 0.0))
        np.testing.assert_array_equal(o, w)


def test_pipeline_quantized_stage_equals_the_jax_stage(rng):
    """A UINT8 conv graph (quantized by the JAX package, read by the port
    from its tmfile bytes) as the inference stage, with quantization as the
    pre stage: each frame's codes equal the JAX pipeline's and the port's
    own call on the main thread."""
    jg, _, _ = make_conv_graph(in_shape=(1, 3, 8, 8), out_c=8, rng=rng)
    calib = [rng.standard_normal((1, 3, 8, 8)).astype(np.float32) for _ in range(2)]
    jqg = jax_quantize(jg, calib, scheme="uint8")
    opts = dict(quant_mode="fast")
    cg = pt.compile_graph(pt.load_tm_bytes(graph_to_tm_bytes(jqg)), pt.Options(**opts),
                          device="cpu")
    jcg = jt.compile_graph(jqg, jt.Options(**opts))
    t_in = jqg.tensors[jqg.input_tensors[0]]

    def pre(f):
        return jq.quantize_np(f, t_in.quant, t_in.dtype)

    frames = [rng.standard_normal((1, 3, 8, 8)).astype(np.float32) for _ in range(8)]
    outs = _run(Pipeline, frames, pre, lambda x: cg.run(x)[0])
    want = _run(JaxPipeline, frames, pre, lambda x: np.asarray(jcg.run(x)[0]))
    assert len(outs) == len(want) == 8
    for f, o, w in zip(frames, outs, want):
        assert o.dtype == np.uint8 and np.array_equal(o, w)
        np.testing.assert_array_equal(o, cg.run(pre(f))[0])
