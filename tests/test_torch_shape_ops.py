"""The PyTorch port's Softmax, LogSoftmax and shape lowerings (Flatten,
Reshape, Permute, Transpose, Squeeze, Slice, Split, Crop) and their quantized
passthroughs against the JAX package, on the CPU.

Each case is a one-node graph, or the node after a 1x1 conv so that its
input arrives in the conv's NHWC layout (the conv reverses the channels: its
weights are a permutation matrix, exact in both engines, float and
quantized), built with the JAX IR and carried to
the port as tmfile bytes. Float: both engines on the same input. Quantized
(UINT8 MinMax by the JAX quantizer, which pins a shape op's output grid to
its input's): both engines under Options(quant_mode="fast"), each shape op
on its passthrough (the stored integers moved as they are), Softmax and
LogSoftmax through the generic dequantize -> f32 -> requantize wrapper, as
the JAX engine routes them. Every port forward runs with torch's host upload
and sync calls patched to raise, as the captured forward on the card needs.

Tolerances, and why: the shape ops move values, so float and quantized
outputs are equal bit for bit. Softmax and LogSoftmax: float within rtol
2e-6 (XLA's exp and sum and torch's round apart in the last bits);
quantized within 1 LSB on at most 1% of the elements (a last-bit parting
meets a .5 tie of the requant). Measured here: 0 LSB on every case.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
import tengine_tpu.executor.engine as jax_engine  # noqa: E402
from tengine_tpu.graph.ir import DType, Graph, TensorType  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402

from test_torch_compiled import run_without_host_transfer  # noqa: E402


def one_node_graph(op, params, shape, n_outputs=1, conv=False, consts=(), extra_inputs=()):
    """input [-> 1x1 conv reversing the channels, so the node reads NHWC]
    -> op, in the JAX IR; consts (numpy arrays, their dtype kept) and extra
    graph inputs (shapes) follow the data input."""
    g = Graph(name=f"{op}_one_node")
    x = g.add_tensor("in0", DType.FP32, list(shape), TensorType.INPUT)
    nodes = [g.add_node("InputOp", "input0", [], [x.idx]).idx]
    ins = [x.idx]
    if conv:
        c = shape[1]
        w = g.add_tensor("conv.w", DType.FP32, [c, c, 1, 1], TensorType.CONST,
                         data=np.eye(c, dtype=np.float32)[::-1].reshape(c, c, 1, 1).copy())
        y = g.add_tensor("conv.out", DType.FP32, list(shape), TensorType.VAR)
        g.add_node("Convolution", "conv", [x.idx, w.idx], [y.idx], dict(
            kernel_h=1, kernel_w=1, stride_h=1, stride_w=1, dilation_h=1, dilation_w=1,
            input_channel=c, output_channel=c, group=1, activation=-1,
            pad_h0=0, pad_w0=0, pad_h1=0, pad_w1=0))
        ins = [y.idx]
    for i, data in enumerate(consts):
        dt = DType.INT32 if data.dtype == np.int32 else DType.FP32
        ins.append(g.add_tensor(f"c{i}", dt, list(data.shape), TensorType.CONST, data=data).idx)
    for i, s in enumerate(extra_inputs):
        t = g.add_tensor(f"in{i + 1}", DType.FP32, list(s), TensorType.INPUT)
        nodes.append(g.add_node("InputOp", f"input{i + 1}", [], [t.idx]).idx)
        ins.append(t.idx)
    outs = [g.add_tensor(f"out{i}", DType.FP32, [], TensorType.VAR).idx for i in range(n_outputs)]
    g.add_node(op, op.lower(), ins, outs, params)
    g.inputs, g.outputs = nodes, [g.nodes[-1].idx]
    return g


S4 = (2, 8, 4, 6)
ONNX_SLICE = dict(iscaffe=0, ismxnet=0, isonnx=1, slice_points=[], begins=[], sizes=[])
# name: (op, params, input shape, outputs, consts, extra inputs, runs after a conv too)
CASES = {
    "softmax-c": ("Softmax", dict(axis=1), S4, 1, (), (), True),
    "softmax-3d": ("Softmax", dict(axis=2), (2, 5, 21), 1, (), (), False),
    "logsoftmax-c": ("LogSoftmax", dict(axis=1), S4, 1, (), (), True),
    "logsoftmax-w": ("LogSoftmax", dict(axis=3), S4, 1, (), (), True),
    "flatten": ("Flatten", dict(axis=1, end_axis=-1), S4, 1, (), (), True),
    "flatten-part": ("Flatten", dict(axis=1, end_axis=2), S4, 1, (), (), True),
    "reshape-0-1": ("Reshape", dict(shape=[0, -1, 6], is_mxnet=0, reverse=0, is_onnx=0), S4, 1,
                    (), (), True),
    "reshape-const": ("Reshape", dict(shape=[], is_mxnet=0, reverse=0, is_onnx=1), S4, 1,
                      (np.array([2, -1, 3], np.int32),), (), True),
    "permute": ("Permute", dict(flag=0, order0=0, order1=2, order2=3, order3=1), S4, 1, (), (),
                True),
    "permute-3d": ("Permute", dict(flag=0, order0=0, order1=2, order2=1, order3=3), (2, 5, 7), 1,
                   (), (), False),
    "transpose": ("Transpose", dict(perm=[0, 3, 1, 2]), S4, 1, (), (), True),
    "squeeze-flag": ("Squeeze", dict(dim_0=0, dim_1=0, dim_2=1, dim_3=0), (2, 8, 1, 6), 1, (), (),
                     True),
    "squeeze-all": ("Squeeze", dict(dim_0=0, dim_1=0, dim_2=0, dim_3=0), (2, 8, 1, 1), 1, (), (),
                    True),
    "slice-caffe": ("Slice", dict(axis=1, iscaffe=1, slice_points=[2, 5], begins=[], sizes=[]),
                    S4, 3, (), (), True),
    "slice-caffe-even": ("Slice", dict(axis=1, iscaffe=1, slice_points=[], begins=[], sizes=[]),
                         S4, 2, (), (), True),
    "slice-onnx-range": ("Slice", dict(ONNX_SLICE, axis=2, begin=1, end=-1, step=1), S4, 1, (),
                         (), True),
    "slice-onnx-step": ("Slice", dict(ONNX_SLICE, axis=3, begin=0, end=6, step=2), S4, 1, (), (),
                        True),
    "slice-onnx-begins": ("Slice", dict(ONNX_SLICE, axis=0, begins=[0, 2, 1, 0],
                                        sizes=[2, 4, -1, 5]), S4, 1, (), (), True),
    "slice-tflite": ("Slice", dict(axis=0, iscaffe=0, ismxnet=0, isonnx=0, slice_points=[],
                                   begins=[0, 1, 0, 2], sizes=[2, 6, 3, -1]), S4, 1, (), (), True),
    "split-sizes": ("Split", dict(axis=1, split_dim=2, is_caffe=False, is_onnx=True,
                                  split_sizes=[3, 5]), S4, 2, (), (), True),
    "split-even": ("Split", dict(axis=3, split_dim=3, is_caffe=False, is_onnx=True,
                                 split_sizes=[]), S4, 3, (), (), True),
    "crop-size": ("Crop", dict(num_args=1, offset_c=0, offset_h=1, offset_w=2, crop_h=2, crop_w=3,
                               center_crop=False, axis=2, flag=0), S4, 1, (), (), True),
    "crop-like": ("Crop", dict(num_args=2, offset_c=0, offset_h=0, offset_w=0, crop_h=0, crop_w=0,
                               center_crop=True, axis=2, flag=0), S4, 1, (), ((2, 8, 2, 2),),
                  True),
}
PASSTHROUGH = {"Flatten", "Reshape", "Permute", "Transpose", "Squeeze", "Slice", "Split", "Crop"}
IDS = [(name, conv) for name, case in CASES.items() for conv in ((False, True) if case[6] else
                                                                  (False,))]


def _graph_and_inputs(name, conv):
    op, params, shape, n_out, consts, extra, _ = CASES[name]
    g = one_node_graph(op, params, shape, n_out, conv, consts, extra)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(s).astype(np.float32) * 2 for s in (shape, *extra)]
    return g, xs


def _both(blob, opts, xs, monkeypatch):
    """(JAX engine's outputs, port's outputs, JAX routes {node: lowering},
    port's CompiledGraph) on the tmfile bytes, numpy in and out."""
    routes = {}
    select = jax_engine.select_kernel

    def recording_select(op, ctx):
        k = select(op, ctx)
        routes[ctx.node.name] = k.name
        return k

    monkeypatch.setattr(jax_engine, "select_kernel", recording_select)
    want = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**opts)).run(*xs)
    monkeypatch.setattr(jax_engine, "select_kernel", select)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    return [np.asarray(w) for w in want], run_without_host_transfer(cg, *xs), routes, cg


@pytest.mark.parametrize("name,conv", IDS, ids=[f"{n}{'-nhwc' if c else ''}" for n, c in IDS])
def test_float_lowering_matches_jax(name, conv, monkeypatch):
    g, xs = _graph_and_inputs(name, conv)
    want, got, routes, cg = _both(graph_to_tm_bytes(g), dict(precision="fp32"), xs, monkeypatch)
    op = CASES[name][0]
    assert cg.kernels == routes and cg.kernels[op.lower()] == f"lower_{op.lower()}"
    assert len(got) == len(want) == CASES[name][3]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        if op in PASSTHROUGH:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("name,conv", IDS, ids=[f"{n}{'-nhwc' if c else ''}" for n, c in IDS])
def test_quantized_lowering_matches_jax(name, conv, monkeypatch):
    g, xs = _graph_and_inputs(name, conv)
    qg = jax_quantize(g, [xs], scheme="uint8", algorithm="minmax")
    xq = []
    for tid, x in zip(qg.input_tensors, xs):
        t = qg.tensors[tid]
        xq.append(jq.quantize_np(x, t.quant, t.dtype))
    want, got, routes, cg = _both(graph_to_tm_bytes(qg), dict(quant_mode="fast"), xq, monkeypatch)
    op = CASES[name][0]
    node = cg.graph.nodes[-1]
    # a Crop to another input's size reads an activation on its own grid:
    # the generic wrapper. The passthroughs register under the name "_lower"
    # in both packages (the name is taken before it is set)
    passthrough = op in PASSTHROUGH and not (op == "Crop" and len(node.inputs) > 1)
    assert cg.kernels == routes
    assert cg.kernels[node.name] == ("_lower" if passthrough else f"lower_{op.lower()}")
    assert len(got) == len(want) == CASES[name][3]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        if passthrough:
            assert d.max() == 0
        else:
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
