"""The port's kernel routes against the JAX engine's on small quantized
graphs, on the CPU: the fused residual (+ relu) route of the direct conv
with uint8 and int8 grids, the FC route of qgemm_requant, the dw gate under
default Options, and the folded leaky-ReLU / Dropout requantization. Graphs
are built and quantized by the JAX package and carried as tmfile bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tengine_tpu as jt  # noqa: E402
import tengine_tpu.executor.engine as jax_engine  # noqa: E402
from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402

from test_qconv_pallas import _tiny_resnet_block  # noqa: E402
from test_torch_imports import tiny_dw_graph  # noqa: E402


def both_engines(qg, opts, xq, monkeypatch):
    """Compile and run qg on both engines; returns the JAX outputs, the JAX
    engine's routes as {node name: lowering name}, the port's outputs and
    the port's CompiledGraph."""
    jax_routes = {}
    select = jax_engine.select_kernel

    def recording_select(op, ctx):
        k = select(op, ctx)
        jax_routes[ctx.node.name] = k.name
        return k

    monkeypatch.setattr(jax_engine, "select_kernel", recording_select)
    blob = graph_to_tm_bytes(qg)
    want = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**opts)).run(xq)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    return want, jax_routes, cg.run(xq), cg


def assert_within_one_lsb(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 1, diff.max()


def _quantized_input(qg, x):
    t_in = qg.tensors[qg.input_tensors[0]]
    return jq.quantize_np(x, t_in.quant, t_in.dtype)


@pytest.mark.parametrize("scheme", ["uint8", "int8"])
def test_fused_residual_route_matches_jax(scheme, monkeypatch):
    """conv3x3(relu) -> conv1x1 -> add(skip) -> relu under the integer-storage
    tier, exact residual epilogue: the 3×3 conv on qconv_direct, the 1×1 conv
    with the add and relu fused on qconv1x1, uint8 zero points included."""
    rng = np.random.default_rng(0)
    g = _tiny_resnet_block(rng)
    calib = [rng.standard_normal((1, 128, 8, 8)).astype(np.float32) for _ in range(3)]
    qg = jax_quantize(g, calib, scheme=scheme)
    xq = np.concatenate([_quantized_input(qg, c) for c in calib])
    opts = dict(quant_mode="fast", quant_bf16_storage=False, quant_relaxed=False, batch_size=3)
    want, jax_routes, got, cg = both_engines(qg, opts, xq, monkeypatch)
    convs = [n for n in cg.graph.nodes if n.op == "Convolution"]
    assert len(convs) == 2 and any("fused_add_pos" in n.params for n in convs)
    for n in convs:
        assert cg.kernels[n.name] == jax_routes[n.name] == "lower_conv_quant_pallas_direct"
    assert_within_one_lsb(want, got)


def _fc_graph(rng, k=200, n=130):
    g = jir.Graph(name="fc")
    x = g.add_tensor("x", jir.DType.FP32, [1, k], jir.TensorType.INPUT)
    w = g.add_tensor("w", jir.DType.FP32, [n, k], jir.TensorType.CONST,
                     data=(rng.standard_normal((n, k)) * 0.1).astype(np.float32))
    b = g.add_tensor("b", jir.DType.FP32, [n], jir.TensorType.CONST,
                     data=(rng.standard_normal(n) * 0.1).astype(np.float32))
    y = g.add_tensor("y", jir.DType.FP32, [1, n], jir.TensorType.VAR)
    g.add_node("InputOp", "in", [], [x.idx])
    g.add_node("FullyConnected", "fc", [x.idx, w.idx, b.idx], [y.idx], params=dict(num_output=n))
    g.inputs = [0]
    g.outputs = [1]
    return g


@pytest.mark.parametrize("scheme", ["uint8", "int8"])
def test_fc_route_matches_jax(scheme, monkeypatch):
    """FullyConnected on qgemm_requant (pallas_qgemm, integer storage), K
    and N not multiples of the kernel's tiles."""
    rng = np.random.default_rng(2)
    g = _fc_graph(rng)
    calib = [rng.standard_normal((1, 200)).astype(np.float32) for _ in range(4)]
    qg = jax_quantize(g, calib, scheme=scheme)
    xq = np.concatenate([_quantized_input(qg, c) for c in calib])
    opts = dict(quant_mode="fast", quant_bf16_storage=False, pallas_qgemm=True, batch_size=4)
    want, jax_routes, got, cg = both_engines(qg, opts, xq, monkeypatch)
    assert cg.kernels["fc"] == jax_routes["fc"] == "lower_fc_quant_pallas"
    assert_within_one_lsb(want, got)


def test_dw_gate_keeps_bf16_storage_off_the_kernel(monkeypatch):
    """TT_DW_PALLAS=1 at batch 32 under default storage: the JAX gate's
    _int_stored terms are False (its bf16 plan is None for a graph with a
    depthwise conv), so both engines take the fast lowering."""
    monkeypatch.setenv("TT_DW_PALLAS", "1")
    rng = np.random.default_rng(4)
    g = tiny_dw_graph(ir=jir)
    calib = [rng.standard_normal((1, 32, 8, 8)).astype(np.float32) for _ in range(2)]
    qg = jax_quantize(g, calib, scheme="int8")
    x = rng.standard_normal((32, 32, 8, 8)).astype(np.float32)
    opts = dict(quant_mode="fast", batch_size=32)
    want, jax_routes, got, cg = both_engines(qg, opts, _quantized_input(qg, x), monkeypatch)
    assert cg.kernels["dw"] == jax_routes["dw"] == "lower_conv_quant_fast"
    assert_within_one_lsb(want, got)


def _leaky_dropout_graph(rng, c=8):
    """conv1x1 -> leaky ReLU(0.1) -> Dropout, darknet style."""
    g = jir.Graph(name="leaky")
    x = g.add_tensor("x", jir.DType.FP32, [1, c, 6, 6], jir.TensorType.INPUT)
    w = g.add_tensor("w", jir.DType.FP32, [c, c, 1, 1], jir.TensorType.CONST,
                     data=rng.standard_normal((c, c, 1, 1)).astype(np.float32))
    y = g.add_tensor("y", jir.DType.FP32, [], jir.TensorType.VAR)
    z = g.add_tensor("z", jir.DType.FP32, [], jir.TensorType.VAR)
    o = g.add_tensor("o", jir.DType.FP32, [], jir.TensorType.VAR)
    g.add_node("InputOp", "in", [], [x.idx])
    g.add_node("Convolution", "conv", [x.idx, w.idx], [y.idx], params=dict(
        kernel_h=1, kernel_w=1, stride_h=1, stride_w=1, pad_h0=0, pad_h1=0, pad_w0=0,
        pad_w1=0, dilation_h=1, dilation_w=1, group=1, activation=-1,
        input_channel=c, output_channel=c))
    g.add_node("ReLu", "leaky", [y.idx], [z.idx], params=dict(negative_slope=0.1))
    g.add_node("Dropout", "drop", [z.idx], [o.idx])
    g.inputs = [0]
    g.outputs = [3]
    return g


@pytest.mark.parametrize("scheme", ["uint8", "int8"])
def test_leaky_and_dropout_requant_match_jax(scheme, monkeypatch):
    """The folded-constant requantization of the port's leaky-ReLU and
    Dropout lowerings equals the JAX engine's generic wrapper as XLA
    compiles it, zero points included."""
    rng = np.random.default_rng(6)
    g = _leaky_dropout_graph(rng)
    calib = [rng.standard_normal((1, 8, 6, 6)).astype(np.float32) * 3 for _ in range(3)]
    qg = jax_quantize(g, calib, scheme=scheme)
    xq = np.concatenate([_quantized_input(qg, c) for c in calib])
    # the integer-storage tier puts the uint8 conv on qconv1x1
    opts = dict(quant_mode="fast", quant_bf16_storage=False, batch_size=3)
    want, _, got, cg = both_engines(qg, opts, xq, monkeypatch)
    assert cg.kernels["leaky"] == "lower_leaky_relu_quant"
    assert cg.kernels["drop"] == "lower_dropout_quant"
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
