"""The PyTorch port's public surface beyond compile_graph, against the JAX
package on the CPU: the pytengine object API, register_custom_op and
load_tengine_plugin (tengine_tpu_torch/api.py), CompiledGraph.cost_analysis
and Options.donate_input (executor/engine.py). Mirrors
test_pytengine_style_api, test_custom_op_registration,
test_load_tengine_plugin, test_cost_analysis and test_donate_input of
tests/test_api_and_extra_ops.py, with both packages run on the same tmfile.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.api import Graph as JaxApiGraph  # noqa: E402
from tengine_tpu.api import Tensor as JaxTensor  # noqa: E402
from tengine_tpu.api import _LOADED_PLUGINS as JAX_PLUGINS  # noqa: E402
from tengine_tpu.api import load_tengine_plugin as jax_load_plugin  # noqa: E402
from tengine_tpu.graph.ir import DType, Graph, TensorType  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes, save_tmfile  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.api import Graph as ApiGraph  # noqa: E402
from tengine_tpu_torch.api import Tensor  # noqa: E402
from tengine_tpu_torch.api import _LOADED_PLUGINS, load_tengine_plugin  # noqa: E402

from test_execute_small import _simple_graph, make_conv_graph  # noqa: E402


def test_pytengine_style_api(tmp_path, rng):
    g, _, _ = make_conv_graph(rng=rng)
    p = str(tmp_path / "m.tmfile")
    save_tmfile(g, p)
    x = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    outs = {}
    for name, graph in (("port", ApiGraph(None, "tengine", p, device="cpu")),
                        ("jax", JaxApiGraph(None, "tengine", p))):
        t = graph.getInputTensor(0, 0)
        assert t.shape == [1, 3, 8, 8] and graph.input_num == graph.output_num == 1
        graph.preRun()
        t.buf = x
        graph.run(1)
        outs[name] = graph.getOutputTensor(0, 0).buf
        assert "Convolution" in graph.dump()
        graph.postRun()
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5, atol=1e-6)
    (expected,) = pt.compile_graph(pt.load_model(p), device="cpu").run(x)
    np.testing.assert_array_equal(outs["port"], expected)


def test_tensor_handle_reports_quant_params(tmp_path, rng):
    """quant_param (get_tensor_quant_param) and the shape setter, which drops
    the build, on a quantized tmfile."""
    g, _, _ = make_conv_graph(rng=rng)
    calib = [rng.standard_normal((1, 3, 8, 8)).astype(np.float32)]
    p = str(tmp_path / "q.tmfile")
    save_tmfile(jax_quantize(g, calib, scheme="uint8"), p)
    port, jax_g = ApiGraph(None, "tengine", p, device="cpu"), JaxApiGraph(None, "tengine", p)
    for tidx in range(len(port.ir.tensors)):
        mine, theirs = Tensor(port, tidx), JaxTensor(jax_g, tidx)
        assert (mine.name, mine.shape, mine.quant_param) == (
            theirs.name, theirs.shape, theirs.quant_param)
    assert any(Tensor(port, i).quant_param for i in range(len(port.ir.tensors)))
    t = port.getInputTensor(0, 0)
    port.preRun()
    t.shape = [2, 3, 8, 8]
    assert port._compiled is None and port.ir.tensors[t._idx].shape == [2, 3, 8, 8]


def _threshold_graph(gain):
    return _simple_graph("Threshold", dict(threshold=0.0, gain=gain), [(1, 4)])


def test_custom_op_registration(rng):
    """A torch lowering registered for Threshold (a builtin op of both
    packages) wins selection at SCORE_STATIC over the builtin; the JAX
    package runs its own registration on the same tmfile; unregister drops
    it again, and the builtin lowering, equal to the JAX package's, takes
    the node back."""
    from tengine_tpu.api import register_custom_op as jax_register
    from tengine_tpu.ops.layout import like as jlike
    from tengine_tpu.ops.registry import SCORE_STATIC

    from tengine_tpu_torch.ops.layout import like

    def lower_double_relu(ctx, x):
        return like(x, torch.clamp_min(x.x, 0) * ctx.params.get("gain", 2.0))

    def jax_lower_double_relu(ctx, x):
        import jax.numpy as jnp

        return jlike(x, jnp.maximum(x.x, 0) * ctx.params.get("gain", 2.0))

    blob = graph_to_tm_bytes(_threshold_graph(2.0))
    x = rng.standard_normal((1, 4)).astype(np.float32)
    unregister = pt.register_custom_op("Threshold", lower_double_relu, score=SCORE_STATIC)
    jax_unregister = jax_register("Threshold", jax_lower_double_relu, score=SCORE_STATIC)
    try:
        cg = pt.compile_graph(pt.load_tm_bytes(blob), device="cpu")
        assert cg.kernels["threshold"] == "lower_double_relu"
        (out,) = cg.run(x)
        (want,) = jt.compile_graph(jt.load_tm_bytes(blob)).run(x)
        np.testing.assert_allclose(out, np.maximum(x, 0) * 2.0, rtol=1e-6)
        np.testing.assert_array_equal(out, want)
    finally:
        unregister()  # don't leak the override into the global registry
        jax_unregister()
    cg = pt.compile_graph(pt.load_tm_bytes(blob), device="cpu")
    assert cg.kernels["threshold"] == "lower_threshold"
    (out,) = cg.run(x)
    (want,) = jt.compile_graph(jt.load_tm_bytes(blob)).run(x)
    np.testing.assert_array_equal(out, (x > 0).astype(np.float32))
    np.testing.assert_array_equal(out, want)


PLUGIN = """
UNREGISTER = []


def init():
    from {pkg}.api import register_custom_op
    from {pkg}.ops.layout import like

    def lower_double(ctx, x):
        return like(x, x.x * 2.0)

    UNREGISTER.append(register_custom_op('Threshold', lower_double))
"""


def test_load_tengine_plugin(tmp_path, rng):
    """Plugin loading (api/plugin.c analog): a python file whose init()
    registers a custom op lowering, loaded once per name; the port's plugin
    and the JAX package's on the same tmfile."""
    blob = graph_to_tm_bytes(_threshold_graph(1.0))
    xv = rng.standard_normal((1, 4)).astype(np.float32)
    outs = {}
    for pkg, load, loaded, compile_run in (
        ("tengine_tpu_torch", load_tengine_plugin, _LOADED_PLUGINS,
         lambda: pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(), device="cpu").run(xv)),
        ("tengine_tpu", jax_load_plugin, JAX_PLUGINS,
         lambda: jt.compile_graph(jt.load_tm_bytes(blob), jt.Options()).run(xv)),
    ):
        plugin = tmp_path / f"{pkg}_plugin.py"
        plugin.write_text(PLUGIN.format(pkg=pkg))
        assert load(f"double_{pkg}", str(plugin)) == 0
        assert load(f"double_{pkg}", str(plugin)) == 0  # idempotent
        mod = loaded.pop(f"double_{pkg}")
        try:
            assert len(mod.UNREGISTER) == 1
            (outs[pkg],) = compile_run()
        finally:
            for unregister in mod.UNREGISTER:
                unregister()
    np.testing.assert_allclose(outs["tengine_tpu_torch"], xv * 2.0, rtol=1e-6)
    np.testing.assert_array_equal(outs["tengine_tpu_torch"], outs["tengine_tpu"])
    with pytest.raises(AttributeError, match="no start"):
        load_tengine_plugin("no_init", str(tmp_path / "tengine_tpu_torch_plugin.py"), "start")


def _cost_conv_graph(rng, bias):
    g = Graph(name="cost")
    x = g.add_tensor("x", DType.FP32, [1, 3, 8, 8], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    w = (rng.standard_normal((4, 3, 3, 3)) * 0.3).astype(np.float32)
    ins = [x.idx, g.add_tensor("w", DType.FP32, list(w.shape), TensorType.CONST, data=w).idx]
    if bias:
        b = np.ones(4, np.float32)
        ins.append(g.add_tensor("b", DType.FP32, [4], TensorType.CONST, data=b).idx)
    y = g.add_tensor("y", DType.FP32, [], TensorType.VAR)
    g.add_node("Convolution", "c", ins, [y.idx],
               params=dict(kernel_h=3, kernel_w=3, stride_h=1, stride_w=1,
                           dilation_h=1, dilation_w=1, input_channel=3,
                           output_channel=4, group=1, activation=-1,
                           pad_h0=1, pad_w0=1, pad_h1=1, pad_w1=1))
    g.inputs, g.outputs = [inp.idx], [g.nodes[-1].idx]
    return g


def _cost_fc_graph(rng, bias):
    g = Graph(name="fc")
    x = g.add_tensor("x", DType.FP32, [2, 16], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    w = (rng.standard_normal((8, 16)) * 0.3).astype(np.float32)
    ins = [x.idx, g.add_tensor("w", DType.FP32, list(w.shape), TensorType.CONST, data=w).idx]
    if bias:
        b = np.ones(8, np.float32)
        ins.append(g.add_tensor("b", DType.FP32, [8], TensorType.CONST, data=b).idx)
    y = g.add_tensor("y", DType.FP32, [], TensorType.VAR)
    g.add_node("FullyConnected", "fc", ins, [y.idx], params=dict(num_output=8))
    g.inputs, g.outputs = [inp.idx], [g.nodes[-1].idx]
    return g


@pytest.mark.parametrize("graph,bias,flops", [
    (_cost_conv_graph, False, 11_616),  # 2 x the MACs of the in-bounds taps only
    (_cost_conv_graph, True, 11_872),
    (_cost_fc_graph, False, 512),
    (_cost_fc_graph, True, 528),
])
def test_cost_analysis_flops_equal_xla(rng, graph, bias, flops):
    """cost_analysis()["flops"] is XLA's count on test_cost_analysis's conv
    graph and on one-FC graphs: the padded taps (13,824 on the conv graph)
    are not counted, a bias adds one flop an output element."""
    g = graph(rng, bias)
    jca = jt.compile_graph(g).cost_analysis()
    ca = pt.compile_graph(pt.load_tm_bytes(graph_to_tm_bytes(g)), device="cpu").cost_analysis()
    assert ca["flops"] == jca["flops"] == flops
    assert ca["bytes accessed"] > 0 and ca["launches"] is None


def test_cost_analysis_on_a_net(rng):
    """On a whole quantized net: the fused chains' convs are counted, so
    tier F (4 FusedResBlockChain nodes) and tier G (the same convs node by
    node) count the same flops."""
    from test_torch_compiled import CASES, quantized

    qg, _ = quantized(*CASES["resnet50-F"][:2])
    opts = dict(quant_mode="fast", quant_relaxed=False, batch_size=2)
    f = pt.compile_graph(qg, pt.Options(fuse_resblock=True, **opts), device="cpu")
    g = pt.compile_graph(qg, pt.Options(**opts), device="cpu")
    assert any(n.op == "FusedResBlockChain" for n in f.graph.nodes)
    assert f.cost_analysis()["flops"] == g.cost_analysis()["flops"] > 0


def test_donate_input(rng):
    """Options.donate_input: a fresh buffer each call (donation-safe); on
    the CPU the forward is eager and never writes its input, donated or
    not."""
    g = Graph(name="don")
    x = g.add_tensor("x", DType.FP32, [4, 4], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    y = g.add_tensor("y", DType.FP32, [], TensorType.VAR)
    g.add_node("ReLu", "r", [x.idx], [y.idx], params=dict(negative_slope=0.0))
    g.inputs, g.outputs = [inp.idx], [g.nodes[-1].idx]
    blob = graph_to_tm_bytes(g)
    for donate in (True, False):
        cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(donate_input=donate),
                              device="cpu")
        for _ in range(2):
            xv = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
            host = xv.clone()
            (out,) = cg.run(xv)
            np.testing.assert_allclose(out, np.maximum(host.numpy(), 0.0))
            assert torch.equal(xv, host)
