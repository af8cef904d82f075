"""The PyTorch port's TM2 writer (tengine_tpu_torch/serializer/tm2/writer.py)
against the JAX package's: the same bytes for the same graph, the port's
bytes read back by both packages' readers into the graph that was written,
and the round trips of tests/test_tm2_writer.py (all but the one that reads
an imported benchmark model) on the port.

Graphs: the JAX tests' conv graph carried to the port as tmfile bytes, and
the in-repo nets' graphs at small sizes (yolov3 and YOLO-Fastest at
img 64, the narrow ResNet-50 and mobilenet-v1 of tests/test_torch_compiled.py),
fp32 as each package's own code makes them, quantized by the port and read into the
JAX package from the port's bytes. Bytes are compared exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes as jax_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.graph.passes import compact  # noqa: E402

from test_execute_small import make_conv_graph  # noqa: E402
from test_torch_compiled import (  # noqa: E402
    MOBILENET_SMALL, RESNET_SMALL, build_mobilenet_v1_graph, build_resnet50_graph, quantized,
)
from test_torch_yolov5 import assert_ir_equal  # noqa: E402


def _to_port(jg):
    return pt.load_tm_bytes(jax_bytes(jg), name=jg.name)


def _roundtrip(g):
    return pt.load_tm_bytes(pt.graph_to_tm_bytes(g), name=g.name)


def test_roundtrip_conv_graph(rng):
    jg, w, _ = make_conv_graph(rng=rng)
    g = _to_port(jg)
    assert pt.graph_to_tm_bytes(g) == jax_bytes(jg)
    g2 = _roundtrip(g)
    assert len(g2.nodes) == len(g.nodes)
    assert len(g2.tensors) == len(g.tensors)
    conv = [n for n in g2.nodes if n.op == "Convolution"][0]
    assert conv.params["kernel_h"] == 3
    np.testing.assert_array_equal(g2.tensors[conv.inputs[1]].data, w)

    x = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    (a,) = pt.compile_graph(g, device="cpu").run(x)
    (b,) = pt.compile_graph(g2, device="cpu").run(x)
    np.testing.assert_array_equal(a, b)


def test_roundtrip_quantized_graph(rng):
    jg, _, _ = make_conv_graph(rng=rng)
    calib = [rng.standard_normal((1, 3, 8, 8)).astype(np.float32) for _ in range(2)]
    jqg = jax_quantize(jg, calib, scheme="int8")
    qg = _to_port(jqg)
    assert pt.graph_to_tm_bytes(qg) == jax_bytes(jqg)
    qg2 = _roundtrip(qg)

    # per-channel quant params survive
    conv = [n for n in qg2.nodes if n.op == "Convolution"][0]
    wq = qg2.tensors[conv.inputs[1]].quant
    wq0 = qg.tensors[conv.inputs[1]].quant
    np.testing.assert_allclose(wq.scales, wq0.scales, rtol=1e-6)
    assert wq.per_channel

    t_in = jqg.tensors[jqg.input_tensors[0]]
    xq = jq.quantize_np(calib[0], t_in.quant, t_in.dtype)
    (a,) = pt.compile_graph(qg, pt.Options(quant_mode="fast"), device="cpu").run(xq)
    (b,) = pt.compile_graph(qg2, pt.Options(quant_mode="fast"), device="cpu").run(xq)
    np.testing.assert_array_equal(a, b)


def test_save_load_file(tmp_path, rng):
    g = _to_port(make_conv_graph(rng=rng)[0])
    p = str(tmp_path / "model.tmfile")
    pt.save_tmfile(g, p)
    g2 = pt.load_model(p)
    assert len(g2.nodes) == len(g.nodes)
    with open(p, "rb") as f:
        assert f.read() == pt.graph_to_tm_bytes(g)


def _flatten_graph(ir):
    g = ir.Graph(name="flat")
    x = g.add_tensor("x", ir.DType.FP32, [1, 4, 2, 2], ir.TensorType.INPUT)
    y = g.add_tensor("y", ir.DType.FP32, [], ir.TensorType.VAR)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    g.add_node("Flatten", "flat", [x.idx], [y.idx], params=dict(axis=1, end_axis=-1))
    g.inputs = [inp.idx]
    g.outputs = [g.nodes[-1].idx]
    return g


def test_flatten_end_axis_resolved_on_wire():
    """A caffe-style end_axis=-1 is written as the last 4-D axis, as the
    JAX writer does (the reference's flatten iterates axis..end_axis
    literally)."""
    blob = pt.graph_to_tm_bytes(_flatten_graph(pir))
    assert blob == jax_bytes(_flatten_graph(jir))
    flat = [n for n in pt.load_tm_bytes(blob).nodes if n.op == "Flatten"][0]
    assert flat.params["end_axis"] == 3
    assert flat.params["axis"] == 1


def test_dead_noop_shells_are_compacted_away():
    """Fusion passes leave output-less Noop shells; both writers write the
    compacted graph instead, with the same bytes."""
    graphs = [_flatten_graph(ir) for ir in (jir, pir)]
    for g in graphs:
        g.add_node("Noop", "dead", [], [])
    blob = pt.graph_to_tm_bytes(graphs[1])
    assert blob == jax_bytes(graphs[0]) == pt.graph_to_tm_bytes(compact(graphs[1]))
    assert [n.op for n in pt.load_tm_bytes(blob).nodes] == ["InputOp", "Flatten"]


def _net_graphs(name):
    """(the JAX package's graph, the port's graph) of one in-repo net."""
    if name == "yolov3":
        from tengine_tpu.models.darknet_zoo import build_yolov3_graph as jb
        from tengine_tpu_torch.models.darknet_zoo import build_yolov3_graph as pb

        return jb(img=64), pb(img=64)
    if name == "yolofastest":
        from tengine_tpu.models.darknet_zoo import build_yolofastest_graph as jb
        from tengine_tpu_torch.models.darknet_zoo import build_yolofastest_graph as pb

        return jb(img=64), pb(img=64)
    if name == "resnet50":
        return (build_resnet50_graph(jir, **RESNET_SMALL), build_resnet50_graph(pir, **RESNET_SMALL))
    return (build_mobilenet_v1_graph(jir, **MOBILENET_SMALL),
            build_mobilenet_v1_graph(pir, **MOBILENET_SMALL))


NETS = {"yolov3": "int8", "yolofastest": "uint8", "resnet50": "int8", "mobilenet": "uint8"}


@pytest.mark.parametrize("net", list(NETS))
def test_net_graphs_fp32_written_as_jax_writes_them(net):
    jg, pg = _net_graphs(net)
    blob = pt.graph_to_tm_bytes(pg)
    assert blob == jax_bytes(jg)
    assert_ir_equal(jt.load_tm_bytes(blob), pt.load_tm_bytes(blob))  # both readers agree
    assert_ir_equal(_roundtrip(pg), pt.load_tm_bytes(jax_bytes(jg)))


@pytest.mark.parametrize("net", list(NETS))
def test_net_graphs_quantized_written_as_jax_writes_them(net):
    """The port-quantized graph (per-channel weights, int32 biases, uint8
    grids): the JAX reader loads the port's bytes, and the JAX writer writes
    that graph back to the same bytes; the port's reader and writer make a
    fixed point from the first round trip on."""
    qg, _ = quantized(net, NETS[net])
    blob = pt.graph_to_tm_bytes(qg)
    jg = jt.load_tm_bytes(blob, name=qg.name)
    assert jax_bytes(jg) == blob
    again = _roundtrip(qg)
    assert_ir_equal(jg, again)
    assert pt.graph_to_tm_bytes(again) == blob
    # what the round trip keeps of the graph itself (float params come back
    # as f32, a uniform bias scale list as one entry, as in the JAX package)
    assert [(n.op, n.name, n.inputs, n.outputs) for n in qg.nodes] == [
        (n.op, n.name, n.inputs, n.outputs) for n in again.nodes]
    for a, b in zip(qg.tensors, again.tensors):
        assert (a.name, a.dtype, list(a.shape), a.tensor_type) == (b.name, b.dtype, list(b.shape),
                                                                   b.tensor_type)
        assert (a.data is None) == (b.data is None)
        if a.data is not None:
            np.testing.assert_array_equal(a.data, b.data)
        if a.quant is not None:
            np.testing.assert_array_equal(np.asarray(a.quant.scales, np.float32).reshape(-1)[:1],
                                          np.asarray(b.quant.scales).reshape(-1)[:1])
