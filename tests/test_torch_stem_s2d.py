"""The PyTorch port's stem_conv_s2d (graph/passes.py) and Options.stem_s2d
against the JAX package, on the CPU.

The pass rewrites a small-channel stride-2 stem as SpaceToDepth(2, DCR) and
a stride-1 conv over 4C channels with re-indexed weights: the same
multiply-adds, permuted. On the four stems of
tests/test_convert_and_passes.py:149 (k, p) = (6, 2), (7, 3), (3, 1),
(5, 2), each imported from torch by each package's front end:
  * the rewritten IR equals the JAX pass's (ops, params, weights bit for
    bit);
  * float: both engines on the rewritten graph, within rtol 1e-6 (XLA's
    conv and torch's sum the taps in another order), and the port's
    rewritten graph against torch's own stride-2 conv, within 1e-5;
  * quantized (INT8 and UINT8 MinMax, by the port's quantizer): the port's
    output with the pass equals its output without it, bit for bit (the
    integer sums are the same sums; an inserted tap is the weight's zero
    point), and equals the JAX engine's on the graph its pass rewrote
    within 1 LSB on at most 0.1% of the elements (the quantized graph
    passes as tmfile bytes, which hold no SpaceToDepth mode, so each
    package rewrites its own copy).
compile_graph applies the pass at its gate (C_in <= 8, k >= 4, H*W >=
320^2) under Options(stem_s2d=True), in both engines: yolov5s-style 6x6
s2 stem at 320.
Per-channel weights with nonzero zero points (none of the port's quantizer
makes them; a hand-built or imported graph may): the JAX pass fills the
inserted taps with 0, a nonzero weight after the zero point; the port fills
each output channel with its own zero point (test_per_channel_zero_points_
are_not_copied).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.convert.torch_frontend import from_torch as jax_from_torch  # noqa: E402
from tengine_tpu.graph.passes import stem_conv_s2d as jax_s2d  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.convert.torch_frontend import from_torch  # noqa: E402
from tengine_tpu_torch.graph.passes import stem_conv_s2d  # noqa: E402
from tengine_tpu_torch.ops import qmath  # noqa: E402
from tengine_tpu_torch.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

STEMS = [(6, 2), (7, 3), (3, 1), (5, 2)]


class StemNet(torch.nn.Module):
    def __init__(self, k, p, c_out=8):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, c_out, k, stride=2, padding=p)

    def forward(self, x):
        return self.conv(x)


def _stem(k, p, img=32, batch=2):
    torch.manual_seed(0)
    model = StemNet(k, p).eval()
    x = torch.randn(batch, 3, img, img)
    return model, x


def _ir_of(g):
    return ([(n.op, n.name, sorted(n.params.items()), list(n.inputs), list(n.outputs))
             for n in g.nodes],
            [(t.name, list(t.shape), None if t.data is None else t.data.tobytes())
             for t in g.tensors])


@pytest.mark.parametrize("k,p", STEMS)
def test_ir_and_float_match_jax(k, p):
    model, x = _stem(k, p)
    g, jg = from_torch(model, x), jax_from_torch(model, x)
    assert stem_conv_s2d(g, min_kernel=0, min_hw=0) == 1
    assert jax_s2d(jg, min_kernel=0, min_hw=0) == 1
    assert _ir_of(g) == _ir_of(jg)
    s2d = [n for n in g.nodes if n.op == "SpaceToDepth"]
    assert len(s2d) == 1 and s2d[0].params == {"block_size": 2, "mode": "DCR"}

    (got,) = pt.compile_graph(g, pt.Options(), device="cpu").run(x.numpy())
    (want,) = jt.compile_graph(jg, jt.Options()).run(x.numpy())
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(got, model(x).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
@pytest.mark.parametrize("k,p", STEMS)
def test_quantized_output_does_not_move(k, p, scheme):
    model, x = _stem(k, p)
    g = from_torch(model, x)
    rng = np.random.default_rng(1)
    calib = [rng.standard_normal((2, 3, 32, 32)).astype(np.float32) for _ in range(2)]
    qg = pt.quantize_graph(g, calib, scheme=scheme, device="cpu")
    q2 = qg.clone()
    assert stem_conv_s2d(q2, min_kernel=0, min_hw=0) == 1
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(x.numpy(), t_in.quant, t_in.dtype)
    opts = dict(quant_mode="fast", quant_bf16_storage=False)
    (plain,) = pt.compile_graph(qg, pt.Options(**opts), device="cpu").run(xq)
    cg = pt.compile_graph(q2, pt.Options(**opts), device="cpu")
    (got,) = cg.run(xq)
    np.testing.assert_array_equal(got, plain)
    # the JAX engine on the quantized graph (carried as tmfile bytes, which
    # hold no SpaceToDepth mode), rewritten by the JAX pass
    jq = jt.load_tm_bytes(graph_to_tm_bytes(qg))
    assert jax_s2d(jq, min_kernel=0, min_hw=0) == 1
    (want,) = jt.compile_graph(jq, jt.Options(**opts)).run(xq)
    d = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_compile_graph_applies_the_pass_at_its_gate(scheme):
    """Options(stem_s2d=True): a 6x6 s2 stem at 320 (yolov5s's, after the
    Focus fold) becomes SpaceToDepth + a 3x3 s1 conv over 12 channels in
    both engines; the output does not move, and equals the JAX engine's."""
    model, x = _stem(6, 2, img=320, batch=1)
    g = from_torch(model, x)
    calib = [np.random.default_rng(2).standard_normal((1, 3, 320, 320)).astype(np.float32)]
    qg = pt.quantize_graph(g, calib, scheme=scheme, device="cpu")
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(x.numpy(), t_in.quant, t_in.dtype)
    outs = {}
    for s2d in (False, True):
        cg = pt.compile_graph(qg, pt.Options(quant_mode="fast", stem_s2d=s2d), device="cpu")
        convs = [n for n in cg.graph.nodes if n.op == "Convolution"]
        assert [n.op == "SpaceToDepth" for n in cg.graph.nodes].count(True) == s2d
        assert (convs[0].params["kernel_h"], convs[0].params["stride_h"]) == ((3, 1) if s2d
                                                                               else (6, 2))
        outs[s2d] = cg.run(xq)[0]
    assert not any(n.op == "SpaceToDepth" for n in qg.nodes)  # compiled on a clone
    np.testing.assert_array_equal(outs[True], outs[False])
    jq = jt.load_tm_bytes(graph_to_tm_bytes(qg))
    (want,) = jt.compile_graph(jq, jt.Options(quant_mode="fast", stem_s2d=True)).run(xq)
    d = np.abs(outs[True].astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _per_channel_uint8_stem(ir):
    """A UINT8 stem (7x7 s2 p3, 3 -> 8: 49 taps a channel of an input
    channel, 64 after the rewrite) whose weights are per-channel UINT8 with
    nonzero zero points, built with the IR module `ir`."""
    rng = np.random.default_rng(9)
    g = ir.Graph(name="pcstem")
    qp = ir.QuantParam
    x = g.add_tensor("x", ir.DType.UINT8, [1, 3, 32, 32], ir.TensorType.INPUT,
                     quant=qp.per_tensor(0.02, 128, width=8))
    zps = rng.integers(90, 160, 8).astype(np.int32)
    w = g.add_tensor("w", ir.DType.UINT8, [8, 3, 7, 7], ir.TensorType.CONST,
                     data=rng.integers(0, 256, (8, 3, 7, 7)).astype(np.uint8),
                     quant=qp(scales=np.full(8, 0.004, np.float32), zero_points=zps, width=8))
    b = g.add_tensor("b", ir.DType.INT32, [8], ir.TensorType.CONST,
                     data=rng.integers(-500, 500, 8).astype(np.int32),
                     quant=qp(scales=np.full(8, 0.02 * 0.004, np.float32),
                              zero_points=np.zeros(8, np.int32), width=32))
    y = g.add_tensor("y", ir.DType.UINT8, [1, 8, 16, 16], ir.TensorType.VAR,
                     quant=qp.per_tensor(0.05, 100, width=8))
    g.add_node("InputOp", "in", [], [x.idx])
    g.add_node("Convolution", "stem", [x.idx, w.idx, b.idx], [y.idx], params=dict(
        kernel_h=7, kernel_w=7, stride_h=2, stride_w=2, pad_h0=3, pad_h1=3, pad_w0=3,
        pad_w1=3, dilation_h=1, dilation_w=1, group=1, output_channel=8, input_channel=3,
        activation=-1))
    g.inputs, g.outputs = [0], [1]
    g._is_quantized = True
    return g


def test_per_channel_zero_points_are_not_copied():
    """Per-channel UINT8 weights with nonzero zero points, under the
    reference lowering (quant_mode="ref", which reads each channel's zero
    point in both engines; the JAX fast lowering takes a per-channel
    weight's zero points as 0, the port's reads them:
    test_fast_tier_reads_per_channel_zero_points): the port's rewritten
    stem equals its plain one at 0 LSB, and the JAX engine's plain one,
    each inserted tap holding its channel's zero point. The JAX pass writes
    code 0 there: its rewritten stem parts from its plain one, so that
    output is not compared."""
    from tengine_tpu.graph import ir as jir

    from tengine_tpu_torch.graph import ir as pir

    opts = dict(quant_mode="ref")
    xq = np.random.default_rng(4).integers(0, 256, (1, 3, 32, 32)).astype(np.uint8)
    outs = {}
    for name, ir, compile_, s2d_pass, options in (
            ("port", pir, lambda g: pt.compile_graph(g, pt.Options(**opts), device="cpu"),
             stem_conv_s2d, pt.Options),
            ("jax", jir, lambda g: jt.compile_graph(g, jt.Options(**opts)), jax_s2d, jt.Options)):
        g = _per_channel_uint8_stem(ir)
        outs[name, False] = np.asarray(compile_(g).run(xq)[0])
        g2 = _per_channel_uint8_stem(ir)
        assert s2d_pass(g2, min_kernel=0, min_hw=0) == 1
        outs[name, True] = np.asarray(compile_(g2).run(xq)[0])
        if name == "port":  # every inserted tap holds its channel's zero point
            g3 = _per_channel_uint8_stem(ir)
            w = g3.tensors[1]
            w.data = np.full_like(w.data, 255)  # no zero point is 255
            stem_conv_s2d(g3, min_kernel=0, min_hw=0)
            inserted = w.data != 255
            assert w.data.shape == (8, 12, 4, 4)
            assert (inserted.sum(axis=(1, 2, 3)) == 12 * 16 - 3 * 49).all()
            zps = np.asarray(w.quant.zero_points)
            assert (w.data == np.where(inserted, zps[:, None, None, None], 255)).all()
    np.testing.assert_array_equal(outs["port", True], outs["port", False])
    np.testing.assert_array_equal(outs["jax", False], outs["port", False])
    assert np.abs(outs["jax", True].astype(np.int32)
                  - outs["jax", False].astype(np.int32)).max() > 1


def test_fast_tier_reads_per_channel_zero_points():
    """The same per-channel UINT8 stem under quant_mode="fast": the port's
    fast lowering subtracts each output channel's own weight zero point
    (ops/quantized.py:_zp_w), so its fast tier equals its ref tier at 0
    LSB. The JAX fast lowering takes the zero points as 0 and parts from
    its own ref tier, which equals the port's (ROADMAP §3: 255 where the ref
    tier reads 87)."""
    from tengine_tpu.graph import ir as jir

    from tengine_tpu_torch.graph import ir as pir

    xq = np.random.default_rng(4).integers(0, 256, (1, 3, 32, 32)).astype(np.uint8)
    port, jax = {}, {}
    for mode in ("ref", "fast"):
        port[mode] = pt.compile_graph(_per_channel_uint8_stem(pir), pt.Options(quant_mode=mode),
                                      device="cpu").run(xq)[0].astype(np.int32)
        jax[mode] = np.asarray(jt.compile_graph(_per_channel_uint8_stem(jir),
                                                jt.Options(quant_mode=mode)).run(xq)[0],
                               np.int32)
    np.testing.assert_array_equal(port["fast"], port["ref"])
    np.testing.assert_array_equal(jax["ref"], port["ref"])
    d = np.abs(jax["fast"] - port["ref"])
    print(f"JAX fast tier against the ref tier: max |d| {d.max()} LSB, {(d > 1).mean():.3f} "
          "beyond 1")
    assert d.max() > 1 and ((jax["fast"] == 255) & (port["ref"] == 87)).any()
