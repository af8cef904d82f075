"""The PyTorch port's fold_shuffle_gathers (graph/passes.py) against the
JAX pass, on the CPU.

On chip_smoke.py:build_shufflenet_v2_graph at a narrow width (stem 8,
stages 16/32/64, conv5 64, 16 classes) and img 64, quantized UINT8 MinMax
by the JAX quantizer (which pins one grid across each concat -> shuffle ->
slice chain): each package's pass on its own copy of the graph (read from
the same tmfile bytes) folds the same 16 chains into the same IR, node for
node and tensor for tensor; the whole net in both engines under
Options(quant_mode="fast") (the ChannelGather and ShuffleChannel
passthroughs, the scattered 1x1 weights on the fast lowering) and under
quant_bf16_storage=False (those convs on qconv1x1's lowering, its plain
version here), with the fold on and with TT_FOLD_SHUFFLE=0.

Two faults of the JAX pass are not copied, and the cases that show them
compare the port with itself, not with JAX (the JAX pass's result is the
fault): a per-channel UINT8 weight with nonzero zero points (the JAX pass
fills its unused columns with code 0, which dequantizes to -zp_c * s_c),
and a caffe Slice whose slice_points do not split it into its outputs (the
JAX pass folds what its zip reaches and leaves the rest without a
producer).

Tolerances: the folded IR equal to the JAX pass's bit for bit; outputs
within 1 LSB of the JAX engine's (the requant epilogues' fused
multiply-add on XLA:CPU against the port's two roundings; measured 0);
folded = unfolded in the port at 0 LSB (the fold moves integers only).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.graph.passes import fold_shuffle_gathers as jax_fold  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.graph.passes import fold_shuffle_gathers as port_fold  # noqa: E402

from test_torch_compiled import run_without_host_transfer  # noqa: E402
from test_torch_yolov5 import assert_ir_equal  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import build_shufflenet_v2_graph  # noqa: E402

IMG, BATCH = 64, 2
SMALL = dict(img=IMG, classes=16, stem=8, widths=(16, 32, 64), conv5=64)
TIERS = {
    "S": dict(quant_mode="fast", batch_size=BATCH),
    "T": dict(quant_mode="fast", quant_bf16_storage=False, batch_size=BATCH),
}
FOLDS = 16  # one shuffle a unit: 4 + 8 + 4


@functools.lru_cache(maxsize=None)
def net():
    """The JAX-quantized narrow net as tmfile bytes, and its UINT8 input."""
    g = build_shufflenet_v2_graph(jir, **SMALL)
    x = np.random.default_rng(1).standard_normal((BATCH, 3, IMG, IMG)).astype(np.float32)
    qg = jax_quantize(g, [x[:1]], scheme="uint8", algorithm="minmax")
    t_in = qg.tensors[qg.input_tensors[0]]
    return graph_to_tm_bytes(qg), jq.quantize_np(x, t_in.quant, t_in.dtype)


def test_graph_is_the_same_with_both_ir_modules():
    """At the published size (224, stages 116/232/464 of 4/8/4 units,
    conv5 1024: 56 convs, 16 shuffles, 13 slices) and at the test's."""
    full = [build_shufflenet_v2_graph(ir) for ir in (jir, pir)]
    assert_ir_equal(*full)
    ops = [n.op for n in full[1].nodes]
    assert (ops.count("Convolution"), ops.count("ShuffleChannel"), ops.count("Slice")) == (56, 16, 13)
    assert_ir_equal(*(build_shufflenet_v2_graph(ir, **SMALL) for ir in (jir, pir)))


def test_folded_ir_equals_the_jax_pass():
    """Each package's pass on its own copy of the quantized graph: the same
    fold count and the same IR, node for node (the Noop shells, the
    ChannelGather nodes and their indices, the scattered and permuted
    weights with their zero-point columns)."""
    blob, _ = net()
    jg, pg = jt.load_tm_bytes(blob), pt.load_tm_bytes(blob)
    n_jax, n_port = jax_fold(jg), port_fold(pg)
    assert n_jax == n_port == FOLDS
    assert_ir_equal(jg, pg)
    ops = [n.op for n in pg.nodes]
    assert "ShuffleChannel" not in ops and ops.count("ChannelGather") == 13
    scattered = [t for t in pg.tensors if t.name.endswith("/shfold")]
    assert scattered and all(
        (t.data == int(np.asarray(t.quant.zero_points))).any() for t in scattered)


@pytest.mark.parametrize("fold", ["1", "0"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_whole_net_matches_jax(tier, fold, monkeypatch):
    """Both engines on the same bytes, the fold on or off in both
    (TT_FOLD_SHUFFLE): the same routes by name, the logits within 1 LSB;
    in the port, folded = unfolded at 0 LSB."""
    blob, xq = net()
    opts = TIERS[tier]
    monkeypatch.setenv("TT_FOLD_SHUFFLE", fold)
    want = np.asarray(jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**opts)).run(xq)[0])
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    (got,) = run_without_host_transfer(cg, xq)
    ops = [n.op for n in cg.graph.nodes]
    assert ops.count("ChannelGather") == (13 if fold == "1" else 0)
    assert ops.count("ShuffleChannel") == (0 if fold == "1" else FOLDS)
    kernels = {cg.kernels[n.name] for n in cg.graph.nodes if n.op in ("ChannelGather",
                                                                      "ShuffleChannel")}
    assert kernels == {"_lower"}  # the passthroughs
    routes = [cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution"]
    assert routes.count("lower_conv_quant_pallas_direct") == (36 if tier == "T" else 0)
    assert got.shape == want.shape == (BATCH, 16, 1, 1) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    monkeypatch.setenv("TT_FOLD_SHUFFLE", "1" if fold == "0" else "0")
    other = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu").run(xq)[0]
    np.testing.assert_array_equal(got, other)


def _qp(ir, scale, zp):
    return ir.QuantParam(scales=np.asarray(scale, np.float32),
                         zero_points=np.asarray(zp, np.int32))


def shuffle_chain_graph(ir, rng, per_channel_zp=False, slice_points=None, C=32, HW=6):
    """conv 1x1 -> ShuffleChannel(2) -> Slice (axis 1, caffe) into two
    halves -> conv 1x1 on the second half, Concat with the first, on one
    UINT8 grid, hand-quantized. per_channel_zp: the convs' UINT8 weights
    per out channel with nonzero zero points (quant_tool_uint8_perchannel).
    slice_points: the Slice's points as written (a malformed one gives a
    third, unused output no point reaches)."""
    grid = _qp(ir, 0.08, 121)

    def weights(name, o, i):
        if per_channel_zp:
            zps = rng.integers(90, 160, o)
            q = _qp(ir, rng.uniform(0.002, 0.006, o), zps)
        else:
            zps = np.full(o, 128)
            q = _qp(ir, 0.004, 128)
        w = np.clip(np.rint(zps[:, None, None, None] + rng.normal(0, 40, (o, i, 1, 1))), 0, 255)
        w = w.astype(np.uint8)
        return g.add_tensor(name, ir.DType.UINT8, [o, i, 1, 1], ir.TensorType.CONST,
                            data=w, quant=q)

    def conv_params(c_in, c_out):
        return dict(kernel_h=1, kernel_w=1, stride_h=1, stride_w=1, dilation_h=1, dilation_w=1,
                    group=1, activation=-1, pad_h0=0, pad_h1=0, pad_w0=0, pad_w1=0,
                    input_channel=c_in, output_channel=c_out)

    g = ir.Graph(name="shuffle-chain")
    x = g.add_tensor("x", ir.DType.UINT8, [BATCH, C, HW, HW], ir.TensorType.INPUT,
                     quant=_qp(ir, 0.05, 128))
    inp = g.add_node("InputOp", "in", [], [x.idx])
    t1 = g.add_tensor("c1", ir.DType.UINT8, [BATCH, C, HW, HW], ir.TensorType.VAR, quant=grid)
    g.add_node("Convolution", "conv1", [x.idx, weights("w1", C, C).idx], [t1.idx],
               conv_params(C, C))
    t2 = g.add_tensor("sh", ir.DType.UINT8, [BATCH, C, HW, HW], ir.TensorType.VAR, quant=grid)
    g.add_node("ShuffleChannel", "shuf", [t1.idx], [t2.idx], dict(group=2))
    points = [C // 2] if slice_points is None else slice_points
    n_out = len(points) + 1 if slice_points is None else 3
    outs = [g.add_tensor(f"s{i}", ir.DType.UINT8, [BATCH, C // 2, HW, HW], ir.TensorType.VAR,
                         quant=grid) for i in range(n_out)]
    g.add_node("Slice", "sl", [t2.idx], [t.idx for t in outs],
               dict(axis=1, iscaffe=1, slice_points=points))
    t3 = g.add_tensor("c2", ir.DType.UINT8, [BATCH, C // 2, HW, HW], ir.TensorType.VAR,
                      quant=grid)
    g.add_node("Convolution", "conv2", [outs[1].idx, weights("w2", C // 2, C // 2).idx],
               [t3.idx], conv_params(C // 2, C // 2))
    t4 = g.add_tensor("cc", ir.DType.UINT8, [BATCH, C, HW, HW], ir.TensorType.VAR, quant=grid)
    cat = g.add_node("Concat", "cat", [outs[0].idx, t3.idx], [t4.idx], dict(axis=1))
    g.inputs, g.outputs = [inp.idx], [cat.idx]
    return g


def _run(cg, xq):
    return run_without_host_transfer(cg, xq)[0]


def test_per_channel_zero_points_are_not_copied(monkeypatch):
    """Per-channel UINT8 weights with nonzero zero points, under the
    native-int8 plan (which reads a per-channel UINT8 weight's zero points
    and requantizes it to symmetric INT8): the port's folded net equals its
    unfolded one at 0 LSB, its scattered weight holding each out channel's
    zero point in the unused columns. The JAX pass writes code 0 there: its
    folded weight dequantizes to -zp_c * s_c in those columns and its
    folded net parts from its unfolded one, so this case is not compared
    with JAX's fast tier. conv1 reads the graph input, so the plan leaves
    its weight UINT8 per channel for the fast lowering, which in the JAX
    package takes those zero points as 0 (ROADMAP §3) and in the port reads
    them: the port's unfolded net is held to the reference tier instead,
    within 1 LSB (the bound of the fast tier against it), where the JAX
    engine's ref tier equals the port's at 0 LSB."""
    opts = dict(quant_mode="fast", quant_native="on")
    rng = np.random.default_rng(5)
    xq = rng.integers(0, 256, (BATCH, 32, 6, 6)).astype(np.uint8)
    outs = {}
    for fold in ("1", "0"):
        monkeypatch.setenv("TT_FOLD_SHUFFLE", fold)
        g = shuffle_chain_graph(pir, np.random.default_rng(7), per_channel_zp=True)
        cg = pt.compile_graph(g, pt.Options(**opts), device="cpu")
        assert ("ChannelGather" in [n.op for n in cg.graph.nodes]) == (fold == "1")
        outs[fold] = _run(cg, xq)
        jg = shuffle_chain_graph(jir, np.random.default_rng(7), per_channel_zp=True)
        outs["jax", fold] = np.asarray(jt.compile_graph(jg, jt.Options(**opts)).run(xq)[0])
    np.testing.assert_array_equal(outs["1"], outs["0"])
    ref = dict(quant_mode="ref")
    g = shuffle_chain_graph(pir, np.random.default_rng(7), per_channel_zp=True)
    port_ref = pt.compile_graph(g, pt.Options(**ref), device="cpu").run(xq)[0].astype(np.int32)
    jg = shuffle_chain_graph(jir, np.random.default_rng(7), per_channel_zp=True)
    np.testing.assert_array_equal(np.asarray(jt.compile_graph(jg, jt.Options(**ref)).run(xq)[0]),
                                  port_ref)
    assert np.abs(outs["0"].astype(np.int32) - port_ref).max() <= 1
    for fold in ("1", "0"):
        assert np.abs(outs["jax", fold].astype(np.int32) - outs["0"].astype(np.int32)).max() > 1

    g = shuffle_chain_graph(pir, np.random.default_rng(7), per_channel_zp=True)
    assert port_fold(g) == 1
    (w,) = [t for t in g.tensors if t.name.endswith("/shfold")]
    zps = np.asarray(w.quant.zero_points).reshape(-1, 1)
    # the second half of the shuffled channels reads input channels 8-15
    # and 24-31: the columns of the others are unused
    unused = [k for k in range(32) if k % 16 < 8]
    np.testing.assert_array_equal(w.data[:, unused, 0, 0], np.broadcast_to(zps, (16, 16)))


def test_malformed_slice_points_leave_the_chain_alone(monkeypatch):
    """A caffe Slice with three outputs and one point: the port's pass
    leaves that chain as it is (count 0, the shuffle and slice kept) and
    the net runs as unfolded. The JAX pass folds what its zip reaches and
    turns the Slice into an output-less Noop, so the third output has no
    producer: the JAX result is the fault, and this case is not compared
    with JAX."""
    g = shuffle_chain_graph(pir, np.random.default_rng(7), slice_points=[16])
    before = [(n.op, list(n.inputs), list(n.outputs)) for n in g.nodes]
    assert port_fold(g) == 0
    assert [(n.op, list(n.inputs), list(n.outputs)) for n in g.nodes] == before

    jg = shuffle_chain_graph(jir, np.random.default_rng(7), slice_points=[16])
    third = jg.nodes[3].outputs[2]
    assert jax_fold(jg) == 1
    assert all(third not in n.outputs for n in jg.nodes)  # no producer left

    xq = np.random.default_rng(5).integers(0, 256, (BATCH, 32, 6, 6)).astype(np.uint8)
    outs = []
    for fold in ("1", "0"):
        monkeypatch.setenv("TT_FOLD_SHUFFLE", fold)
        cg = pt.compile_graph(shuffle_chain_graph(pir, np.random.default_rng(7),
                                                  slice_points=[16]),
                              pt.Options(quant_mode="fast"), device="cpu")
        assert [n.op for n in cg.graph.nodes].count("ShuffleChannel") == 1
        outs.append(_run(cg, xq))
    np.testing.assert_array_equal(*outs)
