"""The PyTorch port's native-int8 plan (Options.quant_native,
graph/passes.py:to_native_int8) against the JAX package, on the CPU: the
graphs of tests/test_native_int8.py, carried to the port as tmfile bytes.

  * the gate: _native_profitable gives the JAX engine's answer on the wide,
    depthwise and narrow fixtures, true on full-width ResNet-50-224 and
    false on mobilenet-v1-224 (both built by chip_smoke.py);
  * the rewritten IR equals the JAX pass's tensor for tensor: dtypes,
    zero points, full_range, the requantized weight bytes, the rescaled
    float biases bit for bit, the weights the pass leaves alone (shared with
    a non-conv consumer, quant arrays of an unexpected size, read from a
    UINT8 graph input) and the per-channel UINT8 weight;
  * numerics, as tests/test_native_int8.py holds the JAX engine: with
    lossless weights the plan is within 1 LSB of the exact engine and of the
    ref oracle, and equal to the JAX engine; on the calibrated wide net the
    default Options keep the relaxed contract against the exact engine;
  * the narrow ResNet-50 (tests/test_torch_resnet.py's SMALL) under
    quant_native="on", INT8 and UINT8, node by node against the JAX engine;
  * routing: under the plan no FusedResBlockChain is built unless
    fuse_resblock=True.

Tolerances, and why: node by node, each port node fed what its JAX
counterpart was fed, 1 LSB on at most 1% of a node's elements (XLA:CPU
contracts acc·M + B, the global average pool's S·f32(1/HW) - zp_in and the
residual sum into fused multiply-adds where the port rounds twice, ROADMAP
§3); free-running logits 2 LSB with at least 95% equal, as
tests/test_torch_resnet.py holds them.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.executor.engine import _native_profitable as jax_profitable  # noqa: E402
from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.graph.passes import to_native_int8 as jax_to_native  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.executor.engine import _native_profitable as port_profitable  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.graph.passes import to_native_int8 as port_to_native  # noqa: E402

from test_native_int8 import (  # noqa: E402
    _conv_params, _lossless_uint8_weights, build_crafted_uint8_graph, build_wide_net,
)
from test_torch_yolofastest import jax_run_all, port_run_all, port_run_forced  # noqa: E402
from test_torch_yolov5 import assert_ir_equal  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import build_mobilenet_v1_graph, build_resnet50_graph  # noqa: E402

SMALL = dict(img=32, classes=16, widths=(8, 16, 32, 64), depths=(2, 2, 2, 2))
BATCH = 2
NATIVE = dict(quant_mode="fast", quant_native="on", batch_size=BATCH)
EXACT = dict(quant_mode="fast", quant_native="off", quant_relaxed=False)


def _both(jg):
    """The JAX graph and the port's reading of its tmfile bytes."""
    blob = graph_to_tm_bytes(jg)
    return jt.load_tm_bytes(blob), pt.load_tm_bytes(blob)


def _run_port(g, opts, xq):
    return pt.compile_graph(g, pt.Options(**opts), device="cpu").run(xq)


def _lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,dw,want", [(64, False, True), (64, True, False), (16, False, False)],
                         ids=["wide", "depthwise", "narrow"])
def test_gate_matches_jax(c, dw, want):
    """The fixtures' VAR tensors carry no shapes: both gates fill them by a
    shape pass of their own engine first."""
    jg, pg = _both(build_wide_net(np.random.default_rng(11), c=c, hw=16, dw=dw))
    assert jax_profitable(jg) is want
    assert port_profitable(pg) is want


def test_gate_on_the_full_size_nets():
    """ResNet-50-224 takes the plan under default Options, mobilenet-v1-224
    (a depthwise net) does not; both engines agree (the graphs carry every
    shape, so neither gate runs a shape pass)."""
    for build, want in ((build_resnet50_graph, True), (build_mobilenet_v1_graph, False)):
        assert jax_profitable(build(jir)) is want
        assert port_profitable(build(pir)) is want


# ---------------------------------------------------------------------------
# the rewritten IR
# ---------------------------------------------------------------------------


def _qp(ir, scale, zp, full_range=False):
    return ir.QuantParam(scales=np.float32(scale), zero_points=np.int32(zp), width=8,
                         full_range=full_range)


def build_edge_graph(rng, c=32, hw=8, odd=True):
    """What the pass leaves alone, and the per-channel weight it requantizes,
    in one hand-quantized UINT8 graph: c1 (per-channel UINT8 weight, reads
    the graph input: left UINT8) -> c2 (per-channel UINT8 weight on an
    internal input: requantized per channel, raw bias rescaled) -> c3 (its
    weight also read by an Eltwise: left as it is) -> c4 (quant arrays of 2
    entries for 32 channels: left as it is; odd=False leaves c4 out, for a
    graph that runs) -> FC (per-tensor, raw bias)."""
    g = jir.Graph(name="edges")
    x = g.add_tensor("x", jir.DType.UINT8, [2, c, hw, hw], jir.TensorType.INPUT,
                     quant=_qp(jir, 0.05, 128))
    inp = g.add_node("InputOp", "input", [], [x.idx])
    g.inputs = [inp.idx]

    def weight(name, shape, quant):
        return g.add_tensor(name, jir.DType.UINT8, list(shape), jir.TensorType.CONST,
                            data=_lossless_uint8_weights(rng, shape), quant=quant)

    def per_channel(n):
        return jir.QuantParam(scales=np.geomspace(0.001, 0.05, n).astype(np.float32),
                              zero_points=rng.integers(100, 156, n).astype(np.int32), width=8)

    def bias(name, n):
        return g.add_tensor(name, jir.DType.INT32, [n], jir.TensorType.CONST,
                            data=rng.integers(-2000, 2000, n).astype(np.int32))

    def conv(name, src, wt, zp, k=3, with_bias=False):
        ins = [src, wt.idx] + ([bias(f"{name}_b", c).idx] if with_bias else [])
        out = g.add_tensor(f"{name}_out", jir.DType.UINT8, [], jir.TensorType.VAR,
                           quant=_qp(jir, 0.3, zp))
        g.add_node("Convolution", name, ins, [out.idx], params=_conv_params(k, 1, k // 2, c, c))
        return out.idx

    t1 = conv("c1", x.idx, weight("w1", (c, c, 3, 3), per_channel(c)), 124, with_bias=True)
    t2 = conv("c2", t1, weight("w2", (c, c, 3, 3), per_channel(c)), 131, with_bias=True)
    w3 = weight("w3", (c, c, 1, 1), _qp(jir, 0.004, 128))
    t3 = conv("c3", t2, w3, 120, k=1, with_bias=True)
    side = g.add_tensor("side", jir.DType.UINT8, [], jir.TensorType.VAR, quant=_qp(jir, 0.01, 128))
    g.add_node("Eltwise", "share", [w3.idx, w3.idx], [side.idx], params=dict(type=2))
    t4 = t3
    if odd:
        quant = jir.QuantParam(scales=np.array([0.004, 0.005], np.float32),
                               zero_points=np.array([128, 127], np.int32), width=8)
        t4 = conv("c4", t3, weight("w4", (c, c, 1, 1), quant), 126, k=1)
    wf = weight("fc_w", (10, c * hw * hw), _qp(jir, 0.004, 128))
    out = g.add_tensor("fc_out", jir.DType.UINT8, [], jir.TensorType.VAR, quant=_qp(jir, 0.2, 128))
    fc = g.add_node("FullyConnected", "fc", [t4, wf.idx, bias("fc_b", 10).idx], [out.idx],
                    params=dict(num_output=10))
    g.outputs = [fc.idx]
    return g


@functools.lru_cache(maxsize=None)
def calibrated_wide_net():
    rng = np.random.default_rng(11)
    g = build_wide_net(rng, n=8, c=64, hw=16)
    calib = [rng.standard_normal((8, 3, 16, 16)).astype(np.float32) for _ in range(2)]
    return g, calib, jax_quantize(g, calib, scheme="uint8")


def _fixture(name):
    rng = np.random.default_rng(11)
    if name == "wide":
        return calibrated_wide_net()[2]
    if name == "crafted":
        return build_crafted_uint8_graph(rng)
    return build_edge_graph(rng)


@pytest.mark.parametrize("name", ["wide", "crafted", "edges"])
def test_rewritten_ir_equals_jax(name):
    """Both passes on the same bytes: the same count and the same IR, node
    for node and tensor for tensor (assert_ir_equal: dtype, QuantParam with
    full_range, data dtype and bytes)."""
    jg, pg = _both(_fixture(name))
    assert port_to_native(pg) == jax_to_native(jg) > 0
    assert_ir_equal(jg, pg)
    boundary = set(pg.input_tensors) | set(pg.output_tensors)
    for t in pg.tensors:
        if t.quant is None or t.is_const:
            continue
        if t.idx in boundary:
            assert t.dtype == pir.DType.UINT8 and not t.quant.full_range, t.name
        else:
            assert t.dtype == pir.DType.INT8 and t.quant.full_range, t.name
            assert -128 <= int(t.quant.zero_points) <= 127, t.name
    for n in pg.nodes:
        if n.op in ("Convolution", "FullyConnected") and len(n.inputs) > 2:
            # a rewritten weight's raw bias becomes float data in a tensor
            # still declared INT32; a weight left alone keeps its int32 bias
            tw, tb = pg.tensors[n.inputs[1]], pg.tensors[n.inputs[2]]
            assert tb.dtype == pir.DType.INT32, n.name
            assert tb.data.dtype == (np.float32 if tw.dtype == pir.DType.INT8 else np.int32), n.name


def test_edge_graph_rewrites_only_what_it_may():
    """The edge graph, tensor by tensor: the weight that reads the graph
    input, the shared one and the oddly quantized one stay UINT8 with their
    bytes and int32 biases; c2's per-channel weight is requantized with each
    channel's own scale and zero point, s_c = max|w_f|/127, its bias
    rescaled by s_old/s_new channel by channel; the FC's per-tensor lossless
    weight becomes w_q - 128 exactly."""
    src = _fixture("edges")
    _, pg = _both(src)
    port_to_native(pg)
    t = {x.name: x for x in pg.tensors}
    s = {x.name: x for x in src.tensors}
    for kept in ("w1", "w3", "w4"):
        assert t[kept].dtype == pir.DType.UINT8 and np.array_equal(t[kept].data, s[kept].data)
    assert t["c1_b"].data.dtype == t["c3_b"].data.dtype == np.int32
    q2 = s["w2"].quant
    s_old = np.asarray(q2.scales, np.float64)
    flat = (s["w2"].data.reshape(32, -1) - np.asarray(q2.zero_points)[:, None]) * s_old[:, None]
    s_new = np.abs(flat).max(axis=1) / 127.0
    assert t["w2"].dtype == pir.DType.INT8 and t["w2"].quant.per_channel
    np.testing.assert_array_equal(t["w2"].quant.scales, s_new.astype(np.float32))
    np.testing.assert_array_equal(t["w2"].quant.zero_points, np.zeros(32, np.int32))
    np.testing.assert_array_equal(t["w2"].data.reshape(32, -1),
                                  np.clip(np.round(flat / s_new[:, None]), -127, 127))
    np.testing.assert_array_equal(
        t["c2_b"].data, (s["c2_b"].data.astype(np.float64) * (s_old / s_new)).astype(np.float32))
    assert t["fc_w"].dtype == pir.DType.INT8
    np.testing.assert_array_equal(t["fc_w"].data, s["fc_w"].data.astype(np.int16) - 128)


def test_weight_requant_rounds_half_to_even():
    """The pass rounds with np.round (half to even), as the JAX pass does,
    not with the port's round-half-away. Per-channel weights built on .5
    ties, exact in binary: scales 2^-6, true values 254, 1, 3, 5 (zp 1)
    and their negatives (zp 255), so s_new = 2^-5 and w/s_new = v/2."""
    g = jir.Graph(name="ties")
    x = g.add_tensor("x", jir.DType.UINT8, [1, 4, 4, 4], jir.TensorType.INPUT,
                     quant=_qp(jir, 0.05, 128))
    inp = g.add_node("InputOp", "input", [], [x.idx])
    mid = g.add_tensor("mid", jir.DType.UINT8, [], jir.TensorType.VAR, quant=_qp(jir, 0.1, 128))
    w0 = g.add_tensor("w0", jir.DType.UINT8, [4, 4, 1, 1], jir.TensorType.CONST,
                      data=np.full((4, 4, 1, 1), 130, np.uint8), quant=_qp(jir, 0.01, 128))
    g.add_node("Convolution", "c0", [x.idx, w0.idx], [mid.idx], params=_conv_params(1, 1, 0, 4, 4))
    wq = np.array([[255, 2, 4, 6], [1, 254, 252, 250]], np.uint8).reshape(2, 4, 1, 1)
    w = g.add_tensor("w", jir.DType.UINT8, [2, 4, 1, 1], jir.TensorType.CONST, data=wq,
                     quant=jir.QuantParam(scales=np.full(2, 2.0 ** -6, np.float32),
                                          zero_points=np.array([1, 255], np.int32), width=8))
    y = g.add_tensor("y", jir.DType.UINT8, [], jir.TensorType.VAR, quant=_qp(jir, 0.2, 128))
    node = g.add_node("Convolution", "c", [mid.idx, w.idx], [y.idx],
                      params=_conv_params(1, 1, 0, 4, 2))
    g.inputs, g.outputs = [inp.idx], [node.idx]
    jg, pg = _both(g)
    assert port_to_native(pg) == jax_to_native(jg)
    assert_ir_equal(jg, pg)
    got = pg.tensors[w.idx].data.reshape(2, 4)
    np.testing.assert_array_equal(got, [[127, 0, 2, 2], [-127, 0, -2, -2]])
    np.testing.assert_array_equal(pg.tensors[w.idx].quant.scales, np.full(2, 2.0 ** -5))


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def _crafted_input(g, seed=11):
    t_in = g.tensors[g.input_tensors[0]]
    return np.random.default_rng(seed).integers(0, 256, [int(d) for d in t_in.shape]).astype(np.uint8)


def test_plan_exact_on_lossless_weights_and_equal_to_jax(monkeypatch):
    """The crafted graph under quant_native="on" with the exact epilogues:
    within 1 LSB of the port's exact engine and of its ref oracle (the
    rewrites are exact; only the f32 association of the folded zero-point
    term may move a value), and equal to the JAX engine's plan."""
    jg, pg = _both(build_crafted_uint8_graph(np.random.default_rng(11)))
    xq = _crafted_input(pg)
    on = dict(quant_mode="fast", quant_native="on", quant_relaxed=False)
    (got,) = _run_port(pg, on, xq)
    (exact,) = _run_port(pg, EXACT, xq)
    (oracle,) = _run_port(pg, dict(quant_mode="ref"), xq)
    (want,) = jt.compile_graph(jg, jt.Options(**on)).run(xq)
    assert got.dtype == np.uint8
    assert _lsb(got, exact).max() <= 1 and _lsb(got, oracle).max() <= 1
    np.testing.assert_array_equal(got, want)


def test_uint8_weight_on_shifted_input_takes_the_shifted_branch(monkeypatch):
    """An INT8 full_range input feeding a conv whose weight is UINT8
    asymmetric: the fast lowering must take the shifted-value branch, not
    read the raw uint8 bytes as int8. Off the plan (the graph of
    tests/test_native_int8.py): within 1 LSB of the ref oracle and equal to
    the JAX engine. Under the plan, on the edge graph, where c3's weight is
    left UINT8 because an Eltwise reads it too: routes and every output
    equal to the JAX engine's."""
    rng = np.random.default_rng(11)
    g = jir.Graph(name="mixed")
    c, hw = 32, 8
    x = g.add_tensor("x", jir.DType.INT8, [2, c, hw, hw], jir.TensorType.INPUT,
                     quant=_qp(jir, 0.05, -7, full_range=True))
    inp = g.add_node("InputOp", "input", [], [x.idx])
    wq = rng.integers(30, 220, size=(c, c, 3, 3)).astype(np.uint8)
    wt = g.add_tensor("w", jir.DType.UINT8, list(wq.shape), jir.TensorType.CONST, data=wq,
                      quant=_qp(jir, 0.004, 117))
    out = g.add_tensor("y", jir.DType.INT8, [], jir.TensorType.VAR,
                       quant=_qp(jir, 0.1, 3, full_range=True))
    node = g.add_node("Convolution", "c", [x.idx, wt.idx], [out.idx],
                      params=_conv_params(3, 1, 1, c, c))
    g.inputs, g.outputs = [inp.idx], [node.idx]
    jg, pg = _both(g)
    xq = rng.integers(-128, 128, size=(2, c, hw, hw)).astype(np.int8)
    opts = dict(quant_mode="fast", quant_relaxed=False)
    (got,) = _run_port(pg, opts, xq)
    (oracle,) = _run_port(pg, dict(quant_mode="ref"), xq)
    (want,) = jt.compile_graph(jg, jt.Options(**opts)).run(xq)
    assert _lsb(got, oracle).max() <= 1
    np.testing.assert_array_equal(got, want)

    blob = graph_to_tm_bytes(build_edge_graph(rng, odd=False))
    xq = _crafted_input(pt.load_tm_bytes(blob))
    on = dict(quant_mode="fast", quant_native="on", batch_size=2)
    jax_env, jax_routes, output_ids = jax_run_all(blob, on, xq, monkeypatch)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**on), device="cpu")
    t = {x.name: x for x in cg.graph.tensors}
    assert t["c2_out"].dtype == pir.DType.INT8 and t["w3"].dtype == pir.DType.UINT8
    for name, kernel in cg.kernels.items():
        assert jax_routes[name] == kernel, name
    env = port_run_all(cg, xq)
    for tid in (t["c3_out"].idx, output_ids[0]):
        np.testing.assert_array_equal(env[tid], jax_env[tid])


def test_default_options_keep_the_relaxed_contract_on_the_wide_net():
    """Default Options take the plan on the calibrated wide net (UINT8): the
    port's result against its exact engine within the JAX test's bounds
    (8 LSB, error against the fp32 engine at most 1.5x the exact engine's
    plus 0.5 LSB, argmax agreement >= 0.85), and against the JAX engine's
    plan within 1 LSB."""
    g, calib, jqg = calibrated_wide_net()
    jg, pg = _both(jqg)
    t_in = pg.tensors[pg.input_tensors[0]]
    xq = jq.quantize_np(calib[0], t_in.quant, t_in.dtype)
    cg = pt.compile_graph(pg, pt.Options(quant_mode="fast"), device="cpu")
    assert any(t.quant is not None and t.quant.full_range for t in cg.graph.tensors)
    (y_nat,) = cg.run(xq)
    (y_exact,) = _run_port(pg, EXACT, xq)
    (y_jax,) = jt.compile_graph(jg, jt.Options(quant_mode="fast")).run(xq)
    assert _lsb(y_nat, y_jax).max() <= 1
    assert _lsb(y_nat, y_exact).max() <= 8
    (y_f32,) = jt.compile_graph(g, jt.Options()).run(calib[0])
    t_out = pg.tensors[pg.output_tensors[0]]
    qtrue = y_f32.reshape(y_nat.shape) / float(t_out.quant.scales) + int(t_out.quant.zero_points)
    err_nat = np.abs(y_nat.astype(np.float64) - qtrue).mean()
    err_exact = np.abs(y_exact.astype(np.float64) - qtrue).mean()
    assert err_nat <= err_exact * 1.5 + 0.5, (err_nat, err_exact)
    agree = (y_nat.reshape(8, -1).argmax(1) == y_exact.reshape(8, -1).argmax(1)).mean()
    assert agree >= 0.85


# ---------------------------------------------------------------------------
# the narrow ResNet-50 under the plan
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def resnet(scheme):
    jg = build_resnet50_graph(jir, **SMALL)
    x = np.random.default_rng(1).standard_normal(
        (BATCH, 3, SMALL["img"], SMALL["img"])).astype(np.float32)
    jqg = jax_quantize(jg, [x[:1]], scheme=scheme, algorithm="minmax")
    t_in = jqg.tensors[jqg.input_tensors[0]]
    return jqg, jq.quantize_np(x, t_in.quant, t_in.dtype)


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_narrow_resnet_under_the_plan_matches_jax(scheme, monkeypatch):
    """_native_profitable is false at these widths, so quant_native="on"
    forces the plan. Routes by name; every node within 1 LSB of its JAX
    counterpart on at most 1% of its elements when fed the same inputs; the
    UINT8 graph's internal tensors shifted to full-range INT8 while its
    input and logits stay UINT8; logits within 2 LSB, 95% equal."""
    jqg, xq = resnet(scheme)
    blob = graph_to_tm_bytes(jqg)
    assert not port_profitable(pt.load_tm_bytes(blob))
    jax_env, jax_routes, output_ids = jax_run_all(blob, NATIVE, xq, monkeypatch)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**NATIVE), device="cpu")
    assert cg.graph._bf16_tids == set()
    for name, kernel in cg.kernels.items():
        assert jax_routes[name] == kernel, name
    assert not any(n.op == "FusedResBlockChain" for n in cg.graph.nodes)
    assert {cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution"} == {
        "lower_conv_quant_fast"}
    shifted = [t for t in cg.graph.tensors if t.quant is not None and t.quant.full_range]
    if scheme == "uint8":
        assert len(shifted) > 30 and all(t.dtype == pir.DType.INT8 for t in shifted)
        for tid in (cg.graph.input_tensors[0], cg.output_ids[0]):
            assert cg.graph.tensors[tid].dtype == pir.DType.UINT8
    else:
        assert not shifted  # the pass is a no-op on a symmetric INT8 graph

    seen, _ = port_run_forced(blob, NATIVE, xq, jax_env, monkeypatch)
    assert {"conv1", "pool1", "pool5", "fc"} <= set(seen) and len(seen) >= 30
    for name, (worst, share) in seen.items():
        assert worst <= 1 and share <= 0.01, (name, worst, share)
    got = port_run_all(cg, xq)[output_ids[0]]
    want = jax_env[output_ids[0]]
    assert got.shape == (BATCH, SMALL["classes"], 1, 1)
    d = _lsb(got, want)
    print(f"{scheme} logits: max |d| {d.max()}, equal fraction {(d == 0).mean():.4f}")
    assert d.max() <= 2 and (d == 0).mean() >= 0.95


@pytest.mark.parametrize("opts,chains", [
    (dict(quant_native="on", chain_min_cmid=0), 0),
    (dict(quant_native="on", fuse_resblock=True), 4),
    (dict(quant_native="off", chain_min_cmid=0), 4),
], ids=["plan", "plan+fuse_resblock", "no plan"])
def test_chains_under_the_plan_only_with_fuse_resblock(opts, chains, monkeypatch):
    """Under the plan quant_relaxed alone builds no chain, even from
    chain_min_cmid = 0; fuse_resblock=True still does; off the plan
    quant_relaxed builds them from chain_min_cmid up. The JAX engine builds
    the same graph: same nodes, same routes."""
    jqg, _ = resnet("int8")  # fuse_resnet_blocks takes symmetric INT8 blocks only
    blob = graph_to_tm_bytes(jqg)
    o = dict(quant_mode="fast", batch_size=BATCH, **opts)
    routes = {}
    import tengine_tpu.executor.engine as jax_engine

    select = jax_engine.select_kernel

    def recording_select(op, ctx):
        k = select(op, ctx)
        routes[ctx.node.name] = k.name
        return k

    monkeypatch.setattr(jax_engine, "select_kernel", recording_select)
    cgj = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**o))
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**o), device="cpu")
    assert [n.op for n in cg.graph.nodes] == [n.op for n in cgj.graph.nodes]
    assert [n.op for n in cg.graph.nodes].count("FusedResBlockChain") == chains
    for name, kernel in cg.kernels.items():
        assert routes[name] == kernel, name
