"""The PyTorch port's quantizer extras against the JAX package, on the CPU:
DFQ (quantize/dfq.py: cross-layer equalization and bias correction) and
EQ (quantize/eq.py: the per-channel weight-scale zoom search behind
quantize_graph(algorithm="eq")).

Graphs are built with the JAX IR and carried to the port as tmfile bytes.
  * equalize_graph / equalize_pair: numpy in both packages, so the
    equalized weights and biases are equal bit for bit; the port's engine
    then holds the equalized graph to the original (fp32, rtol 1e-4, as
    tests/test_dfq.py) and UINT8 gains cosine, as in tests/test_dfq.py.
  * bias_correction: each package runs both graphs on its own engine and
    folds the per-channel mean error into the int32 biases; the corrected
    biases equal JAX's within 1 (the mean of an f32 difference rounds
    apart only where it falls on a .5 of the bias grid), and the error
    does not grow, as in tests/test_dfq.py.
  * EQ: the zoom search runs one torch conv or matmul per zoom on the
    layer's fp32 inputs; the chosen zooms (the new scales over the MinMax
    ones), the scales, the requantized weights and biases equal JAX's bit
    for bit on the nets below: no near-tie flips the arg-max over zooms
    there (a flip would need two zooms' cosines to part by less than the
    last bits in which XLA's and torch's convs differ). quantize_graph
    takes a generator, rejects EQ under UINT8, and guards an all-zero
    channel, as the JAX tests hold the JAX quantizer to.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.graph.ir import DType, Graph, TensorType  # noqa: E402
from tengine_tpu.quantize.dfq import bias_correction as jax_bias_correction  # noqa: E402
from tengine_tpu.quantize.dfq import equalize_graph as jax_equalize  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.ops import qmath  # noqa: E402
from tengine_tpu_torch.quantize.dfq import bias_correction, equalize_graph  # noqa: E402
from tengine_tpu_torch.quantize.eq import ZOOMS  # noqa: E402

from test_dfq import skewed_net  # noqa: E402


def _port(g):
    return pt.load_tm_bytes(graph_to_tm_bytes(g))


def _cos(a, b):
    a, b = a.reshape(-1).astype(np.float64), b.reshape(-1).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _consts(g):
    return {t.name: t.data for t in g.tensors if t.data is not None}


def test_equalize_matches_jax():
    jg = skewed_net(np.random.default_rng(0))
    g = _port(jg)
    assert equalize_graph(g) == jax_equalize(jg) == 1
    want = _consts(jg)
    got = _consts(g)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_dfq_preserves_fp32_and_improves_uint8():
    rng = np.random.default_rng(1)
    g = _port(skewed_net(rng))
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    (y_ref,) = pt.compile_graph(copy.deepcopy(g), pt.Options(), device="cpu").run(x)
    ge = copy.deepcopy(g)
    assert equalize_graph(ge) == 1
    (y_eq,) = pt.compile_graph(copy.deepcopy(ge), pt.Options(), device="cpu").run(x)
    np.testing.assert_allclose(y_eq, y_ref, rtol=1e-4, atol=1e-5)
    w1 = next(t for t in ge.tensors if t.name == "w1").data
    r1 = np.abs(w1.reshape(w1.shape[0], -1)).max(axis=1)
    assert r1.max() / r1.min() < 60  # was 1000x skewed

    calib = [x] + [rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(2)]

    def quant_cos(graph):
        qg = pt.quantize_graph(copy.deepcopy(graph), calib, scheme="uint8", device="cpu")
        t_in = qg.tensors[qg.input_tensors[0]]
        xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
        (yq,) = pt.compile_graph(qg, pt.Options(quant_mode="ref"), device="cpu").run(xq)
        return _cos(qmath.dequantize_np(yq, qg.tensors[qg.output_tensors[0]].quant), y_ref)

    cos_plain, cos_dfq = quant_cos(g), quant_cos(ge)
    assert cos_dfq > cos_plain and cos_dfq > 0.99, (cos_plain, cos_dfq)


@pytest.mark.parametrize("scheme", ["uint8", "int8"])
def test_bias_correction_matches_jax(scheme):
    rng = np.random.default_rng(2)
    jg = skewed_net(rng)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    calib = [x] + [rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(3)]
    jq = jax_quantize(copy.deepcopy(jg), calib, scheme=scheme)
    g, q = _port(jg), _port(jq)
    before = {t.name: t.data.copy() for t in q.tensors if t.dtype == DType.INT32}
    n = bias_correction(g, q, calib, device="cpu")
    assert n == jax_bias_correction(jg, jq, calib) >= 2
    moved = 0
    for t in q.tensors:
        if t.name in before:
            want = next(u for u in jq.tensors if u.name == t.name).data
            assert np.abs(t.data.astype(np.int64) - want).max() <= 1, t.name
            moved += int((t.data != before[t.name]).sum())
    assert moved > 0

    # the error against fp32 does not grow (tests/test_dfq.py's bound)
    t_in = q.tensors[q.input_tensors[0]]
    xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
    (y_ref,) = pt.compile_graph(g, pt.Options(), device="cpu").run(x)
    t_out = q.tensors[q.output_tensors[0]]

    def err(graph):
        (yq,) = pt.compile_graph(graph, pt.Options(quant_mode="fast"), device="cpu").run(xq)
        return np.abs(qmath.dequantize_np(yq, t_out.quant) - y_ref).mean()

    assert err(q) <= err(_port(jax_quantize(copy.deepcopy(jg), calib, scheme=scheme))) * 1.05


def _conv_fc_net(rng, outlier=False):
    """conv 3x3 (relu) -> conv 1x1 (relu) -> FC, with an outlier weight per
    output channel of the first conv on a near-dead input channel when
    `outlier` (tests/test_quantize.py's EQ-must-win case)."""
    g = Graph(name="eqnet")
    x = g.add_tensor("x", DType.FP32, [1, 6, 8, 8], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    cur = x.idx
    shapes = {"c1": (8, 6, 3, 3), "c2": (12, 8, 1, 1)}
    for name, shape in shapes.items():
        w = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        if outlier and name == "c1":
            w *= 0.1
            w[:, 0, 0, 0] = 3.0
        b = (rng.standard_normal(shape[0]) * 0.05).astype(np.float32)
        wt = g.add_tensor(f"{name}/w", DType.FP32, list(shape), TensorType.CONST, data=w)
        bt = g.add_tensor(f"{name}/b", DType.FP32, [shape[0]], TensorType.CONST, data=b)
        out = g.add_tensor(name, DType.FP32, [], TensorType.VAR)
        k = shape[2]
        g.add_node("Convolution", name, [cur, wt.idx, bt.idx], [out.idx], params=dict(
            kernel_h=k, kernel_w=k, stride_h=1, stride_w=1, dilation_h=1, dilation_w=1,
            input_channel=shape[1], output_channel=shape[0], group=1, activation=0,
            pad_h0=k // 2, pad_w0=k // 2, pad_h1=k // 2, pad_w1=k // 2))
        cur = out.idx
    wf = (rng.standard_normal((5, 12 * 64)) * 0.05).astype(np.float32)
    wft = g.add_tensor("fc/w", DType.FP32, list(wf.shape), TensorType.CONST, data=wf)
    bft = g.add_tensor("fc/b", DType.FP32, [5], TensorType.CONST,
                       data=(rng.standard_normal(5) * 0.05).astype(np.float32))
    y = g.add_tensor("y", DType.FP32, [], TensorType.VAR)
    g.add_node("FullyConnected", "fc", [cur, wft.idx, bft.idx], [y.idx], params=dict(num_output=5))
    g.inputs = [inp.idx]
    g.outputs = [g.nodes[-1].idx]
    return g


def _calib(rng, n=2, dead=False):
    out = []
    for _ in range(n):
        c = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
        if dead:
            c[:, 0] *= 1e-3
        out.append(c)
    return out


@pytest.mark.parametrize("outlier", [False, True], ids=["plain", "outlier"])
def test_eq_matches_jax(outlier):
    rng = np.random.default_rng(3)
    jg = _conv_fc_net(rng, outlier)
    calib = _calib(rng, dead=outlier)
    want = jax_quantize(jg, calib, scheme="int8", algorithm="eq")
    got = pt.quantize_graph(_port(jg), calib, scheme="int8", algorithm="eq", device="cpu")
    base = jax_quantize(jg, calib, scheme="int8", algorithm="minmax")
    zooms = np.float32(ZOOMS)
    checked = 0
    for t_w, t_b, t_m in zip(want.tensors, got.tensors, base.tensors):
        assert t_w.name == t_b.name
        if t_w.data is None:
            continue
        np.testing.assert_array_equal(t_b.data, t_w.data, err_msg=t_w.name)
        if t_w.name.endswith("/w"):
            s_eq = np.asarray(t_b.quant.scales)
            np.testing.assert_array_equal(s_eq, np.asarray(t_w.quant.scales))
            # each channel's scale is its MinMax scale times one of the zooms
            ratio = s_eq / np.asarray(t_m.quant.scales)
            assert np.abs(ratio[:, None] - zooms[None]).min(1).max() < 1e-5
            checked += 1
    assert checked == 3
    if outlier:  # the search shrinks the outlier channels' scales (quant_eq.cpp's case)
        w = [t for t in got.tensors if t.name == "c1/w"][0]
        m = [t for t in base.tensors if t.name == "c1/w"][0]
        assert np.all(np.asarray(w.quant.scales) < np.asarray(m.quant.scales) * 0.5)


def test_eq_quantizer_contract():
    """A generator of calibration batches is materialized (EQ reads it a
    second time); EQ under UINT8 raises; an all-zero output channel keeps
    a finite, positive scale."""
    rng = np.random.default_rng(4)
    jg = _conv_fc_net(rng)
    w = jg.tensors[1]
    w.data = w.data.copy()
    w.data[2] = 0.0
    g = _port(jg)
    gen = (c for c in _calib(rng))
    q = pt.quantize_graph(g, gen, scheme="int8", algorithm="eq", device="cpu")
    s = np.asarray(q.tensors[1].quant.scales)
    assert np.all(np.isfinite(s)) and np.all(s > 0)
    with pytest.raises(ValueError):
        pt.quantize_graph(g, _calib(rng), scheme="uint8", algorithm="eq", device="cpu")


def test_eq_on_crnn_matches_jax():
    """DFQ then EQ on the narrow CRNN (tests/test_model_extra.py's size):
    the weights and their scales equal to the JAX package's (no zoom
    flips), the activation scales within rtol 1e-6 and the int32 biases
    within 1 (the FC's input scale is calibrated on the LSTMs' output,
    which the engines round apart in the last bits); the INT8 output
    within 1 LSB of the JAX engine's, its CTC string equal to JAX's."""
    from tengine_tpu.models.extra import build_crnn_graph as jax_crnn

    from tengine_tpu_torch.models.extra import build_crnn_graph, ctc_greedy_decode

    jg, _ = jax_crnn(img_w=48, hidden=32)
    g, _ = build_crnn_graph(img_w=48, hidden=32)
    assert equalize_graph(g) == jax_equalize(jg)
    calib = [np.random.default_rng(s).standard_normal((1, 1, 32, 48)).astype(np.float32)
             for s in range(4)]
    want = jax_quantize(jg, calib, scheme="int8", algorithm="eq")
    got = pt.quantize_graph(g, calib, scheme="int8", algorithm="eq", device="cpu")
    for t_w, t_b in zip(want.tensors, got.tensors):
        if t_w.data is not None and t_w.dtype == DType.INT32:
            # b / (s_in * s_w): s_in is calibrated on the LSTMs' output,
            # whose f32 the engines round apart in the last bits
            assert np.abs(t_b.data.astype(np.int64) - t_w.data).max() <= 1, t_w.name
        elif t_w.data is not None:
            np.testing.assert_array_equal(t_b.data, t_w.data, err_msg=t_w.name)
        if t_w.quant is not None and t_w.name.endswith("/w"):
            np.testing.assert_array_equal(np.asarray(t_b.quant.scales),
                                          np.asarray(t_w.quant.scales))
        elif t_w.quant is not None:
            np.testing.assert_allclose(np.asarray(t_b.quant.scales),
                                       np.asarray(t_w.quant.scales), rtol=1e-6)
    x = calib[0]
    t_in = got.tensors[got.input_tensors[0]]
    xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
    (yq,) = pt.compile_graph(got, pt.Options(quant_mode="fast"), device="cpu").run(xq)
    (yf,) = pt.compile_graph(g, pt.Options(), device="cpu").run(x)
    deq = qmath.dequantize_np(yq, got.tensors[got.output_tensors[0]].quant)
    assert _cos(deq, yf) > 0.99
    (jy,) = jt.compile_graph(want, jt.Options(quant_mode="fast")).run(xq)
    d = np.abs(yq.astype(np.int32) - np.asarray(jy).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(), (d > 0).mean())
    jdeq = qmath.dequantize_np(np.asarray(jy), got.tensors[got.output_tensors[0]].quant)
    assert ctc_greedy_decode(deq.reshape(yf.shape)) == ctc_greedy_decode(jdeq.reshape(yf.shape))


def test_eq_near_tie_on_proportional_channels():
    """A near tie that flips: a 1x1 conv whose weights are all 1. Every zoom
    fake-quantizes a channel to one value, so every zoom's output is
    proportional to the fp32 output and its cosine is 1 up to the last
    bits; the arg-max is decided by rounding, which XLA's conv and torch's
    do apart. Both engines pick a zoom among the tied ones (recorded in
    ROADMAP §3); on the nets above no such tie occurs."""
    from tengine_tpu_torch.quantize.eq import (
        _fake_quant_weight, _layer_out, _per_channel_cosine,
    )

    g = Graph(name="ones")
    x = g.add_tensor("x", DType.FP32, [1, 3, 8, 8], TensorType.INPUT)
    inp = g.add_node("InputOp", "in", [], [x.idx])
    w = np.ones((4, 3, 1, 1), np.float32)
    wt = g.add_tensor("w", DType.FP32, [4, 3, 1, 1], TensorType.CONST, data=w)
    y = g.add_tensor("y", DType.FP32, [1, 4, 8, 8], TensorType.VAR)
    g.add_node("Convolution", "conv", [x.idx, wt.idx], [y.idx], params=dict(
        kernel_h=1, kernel_w=1, stride_h=1, stride_w=1, pad_h0=0, pad_h1=0, pad_w0=0,
        pad_w1=0, dilation_h=1, dilation_w=1, group=1, output_channel=4, input_channel=3,
        activation=-1))
    g.inputs, g.outputs = [inp.idx], [g.nodes[-1].idx]
    calib = [np.random.default_rng(0).standard_normal((1, 3, 8, 8)).astype(np.float32)]
    got = pt.quantize_graph(_port(g), calib, scheme="int8", algorithm="eq", device="cpu")
    want = jax_quantize(g, calib, scheme="int8", algorithm="eq")
    xt = torch.from_numpy(calib[0])
    node = got.nodes[-1]
    ref = _layer_out(xt, torch.from_numpy(w), None, node)
    cos = np.stack([_per_channel_cosine(ref, _layer_out(
        xt, torch.from_numpy(_fake_quant_weight(w, np.full(4, z / 127.0, np.float32))), None,
        node)) for z in ZOOMS])  # [zooms, channels]
    assert np.abs(cos - 1.0).max() < 1e-12  # every zoom ties
    picks = {name: np.asarray(q.tensors[1].quant.scales) * 127.0
             for name, q in (("port", got), ("jax", want))}
    for z in picks.values():
        assert np.abs(z[:, None] - np.float32(ZOOMS)[None]).min(1).max() < 1e-5
    print(f"tied zooms picked: port {picks['port']}, JAX {picks['jax']}")
