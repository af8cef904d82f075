"""Two faults the port shared with the JAX package and repairs (ROADMAP §3,
"Faults in the reference that the port does not copy"), on the CPU, at
small shapes:

  * INT8 Deconvolution. A Deconvolution weight is [C_in, C_out/g, kh, kw],
    and the JAX quantizer takes its per-channel scales along axis 0: C_in
    scales against C_out biases, so it raises wherever C_in != C_out. The
    port's qmath.weight_channels / weight_absmax map each element to its
    output channel as an explicit loop does (g = 1, grouped, depthwise);
    on a Convolution they are axis 0, byte for byte. A conv -> deconv net
    quantized INT8 by the port gets C_out weight and bias scales, and its
    deconv, run through the generic dequantize -> conv_transpose2d ->
    requantize wrapper, is within 1 LSB of a numpy float64 oracle; the
    JAX quantizer raises on it (the depthwise deconv, C_in = C_out, it
    quantizes to the port's bytes).
  * int32 bias overflow. Where round(b / (s_in·s_w)) would not fit int32,
    the JAX quantizer clips it at +-(2^31 - 1); the port raises that
    channel's weight scale (the one UINT8 scale) until the bias lands at
    2^30 (quantizer.fit_bias). On a conv whose input is 1e-6 small and half
    of whose biases are large, the JAX biases saturate and its dequantized
    output parts from fp32; the port's raised channels hold biases of
    about 2^30, the others keep the JAX quantizer's scales and biases, and
    its output's cosine against fp32 is above 0.999. Where every bias
    fits, fit_bias changes nothing: the quantized graph's bytes are those
    of a quantizer without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import torch.nn as nn  # noqa: E402

from tengine_tpu.convert.torch_frontend import from_torch as jax_from_torch  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes as jax_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.convert.torch_frontend import from_torch  # noqa: E402
from tengine_tpu_torch.graph.ir import DType  # noqa: E402
from tengine_tpu_torch.ops import qmath  # noqa: E402
from tengine_tpu_torch.quantize import quantizer  # noqa: E402
from tengine_tpu_torch.quantize.calibrate import weight_quant_int8_perchannel  # noqa: E402

from test_torch_yolofastest import port_run_all  # noqa: E402

# (C_in, C_out, group)
DECONV = {"g1": (8, 4, 1), "grouped": (8, 6, 2), "depthwise": (6, 6, 6)}


def conv_transpose_np(x, w, stride, pad, out_pad, group):
    """A transposed conv in float64 numpy: x [N, C_in, H, W], w [C_in,
    C_out/g, kh, kw]; every input pixel scatters its kh x kw products,
    then pad is cropped off each side and out_pad added at the end."""
    n, c_in, h, wd = x.shape
    _, ocg, kh, kw = w.shape
    cig = c_in // group
    full = np.zeros((n, ocg * group, (h - 1) * stride + kh, (wd - 1) * stride + kw))
    for gi in range(group):
        xs = x[:, gi * cig:(gi + 1) * cig].astype(np.float64)
        ws = w[gi * cig:(gi + 1) * cig].astype(np.float64)
        for ki in range(kh):
            for kj in range(kw):
                full[:, gi * ocg:(gi + 1) * ocg, ki:ki + (h - 1) * stride + 1:stride,
                     kj:kj + (wd - 1) * stride + 1:stride] += np.einsum(
                         "ncij,co->noij", xs, ws[:, :, ki, kj])
    oh = (h - 1) * stride + kh - 2 * pad + out_pad
    ow = (wd - 1) * stride + kw - 2 * pad + out_pad
    return full[:, :, pad:pad + oh, pad:pad + ow]


def deconv_oracle(g, node, x_q):
    """A quantized Deconvolution node of graph g on its quantized input
    x_q (NCHW): dequantize the input, the weight by output channel and the
    int32 bias, conv_transpose in float64, requantize onto the output grid
    (round half away, the output dtype's clip range)."""
    t_x, t_w = g.tensors[node.inputs[0]], g.tensors[node.inputs[1]]
    p = node.params
    assert p["stride_h"] == p["stride_w"] and p["pad_h0"] == p["pad_h1"] == p["pad_w0"]
    assert p["dilation_h"] == p["dilation_w"] == 1
    x = (x_q.astype(np.float64) - float(np.asarray(t_x.quant.zero_points))) * float(
        np.asarray(t_x.quant.scales))
    ch = qmath.weight_channels("Deconvolution", t_w.shape, p["group"])
    w = (t_w.data.astype(np.float64) - np.asarray(t_w.quant.zero_points)[ch]) * np.asarray(
        t_w.quant.scales, np.float64)[ch]
    y = conv_transpose_np(x, w, p["stride_h"], p["pad_h0"], p.get("output_pad_h0", 0), p["group"])
    if len(node.inputs) > 2:
        t_b = g.tensors[node.inputs[2]]
        b = t_b.data.astype(np.float64) * np.asarray(t_b.quant.scales, np.float64).reshape(-1)
        y = y + b.reshape(1, -1, 1, 1)
    t_y = g.tensors[node.outputs[0]]
    lo, hi = qmath.qrange(t_y.dtype, t_y.quant)
    q = qmath.round_away_np(y / float(np.asarray(t_y.quant.scales))) + float(
        np.asarray(t_y.quant.zero_points))
    return np.clip(q, lo, hi).astype(t_y.dtype.np)


@pytest.mark.parametrize("case", list(DECONV))
def test_deconv_weight_channels_by_group(case):
    c_in, c_out, g = DECONV[case]
    rng = np.random.default_rng(1)
    w = rng.standard_normal((c_in, c_out // g, 3, 3)).astype(np.float32)
    want = np.empty((c_in, c_out // g), np.int64)
    amax = np.zeros(c_out, np.float32)
    for i in range(c_in):
        for j in range(c_out // g):
            want[i, j] = (i // (c_in // g)) * (c_out // g) + j
            amax[want[i, j]] = max(amax[want[i, j]], np.abs(w[i, j]).max())
    ch = qmath.weight_channels("Deconvolution", w.shape, g)
    np.testing.assert_array_equal(np.broadcast_to(ch, w.shape), want[:, :, None, None]
                                  * np.ones((1, 1, 3, 3), np.int64))
    np.testing.assert_array_equal(qmath.weight_absmax(w, "Deconvolution", g), amax)
    wq = weight_quant_int8_perchannel(w, "Deconvolution", g)
    assert wq.scales.shape == (c_out,)
    q = qmath.quantize_weight_np(w, wq, DType.INT8, "Deconvolution", g)
    back = qmath.dequantize_weight_np(q, wq, "Deconvolution", g)
    assert np.abs(back - w).max() <= wq.scales.max() / 2 * (1 + 1e-6)
    for o in range(c_out):  # each output channel's largest weight lands on +-127
        assert np.abs(q[np.broadcast_to(ch, w.shape) == o]).max() == 127
    # a Convolution's output channels are axis 0: the old per-axis path's bytes
    wc = rng.standard_normal((c_out, c_in // g, 3, 3)).astype(np.float32)
    qc = weight_quant_int8_perchannel(wc)
    np.testing.assert_array_equal(qmath.quantize_weight_np(wc, qc, DType.INT8, "Convolution"),
                                  qmath.quantize_np(wc, qc, DType.INT8, channel_axis=0))


def deconv_net(c_in, c_out, g):
    torch.manual_seed(0)
    return nn.Sequential(nn.Conv2d(3, c_in, 3, padding=1), nn.ReLU(),
                         nn.ConvTranspose2d(c_in, c_out, 3, stride=2, padding=1,
                                            output_padding=1, groups=g)).eval()


@pytest.mark.parametrize("case", list(DECONV))
def test_int8_deconv_within_1_lsb_of_the_oracle(case):
    c_in, c_out, g = DECONV[case]
    m = deconv_net(c_in, c_out, g)
    example = torch.zeros(1, 3, 8, 8)
    pg, jg = from_torch(m, example), jax_from_torch(m, example)
    x = np.random.default_rng(2).standard_normal((1, 3, 8, 8)).astype(np.float32)
    qg = pt.quantize_graph(pg, [x], scheme="int8", algorithm="minmax", device="cpu")
    (node,) = [n for n in qg.nodes if n.op == "Deconvolution"]
    t_w, t_b = qg.tensors[node.inputs[1]], qg.tensors[node.inputs[2]]
    assert t_w.quant.scales.shape == t_b.quant.scales.shape == (c_out,)
    if c_in == c_out:  # depthwise: one scale a channel along axis 0, as the JAX quantizer has it
        jqg = jax_quantize(jg, [x], scheme="int8", algorithm="minmax")
        (jn,) = [n for n in jqg.nodes if n.op == "Deconvolution"]
        np.testing.assert_array_equal(jqg.tensors[jn.inputs[1]].data, t_w.data)
        np.testing.assert_array_equal(jqg.tensors[jn.inputs[1]].quant.scales, t_w.quant.scales)
    else:
        with pytest.raises(ValueError, match="broadcast"):
            jax_quantize(jg, [x], scheme="int8", algorithm="minmax")
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
    cg = pt.compile_graph(qg, pt.Options(quant_mode="fast"), device="cpu")
    assert cg.kernels[node.name] == "lower_deconv"
    env = port_run_all(cg, xq)
    got, want = env[node.outputs[0]], deconv_oracle(qg, node, env[node.inputs[0]])
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(), (d > 0).mean())
    (fp32,) = pt.compile_graph(pg, pt.Options(precision="fp32"), device="cpu").run(x)
    t_y = qg.tensors[node.outputs[0]]
    deq = qmath.dequantize_np(got, t_y.quant).ravel()
    assert deq @ fp32.ravel() / (np.linalg.norm(deq) * np.linalg.norm(fp32)) > 0.999


# --- the int32 bias --------------------------------------------------------------


def bias_net(seed=3, big=1.0):
    """One 3x3 conv, 8 output channels, its weights ~1e-2 and its input
    ~1e-6 (s_in·s_w ~ 1e-11): the even channels' biases `big`, which do not
    fit int32 at that scale where big = 1, the odd ones 1e-4, which do."""
    torch.manual_seed(seed)
    m = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1)).eval()
    with torch.no_grad():
        m[0].weight.mul_(0.05)
        m[0].bias.copy_(torch.tensor([big, 1e-4] * 4) * torch.tensor([1, -1, -1, 1] * 2))
    x = (np.random.default_rng(seed).standard_normal((1, 3, 8, 8)) * 1e-6).astype(np.float32)
    return m, x


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_bias_that_does_not_fit_raises_the_weight_scale(scheme):
    m, x = bias_net()
    example = torch.zeros(1, 3, 8, 8)
    pg, jg = from_torch(m, example), jax_from_torch(m, example)
    qg = pt.quantize_graph(pg, [x], scheme=scheme, algorithm="minmax", device="cpu")
    jqg = jax_quantize(jg, [x], scheme=scheme, algorithm="minmax")
    (node,) = [n for n in qg.nodes if n.op == "Convolution"]
    (jn,) = [n for n in jqg.nodes if n.op == "Convolution"]
    b, jb = (g.tensors[n.inputs[2]].data.astype(np.int64) for g, n in ((qg, node), (jqg, jn)))
    s_w = np.asarray(qg.tensors[node.inputs[1]].quant.scales).reshape(-1)
    js_w = np.asarray(jqg.tensors[jn.inputs[1]].quant.scales).reshape(-1)
    top = 2**31 - 1
    big = np.arange(8) % 2 == 0
    assert (np.abs(jb[big]) == top).all() and (np.abs(jb[~big]) < top).all()
    assert (np.abs(b) < top).all()
    if scheme == "int8":
        # the raised channels' biases at 2^30, give or take the f32 roundings
        np.testing.assert_allclose(np.abs(b[big]), 2**30, rtol=1e-6)
        assert (s_w[big] > js_w[big]).all()
        np.testing.assert_array_equal(s_w[~big], js_w[~big])
        np.testing.assert_array_equal(b[~big], jb[~big])
    else:
        # one scale: raised until the largest bias lands at 2^30
        assert s_w.size == 1 and s_w[0] > js_w[0]
        assert np.abs(b).max() == pytest.approx(2**30, rel=1e-6)
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
    (fp32,) = pt.compile_graph(pg, pt.Options(precision="fp32"), device="cpu").run(x)
    t_out = qg.tensors[qg.output_tensors[0]]

    def cosine(q):
        d = qmath.dequantize_np(np.asarray(q), t_out.quant).ravel().astype(np.float64)
        return d @ fp32.ravel() / (np.linalg.norm(d) * np.linalg.norm(fp32) + 1e-30)

    (got,) = pt.compile_graph(qg, pt.Options(quant_mode="fast"), device="cpu").run(xq)
    (jax_got,) = pt.compile_graph(pt.load_tm_bytes(jax_bytes(jqg)), pt.Options(quant_mode="fast"),
                                  device="cpu").run(xq)
    assert cosine(got) > 0.999 and cosine(jax_got) < 0.9, (cosine(got), cosine(jax_got))


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_bias_that_fits_leaves_the_graph_as_it_was(scheme, monkeypatch):
    """fit_bias where every bias fits (bias_net with small biases, and
    chip_smoke's narrow mobilenet): the same bytes as a quantizer without
    it, whose bias path is the JAX quantizer's."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from tengine_tpu_torch.graph import ir as pir

    m, x = bias_net(big=1e-4)
    graphs = [(from_torch(m, torch.zeros(1, 3, 8, 8)), x)]
    g = chip_smoke.build_mobilenet_v1_graph(pir, img=32, classes=10, widths=tuple(
        max(8, w // 4) for w in chip_smoke.MOBILENET_WIDTHS))
    graphs.append((g, np.random.default_rng(4).standard_normal((1, 3, 32, 32)).astype(np.float32)))
    for g, x in graphs:
        with_fit = pt.graph_to_tm_bytes(pt.quantize_graph(g, [x], scheme=scheme, device="cpu"))
        monkeypatch.setattr(quantizer, "fit_bias", lambda wq, *a, **k: wq)
        without = pt.graph_to_tm_bytes(pt.quantize_graph(g, [x], scheme=scheme, device="cpu"))
        monkeypatch.undo()
        assert with_fit == without


def saturated_channels(jqg):
    """{tensor id: bool mask over output channels} of graph jqg (the JAX
    quantizer's) for the weight and the bias of each node whose int32 bias
    it saturated at +-(2^31 - 1) in some channel: where the port's
    quantizer raised the weight scale instead (quantizer.fit_bias), so
    those channels' scales, weights and biases are the port's own."""
    out = {}
    for n in jqg.nodes:
        if n.op not in ("Convolution", "FullyConnected", "Deconvolution") or len(n.inputs) < 3:
            continue
        b = jqg.tensors[n.inputs[2]]
        if b.data is None or b.dtype.name != "INT32":
            continue
        mask = np.abs(b.data.astype(np.int64).reshape(-1)) == 2**31 - 1
        if mask.any():
            out[n.inputs[1]] = out[n.inputs[2]] = mask
    return out


def assert_agree_but_raised(a, b, mask, op="Convolution", group=1):
    """Weight or bias tensor a (the JAX quantizer's) against b (the port's):
    the channels outside `mask` equal (the scales and the weights; the
    int32 biases within 1 or rtol 1e-5: b / (s_in·s_w) over two
    calibrations an ULP apart), those inside raised: the port's weight
    scale larger, its bias |q| at 2^30 within rtol 1e-5. A per-tensor
    weight grid with any channel raised: its one scale larger."""
    sa, sb = (np.asarray(t.quant.scales, np.float64).reshape(-1) for t in (a, b))
    if a.dtype.name == "INT32":
        np.testing.assert_allclose(b.data.reshape(-1)[~mask], a.data.reshape(-1)[~mask],
                                   rtol=1e-5, atol=1, err_msg=a.name)
        np.testing.assert_allclose(np.abs(b.data.reshape(-1)[mask].astype(np.float64)), 2**30,
                                   rtol=1e-5)
        return
    if sa.size == 1:
        assert sb[0] > sa[0], a.name
        return
    np.testing.assert_array_equal(sa[~mask], sb[~mask])
    assert (sb[mask] > sa[mask]).all(), a.name
    keep = np.broadcast_to(~mask[qmath.weight_channels(op, a.data.shape, group)], a.data.shape)
    np.testing.assert_array_equal(a.data[keep], b.data[keep])
