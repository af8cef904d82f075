"""The PyTorch port's normalizations, activations, resizes, relayouts,
Deconvolution, ShuffleChannel and ChannelGather (ops/lowering.py) and the
ShuffleChannel / ChannelGather passthroughs (ops/quantized.py) against the
JAX package, on the CPU.

Each case is a one-node graph, or the node after a 1x1 conv so that its
input arrives in the conv's NHWC layout (the conv reverses the channels:
its weights are a permutation matrix, exact in both engines, float and
quantized). Both graphs come from one builder, run once with each IR
module; where the tmfile format carries every param of the node, the port
reads the JAX graph's tmfile bytes instead (the mode of SpaceToDepth /
DepthToSpace and the ChannelGather node, which only the shuffle fold makes,
have no tmfile record). Float: both engines on the same input. Quantized
(UINT8 MinMax by the JAX quantizer, its QuantParams carried to the port):
both engines under Options(quant_mode="fast"); ShuffleChannel and
ChannelGather on their passthroughs (the stored integers moved as they
are), every other node through the generic dequantize -> f32 -> requantize
wrapper, as the JAX engine routes them. Every port forward runs with
torch's host upload and sync calls patched to raise, as the captured
forward on the card needs.

Tolerances, and why:
  * float, data movement (Pad, ShuffleChannel, ChannelGather, SpaceToDepth,
    DepthToSpace, Reorg, nearest resizes, Clip, Threshold, ReLu6, ReLU1,
    Absval, Ceil, Round, ZerosLike, the Unary table's exact entries):
    equal bit for bit;
  * float, a multiply-add a value or a sum of products (BatchNormalization,
    Scale, PReLU, HardSwish, Hardsigmoid, Reciprocal, Deconvolution): rtol
    1e-6 (XLA:CPU contracts x*s + b into one fused multiply-add where torch
    rounds twice, and sums the taps in another order);
  * float, transcendental (Logistic, Sigmoid, Tanh, Mish, Softplus, Gelu,
    Elu, Selu, Normalize, L2Normalization, the Unary table's functions)
    and the bilinear resizes: rtol 1e-5 (XLA's and torch's exp, log, erfc,
    rsqrt and sums round apart in the last bits);
  * both with an absolute floor of 1e-6 of the output's largest magnitude:
    where a value cancels to near 0 (x*s + b, exp(x) - 1) one rounding
    apart is a large part of it;
  * quantized: ShuffleChannel and ChannelGather on their passthroughs
    equal bit for bit; through the wrapper at most 1 LSB, on at most 0.1%
    of the elements (a last-bit parting of the f32 value meets a .5 tie of
    the requant).
Measured here: 0 LSB on every quantized case; float within 4.4e-7 of the
output's largest magnitude (the dilated Deconvolution), every exact case
equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
import tengine_tpu.executor.engine as jax_engine  # noqa: E402
from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402

from test_torch_compiled import run_without_host_transfer  # noqa: E402


def one_node_graph(ir, op, params, shape, conv=False, consts=()):
    """input [-> 1x1 conv reversing the channels, so the node reads NHWC]
    -> op, built with the IR module `ir`; consts (float32 numpy arrays)
    follow the data input."""
    g = ir.Graph(name=f"{op}_one_node")
    x = g.add_tensor("in0", ir.DType.FP32, list(shape), ir.TensorType.INPUT)
    inp = g.add_node("InputOp", "input0", [], [x.idx])
    src = x.idx
    if conv:
        c = shape[1]
        w = g.add_tensor("conv.w", ir.DType.FP32, [c, c, 1, 1], ir.TensorType.CONST,
                         data=np.eye(c, dtype=np.float32)[::-1].reshape(c, c, 1, 1).copy())
        y = g.add_tensor("conv.out", ir.DType.FP32, list(shape), ir.TensorType.VAR)
        g.add_node("Convolution", "conv", [x.idx, w.idx], [y.idx], dict(
            kernel_h=1, kernel_w=1, stride_h=1, stride_w=1, dilation_h=1, dilation_w=1,
            input_channel=c, output_channel=c, group=1, activation=-1,
            pad_h0=0, pad_w0=0, pad_h1=0, pad_w1=0))
        src = y.idx
    ins = [src] + [g.add_tensor(f"c{i}", ir.DType.FP32, list(d.shape), ir.TensorType.CONST,
                                data=d).idx for i, d in enumerate(consts)]
    out = g.add_tensor("out0", ir.DType.FP32, [], ir.TensorType.VAR)
    g.add_node(op, op.lower(), ins, [out.idx], params)
    g.inputs, g.outputs = [inp.idx], [g.nodes[-1].idx]
    return g


def _vec(seed, n, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


C = 8
S4 = (2, C, 12, 16)
BN = (_vec(1, C, 0.5, 1.5), _vec(2, C), _vec(3, C), _vec(4, C, 0.2, 2.0))
EXACT, AFFINE, TRANSCENDENTAL = "exact", "affine", "transcendental"
# How a case compares (float): EXACT bit for bit, AFFINE rtol 1e-6,
# TRANSCENDENTAL rtol 1e-5; both with a floor of 1e-6 of the output's
# largest magnitude.
PAD = dict(pad_n_0=0, pad_n_1=0, pad_c_0=0, pad_c_1=0, pad_h_0=0, pad_h_1=0, pad_w_0=0,
           pad_w_1=0, mode=0, value=0.0)
INTERP = dict(resize_type=2, width_scale=1.0, height_scale=1.0, output_width=0, output_height=0)


def _deconv(i, o_g, k, group=1, stride=1, pads=(0, 0, 0, 0), dil=1, out_pad=0, act=-1,
            bias=True, seed=5):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((i, o_g, k, k)) * 0.3).astype(np.float32)
    consts = (w,) + ((_vec(seed + 1, o_g * group),) if bias else ())
    params = dict(num_output=o_g * group, kernel_h=k, kernel_w=k, stride_h=stride,
                  stride_w=stride, pad_h0=pads[0], pad_w0=pads[1], pad_h1=pads[2],
                  pad_w1=pads[3], dilation_h=dil, dilation_w=dil, group=group, activation=act,
                  output_pad_h0=out_pad, output_pad_w0=out_pad)
    return ("Deconvolution", params, S4, consts, None, AFFINE)


# name: (op, params, input shape, consts, input kind, comparison); input
# kinds: None standard normal x 2, "pos" |x| + 0.5, "unit" 0.9 tanh(x)
CASES = {
    "batchnorm": ("BatchNormalization", dict(rescale_factor=1.0, eps=1e-5, caffe_flavor=0),
                  S4, BN, None, AFFINE),
    "batchnorm-caffe": ("BatchNormalization", dict(rescale_factor=2.0, eps=1e-3, caffe_flavor=1),
                        S4, BN, None, AFFINE),
    "batchnorm-2d": ("BatchNormalization", dict(rescale_factor=1.0, eps=2e-5, caffe_flavor=0),
                     (4, C), BN, None, AFFINE),
    "batchnorm-3d": ("BatchNormalization", dict(rescale_factor=1.0, eps=1e-5, caffe_flavor=0),
                     (2, C, 5), BN, None, AFFINE),
    "scale": ("Scale", dict(axis=1, num_axes=1, bias_term=1), S4, BN[:2], None, AFFINE),
    "scale-nobias": ("Scale", dict(axis=1, num_axes=1, bias_term=0), S4, BN[:1], None, AFFINE),
    "normalize": ("Normalize", dict(across_spatial=0, channel_shared=0), S4, BN[:1], None,
                  TRANSCENDENTAL),
    "l2norm": ("L2Normalization", {}, (4, C), (), None, TRANSCENDENTAL),
    "l2norm-4d": ("L2Normalization", {}, S4, (), None, TRANSCENDENTAL),
    "prelu": ("PReLU", {}, S4, (_vec(6, C, 0.0, 0.5),), None, AFFINE),
    "prelu-2d": ("PReLU", {}, (4, C), (_vec(6, C, 0.0, 0.5),), None, AFFINE),
    "relu6": ("ReLu6", {}, S4, (), None, EXACT),
    "relu1": ("ReLU1", {}, S4, (), None, EXACT),
    "logistic": ("Logistic", {}, S4, (), None, TRANSCENDENTAL),
    "sigmoid": ("Sigmoid", {}, S4, (), None, TRANSCENDENTAL),
    "tanh": ("Tanh", {}, S4, (), None, TRANSCENDENTAL),
    "absval": ("Absval", {}, S4, (), None, EXACT),
    "mish": ("Mish", {}, S4, (), None, TRANSCENDENTAL),
    "softplus": ("Softplus", {}, S4, (), None, TRANSCENDENTAL),
    "reciprocal": ("Reciprocal", {}, S4, (), "pos", AFFINE),
    "ceil": ("Ceil", {}, S4, (), None, EXACT),
    "round": ("Round", {}, S4, (), None, EXACT),
    "zeroslike": ("ZerosLike", {}, S4, (), None, EXACT),
    "gelu": ("Gelu", {}, S4, (), None, TRANSCENDENTAL),
    "elu": ("Elu", dict(alpha=0.7), S4, (), None, TRANSCENDENTAL),
    "selu": ("Selu", dict(alpha=1.6732632, lambda_=1.050701), S4, (), None, TRANSCENDENTAL),
    "hardswish": ("HardSwish", dict(alpha=0.2, beta=0.4), S4, (), None, AFFINE),
    "hardsigmoid": ("Hardsigmoid", dict(alpha=0.2, beta=0.5), S4, (), None, AFFINE),
    "clip": ("Clip", dict(min=-1.0, max=2.5), S4, (), None, EXACT),
    "threshold": ("Threshold", dict(threshold=0.5), S4, (), None, EXACT),
    **{f"unary-{t}": ("Unary", dict(type=t), S4, (), kind, cmp) for t, kind, cmp in (
        (0, None, EXACT), (1, None, EXACT), (2, None, EXACT), (3, None, EXACT),
        (4, None, AFFINE), (5, "pos", TRANSCENDENTAL), (6, "pos", TRANSCENDENTAL),
        (7, None, TRANSCENDENTAL), (8, "pos", TRANSCENDENTAL), (9, None, TRANSCENDENTAL),
        (10, None, TRANSCENDENTAL), (11, "unit", TRANSCENDENTAL),
        (12, "unit", TRANSCENDENTAL), (13, "unit", TRANSCENDENTAL),
        (14, None, TRANSCENDENTAL), (15, "pos", AFFINE), (16, None, TRANSCENDENTAL))},
    "pad-constant": ("Pad", dict(PAD, pad_c_0=1, pad_c_1=2, pad_h_0=2, pad_h_1=-1, pad_w_1=3,
                                 value=0.5), S4, (), None, EXACT),
    "pad-edge": ("Pad", dict(PAD, pad_c_0=1, pad_h_0=1, pad_h_1=2, pad_w_0=3, mode=1), S4, (),
                 None, EXACT),
    "pad-reflect": ("Pad", dict(PAD, pad_h_0=2, pad_h_1=1, pad_w_0=1, pad_w_1=3, mode=2), S4,
                    (), None, EXACT),
    "pad-2d": ("Pad", dict(PAD, pad_n_0=1, pad_c_0=2, pad_c_1=1, value=-1.0), (4, C), (), None,
               EXACT),
    "shufflechannel-2": ("ShuffleChannel", dict(group=2), S4, (), None, EXACT),
    "shufflechannel-4": ("ShuffleChannel", dict(group=4), S4, (), None, EXACT),
    "channelgather": ("ChannelGather", dict(indices=[3, 0, 5, 6, 1]), S4, (), None, EXACT),
    "spacetodepth": ("SpaceToDepth", dict(block_size=2), S4, (), None, EXACT),
    "spacetodepth-dcr": ("SpaceToDepth", dict(block_size=2, mode="DCR"), S4, (), None, EXACT),
    "depthtospace": ("DepthToSpace", dict(block_size=2), S4, (), None, EXACT),
    "depthtospace-dcr": ("DepthToSpace", dict(block_size=2, mode="DCR"), S4, (), None, EXACT),
    "reorg": ("Reorg", dict(stride=2), S4, (), None, EXACT),
    "interp-bilinear-up": ("Interp", dict(INTERP, width_scale=2.0, height_scale=2.0), S4, (),
                           None, TRANSCENDENTAL),
    "interp-bilinear-down": ("Interp", dict(INTERP, output_height=5, output_width=7), S4, (),
                             None, TRANSCENDENTAL),
    "interp-bilinear-mixed": ("Interp", dict(INTERP, output_height=20, output_width=10), S4, (),
                              None, TRANSCENDENTAL),
    "interp-nearest": ("Interp", dict(INTERP, resize_type=1, width_scale=2.0, height_scale=1.5),
                       S4, (), None, EXACT),
    "resize-bilinear": ("Resize", dict(scale_x=1.5, scale_y=0.5, type=1), S4, (), None,
                        TRANSCENDENTAL),
    "resize-nearest": ("Resize", dict(scale_x=2.0, scale_y=2.0, type=0), S4, (), None, EXACT),
    "bilinearresize": ("BilinearResize", dict(scale_x=0.75, scale_y=1.25, type=1), S4, (), None,
                       TRANSCENDENTAL),
    "deconv": _deconv(C, 4, 3, stride=2, pads=(1, 1, 1, 1), out_pad=1),
    "deconv-group": _deconv(C, 3, 2, group=2, stride=2, act=0, bias=False),
    "deconv-dilated": _deconv(C, 4, 3, stride=1, pads=(3, 1, 2, 0), dil=2),
}
# cases the tmfile cannot carry: the node is built with each IR module
BUILT = {"channelgather", "spacetodepth-dcr", "depthtospace-dcr"}
PASSTHROUGH = {"ShuffleChannel", "ChannelGather"}
IDS = [(name, conv) for name, case in CASES.items()
       for conv in ((False, True) if len(case[2]) == 4 else (False,))]


def _inputs(name):
    shape, kind = CASES[name][2], CASES[name][4]
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32) * 2
    if kind == "pos":
        x = np.abs(x) + 0.5
    elif kind == "unit":
        x = (0.9 * np.tanh(x)).astype(np.float32)
    return x


def _graphs(name, conv):
    op, params, shape, consts, _, _ = CASES[name]
    return (one_node_graph(jir, op, params, shape, conv, consts),
            one_node_graph(pir, op, params, shape, conv, consts))


def _port_quantized(jqg, pg):
    """The port graph `pg` (built like the JAX graph that became jqg) with
    jqg's dtypes, QuantParams and quantized consts."""
    for a, b in zip(jqg.tensors, pg.tensors, strict=True):
        b.dtype = pir.DType[a.dtype.name]
        b.data = a.data
        b.quant = None if a.quant is None else pir.QuantParam(
            a.quant.scales, a.quant.zero_points, a.quant.width, a.quant.full_range)
    return pg


def _both(name, jg, pg, opts, x, monkeypatch):
    """(JAX engine's output, port's output, JAX routes {node: lowering},
    port's CompiledGraph), numpy in and out. The port reads the JAX graph's
    tmfile bytes unless the case is BUILT."""
    routes = {}
    select = jax_engine.select_kernel

    def recording_select(op, ctx):
        k = select(op, ctx)
        routes[ctx.node.name] = k.name
        return k

    monkeypatch.setattr(jax_engine, "select_kernel", recording_select)
    (want,) = jt.compile_graph(jg, jt.Options(**opts)).run(x)
    monkeypatch.setattr(jax_engine, "select_kernel", select)
    if name not in BUILT:
        pg = pt.load_tm_bytes(graph_to_tm_bytes(jg))
    cg = pt.compile_graph(pg, pt.Options(**opts), device="cpu")
    (got,) = run_without_host_transfer(cg, x)
    return np.asarray(want), got, routes, cg


def _ids():
    return [f"{n}{'-nhwc' if c else ''}" for n, c in IDS]


@pytest.mark.parametrize("name,conv", IDS, ids=_ids())
def test_float_lowering_matches_jax(name, conv, monkeypatch):
    jg, pg = _graphs(name, conv)
    x = _inputs(name)
    want, got, routes, cg = _both(name, jg, pg, dict(precision="fp32"), x, monkeypatch)
    op, cmp = CASES[name][0], CASES[name][5]
    assert cg.kernels == routes
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.isfinite(want).all()
    if cmp == EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6 if cmp == AFFINE else 1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name,conv", IDS, ids=_ids())
def test_quantized_lowering_matches_jax(name, conv, monkeypatch):
    jg, pg = _graphs(name, conv)
    x = _inputs(name)
    jqg = jax_quantize(jg, [x], scheme="uint8", algorithm="minmax")
    op = CASES[name][0]
    node = jqg.nodes[-1]
    if op == "ChannelGather":
        # the shuffle fold makes ChannelGather only on the grid the
        # quantizer pins across the chain: its output shares its input's
        jqg.tensors[node.outputs[0]].quant = jqg.tensors[node.inputs[0]].quant
    pqg = _port_quantized(jqg, pg)
    t_in = jqg.tensors[jqg.input_tensors[0]]
    xq = jq.quantize_np(x, t_in.quant, t_in.dtype)
    want, got, routes, cg = _both(name, jqg, pqg, dict(quant_mode="fast"), xq, monkeypatch)
    assert cg.kernels == routes
    # the passthroughs register under the name "_lower" in both packages;
    # the unary table's lowerings under "lower"
    assert cg.kernels[node.name] == ("_lower" if op in PASSTHROUGH else routes[node.name])
    assert routes[node.name] != "_lower" or op in PASSTHROUGH
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if op in PASSTHROUGH:
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_round_and_softplus_follow_jax_on_their_edges(monkeypatch):
    """Round halves to even in both engines (not qmath's half away), and
    Softplus is logaddexp(x, 0) beyond F.softplus's threshold of 20, and
    Elu's exp(x) - 1 agrees with JAX's."""
    x = np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 30.0]], np.float32)
    for op, cmp in (("Round", EXACT), ("Softplus", TRANSCENDENTAL), ("Elu", TRANSCENDENTAL)):
        params = dict(alpha=1.0) if op == "Elu" else {}
        jg, pg = (one_node_graph(ir, op, params, x.shape) for ir in (jir, pir))
        want, got, _, _ = _both(op, jg, pg, dict(precision="fp32"), x, monkeypatch)
        if cmp == EXACT:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, [[-2, -2, -0, 0, 2, 2, 4, 30]])
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("size", [(12, 16, 24, 32), (12, 16, 5, 7), (12, 16, 3, 16)],
                         ids=["up", "down", "down-h"])
def test_bilinear_resize_is_jax_image_resize(size):
    """The weights' contraction equals jax.image.resize(method="bilinear")
    on its own, up-scale and down-scale, where it antialiases (a triangle
    widened by the scale); F.interpolate's bilinear mode (no antialias)
    parts from it when scaling down."""
    import jax

    from tengine_tpu_torch.ops.lowering import _bilinear_weights

    h, w, oh, ow = size
    x = np.random.default_rng(0).standard_normal((2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, oh, ow, 3), method="bilinear"))
    xt = torch.from_numpy(x)
    if oh != h:
        xt = torch.einsum("nhwc,ho->nowc", xt, torch.from_numpy(_bilinear_weights(h, oh)))
    if ow != w:
        xt = torch.einsum("nhwc,wp->nhpc", xt, torch.from_numpy(_bilinear_weights(w, ow)))
    np.testing.assert_allclose(xt.numpy(), want, rtol=1e-5, atol=1e-6)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    if oh < h:
        assert np.abs(plain - want).max() > 1e-2
    else:
        np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["interp-bilinear-down", "resize-bilinear", "interp-nearest",
                                  "pad-reflect", "pad-edge", "reorg"])
def test_size_dependent_params_at_a_second_size(name, monkeypatch):
    """The resize weights and index tables are compile-time params at the
    compiled size; a call at another size prepares them for that size
    (executor/engine.py:CompiledGraph._for_size): its output equals the
    graph compiled at that size and the JAX engine's there, bit for bit
    where the case is data movement."""
    op, params, shape, consts, _, cmp = CASES[name]
    small = (shape[0], shape[1], 8, 10)
    x = np.random.default_rng(4).standard_normal(small).astype(np.float32)
    cg = pt.compile_graph(one_node_graph(pir, op, params, shape, True, consts),
                          pt.Options(precision="fp32"), device="cpu")
    (got,) = cg.run(x)
    jg, pg = (one_node_graph(ir, op, params, small, True, consts) for ir in (jir, pir))
    want_jax, want, _, _ = _both(name, jg, pg, dict(precision="fp32"), x, monkeypatch)
    np.testing.assert_array_equal(got, want)
    if cmp == EXACT:
        np.testing.assert_array_equal(got, want_jax)
    else:
        np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-6 * np.abs(want_jax).max())
