"""The fast tier's INT8 convs on the int8 implicit GEMM (ops/cuda/qconv.py:
qconv_fast, csrc/qconv.cu's fast-epilogue mode), as far as the CPU reaches:

  * the route: lower_conv_quant_fast takes qconv_fast for an INT8 conv at
    zero point 0 (group 1, dilation 1, stride 1 or 2), fused residuals
    included, and the float64 chain for every other conv; the route gives
    the float64 chain's bytes;
  * the arithmetic: a numpy emulation of the kernel (int64 sums, exact in
    int32, then int32 -> f32 and the f32 steps of csrc/requant_steps.cuh)
    byte-equal to the float64 chain that qconv_fast runs on the CPU, on
    yolov5s's conv shapes, SiLU, both residual forms and sums past 2^24.

The kernel runs in tests/test_torch_cuda.py, on the card, against the
float64 chain there. The input grids here are shared with it, so this file
imports neither JAX nor the JAX package.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from test_torch_requant import requant_np  # noqa: E402

from tengine_tpu_torch.ops.cuda import qconv as pq  # noqa: E402
from tengine_tpu_torch.ops.cuda import requant as rq  # noqa: E402

SILU = 100

# --- the conv shapes of the two INT8 benchmark nets -------------------------


@functools.lru_cache(maxsize=None)
def _yolov5s_convs_64():
    from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph

    _, g = build_yolov5s_graph(img=64)
    out = []
    for n in g.toposorted():
        if n.op != "Convolution":
            continue
        p = n.params
        _, C, H, W = map(int, g.tensors[n.inputs[0]].shape)
        O, _, k, _ = map(int, g.tensors[n.inputs[1]].shape)
        out.append((H, W, C, O, k, p["stride_h"], (p["pad_h0"], p["pad_h1"], p["pad_w0"],
                                                    p["pad_w1"]), p.get("activation", -1),
                    len(n.inputs) > 2))
    return out


def yolov5s_convs(img=64):
    """yolov5s's 81 convs (the stem first) at img: (H, W, C, O, k, stride,
    pads, act, has_bias); every map scales with the image from img 64's."""
    f = img // 64
    return [(H * f, W * f, *rest) for H, W, *rest in _yolov5s_convs_64()]


def resnet50_convs(img=224):
    """ResNet-50's 53 convs (Caffe layout: stride 2 in a stage's first 1×1
    conv and projection) as yolov5s_convs gives them, plus the fused
    residual: each block's last 1×1 conv takes the block's input, exact,
    with the ReLU after the sum."""
    convs = [(img, img, 3, 64, 7, 2, (3, 3, 3, 3), 0, True, None)]
    h, cin = (img // 2 - 1) // 2 + 1, 64
    for stage, (n, mid) in enumerate(((3, 64), (4, 128), (6, 256), (3, 512))):
        for b in range(n):
            s = 2 if b == 0 and stage > 0 else 1
            h2 = (h - 1) // s + 1
            convs += [(h, h, cin, mid, 1, s, (0, 0, 0, 0), 0, True, None),
                      (h2, h2, mid, mid, 3, 1, (1, 1, 1, 1), 0, True, None),
                      (h2, h2, mid, mid * 4, 1, 1, (0, 0, 0, 0), -1, True, "exact-relu")]
            if b == 0:
                convs.append((h, h, cin, mid * 4, 1, s, (0, 0, 0, 0), -1, True, None))
            cin, h = mid * 4, h2
    return convs


# --- inputs -----------------------------------------------------------------


def fast_inputs(N, conv, seed, fill="rand", device="cpu"):
    """Seeded operands of qconv_fast for one conv (H, W, C, O, k, stride,
    pads, act, has_bias[, residual]): x int8 NHWC, the stored [O, C, k, k]
    weights, qconv_fast's packed weights, M, B (or None), the Epilogue and
    the residual (None, "exact", "exact-relu", "relaxed", "relaxed-relu").
    The multiplier puts the sums around +-50 output steps whatever K is, so
    neither the clip nor the activation hides the arithmetic. "max" fills
    with magnitudes 120..127 (each output channel's weights one sign), so
    that every sum passes 2^24 at K = 9,216."""
    H, W, C, O, k, s, pads, act, has_bias, *res = conv
    res = res[0] if res else None
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    if fill == "max":
        x = ints(120, 128, (N, H, W, C))
        w = ints(120, 128, (O, C, k, k)) * (ints(0, 2, (O, 1, 1, 1)) * 2 - 1)
        spread = C * k * k * 124.0 * 124.0
    else:
        x = ints(-127, 128, (N, H, W, C))
        w = ints(-127, 128, (O, C, k, k))
        spread = np.sqrt(C * k * k) * 73.0 * 73.0
    x, w = x.to(torch.int8), w.to(torch.int8).cpu()
    M = ((torch.rand(O, generator=g, device=dev, dtype=torch.float64) + 0.5) * 50.0
         / spread).float()
    B = (torch.randn(O, generator=g, device=dev) * 20).float() if has_bias else None
    pt, pb, pl, pr = pads
    OH, OW = (H + pt + pb - k) // s + 1, (W + pl + pr - k) // s + 1
    ep = dict(zp_out=0, lo=-127, hi=127, out_u8=False, s_out=0.0473, act=act)
    residual = None
    if res is not None:
        residual = ints(-127, 128, (N, OH, OW, O)).to(torch.int8)
        relu2 = res.endswith("relu")
        if res.startswith("exact"):
            ep.update(residual="exact", s_r=0.061, zp_r=0, relu2=relu2,
                      inv_s_out2=float(np.float32(1.0) / np.float32(0.0831)), zp_out2=0,
                      lo2=-127, hi2=127)
        else:
            ep.update(residual="relaxed", relu2=relu2, beta=float(np.float32(0.061 / 0.0473)),
                      act=-1)
    wp = torch.from_numpy(pq.pack_qconv_weights(w.numpy(), False)).reshape(O, k, k, -1)
    return dict(x=x, w=w, wp=wp.to(dev), M=M, B=B, ep=rq.Epilogue(**ep), residual=residual,
                stride=s, pads=((pt, pb), (pl, pr)))


def run_fast(inp, **kw):
    return pq.qconv_fast(inp["x"], inp["wp"], inp["M"], inp["B"], inp["residual"], inp["ep"],
                         stride=inp["stride"], pads=inp["pads"], **kw)


def run_plain(inp):
    return pq.qconv_fast_plain(inp["x"], inp["wp"], inp["M"], inp["B"], inp["residual"],
                               inp["ep"], stride=inp["stride"], pads=inp["pads"])


def kernel_sums(inp):
    """The kernel's accumulators in numpy: int64 sums over the zero-padded
    input, each tap's channels in turn; they must fit in int32."""
    x = inp["x"].cpu().numpy().astype(np.int64)
    w = inp["w"].numpy().astype(np.int64)  # [O, C, k, k], on the host
    (pt, pb), (pl, pr) = inp["pads"]
    s, k = inp["stride"], w.shape[2]
    x = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    OH, OW = (x.shape[1] - k) // s + 1, (x.shape[2] - k) // s + 1
    acc = np.zeros((x.shape[0], OH, OW, w.shape[0]), np.int64)
    for ky in range(k):
        for kx in range(k):
            acc += x[:, ky:ky + (OH - 1) * s + 1:s, kx:kx + (OW - 1) * s + 1:s, :] @ w[:, :, ky, kx].T
    assert np.abs(acc).max() < 2**31
    return acc


def kernel_emulation(inp):
    """The fast-epilogue mode in numpy: int32 -> f32, then the header's f32
    steps (tests/test_torch_requant.py:requant_np states them op by op)."""
    acc = kernel_sums(inp).astype(np.int32).astype(np.float32)
    res = inp["residual"]
    arrays = dict(acc=acc, mult=inp["M"].cpu().numpy(),
                  bias=None if inp["B"] is None else inp["B"].cpu().numpy(), corr=None,
                  residual=None if res is None else res.cpu().numpy())
    return requant_np(arrays, inp["ep"])


# --- the arithmetic ---------------------------------------------------------

ARITH_CASES = (
    [("yolov5s", i) for i in range(81)]
    + [("res", r) for r in ("exact", "exact-relu", "relaxed", "relaxed-relu")]
    + [("max", 0)]
)


def _arith_conv(case):
    kind, i = case
    if kind == "yolov5s":
        return yolov5s_convs(64)[i], "rand"
    if kind == "res":  # a C3 bottleneck's 3×3 conv with a residual of each form
        return (8, 8, 64, 64, 3, 1, (1, 1, 1, 1), SILU if i.startswith("exact") else -1, True,
                i), "rand"
    return (4, 4, 1024, 16, 3, 1, (1, 1, 1, 1), -1, True), "max"  # K = 9,216


@pytest.mark.parametrize("case", ARITH_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_kernel_emulation_equals_the_float64_chain(case):
    """The numpy emulation of qconv_fast's kernel against qconv_fast on the
    CPU (the float64 chain: qwiden, a float64 conv, qrequant), byte for
    byte, on yolov5s's 81 convs at img 64 (SiLU or none, with and without a
    bias), both residual forms, and sums past 2^24."""
    conv, fill = _arith_conv(case)
    inp = fast_inputs(2 if conv[0] <= 16 else 1, conv, seed=17 + ARITH_CASES.index(case),
                      fill=fill)
    before = pq.qconv_fast.plain
    got = run_fast(inp)
    assert pq.qconv_fast.plain == before + 1
    assert got.dtype == torch.int8
    want = kernel_emulation(inp)
    np.testing.assert_array_equal(got.numpy(), want)
    if fill == "max":
        acc = kernel_sums(inp)
        assert np.abs(acc).max() > 2**24
        assert (acc.astype(np.float32).astype(np.int64) != acc).any()
    else:
        assert ((want > -127) & (want < 127)).mean() > 0.3


def test_the_shape_lists_are_the_nets():
    """yolov5s: 81 convs at img 64 (80 at 640, where the stem kernel takes
    the first), 42 with SiLU, 19 without a bias (split concats); ResNet-50:
    53, 16 with a fused residual, the largest K 4,608."""
    y = yolov5s_convs(64)
    assert len(y) == 81 and y[0][2:6] == (3, 32, 6, 2)
    assert sum(c[7] == SILU for c in y) == 42 and sum(not c[8] for c in y) == 19
    assert yolov5s_convs(640)[1][:2] == (320, 320)
    r = resnet50_convs()
    assert len(r) == 53 and sum(c[9] is not None for c in r) == 16
    assert max(c[2] * c[4] ** 2 for c in r) == 4608 and r[-1][:2] == (7, 7)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    """launch_igemm's checks of the fast mode run before anything is built:
    uint8 input, a Pallas residual tuple beside the steps."""
    inp = fast_inputs(1, (5, 5, 8, 8, 3, 1, (1, 1, 1, 1), -1, True), seed=1)
    steps = rq.steps_args(inp["ep"], has_bias=True)
    shape = dict(n=1, h=5, w_in=5, c=8, oh=5, ow=5, kh=3, kw=3, stride=1, pad_t=1, pad_l=1,
                 zp_in=0, cw=0, act=-1, inv_s_out=1.0, zp_out=0, lo=-127, hi=127,
                 out_dtype="int8", out_shape=(1, 5, 5, 8))
    w = inp["wp"].reshape(8, 9, -1)
    with pytest.raises(ValueError, match="fast epilogue"):
        pq.launch_igemm("t", inp["x"].view(torch.uint8), w, inp["M"], inp["B"], None, None,
                        steps=steps, **shape)
    with pytest.raises(ValueError, match="fast epilogue"):
        pq.launch_igemm("t", inp["x"], w, inp["M"], inp["B"], None, (1,) * 7, steps=steps,
                        **shape)
    with pytest.raises(ValueError, match="zero point 0"):
        pq.launch_igemm("t", inp["x"], w, inp["M"], inp["B"], None, None, steps=steps,
                        **dict(shape, zp_in=3))


# --- the route --------------------------------------------------------------


def conv_graph(C, O, k, s, pads, *, hw=8, group=1, dil=1, act=-1, residual=None, seed=0):
    """input [1, C, hw, hw] -> one conv (-> Eltwise SUM with the input, with
    its ReLU where residual ends in "relu"), built with the port's IR."""
    from tengine_tpu_torch.graph import ir
    from tengine_tpu_torch.serializer.tm2 import format as tmfmt

    rng = np.random.default_rng(seed)
    g = ir.Graph(name="conv")
    x = g.add_tensor("x", ir.DType.FP32, [1, C, hw, hw], ir.TensorType.INPUT)
    inp = g.add_node("InputOp", "in", [], [x.idx])
    w = g.add_tensor("w", ir.DType.FP32, [O, C // group, k, k], ir.TensorType.CONST,
                     data=(rng.standard_normal((O, C // group, k, k)) * 0.3).astype(np.float32))
    b = g.add_tensor("b", ir.DType.FP32, [O], ir.TensorType.CONST,
                     data=(rng.standard_normal(O) * 0.1).astype(np.float32))
    y = g.add_tensor("y", ir.DType.FP32, [], ir.TensorType.VAR)
    pt, pb, pl, pr = pads
    g.add_node("Convolution", "conv", [x.idx, w.idx, b.idx], [y.idx], params=dict(
        kernel_h=k, kernel_w=k, stride_h=s, stride_w=s, pad_h0=pt, pad_h1=pb, pad_w0=pl,
        pad_w1=pr, dilation_h=dil, dilation_w=dil, group=group, input_channel=C,
        output_channel=O, activation=act))
    if residual is not None:
        added = g.add_tensor("added", ir.DType.FP32, [], ir.TensorType.VAR)
        g.add_node("Eltwise", "add", [y.idx, x.idx], [added.idx],
                   params=dict(type=tmfmt.ELT_SUM, caffe_flavor=0, shift=0.0, power=1.0,
                               scale=1.0, activation=0 if residual.endswith("relu") else -1))
    g.inputs = [inp.idx]
    g.outputs = [g.nodes[-1].idx]
    return g


#   name, (C, O, k, s, pads), keywords of conv_graph, scheme, takes qconv_fast
ROUTE_CASES = [
    ("k1", (64, 96, 1, 1, (0, 0, 0, 0)), {}, "int8", True),
    ("k1-s2", (64, 128, 1, 2, (0, 0, 0, 0)), {}, "int8", True),
    ("k3-silu", (32, 64, 3, 1, (1, 1, 1, 1)), dict(act=SILU), "int8", True),
    ("k3-s2", (64, 64, 3, 2, (1, 1, 1, 1)), dict(act=0), "int8", True),
    ("k5", (16, 24, 5, 1, (2, 2, 2, 2)), dict(act=6), "int8", True),
    ("k7-s2-c3", (3, 64, 7, 2, (3, 3, 3, 3)), dict(act=0, hw=16), "int8", True),
    ("c1024", (1024, 64, 1, 1, (0, 0, 0, 0)), dict(hw=4), "int8", True),
    ("c2-255", (128, 255, 1, 1, (0, 0, 0, 0)), {}, "int8", True),
    ("tf-same-s2", (32, 48, 3, 2, (-1, -1, -1, -1)), dict(act=1), "int8", True),
    ("tf-same-k4", (32, 48, 4, 1, (-1, -1, -1, -1)), {}, "int8", True),
    ("res-exact", (64, 64, 3, 1, (1, 1, 1, 1)), dict(residual="exact"), "int8", True),
    ("res-exact-relu", (64, 64, 1, 1, (0, 0, 0, 0)), dict(residual="exact-relu"), "int8", True),
    ("res-relaxed", (64, 64, 3, 1, (1, 1, 1, 1)), dict(residual="relaxed"), "int8", True),
    ("res-relaxed-relu", (64, 64, 1, 1, (0, 0, 0, 0)), dict(residual="relaxed-relu"), "int8",
     True),
    ("uint8", (32, 64, 3, 1, (1, 1, 1, 1)), {}, "uint8", False),
    ("depthwise", (32, 32, 3, 1, (1, 1, 1, 1)), dict(group=32), "int8", False),
    ("dilated", (32, 32, 3, 1, (2, 2, 2, 2)), dict(dil=2), "int8", False),
    ("zp-in", (32, 64, 3, 1, (1, 1, 1, 1)), {}, "int8", False),
    ("pc-zero-points", (32, 64, 3, 1, (1, 1, 1, 1)), {}, "int8", False),
    ("stride-3", (32, 64, 3, 3, (1, 1, 1, 1)), {}, "int8", False),
]


def _compile(qg, relaxed):
    from tengine_tpu_torch.executor.engine import compile_graph
    from tengine_tpu_torch.utils.config import Options

    return compile_graph(qg, Options(quant_mode="fast", batch_size=2, quant_relaxed=relaxed,
                                     quant_native="off"), device="cpu")


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: c[0])
def test_the_fast_tier_routes_int8_convs_at_zero_point_0_to_qconv_fast(case, monkeypatch):
    """Each conv on lower_conv_quant_fast: those of the predicate run
    qconv_fast (its plain version here) once a forward, the others the
    float64 chain; either way the output is the float64 chain's, byte for
    byte (the route switched off by hand)."""
    from tengine_tpu_torch.graph.ir import QuantParam
    from tengine_tpu_torch.ops import quantized
    from tengine_tpu_torch.quantize.quantizer import quantize_graph

    name, (C, O, k, s, pads), kw, scheme, engages = case
    g = conv_graph(C, O, k, s, pads, **kw)
    hw = kw.get("hw", 8)
    rng = np.random.default_rng(len(name))
    calib = [rng.standard_normal((1, C, hw, hw)).astype(np.float32) for _ in range(2)]
    qg = quantize_graph(g, calib, scheme=scheme, device="cpu")
    conv = next(n for n in qg.nodes if n.op == "Convolution")
    if name == "zp-in":
        t = qg.tensors[conv.inputs[0]]
        t.quant = QuantParam(np.asarray(t.quant.scales), np.asarray(3, np.int32))
    if name == "pc-zero-points":
        t = qg.tensors[conv.inputs[1]]
        t.quant = QuantParam(np.asarray(t.quant.scales),
                             np.arange(O, dtype=np.int32) % 3 - 1, t.quant.width)
    relaxed = kw.get("residual", "").startswith("relaxed")
    cg = _compile(qg, relaxed)
    assert set(cg.kernels.values()) == {"lower_conv_quant_fast"}
    if "residual" in kw:
        fused = next(n for n in cg.graph.nodes if n.name == "conv")
        assert fused.params.get("fused_add_pos") is not None
        assert bool(fused.params.get("fused_add_relu")) == kw["residual"].endswith("relu")
        assert quantized._relaxed_fused_add(_ctx(cg, "conv")) == relaxed
    t_in = qg.tensors[qg.input_tensors[0]]
    dtype = torch.uint8 if scheme == "uint8" else torch.int8
    lo, hi = (0, 256) if scheme == "uint8" else (-127, 128)
    x = torch.from_numpy(rng.integers(lo, hi, (2, *t_in.shape[1:])).astype(
        np.uint8 if scheme == "uint8" else np.int8))
    assert x.dtype == dtype
    before = pq.qconv_fast.plain
    got = cg(x)
    assert pq.qconv_fast.plain - before == int(engages)
    monkeypatch.setattr(quantized, "_igemm_fast_ok", lambda ctx: False)
    want = _compile(qg, relaxed)(x)
    assert pq.qconv_fast.plain - before == int(engages)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    out = got[0].numpy().astype(np.int32)
    assert 0.05 < ((out > out.min()) & (out < out.max())).mean()  # not all clipped


def _ctx(cg, name):
    from tengine_tpu_torch.ops.registry import LowerCtx

    node = next(n for n in cg.graph.nodes if n.name == name)
    return LowerCtx(graph=cg.graph, node=node, options=cg.options, store=None)
