"""The port's kernel routes against the JAX engine's on small quantized
graphs, on the CPU: the fused residual (+ relu) route of the direct conv
with uint8 and int8 grids, the FC route of qgemm_requant, the dw gate under
default Options, and the folded leaky-ReLU / Dropout requantization. Graphs
are built and quantized by the JAX package and carried as tmfile bytes."""

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


def test_per_channel_output_through_the_generic_wrapper_refused_by_both(monkeypatch):
    """A leaky ReLU whose output grid is per-channel has no quantized
    lowering (its predicate wants one scale), so it runs as a float node
    inside the generic dequant -> op -> requant wrapper. Neither engine's
    wrapper passes a channel axis: both refuse the graph with the same
    AssertionError from qmath.requantize (tengine_tpu/ops/qmath.py and the
    port's ops/qmath.py), so the engines do not part here (ROADMAP §3)."""
    rng = np.random.default_rng(7)
    c = 8
    g = jir.Graph(name="leaky_pc")
    x = g.add_tensor("x", jir.DType.FP32, [1, c, 6, 6], jir.TensorType.INPUT)
    y = g.add_tensor("y", jir.DType.FP32, [1, c, 6, 6], jir.TensorType.VAR)
    g.add_node("InputOp", "in", [], [x.idx])
    g.add_node("ReLu", "leaky", [x.idx], [y.idx], params=dict(negative_slope=0.1))
    g.inputs = [0]
    g.outputs = [1]
    calib = [rng.standard_normal((1, c, 6, 6)).astype(np.float32) for _ in range(2)]
    qg = jax_quantize(g, calib, scheme="int8")
    out = qg.tensors[y.idx]
    out.quant = jir.QuantParam(scales=np.linspace(0.01, 0.03, c).astype(np.float32),
                               zero_points=np.zeros(c, np.int32))
    assert out.quant.per_channel
    xq = _quantized_input(qg, calib[0])
    blob = graph_to_tm_bytes(qg)
    opts = dict(quant_mode="fast", batch_size=1)
    for engine in (jt, pt):
        kw = {} if engine is jt else dict(device="cpu")
        with pytest.raises(AssertionError) as err:
            engine.compile_graph(engine.load_tm_bytes(blob), engine.Options(**opts), **kw).run(xq)
        last = err.traceback[-1]
        assert last.name == "requantize" and str(last.path).endswith("ops/qmath.py")


DW_OPTS = dict(quant_mode="fast", quant_bf16_storage=False, batch_size=32)


def _dw_case(scheme, k, seed=4):
    rng = np.random.default_rng(seed)
    g = tiny_dw_graph(k=k, ir=jir)
    calib = [rng.standard_normal((1, 32, 8, 8)).astype(np.float32) for _ in range(2)]
    qg = jax_quantize(g, calib, scheme=scheme)
    x = rng.standard_normal((32, 32, 8, 8)).astype(np.float32)
    return qg, _quantized_input(qg, x)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_dw_route_matches_jax(scheme, k, monkeypatch):
    """One depthwise conv on the integer-storage tier at batch 32 with
    TT_DW_PALLAS=1: both engines on lower_conv_quant_pallas_dw (JAX's Pallas
    kernel in interpret mode, the port's kernel as its plain version); uint8
    brings zp_in borders, the -zp_in·colsum·M fold and taps w - zp_w."""
    monkeypatch.setenv("TT_DW_PALLAS", "1")
    qg, xq = _dw_case(scheme, k)
    want, jax_routes, got, cg = both_engines(qg, DW_OPTS, xq, monkeypatch)
    assert cg.kernels["dw"] == jax_routes["dw"] == "lower_conv_quant_pallas_dw"
    assert got[0].dtype == (np.uint8 if scheme == "uint8" else np.int8)
    assert_within_one_lsb(want, got)


@pytest.mark.parametrize("k", [3, 5])
def test_dw_uint8_fast_lowering_matches_jax(k, monkeypatch):
    """The same uint8 graphs with the kernel's gate closed: both engines on
    lower_conv_quant_fast, whose depthwise branch feeds the raw input padded
    with zp_in and adds f32(-zp_in·colsum·m) after acc·M + B; and the port's
    two routes agree with each other."""
    qg, xq = _dw_case("uint8", k)
    monkeypatch.setenv("TT_DW_PALLAS", "0")
    want, jax_routes, got, cg = both_engines(qg, DW_OPTS, xq, monkeypatch)
    assert cg.kernels["dw"] == jax_routes["dw"] == "lower_conv_quant_fast"
    assert_within_one_lsb(want, got)
    monkeypatch.setenv("TT_DW_PALLAS", "1")
    blob = graph_to_tm_bytes(qg)
    cg_dw = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**DW_OPTS), device="cpu")
    assert cg_dw.kernels["dw"] == "lower_conv_quant_pallas_dw"
    assert_within_one_lsb(got, cg_dw.run(xq))


def _stem_graph(rng, c_in=3, c_out=8, hw=16):
    """input -> one 3×3 stride-2 conv with bias, C_in = 3 (a darknet stem)."""
    g = jir.Graph(name="stem")
    x = g.add_tensor("x", jir.DType.FP32, [1, c_in, hw, hw], jir.TensorType.INPUT)
    w = g.add_tensor("w", jir.DType.FP32, [c_out, c_in, 3, 3], jir.TensorType.CONST,
                     data=(rng.standard_normal((c_out, c_in, 3, 3)) * 0.3).astype(np.float32))
    b = g.add_tensor("b", jir.DType.FP32, [c_out], jir.TensorType.CONST,
                     data=(rng.standard_normal(c_out) * 0.1).astype(np.float32))
    y = g.add_tensor("y", jir.DType.FP32, [], jir.TensorType.VAR)
    g.add_node("InputOp", "in", [], [x.idx])
    g.add_node("Convolution", "conv", [x.idx, w.idx, b.idx], [y.idx], params=dict(
        kernel_h=3, kernel_w=3, stride_h=2, stride_w=2, pad_h0=1, pad_h1=1, pad_w0=1,
        pad_w1=1, dilation_h=1, dilation_w=1, group=1, activation=0,
        input_channel=c_in, output_channel=c_out))
    g.inputs = [0]
    g.outputs = [1]
    return g


@pytest.mark.parametrize("storage", [False, True])
def test_uint8_stem_fast_lowering_matches_jax(storage, monkeypatch):
    """A uint8 group-1 3×3 stride-2 conv with C_in = 3: the shifted-value
    branch of the fast lowering ((x - zp_in)·(w - zp_w), K = 27, exact in
    both engines), under integer storage and under the default storage."""
    rng = np.random.default_rng(8)
    g = _stem_graph(rng)
    calib = [rng.standard_normal((1, 3, 16, 16)).astype(np.float32) for _ in range(3)]
    qg = jax_quantize(g, calib, scheme="uint8")
    xq = np.concatenate([_quantized_input(qg, c) for c in calib])
    opts = dict(quant_mode="fast", quant_bf16_storage=storage, batch_size=3)
    want, jax_routes, got, cg = both_engines(qg, opts, xq, monkeypatch)
    assert cg.kernels["conv"] == jax_routes["conv"] == "lower_conv_quant_fast"
    assert got[0].dtype == np.uint8
    assert_within_one_lsb(want, got)


# ---------------------------------------------------------------------------
# The .5 tie where one rounding and two part. The port's contract is two
# roundings, fl(fl(acc·M) + B), as its kernels are built (no contraction);
# XLA's CPU compiler, which runs the Pallas kernels in interpret mode,
# contracts the pair into one fused multiply-add, fl(acc·M + B). The case is
# built on purpose: per channel, B is chosen so that fl(acc·M) + B is exactly
# k + 0.5 at one element whose product acc·M was rounded away from zero on
# the tie's side (up for k >= 0, down for k < 0), so two roundings give the
# tie, which rounds away to k + 1 (k for k < 0), and the fused value lies
# just inside it -> k (k + 1). |acc·M| ~ 1000 against a result ~ 10, so the product's rounding
# error (up to 2^-15) is far above the result's f32 spacing and survives.
# ---------------------------------------------------------------------------


def _tie_case(n_rows=28, n_ch=32, seed=11):
    """acc [n_rows, n_ch] = a[row]·b[ch], M and B per channel with one built
    tie per channel; returns a, b, M, B, the two-rounding and the fused
    integer results (numpy emulation) and the built positions."""
    rng = np.random.default_rng(seed)
    a = np.arange(100, 100 + n_rows, dtype=np.int64)
    b = rng.integers(100, 128, n_ch).astype(np.int64)
    acc = a[:, None] * b[None, :]
    M = rng.uniform(0.06, 0.09, n_ch).astype(np.float32)
    prod64 = acc.astype(np.float64) * M.astype(np.float64)  # exact: 14 + 24 bits
    prod32 = acc.astype(np.float32) * M
    B = np.zeros(n_ch, np.float32)
    built = []
    for c in range(n_ch):
        target = np.float32(c % 21 - 10) + np.float32(0.5)  # k + 0.5, k in [-10, 10]
        err = prod32[:, c].astype(np.float64) - prod64[:, c]
        # the rounding error must exceed the result's f32 spacing (2^-20 at
        # 10.5), or the fused value rounds back onto the tie
        rows = np.nonzero(err > 2.0 ** -19 if target > 0 else err < -(2.0 ** -19))[0]
        r = int(rows[c % len(rows)])
        B[c] = target - prod32[r, c]
        assert np.float64(B[c]) == np.float64(target) - np.float64(prod32[r, c])  # exact
        built.append((r, c))

    def rnd(q):
        return np.clip(np.sign(q) * np.floor(np.abs(q) + 0.5), -127, 127).astype(np.int32)

    two = rnd((prod32 + B).astype(np.float32).astype(np.float64))
    fused = rnd((prod64 + B.astype(np.float64)).astype(np.float32).astype(np.float64))
    return a, b, M, B, two, fused, built


@pytest.mark.parametrize("kernel", ["qconv1x1", "dw_qconv"])
def test_built_half_tie_parts_fused_from_two_roundings(kernel):
    """The Pallas kernel in interpret mode gives the fused result, the port's
    plain version the two-rounding result: exactly 1 LSB apart at every
    built tie (and wherever the emulation says so), equal everywhere else."""
    import jax.numpy as jnp

    a, b, M, B, two, fused, built = _tie_case()
    n_rows, n_ch = two.shape
    differ = two != fused
    assert all(differ[r, c] for r, c in built)
    assert np.abs(two - fused).max() == 1 and differ.sum() < 2 * len(built)

    if kernel == "qconv1x1":
        from tengine_tpu.ops.pallas import qconv as jqc
        from tengine_tpu_torch.ops.cuda import qconv as pq

        C = 32  # only channel 0 carries a value: acc[row, ch] = a[row]·b[ch]
        x = np.zeros((n_rows, C), np.int8)
        x[:, 0] = a
        w = np.zeros((n_ch, C, 1, 1), np.int8)
        w[:, 0, 0, 0] = b
        ep = dict(cw=0, act=-1, inv_s_out=20.0, zp_out=0, lo=-127, hi=127, out_dtype="int8")
        want = np.asarray(jqc.qconv1x1(
            jnp.asarray(x), jnp.asarray(jqc.pack_qconv_weights(w, False, False)),
            jnp.asarray(M), jnp.asarray(B), **ep))
        got = pq.qconv1x1_plain(
            torch.from_numpy(x), torch.from_numpy(pq.pack_qconv_weights(w, False)),
            torch.from_numpy(M), torch.from_numpy(B), **ep).numpy()
    else:
        from tengine_tpu.ops.pallas.dw_conv import dw_qconv as jax_dw
        from tengine_tpu_torch.ops.cuda import dw_conv as pd

        # only the centre tap carries a value: acc[n, h, w, c] = x·b[c]
        x = np.broadcast_to(a.reshape(1, 4, 7, 1), (1, 4, 7, n_ch)).astype(np.int8)
        w = np.zeros((n_ch, 1, 3, 3), np.int32)
        w[:, 0, 1, 1] = b
        ep = dict(zp_in=0, zp_out=0, act=-1, s_out=0.05, lo=-127.0, hi=127.0, out_u8=False)
        want = np.asarray(jax_dw(jnp.asarray(x), w, jnp.asarray(M), jnp.asarray(B),
                                 stride=1, pad=1, **ep)).reshape(n_rows, n_ch)
        got = pd.dw_qconv_plain(
            torch.from_numpy(x.copy()), torch.from_numpy(pd.pack_dw_taps(w)),
            torch.from_numpy(M), torch.from_numpy(B), k=3, stride=1, pad_t=1, pad_b=1,
            pad_l=1, pad_r=1, **ep).numpy().reshape(n_rows, n_ch)

    np.testing.assert_array_equal(got.astype(np.int32), two)
    np.testing.assert_array_equal(want.astype(np.int32), fused)
    d = got.astype(np.int32) - want.astype(np.int32)
    for r, c in built:
        assert abs(d[r, c]) == 1, (r, c, d[r, c])
    assert np.array_equal(d != 0, differ) and np.abs(d).max() == 1
