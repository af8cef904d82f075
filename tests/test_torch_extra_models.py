"""The PyTorch port's OCR and segmentation nets (models/extra.py: CRNN
conv+LSTM+CTC and U-Net) against the JAX package, on the CPU, at the sizes
tests/test_model_extra.py runs them: CRNN at img_w 48, hidden 32 (T = 11,
build_crnn_graph's widths 32-128 and 37 classes), U-Net at img 32, base 8,
depth 2 (2 classes).

  * the builders' IR equals the JAX builders' (U-Net through each
    package's torch front end and optimize);
  * fp32: the port against the JAX engine, rtol 1e-5 with a floor of 1e-5
    of the largest magnitude (XLA and torch sum the products in another
    order, and the LSTM's sigmoid and tanh round apart in the last bits),
    and against the torch module (U-Net) and tests/test_model_extra.py's
    numpy oracle (CRNN), rtol 2e-3 as there; the CTC strings equal;
  * quantized, CRNN INT8 and U-Net UINT8 (MinMax by the JAX quantizer, its
    grids copied into the port's graph), under two tiers:
      S  Options(quant_mode="fast"): every conv and the FC on the fast
         lowering, the LSTMs through the generic dequantize -> f32 ->
         requantize wrapper;
      T  CRNN: S + quant_bf16_storage=False, pallas_qgemm=True (conv6 and
         conv7, C_in 128, on qconv_direct's lowering, the FC on
         qgemm_requant's); U-Net: S + quant_bf16_storage=False,
         quant_native="off" (the 1x1 head on qconv1x1's; no k x k conv
         has C_in % 128 == 0 at base 8). The JAX package runs its Pallas
         kernels in interpret mode, the port their plain versions.
    Routes equal by name; node by node, each port node fed what its JAX
    counterpart was fed (test_torch_transformer.py:port_run_forced), at
    most 1 LSB on at most 0.1% of a node's elements (the wrapper's f32
    steps round apart in the last bits and meet a .5 tie of the requant
    now and then); the free-running output within 1 LSB on at most 1% of
    its elements; the CTC strings of both engines equal.
  * fault 1 of ROADMAP §3, not copied: the JAX quantizer refuses an INT8
    U-Net (the Deconvolution weight [C_in, C_out, kh, kw] is quantized per
    channel along axis 0, so its bias scales have C_in entries against
    C_out biases); the port's INT8 U-Net at img 64 runs, node by node
    against the JAX engine but for the deconvs, which are held to a numpy
    float64 oracle.
"""

import collections
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.models import extra as jax_extra  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.models import extra as port_extra  # noqa: E402

from test_model_extra import _np_crnn_oracle  # noqa: E402
from test_torch_compiled import run_without_host_transfer  # noqa: E402
from test_torch_transformer import _cosine, jax_run_all, port_run_forced  # noqa: E402
from test_torch_yolov5 import assert_ir_equal  # noqa: E402

CRNN = dict(img_w=48, hidden=32)
UNET = dict(img=32, base=8, depth=2)
TIERS = {
    "crnn": {"S": dict(quant_mode="fast"),
             "T": dict(quant_mode="fast", quant_bf16_storage=False, pallas_qgemm=True)},
    "unet": {"S": dict(quant_mode="fast"),
             "T": dict(quant_mode="fast", quant_bf16_storage=False, quant_native="off")},
}
# the nodes on the kernels' lowerings under T: (direct-route convs, FC)
KERNEL_ROUTES = {"crnn": (2, 1), "unet": (1, 0)}


def _graph(zoo, name):
    if name == "crnn":
        g, weights = zoo.build_crnn_graph(**CRNN)
        return weights, g
    return zoo.build_unet_graph(**UNET)


@functools.lru_cache(maxsize=None)
def net(name):
    """The torch module (U-Net) or the weights (CRNN), the JAX graph, the
    port graph, the JAX quantized graph (CRNN INT8, U-Net UINT8), the port
    graph with its dtypes, grids and consts, the float input and its
    codes."""
    ref, jg = _graph(jax_extra, name)
    _, pg = _graph(port_extra, name)
    shape = [int(d) for d in jg.tensors[jg.input_tensors[0]].shape]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jqg = jax_quantize(jg, [x], scheme="int8" if name == "crnn" else "uint8",
                       algorithm="minmax")
    pqg = pg.clone()
    for a, b in zip(jqg.tensors, pqg.tensors, strict=True):
        b.dtype = pir.DType[a.dtype.name]
        b.data = a.data
        b.quant = None if a.quant is None else pir.QuantParam(
            a.quant.scales, a.quant.zero_points, a.quant.width, a.quant.full_range)
    t_in = jqg.tensors[jqg.input_tensors[0]]
    return ref, jg, pg, jqg, pqg, x, jq.quantize_np(x, t_in.quant, t_in.dtype)


@pytest.mark.parametrize("name", ["crnn", "unet"])
def test_builders_build_the_jax_ir(name):
    _, jg, pg, *_ = net(name)
    assert_ir_equal(jg, pg)
    ops = collections.Counter(n.op for n in pg.nodes)
    if name == "crnn":
        assert ops["LSTM"] == 2 and ops["Convolution"] == 7 and ops["FullyConnected"] == 1
    else:
        assert ops["Deconvolution"] == 2 and ops["Concat"] == 2
    assert port_extra.CRNN_CHARSET == jax_extra.CRNN_CHARSET


@pytest.mark.parametrize("name", ["crnn", "unet"])
def test_fp32_matches_jax(name):
    ref, jg, pg, _, _, x, _ = net(name)
    cg = pt.compile_graph(pg, pt.Options(precision="fp32"), device="cpu")
    (got,) = run_without_host_transfer(cg, x)
    (want,) = jt.compile_graph(jg, jt.Options(precision="fp32")).run(x)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if name == "crnn":
        oracle = _np_crnn_oracle(x, ref, CRNN["img_w"], CRNN["hidden"],
                                 len(port_extra.CRNN_CHARSET))
        np.testing.assert_allclose(got.reshape(oracle.shape), oracle, rtol=2e-3, atol=2e-3)
        decode = port_extra.ctc_greedy_decode
        assert decode(got) == decode(oracle) == jax_extra.ctc_greedy_decode(want)
    else:
        with torch.no_grad():
            module = ref(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got.reshape(module.shape), module, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("tier", ["S", "T"])
@pytest.mark.parametrize("name", ["crnn", "unet"])
def test_whole_net_matches_jax(name, tier, monkeypatch):
    _, jg, pg, jqg, pqg, x, xq = net(name)
    opts = TIERS[name][tier]
    jax_env, jax_routes, output_ids = jax_run_all(jqg, opts, xq, monkeypatch)
    cg = pt.compile_graph(pqg, pt.Options(**opts), device="cpu")
    assert list(cg.output_ids) == list(output_ids) and cg.kernels == jax_routes
    routes = collections.Counter(cg.kernels.values())
    direct, fc = KERNEL_ROUTES[name] if tier == "T" else (0, 0)
    assert routes["lower_conv_quant_pallas_direct"] == direct
    assert routes["lower_fc_quant_pallas"] == fc
    assert {cg.kernels[n.name] for n in cg.graph.nodes if n.op == "LSTM"} <= {"lower_lstm"}

    seen = port_run_forced(pqg, opts, xq, jax_env, monkeypatch)
    # every output is quantized, so every node is compared (by name: U-Net's
    # one MaxPool module makes two nodes of one name)
    assert set(seen) == {n.name for n in cg.graph.nodes if n.outputs and n.op != "InputOp"}
    for node, (worst, share) in seen.items():
        assert worst <= 1 and share <= 1e-3, (node, worst, share)

    (got,) = run_without_host_transfer(cg, xq)
    want = jax_env[output_ids[0]]
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(), (d > 0).mean())
    (fp32,) = pt.compile_graph(pg, pt.Options(precision="fp32"), device="cpu").run(x)
    t = cg.graph.tensors[output_ids[0]]
    assert _cosine(got, t, fp32) > 0.99
    if name == "crnn":
        deq = [(a.astype(np.float64) - float(np.asarray(t.quant.zero_points)))
               * float(np.asarray(t.quant.scales)) for a in (got, want)]
        assert port_extra.ctc_greedy_decode(deq[0]) == jax_extra.ctc_greedy_decode(deq[1])


def test_calibration_matches_jax():
    """The same image through each quantizer: weights and their grids
    equal, raw int32 biases within 1, activation grids within rtol 1e-5
    (the LSTMs' f32 round apart in the last bits)."""
    for name, scheme in (("crnn", "int8"), ("unet", "uint8")):
        _, _, pg, jqg, _, x, _ = net(name)
        pqg = pt.quantize_graph(pg, [x], scheme=scheme, algorithm="minmax", device="cpu")
        for a, b in zip(jqg.tensors, pqg.tensors, strict=True):
            assert (a.dtype.name, a.quant is None) == (b.dtype.name, b.quant is None), a.name
            if a.quant is None:
                continue
            if a.tensor_type.name == "CONST" and a.dtype.name != "INT32":
                np.testing.assert_array_equal(a.data, b.data)
                np.testing.assert_array_equal(a.quant.scales, b.quant.scales)
            elif a.tensor_type.name == "CONST":
                assert np.abs(a.data.astype(np.int64) - b.data).max() <= 1, a.name
            else:
                np.testing.assert_allclose(np.asarray(b.quant.scales),
                                           np.asarray(a.quant.scales), rtol=1e-5)


def test_int8_unet_is_refused_by_both_quantizers(monkeypatch):
    """Fault 1 (ROADMAP §3), not copied: a Deconvolution weight is [C_in,
    C_out, kh, kw], and the JAX quantizer takes its per-channel INT8 scales
    along axis 0; the bias scales then have C_in entries against C_out
    biases, and it raises where C_in != C_out (every up-conv of U-Net). The
    port's quantizer takes them by output channel. Its INT8 U-Net at img 64
    under S and T: its bytes run by the JAX engine, each deconv's weight
    handed over dequantized by output channel to fp32 (the JAX deconv
    lowering takes a float weight as is; its own per-channel dequantize
    would broadcast along axis 0); every node but the deconvs, fed what its
    JAX counterpart was fed, within 1 LSB on at most 0.1% of its elements;
    each deconv, on the port's own run, within 1 LSB of a numpy float64
    dequantize -> conv_transpose -> requantize
    (test_torch_repairs.py:deconv_oracle) on at most 1% of its elements;
    the output's cosine against fp32 above 0.99."""
    from tengine_tpu.graph import ir as jir

    from test_torch_repairs import deconv_oracle
    from test_torch_yolofastest import port_run_all

    unet = dict(UNET, img=64)
    _, jg = jax_extra.build_unet_graph(**unet)
    _, pg = port_extra.build_unet_graph(**unet)
    x = np.random.default_rng(0).standard_normal((1, 3, 64, 64)).astype(np.float32)
    with pytest.raises(ValueError, match="broadcast"):
        jax_quantize(jg, [x], scheme="int8", algorithm="minmax")
    blob = pt.graph_to_tm_bytes(
        pt.quantize_graph(pg, [x], scheme="int8", algorithm="minmax", device="cpu"))
    pqg, jqg = pt.load_tm_bytes(blob), jt.load_tm_bytes(blob)
    deconvs = [n for n in pqg.nodes if n.op == "Deconvolution"]
    assert len(deconvs) == 2 and all(
        pqg.tensors[n.inputs[1]].shape[0] != pqg.tensors[n.inputs[1]].shape[1] for n in deconvs)
    for n in deconvs:
        t, tj = pqg.tensors[n.inputs[1]], jqg.tensors[n.inputs[1]]
        tj.data = pt.ops.qmath.dequantize_weight_np(t.data, t.quant, n.op, n.params["group"])
        tj.data = tj.data.astype(np.float32)
        tj.dtype, tj.quant = jir.DType.FP32, None
    t_in = pqg.tensors[pqg.input_tensors[0]]
    xq = jq.quantize_np(x, t_in.quant, t_in.dtype)
    (fp32,) = pt.compile_graph(pg, pt.Options(precision="fp32"), device="cpu").run(x)
    for tier, opts in TIERS["unet"].items():
        jax_env, jax_routes, _ = jax_run_all(jqg, opts, xq, monkeypatch)
        cg = pt.compile_graph(pqg, pt.Options(**opts), device="cpu")
        assert cg.kernels == jax_routes
        seen = port_run_forced(pqg, opts, xq, jax_env, monkeypatch)
        assert set(seen) == {n.name for n in cg.graph.nodes if n.outputs and n.op != "InputOp"}
        for node, (worst, share) in seen.items():
            if node not in {n.name for n in deconvs}:
                assert worst <= 1 and share <= 1e-3, (tier, node, worst, share)
        env = port_run_all(cg, xq)
        for n in deconvs:
            got = env[n.outputs[0]]
            d = np.abs(got.astype(np.int32)
                       - deconv_oracle(pqg, n, env[n.inputs[0]]).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (tier, n.name, d.max())
        out = env[cg.output_ids[0]]
        assert _cosine(out, cg.graph.tensors[cg.output_ids[0]], fp32) > 0.99, tier
