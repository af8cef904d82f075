"""The PyTorch port on mobilenet-SSD (chip_smoke.py:build_mobilenet_ssd_graph)
against the JAX package, on the CPU: the graph's IR with both IR modules,
UINT8 MinMax calibration, and the whole UINT8 net at a small size (img 64,
widths multiples of 32, batch 2; the conf head's gain raised so that the
narrow net's softmax puts classes above the 0.25 threshold too) through
quantize_graph -> compile_graph -> the forward, under two tiers:

  S  Options(quant_mode="fast", batch_size=2): every conv on the fast
     lowering (bench.py's mssd config, at batch 2);
  T  S + quant_bf16_storage=False: the 1x1 convs (pointwise, extras' 1x1,
     heads) on qconv1x1 and the extras' 3x3 s2 convs with C_in % 128 == 0
     on qconv_direct (their plain versions here), the depthwise convs and
     the rest on the fast lowering.

The shape ops run on their quantized passthroughs, Softmax and PriorBox
through the generic wrapper, DetectionOutput on the dequantized heads, as in
the JAX engine. The JAX DetectionOutput mixes the images of a batch
(tests/test_torch_detection.py::test_jax_batch_fault_is_not_copied), so the
port's detection rows at batch 2 are held to the JAX engine's at batch 1,
image by image.

Tolerances, and why: routes equal by name; node by node, each port node fed
what its JAX counterpart was fed, 1 LSB on at most 0.1% of a node's
elements (XLA:CPU contracts acc·M + B into a fused multiply-add where the
port rounds twice, and the softmax's exp and sum round apart in the last
bits: either meets a .5 tie of the requant now and then; ROADMAP §3); the
free-running integer heads (loc, softmax-ed conf) within 1 LSB; the
detection rows: labels and scores equal, boxes within 1e-5 (the decode's
exp and multiply-adds). Measured here: 0 LSB at every node and head, every
row's label and score equal.
"""

import collections
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402

from test_torch_detection import assert_rows_equal  # noqa: E402
from test_torch_compiled import run_without_host_transfer  # noqa: E402
from test_torch_yolofastest import jax_run_all, port_run_forced  # noqa: E402
from test_torch_yolov5 import _quant_key, assert_ir_equal  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import SSD_NUM_PRIORS, build_mobilenet_ssd_graph  # noqa: E402

IMG, BATCH = 64, 2
SMALL = dict(img=IMG, widths=(32, 32, 64, 64, 64, 64, 96, 96, 96, 96, 96, 96, 128, 128),
             extras=((128, 64), (128, 64), (32, 64), (32, 32)), conf_gain=16.0)
TIERS = {
    "S": dict(quant_mode="fast", batch_size=BATCH),
    "T": dict(quant_mode="fast", quant_bf16_storage=False, batch_size=BATCH),
}
# convs by route under each tier: (qconv1x1 / qconv_direct's lowering, fast
# lowering); of the 47 convs: the stem, 13 depthwise, 13 pointwise, 8 extras
# (4 1x1, 4 3x3 s2: 2 of them with C_in = 128 here), 12 heads
ROUTES = {"S": (0, 47), "T": (13 + 4 + 12 + 2, 47 - 31)}


@functools.lru_cache(maxsize=None)
def net():
    jg = build_mobilenet_ssd_graph(jir, **SMALL)
    pg = build_mobilenet_ssd_graph(pir, **SMALL)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 3, IMG, IMG)).astype(np.float32)
    jqg = jax_quantize(jg, [x[:1]], scheme="uint8", algorithm="minmax")
    t_in = jqg.tensors[jqg.input_tensors[0]]
    return jg, pg, jqg, x, jq.quantize_np(x, t_in.quant, t_in.dtype)


def test_graph_is_the_same_with_both_ir_modules():
    """At the published size (300, mobilenet-v1 widths, extras 256/512,
    128/256, 128/256, 64/128: six maps 19, 10, 5, 3, 2, 1, 1,917 priors,
    47 convs) and at the test's size."""
    full = [build_mobilenet_ssd_graph(ir) for ir in (jir, pir)]
    assert_ir_equal(*full)
    g = full[1]
    assert sum(n.op == "Convolution" for n in g.nodes) == 47
    maps = [g.tensors[n.inputs[0]].shape[2] for n in g.nodes if n.op == "PriorBox"]
    assert maps == [19, 10, 5, 3, 2, 1]
    shapes = [g.tensors[t].shape for t in g.output_tensors]
    assert shapes == [[1, 100, 6], [1, SSD_NUM_PRIORS * 4], [1, SSD_NUM_PRIORS * 21]]
    jg, pg, *_ = net()
    assert_ir_equal(jg, pg)


def test_uint8_minmax_calibration_matches_jax():
    """Same calibration image, same QuantParams: weights exact, activation
    zero points equal and scales within rtol 1e-5 (the fp32 engines sum in
    different orders); the raw int32 biases round b / (s_in·s_w) on those
    scales, so they may part by 1. The detections stay float."""
    _, pg, jqg, x, _ = net()
    pqg = pt.quantize_graph(pg, [x[:1]], scheme="uint8", algorithm="minmax", device="cpu")
    n_w, n_act = check_calibration(jqg, pqg)
    det = pqg.tensors[pqg.output_tensors[0]]
    assert det.quant is None and det.dtype.name == "FP32"
    assert n_w == 47 and n_act >= 80


def check_calibration(jqg, pqg):
    """The UINT8 MinMax graphs of the two quantizers, tensor by tensor:
    weights and their QuantParams equal, raw int32 biases within 1,
    activation zero points equal and scales within rtol 1e-5. Returns the
    numbers of weights and of quantized activations."""
    assert len(pqg.tensors) == len(jqg.tensors)
    n_act = n_w = 0
    for a, b in zip(jqg.tensors, pqg.tensors):
        assert a.dtype.name == b.dtype.name and (a.quant is None) == (b.quant is None), a.name
        if a.quant is None:
            continue
        if a.tensor_type.name == "CONST" and a.dtype.name == "UINT8":
            n_w += 1
            np.testing.assert_array_equal(a.data, b.data)
            assert _quant_key(a.quant) == _quant_key(b.quant), a.name
        elif a.tensor_type.name == "CONST":
            assert a.dtype.name == "INT32" and a.data.dtype == b.data.dtype, a.name
            assert np.abs(a.data.astype(np.int64) - b.data).max() <= 1, a.name
        else:
            n_act += 1
            assert a.dtype.name == "UINT8"
            assert int(a.quant.zero_points) == int(b.quant.zero_points), a.name
            np.testing.assert_allclose(float(b.quant.scales), float(a.quant.scales), rtol=1e-5,
                                       err_msg=a.name)
    return n_w, n_act


@pytest.mark.parametrize("tier", list(TIERS))
def test_whole_net_matches_jax(tier, monkeypatch):
    opts = TIERS[tier]
    *_, jqg, _, xq = net()
    blob = graph_to_tm_bytes(jqg)
    jax_env, jax_routes, output_ids = jax_run_all(blob, opts, xq, monkeypatch)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    assert list(cg.output_ids) == list(output_ids)
    for name, kernel in cg.kernels.items():
        assert jax_routes[name] == kernel, name
    routes = collections.Counter(
        cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution")
    assert (routes["lower_conv_quant_pallas_direct"], routes["lower_conv_quant_fast"]) == ROUTES[tier]
    by_op = {n.op: cg.kernels[n.name] for n in cg.graph.nodes if n.name in cg.kernels}
    assert by_op["Permute"] == by_op["Flatten"] == by_op["Reshape"] == by_op["Concat"] == "_lower"
    assert by_op["Softmax"] == "lower_softmax" and by_op["PriorBox"] == "lower_priorbox"

    seen, _ = port_run_forced(blob, opts, xq, jax_env, monkeypatch)
    assert len(seen) >= 47 + 6
    for name, (worst, share) in seen.items():
        assert worst <= 1 and share <= 1e-3, (name, worst, share)

    det, loc, conf = run_without_host_transfer(cg, xq)
    assert det.shape == (BATCH, 100, 6) and det.dtype == np.float32
    for got, tid in ((loc, output_ids[1]), (conf, output_ids[2])):
        want = jax_env[tid]
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        print(f"tier {tier} head {cg.graph.tensors[tid].name}: max |d| {d.max()}")
        assert d.max() <= 1
    for i in range(BATCH):
        env_i, _, _ = jax_run_all(blob, dict(opts, batch_size=1), xq[i : i + 1], monkeypatch)
        want = env_i[output_ids[0]]
        assert (want[0, :, 0] >= 0).sum() >= 10
        assert_rows_equal(det[i : i + 1], want)


def test_cost_analysis_counts_only_the_convs():
    """cost_analysis on the compiled SSD: the shape ops, softmax, PriorBox
    and the NMS add no flops (data movement counts 0, as in XLA's count of
    the convs); flops are the 47 convs' 2 per in-bounds MAC plus 1 per
    biased output; no launches on the CPU."""
    from tengine_tpu_torch.executor.engine import _taps

    *_, jqg, _, xq = net()
    cg = pt.compile_graph(pt.load_tm_bytes(graph_to_tm_bytes(jqg)), pt.Options(**TIERS["S"]),
                          device="cpu")
    cost = cg.cost_analysis()
    g = cg.graph
    want = 0
    for n in g.nodes:
        if n.op != "Convolution":
            continue
        p, (_, c_in, h, w) = n.params, g.tensors[n.inputs[0]].shape
        out = g.tensors[n.outputs[0]].shape
        taps = (_taps(h, out[2], p["kernel_h"], p["stride_h"], p["pad_h0"], 1)
                * _taps(w, out[3], p["kernel_w"], p["stride_w"], p["pad_w0"], 1))
        want += (2 * BATCH * out[1] * (c_in // p["group"]) * taps
                 + BATCH * out[1] * out[2] * out[3])
    assert cost["flops"] == float(want) > 0
    assert cost["bytes accessed"] > 0 and cost["launches"] is None
