"""The PyTorch port on mobilenet-v1 (chip_smoke.py:build_mobilenet_v1_graph)
against the JAX package, on the CPU: the graph's IR with both IR modules,
UINT8 MinMax calibration, and the whole UINT8 net at a small size (widths
multiples of 32 so that the depthwise kernel's gate holds, img 32, batch 32)
under two tiers:

  K  default Options: the legacy route (_native_profitable is false on a
     depthwise net), every conv on the fast lowering's shifted-value branch;
  L  quant_native="on" with TT_DW_PALLAS=1: the native-int8 plan, UINT8
     shifted to full-range INT8 inside the net, the 13 depthwise convs on
     dw_qconv (the JAX engine: its Pallas dw kernel in interpret mode), the
     pointwise convs on the fast lowering's integer branch.

Tolerances, and why: routes equal by name; node by node, each port node fed
what its JAX counterpart was fed, 1 LSB on at most 0.1% of a node's
elements (XLA:CPU contracts acc·M + B, and the global average pool's
S·f32(1/HW) - zp_in, into fused multiply-adds where the port rounds twice;
ROADMAP §3); the free-running logits within 2 LSB, 95% equal (a 1-LSB
parting upstream spreads through the layers below it). Measured here: 0 LSB
everywhere at this size.
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

from test_torch_yolofastest import jax_run_all, port_run_all, port_run_forced  # noqa: E402
from test_torch_yolov5 import _quant_key, assert_ir_equal  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import MOBILENET_DW, build_mobilenet_v1_graph  # noqa: E402

IMG, BATCH = 32, 32  # the depthwise kernel's gate wants batch >= 32
SMALL = dict(img=IMG, classes=16,
             widths=(32, 32, 64, 64, 64, 64, 96, 96, 96, 96, 96, 96, 128, 128))
TIERS = {
    "K": ("0", dict(quant_mode="fast", batch_size=BATCH)),
    "L": ("1", dict(quant_mode="fast", quant_native="on", batch_size=BATCH)),
}


@functools.lru_cache(maxsize=None)
def net():
    jg = build_mobilenet_v1_graph(jir, **SMALL)
    pg = build_mobilenet_v1_graph(pir, **SMALL)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 3, IMG, IMG)).astype(np.float32)
    jqg = jax_quantize(jg, [x[:1]], scheme="uint8", algorithm="minmax")
    t_in = jqg.tensors[jqg.input_tensors[0]]
    return jg, pg, jqg, x, jq.quantize_np(x, t_in.quant, t_in.dtype)


def test_graph_is_the_same_with_both_ir_modules():
    """At full size (Howard et al. 2017, Table 1: 28 weight layers, 27 convs
    and the FC, 13 of the convs depthwise at the 13 shapes chip_smoke.py
    times) and at the test's size."""
    full = [build_mobilenet_v1_graph(ir) for ir in (jir, pir)]
    assert_ir_equal(*full)
    convs = [n for n in full[1].nodes if n.op == "Convolution"]
    assert len(convs) == 27
    dws = [n for n in convs if n.params["group"] > 1]
    shapes = [(full[1].tensors[n.inputs[0]].shape[2], n.params["group"], n.params["stride_h"])
              for n in dws]
    assert shapes == [(h, c, s) for h, c, s, count in MOBILENET_DW for _ in range(count)]
    assert full[1].tensors[full[1].output_tensors[0]].shape == [1, 1000, 1, 1]
    jg, pg, *_ = net()
    assert_ir_equal(jg, pg)


def test_uint8_minmax_calibration_matches_jax():
    """Same calibration image, same QuantParams: weights exact, activation
    zero points equal and scales within rtol 1e-5 (the fp32 engines sum in
    different orders); the raw int32 biases round b / (s_in·s_w) on those
    scales, so they may part by 1 (measured: 4 elements of 28 biases)."""
    _, pg, jqg, x, _ = net()
    pqg = pt.quantize_graph(pg, [x[:1]], scheme="uint8", algorithm="minmax", device="cpu")
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
    assert n_w == 28 and n_act >= 30


@pytest.mark.parametrize("tier", list(TIERS))
def test_whole_net_matches_jax_node_by_node(tier, monkeypatch):
    gate, opts = TIERS[tier]
    *_, jqg, _, xq = net()
    blob = graph_to_tm_bytes(jqg)
    monkeypatch.setenv("TT_DW_PALLAS", gate)
    jax_env, jax_routes, output_ids = jax_run_all(blob, opts, xq, monkeypatch)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    assert list(cg.output_ids) == list(output_ids)
    for name, kernel in cg.kernels.items():
        assert jax_routes[name] == kernel, name
    routes = collections.Counter(
        cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution")
    dw = 13 if tier == "L" else 0
    assert (routes["lower_conv_quant_pallas_dw"], routes["lower_conv_quant_fast"]) == (dw, 27 - dw)
    assert cg.kernels["pool6"] == "lower_global_avgpool_quant"
    assert cg.kernels["fc7"] == "lower_fc_quant_fast"
    t = cg.graph.tensors
    assert t[cg.graph.input_tensors[0]].dtype == t[output_ids[0]].dtype == pir.DType.UINT8
    inner = t[cg.graph.nodes[1].outputs[0]]  # the stem's output
    if tier == "L":
        assert inner.dtype == pir.DType.INT8 and inner.quant.full_range
        assert int(inner.quant.zero_points) != 0
    else:
        assert inner.dtype == pir.DType.UINT8 and not inner.quant.full_range

    seen, _ = port_run_forced(blob, opts, xq, jax_env, monkeypatch)
    assert len(seen) == 27 + 2
    for name, (worst, share) in seen.items():
        assert worst <= 1 and share <= 1e-3, (name, worst, share)
    got = port_run_all(cg, xq)[output_ids[0]]
    want = jax_env[output_ids[0]]
    assert got.shape == want.shape == (BATCH, SMALL["classes"], 1, 1) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"tier {tier} logits: max |d| {d.max()}, equal fraction {(d == 0).mean():.4f}")
    assert d.max() <= 2 and (d == 0).mean() >= 0.95
