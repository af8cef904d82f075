"""The PyTorch port on the face pipeline's two nets
(chip_smoke.py:build_retinaface_mnet_graph, build_mobilefacenet_graph)
against the JAX package, on the CPU: each graph's IR with both IR modules,
UINT8 MinMax calibration, and each whole UINT8 net at a small size
(RetinaFace at 64x48, MobileFaceNet at 56 with its GDConv's kernel the
map's 4x4, both at narrow widths, batch 2) through quantize_graph ->
compile_graph -> the forward, under two tiers:

  S  Options(quant_mode="fast", batch_size=2): every conv on the fast
     lowering (bench.py's face pipeline config, at batch 2);
  T  S + quant_bf16_storage=False: every group-1 1x1 conv on qconv1x1's
     lowering (its plain version here), the rest on the fast lowering.

PReLU, BatchNormalization (after the FC, on a 2-D tensor),
L2Normalization, Softmax, Crop (to the lateral's size) and the unfused
Eltwise sums run through the generic dequantize -> f32 -> requantize
wrapper, the Reshapes, Concats and Upsamples on their passthroughs, as the
JAX engine routes them.

Tolerances, and why: routes equal by name; node by node, each port node fed
what its JAX counterpart was fed, 1 LSB on at most 0.1% of a node's
elements (XLA:CPU contracts acc*M + B into a fused multiply-add where the
port rounds twice, and the wrapper's f32 steps round apart in the last
bits: either meets a .5 tie of the requant now and then; ROADMAP §3); the
free-running outputs within 1 LSB; each output's dequantized cosine
against the port's fp32 engine at least 0.99, or the JAX engine's own
cosine where that is lower at this size (MobileFaceNet's narrow
embedding: its 33 PReLUs and 15 bottlenecks each requantize). Measured
here: 0 LSB at every node and output.
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

from test_torch_compiled import run_without_host_transfer  # noqa: E402
from test_torch_ssd import check_calibration  # noqa: E402
from test_torch_yolofastest import jax_run_all, port_run_forced  # noqa: E402
from test_torch_yolov5 import assert_ir_equal  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import build_mobilefacenet_graph, build_retinaface_mnet_graph  # noqa: E402

BATCH = 2
NETS = {
    "retinaface": (build_retinaface_mnet_graph,
                   dict(h=64, w=48, widths=(8, 16, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 64, 64),
                        fpn=32), (3, 64, 48)),
    "mobilefacenet": (build_mobilefacenet_graph,
                      dict(img=56, stem=32, bottlenecks=((2, 32, 2, 2), (2, 64, 1, 2),
                                                         (2, 64, 2, 1), (2, 64, 1, 2),
                                                         (2, 64, 1, 1)),
                           conv5=128, embedding=32), (3, 56, 56)),
}
TIERS = {
    "S": dict(quant_mode="fast", batch_size=BATCH),
    "T": dict(quant_mode="fast", quant_bf16_storage=False, batch_size=BATCH),
}
# group-1 1x1 convs, which tier T puts on qconv1x1's lowering: RetinaFace's
# 13 pointwise, 3 laterals and 9 heads; the narrow MobileFaceNet's 7
# expansions, 7 projections and conv5
ONE_BY_ONE = {"retinaface": 25, "mobilefacenet": 15}


@functools.lru_cache(maxsize=None)
def net(name):
    """The JAX graph, the port graph, the JAX-quantized graph, the float
    input and its UINT8 codes."""
    build, kw, shape = NETS[name]
    jg, pg = build(jir, **kw), build(pir, **kw)
    x = np.random.default_rng(1).standard_normal((BATCH, *shape)).astype(np.float32)
    jqg = jax_quantize(jg, [x[:1]], scheme="uint8", algorithm="minmax")
    t_in = jqg.tensors[jqg.input_tensors[0]]
    return jg, pg, jqg, x, jq.quantize_np(x, t_in.quant, t_in.dtype)


def test_graphs_are_the_same_with_both_ir_modules():
    """At the published sizes (RetinaFace mnet0.25 at 320x240: 56 convs, 9
    outputs at strides 32, 16, 8, the stride-32 upsample cropped from 20x16
    to 20x15; MobileFaceNet at 112: 49 convs, 33 PReLUs, the 7x7 GDConv,
    FC -> BatchNormalization -> L2Normalization) and at the tests' sizes."""
    retina = [build_retinaface_mnet_graph(ir) for ir in (jir, pir)]
    assert_ir_equal(*retina)
    g = retina[1]
    assert sum(n.op == "Convolution" for n in g.nodes) == 56
    shapes = [g.tensors[t].shape for t in g.output_tensors]
    assert shapes == [[1, c, h, w] for h, w in ((10, 8), (20, 15), (40, 30)) for c in (4, 8, 20)]
    (crop,) = [n for n in g.nodes if n.op == "Crop" and g.tensors[n.inputs[0]].shape[3] == 16]
    assert g.tensors[crop.outputs[0]].shape == [1, 64, 20, 15]

    face = [build_mobilefacenet_graph(ir) for ir in (jir, pir)]
    assert_ir_equal(*face)
    g = face[1]
    ops = collections.Counter(n.op for n in g.nodes)
    assert (ops["Convolution"], ops["PReLU"], ops["BatchNormalization"],
            ops["L2Normalization"]) == (49, 33, 1, 1)
    (gdc,) = [n for n in g.nodes if n.name == "conv6_dw"]
    assert (gdc.params["kernel_h"], gdc.params["group"]) == (7, 512)
    assert [g.tensors[t].shape for t in g.output_tensors] == [[1, 128]]
    for name in NETS:
        jg, pg, *_ = net(name)
        assert_ir_equal(jg, pg)


@pytest.mark.parametrize("name", list(NETS))
def test_uint8_minmax_calibration_matches_jax(name):
    """Same calibration image, same QuantParams: weights exact, activation
    zero points equal and scales within rtol 1e-5, raw int32 biases within
    1 (ROADMAP §3, the JAX engine's own fp32 sums)."""
    _, pg, jqg, x, _ = net(name)
    pqg = pt.quantize_graph(pg, [x[:1]], scheme="uint8", algorithm="minmax", device="cpu")
    n_w, n_act = check_calibration(jqg, pqg)
    assert n_w == {"retinaface": 56, "mobilefacenet": 26}[name] and n_act > 50


def _cosine(q, t, f):
    d = (q.astype(np.float64) - float(np.asarray(t.quant.zero_points))) * float(
        np.asarray(t.quant.scales))
    return float(d.ravel() @ f.ravel() / (np.linalg.norm(d) * np.linalg.norm(f) + 1e-12))


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name", list(NETS))
def test_whole_net_matches_jax(name, tier, monkeypatch):
    jg, _, jqg, x, xq = net(name)
    opts = TIERS[tier]
    blob = graph_to_tm_bytes(jqg)
    jax_env, jax_routes, output_ids = jax_run_all(blob, opts, xq, monkeypatch)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    assert list(cg.output_ids) == list(output_ids)
    for node, kernel in cg.kernels.items():
        assert jax_routes[node] == kernel, node
    routes = collections.Counter(
        cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution")
    assert routes["lower_conv_quant_pallas_direct"] == (ONE_BY_ONE[name] if tier == "T" else 0)
    by_op = {n.op: cg.kernels[n.name] for n in cg.graph.nodes if n.name in cg.kernels}
    # the generic wrapper's float lowerings
    wrapped = {"retinaface": {"Softmax": "lower_softmax", "Crop": "lower_crop"},
               "mobilefacenet": {"PReLU": "lower_prelu", "BatchNormalization": "lower_batchnorm",
                                 "L2Normalization": "lower_l2norm"}}[name]
    assert {op: by_op[op] for op in wrapped} == wrapped
    assert by_op.get("Reshape", "_lower") == by_op.get("Flatten", "_lower") == "_lower"

    seen, _ = port_run_forced(blob, opts, xq, jax_env, monkeypatch)
    assert len(seen) >= sum(n.op == "Convolution" for n in jqg.nodes)
    for node, (worst, share) in seen.items():
        assert worst <= 1 and share <= 1e-3, (node, worst, share)

    got = run_without_host_transfer(cg, xq)
    fp32 = pt.compile_graph(pt.load_tm_bytes(graph_to_tm_bytes(jg)),
                            pt.Options(precision="fp32", batch_size=BATCH), device="cpu").run(x)
    for out, tid, f in zip(got, output_ids, fp32, strict=True):
        want = jax_env[tid]
        assert out.shape == want.shape == f.shape and out.dtype == want.dtype == np.uint8
        d = np.abs(out.astype(np.int32) - want.astype(np.int32))
        t = cg.graph.tensors[tid]
        cos, cos_jax = _cosine(out, t, f), _cosine(want, t, f)
        print(f"{name} {tier} {t.name}: max |d| {d.max()}, cosine vs fp32 {cos:.5f} "
              f"(JAX {cos_jax:.5f})")
        assert d.max() <= 1
        assert cos >= min(0.99, cos_jax) - 1e-6


def test_embeddings_at_batch_1_equal_the_batch():
    """MobileFaceNet under tier T: each image's embedding at batch 1 equals
    its row at batch 2 (no arithmetic crosses images)."""
    *_, jqg, _, xq = net("mobilefacenet")
    blob = graph_to_tm_bytes(jqg)
    opts = TIERS["T"]
    (rows,) = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu").run(xq)
    cg1 = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**dict(opts, batch_size=1)),
                           device="cpu")
    for i in range(BATCH):
        (one,) = cg1.run(xq[i : i + 1])
        np.testing.assert_array_equal(one, rows[i : i + 1])
