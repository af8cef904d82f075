"""The PyTorch port's ResNet-50 slice against the JAX package, on the CPU, at
a small size: chip_smoke.py's build_resnet50_graph at widths/8, depths
(2, 2, 2, 2), img 32, batch 2. The graph's IR with both IR modules, the float
engine and MinMax calibration, each lowering of the classifier's tail on a
one-node graph, and the whole INT8 net under the chain tier F
(fuse_resblock, exact) and the unfused tier G, node by node and at the
logits. The JAX engine runs its Pallas chain kernel in interpret mode, the
port its kernel's plain version.

Tolerances, and why:
  * one-node FullyConnected (fast and ref, int8 and uint8), ReLu on a shared
    grid, and the int8 global average pool: 0 LSB.
  * uint8 global average pool: 1 LSB. XLA's CPU compiler contracts
    S·f32(1/HW) - zp_in into one fused multiply-add and the port rounds the
    product and the difference on their own; the case is built on .5 ties.
  * whole net, each port node fed what its JAX counterpart was fed: 1 LSB,
    on at most 1% of a node's elements (the contraction of acc·M + B and of
    the residual sum, tests/test_torch_qblock.py).
  * logits, free running: 2 LSB with at least 95% of them equal (each 1-LSB
    parting upstream spreads through the layers below it).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402

from test_torch_qroutes import _fc_graph, both_engines  # noqa: E402
from test_torch_yolofastest import jax_run_all, port_run_all, port_run_forced  # noqa: E402
from test_torch_yolov5 import _quant_key, assert_ir_equal  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import build_resnet50_graph  # noqa: E402

SMALL = dict(img=32, classes=16, widths=(8, 16, 32, 64), depths=(2, 2, 2, 2))
BATCH = 2
F = dict(quant_mode="fast", fuse_resblock=True, quant_relaxed=False, batch_size=BATCH)
G = dict(quant_mode="fast", quant_relaxed=False, batch_size=BATCH)
# the integer-storage tier without the chains: every 1x1 conv on qconv1x1 (the
# fused residual included), the FC on qgemm_requant; at these widths no 3x3
# conv has C_in % 128 == 0, so none takes qconv_direct
H = dict(quant_mode="fast", quant_relaxed=False, quant_bf16_storage=False, pallas_qgemm=True,
         batch_size=BATCH)


@functools.lru_cache(maxsize=None)
def net():
    jg = build_resnet50_graph(jir, **SMALL)
    pg = build_resnet50_graph(pir, **SMALL)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 3, SMALL["img"], SMALL["img"])).astype(np.float32)
    jqg = jax_quantize(jg, [x[:1]], scheme="int8", algorithm="minmax")
    t_in = jqg.tensors[jqg.input_tensors[0]]
    return jg, pg, jqg, x, jq.quantize_np(x, t_in.quant, t_in.dtype)


def test_graph_has_the_same_ir_with_both_ir_modules():
    jg, pg, *_ = net()
    assert_ir_equal(jg, pg)
    ops = [n.op for n in pg.nodes]
    assert ops.count("Convolution") == 1 + 3 * 8 + 4 and ops.count("Eltwise") == 8
    assert ops.count("Pooling") == 2 and ops.count("FullyConnected") == 1
    full = build_resnet50_graph(pir, img=32, widths=(1, 1, 1, 1))  # full depth, 1 channel wide
    assert [n.op for n in full.nodes].count("Convolution") == 53


def test_float_engine_matches_jax():
    """fp32 end to end, the float FullyConnected lowering included: the two
    engines sum in different orders, so 1e-4 of the logits' range."""
    jg, pg, _, x, _ = net()
    (want,) = jt.compile_graph(jg, jt.Options(batch_size=BATCH)).run(x)
    (got,) = pt.compile_graph(pg, pt.Options(batch_size=BATCH), device="cpu").run(x)
    assert got.shape == want.shape == (BATCH, SMALL["classes"], 1, 1)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_float_fc_matches_jax():
    rng = np.random.default_rng(2)
    g = _fc_graph(rng)
    x = rng.standard_normal((4, 200)).astype(np.float32)
    blob = graph_to_tm_bytes(g)
    (want,) = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(batch_size=4)).run(x)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(batch_size=4), device="cpu")
    assert cg.kernels["fc"] == "lower_fc"
    np.testing.assert_allclose(cg.run(x)[0], want, rtol=1e-5, atol=1e-5)


def test_minmax_calibration_matches_jax():
    """Same calibration image, same QuantParams: weights and biases exact,
    activation zero points equal and scales within rtol 1e-5."""
    _, pg, jqg, x, _ = net()
    pqg = pt.quantize_graph(pg, [x[:1]], scheme="int8", algorithm="minmax", device="cpu")
    assert len(pqg.tensors) == len(jqg.tensors)
    n_act = n_const = 0
    for a, b in zip(jqg.tensors, pqg.tensors):
        assert a.dtype.name == b.dtype.name and (a.quant is None) == (b.quant is None), a.name
        if a.quant is None:
            continue
        if a.tensor_type.name == "CONST":
            n_const += 1
            np.testing.assert_array_equal(a.data, b.data)
            if a.dtype.name == "INT8":
                assert _quant_key(a.quant) == _quant_key(b.quant), a.name
        else:
            n_act += 1
            assert int(a.quant.zero_points) == int(b.quant.zero_points) == 0, a.name
            np.testing.assert_allclose(float(b.quant.scales), float(a.quant.scales), rtol=1e-5,
                                       err_msg=a.name)
    assert n_const == 2 * 30 and n_act >= 45


# ---------------------------------------------------------------------------
# the classifier's tail, one node at a time
# ---------------------------------------------------------------------------


def _quantized_input(qg, x):
    t_in = qg.tensors[qg.input_tensors[0]]
    return jq.quantize_np(x, t_in.quant, t_in.dtype)


@pytest.mark.parametrize("mode,lowering", [("fast", "lower_fc_quant_fast"),
                                           ("ref", "lower_fc_quant_ref")])
@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_fc_lowerings_match_jax(scheme, mode, lowering, monkeypatch):
    """K = 200, N = 130 under the default storage: every sum stays below
    2^24, so the JAX fast lowering's f32 sum of bf16 products is exact and
    both engines round the same values."""
    rng = np.random.default_rng(2)
    g = _fc_graph(rng)
    calib = [rng.standard_normal((1, 200)).astype(np.float32) for _ in range(4)]
    qg = jax_quantize(g, calib, scheme=scheme)
    xq = np.concatenate([_quantized_input(qg, c) for c in calib])
    want, jax_routes, got, cg = both_engines(qg, dict(quant_mode=mode, batch_size=4), xq,
                                             monkeypatch)
    assert cg.kernels["fc"] == jax_routes["fc"] == lowering
    assert got[0].dtype == (np.uint8 if scheme == "uint8" else np.int8)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_fc_2048_fast_lowering_matches_jax(scheme, monkeypatch):
    """ResNet-50's FC, K = 2048 -> N = 1000, under quant_mode="fast" and the
    default storage, batch 8. The JAX fast lowering sums bf16 products in
    f32, which could round once a partial sum passed 2^24; at calibrated
    ranges the sums stay far below it (|acc| ~ sqrt(K)·|x|·|w|), so both
    engines round the same exact sums: measured 0 LSB, 0 of 8,000 elements
    differing, int8 and uint8 (ROADMAP §3)."""
    rng = np.random.default_rng(3)
    g = _fc_graph(rng, k=2048, n=1000)
    calib = [rng.standard_normal((1, 2048)).astype(np.float32) for _ in range(8)]
    qg = jax_quantize(g, calib, scheme=scheme)
    xq = np.concatenate([_quantized_input(qg, c) for c in calib])
    want, jax_routes, got, cg = both_engines(qg, dict(quant_mode="fast", batch_size=8), xq,
                                             monkeypatch)
    assert cg.kernels["fc"] == jax_routes["fc"] == "lower_fc_quant_fast"
    assert got[0].shape == want[0].shape == (8, 1000)
    np.testing.assert_array_equal(got[0], want[0])


def _gap_graph(c=16, hw=6):
    g = jir.Graph(name="gap")
    x = g.add_tensor("x", jir.DType.FP32, [1, c, hw, hw], jir.TensorType.INPUT)
    y = g.add_tensor("y", jir.DType.FP32, [1, c, 1, 1], jir.TensorType.VAR)
    g.add_node("InputOp", "in", [], [x.idx])
    g.add_node("Pooling", "gap", [x.idx], [y.idx], dict(
        alg=1, kernel_h=hw, kernel_w=hw, stride_h=1, stride_w=1, global_pool=1, caffe_flavor=0,
        pad_h0=0, pad_w0=0, pad_h1=0, pad_w1=0))
    g.inputs = [0]
    g.outputs = [1]
    return g


@pytest.mark.parametrize("scheme,grids", [
    ("int8", ((0.0123, 0.0123, 0, 0), (0.02, 0.01, 0, 0), (0.011, 0.0173, 0, 0))),
    ("uint8", ((0.0123, 0.0123, 100, 100), (0.02, 0.01, 128, 128), (0.011, 0.0173, 128, 3))),
])
def test_global_avgpool_matches_jax(scheme, grids, monkeypatch):
    """A 6×6 pool whose inputs are built onto .5 ties (18 values k + 1 and 18
    values k: mean k + .5), and random inputs, under hand-set grids (s_in,
    s_out, zp_in, zp_out). int8: the port's single folded constant is XLA's,
    0 LSB. uint8: 1 LSB, the fused multiply-add of the module docstring."""
    rng = np.random.default_rng(0)
    qg = jax_quantize(_gap_graph(), [rng.standard_normal((1, 16, 6, 6)).astype(np.float32)],
                      scheme=scheme)
    lo, hi = (0, 255) if scheme == "uint8" else (-127, 127)
    n = 512
    xq = rng.integers(lo, hi + 1, (n, 16, 6, 6)).astype(np.uint8 if scheme == "uint8" else np.int8)
    ks = np.arange(lo, lo + 240)
    ties = np.concatenate([np.broadcast_to(ks[:, None, None] + 1, (240, 16, 18)),
                           np.broadcast_to(ks[:, None, None], (240, 16, 18))], axis=2)
    xq[:240] = ties.reshape(240, 16, 6, 6)
    worst = 0
    for s_in, s_out, zp_in, zp_out in grids:
        t_in, t_out = qg.tensors[qg.input_tensors[0]], qg.tensors[qg.output_tensors[0]]
        t_in.quant.scales, t_out.quant.scales = np.float32(s_in), np.float32(s_out)
        t_in.quant.zero_points, t_out.quant.zero_points = np.int32(zp_in), np.int32(zp_out)
        want, jax_routes, got, cg = both_engines(qg, dict(quant_mode="fast", batch_size=n), xq,
                                                 monkeypatch)
        assert cg.kernels["gap"] == jax_routes["gap"] == "lower_global_avgpool_quant"
        assert got[0].shape == want[0].shape == (n, 16, 1, 1) and got[0].dtype == want[0].dtype
        d = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
        print(f"{scheme} {s_in, s_out, zp_in, zp_out}: max |d| {d.max()}, {(d > 0).sum()} differ")
        worst = max(worst, int(d.max()))
    assert worst <= (1 if scheme == "uint8" else 0)


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_relu_on_a_shared_grid_matches_jax(scheme, monkeypatch):
    """conv -> ReLu node with the ReLu's output pinned to its input's grid:
    both engines take lower_relu_quant, max(q, zp) on the stored values."""
    rng = np.random.default_rng(5)
    g = jir.Graph(name="relu")
    x = g.add_tensor("x", jir.DType.FP32, [1, 8, 6, 6], jir.TensorType.INPUT)
    w = g.add_tensor("w", jir.DType.FP32, [8, 8, 1, 1], jir.TensorType.CONST,
                     data=rng.standard_normal((8, 8, 1, 1)).astype(np.float32))
    y = g.add_tensor("y", jir.DType.FP32, [], jir.TensorType.VAR)
    z = g.add_tensor("z", jir.DType.FP32, [], jir.TensorType.VAR)
    g.add_node("InputOp", "in", [], [x.idx])
    g.add_node("Convolution", "conv", [x.idx, w.idx], [y.idx], params=dict(
        kernel_h=1, kernel_w=1, stride_h=1, stride_w=1, pad_h0=0, pad_h1=0, pad_w0=0,
        pad_w1=0, dilation_h=1, dilation_w=1, group=1, activation=-1,
        input_channel=8, output_channel=8))
    g.add_node("ReLu", "relu", [y.idx], [z.idx], params=dict(negative_slope=0.0))
    g.inputs = [0]
    g.outputs = [2]
    calib = [rng.standard_normal((1, 8, 6, 6)).astype(np.float32) for _ in range(3)]
    qg = jax_quantize(g, calib, scheme=scheme)
    t_y, t_z = qg.tensors[y.idx], qg.tensors[z.idx]
    t_z.quant.scales, t_z.quant.zero_points = t_y.quant.scales, t_y.quant.zero_points
    xq = np.concatenate([_quantized_input(qg, c) for c in calib])
    want, jax_routes, got, cg = both_engines(qg, dict(quant_mode="fast", batch_size=3), xq,
                                             monkeypatch)
    assert cg.kernels["relu"] == jax_routes["relu"] == "lower_relu_quant"
    zp = int(t_y.quant.zero_points)
    assert got[0].min() == zp and (got[0] > zp).any()
    np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# the whole net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["F", "G", "H"])
def test_whole_net_matches_jax_node_by_node(tier, monkeypatch):
    *_, jqg, _, xq = net()
    opts = {"F": F, "G": G, "H": H}[tier]
    blob = graph_to_tm_bytes(jqg)
    jax_env, jax_routes, output_ids = jax_run_all(blob, opts, xq, monkeypatch)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    assert list(cg.output_ids) == list(output_ids)
    for name, kernel in cg.kernels.items():
        assert jax_routes[name] == kernel, name
    chains = [n for n in cg.graph.nodes if n.op == "FusedResBlockChain"]
    if tier == "F":
        # a stride-2 head starts a new chain: one chain per stage
        assert [len(n.params["blocks"]) for n in chains] == list(SMALL["depths"])
        assert all(cg.kernels[n.name] == "lower_resblock_chain" for n in chains)
        assert [n.op for n in cg.graph.nodes].count("Convolution") == 1
    else:
        assert not chains
        assert [n.op for n in cg.graph.nodes].count("Convolution") == 29
    assert cg.kernels["conv1"] == "lower_conv_quant_fast"
    assert cg.kernels["pool1"] == "lower_maxpool_quant"
    assert cg.kernels["pool5"] == "lower_global_avgpool_quant"
    assert cg.kernels["fc"] == ("lower_fc_quant_pallas" if tier == "H" else "lower_fc_quant_fast")
    if tier == "H":
        routes = [cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution"]
        assert routes.count("lower_conv_quant_pallas_direct") == 2 * 8 + 4  # the 1x1 convs
        assert routes.count("lower_conv_quant_fast") == 1 + 8  # the stem and the 3x3 convs

    seen, _ = port_run_forced(blob, opts, xq, jax_env, monkeypatch)
    assert {"conv1", "pool1", "pool5", "fc"} <= set(seen)
    # a node on the generic dequant -> fp32 -> requant wrapper returns floats
    # and is compared through its consumer
    live = {n.name for n in cg.graph.nodes
            if n.outputs and n.op != "InputOp" and cg.kernels[n.name] != "lower_relu"}
    assert set(seen) == live and len(live) == (8 if tier == "F" else 32)
    for name, (worst, share) in seen.items():
        assert worst <= 1 and share <= 0.01, (name, worst, share)

    got = port_run_all(cg, xq)[output_ids[0]]
    want = jax_env[output_ids[0]]
    assert got.shape == want.shape == (BATCH, SMALL["classes"], 1, 1) and got.dtype == np.int8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"tier {tier} logits: max |d| {d.max()}, equal fraction {(d == 0).mean():.4f}")
    assert d.max() <= 2 and (d == 0).mean() >= 0.95


def test_default_options_still_raise_for_the_native_plan(monkeypatch):
    """The name is older than the plan's port: default Options (quant_relaxed
    with quant_native="auto") take the native-int8 plan on a net whose convs
    are 64 channels wide and more (_native_profitable), and since the plan
    is ported they compile instead of raising. One bottleneck per stage at
    ResNet-50's widths, img 32: the plan builds no chain, every conv stays on
    the fast lowering, the routes are the JAX engine's and the logits equal
    its; with quant_native="off" quant_relaxed alone fuses from
    chain_min_cmid = 256 up: stages 3 and 4."""
    g = build_resnet50_graph(jir, img=32, classes=16, depths=(1, 1, 1, 1))
    x = np.random.default_rng(1).standard_normal((1, 3, 32, 32)).astype(np.float32)
    qg = jax_quantize(g, [x], scheme="int8", algorithm="minmax")
    xq = _quantized_input(qg, x)
    want, jax_routes, got, cg = both_engines(qg, dict(batch_size=1), xq, monkeypatch)
    assert cg.graph._bf16_tids == set()
    assert not any(n.op == "FusedResBlockChain" for n in cg.graph.nodes)
    assert cg.kernels == {k: v for k, v in jax_routes.items() if k in cg.kernels}
    assert {cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution"} == {
        "lower_conv_quant_fast"}
    np.testing.assert_array_equal(got[0], want[0])
    pg = pt.load_tm_bytes(graph_to_tm_bytes(qg))
    cg = pt.compile_graph(pg, pt.Options(batch_size=1, quant_native="off"), device="cpu")
    chains = [n for n in cg.graph.nodes if n.op == "FusedResBlockChain"]
    assert [n.params["blocks"][0]["c_mid"] for n in chains] == [256, 512]
