"""The PyTorch port's YOLO-Fastest slice against the JAX package, on the CPU
at img=64: the graph's IR, the quantizer, and the integer-storage tier at batch
32 with the depthwise kernel's gate open (TT_DW_PALLAS=1; JAX's Pallas
kernels in interpret mode, the port's kernels as their plain versions),
INT8 and UINT8. One JAX run per scheme (interpret mode takes most of the
file's time), compared node by node and at the heads; the tier with the
gate closed runs on the port alone, against its own depthwise tier."""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tengine_tpu as jt  # noqa: E402
import tengine_tpu.executor.engine as jax_engine  # noqa: E402
from tengine_tpu.models.darknet_zoo import build_yolofastest_graph as jax_build  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
import tengine_tpu_torch.executor.engine as port_engine  # noqa: E402
from tengine_tpu_torch.models.darknet_zoo import build_yolofastest_graph as port_build  # noqa: E402

from tengine_tpu_torch.ops.layout import as_semantic, nchw  # noqa: E402

from test_torch_yolov5 import _quant_key, assert_ir_equal  # noqa: E402

IMG = 64
BATCH = 32  # the depthwise kernel's gate wants batch >= 32
OPTS = dict(quant_mode="fast", quant_bf16_storage=False, batch_size=BATCH)
# convs per forward by route, of YOLO-Fastest's 43: (dw kernel, 1×1 on the
# direct route, fast lowering)
ROUTES = {"1": (13, 29, 1), "0": (0, 29, 14)}
STORED = {"int8": "INT8", "uint8": "UINT8"}


@pytest.fixture(scope="module")
def graphs():
    jg = jax_build(img=IMG)
    pg = port_build(img=IMG)
    rng = np.random.default_rng(1)
    calib = [rng.standard_normal((1, 3, IMG, IMG)).astype(np.float32)]
    x = np.concatenate(
        [calib[0], rng.standard_normal((BATCH - 1, 3, IMG, IMG)).astype(np.float32)])
    jqgs = {s: jax_quantize(jg, calib, scheme=s, algorithm="minmax") for s in STORED}
    return jg, pg, jqgs, calib, x


def test_graph_has_the_same_ir(graphs):
    jg, pg, _, _, _ = graphs
    assert_ir_equal(jg, pg)
    convs = [n for n in pg.nodes if n.op == "Convolution"]
    assert len(convs) == 43
    assert sum(n.params["group"] > 1 for n in convs) == 13


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_quantizer_matches_jax(graphs, scheme):
    """Same calibration, same QuantParams: weights exact, activation zero
    points equal and scales within rtol 1e-5 (the fp32 engines sum in
    different orders)."""
    _, pg, jqgs, calib, _ = graphs
    jqg = jqgs[scheme]
    pqg = pt.quantize_graph(pg, calib, scheme=scheme, algorithm="minmax", device="cpu")
    assert len(pqg.tensors) == len(jqg.tensors)
    n_act = n_w = 0
    for a, b in zip(jqg.tensors, pqg.tensors):
        assert a.dtype.name == b.dtype.name, a.name
        assert (a.quant is None) == (b.quant is None), a.name
        if a.quant is None:
            continue
        if a.tensor_type.name == "CONST" and a.dtype.name == STORED[scheme]:
            n_w += 1
            assert _quant_key(a.quant) == _quant_key(b.quant), a.name
            np.testing.assert_array_equal(a.data, b.data)
        elif a.tensor_type.name in ("VAR", "INPUT"):
            n_act += 1
            assert a.dtype.name == STORED[scheme]
            assert int(a.quant.zero_points) == int(b.quant.zero_points), a.name
            np.testing.assert_allclose(
                float(b.quant.scales), float(a.quant.scales), rtol=1e-5, err_msg=a.name
            )
    assert n_w == 43 and n_act > 80


def _routes(cg):
    count = collections.Counter(
        cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution")
    assert sum(count.values()) == 43
    return (count["lower_conv_quant_pallas_dw"], count["lower_conv_quant_pallas_direct"],
            count["lower_conv_quant_fast"])


def _head_diff(want, got, dtype):
    """(largest |d| in LSB, smallest share of equal elements) over the heads."""
    worst, equal = 0, 1.0
    assert len(want) == len(got) == 2
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        print(f"head {a.shape}: equal fraction {(diff == 0).mean():.6f}, max |d| {diff.max()}")
        worst, equal = max(worst, int(diff.max())), min(equal, float((diff == 0).mean()))
    return worst, equal


def jax_run_all(blob, opts, xq, monkeypatch):
    """The JAX engine on the tmfile bytes: every tensor of the forward
    ({tensor id: numpy array}, IR order), the routes {node name: lowering
    name}, and the output tensor ids. compile_graph applies the passes and
    selects the kernels; the forward that returns every tensor is built on
    the graph it made."""
    routes = {}
    select = jax_engine.select_kernel

    def recording_select(op, ctx):
        k = select(op, ctx)
        routes[ctx.node.name] = k.name
        return k

    monkeypatch.setattr(jax_engine, "select_kernel", recording_select)
    cgj = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**opts))
    store = jax_engine.ParamStore()
    forward_all, _, output_ids = jax_engine.build_forward(
        cgj.graph, cgj.options, store, return_all=True)
    jax.eval_shape(forward_all, {}, jax.ShapeDtypeStruct(xq.shape, xq.dtype))
    params = {k: jnp.asarray(v) for k, v in store.values.items()}
    store.phase = "trace"
    env = jax.jit(forward_all)(params, xq)
    return {tid: np.asarray(v) for tid, v in env.items()}, routes, output_ids


def port_run_all(cg, xq):
    """Every tensor of the port's forward on a compiled graph (kernels are
    selected anew, under the environment of the moment)."""
    store = port_engine.ParamStore()
    forward_all, _, _ = port_engine.build_forward(cg.graph, cg.options, store, return_all=True)
    with torch.inference_mode():
        forward_all({}, *port_engine._meta_inputs(cg.graph, cg.options))
        env = forward_all(store.upload(torch.device("cpu")), torch.from_numpy(xq))
    return {tid: v.numpy() for tid, v in env.items()}


def port_run_forced(blob, opts, xq, jax_env, monkeypatch):
    """The port on the same bytes with every quantized node's output
    replaced, once compared, by the reference run's tensor (jax_env: the
    JAX engine's tensors, or another tier's): each node then sees the inputs
    its counterpart saw. Returns {node name: (max |d| in LSB, share of
    elements that differ)} and the CompiledGraph."""
    seen = {}
    select = port_engine.select_kernel

    def forcing_select(op, ctx):
        k = select(op, ctx)
        tid = ctx.node.outputs[0] if len(ctx.node.outputs) == 1 else None

        def fn(c, *args):
            out = k.fn(c, *args)
            if (tid not in jax_env or isinstance(out, tuple) or out.x.device.type == "meta"
                    or out.x.is_floating_point()):
                return out
            got, want = as_semantic(out).numpy(), jax_env[tid]
            assert got.shape == want.shape and got.dtype == want.dtype, c.node.name
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            seen[c.node.name] = (int(d.max()), float((d > 0).mean()))
            return nchw(torch.from_numpy(want.copy()))

        return dataclasses.replace(k, fn=fn)

    monkeypatch.setattr(port_engine, "select_kernel", forcing_select)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    cg.run(xq)
    monkeypatch.setattr(port_engine, "select_kernel", select)
    return seen, cg


@pytest.mark.parametrize("scheme", ["int8", "uint8"])
def test_heads_match_jax_on_the_depthwise_tier(graphs, scheme, monkeypatch):
    """The JAX-quantized graph, carried as tmfile bytes, through both
    engines with TT_DW_PALLAS=1.

    Routes: every conv on the same lowering by name (13 on the dw kernel, 29
    1×1 on the direct route, the stem on the fast lowering).

    Node by node, each port node fed what its JAX counterpart was fed: at
    most 1 LSB apart, on at most 0.1% of a node's elements, and only at the
    kernels' requant epilogues. That is XLA:CPU's contraction of acc·M + B
    into one fused multiply-add where the port's contract rounds twice
    (tests/test_torch_qroutes.py builds the case): at batch 32 a layer has
    up to a million outputs and a handful land on such ties.

    End to end the heads therefore cannot be held to 1 LSB against the CPU's
    JAX run: each tie moves one activation by 1 LSB, the next layers spread
    it, and 40 layers on, some 7% of the head elements differ, by up to 5
    LSB. The bound here is what that mechanism gives with margin (8 LSB, 85%
    equal); a wrong fold, pad or route breaks the node-by-node check and
    moves the heads by tens of LSB.

    Then the port alone with the gate closed (14 convs on the fast lowering,
    whose uint8 depthwise branch the 13 then take) against its own depthwise
    tier, the same two ways. The dw route folds (bias - zp_in·colsum)·m in
    float64 into one f32 B; the fast lowering adds f32(bias·m) and
    f32(-zp_in·colsum·m) one after the other, as the JAX lowerings do. With
    zp_in = 0 (int8) the heads agree within 1 LSB; on the uint8 graph two
    depthwise convs part by 1 LSB on a few elements in 100,000 and the heads
    by up to 3 LSB, held to the same 8 LSB / 85% bound."""
    _, _, jqgs, _, x = graphs
    jqg = jqgs[scheme]
    t_in = jqg.tensors[jqg.input_tensors[0]]
    xq = jq.quantize_np(x, t_in.quant, t_in.dtype)
    dtype = np.uint8 if scheme == "uint8" else np.int8
    blob = graph_to_tm_bytes(jqg)

    monkeypatch.setenv("TT_DW_PALLAS", "1")
    jax_env, jax_routes, output_ids = jax_run_all(blob, OPTS, xq, monkeypatch)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**OPTS), device="cpu")
    assert _routes(cg) == ROUTES["1"]
    convs = [n.name for n in cg.graph.nodes if n.op == "Convolution"]
    for name in convs:
        assert cg.kernels[name] == jax_routes[name], name
    assert list(cg.output_ids) == list(output_ids)

    seen, _ = port_run_forced(blob, OPTS, xq, jax_env, monkeypatch)
    assert set(convs) <= set(seen) and len(seen) >= 70
    for name, (worst, share) in seen.items():
        assert worst <= 1 and share <= 1e-3, (name, worst, share)
        if cg.kernels[name] not in ("lower_conv_quant_pallas_dw", "lower_conv_quant_pallas_direct",
                                    "lower_conv_quant_fast"):
            assert worst == 0, (name, cg.kernels[name])

    port_env = port_run_all(cg, xq)
    got = [port_env[tid] for tid in output_ids]
    want = [jax_env[tid] for tid in output_ids]
    assert {tuple(o.shape) for o in got} == {(BATCH, 255, 2, 2), (BATCH, 255, 4, 4)}
    worst, equal = _head_diff(want, got, dtype)
    assert worst <= 8 and equal >= 0.85

    monkeypatch.setenv("TT_DW_PALLAS", "0")
    seen_e, _ = port_run_forced(blob, OPTS, xq, port_env, monkeypatch)
    cg_e = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**OPTS), device="cpu")
    assert _routes(cg_e) == ROUTES["0"]
    for name, (worst, share) in seen_e.items():
        if cg.kernels[name] == "lower_conv_quant_pallas_dw":
            assert cg_e.kernels[name] == "lower_conv_quant_fast"
            assert worst <= 1 and share <= 1e-3, (name, worst, share)
        else:
            assert worst == 0, (name, worst)
    worst, equal = _head_diff(got, cg_e.run(xq), dtype)
    assert (worst <= 1) if scheme == "int8" else (worst <= 8 and equal >= 0.85)
