"""The port's fuse_resnet_blocks pass and FusedResBlockChain lowering against
the JAX package's, on the CPU, on the five bottleneck-chain graphs of
tests/test_resblock_fusion.py (identity chain, projection head, stride-2
head, no trailing ReLu, odd batch). The graphs are built and quantized by
the JAX package (int8 per-channel, MinMax) and carried as tmfile bytes. The
JAX engine runs its Pallas chain kernel in interpret mode, the port its
kernel's plain version.

Tiers: F = Options(quant_mode="fast", fuse_resblock=True,
quant_relaxed=False), the exact chain; G = F without fuse_resblock, the
unfused convs with fuse_conv_add; R = F with quant_relaxed=True,
quant_native="off", the chain's single-rounding epilogue.

Tolerances: F and R against the JAX engine, and the port's F against its G,
within 1 LSB on fewer than 2% of the elements (the JAX package's own bound
for fused against unfused, tests/test_resblock_fusion.py:106-109: .5 ties
where XLA's CPU compiler fuses a multiply-add and the port rounds twice,
tests/test_torch_qblock.py, and where the chain multiplies by f32(1/s_out)
and the unfused epilogue divides). R against F: the relaxed tier's bounds of
tests/test_relaxed_tier.py:43-47.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.graph.passes import fuse_resnet_blocks as jax_fuse  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.graph.passes import fuse_resnet_blocks as port_fuse  # noqa: E402

from test_resblock_fusion import build_chain_graph, quantized_pair  # noqa: E402
from test_torch_qroutes import both_engines  # noqa: E402
from test_torch_yolov5 import assert_ir_equal  # noqa: E402

# tests/test_resblock_fusion.py:117-138
GRAPHS = {
    "identity_chain": dict(n=2, c0=16, c_mid=8, c_out=16, hw=8, nblocks=2),
    "proj_head": dict(n=2, c0=8, c_mid=8, c_out=16, hw=8, nblocks=3),
    "stride2_head": dict(n=2, c0=8, c_mid=8, c_out=16, hw=8, nblocks=2, first_stride=2),
    "no_trailing_relu": dict(n=2, c0=16, c_mid=8, c_out=16, hw=8, nblocks=1,
                             trailing_relu=False),
    "odd_batch": dict(n=3, c0=16, c_mid=8, c_out=16, hw=8, nblocks=2),
}
F = dict(quant_mode="fast", fuse_resblock=True, quant_relaxed=False)
G = dict(quant_mode="fast", quant_relaxed=False)
R = dict(quant_mode="fast", fuse_resblock=True, quant_relaxed=True, quant_native="off")


@functools.lru_cache(maxsize=None)
def quantized(name):
    """(tmfile bytes of the JAX-quantized graph, its quantized input)."""
    qg, xq = quantized_pair(np.random.default_rng(3), **GRAPHS[name])
    return graph_to_tm_bytes(qg), xq


@functools.lru_cache(maxsize=None)
def port_run(name, tier):
    blob, xq = quantized(name)
    opts = {"F": F, "G": G, "R": R}[tier]
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    return cg, cg.run(xq)


def assert_close(want, got, what):
    """Within 1 LSB, on fewer than 2% of the elements."""
    assert len(want) == len(got) == 1
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype == np.int8
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        print(f"{what}: max |d| {d.max()}, {(d > 0).sum()} of {d.size} differ")
        assert d.max() <= 1 and (d > 0).mean() < 0.02, what


@pytest.mark.parametrize("name", list(GRAPHS))
def test_pass_gives_the_jax_ir(name):
    """Same nodes, inputs, `blocks` params and outputs, the Noop shells and
    the orphaned mid tensors included."""
    blob, _ = quantized(name)
    jg, pg = jt.load_tm_bytes(blob), pt.load_tm_bytes(blob)
    assert jax_fuse(jg) == port_fuse(pg) == GRAPHS[name]["nblocks"]
    assert_ir_equal(jg, pg)
    for a, b in zip(jg.tensors, pg.tensors):
        assert (a.producer, list(a.consumers)) == (b.producer, list(b.consumers)), a.name
    chains = [n for n in pg.nodes if n.op == "FusedResBlockChain"]
    assert len(chains) == 1 and len(chains[0].params["blocks"]) == GRAPHS[name]["nblocks"]
    assert all(not n.inputs and not n.outputs for n in pg.nodes if n.op == "Noop")


def test_pass_does_not_match_uint8():
    rng = np.random.default_rng(3)
    g = build_chain_graph(rng, n=1, c0=16, c_mid=8, c_out=16, hw=8, nblocks=1)
    calib = [rng.standard_normal((1, 16, 8, 8)).astype(np.float32)]
    pg = pt.load_tm_bytes(graph_to_tm_bytes(jax_quantize(g, calib, scheme="uint8")))
    assert port_fuse(pg) == 0
    assert not any(n.op == "FusedResBlockChain" for n in pg.nodes)


def test_min_cmid_and_the_width_knob(monkeypatch):
    """min_cmid skips narrower blocks; TT_CHAIN_CMID keeps only the listed
    widths. Under quant_relaxed without fuse_resblock the engine passes
    Options.chain_min_cmid, as the JAX engine does."""
    blob, xq = quantized("identity_chain")
    assert port_fuse(pt.load_tm_bytes(blob), min_cmid=9) == 0
    assert port_fuse(pt.load_tm_bytes(blob), min_cmid=8) == 2
    monkeypatch.setenv("TT_CHAIN_CMID", "16,32")
    assert port_fuse(pt.load_tm_bytes(blob)) == jax_fuse(jt.load_tm_bytes(blob)) == 0
    monkeypatch.setenv("TT_CHAIN_CMID", "8")
    assert port_fuse(pt.load_tm_bytes(blob)) == 2
    monkeypatch.delenv("TT_CHAIN_CMID")
    relaxed = dict(quant_mode="fast", quant_relaxed=True, quant_native="off")
    for min_cmid, op in ((256, "Convolution"), (0, "FusedResBlockChain")):
        cg = pt.compile_graph(pt.load_tm_bytes(blob),
                              pt.Options(chain_min_cmid=min_cmid, **relaxed), device="cpu")
        assert any(n.op == op for n in cg.graph.nodes)
        assert (op == "FusedResBlockChain") == ("lower_resblock_chain" in cg.kernels.values())


@pytest.mark.parametrize("tier", ["F", "R"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_chain_tier_matches_jax(name, tier, monkeypatch):
    blob, xq = quantized(name)
    opts = {"F": F, "R": R}[tier]
    qg = jt.load_tm_bytes(blob)
    want, jax_routes, got, cg = both_engines(qg, opts, xq, monkeypatch)
    chain = [n.name for n in cg.graph.nodes if n.op == "FusedResBlockChain"]
    assert len(chain) == 1
    assert cg.kernels[chain[0]] == jax_routes[chain[0]] == "lower_resblock_chain"
    assert not any(n.op in ("Convolution", "Eltwise", "ReLu") for n in cg.graph.nodes)
    assert_close(want, got, f"{name} {tier} port vs JAX")
    np.testing.assert_array_equal(got[0], port_run(name, tier)[1][0])


@pytest.mark.parametrize("name", list(GRAPHS))
def test_exact_chain_matches_the_unfused_convs(name):
    cg_g, out_g = port_run(name, "G")
    assert "lower_resblock_chain" not in cg_g.kernels.values()
    assert_close(out_g, port_run(name, "F")[1], f"{name} port F vs G")


@pytest.mark.parametrize("name", list(GRAPHS))
def test_relaxed_chain_against_exact(name):
    """tests/test_relaxed_tier.py:43-47: each skipped rounding moves a value
    by a fraction of an output LSB, so a few LSB on the tails."""
    (a,), (b,) = port_run(name, "R")[1], port_run(name, "F")[1]
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    print(f"{name} R vs F: max |d| {d.max()}, >1: {(d > 1).mean():.4f}, >3: {(d > 3).mean():.4f}")
    assert d.max() <= 6 and (d > 1).mean() < 0.10 and (d > 3).mean() < 0.01


def test_pass_does_not_match_full_range_grids():
    """The chain kernel clips every INT8 activation at +-127, with zero
    point 0. A full-range grid with zero point 0 (a TFLite import's, whose
    int8 tensors clip at -128) keeps its blocks on the convs: the same
    graph fuses its blocks without the flag and none with it."""
    blob, _ = quantized("identity_chain")
    assert port_fuse(pt.load_tm_bytes(blob)) == 2
    pg = pt.load_tm_bytes(blob)
    for t in pg.tensors:
        if t.data is None and t.quant is not None and t.dtype.name == "INT8":
            t.quant.full_range = True
    assert port_fuse(pg) == 0
    assert not any(n.op == "FusedResBlockChain" for n in pg.nodes)
