"""The PyTorch port's float lowerings, part 2 (ops/lowering.py): Gemm,
MatMul, the normalizations LRN, InstanceNorm, LayerNorm and MVN, the
elementwise BroadMul, Maximum, Minimum, SquaredDifference, Addn and Mean,
the reductions and selections ArgMax, ArgMin, TopKV2, Reduction (all 11
types) and ReduceL2, the shape ops SwapAxis, Unsqueeze, Expanddims, Shape,
StridedSlice, Tile and Expand, and Gather, Cast, Comparison, Logical,
Reverse and Where, against the JAX package, on the CPU; and the registry:
the port lowers every op type that tengine_tpu/ops/lowering.py,
detection.py and lowering_extra.py register.

Each case is a one-node graph (tests/test_torch_shape_ops.py:
one_node_graph), or the node after a 1x1 conv so that its first input
arrives in the conv's NHWC layout (the conv reverses the channels: its
weights are a permutation matrix, exact in both engines, float and
quantized); further operands are graph inputs (in NCHW) or consts. Built
with the JAX IR and carried to the port as tmfile bytes. Float: both
engines on the same inputs. Quantized (UINT8 MinMax by the JAX quantizer,
its grids carried in the bytes): both engines under
Options(quant_mode="fast"), every node through the generic dequantize ->
f32 -> requantize wrapper, as the JAX engine routes them; the quantizer
keeps float outputs for ArgMax, ArgMin, TopKV2 and Shape. Every port
forward runs with torch's host upload and sync calls patched to raise, as
the captured forward on the card needs.

Tolerances, and why:
  * float, data movement, selection, comparison, cast and gather (the
    shape ops, Reverse, Where, Maximum, Minimum, ArgMax, ArgMin, TopKV2,
    Gather, Cast, Comparison, Logical, Reduction's max and min): equal bit
    for bit, NaN where JAX puts NaN;
  * float, a multiply-add or a sum of products (Gemm, MatMul, BroadMul,
    SquaredDifference, Addn, Mean, Reduction's sums and products): rtol
    1e-6 (XLA:CPU and torch sum the products in another order, and XLA
    contracts a product and a sum into one fused multiply-add);
  * float, transcendentals, LayerNorm, InstanceNorm, MVN, LRN, ReduceL2
    and Reduction's logs and means: rtol 1e-5 (XLA's and torch's exp, log,
    pow, sqrt, rsqrt and long sums round apart in the last bits);
  * both with an absolute floor of 1e-6 of the output's largest magnitude
    (a value that cancels to near 0, x - mean, is a large part of one
    rounding);
  * quantized: integer outputs (indices, Shape, Cast) equal bit for bit;
    through the wrapper at most 1 LSB, on at most 0.1% of the elements (a
    last-bit parting of the f32 value meets a .5 tie of the requant).
The edge cases where torch's semantics are not JAX's each have a case:
Gather's negative indices (wrapped once) and out-of-range ones (NaN);
Cast's saturating float -> int conversion with NaN to 0; TopKV2 and
ArgMax on ties (the lower index first); Reduction's types 6 (product),
8 (sum |x|, the runtime's "l2"), 9 (log sum) and 10 (the naive log sum
exp).
Measured here: every exact case equal; float within 4.8e-7 of the output's
largest magnitude (the mean over every axis after the conv); 0 LSB on
every quantized case.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

from test_torch_shape_ops import _both, one_node_graph  # noqa: E402

EXACT, AFFINE, TRANSCENDENTAL = "exact", "affine", "transcendental"
C = 8
S4 = (2, C, 6, 10)
S3 = (2, 5, 16)


def _vec(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _red(t, dims=(), keep=0):
    d = (list(dims) + [-2, -2, -2, -2])[:4]
    return dict(type=t, dim_0=d[0], dim_1=d[1], dim_2=d[2], dim_3=d[3], keepdim=keep)


def _ss(**kw):
    p = {f"{k}_{d}": 0 for k in ("begin", "end") for d in "nchw"}
    p.update({f"stride_{d}": 1 for d in "nchw"})
    p.update(kw)
    return p


GATHER_IDX = np.array([[-1, 0, 3], [-8, 7, 5]], np.int32)
# name: (op, params, input shapes (the first is the data input, the rest
# extra graph inputs), input kind, consts, outputs, comparison, runs after a
# conv too); kinds: "n" standard normal x 2, "pos" |x| + 0.5, "near1"
# 1 + x/10, "ties" x rounded to halves, "bin" 0.0 or 1.0 (the first input
# only; the others normal), "idx" (extra input: index values as floats)
CASES = {
    "gemm": ("Gemm", dict(alpha=1.5, beta=0.5, transA=0, transB=0), [(4, 6)], "n",
             (_vec(1, (6, 5)), _vec(2, (5,))), 1, AFFINE, False),
    "gemm-trans": ("Gemm", dict(alpha=1.0, beta=2.0, transA=1, transB=1), [(6, 4)], "n",
                   (_vec(3, (5, 6)), _vec(4, (4, 5))), 1, AFFINE, False),
    "gemm-nobias": ("Gemm", dict(alpha=0.5, beta=1.0, transA=0, transB=1), [(4, 6)], "n",
                    (_vec(5, (5, 6)),), 1, AFFINE, False),
    "matmul-batched": ("MatMul", {}, [(2, 3, 5, 6), (2, 3, 6, 4)], "n", (), 1, AFFINE, False),
    "matmul-const": ("MatMul", {}, [S3], "n", (_vec(6, (16, 7)),), 1, AFFINE, False),
    "matmul-4d": ("MatMul", {}, [S4], "n", (_vec(7, (10, 5)),), 1, AFFINE, True),
    "lrn": ("LRN", dict(local_size=5, alpha=1e-3, beta=0.75, norm_region=0, k=2.0), [S4], "n",
            (), 1, TRANSCENDENTAL, True),
    "lrn-3": ("LRN", dict(local_size=3, alpha=0.5, beta=0.6, norm_region=0, k=1.0), [S4], "n",
              (), 1, TRANSCENDENTAL, True),
    "instancenorm": ("InstanceNorm", dict(eps=1e-5), [S4], "n", (_vec(8, (C,), 0.5, 1.5),
                                                                 _vec(9, (C,))), 1,
                     TRANSCENDENTAL, True),
    "instancenorm-3d": ("InstanceNorm", dict(eps=1e-3), [S3], "n", (), 1, TRANSCENDENTAL, False),
    "layernorm": ("LayerNorm", dict(eps=1e-5), [S3], "n", (_vec(10, (16,), 0.5, 1.5),
                                                           _vec(11, (16,))), 1,
                  TRANSCENDENTAL, False),
    "layernorm-plain": ("LayerNorm", dict(eps=1e-6), [S3], "n", (), 1, TRANSCENDENTAL, False),
    "layernorm-4d": ("LayerNorm", dict(eps=1e-5), [S4], "n", (_vec(12, (10,), 0.5, 1.5),
                                                              _vec(13, (10,))), 1,
                     TRANSCENDENTAL, True),
    "mvn": ("MVN", dict(across_channels=0, normalize_variance=1, eps=1e-9), [S4], "n", (), 1,
            TRANSCENDENTAL, True),
    "mvn-across": ("MVN", dict(across_channels=1, normalize_variance=1, eps=1e-3), [S4], "n", (),
                   1, TRANSCENDENTAL, True),
    "mvn-mean": ("MVN", dict(across_channels=0, normalize_variance=0, eps=1e-9), [S4], "n", (),
                 1, TRANSCENDENTAL, True),
    "broadmul": ("BroadMul", {}, [S4, (2, C, 1, 1)], "n", (), 1, AFFINE, True),
    "broadmul-2d": ("BroadMul", {}, [(4, C), (C,)], "n", (), 1, AFFINE, False),
    "maximum": ("Maximum", {}, [S4, S4], "n", (), 1, EXACT, True),
    "minimum": ("Minimum", {}, [S4, S4], "n", (), 1, EXACT, True),
    "squareddifference": ("SquaredDifference", {}, [S4, S4], "n", (), 1, AFFINE, True),
    "addn": ("Addn", dict(axis=0), [S4, S4, S4], "n", (), 1, AFFINE, True),
    "mean": ("Mean", {}, [S4, S4, S4], "n", (), 1, AFFINE, True),
    "argmax": ("ArgMax", dict(axis=1, keepdims=1), [S4], "ties", (), 1, EXACT, True),
    "argmax-w": ("ArgMax", dict(axis=3, keepdims=0), [S4], "ties", (), 1, EXACT, True),
    "argmin": ("ArgMin", dict(axis=2, keepdims=1), [S4], "ties", (), 1, EXACT, True),
    "topk": ("TopKV2", dict(k=4, sorted=1), [S4], "ties", (), 2, EXACT, True),
    "topk-3d": ("TopKV2", dict(k=7, sorted=1), [S3], "ties", (), 2, EXACT, False),
    **{f"reduction-{t}": ("Reduction", _red(t, (1,), 1), [S4], kind, (), 1, cmp, True)
       for t, kind, cmp in ((0, "n", AFFINE), (1, "n", TRANSCENDENTAL), (2, "n", AFFINE),
                            (3, "n", AFFINE), (4, "n", EXACT), (5, "n", EXACT),
                            (6, "near1", AFFINE), (7, "n", AFFINE), (8, "n", AFFINE),
                            (9, "pos", TRANSCENDENTAL), (10, "n", TRANSCENDENTAL))},
    "reduction-hw": ("Reduction", _red(0, (2, 3), 0), [S4], "n", (), 1, AFFINE, True),
    "reduction-all": ("Reduction", _red(1), [S4], "n", (), 1, TRANSCENDENTAL, True),
    "reduction-prod-hw": ("Reduction", _red(6, (-1, -2), 1), [S4], "near1", (), 1, AFFINE, True),
    "reduction-mean-tokens": ("Reduction", _red(1, (1,), 0), [S3], "n", (), 1, TRANSCENDENTAL,
                              False),
    "reducel2": ("ReduceL2", dict(axis=1, keepdim=1), [S4], "n", (), 1, TRANSCENDENTAL, True),
    "reducel2-last": ("ReduceL2", dict(axis=-1, keepdim=0), [S3], "n", (), 1, TRANSCENDENTAL,
                      False),
    "swapaxis": ("SwapAxis", dict(dim_0=1, dim_1=2), [S3], "n", (), 1, EXACT, False),
    "swapaxis-4d": ("SwapAxis", dict(dim_0=1, dim_1=3), [S4], "n", (), 1, EXACT, True),
    "unsqueeze": ("Unsqueeze", dict(axes=[2, 0]), [S3], "n", (), 1, EXACT, False),
    "expanddims": ("Expanddims", dict(axis=1), [S3], "n", (), 1, EXACT, False),
    "expanddims-last": ("Expanddims", dict(axis=-1), [S3], "n", (), 1, EXACT, False),
    "shape": ("Shape", {}, [S4], "n", (), 1, EXACT, True),
    "stridedslice": ("StridedSlice", _ss(begin_c=1, end_c=3, stride_c=2, begin_h=1, end_h=2,
                                         stride_w=3), [S4], "n", (), 1, EXACT, True),
    "stridedslice-focus": ("StridedSlice", _ss(stride_h=2, stride_w=2, begin_w=1, end_w=1),
                           [S4], "n", (), 1, EXACT, True),
    "tile-caffe": ("Tile", dict(frame_flag=0, reps=[2, 1, 3]), [S4], "n", (), 1, EXACT, True),
    "tile-onnx": ("Tile", dict(frame_flag=1, reps=[2, 1, 3, 2]), [S4], "n", (), 1, EXACT, True),
    "tile-3d": ("Tile", dict(frame_flag=1, reps=[1, 2, 1, 2]), [S3], "n", (), 1, EXACT, False),
    "expand": ("Expand", dict(shape=[2, C, 6, 10]), [(1, C, 1, 10)], "n", (), 1, EXACT, True),
    "expand-rank": ("Expand", dict(shape=[3, 1, 5, 16]), [(5, 1)], "n", (), 1, EXACT, False),
    "gather": ("Gather", dict(axis=1, indices_num=6), [S4], "n", (GATHER_IDX,), 1, EXACT, True),
    "gather-w": ("Gather", dict(axis=3, indices_num=3), [S4], "n",
                 (np.array([9, -10, 2], np.int32),), 1, EXACT, True),
    "gather-float-idx": ("Gather", dict(axis=0, indices_num=4), [(5, 7), (4,)], "idx", (), 1,
                         EXACT, False),
    **{f"cast-{to}": ("Cast", dict(type_from=0, type_to=to), [S4], "n", (), 1, EXACT, True)
       for to in (0, 2, 3, 4)},
    **{f"comparison-{t}": ("Comparison", dict(type=t), [S4, S4], "ties", (), 1, EXACT, True)
       for t in range(6)},
    "logical-and": ("Logical", dict(type=0), [S4, S4], "bin", (), 1, EXACT, True),
    "logical-or": ("Logical", dict(type=1), [S4, S4], "bin", (), 1, EXACT, True),
    "logical-not": ("Logical", dict(type=2), [S4], "bin", (), 1, EXACT, True),
    "reverse": ("Reverse", {}, [S4], "n", (np.array([2], np.int32),), 1, EXACT, True),
    "reverse-0": ("Reverse", {}, [S4], "n", (), 1, EXACT, True),
    # the JAX lowering broadcasts cond as it is: no NHWC cond
    "where": ("Where", {}, [S4, S4, S4], "bin", (), 1, EXACT, False),
}
# the quantizer keeps these outputs float (quantize/quantizer.py:
# _KEEP_FLOAT_OUTPUT_OPS); Cast to an integer type returns integers
FLOAT_OUT = {"ArgMax", "ArgMin", "TopKV2", "Shape"}
IDS = [(name, conv) for name, case in CASES.items() for conv in ((False, True) if case[7] else
                                                                  (False,))]


def _ids():
    return [f"{n}{'-nhwc' if c else ''}" for n, c in IDS]


def _inputs(name, conv):
    """The graph and its inputs; the node after the channel-reversing conv
    with conv."""
    op, params, shapes, kind, consts, n_out, _, _ = CASES[name]
    g = one_node_graph(op, params, shapes[0], n_out, conv, consts, shapes[1:])
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(s).astype(np.float32) * 2 for s in shapes]
    if kind == "pos":
        xs[0] = np.abs(xs[0]) + 0.5
    elif kind == "near1":
        xs[0] = 1 + xs[0] / 20
    elif kind == "ties":
        xs = [np.round(x).astype(np.float32) / 2 for x in xs]
    elif kind == "bin":
        xs = [(x > 0).astype(np.float32) for x in xs[:1]] + xs[1:]
        if op == "Logical":
            xs = [(x > 0).astype(np.float32) for x in xs]
    elif kind == "idx":
        xs[1] = np.array([-1.7, 2.2, -5.0, 4.9], np.float32)
    return g, xs


def _compare(got, want, cmp):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                   got.dtype, want.dtype)
    if cmp == EXACT or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6 if cmp == AFFINE else 1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name,conv", IDS, ids=_ids())
def test_float_lowering_matches_jax(name, conv, monkeypatch):
    g, xs = _inputs(name, conv)
    want, got, routes, cg = _both(graph_to_tm_bytes(g), dict(precision="fp32"), xs, monkeypatch)
    op, cmp = CASES[name][0], CASES[name][6]
    assert cg.kernels == routes
    assert len(got) == len(want) == CASES[name][5]
    for a, b in zip(got, want):
        _compare(a, b, cmp)


@pytest.mark.parametrize("name,conv", IDS, ids=_ids())
def test_quantized_lowering_matches_jax(name, conv, monkeypatch):
    g, xs = _inputs(name, conv)
    qg = jax_quantize(g, [xs], scheme="uint8", algorithm="minmax")
    xq = [jq.quantize_np(x, qg.tensors[tid].quant, qg.tensors[tid].dtype)
          for tid, x in zip(qg.input_tensors, xs)]
    want, got, routes, cg = _both(graph_to_tm_bytes(qg), dict(quant_mode="fast"), xq, monkeypatch)
    op = CASES[name][0]
    node = cg.graph.nodes[-1]
    assert cg.kernels == routes
    assert not cg.graph.tensors[node.outputs[0]].quant or op not in FLOAT_OUT
    assert len(got) == len(want) == CASES[name][5]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype != np.uint8:  # indices, shapes, casts and float outputs
            _compare(a, b, CASES[name][6])
            continue
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


WILD = np.array([[3e9, -3e9, np.nan, np.inf, -np.inf, 300.0, -500.0, 2.7, -2.7, 127.9, -128.9,
                  255.5, 0.0, -0.0, 1e-30, 65535.0]], np.float32)


@pytest.mark.parametrize("to", [2, 3, 4])
def test_cast_saturates_and_sends_nan_to_zero(to, monkeypatch):
    """XLA's float -> integer conversion saturates at the type's range and
    sends NaN to 0; a plain torch cast wraps and sends NaN to the lowest
    value. The port follows XLA."""
    g = one_node_graph("Cast", dict(type_from=0, type_to=to), WILD.shape)
    want, got, _, _ = _both(graph_to_tm_bytes(g), dict(precision="fp32"), [WILD], monkeypatch)
    np.testing.assert_array_equal(got[0], want[0])
    dt = {2: torch.int8, 3: torch.uint8, 4: torch.int32}[to]
    info = torch.iinfo(dt)
    assert got[0][0, 0] == info.max and got[0][0, 2] == 0 and got[0][0, 7] == 2
    if to != 3:
        assert got[0][0, 1] == info.min
        plain = torch.from_numpy(WILD).to(dt).numpy()
        assert not np.array_equal(plain, got[0])


@pytest.mark.parametrize("conv", [False, True], ids=["nchw", "nhwc"])
def test_gather_wraps_negative_indices_once_and_fills_the_rest(conv, monkeypatch):
    """jnp.take's default mode: an index in [-n, n) picks, the negative ones
    wrapped once; any other gives NaN. torch.index_select rejects both."""
    idx = np.array([[-1, 0, 3], [-8, -9, 100]], np.int32)
    g = one_node_graph("Gather", dict(axis=1, indices_num=6), S4, 1, conv, (idx,))
    x = np.random.default_rng(3).standard_normal(S4).astype(np.float32)
    want, got, _, _ = _both(graph_to_tm_bytes(g), dict(precision="fp32"), [x], monkeypatch)
    np.testing.assert_array_equal(got[0], want[0])
    if not conv:
        np.testing.assert_array_equal(got[0][:, 0, 0], x[:, C - 1])  # -1
        np.testing.assert_array_equal(got[0][:, 1, 0], x[:, 0])  # -8 wraps once to 0
    assert np.isnan(got[0][:, 1, 1:]).all() and not np.isnan(got[0][:, 0]).any()


def test_topk_and_argmax_keep_ties_in_index_order(monkeypatch):
    """lax.top_k and jnp.argmax put the lower index first among equal
    values; the port's stable sort does too (torch.topk promises no
    order). lax.top_k also orders +0.0 above -0.0, which torch.sort takes
    as equal."""
    x = np.array([[1.0, 3.0, -0.0, 3.0, 0.5, 0.0, 3.0, 1.0, 2.0, 2.0]], np.float32)
    for op, params, n_out in (("TopKV2", dict(k=8, sorted=1), 2),
                              ("ArgMax", dict(axis=1, keepdims=0), 1)):
        g = one_node_graph(op, params, x.shape, n_out)
        want, got, _, _ = _both(graph_to_tm_bytes(g), dict(precision="fp32"), [x], monkeypatch)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        if op == "TopKV2":
            np.testing.assert_array_equal(got[1], [[1, 3, 6, 8, 9, 0, 7, 4]])
        else:
            np.testing.assert_array_equal(got[0], [1])
    g = one_node_graph("TopKV2", dict(k=10, sorted=1), x.shape, 2)
    want, got, _, _ = _both(graph_to_tm_bytes(g), dict(precision="fp32"), [x], monkeypatch)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1][0, -2:], [5, 2])  # +0.0, then -0.0


@pytest.mark.parametrize("t,want", [(6, np.prod), (8, lambda a, axis: np.abs(a).sum(axis)),
                                    (9, lambda a, axis: np.log(a.sum(axis))),
                                    (10, lambda a, axis: np.log(np.exp(a).sum(axis)))],
                         ids=["prod", "asum-l2", "log-sum", "log-sum-exp"])
def test_reduction_types_follow_the_runtime_table(t, want, monkeypatch):
    """Type 6 is the product, 8 (named "l2" in the param header) sums |x|,
    9 is log(sum), 10 the naive log(sum(exp)), which overflows to inf where
    torch.logsumexp would not; against numpy and the JAX engine."""
    x = np.array([[0.5, 1.5, 2.0, 1.25], [100.0, 1.0, 0.25, 3.0]], np.float32)
    if t == 9:
        x = np.abs(x)
    g = one_node_graph("Reduction", _red(t, (1,), 0), x.shape)
    jax_out, got, _, _ = _both(graph_to_tm_bytes(g), dict(precision="fp32"), [x], monkeypatch)
    np.testing.assert_allclose(got[0], jax_out[0], rtol=1e-6)
    np.testing.assert_allclose(got[0], want(x, axis=1), rtol=1e-5)
    if t == 10:
        assert np.isinf(got[0][1]) and np.isfinite(torch.logsumexp(torch.from_numpy(x), 1)).all()


def test_registry_covers_the_jax_lowerings():
    """The port registers a lowering for every op type that
    tengine_tpu/ops/lowering.py, detection.py and lowering_extra.py
    register (106: all of the reference's)."""
    import tengine_tpu.executor.engine  # noqa: F401 — populate the registry
    from tengine_tpu.ops.registry import _REGISTRY as jax_registry

    import tengine_tpu_torch.executor.engine  # noqa: F401
    from tengine_tpu_torch.ops.registry import _REGISTRY as port_registry

    modules = {"tengine_tpu.ops.lowering", "tengine_tpu.ops.detection",
               "tengine_tpu.ops.lowering_extra"}
    want = {op for op, kernels in jax_registry.items()
            if any(k.fn.__module__ in modules for k in kernels)}
    assert len(want) == 106
    assert want <= set(port_registry), sorted(want - set(port_registry))
