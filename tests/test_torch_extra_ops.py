"""The PyTorch port's last 19 lowerings (ops/lowering_extra.py): LSTM, RNN,
GRU, ROIPooling, Roialign, Psroipooling, RPN, SpaceToBatchND,
BatchToSpaceND, L2Pool, Bias, Embedding, Scatter, SparseToDense,
DetectionPostProcess, SpatialTransformer, FusedBNScaleReLu, Accuracy and
Generic, against the JAX package, on the CPU; and the registry: every
TM2 op type has a lowering, as tests/test_op_coverage.py holds the JAX
package to.

Each case is a one-node graph (tests/test_torch_shape_ops.py:
one_node_graph), or the node after a 1x1 conv so that its first input
arrives in the conv's NHWC layout (the conv reverses the channels, exact in
both engines); further operands are graph inputs or consts. Built with the
JAX IR and carried to the port as tmfile bytes. Float: both engines on the
same inputs. Quantized (UINT8 MinMax by the JAX quantizer): both engines
under Options(quant_mode="fast"), every node through the generic
dequantize -> f32 -> requantize wrapper, as the JAX engine routes them; RPN
keeps a float output. Every port forward runs with torch's host upload and
sync calls patched to raise, as the captured forward on the card needs.

Tolerances, and why:
  * float, data movement, selection and max (SpaceToBatchND,
    BatchToSpaceND, Bias, Embedding, Scatter, SparseToDense, Accuracy,
    ROIPooling, L2Pool): equal bit for bit, NaN where JAX puts NaN (the
    port divides by a constant as XLA compiles it, a multiply by the f32
    reciprocal; L2Pool sums its window in XLA's order);
  * float, products and sums (Roialign, Psroipooling, SpatialTransformer,
    FusedBNScaleReLu, DetectionPostProcess): rtol 1e-6 (XLA:CPU contracts
    a product and a sum into one fused multiply-add, and sums a
    contraction in another order);
  * float, the recurrences and RPN (sigmoid, tanh, exp, over up to 8
    steps): rtol 1e-5;
  * each with an absolute floor of 1e-6 of the output's largest
    magnitude;
  * quantized: at most 1 LSB on at most 0.1% of the elements (a last-bit
    parting of the f32 value meets a .5 tie of the requant).
The hazards each have a case: the saturating float -> int casts of
ROIPooling's rounded corners and Psroipooling's floor/ceil (corners at
+-1e10), Embedding's wrapped and out-of-range indices (jnp.take),
Scatter's and SparseToDense's negative and out-of-range indices (wrapped
once, dropped), L2Pool's division by 9, SpatialTransformer's
jnp.linspace grid (held equal to JAX's own), the recurrent biases (8H,
4H and none; 6H, 3H and none).
Scatter and SparseToDense with duplicate indices: the order in which
either engine applies them is unspecified; test_duplicate_indices shows
what each does here.
Measured here: every exact case equal; the recurrences within 6.3e-7 of
the output's largest magnitude, the ROI ops, SpatialTransformer and
FusedBNScaleReLu within 4e-7, RPN within 8.1e-8, DetectionPostProcess
equal; 0 LSB on every quantized case.
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


def _vec(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


T_, B_, I_, H_ = 8, 2, 5, 4
ROIS = np.array([[0, 0, 3, 3], [2, 1, 7, 6], [1.5, 2.5, 4.4, 8.6], [-3, -2, 20, 15],
                 [5, 5, 4, 4], [0.5, 0.5, 1.5, 1.5]], np.float32)
ROIS_WILD = np.array([[1e10, -1e10, 3e9, 2.0], [-1e10, 1.0, 1e10, 1e10], [2, 3, 2, 3]],
                     np.float32)
RPN = dict(feat_stride=16, basesize=16, min_size=16, per_nms_topn=60, post_nms_topn=20,
           nms_thresh=0.7, ratios=[0.5, 1.0, 2.0], anchor_scales=[2.0, 4.0, 8.0], anchors=[])
DPP = dict(max_detections=6, max_classes_per_detection=1, nms_score_threshold=0.3,
           nms_iou_threshold=0.5, num_classes=3, scales=[10.0, 10.0, 5.0, 5.0])
S4 = (2, 6, 7, 9)


def _emb_idx():
    return np.array([1.0, 5.0, 9.0, -1.0, 3.7, -10.0, 10.0, 12.0, -11.0], np.float32)


# name: (op, params, input shapes (the first is the data input, the rest
# extra graph inputs), consts, comparison, runs after a conv too, inputs
# (a function of the rng returning every graph input, or None: standard
# normal x 2))
CASES = {
    "lstm": ("LSTM", dict(hidden_size=H_), [(T_, B_, I_)],
             (_vec(1, (4 * H_, I_)), _vec(2, (4 * H_, H_))), TRANSCENDENTAL, False, None),
    "lstm-bias8h": ("LSTM", dict(hidden_size=H_), [(T_, B_, I_)],
                    (_vec(3, (4 * H_, I_)), _vec(4, (4 * H_, H_)), _vec(5, (8 * H_,))),
                    TRANSCENDENTAL, False, None),
    "lstm-bias4h": ("LSTM", dict(hidden_size=H_), [(T_, B_, I_)],
                    (_vec(6, (4 * H_, I_)), _vec(7, (4 * H_, H_)), _vec(8, (4 * H_,))),
                    TRANSCENDENTAL, False, None),
    "rnn": ("RNN", dict(hidden_size=H_), [(T_, B_, I_)],
            (_vec(9, (H_, I_)), _vec(10, (H_, H_))), TRANSCENDENTAL, False, None),
    "rnn-bias": ("RNN", dict(hidden_size=H_), [(T_, B_, I_)],
                 (_vec(11, (H_, I_)), _vec(12, (H_, H_)), _vec(13, (2 * H_,))),
                 TRANSCENDENTAL, False, None),
    "gru": ("GRU", dict(hidden_size=H_), [(T_, B_, I_)],
            (_vec(14, (3 * H_, I_)), _vec(15, (3 * H_, H_))), TRANSCENDENTAL, False, None),
    "gru-bias6h": ("GRU", dict(hidden_size=H_), [(T_, B_, I_)],
                   (_vec(16, (3 * H_, I_)), _vec(17, (3 * H_, H_)), _vec(18, (6 * H_,))),
                   TRANSCENDENTAL, False, None),
    "gru-bias3h": ("GRU", dict(hidden_size=H_), [(T_, B_, I_)],
                   (_vec(19, (3 * H_, I_)), _vec(20, (3 * H_, H_)), _vec(21, (3 * H_,))),
                   TRANSCENDENTAL, False, None),
    "roipooling": ("ROIPooling", dict(pooled_h=2, pooled_w=3, spatial_scale=1.0),
                   [(1, 6, 8, 10), ROIS.shape], (), EXACT, True,
                   lambda r: [r.standard_normal((1, 6, 8, 10)).astype(np.float32), ROIS]),
    "roipooling-scale": ("ROIPooling", dict(pooled_h=3, pooled_w=2, spatial_scale=0.5),
                         [(1, 6, 8, 10), ROIS.shape], (), EXACT, True,
                         lambda r: [r.standard_normal((1, 6, 8, 10)).astype(np.float32),
                                    ROIS * 2.3]),
    "roipooling-saturate": ("ROIPooling", dict(pooled_h=2, pooled_w=2, spatial_scale=1.0),
                            [(1, 6, 8, 10), ROIS_WILD.shape], (), EXACT, False,
                            lambda r: [r.standard_normal((1, 6, 8, 10)).astype(np.float32),
                                       ROIS_WILD]),
    "roialign": ("Roialign", dict(pooled_height=2, pooled_width=3, spatial_scale=0.5),
                 [(1, 6, 8, 10), ROIS.shape], (), AFFINE, True,
                 lambda r: [r.standard_normal((1, 6, 8, 10)).astype(np.float32), ROIS * 2.3]),
    "psroipooling": ("Psroipooling", dict(pooled_h=2, pooled_w=3, spatial_scale=1.0,
                                          output_dim=2),
                     [(1, 12, 8, 10), ROIS.shape], (), AFFINE, True,
                     lambda r: [r.standard_normal((1, 12, 8, 10)).astype(np.float32), ROIS]),
    "psroipooling-saturate": ("Psroipooling", dict(pooled_h=2, pooled_w=2, spatial_scale=1.0,
                                                   output_dim=3),
                              [(1, 12, 8, 10), ROIS_WILD.shape], (), AFFINE, False,
                              lambda r: [r.standard_normal((1, 12, 8, 10)).astype(np.float32),
                                         ROIS_WILD]),
    "rpn": ("RPN", RPN, [(1, 18, 6, 6), (1, 36, 6, 6), (1, 3)], (), TRANSCENDENTAL, True,
            lambda r: [r.standard_normal((1, 18, 6, 6)).astype(np.float32),
                       (r.standard_normal((1, 36, 6, 6)) * 0.3).astype(np.float32),
                       np.array([[96.0, 80.0, 1.0]], np.float32)]),
    "rpn-anchors": ("RPN", dict(RPN, feat_stride=8, min_size=4, post_nms_topn=70,
                                anchors=[[-8, -8, 23, 23], [-20, -4, 35, 19]]),
                    [(1, 4, 5, 7), (1, 8, 5, 7), (3,)], (), TRANSCENDENTAL, False,
                    lambda r: [r.standard_normal((1, 4, 5, 7)).astype(np.float32),
                               (r.standard_normal((1, 8, 5, 7)) * 0.3).astype(np.float32),
                               np.array([40.0, 56.0, 1.0], np.float32)]),
    "spacetobatchnd": ("SpaceToBatchND", dict(dilation_x=2, dilation_y=2, pad_top=1,
                                              pad_bottom=0, pad_left=0, pad_right=1),
                       [(1, 6, 7, 9)], (), EXACT, True, None),
    "batchtospacend": ("BatchToSpaceND", dict(dilation_x=2, dilation_y=2, crop_top=1,
                                              crop_bottom=0, crop_left=0, crop_right=1),
                       [(4, 6, 3, 5)], (), EXACT, True, None),
    "l2pool": ("L2Pool", dict(padding_type=0, kernel_h=3, kernel_w=3, stride_h=2, stride_w=2),
               [S4], (), EXACT, True, None),
    "l2pool-2": ("L2Pool", dict(padding_type=0, kernel_h=2, kernel_w=3, stride_h=2, stride_w=1),
                 [S4], (), EXACT, True, None),
    "bias": ("Bias", dict(bias_size=6), [S4], (_vec(22, (6,)),), EXACT, True, None),
    "bias-2d": ("Bias", dict(bias_size=6), [(4, 6)], (_vec(23, (6,)),), EXACT, False, None),
    "embedding": ("Embedding", dict(num_output=6, input_dim=10, bias_term=0,
                                    weight_data_size=60), [(9,)], (_vec(24, (10, 6)),),
                  EXACT, False, lambda r: [_emb_idx()]),
    "embedding-bias": ("Embedding", dict(num_output=6, input_dim=10, bias_term=1,
                                         weight_data_size=60), [(2, 3)],
                       (_vec(25, (10, 6)), _vec(26, (6,))), EXACT, False,
                       lambda r: [np.array([[0.0, 9.0, 4.2], [7.9, -3.0, 2.0]], np.float32)]),
    "scatter": ("Scatter", dict(axis=0, is_onnx=True), [(5, 4), (2, 4), (2, 4)], (), EXACT,
                False, lambda r: [r.standard_normal((5, 4)).astype(np.float32),
                                  np.array([[0, -1, 7, 2], [3, 1, -2, -6]], np.float32),
                                  r.standard_normal((2, 4)).astype(np.float32)]),
    "scatter-axis2": ("Scatter", dict(axis=2, is_onnx=True), [(2, 3, 5), (2, 2, 2), (2, 2, 2)],
                      (), EXACT, False,
                      lambda r: [r.standard_normal((2, 3, 5)).astype(np.float32),
                                 np.array([[[4, 0], [1, -5]], [[-1, 2], [3, 0]]], np.float32),
                                 r.standard_normal((2, 2, 2)).astype(np.float32)]),
    "sparsetodense": ("SparseToDense", dict(output_shape_size0=10, output_shape_size1=0,
                                            default_value=2), [(6,), (6,)],
                      (np.array([10], np.int32),), EXACT, False,
                      lambda r: [np.array([0, 3, -1, 12, 5, -11], np.float32),
                                 r.standard_normal(6).astype(np.float32)]),
    "sparsetodense-2d": ("SparseToDense", dict(output_shape_size0=4, output_shape_size1=5,
                                               default_value=0), [(5, 2), (5,)],
                         (np.array([4, 5], np.int32),), EXACT, False,
                         lambda r: [np.array([[0, 0], [3, 4], [-1, 2], [1, 7], [4, 0]],
                                             np.float32),
                                    r.standard_normal(5).astype(np.float32)]),
    "detectionpostprocess": ("DetectionPostProcess", DPP, [(1, 40, 4), (1, 40, 3), (40, 4)],
                             (), AFFINE, False,
                             lambda r: [(r.standard_normal((1, 40, 4)) * 0.5).astype(np.float32),
                                        r.uniform(0, 1, (1, 40, 3)).astype(np.float32),
                                        np.concatenate([r.uniform(0.2, 0.8, (40, 2)),
                                                        r.uniform(0.1, 0.3, (40, 2))],
                                                       1).astype(np.float32)]),
    "spatialtransformer": ("SpatialTransformer", dict(target_shape=[5, 7]),
                           [(2, 3, 6, 8), (2, 6)], (), AFFINE, True,
                           lambda r: [r.standard_normal((2, 3, 6, 8)).astype(np.float32),
                                      (np.array([1, 0, 0, 0, 1, 0], np.float32)
                                       + r.standard_normal((2, 6)).astype(np.float32) * 0.2)]),
    "spatialtransformer-same": ("SpatialTransformer", dict(target_shape=[]),
                                [(1, 3, 13, 24), (1, 6)], (), AFFINE, False,
                                lambda r: [r.standard_normal((1, 3, 13, 24)).astype(np.float32),
                                           np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0]],
                                                    np.float32)]),
    "fusedbnscalerelu": ("FusedBNScaleReLu", {}, [S4], (_vec(27, (6,)), _vec(28, (6,))),
                         AFFINE, True, None),
    "fusedbnscalerelu-noshift": ("FusedBNScaleReLu", {}, [S4], (_vec(29, (6,)),), AFFINE, True,
                                 None),
    "accuracy": ("Accuracy", {}, [S4], (), EXACT, True, None),
}
IDS = [(name, conv) for name, case in CASES.items() for conv in ((False, True) if case[5] else
                                                                  (False,))]
# float only: outputs the MinMax calibration cannot take (-inf in an empty
# ROI bin, NaN rows of out-of-range indices)
FLOAT_ONLY = {"roipooling-saturate", "embedding"}
QUANT_IDS = [(name, conv) for name, conv in IDS if name not in FLOAT_ONLY]


def _ids(ids=IDS):
    return [f"{n}{'-nhwc' if c else ''}" for n, c in ids]


def _inputs(name, conv):
    op, params, shapes, consts, _, _, make = CASES[name]
    g = one_node_graph(op, params, shapes[0], 1, conv, consts, shapes[1:])
    rng = np.random.default_rng(3)
    xs = make(rng) if make else [rng.standard_normal(s).astype(np.float32) * 2 for s in shapes]
    return g, xs


def _compare(got, want, cmp):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                   got.dtype, want.dtype)
    if cmp == EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6 if cmp == AFFINE else 1e-5,
                                   atol=1e-6 * np.nanmax(np.abs(want)))


@pytest.mark.parametrize("name,conv", IDS, ids=_ids())
def test_float_lowering_matches_jax(name, conv, monkeypatch):
    g, xs = _inputs(name, conv)
    want, got, routes, cg = _both(graph_to_tm_bytes(g), dict(precision="fp32"), xs, monkeypatch)
    assert cg.kernels == routes
    assert len(got) == len(want) == 1
    _compare(got[0], want[0], CASES[name][4])


@pytest.mark.parametrize("name,conv", QUANT_IDS, ids=_ids(QUANT_IDS))
def test_quantized_lowering_matches_jax(name, conv, monkeypatch):
    g, xs = _inputs(name, conv)
    qg = jax_quantize(g, [xs], scheme="uint8", algorithm="minmax")
    xq = [jq.quantize_np(x, qg.tensors[tid].quant, qg.tensors[tid].dtype)
          for tid, x in zip(qg.input_tensors, xs)]
    want, got, routes, cg = _both(graph_to_tm_bytes(qg), dict(quant_mode="fast"), xq, monkeypatch)
    node = cg.graph.nodes[-1]
    assert cg.kernels == routes and not any(k.quant_aware for k in _kernels(node.op))
    a, b = got[0], want[0]
    assert a.shape == b.shape and a.dtype == b.dtype
    if CASES[name][0] == "RPN":  # a float output (the quantizer's keep-float ops)
        assert a.dtype == np.float32
        _compare(a, b, CASES[name][4])
        return
    assert a.dtype == np.uint8
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _kernels(op):
    from tengine_tpu_torch.ops.registry import _REGISTRY

    return _REGISTRY[op]


def test_generic_raises_naming_the_custom_op_api():
    """A Generic node needs a kernel the caller registers: both engines
    refuse to compile it, naming their register_custom_op."""
    import tengine_tpu as jt

    import tengine_tpu_torch as pt

    g = one_node_graph("Generic", dict(max_input_num=1, max_output_num=1, op_name="MyOp"),
                       (1, 4))
    blob = graph_to_tm_bytes(g)
    with pytest.raises(NotImplementedError, match="tengine_tpu.register_custom_op"):
        jt.compile_graph(jt.load_tm_bytes(blob), jt.Options())
    with pytest.raises(NotImplementedError, match="'MyOp'.*tengine_tpu_torch.register_custom_op"):
        pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(), device="cpu")
    # with a kernel registered, the node runs
    unregister = pt.register_custom_op("Generic", lambda ctx, x: x)
    try:
        out = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(), device="cpu").run(
            np.ones((1, 4), np.float32))
        np.testing.assert_array_equal(out[0], np.ones((1, 4), np.float32))
    finally:
        unregister()


@pytest.mark.parametrize("th,tw", [(5, 7), (7, 13), (24, 24), (33, 100), (1, 2)])
def test_affine_grid_is_jax_linspace(th, tw):
    """The SpatialTransformer grid, a compile-time param in the port, equals
    jnp.linspace(-1, 1, n) as the JAX lowering's compiled forward computes
    it (the division by n - 1 a reciprocal multiply there); eager
    jnp.linspace and np.linspace round otherwise."""
    import jax
    import jax.numpy as jnp

    from tengine_tpu_torch.ops.lowering_extra import _affine_grid

    def jax_grid(z):
        gy, gx = jnp.meshgrid(jnp.linspace(-1.0, 1.0, th), jnp.linspace(-1.0, 1.0, tw),
                              indexing="ij")
        return z + jnp.stack([gx.reshape(-1), gy.reshape(-1), jnp.ones(th * tw)], axis=0)

    want = np.asarray(jax.jit(jax_grid)(np.zeros((3, th * tw), np.float32)))
    np.testing.assert_array_equal(_affine_grid(th, tw), want)


def test_duplicate_indices(monkeypatch):
    """Scatter and SparseToDense with an index given twice: which update
    lands is unspecified in both engines (XLA's scatter and torch's
    scatter alike). Here, on the CPU, both take the later update; the
    other positions are equal bit for bit. On the card torch makes no
    promise either (ROADMAP §3)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    idx = np.array([[1, 2, 0], [1, 0, 0]], np.float32)  # column 0: row 1 twice, column 2: row 0
    upd = rng.standard_normal((2, 3)).astype(np.float32)
    g = one_node_graph("Scatter", dict(axis=0, is_onnx=True), x.shape, extra_inputs=[(2, 3),
                                                                                      (2, 3)])
    want, got, _, _ = _both(graph_to_tm_bytes(g), dict(precision="fp32"), [x, idx, upd],
                            monkeypatch)
    later = x.copy()
    for i in range(2):
        for j in range(3):
            later[int(idx[i, j]), j] = upd[i, j]
    np.testing.assert_array_equal(want[0], later)
    np.testing.assert_array_equal(got[0], later)

    sidx = np.array([2, 5, 2, 7, 5], np.float32)
    vals = rng.standard_normal(5).astype(np.float32)
    g = one_node_graph("SparseToDense", dict(output_shape_size0=8, output_shape_size1=0,
                                             default_value=0), sidx.shape,
                       consts=(np.array([8], np.int32),), extra_inputs=[vals.shape])
    want, got, _, _ = _both(graph_to_tm_bytes(g), dict(precision="fp32"), [sidx, vals],
                            monkeypatch)
    dense = np.zeros(8, np.float32)
    for i, v in zip(sidx.astype(int), vals):
        dense[i] = v
    np.testing.assert_array_equal(want[0], dense)
    np.testing.assert_array_equal(got[0], dense)


def test_registry_covers_every_tm2_op():
    """Every TM2 builtin op type has a lowering in the port (the port's
    mirror of tests/test_op_coverage.py), and the port registers every op
    type the JAX package does (106)."""
    import tengine_tpu.executor.engine  # noqa: F401 — populate the registry
    from tengine_tpu.ops.registry import registered_ops as jax_ops

    import tengine_tpu_torch.executor.engine  # noqa: F401
    from tengine_tpu_torch.ops.registry import registered_ops
    from tengine_tpu_torch.serializer.tm2.format import OP_TYPE_TO_NAME

    missing = sorted(set(OP_TYPE_TO_NAME.values()) - set(registered_ops()) - {"Const", "InputOp"})
    assert missing == [], f"ops without lowerings: {missing}"
    assert set(jax_ops()) <= set(registered_ops()), sorted(set(jax_ops()) - set(registered_ops()))


def test_param_writers_cover_param_parsers():
    """Every op the port's reader parses params for, its writer writes."""
    from tengine_tpu_torch.serializer.tm2.reader import PARAM_PARSERS
    from tengine_tpu_torch.serializer.tm2.writer import PARAM_WRITERS

    missing = sorted(set(PARAM_PARSERS) - set(PARAM_WRITERS))
    assert missing == [], f"param writers missing: {missing}"
