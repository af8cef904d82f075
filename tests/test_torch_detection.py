"""The PyTorch port's ops/detection.py (PriorBox, DetectionOutput with the
padded greedy NMS, Region) against the JAX package, on the CPU.

The JAX DetectionOutput is at fault at batch > 1: it flattens the batch's
priors and locations into one set (tengine_tpu/ops/detection.py:104-106
with :171), so image 0's priors read image 1's variances as boxes and every
image's boxes go into one NMS, one [1, keep_top_k, 6] block for the batch.
The port computes each image on its own ([N, keep_top_k, 6]), so its rows at
batch N are held to the JAX engine's rows at batch 1, image by image;
test_jax_batch_fault_is_not_copied shows the fault.

Tolerances, and why: priors are the same numpy code, equal bit for bit.
Detection rows: labels and scores equal (the scores are the inputs' values,
selected), boxes within 1e-5 (exp and the decode's multiply-adds: XLA:CPU
contracts them into fused multiply-adds and its exp differs from torch's by
ulps). The sorts put the lower index first among equal scores in both
engines (lax.top_k's order; the port sorts stably), so tied inputs give the
same rows. Region: within rtol 2e-6 (sigmoid, exp and sum round apart).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.graph.ir import DType, Graph, TensorType  # noqa: E402
from tengine_tpu.ops import detection as jdet  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.ops import detection as pdet  # noqa: E402

from test_torch_compiled import run_without_host_transfer  # noqa: E402

SSD_MAPS = [  # (feat, min_size, max_size, aspect ratios) of mobilenet-SSD at 300
    (19, 60, None, [2.0]), (10, 105, 150, [2.0, 3.0]), (5, 150, 195, [2.0, 3.0]),
    (3, 195, 240, [2.0, 3.0]), (2, 240, 285, [2.0, 3.0]), (1, 285, 300, [2.0, 3.0]),
]


def prior_params(min_size, max_size, ratios, **kw):
    return dict(dict(min_sizes=[float(min_size)], max_sizes=[float(max_size)] if max_size else [],
                     variances=[0.1, 0.1, 0.2, 0.2], aspect_ratios=ratios, flip=1, clip=0,
                     img_size=0, img_h=0, img_w=0, step_w=0.0, step_h=0.0, offset=0.5,
                     num_priors=0, out_dim=0), **kw)


def test_compute_priorbox_equals_jax():
    """The six maps of mobilenet-SSD at 300 (1,917 priors), then a
    non-square input, where the flip branch's x normalized by image_h
    differs from y by image_w, with clip, fixed steps and two min sizes."""
    total = 0
    for feat, mn, mx, ars in SSD_MAPS:
        p = prior_params(mn, mx, ars)
        got = pdet.compute_priorbox(feat, feat, 300, 300, p)
        np.testing.assert_array_equal(got, jdet.compute_priorbox(feat, feat, 300, 300, p))
        total += got.shape[1] // 4
    assert total == 1917
    for p in (prior_params(30, 60, [2.0, 3.0]),
              prior_params(30, None, [2.0], clip=1, step_w=16.0, step_h=24.0, offset=0.25),
              dict(prior_params(20, None, [0.5], img_h=200, img_w=320),
                   min_sizes=[20.0, 40.0])):
        got = pdet.compute_priorbox(7, 11, 200, 320, p)
        np.testing.assert_array_equal(got, jdet.compute_priorbox(7, 11, 200, 320, p))


def _graph(op, params, in_shapes, n_outputs=1):
    g = Graph(name=f"{op}_one_node")
    ins, nodes = [], []
    for i, s in enumerate(in_shapes):
        t = g.add_tensor(f"in{i}", DType.FP32, list(s), TensorType.INPUT)
        nodes.append(g.add_node("InputOp", f"input{i}", [], [t.idx]).idx)
        ins.append(t.idx)
    outs = [g.add_tensor(f"out{i}", DType.FP32, [], TensorType.VAR).idx for i in range(n_outputs)]
    g.add_node(op, op.lower(), ins, outs, params)
    g.inputs, g.outputs = nodes, [g.nodes[-1].idx]
    return graph_to_tm_bytes(g)


def test_priorbox_lowering_equals_jax():
    """A one-node PriorBox at batch 2: the priors of the compiled size,
    [N, 2, out_dim, 1], equal to the JAX engine's."""
    p = prior_params(105, 150, [2.0, 3.0])
    blob = _graph("PriorBox", p, [(2, 8, 10, 10), (2, 3, 300, 300)])
    xs = [np.zeros((2, 8, 10, 10), np.float32), np.zeros((2, 3, 300, 300), np.float32)]
    want = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options()).run(*xs)[0]
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(), device="cpu")
    (got,) = run_without_host_transfer(cg, *xs)
    assert got.shape == (2, 2, 10 * 10 * 6 * 4, 1)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_top_k_keeps_lax_order_among_ties():
    """The stable sort the port uses for lax.top_k: values and indices equal
    on rows full of ties (few distinct values, as a dequantized UINT8
    softmax has)."""
    rng = np.random.default_rng(0)
    scores = (rng.integers(0, 6, (4, 300)) / 5).astype(np.float32)
    values, order = pdet._top_k(torch.from_numpy(scores), 100)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 100)
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_i))


def _boxes(rng, n):
    c = rng.uniform(0.1, 0.9, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


def test_padded_nms_equals_jax():
    """Keep mask and order equal to the JAX padded_nms on each of a batch of
    candidate sets with tied scores, the port running them batched."""
    rng = np.random.default_rng(1)
    boxes = np.stack([_boxes(rng, 60) for _ in range(3)])
    scores = (rng.integers(0, 8, (3, 60)) / 7).astype(np.float32)
    keep, order = pdet.padded_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 40)
    for b in range(3):
        wk, wo = jdet.padded_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.45, 40)
        np.testing.assert_array_equal(order[b].numpy(), np.asarray(wo))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(wk))
    iou = pdet._iou_matrix(torch.from_numpy(boxes[0])).numpy()
    np.testing.assert_allclose(iou, np.asarray(jdet._iou_matrix(jnp.asarray(boxes[0]))),
                               rtol=1e-6, atol=1e-7)


def detection_inputs(n, num_prior, classes, seed, levels=None):
    """loc [n, P*4], conf [n, P*C] and priors [n, 2, P*4, 1] (the same
    priors for every image, as PriorBox gives them). levels: the conf
    values come from that many equally spaced levels in [0, 1], so scores
    tie (a dequantized UINT8 softmax has at most 256)."""
    rng = np.random.default_rng(seed)
    loc = (rng.standard_normal((n, num_prior * 4)) * 0.5).astype(np.float32)
    if levels:
        conf = (rng.integers(0, levels, (n, num_prior * classes)) / (levels - 1))
    else:
        conf = rng.dirichlet(np.full(classes, 0.3), (n, num_prior)).reshape(n, -1)
    pb = _boxes(rng, num_prior).reshape(-1)
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), num_prior)
    priors = np.broadcast_to(np.stack([pb, var])[None, :, :, None], (n, 2, num_prior * 4, 1))
    return [loc, conf.astype(np.float32), np.ascontiguousarray(priors, dtype=np.float32)]


DET_PARAMS = dict(num_classes=6, keep_top_k=50, nms_top_k=40, confidence_threshold=0.25,
                  nms_threshold=0.45)


def _det_blob(n, num_prior, params=DET_PARAMS):
    c = params["num_classes"]
    return _graph("DetectionOutput", params,
                  [(n, num_prior * 4), (n, num_prior * c), (n, 2, num_prior * 4, 1)])


def jax_rows(xs, num_prior, params=DET_PARAMS):
    """The JAX engine's rows, at the batch of xs."""
    blob = _det_blob(xs[0].shape[0], num_prior, params)
    return np.asarray(jt.compile_graph(jt.load_tm_bytes(blob), jt.Options()).run(*xs)[0])


def port_rows(xs, num_prior, params=DET_PARAMS):
    blob = _det_blob(xs[0].shape[0], num_prior, params)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(), device="cpu")
    (rows,) = run_without_host_transfer(cg, *xs)
    return rows


def assert_rows_equal(got, want):
    """Labels and scores equal, boxes within 1e-5, pad rows -1 alike."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("levels", [None, 8, 256], ids=["distinct", "ties8", "ties256"])
def test_detection_output_per_image_equals_jax_at_batch_1(levels):
    """Four images through the port at batch 4, each against the JAX engine
    at batch 1 on that image alone; at least 10 valid rows an image, and
    on the tied inputs the rows' order decided by ties."""
    num_prior = 200
    xs = detection_inputs(4, num_prior, DET_PARAMS["num_classes"], seed=2, levels=levels)
    got = port_rows(xs, num_prior)
    assert got.shape == (4, DET_PARAMS["keep_top_k"], 6)
    for i in range(4):
        want = jax_rows([x[i : i + 1] for x in xs], num_prior)
        assert (want[0, :, 0] >= 0).sum() >= 10
        assert_rows_equal(got[i : i + 1], want)
    if levels:  # equal scores side by side in the output
        valid = got[..., 0] >= 0
        assert (np.diff(got[..., 1], axis=1)[valid[:, 1:]] == 0).any()


def test_detection_output_pads_when_few_pass():
    """Few candidates above the threshold: the valid rows, then -1 rows;
    keep_top_k above (C-1)·nms_top_k takes all of them."""
    num_prior = 50
    params = dict(DET_PARAMS, confidence_threshold=0.9, keep_top_k=400, nms_top_k=30)
    xs = detection_inputs(2, num_prior, params["num_classes"], seed=5)
    got = port_rows(xs, num_prior, params)
    assert got.shape == (2, 150, 6)
    for i in range(2):
        want = jax_rows([x[i : i + 1] for x in xs], num_prior, params)
        assert_rows_equal(got[i : i + 1], want)
        assert 0 < (got[i, :, 0] >= 0).sum() < 150 and (got[i, -1] == -1).all()


def test_jax_batch_fault_is_not_copied():
    """The JAX engine at batch 2 returns one block for the batch, and its
    rows for image 0 are not its rows at batch 1 on image 0 (the priors of
    the two images are read as one array and the boxes of both go into one
    NMS); the port at batch 2 equals the JAX engine at batch 1, image by
    image. This test stands in for the batch-2 comparison that the fault
    makes meaningless."""
    num_prior = 200
    xs = detection_inputs(2, num_prior, DET_PARAMS["num_classes"], seed=3)
    jax_b2 = jax_rows(xs, num_prior)
    jax_b1 = [jax_rows([x[i : i + 1] for x in xs], num_prior) for i in range(2)]
    assert jax_b2.shape == (1, DET_PARAMS["keep_top_k"], 6)
    assert not np.allclose(jax_b2[0, :, 2:], jax_b1[0][0, :, 2:], atol=1e-3)
    got = port_rows(xs, num_prior)
    assert got.shape == (2, DET_PARAMS["keep_top_k"], 6)
    for i in range(2):
        assert_rows_equal(got[i : i + 1], jax_b1[i])


@pytest.mark.parametrize("coords,classes", [(4, 20), (4, 3)])
def test_region_equals_jax(coords, classes):
    num_box = 5
    c = num_box * (coords + 1 + classes)
    params = dict(num_classes=classes, side=13, num_box=num_box, coords=coords,
                  confidence_threshold=0.5, nms_threshold=0.4, biases=[1.0] * 10)
    blob = _graph("Region", params, [(2, c, 13, 13)])
    x = np.random.default_rng(4).standard_normal((2, c, 13, 13)).astype(np.float32) * 3
    want = np.asarray(jt.compile_graph(jt.load_tm_bytes(blob), jt.Options()).run(x)[0])
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(), device="cpu")
    assert cg.kernels["region"] == "lower_region"
    (got,) = run_without_host_transfer(cg, x)
    assert got.shape == want.shape == (2, c, 13, 13)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
