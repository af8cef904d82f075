"""The PyTorch port's detector zoo (models/detect_zoo.py, detect_zoo2.py,
detect_zoo3.py, the rest of darknet_zoo.py, zoo.py) against the JAX
package's, on the CPU.

Builders: each package builds its graph after the same torch.manual_seed
(the torch modules draw their weights from it), at img 64; the two graphs
are equal field for field (tests/test_torch_yolov5.py's assert_ir_equal)
and the two writers' TM2 bytes are equal. fp32: the port's engine against
the builder's torch module at tests/test_detect_zoo.py's bounds (rtol 1e-3,
atol 1e-4). Decoders: the same numpy code in both packages, so equal
outputs, on the port's fp32 outputs and on seeded maps of their shapes.
zoo.py: the table equal to the JAX table; a tmfile in the benchmark
layout loads with the table's input shape.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
import tengine_tpu.models.darknet_zoo as jdark  # noqa: E402
import tengine_tpu.models.detect_zoo as jz1  # noqa: E402
import tengine_tpu.models.detect_zoo2 as jz2  # noqa: E402
import tengine_tpu.models.detect_zoo3 as jz3  # noqa: E402
import tengine_tpu.models.zoo as jzoo  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes as jax_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
import tengine_tpu_torch.models.darknet_zoo as pdark  # noqa: E402
import tengine_tpu_torch.models.detect_zoo as pz1  # noqa: E402
import tengine_tpu_torch.models.detect_zoo2 as pz2  # noqa: E402
import tengine_tpu_torch.models.detect_zoo3 as pz3  # noqa: E402
import tengine_tpu_torch.models.zoo as pzoo  # noqa: E402
from tengine_tpu_torch.ops import qmath  # noqa: E402
from tengine_tpu_torch.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

from test_torch_yolov5 import assert_ir_equal  # noqa: E402

IMG = 64
MODULES = {1: (jz1, pz1), 2: (jz2, pz2), 3: (jz3, pz3)}
# name -> (module number, builder, its arguments at the tests' size)
NETS = {
    "fastpose": (1, "build_fastpose_graph", dict(img_h=IMG, img_w=48)),
    "nanodet": (1, "build_nanodet_graph", dict(img=IMG)),
    "ultraface": (1, "build_ultraface_graph", dict(img_h=IMG, img_w=IMG)),
    "hrnet": (1, "build_hrnet_graph", dict(img=IMG)),
    "yolact": (1, "build_yolact_graph", dict(img=IMG)),
    "openpose": (1, "build_openpose_graph", dict(img=IMG)),
    "efficientdet": (1, "build_efficientdet_graph", dict(img=IMG)),
    "landmark": (1, "build_landmark_graph", dict(img=IMG)),
    "yolox": (2, "build_yolox_graph", dict(img=IMG, width=16)),
    "scrfd": (2, "build_scrfd_graph", dict(img=IMG, width=8)),
    "movenet": (2, "build_movenet_graph", dict(img=IMG, width=8)),
    "nanodet_plus": (3, "build_nanodet_plus_graph", dict(num_classes=8, img=IMG, width=16)),
    "picodet": (3, "build_picodet_graph", dict(num_classes=8, img=IMG, width=16)),
}


def build(name, package):
    """(torch module, graph) of `name` from package 0 (JAX) or 1 (port)."""
    m, fn, kw = NETS[name]
    torch.manual_seed(0)
    return getattr(MODULES[m][package], fn)(**kw)


def _yolo_params(g):
    return [n.params for n in g.nodes if n.op == "Dropout" and "classes" in n.params]


# name -> decode(zoo module, outputs) for the nets with a host decoder
DECODERS = {
    "fastpose": lambda z, o: z.decode_pose_heatmaps(o[0]),
    "hrnet": lambda z, o: z.decode_pose_heatmaps(o[0]),
    "nanodet": lambda z, o: z.decode_nanodet(o, score_threshold=0.0),
    "ultraface": lambda z, o: z.decode_ultraface(*z.flatten_ultraface(o),
                                                 z.ultraface_priors(IMG, IMG),
                                                 score_threshold=0.0),
    "yolact": lambda z, o: z.assemble_yolact_masks(
        o[0][0], np.random.default_rng(1).standard_normal((5, o[0].shape[1])).astype(np.float32)),
    "yolox": lambda z, o: z.decode_yolox(o, score_threshold=0.0),
    "scrfd": lambda z, o: z.decode_scrfd(o, IMG, score_threshold=0.0),
    "movenet": lambda z, o: z.decode_movenet(*o, img=IMG),
    "nanodet_plus": lambda z, o: z.decode_nanodet_plus(o[0], IMG, num_classes=8,
                                                       score_threshold=0.0),
    "picodet": lambda z, o: z.decode_picodet(o, IMG, num_classes=8, score_threshold=0.0),
}


@pytest.mark.parametrize("name", list(NETS))
def test_builders_build_the_jax_ir(name):
    """The same IR in both packages, and the JAX writer's tmfile bytes but
    for the split sums' fused activations (YOLOX's, PicoDet's): the port's
    writer records those in the node's attribute list, the TM2 Eltwise
    record having no field for them (ROADMAP §3). With them dropped the
    bytes are equal; the port's bytes read back with them."""
    _, jg = build(name, 0)
    _, pg = build(name, 1)
    assert_ir_equal(jg, pg)
    acts = {n.name: n.params["activation"] for n in pg.nodes
            if n.op == "Eltwise" and n.params.get("activation", -1) >= 0}
    data = graph_to_tm_bytes(pg)
    back = pt.load_tm_bytes(data)
    assert {n.name: n.params.get("activation") for n in back.nodes if n.name in acts} == acts
    for n in pg.nodes:
        if n.name in acts:
            del n.params["activation"]
    assert graph_to_tm_bytes(pg) == jax_bytes(jg)
    assert (data == jax_bytes(jg)) == (not acts)


def test_yolov4_tiny_builds_the_jax_ir():
    jg, pg = jdark.build_yolov4_tiny_graph(img=IMG), pdark.build_yolov4_tiny_graph(img=IMG)
    assert_ir_equal(jg, pg)
    assert graph_to_tm_bytes(pg) == jax_bytes(jg)
    assert [p["mask"] for p in _yolo_params(pg)] == [[3, 4, 5], [1, 2, 3]]
    assert pdark.YOLOV4_TINY_CFG == jdark.YOLOV4_TINY_CFG


def _as_outputs(out, outs):
    """The module's outputs as a list of arrays in the graph's output shapes."""
    exp = out if isinstance(out, tuple) else (out,)
    return [e.numpy().reshape(o.shape) for e, o in zip(exp, outs, strict=True)]


def _seeded_like(outs, seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(o.shape) * 3).astype(np.float32) for o in outs]


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", list(NETS))
def test_fp32_matches_the_module_and_decoders_equal_jax(name):
    m, g = build(name, 1)
    shape = g.tensors[g.input_tensors[0]].shape
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    outs = pt.compile_graph(g, pt.Options(precision="fp32"), device="cpu").run(x)
    with torch.no_grad():
        want = _as_outputs(m(torch.from_numpy(x)), outs)
    for a, b in zip(outs, want):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    if name not in DECODERS:
        return
    zj, zp = MODULES[NETS[name][0]]
    for maps in (outs, _seeded_like(outs)):
        got = DECODERS[name](zp, maps)
        _equal(got, DECODERS[name](zj, maps))
    if name in ("nanodet", "yolox", "scrfd", "nanodet_plus", "picodet"):
        dets = got[0] if isinstance(got, tuple) else got
        assert len(dets) > 0 and np.isfinite(dets).all()


def test_scrfd_anchor_centers_equal_jax():
    for h, w, stride in ((8, 8, 8), (5, 7, 16), (2, 2, 32)):
        _equal(pz2.scrfd_anchor_centers(h, w, stride), jz2.scrfd_anchor_centers(h, w, stride))
    # at a size whose maps are whole multiples of the strides: at 240x320
    # the port counts ceil(size / stride) cells where JAX counts floor
    # (tests/test_torch_examples2.py::test_ultraface_priors_fall_short_at_the_default_size)
    _equal(pz1.ultraface_priors(256, 320), jz1.ultraface_priors(256, 320))


def test_yolov4_tiny_decode_equals_jax():
    g = pdark.build_yolov4_tiny_graph(img=IMG)
    x = np.random.default_rng(0).standard_normal((1, 3, IMG, IMG)).astype(np.float32)
    outs = pt.compile_graph(g, pt.Options(precision="fp32"), device="cpu").run(x)
    assert [o.shape[-1] for o in outs] == [IMG // 32, IMG // 16]
    params = _yolo_params(g)
    for maps in (outs, _seeded_like(outs)):
        for thr in (0.0, 0.3):
            got = pdark.decode_darknet_yolo(maps, params, IMG, thr)
            _equal(got, jdark.decode_darknet_yolo(maps, params, IMG, thr))
    assert got.shape[1] == 6


def test_yolox_int8_bias_saturation_is_shared():
    """A fault of the reference not copied (ROADMAP §3). The seeded YOLOX's
    activations shrink through its SiLU stacks to scales of 1e-9 to 1e-11
    at the heads, where a head's float bias over s_in * s_w no longer fits
    int32: the JAX quantizer saturates it at +-(2^31 - 1), and the JAX
    engine then gives the two coarser heads all zero. The port's quantizer
    raises such a channel's weight scale until its bias lands at 2^30
    (quantizer.fit_bias): no bias at the bound; every channel whose bias
    JAX did not saturate keeps its weight scale and its bias (within the
    relative 1e-5 that the two calibrations' activation scales part by,
    tests/test_torch_transformer.py); and every head's dequantized cosine
    against the fp32 engine is above 0.99."""
    _, jg = build("yolox", 0)
    _, pg = build("yolox", 1)
    x = np.random.default_rng(0).standard_normal((1, 3, IMG, IMG)).astype(np.float32)
    qg = pt.quantize_graph(pg, [x], scheme="int8", algorithm="minmax", device="cpu")
    jqg = jax_quantize(jg, [x], scheme="int8", algorithm="minmax")
    top = 2**31 - 1
    saturated = []
    for n in qg.nodes:
        if n.op == "Convolution" and len(n.inputs) > 2:
            b = qg.tensors[n.inputs[2]].data.astype(np.int64)
            (jn,) = [j for j in jqg.nodes if j.name == n.name]
            jb = jqg.tensors[jn.inputs[2]].data.astype(np.int64)
            s_w, js_w = (np.asarray(g.tensors[m.inputs[1]].quant.scales)
                         for g, m in ((qg, n), (jqg, jn)))
            assert (np.abs(b) < top).all(), n.name
            kept = np.abs(jb) < top
            np.testing.assert_allclose(b[kept], jb[kept], rtol=1e-5, atol=1)
            np.testing.assert_array_equal(s_w[kept], js_w[kept])
            if not kept.all():
                saturated.append(n.name)
                assert (s_w[~kept] > js_w[~kept]).all()
                np.testing.assert_allclose(np.abs(b[~kept]), 2**30, rtol=1e-5)
    assert {"heads/1/reg_pred", "heads/2/cls_pred"} <= set(saturated)
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
    got = pt.compile_graph(qg, pt.Options(quant_mode="fast"), device="cpu").run(xq)
    want = jt.compile_graph(jqg, jt.Options(quant_mode="fast")).run(xq)
    assert not np.asarray(want[1]).any() and not np.asarray(want[2]).any()
    fp32 = pt.compile_graph(pg, pt.Options(precision="fp32"), device="cpu").run(x)
    for t_id, q, f in zip(qg.output_tensors, got, fp32, strict=True):
        d = qmath.dequantize_np(q, qg.tensors[t_id].quant).ravel().astype(np.float64)
        cos = d @ f.ravel() / (np.linalg.norm(d) * np.linalg.norm(f) + 1e-30)
        assert cos > 0.99, (qg.tensors[t_id].name, cos)


def test_zoo_table_equals_jax():
    assert pzoo.BENCHMARK_MODELS == jzoo.BENCHMARK_MODELS
    assert pzoo.benchmark_model_names() == jzoo.benchmark_model_names()


def test_zoo_missing_model_raises_as_jax(tmp_path):
    missing = str(tmp_path / "absent")
    with pytest.raises(FileNotFoundError) as pe:
        pzoo.load_benchmark_model("mobilenetv1", model_dir=missing)
    with pytest.raises(FileNotFoundError) as je:
        jzoo.load_benchmark_model("mobilenetv1", model_dir=missing)
    assert str(pe.value) == str(je.value)
    with pytest.raises(KeyError):
        pzoo.load_benchmark_model("no-such-net", model_dir=missing)


def test_zoo_sets_the_table_input_shape(tmp_path):
    """A tmfile in the benchmark layout whose input has no shape gets the
    table's (tm_benchmark's set_tensor_shape), with the batch override."""
    torch.manual_seed(0)
    _, g = pz1.build_landmark_graph(img=IMG)
    g.tensors[g.input_tensors[0]].shape = []
    fname = pzoo.BENCHMARK_MODELS["retinaface"][0]
    (tmp_path / fname).write_bytes(graph_to_tm_bytes(g))
    for batch, want in ((None, [1, 3, 320, 240]), (4, [4, 3, 320, 240])):
        pg = pzoo.load_benchmark_model("retinaface", model_dir=str(tmp_path), batch=batch)
        jg = jzoo.load_benchmark_model("retinaface", model_dir=str(tmp_path), batch=batch)
        assert pg.tensors[pg.input_tensors[0]].shape == want
        assert_ir_equal(jg, pg)
