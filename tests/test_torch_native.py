"""The PyTorch port's host layer against the JAX package's, on the CPU:
native/ (improc.cc, postproc.cc, tm2_parser.cc and their ctypes wrappers),
the TM2 reader's native path, and utils/data.py's loader.

Tolerances, and why: the port builds the JAX package's C++ sources with its
g++ flags, so every native function is bit-equal to the JAX package's; the
numpy versions are the JAX fallbacks' code, bit-equal to them; native
against numpy within the JAX tests' bounds (the bilinear resize rounds
float32 sums in C++ and float64 ones in numpy: 1 LSB; NMS equal, apart
from the documented parting on boxes with a union of at most 1e-9). The
native parser's wire bytes equal the JAX parser's, and its graph equals the
pure-Python parse under tests/test_native.py's _graphs_equal rules; the
tmfiles are written in code (yolov5s and mobilenet-SSD at img 64,
RetinaFace mnet0.25, the quantized conv graph of tests/test_quantize.py).
The loader's batches equal the JAX loader's byte for byte.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu.native as jnative  # noqa: E402
from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes as jax_bytes  # noqa: E402

import tengine_tpu_torch.native as pnative  # noqa: E402
import tengine_tpu_torch.serializer.tm2.reader as preader  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph  # noqa: E402
from tengine_tpu_torch.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

from test_native import _graphs_equal  # noqa: E402
from test_quantize import make_quant_conv_graph  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import build_mobilenet_ssd_graph, build_retinaface_mnet_graph  # noqa: E402

THREADS = 2  # tt_preprocess_batch's pool beside the workers' torch threads
SSD_SMALL = dict(img=64, widths=(32, 32, 64, 64, 64, 64, 96, 96, 96, 96, 96, 96, 128, 128),
                 extras=((128, 64), (128, 64), (32, 64), (32, 32)))


@pytest.fixture()
def plain(monkeypatch):
    """Both packages on their numpy versions."""
    for mod in (jnative, pnative):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)


def _images(rng, sizes=((40, 50), (64, 64), (31, 77), (480, 640))):
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8) for h, w in sizes]


def _calls(rng):
    """(name, fn(native module)) over the image functions at several shapes."""
    images = _images(rng)
    mean, scale = [104.0, 117.0, 123.0], [0.017, 0.017, 0.017]
    x = (rng.standard_normal(1000) * 3).astype(np.float32)
    calls = []
    for i, im in enumerate(images):
        for oh, ow in ((24, 24), (32, 17), (640, 640)):
            calls.append((f"resize{i}-{oh}x{ow}", lambda m, im=im, oh=oh, ow=ow:
                          m.resize_bilinear(im, oh, ow)))
            calls.append((f"letterbox{i}-{oh}x{ow}", lambda m, im=im, oh=oh, ow=ow:
                          m.letterbox(im, oh, ow, pad_value=114)))
        calls.append((f"normalize{i}", lambda m, im=im: m.normalize_chw(im, mean, scale)))
    calls.append(("quantize", lambda m: m.quantize_u8(x, 0.05, 128)))
    calls.append(("batch-f32", lambda m: m.preprocess_batch(images, 32, 48, mean, scale,
                                                            n_threads=THREADS)))
    calls.append(("batch-u8", lambda m: m.preprocess_batch(images, 32, 48, mean, scale,
                                                           quant=(0.02, 110), n_threads=THREADS)))
    return calls


def _boxes(rng, n=300):
    boxes = rng.uniform(0, 100, (n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(1, 40, (n, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[::7] = scores[0]  # ties: the stable order decides
    return boxes, scores


def test_native_builds_into_the_repo():
    assert pnative.available(), "g++ is in the image; the native build should work"
    path = pnative.library_path()
    assert path.exists() and path.parent == Path(__file__).resolve().parents[1] / "build" / "native"


def test_image_functions_equal_the_jax_native(rng):
    assert jnative.available() and pnative.available()
    for name, fn in _calls(rng):
        a, b = fn(pnative), fn(jnative)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


def test_numpy_versions_equal_the_jax_fallbacks(rng, plain):
    for name, fn in _calls(rng):
        a, b = fn(pnative), fn(jnative)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    boxes, scores = _boxes(rng)
    for thr, max_out in ((0.45, 0), (0.3, 10), (0.7, 1000)):
        assert np.array_equal(pnative.nms(boxes, scores, thr, max_out),
                              jnative.nms(boxes, scores, thr, max_out))


def test_native_within_the_jax_bounds_of_numpy(rng, monkeypatch):
    """The JAX tests' bounds: resize within 1 LSB, so the batch
    preprocessor within one resize LSB times the scale (fp32) and 1 LSB
    (uint8: 0.017 / 0.02 of an LSB before rounding), NMS equal."""
    mean, scale = [104.0, 117.0, 123.0], [0.017, 0.017, 0.017]
    images = _images(rng)
    boxes, scores = _boxes(rng)
    native = [pnative.resize_bilinear(im, 24, 31) for im in images]
    batch = pnative.preprocess_batch(images, 32, 32, mean, scale, n_threads=THREADS)
    batch_q = pnative.preprocess_batch(images, 32, 32, mean, scale, quant=(0.02, 110),
                                       n_threads=THREADS)
    keep = pnative.nms(boxes, scores, 0.45)
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "_TRIED", True)
    for a, im in zip(native, images):
        assert np.abs(a.astype(int) - pnative.resize_bilinear(im, 24, 31).astype(int)).max() <= 1
    d = np.abs(batch - pnative.preprocess_batch(images, 32, 32, mean, scale))
    assert d.max() <= 0.017 * (1 + 1e-4)  # plus the f32 rounding of (v - mean) * scale
    q = pnative.preprocess_batch(images, 32, 32, mean, scale, quant=(0.02, 110))
    assert np.abs(batch_q.astype(int) - q.astype(int)).max() <= 1
    assert np.array_equal(keep, pnative.nms(boxes, scores, 0.45))


def test_nms_parting_on_degenerate_boxes(plain):
    """Two equal boxes with a union of 5e-10 (<= 1e-9): numpy divides by
    max(union, 1e-9) and finds IoU 0.5 > 0.45, so it suppresses the second;
    postproc.cc takes the IoU as 0 and keeps both. The port keeps each side
    as the JAX package has it (ROADMAP §3)."""
    boxes = np.array([[0, 0, 1e-5, 5e-5]] * 2, np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    numpy_keep = pnative.nms(boxes, scores, 0.45)
    assert np.array_equal(numpy_keep, jnative.nms(boxes, scores, 0.45))
    assert numpy_keep.tolist() == [0]


def test_nms_native_on_degenerate_boxes():
    boxes = np.array([[0, 0, 1e-5, 5e-5]] * 2, np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    keep = pnative.nms(boxes, scores, 0.45)
    assert np.array_equal(keep, jnative.nms(boxes, scores, 0.45))
    assert keep.tolist() == [0, 1]


def test_letterbox_bands(rng):
    img = rng.integers(0, 255, (30, 60, 3)).astype(np.uint8)
    out = pnative.letterbox(img, 64, 64, pad_value=114)
    assert out.shape == (64, 64, 3)
    assert (out[:15] == 114).all() and (out[-15:] == 114).all()


def _tmfiles():
    """name -> tmfile bytes, written in code."""
    rng = np.random.default_rng(3)
    torch.manual_seed(0)
    _, y5 = build_yolov5s_graph(num_classes=80, img=64)
    _, qconv, _ = make_quant_conv_graph("int8", rng)
    return {
        "yolov5s-64": lambda: graph_to_tm_bytes(y5),
        "mobilenet-ssd-64": lambda: graph_to_tm_bytes(build_mobilenet_ssd_graph(pir, **SSD_SMALL)),
        "retinaface": lambda: graph_to_tm_bytes(build_retinaface_mnet_graph(pir, h=64, w=48)),
        "quant-conv-int8": lambda: jax_bytes(qconv),
    }


TMFILES = ["yolov5s-64", "mobilenet-ssd-64", "retinaface", "quant-conv-int8"]


@pytest.fixture(scope="module")
def tmfiles():
    return {name: make() for name, make in _tmfiles().items()}


@pytest.mark.parametrize("name", TMFILES)
def test_wire_bytes_equal_the_jax_parser(tmfiles, name):
    wire = pnative.tm2_parse(tmfiles[name])
    assert wire is not None and wire[:4] == b"TTW1"
    assert wire == jnative.tm2_parse(tmfiles[name])


@pytest.mark.parametrize("name", TMFILES)
def test_native_parse_equals_the_python_parse(tmfiles, name, monkeypatch):
    data = tmfiles[name]
    calls = []
    parse = pnative.tm2_parse
    monkeypatch.setattr(pnative, "tm2_parse", lambda d: calls.append(1) or parse(d))
    gn = preader.load_tm_bytes(data, name=name, fill_missing_weights="random")
    assert calls, "load_tm_bytes did not take the native parser"
    gp = preader.load_tm_bytes_py(data, name=name, fill_missing_weights="random")
    _graphs_equal(gp, gn)
    if name == "mobilenet-ssd-64":  # PriorBox's vector params came through the wire
        prior = [n for n in gn.nodes if n.op == "PriorBox"]
        assert len(prior) == 6 and all(isinstance(n.params["min_sizes"], list) for n in prior)


def test_stripped_weights_fill_as_the_python_parse():
    """A buffer with offset 0 (a weight-stripped tmfile) fills from the same
    seeded stream in both parses."""
    g = pir.Graph(name="stripped")
    x = g.add_tensor("x", pir.DType.FP32, [1, 3, 8, 8], pir.TensorType.INPUT)
    w = g.add_tensor("w", pir.DType.FP32, [4, 3, 1, 1], pir.TensorType.CONST,
                     data=np.ones((4, 3, 1, 1), np.float32))
    y = g.add_tensor("y", pir.DType.FP32, [1, 4, 8, 8])
    g.add_node("InputOp", "in", [], [x.idx])
    g.add_node("Convolution", "conv", [x.idx, w.idx], [y.idx], params=dict(
        kernel_h=1, kernel_w=1, stride_h=1, stride_w=1, pad_h0=0, pad_h1=0, pad_w0=0,
        pad_w1=0, dilation_h=1, dilation_w=1, group=1, output_channel=4, input_channel=3,
        activation=-1))
    g.inputs, g.outputs = [0], [1]
    data = bytearray(graph_to_tm_bytes(g))
    # point the weight's buffer record {size 48, offset} at offset 0
    off = bytes(data).index(np.ones(12, np.float32).tobytes())
    rec = bytes(data).index((48).to_bytes(4, "little") + off.to_bytes(4, "little"))
    data[rec + 4:rec + 8] = (0).to_bytes(4, "little")
    for fill in ("zero", "random"):
        gn = preader.load_tm_bytes(bytes(data), fill_missing_weights=fill)
        gp = preader.load_tm_bytes_py(bytes(data), fill_missing_weights=fill)
        _graphs_equal(gp, gn)
        assert (gn.tensors[1].data != 0).all() == (fill == "random")


def test_native_parser_rejects_malformed(tmfiles):
    data = tmfiles["yolov5s-64"]
    with pytest.raises(ValueError):
        pnative.tm2_parse(data[: len(data) // 3])
    bad = bytearray(data)
    bad[8:12] = (0xFFFFFFF0).to_bytes(4, "little")  # root offset past the end
    with pytest.raises(ValueError):
        pnative.tm2_parse(bytes(bad))
    with pytest.raises(ValueError):
        pnative.tm2_parse(b"\x07\x00bogus")
    with pytest.raises(ValueError):
        preader.load_tm_bytes(data[: len(data) // 2])


def test_tm2_parser_env_selects_the_python_parse(tmfiles, monkeypatch):
    def refuse(_):
        raise AssertionError("the native parser ran under TT_NATIVE_PARSER=0")

    monkeypatch.setattr(pnative, "tm2_parse", refuse)
    monkeypatch.setenv("TT_NATIVE_PARSER", "0")
    g = preader.load_tm_bytes(tmfiles["quant-conv-int8"])
    _graphs_equal(preader.load_tm_bytes_py(tmfiles["quant-conv-int8"]), g)


def test_tm2_scan_lists_the_consts(tmfiles):
    data = tmfiles["retinaface"]
    table = pnative.tm2_scan_buffers(data)
    assert np.array_equal(table, jnative.tm2_scan_buffers(data))
    g = preader.load_tm_bytes(data)
    consts = [t.idx for t in g.tensors if t.tensor_type == pir.TensorType.CONST]
    assert sorted(int(r[0]) for r in table) == sorted(consts)


def test_library_name_follows_sources_and_flags(tmp_path, monkeypatch):
    for src in pnative.SOURCES:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    names = {"start": pnative.library_path()}
    monkeypatch.setattr(pnative, "SOURCES", tuple(tmp_path / s.name for s in pnative.SOURCES))
    assert pnative.library_path() == names["start"]  # the digest reads bytes, not paths
    with open(tmp_path / "postproc.cc", "ab") as f:
        f.write(b"// edited\n")
    names["source edited"] = pnative.library_path()
    monkeypatch.setattr(pnative, "CXX_FLAGS", pnative.CXX_FLAGS + ("-g",))
    names["flag added"] = pnative.library_path()
    assert len(set(names.values())) == len(names), names
    assert all(p.parent == pnative.BUILD_DIR and p.name.startswith("libtengine_native-")
               for p in names.values())


def test_numpy_version_logs_a_warning(monkeypatch, caplog, rng):
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "_TRIED", True)
    monkeypatch.setattr(pnative, "_WARNED", set())
    import logging

    logger = logging.getLogger("tengine_tpu_torch")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger="tengine_tpu_torch"):
        pnative.resize_bilinear(rng.integers(0, 255, (8, 8, 3)).astype(np.uint8), 4, 4)
    assert any(r.levelno == logging.WARNING and "resize_bilinear" in r.getMessage()
               for r in caplog.records)


def _write_pngs(tmp_path, rng, n=5):
    Image = pytest.importorskip("PIL.Image")
    for i in range(n):
        arr = rng.integers(0, 255, (48 + i, 40 + 3 * i, 3)).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")


@pytest.mark.parametrize("quant", [None, (0.02, 110)])
def test_image_loader_equals_the_jax_loader(tmp_path, rng, quant):
    _write_pngs(tmp_path, rng)
    from tengine_tpu.utils import data as jdata

    from tengine_tpu_torch.utils import data as pdata

    paths = pdata.list_images(str(tmp_path))
    assert paths == jdata.list_images(str(tmp_path)) and len(paths) == 5
    kw = dict(batch_size=2, mean=(104.0, 117.0, 123.0), scale=(0.017,) * 3, quant=quant,
              decode_threads=2)
    ours = list(pdata.ImageBatchLoader(paths, (32, 24), **kw))
    theirs = list(jdata.ImageBatchLoader(paths, (32, 24), **kw))
    assert len(ours) == len(theirs) == len(pdata.ImageBatchLoader(paths, (32, 24), **kw)) == 3
    for (a, pa), (b, pb) in zip(ours, theirs):
        assert pa == pb and a.dtype == b.dtype and np.array_equal(a, b)
    assert [p for _, chunk in ours for p in chunk] == paths
    dropped = list(pdata.ImageBatchLoader(paths, (32, 24), drop_last=True, **kw))
    assert [len(c) for _, c in dropped] == [2, 2]
    one = pdata.load_image_batch(paths, (32, 24), kw["mean"], kw["scale"], quant=quant)
    assert np.array_equal(one, jdata.load_image_batch(paths, (32, 24), kw["mean"], kw["scale"],
                                                      quant=quant))
    assert np.array_equal(one, np.concatenate([a for a, _ in ours]))
