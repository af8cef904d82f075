"""The PyTorch port's TF and TFLite front ends (tengine_tpu_torch/convert/
tf_frontend.py, tflite_frontend.py, _flatbuf.py) on the CPU, against the
JAX package's and against TensorFlow, which here only makes fixtures and
serves as an oracle: the port decodes GraphDefs and flatbuffers itself.

  * The port's GraphDef decode equals tf.compat.v1.GraphDef.ParseFromString
    on the same bytes (node names, ops, inputs, every attr, constants by
    tf.make_ndarray); its make_ndarray keeps tf.make_ndarray's semantics.
  * Its flatbuffer reader equals schema_py_generated's on the same bytes.
  * The JAX tests' fixtures (tests/test_tf_frontend.py,
    tests/test_tflite_frontend.py) import to the JAX writer's tmfile bytes;
    fp32 outputs within 1e-5 of the JAX engine's; the full-int8 TFLite
    fixture within 2 LSB of tf.lite.Interpreter (the JAX test's bound) and
    1 LSB of the JAX engine; quantized by the port (UINT8 MinMax) every node
    within 1 LSB of the JAX engine's.
  * A fault of the reference not copied: both JAX importers emit a source
    Reshape onto the IR's NCHW tensor, so a spatial map is flattened C-H-W
    where TensorFlow flattens H-W-C. On conv -> Reshape -> MatMul / Dense
    the port is within 1e-5 of a TF session and of tf.lite.Interpreter, and
    the JAX imports are off by more than 0.5; a 1x1 map keeps the
    reference's bytes.
  * Per-channel weight zero points, which TFLite files may carry, run on
    the port's fast tier within 1 LSB of its ref tier (the JAX fast tier
    takes them as 0).
  * The port's dw route takes TF-SAME pads (the JAX gate refuses them): the
    full-int8 TFLite mobilenet at batch 32 puts its 13 depthwise convs on
    dw_qconv, each node within 1 LSB of the JAX engine's fast lowering.
  * chip_smoke.py's GraphDef and TFLite encoders at small width run in TF
    and in the Interpreter, each equal to the port's forward.
  * Faults of the reference not copied (ROADMAP §3): the JAX engine clips
    a TFLite int8 grid at -127 where TFLite's spans [-128, 127], and the
    port's import sets QuantParam.full_range, which its tmfile keeps; the
    JAX TF importer raises on Squeeze, which TF-slim's logits tail needs
    (with a Shape), and the port imports both against a TF session; the
    port's flatbuffer reader reads a buffer stored by offset and size after
    the flatbuffer.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from tensorflow.lite.python import schema_py_generated as tfl_schema  # noqa: E402

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.convert.tf_frontend import from_tf_graphdef as jax_from_tf  # noqa: E402
from tengine_tpu.convert.tflite_frontend import from_tflite as jax_from_tflite  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes as jax_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.convert import _flatbuf  # noqa: E402
from tengine_tpu_torch.convert import tf_frontend as ptf  # noqa: E402
from tengine_tpu_torch.convert.tflite_frontend import from_tflite  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402

from test_tf_frontend import build_tf_net  # noqa: E402
from test_tflite_frontend import build_keras_net, tflite_run  # noqa: E402
from test_torch_frontends import assert_quantized_nodes_match_jax  # noqa: E402
from test_torch_yolofastest import jax_run_all, port_run_forced  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

tf1 = tf.compat.v1


def tf_breadth_graph(rng):
    """tests/test_tf_frontend.py:test_tf_breadth_ops's graph."""
    gph = tf1.Graph()
    with gph.as_default():
        x = tf1.placeholder(tf.float32, [1, 4, 4, 2], name="input")
        a = tf.constant((np.abs(rng.standard_normal((1, 4, 4, 2))) + 0.5).astype(np.float32))
        s, d = tf.subtract(x, a), tf.divide(x, a)
        p = tf.pow(tf.abs(x) + 0.5, a)
        mn, mx = tf.minimum(s, d), tf.maximum(s, d)
        add3 = tf.add_n([s, d, p])
        tf.identity(tf.exp(mn) + tf.math.log(tf.abs(mx) + 0.5) + tf.sqrt(tf.abs(add3) + 0.1)
                    + tf.math.rsqrt(tf.abs(add3) + 0.1), name="out")
    return gph


def flatten_graph(rng, hw=6, scale=0.1):
    """conv 3x3 SAME on hw x hw x 3 -> Reshape [1, hw*hw*4] -> MatMul 5
    (weights of std 1 and `scale`), as a frozen GraphDef: the graph that
    shows the flatten-order fault."""
    gph = tf1.Graph()
    with gph.as_default():
        x = tf1.placeholder(tf.float32, [1, hw, hw, 3], name="input")
        w = tf.constant(rng.standard_normal((3, 3, 3, 4)).astype(np.float32))
        c = tf1.nn.conv2d(x, w, strides=[1, 1, 1, 1], padding="SAME")
        r = tf.reshape(c, [1, hw * hw * 4])
        wf = tf.constant((rng.standard_normal((hw * hw * 4, 5)) * scale).astype(np.float32))
        tf1.matmul(r, wf, name="out")
    return gph


def tf_session(gph, out, x_nhwc):
    with tf1.Session(graph=gph) as sess:
        return sess.run(out, {"input:0": x_nhwc})


def nchw(x):
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


# --- the GraphDef decode -------------------------------------------------------


def assert_graphdef_decoded_alike(data: bytes):
    gd = tf1.GraphDef()
    gd.ParseFromString(data)
    nodes = ptf.parse_graphdef(data)
    assert [(n.name, n.op, list(n.input), n.device) for n in gd.node] == [
        (n.name, n.op, n.input, n.device) for n in nodes]
    for a, b in zip(gd.node, nodes):
        assert set(a.attr) == set(b.attr), a.name
        for key, v in a.attr.items():
            w, which = b.attr[key], v.WhichOneof("value")
            assert w.which == which, (a.name, key)
            if which == "tensor":
                want, got = tf.make_ndarray(v.tensor), ptf.make_ndarray(w.tensor)
                assert want.dtype == got.dtype and want.shape == got.shape, (a.name, key)
                np.testing.assert_array_equal(got, want)
            elif which == "shape":
                assert [d.size for d in v.shape.dim] == [d.size for d in w.shape.dim]
                assert v.shape.unknown_rank == w.shape.unknown_rank
            elif which == "list":
                for f in ("s", "i", "f", "b", "type"):
                    assert list(getattr(v.list, f)) == getattr(w.list, f), (a.name, key, f)
                assert [[d.size for d in s.dim] for s in v.list.shape] == [
                    [d.size for d in s.dim] for s in w.list.shape]
            else:
                assert getattr(v, which) == getattr(w, which), (a.name, key)


@functools.lru_cache(maxsize=None)
def tf_graphs():
    rng = np.random.default_rng(0)
    return {"convnet": build_tf_net(rng), "breadth": tf_breadth_graph(rng),
            "flatten": flatten_graph(rng)}


@functools.lru_cache(maxsize=None)
def graphdefs():
    out = {k: g.as_graph_def().SerializeToString() for k, g in tf_graphs().items()}
    out["chip_smoke"] = chip_smoke.encode_tf_graphdef(*chip_smoke_small())[0]["frozen.pb"]
    return out


@pytest.mark.parametrize("case", ["convnet", "breadth", "flatten", "chip_smoke"])
def test_graphdef_decode_equals_tensorflow(case):
    assert_graphdef_decoded_alike(graphdefs()[case])


def test_make_ndarray_keeps_tensorflows_semantics():
    """Splats fill the shape, a short list pads with its last value, an empty
    one gives zeros, tensor_content is little-endian raw bytes; every dtype
    the importer meets, half and bool included."""
    from tensorflow.core.framework import tensor_pb2, tensor_shape_pb2, types_pb2

    def proto(dtype, shape, **vals):
        shp = tensor_shape_pb2.TensorShapeProto(
            dim=[tensor_shape_pb2.TensorShapeProto.Dim(size=d) for d in shape])
        return tensor_pb2.TensorProto(dtype=dtype, tensor_shape=shp, **vals)

    protos = [
        proto(types_pb2.DT_FLOAT, [2, 3], float_val=[1.5]),
        proto(types_pb2.DT_FLOAT, [4], float_val=[1.0, -2.0]),
        proto(types_pb2.DT_FLOAT, [2, 2]),
        proto(types_pb2.DT_INT32, [3], int_val=[7]),
        proto(types_pb2.DT_INT8, [2, 2], int_val=[-3, 4, 5, -128]),
        proto(types_pb2.DT_UINT8, [3], int_val=[255, 0]),
        proto(types_pb2.DT_INT64, [2], int64_val=[-(2**40), 3]),
        proto(types_pb2.DT_DOUBLE, [3], double_val=[0.1]),
        proto(types_pb2.DT_BOOL, [3], bool_val=[True, False]),
        proto(types_pb2.DT_HALF, [2], half_val=[0x3C00, 0xC000]),
        tf.make_tensor_proto(np.arange(12, dtype=np.float32).reshape(3, 4)),
        tf.make_tensor_proto(np.asarray([[1, -2], [3, 2**40]], np.int64)),
        tf.make_tensor_proto(np.asarray([0.25, -1e300], np.float64)),
        tf.make_tensor_proto(np.asarray([1, 2, 3], np.int32), shape=[3]),
        tf.make_tensor_proto(np.asarray([True, False]), shape=[2]),
    ]
    for p in protos:
        want = tf.make_ndarray(p)
        got = ptf.make_ndarray(ptf.TensorProto(memoryview(p.SerializeToString())))
        assert got.dtype == want.dtype and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want)


def test_int64_and_double_constants_are_narrowed_as_const_does():
    """A DT_INT64 and a DT_DOUBLE constant feeding the graph become INT32 and
    FP32 IR tensors in both packages (tf_frontend.py:53-58), to the same
    bytes; a Placeholder with an empty input list is the one graph input."""
    gd = tf1.GraphDef()
    n = gd.node.add(name="input", op="Placeholder")
    n.attr["dtype"].type = 1
    for d in (1, 4, 4, 2):
        n.attr["shape"].shape.dim.add(size=d)
    n = gd.node.add(name="k", op="Const")
    n.attr["value"].tensor.CopyFrom(tf.make_tensor_proto(np.full((1, 4, 4, 2), 0.5, np.float64)))
    gd.node.add(name="add", op="AddV2", input=["input", "k"])
    n = gd.node.add(name="m", op="Const")
    n.attr["value"].tensor.CopyFrom(tf.make_tensor_proto(np.full((1, 4, 4, 2), 3, np.int64)))
    gd.node.add(name="mul", op="Mul", input=["add", "m"])
    data = gd.SerializeToString()
    jg, pg = jax_from_tf(data), ptf.from_tf_graphdef(data)
    assert pt.graph_to_tm_bytes(pg) == jax_bytes(jg)
    consts = {t.name: t for t in pg.tensors if t.data is not None}
    assert consts["k"].dtype == pir.DType.FP32 and consts["k"].data.dtype == np.float32
    assert consts["m"].dtype == pir.DType.INT32 and consts["m"].data.dtype == np.int32
    assert consts["m"].shape == [1, 2, 4, 4]  # NHWC -> NCHW
    assert len(pg.inputs) == 1 and pg.tensors[pg.input_tensors[0]].shape == [1, 2, 4, 4]
    assert [n.op for n in pg.nodes] == ["InputOp", "Eltwise", "Eltwise"]


# --- TF fixtures ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["convnet", "breadth"])
def test_tf_fixture(case):
    rng = np.random.default_rng(3)
    gph, data = tf_graphs()[case], graphdefs()[case]
    jg, pg = jax_from_tf(data), ptf.from_tf_graphdef(data)
    assert pt.graph_to_tm_bytes(pg) == jax_bytes(jg)
    shape = (1, 16, 16, 3) if case == "convnet" else (1, 4, 4, 2)
    x = rng.standard_normal(shape).astype(np.float32)
    want_tf = tf_session(gph, "prob:0" if case == "convnet" else "out:0", x)
    (got,) = pt.compile_graph(pg, device="cpu").run(nchw(x))
    (want,) = jt.compile_graph(jg, jt.Options()).run(nchw(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    if want_tf.ndim == 4:
        want_tf = nchw(want_tf)
    np.testing.assert_allclose(got.reshape(want_tf.shape), want_tf, rtol=1e-4, atol=1e-5)


def test_tf_quantized_convnet_matches_jax_node_by_node(monkeypatch):
    pg = ptf.from_tf_graphdef(graphdefs()["convnet"])
    x = nchw(np.random.default_rng(4).standard_normal((1, 16, 16, 3)).astype(np.float32))
    assert len(assert_quantized_nodes_match_jax(pg, x, monkeypatch)) >= 4


# --- TFLite ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def keras_blobs():
    """The fp32 and full-int8 conversions of tests/test_tflite_frontend.py's
    keras net, and the int8 conversion's calibration images."""
    rng = np.random.default_rng(0)
    m = build_keras_net(rng)
    fp32 = tf.lite.TFLiteConverter.from_keras_model(m).convert()
    conv = tf.lite.TFLiteConverter.from_keras_model(m)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]
    cal = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(8)]
    conv.representative_dataset = lambda: ([c] for c in cal)
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    return fp32, conv.convert(), cal


def assert_flatbuffer_read_alike(buf: bytes):
    """The port's reader against the schema's generated classes."""
    m, pm = tfl_schema.Model.GetRootAsModel(buf, 0), _flatbuf.Model(buf)
    assert m.OperatorCodesLength() == len(pm.operator_codes)
    for i in range(m.OperatorCodesLength()):
        oc = m.OperatorCodes(i)
        assert pm.builtin_code(i) == max(oc.BuiltinCode(), oc.DeprecatedBuiltinCode())
    assert m.BuffersLength() == len(pm.buffers)
    for i in range(m.BuffersLength()):
        b = m.Buffers(i)
        want = b.DataAsNumpy() if b.DataLength() else np.zeros(0, np.uint8)
        np.testing.assert_array_equal(pm.buffer_data(i), want)
    sub, ps = m.Subgraphs(0), pm.subgraphs[0]
    assert sub.InputsAsNumpy().tolist() == ps.vector(_flatbuf.SUBGRAPH_INPUTS, np.int32).tolist()
    assert sub.OutputsAsNumpy().tolist() == ps.vector(_flatbuf.SUBGRAPH_OUTPUTS, np.int32).tolist()
    tensors = ps.tables(_flatbuf.SUBGRAPH_TENSORS)
    assert sub.TensorsLength() == len(tensors)
    for i, t in enumerate(tensors):
        w = sub.Tensors(i)
        assert w.ShapeAsNumpy().tolist() == t.vector(_flatbuf.TENSOR_SHAPE, np.int32).tolist()
        assert w.Type() == t.scalar(_flatbuf.TENSOR_TYPE, "b", 0)
        assert w.Buffer() == t.scalar(_flatbuf.TENSOR_BUFFER, "I", 0)
        assert w.Name() == t.string(_flatbuf.TENSOR_NAME)
        q, pq = w.Quantization(), t.table(_flatbuf.TENSOR_QUANTIZATION)
        assert (q is None) == (pq is None)
        if q is not None:
            assert q.ScaleAsNumpy().tolist() == pq.vector(_flatbuf.QUANT_SCALE, np.float32).tolist() \
                if q.ScaleLength() else not pq.has(_flatbuf.QUANT_SCALE)
            zps = q.ZeroPointAsNumpy().tolist() if q.ZeroPointLength() else []
            assert zps == pq.vector(_flatbuf.QUANT_ZERO_POINT, np.int64).tolist()
    ops = ps.tables(_flatbuf.SUBGRAPH_OPERATORS)
    assert sub.OperatorsLength() == len(ops)
    slots = {  # builtin -> (options class, [(getter, slot, format, default)])
        _flatbuf.CONV_2D: (tfl_schema.Conv2DOptions, [
            ("Padding", 0, "b", 0), ("StrideW", 1, "i", 0), ("StrideH", 2, "i", 0),
            ("FusedActivationFunction", 3, "b", 0), ("DilationWFactor", 4, "i", 1),
            ("DilationHFactor", 5, "i", 1)]),
        _flatbuf.DEPTHWISE_CONV_2D: (tfl_schema.DepthwiseConv2DOptions, [
            ("Padding", 0, "b", 0), ("StrideW", 1, "i", 0), ("StrideH", 2, "i", 0),
            ("DepthMultiplier", 3, "i", 0), ("FusedActivationFunction", 4, "b", 0),
            ("DilationWFactor", 5, "i", 1), ("DilationHFactor", 6, "i", 1)]),
        _flatbuf.FULLY_CONNECTED: (tfl_schema.FullyConnectedOptions, [
            ("FusedActivationFunction", 0, "b", 0)]),
        _flatbuf.MAX_POOL_2D: (tfl_schema.Pool2DOptions, [
            ("Padding", 0, "b", 0), ("StrideW", 1, "i", 0), ("StrideH", 2, "i", 0),
            ("FilterWidth", 3, "i", 0), ("FilterHeight", 4, "i", 0)]),
    }
    for i, op in enumerate(ops):
        w = sub.Operators(i)
        assert w.OpcodeIndex() == op.scalar(_flatbuf.OPERATOR_OPCODE_INDEX, "I", 0)
        assert w.InputsAsNumpy().tolist() == op.vector(_flatbuf.OPERATOR_INPUTS, np.int32).tolist()
        assert w.OutputsAsNumpy().tolist() == op.vector(_flatbuf.OPERATOR_OUTPUTS,
                                                        np.int32).tolist()
        code = pm.builtin_code(w.OpcodeIndex())
        if code in slots and w.BuiltinOptions() is not None:
            cls, fields = slots[code]
            opts = cls()
            opts.Init(w.BuiltinOptions().Bytes, w.BuiltinOptions().Pos)
            table = op.table(_flatbuf.OPERATOR_BUILTIN_OPTIONS)
            for getter, slot, fmt, default in fields:
                assert getattr(opts, getter)() == table.scalar(slot, fmt, default), getter


@pytest.mark.parametrize("case", ["fp32", "int8", "chip_smoke_fp32", "chip_smoke_int8"])
def test_flatbuffer_reader_equals_the_schema(case):
    if case.startswith("chip_smoke"):
        buf = chip_smoke_tflite(int8=case.endswith("int8"))
    else:
        buf = keras_blobs()[0 if case == "fp32" else 1]
    assert_flatbuffer_read_alike(buf)


def test_tflite_fp32_fixture():
    blob = keras_blobs()[0]
    jg, pg = jax_from_tflite(blob), from_tflite(blob)
    assert pt.graph_to_tm_bytes(pg) == jax_bytes(jg)
    x = np.random.default_rng(5).standard_normal((1, 16, 16, 3)).astype(np.float32)
    _, y_tfl, _, _ = tflite_run(blob, x)
    (got,) = pt.compile_graph(pg, device="cpu").run(nchw(x))
    (want,) = jt.compile_graph(jg, jt.Options()).run(nchw(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.reshape(y_tfl.shape), y_tfl, rtol=1e-4, atol=1e-5)


def without_full_range(g):
    """A copy of g with every QuantParam.full_range unset, as the JAX
    importers leave it."""
    h = g.clone()
    for t in h.tensors:
        if t.quant is not None:
            t.quant.full_range = False
    return h


def test_tflite_full_int8_fixture():
    """tests/test_tflite_frontend.py:55's full-int8 file: imported with its
    quant params, no calibration; within 2 LSB of the Interpreter (the JAX
    test's own bound) and 1 LSB of the JAX engine. The port's INT8
    activations carry full_range, which its writer records as node
    attributes: without the flags its bytes are the JAX writer's, and the
    JAX reader reads its bytes to the JAX import's graph."""
    _, blob, cal = keras_blobs()
    jg, pg = jax_from_tflite(blob), from_tflite(blob)
    assert all(t.quant.full_range for t in pg.tensors
               if t.data is None and t.dtype == pir.DType.INT8)
    assert pt.graph_to_tm_bytes(without_full_range(pg)) == jax_bytes(jg)
    assert jax_bytes(jt.load_tm_bytes(pt.graph_to_tm_bytes(pg))) == jax_bytes(jg)
    xq_tfl, y_tfl, _, _ = tflite_run(blob, cal[0])
    t_in = pg.tensors[pg.input_tensors[0]]
    assert t_in.quant is not None and t_in.dtype == pir.DType.INT8
    xq = nchw(xq_tfl)
    (got,) = pt.compile_graph(pg, pt.Options(quant_mode="fast"), device="cpu").run(xq)
    (want,) = jt.compile_graph(jg, jt.Options(quant_mode="fast")).run(xq)
    got = got.reshape(y_tfl.shape).astype(np.int32)
    assert np.abs(got - y_tfl.astype(np.int32)).max() <= 2
    assert np.abs(got - np.asarray(want).reshape(y_tfl.shape).astype(np.int32)).max() <= 1


def test_tflite_quantized_convnet_matches_jax_node_by_node(monkeypatch):
    pg = from_tflite(keras_blobs()[0])
    x = nchw(keras_blobs()[2][1])
    assert len(assert_quantized_nodes_match_jax(pg, x, monkeypatch)) >= 4


# --- the flatten-order fault ------------------------------------------------------


def keras_flatten_blob(hw=6, scale=0.1):
    """flatten_graph's net as a keras model converted to TFLite."""
    tf.keras.utils.set_random_seed(1)
    inp = tf.keras.Input((hw, hw, 3), batch_size=1)
    x = tf.keras.layers.Conv2D(4, 3, padding="same", kernel_initializer=tf.keras.initializers
                               .RandomNormal(stddev=1.0))(inp)
    x = tf.keras.layers.Reshape((hw * hw * 4,))(x)
    x = tf.keras.layers.Dense(5, kernel_initializer=tf.keras.initializers
                              .RandomNormal(stddev=scale))(x)
    return tf.lite.TFLiteConverter.from_keras_model(tf.keras.Model(inp, x)).convert()


@pytest.mark.parametrize("fmt", ["tf", "tflite"])
def test_flatten_order_fault_is_not_copied(fmt):
    """conv 3x3 on 6x6x3 -> Reshape [1, 144] -> MatMul / Dense 5: the port's
    import within 1e-5 of TensorFlow's runtime (it transposes the map to
    NHWC before the flatten); the JAX import flattens C-H-W and is off by
    more than 0.5."""
    x = np.random.default_rng(6).standard_normal((1, 6, 6, 3)).astype(np.float32)
    if fmt == "tf":
        gph = flatten_graph(np.random.default_rng(7))
        data = gph.as_graph_def().SerializeToString()
        want = tf_session(gph, "out:0", x)
        jg, pg = jax_from_tf(data), ptf.from_tf_graphdef(data)
    else:
        data = keras_flatten_blob()
        _, want, _, _ = tflite_run(data, x)
        jg, pg = jax_from_tflite(data), from_tflite(data)
    ops = [n.op for n in pg.toposorted()]
    assert ops[ops.index("Reshape") - 1] == "Transpose"
    (got,) = pt.compile_graph(pg, device="cpu").run(nchw(x))
    (jax_out,) = jt.compile_graph(jg, jt.Options()).run(nchw(x))
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0, atol=1e-5)
    off = np.abs(np.asarray(jax_out).reshape(want.shape) - want).max()
    print(f"{fmt}: the JAX import is off by {off:.3f} (outputs up to {np.abs(want).max():.3f})")
    assert off > 0.5


@pytest.mark.parametrize("fmt", ["tf", "tflite"])
def test_flatten_of_a_1x1_map_keeps_the_reference_bytes(fmt):
    if fmt == "tf":
        data = flatten_graph(np.random.default_rng(8), hw=1).as_graph_def().SerializeToString()
        jg, pg = jax_from_tf(data), ptf.from_tf_graphdef(data)
    else:
        data = keras_flatten_blob(hw=1)
        jg, pg = jax_from_tflite(data), from_tflite(data)
    assert "Transpose" not in [n.op for n in pg.nodes]
    assert pt.graph_to_tm_bytes(pg) == jax_bytes(jg)


# --- per-channel weight zero points -------------------------------------------


def per_channel_uint8_conv_tflite():
    """A one-conv TFLite file written with chip_smoke.py's flatbuffer builder:
    UINT8 input and output, UINT8 weights with per-channel scales and
    nonzero per-channel zero points (a grid TFLite's converter does not
    make, which the schema allows), int32 bias."""
    rng = np.random.default_rng(9)
    fbt, vec = chip_smoke._fb_table, chip_smoke._fb_vec
    zps = [100, 120, 140, 160]
    s_w = [0.004, 0.003, 0.005, 0.002]

    def q(scales, zero_points, dim=0):
        return fbt({2: vec("f", scales), 3: vec("q", zero_points, 8), 6: ("i", dim)})

    def tensor(name, shape, ttype, buffer, quant):
        return fbt({0: vec("i", shape), 1: ("b", ttype), 2: ("I", buffer), 3: ("str", name),
                    4: quant})

    w = rng.integers(0, 256, (4, 3, 3, 3)).astype(np.uint8)  # OHWI
    b = rng.integers(-500, 500, 4).astype(np.int32)
    buffers = [fbt({}), fbt({0: vec("B", w.tobytes(), 16)}), fbt({0: vec("B", b.tobytes(), 16)})]
    tensors = [tensor("x", [1, 8, 8, 3], 3, 0, q([0.02], [128])),
               tensor("w", [4, 3, 3, 3], 3, 1, q(s_w, zps)),
               tensor("b", [4], 2, 2, q([0.02 * s for s in s_w], [0] * 4)),
               tensor("y", [1, 8, 8, 4], 3, 0, q([0.05], [100]))]
    op = fbt({0: ("I", 0), 1: vec("i", [0, 1, 2]), 2: vec("i", [3]), 3: ("B", 1),
              4: fbt({0: ("b", 0), 1: ("i", 1), 2: ("i", 1), 3: ("b", 0)})})
    sub = fbt({0: ("tables", tensors), 1: vec("i", [0]), 2: vec("i", [3]), 3: ("tables", [op])})
    model = fbt({0: ("I", 3), 1: ("tables", [fbt({0: ("b", 3), 3: ("i", 3)})]),
                 2: ("tables", [sub]), 4: ("tables", buffers)})
    return chip_smoke._fb_build(model, b"TFL3")


def test_per_channel_weight_zero_points_run_on_the_fast_tier():
    """The file's per-channel zero points import as given; the port's fast
    tier equals its ref tier within 1 LSB; the JAX fast tier, which takes a
    per-channel grid's zero points as 0, parts from it."""
    blob = per_channel_uint8_conv_tflite()
    assert_flatbuffer_read_alike(blob)
    pg = from_tflite(blob)
    w = pg.tensors[pg.nodes[1].inputs[1]]
    assert w.quant.per_channel and list(w.quant.zero_points) == [100, 120, 140, 160]
    assert pt.graph_to_tm_bytes(pg) == jax_bytes(jax_from_tflite(blob))
    xq = np.random.default_rng(10).integers(0, 256, (1, 3, 8, 8)).astype(np.uint8)
    ref, fast = (pt.compile_graph(pg, pt.Options(quant_mode=m), device="cpu").run(xq)[0]
                 .astype(np.int32) for m in ("ref", "fast"))
    assert np.abs(fast - ref).max() <= 1
    (jax_fast,) = jt.compile_graph(jt.load_tm_bytes(pt.graph_to_tm_bytes(pg)),
                                   jt.Options(quant_mode="fast")).run(xq)
    assert np.abs(np.asarray(jax_fast).astype(np.int32) - ref).max() > 1


# --- chip_smoke.py's encoders at small width ---------------------------------------

# mobilenet-v1 at img 32 and width multiplier 0.25; the dw route test's
# widths are multiples of 32, as the kernel's gate wants
SMALL = dict(img=32, classes=10, widths=tuple(max(8, w // 4) for w in chip_smoke.MOBILENET_WIDTHS))
SMALL_DW = dict(SMALL, widths=(32, 32, 64, 64, 64, 64, 96, 96, 96, 96, 96, 96, 128, 128))


@functools.lru_cache(maxsize=None)
def chip_smoke_small(dw=False):
    g = chip_smoke.build_mobilenet_v1_graph(pir, **(SMALL_DW if dw else SMALL))
    return chip_smoke.mobilenet_layers(g)


@functools.lru_cache(maxsize=None)
def chip_smoke_tflite(int8=False, dw=False):
    layers, shape = chip_smoke_small(dw)
    (blob,) = chip_smoke.encode_tflite(layers, shape)[0].values()
    if not int8:
        return blob
    x = np.random.default_rng(11).standard_normal((1, *shape[1:])).astype(np.float32)
    qg = pt.quantize_graph(from_tflite(blob), [x], scheme="uint8", algorithm="minmax",
                           device="cpu")
    (blob8,) = chip_smoke.encode_tflite(layers, shape, chip_smoke.tflite_grids(qg))[0].values()
    return blob8


def test_chip_smoke_graphdef_runs_in_tensorflow():
    layers, shape = chip_smoke_small()
    data = graphdefs()["chip_smoke"]
    x = np.random.default_rng(12).standard_normal((1, *shape[1:])).astype(np.float32)
    gd = tf1.GraphDef()
    gd.ParseFromString(data)
    with tf1.Graph().as_default() as gph:
        tf1.import_graph_def(gd, name="")
    want = tf_session(gph, "fc7:0", np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    jg, pg = jax_from_tf(data), ptf.from_tf_graphdef(data)
    assert pt.graph_to_tm_bytes(pg) == jax_bytes(jg)
    (got,) = pt.compile_graph(pg, device="cpu").run(x)
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0, atol=1e-4)
    plain = chip_smoke.plain_mobilenet(torch, layers, torch.from_numpy(x), same=True).numpy()
    np.testing.assert_allclose(got.reshape(plain.shape), plain, rtol=0, atol=1e-5)


def test_chip_smoke_tflite_runs_in_the_interpreter():
    _, shape = chip_smoke_small()
    blob = chip_smoke_tflite()
    x = np.random.default_rng(13).standard_normal((1, *shape[1:])).astype(np.float32)
    _, want, _, _ = tflite_run(blob, np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    assert pt.graph_to_tm_bytes(from_tflite(blob)) == jax_bytes(jax_from_tflite(blob))
    (got,) = pt.compile_graph(from_tflite(blob), device="cpu").run(x)
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0, atol=1e-4)


def test_chip_smoke_full_int8_tflite_within_2_lsb_of_the_interpreter():
    _, shape = chip_smoke_small()
    blob = chip_smoke_tflite(int8=True)
    x = np.random.default_rng(14).standard_normal((1, *shape[1:])).astype(np.float32)
    xq_tfl, want, ind, _ = tflite_run(blob, np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    assert ind["dtype"] == np.int8 and ind["quantization"][1] != 0
    pg = from_tflite(blob)
    (got,) = pt.compile_graph(pg, pt.Options(quant_mode="fast"), device="cpu").run(nchw(xq_tfl))
    d = np.abs(got.reshape(want.shape).astype(np.int32) - want.astype(np.int32))
    print(f"chip_smoke full-int8 tflite: max |d| {d.max()} LSB, equal {(d == 0).mean():.3f}")
    assert d.max() <= 2


def test_same_padded_depthwise_convs_take_the_dw_route(monkeypatch):
    """The full-int8 TFLite mobilenet (TF-SAME pads) at batch 32 on the
    integer-storage tier with TT_DW_PALLAS=1: the port puts its 13
    depthwise convs on dw_qconv, the JAX gate refuses TF-SAME pads and keeps
    them on its fast lowering; every port node within 1 LSB of the JAX
    node's output on the JAX node's inputs. The pointwise convs' shifted
    INT8 input keeps them off qconv1x1 in both."""
    _, shape = chip_smoke_small(dw=True)
    blob = pt.graph_to_tm_bytes(from_tflite(chip_smoke_tflite(int8=True, dw=True)))
    opts = dict(quant_mode="fast", quant_bf16_storage=False, batch_size=32)
    pg = pt.load_tm_bytes(blob)
    t_in = pg.tensors[pg.input_tensors[0]]
    x = np.random.default_rng(15).standard_normal((32, *shape[1:])).astype(np.float32)
    from tengine_tpu_torch.ops import qmath

    xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
    monkeypatch.setenv("TT_DW_PALLAS", "1")
    jax_env, jax_routes, _ = jax_run_all(blob, opts, xq, monkeypatch)
    seen, cg = port_run_forced(blob, opts, xq, jax_env, monkeypatch)
    routes = [cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution"]
    assert routes.count("lower_conv_quant_pallas_dw") == 13
    assert routes.count("lower_conv_quant_fast") == 14
    assert "lower_conv_quant_pallas_dw" not in jax_routes.values()
    assert len(seen) >= 27
    for name, (worst, _) in seen.items():
        assert worst <= 1, (name, worst)


def test_int8_tflite_grids_clip_at_minus_127_in_both_engines(monkeypatch):
    """A fault of the reference not copied (ROADMAP §3): TFLite's int8
    tensors span [-128, 127], but the JAX importer leaves
    QuantParam.full_range unset, so the JAX engine clips every INT8
    activation to [-127, 127]. The port's importer sets it. On the small
    full-int8 mobilenet, conv1 (ReLU, zero point -128) reads -127 in the
    JAX engine wherever tf.lite.Interpreter reads -128, and equals it
    elsewhere; the port equals the Interpreter on conv1, -128 included, and
    on every activation down to the logits: its largest difference from the
    Interpreter mid-net is 0 LSB, where the JAX engine's, run free on the
    same bytes (its reader skips the full_range attribute), is tens of
    LSB."""
    from test_torch_yolofastest import port_run_all

    _, shape = chip_smoke_small()
    blob = chip_smoke_tflite(int8=True)
    x = np.random.default_rng(16).standard_normal((1, *shape[1:])).astype(np.float32)
    it = tf.lite.Interpreter(model_content=blob, experimental_preserve_all_tensors=True)
    it.allocate_tensors()
    ind = it.get_input_details()[0]
    s, zp = ind["quantization"]
    xq = np.clip(np.round(x.transpose(0, 2, 3, 1) / s) + zp, -128, 127).astype(np.int8)
    it.set_tensor(ind["index"], xq)
    it.invoke()
    tfl = {d["name"]: it.get_tensor(d["index"]) for d in it.get_tensor_details()}
    pg = from_tflite(blob)
    (t1,) = [t for t in pg.tensors if t.name == "conv1"]
    assert int(np.asarray(t1.quant.zero_points)) == -128 and t1.quant.full_range
    opts = dict(quant_mode="fast")
    port = port_run_all(pt.compile_graph(pg, pt.Options(**opts), device="cpu"), nchw(xq))
    jax_env, _, _ = jax_run_all(pt.graph_to_tm_bytes(pg), opts, nchw(xq), monkeypatch)
    want = nchw(tfl["conv1"])
    floor = want == -128
    assert floor.mean() > 0.2
    assert (jax_env[t1.idx][floor] == -127).all()
    np.testing.assert_array_equal(jax_env[t1.idx][~floor], want[~floor])
    np.testing.assert_array_equal(port[t1.idx], want)

    worst = {"port": 0, "jax": 0}
    acts = [t for t in pg.tensors if t.data is None and t.name in tfl]
    assert len(acts) == 30  # the input, 27 convs, the pool, the logits
    for t in acts[:-1]:
        w = tfl[t.name]
        w = (nchw(w) if w.ndim == 4 else w).astype(np.int32)
        for engine, env in (("port", port), ("jax", jax_env)):
            got = env[t.idx].astype(np.int32)
            worst[engine] = max(worst[engine], int(np.abs(got - w.reshape(got.shape)).max()))
    assert worst["port"] == 0 and worst["jax"] >= 10, worst
    logits = tfl[acts[-1].name].astype(np.int32)
    got = port[acts[-1].idx].reshape(logits.shape).astype(np.int32)
    assert np.abs(got - logits).max() <= 2


# --- TF-slim's logits tail and TFLite buffers stored after the flatbuffer ------


def slim_tail_graph(rng, squeeze_dims=(1, 2), pool=4):
    """A conv net ending as TF-slim's frozen mobilenet_v1 ends: AvgPool to
    1x1, a 1x1 conv with bias (Logits/Conv2d_1c_1x1), SpatialSqueeze (a
    Squeeze), then Predictions: Reshape [-1, C], Softmax, Reshape to
    Shape(logits). The batch is unknown, so TF leaves the Shape a node.
    squeeze_dims=(1,) with pool < 4 squeezes H only (a [N, W, C] result)."""
    gph = tf1.Graph()
    with gph.as_default():
        x = tf1.placeholder(tf.float32, [None, 8, 8, 3], name="input")
        w = tf.constant(rng.standard_normal((3, 3, 3, 16)).astype(np.float32))
        c = tf.nn.relu(tf1.nn.conv2d(x, w, strides=[1, 2, 2, 1], padding="SAME"))
        p = tf1.nn.avg_pool(c, [1, 4, pool, 1], [1, 1, 1, 1], "VALID")
        wl = tf.constant(rng.standard_normal((1, 1, 16, 10)).astype(np.float32))
        bl = tf.constant(rng.standard_normal(10).astype(np.float32))
        logits = tf.nn.bias_add(tf1.nn.conv2d(p, wl, [1, 1, 1, 1], "SAME"), bl)
        logits = tf.squeeze(logits, list(squeeze_dims), name="SpatialSqueeze")
        if len(squeeze_dims) == 2:
            probs = tf.nn.softmax(tf.reshape(logits, [-1, 10]))
            tf.reshape(probs, tf.shape(logits), name="out")
        else:
            tf.identity(logits, name="out")
    return gph


@pytest.mark.parametrize("case", ["slim", "squeeze_h"])
def test_squeeze_and_shape_import_as_tensorflow_runs_them(case):
    """The slim tail imports (the JAX importer raises on the Squeeze) and
    runs within 1e-5 of a TF session, at the import's batch 1 and at batch
    3 (the Reshape to a folded Shape keeps the input's batch); a Squeeze
    that keeps C beside W goes through an NHWC transpose and keeps TF's
    order."""
    rng = np.random.default_rng(21)
    gph = slim_tail_graph(rng, *((1, 2), 4) if case == "slim" else ((1,), 2))
    data = gph.as_graph_def().SerializeToString()
    ops = [n.op for n in gph.as_graph_def().node]
    assert "Squeeze" in ops and ("Shape" in ops) == (case == "slim")
    with pytest.raises(NotImplementedError, match="Squeeze"):
        jax_from_tf(data)
    pg = ptf.from_tf_graphdef(data)
    assert ("Transpose" in [n.op for n in pg.nodes]) == (case == "squeeze_h")
    x = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    for batch in (1, 3):
        want = tf_session(gph, "out:0", x[:batch])
        (got,) = pt.compile_graph(pg, pt.Options(batch_size=batch), device="cpu").run(
            nchw(x[:batch]))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def external_buffers(buf: bytes) -> bytes:
    """The TFLite file with every buffer's data moved after the flatbuffer,
    referred to by Buffer.offset and size (schema.fbs; 16-byte aligned),
    as the converter writes a model over 2 GB. The flatbuffer is packed
    twice: its length does not depend on the offsets' values."""
    import flatbuffers

    model = tfl_schema.ModelT.InitFromObj(tfl_schema.Model.GetRootAsModel(buf, 0))
    datas = []
    for b in model.buffers:
        datas.append(None if b.data is None else bytes(np.asarray(b.data, np.uint8)))
        b.data = None

    def pack():
        builder = flatbuffers.Builder(1024)
        builder.Finish(model.Pack(builder), file_identifier=b"TFL3")
        return bytes(builder.Output())

    for b, d in zip(model.buffers, datas):
        b.offset, b.size = (2, len(d)) if d else (0, 0)
    at, tail = -(-len(pack()) // 16) * 16, b""
    for b, d in zip(model.buffers, datas):
        if d:
            b.offset = at + len(tail)
            tail += d + bytes(-len(d) % 16)
    head = pack()
    return head + bytes(at - len(head)) + tail


def test_tflite_buffers_stored_by_offset_and_size():
    """The full-int8 keras file with its buffers moved after the
    flatbuffer: tf.lite.Interpreter reads it to the same outputs, and the
    port imports it to the graph of the inline file, tmfile bytes equal;
    the JAX importer, which reads only inline data, fails on it."""
    _, blob, cal = keras_blobs()
    ext = external_buffers(blob)
    assert len(ext) > len(blob) and not any(
        b.DataLength() for b in (tfl_schema.Model.GetRootAsModel(ext, 0).Buffers(i)
                                 for i in range(tfl_schema.Model.GetRootAsModel(ext, 0).BuffersLength())))
    _, y_inline, _, _ = tflite_run(blob, cal[0])
    _, y_ext, _, _ = tflite_run(ext, cal[0])
    np.testing.assert_array_equal(y_ext, y_inline)
    assert pt.graph_to_tm_bytes(from_tflite(ext)) == pt.graph_to_tm_bytes(from_tflite(blob))
    with pytest.raises(TypeError):
        jax_from_tflite(ext)
