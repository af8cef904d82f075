"""The PyTorch port's ONNX, Caffe, ncnn and MXNet front ends
(tengine_tpu_torch/convert/) against the JAX package's, on the CPU.

Fixtures: the JAX front-end tests' own (tests/test_{onnx,caffe,ncnn,
mxnet}_frontend.py), built with their builders by import, and
chip_smoke.py's encoders of mobilenet-v1 (img 32, width multiplier 0.25).
Each fixture goes through both packages' front ends:
  * the port's tmfile bytes equal the JAX writer's (graph_to_tm_bytes) for
    the same source bytes, so the IRs are the same;
  * fp32: the JAX engine's outputs and the port's on the CPU within 1e-5
    absolute; the ncnn and MXNet tests' torch oracles hold the port too;
  * quantized: one convnet a format, imported and quantized by the port
    (UINT8 MinMax), its bytes run by both engines under
    Options(quant_mode="fast"), every node within 1 LSB of its JAX
    counterpart on the counterpart's inputs (XLA:CPU's fused multiply-add,
    ROADMAP §3, is why 1 and not 0);
  * the decoders' parse results (parse_onnx, parse_prototxt,
    parse_caffemodel, parse_param, parse_params) equal the JAX package's.
"""

import functools
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import torch.nn.functional as F  # noqa: E402

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.convert import caffe_frontend as jcaffe  # noqa: E402
from tengine_tpu.convert import mxnet_frontend as jmx  # noqa: E402
from tengine_tpu.convert import ncnn_frontend as jncnn  # noqa: E402
from tengine_tpu.convert import onnx_frontend as jonnx  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes as jax_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.convert import caffe_frontend as pcaffe  # noqa: E402
from tengine_tpu_torch.convert import mxnet_frontend as pmx  # noqa: E402
from tengine_tpu_torch.convert import ncnn_frontend as pncnn  # noqa: E402
from tengine_tpu_torch.convert import onnx_frontend as ponnx  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.ops import qmath  # noqa: E402

from test_caffe_frontend import PROTOTXT, make_caffemodel  # noqa: E402
from test_mxnet_frontend import _mk, make_params  # noqa: E402
from test_ncnn_frontend import _bin  # noqa: E402
from test_onnx_frontend import _onnx_convnet, model, node  # noqa: E402
from test_torch_yolofastest import jax_run_all, port_run_forced  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SMALL_MOBILENET = dict(img=32, classes=10,
                       widths=tuple(max(8, w // 4) for w in chip_smoke.MOBILENET_WIDTHS))


def _x(rng, shape, positive=False):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.abs(x) + 0.5 if positive else x


# --- ONNX: the fixtures of tests/test_onnx_frontend.py -----------------------

_UNARY = ["Abs", "Neg", "Floor", "Ceil", "Sqrt", "Exp", "Log", "Sin", "Cos", "Reciprocal",
          "Round", "Softplus"]
_BINARY = ["Pow", "Min", "Max", "Mean", "Greater", "Less", "Equal"]
_REDUCE = ["ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin", "ReduceProd",
           "ReduceSumSquare", "ReduceL1", "ReduceLogSum", "ReduceLogSumExp"]
ONNX_CASES = (["convnet", "misc", "DepthToSpace", "Gather", "Tile", "Expand", "Split",
               "ArgMax", "Where", "InstanceNormalization", "LRN", "PRelu", "LSTM", "GRU",
               "ReduceL2"]
              + [f"unary-{op}" for op in _UNARY] + [f"binary-{op}" for op in _BINARY]
              + [f"reduce-{op}" for op in _REDUCE])


@functools.lru_cache(maxsize=None)
def onnx_case(name):
    """(ModelProto bytes, inputs) of a fixture of tests/test_onnx_frontend.py."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "convnet":
        return _onnx_convnet(rng)[0], (_x(rng, (1, 3, 16, 16)),)
    if name == "misc":
        w = (rng.standard_normal((4, 4, 1, 1)) * 0.3).astype(np.float32)
        nodes = [
            node("Conv", ["x", "w"], ["c"], kernel_shape=[1, 1], pads=[0, 0, 0, 0],
                 strides=[1, 1], group=1),
            node("Add", ["c", "x"], ["a"]), node("Sigmoid", ["a"], ["s"]),
            node("Mul", ["a", "s"], ["m"]), node("Concat", ["m", "x"], ["cc"], axis=1),
            node("Slice", ["cc", "st", "en", "ax", "sp"], ["sl"]),
            node("Upsample", ["sl"], ["up"], mode="nearest", scales=[1.0, 1.0, 2.0, 2.0]),
            node("Transpose", ["up"], ["tr"], perm=[0, 2, 3, 1]),
            node("Reshape", ["tr", "shp"], ["y"]),
        ]
        inits = dict(w=w, st=np.asarray([0], np.int64), en=np.asarray([4], np.int64),
                     ax=np.asarray([1], np.int64), sp=np.asarray([2], np.int64),
                     shp=np.asarray([1, -1], np.int64))
        return model(nodes, inits, [("x", [1, 4, 6, 6])], ["y"]), (_x(rng, (1, 4, 6, 6)),)
    kind, _, op = name.partition("-")
    if kind == "unary":
        return (model([node(op, ["x"], ["y"])], {}, [("x", [1, 3, 4, 4])], ["y"]),
                (_x(rng, (1, 3, 4, 4), positive=True),))
    if kind == "binary":
        return (model([node(op, ["a", "b"], ["y"])], {}, [("a", [1, 3, 4, 4]), ("b", [1, 3, 4, 4])],
                      ["y"]),
                (_x(rng, (1, 3, 4, 4), positive=op == "Pow"), _x(rng, (1, 3, 4, 4), positive=True)))
    if kind == "reduce":
        return (model([node(op, ["x"], ["y"], axes=[2, 3], keepdims=1)], {},
                      [("x", [2, 3, 4, 5])], ["y"]),
                (_x(rng, (2, 3, 4, 5), positive=True) - 0.4,))
    x = _x(rng, (1, 8, 4, 4))
    one = [("x", [1, 8, 4, 4])]
    if name == "ReduceL2":
        return (model([node("ReduceL2", ["x"], ["y"], axes=[1], keepdims=1)], {},
                      [("x", [2, 3, 4, 5])], ["y"]), (_x(rng, (2, 3, 4, 5)),))
    if name == "DepthToSpace":
        return model([node(name, ["x"], ["y"], blocksize=2, mode="DCR")], {}, one, ["y"]), (x,)
    if name == "Gather":
        return (model([node(name, ["x", "i"], ["y"], axis=1)], {"i": np.array([3, 1, 5], np.int64)},
                      one, ["y"]), (x,))
    if name == "Tile":
        return (model([node(name, ["x", "r"], ["y"])], {"r": np.array([1, 2, 1, 3], np.int64)},
                      one, ["y"]), (x,))
    if name == "Expand":
        return (model([node(name, ["x2", "e"], ["y"])], {"e": np.array([1, 8, 4, 4], np.int64)},
                      [("x2", [1, 8, 1, 4])], ["y"]), (_x(rng, (1, 8, 1, 4)),))
    if name == "Split":
        return model([node(name, ["x"], ["y", "z"], axis=1, split=[5, 3])], {}, one, ["y"]), (x,)
    if name == "ArgMax":
        return model([node(name, ["x"], ["y"], axis=1, keepdims=0)], {}, one, ["y"]), (x,)
    if name == "Where":
        return (model([node("Greater", ["x", "x0"], ["c"]), node("Where", ["c", "x", "x0"], ["y"])],
                      {}, one + [("x0", [1, 8, 4, 4])], ["y"]), (x, np.zeros_like(x)))
    four = [("x", [2, 4, 6, 6])]
    x4 = _x(rng, (2, 4, 6, 6))
    if name == "InstanceNormalization":
        g = (1 + 0.1 * rng.standard_normal(4)).astype(np.float32)
        b = (0.1 * rng.standard_normal(4)).astype(np.float32)
        return (model([node(name, ["x", "g", "b"], ["y"], epsilon=1e-5)], {"g": g, "b": b}, four,
                      ["y"]), (x4,))
    if name == "LRN":
        return (model([node(name, ["x"], ["y"], size=3, alpha=2e-4, beta=0.75, bias=1.0)], {},
                      four, ["y"]), (x4,))
    if name == "PRelu":
        s = np.abs(rng.standard_normal(4)).astype(np.float32)
        return model([node(name, ["x", "s"], ["y"])], {"s": s}, four, ["y"]), (x4,)
    T, B, I, H = 5, 2, 3, 4
    gates = 4 if name == "LSTM" else 3
    inits = {"W": (rng.standard_normal((1, gates * H, I)) * 0.3).astype(np.float32),
             "R": (rng.standard_normal((1, gates * H, H)) * 0.3).astype(np.float32)}
    ins = ["x", "W", "R"]
    if name == "LSTM":
        inits["B"] = (rng.standard_normal((1, 2 * gates * H)) * 0.1).astype(np.float32)
        ins.append("B")
    return (model([node(name, ins, ["y"], hidden_size=H)], inits, [("x", [T, B, I])], ["y"]),
            (_x(rng, (T, B, I)),))


def _same_import_and_outputs(jg, pg, inputs, atol=1e-5):
    """The port's tmfile bytes equal the JAX writer's; the two engines'
    fp32 outputs within atol. Returns the port's outputs."""
    assert pt.graph_to_tm_bytes(pg) == jax_bytes(jg)
    want = jt.compile_graph(jg, jt.Options()).run(*inputs)
    got = pt.compile_graph(pg, device="cpu").run(*inputs)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    return got


def test_wire_decoder_is_importable_and_parses_alike(rng):
    """The protobuf reader the Caffe and TF front ends build on keeps its
    names, and parse_onnx reads what the JAX package reads."""
    for fn in ("_fields", "_signed", "_packed_varints"):
        assert callable(getattr(ponnx, fn))
    assert ponnx._signed(2**64 - 1) == -1 and ponnx._packed_varints(memoryview(b"\x96\x01\x7f")) == [150, 127]
    m, _ = onnx_case("convnet")
    jp, pp = jonnx.parse_onnx(m), ponnx.parse_onnx(m)
    assert jp[0] == pp[0] and jp[3:] == pp[3:]
    assert [(n.op, n.name, n.inputs, n.outputs) for n in jp[1]] == [
        (n.op, n.name, n.inputs, n.outputs) for n in pp[1]]
    for a, b in zip(jp[1], pp[1]):
        assert a.attrs.keys() == b.attrs.keys()
        assert all(np.array_equal(a.attrs[k], b.attrs[k]) for k in a.attrs)
    assert jp[2].keys() == pp[2].keys()
    assert all(np.array_equal(jp[2][k], pp[2][k]) for k in jp[2])


@pytest.mark.parametrize("case", ONNX_CASES)
def test_onnx_fixture(case):
    m, inputs = onnx_case(case)
    _same_import_and_outputs(jonnx.from_onnx(m), ponnx.from_onnx(m), inputs)


# --- Caffe: tests/test_caffe_frontend.py ---------------------------------------

CAFFE_BREADTH = """
name: "breadth"
input: "data"
input_shape { dim: 1 dim: 8 dim: 8 dim: 8 }
layer { name: "sp" type: "Split" bottom: "data" top: "d1" top: "d2" }
layer { name: "abs" type: "AbsVal" bottom: "d1" top: "abs" }
layer { name: "clip" type: "Clip" bottom: "abs" top: "clip" clip_param { min: 0.1 max: 0.9 } }
layer { name: "elu" type: "ELU" bottom: "d2" top: "elu" elu_param { alpha: 0.5 } }
layer { name: "pow" type: "Power" bottom: "elu" top: "pow"
        power_param { power: 2.0 scale: 0.5 shift: 1.0 } }
layer { name: "sum" type: "Eltwise" bottom: "clip" bottom: "pow" top: "sum" }
layer { name: "lrn" type: "LRN" bottom: "sum" top: "lrn"
        lrn_param { local_size: 3 alpha: 0.0002 beta: 0.75 } }
layer { name: "mvn" type: "MVN" bottom: "lrn" top: "mvn" }
layer { name: "thr" type: "Threshold" bottom: "mvn" top: "thr" threshold_param { threshold: 0.2 } }
layer { name: "shuf" type: "ShuffleChannel" bottom: "thr" top: "shuf"
        shuffle_channel_param { group: 2 } }
layer { name: "reorg" type: "Reorg" bottom: "shuf" top: "reorg" reorg_param { stride: 2 } }
layer { name: "slice" type: "Slice" bottom: "reorg" top: "s0" top: "s1"
        slice_param { axis: 1 slice_point: 16 } }
layer { name: "tile" type: "Tile" bottom: "s0" top: "tile" tile_param { axis: 1 tiles: 2 } }
layer { name: "red" type: "Reduction" bottom: "tile" top: "red"
        reduction_param { operation: SUM axis: 2 } }
"""
CAFFE_SSD = """
name: "ssdish"
input: "data"
input_shape { dim: 1 dim: 4 dim: 6 dim: 6 }
layer { name: "norm" type: "Normalize" bottom: "data" top: "norm"
        norm_param { across_spatial: false channel_shared: false } }
layer { name: "perm" type: "Permute" bottom: "norm" top: "perm"
        permute_param { order: 0 order: 2 order: 3 order: 1 } }
layer { name: "pb" type: "PriorBox" bottom: "norm" bottom: "data" top: "pb"
        prior_box_param { min_size: 30 max_size: 60 aspect_ratio: 2
                          flip: true clip: false variance: 0.1 variance: 0.1
                          variance: 0.2 variance: 0.2 step: 8 offset: 0.5 } }
"""


def caffe_net(rng):
    """tests/test_caffe_frontend.py:test_caffe_end_to_end's net and weights."""
    w1 = (rng.standard_normal((4, 3, 3, 3)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(4) * 0.1).astype(np.float32)
    wf = (rng.standard_normal((5, 4 * 4 * 4)) * 0.2).astype(np.float32)
    bf = (rng.standard_normal(5) * 0.1).astype(np.float32)
    return make_caffemodel({"conv1": [w1, b1], "fc1": [wf.reshape(5, 4, 4, 4), bf]})


def test_caffe_parsers_read_alike(rng):
    for text in (PROTOTXT, CAFFE_BREADTH, CAFFE_SSD):
        assert pcaffe.parse_prototxt(text) == jcaffe.parse_prototxt(text)
    blob = caffe_net(rng)
    jb, pb = jcaffe.parse_caffemodel(blob), pcaffe.parse_caffemodel(blob)
    assert jb.keys() == pb.keys()
    for k in jb:
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(jb[k], pb[k]))


@pytest.mark.parametrize("case", ["end_to_end", "breadth", "ssd_head"])
def test_caffe_fixture(case, rng):
    text, blob, shape = {"end_to_end": (PROTOTXT, caffe_net(rng), (1, 3, 8, 8)),
                         "breadth": (CAFFE_BREADTH, None, (1, 8, 8, 8)),
                         "ssd_head": (CAFFE_SSD, None, (1, 4, 6, 6))}[case]
    x = rng.standard_normal(shape).astype(np.float32)
    _same_import_and_outputs(jcaffe.from_caffe(text, blob), pcaffe.from_caffe(text, blob), (x,))


# --- ncnn: tests/test_ncnn_frontend.py -----------------------------------------

NCNN_PARSE = """7767517
3 3
Input        data    0 1 data 0=8 1=8 2=3
Convolution  conv0   1 1 data c0 0=4 1=3 4=1 5=1 6=108 9=2 10=1,0.15
Slice        split0  1 2 c0 a b -23300=2,2,-233 1=0
"""
NCNN_NET = """7767517
9 10
Input        data  0 1 data 0=8 1=8 2=3
Convolution  conv0 1 1 data c0 0=6 1=3 3=1 4=1 5=1 6=162 9=2 10=1,0.1
Split        sp0   1 2 c0 c0a c0b
Pooling      pool0 1 1 c0a p0 0=0 1=2 2=2 5=1
Pooling      pool1 1 1 c0b p1 0=1 1=2 2=2 5=1
Eltwise      add0  2 1 p0 p1 e0 0=1
BatchNorm    bn0   1 1 e0 b0 0=6 1=0.001
InnerProduct fc0   1 1 b0 f0 0=5 1=1 2=480
Softmax      sm0   1 1 f0 s0 0=0
"""
NCNN_SLICE = """7767517
5 6
Input    data 0 1 data 0=4 1=4 2=4
Slice    sl0  1 2 data a b -23300=2,2,-233 1=0
BinaryOp sub0 2 1 a b d0 0=1
BinaryOp muls 1 1 d0 m0 0=2 1=1 2=0.5
UnaryOp  abs0 1 1 m0 u0 0=0
"""
NCNN_WEIGHTLESS = """7767517
3 3
Input         data  0 1 data 0=16 1=16 2=8
ConvolutionDepthWise conv0 1 1 data c0 0=8 1=3 3=2 4=1 5=0 6=72 7=8
ShuffleChannel shuf 1 1 c0 s0 0=2
"""


def ncnn_net(rng):
    """tests/test_ncnn_frontend.py:test_ncnn_end_to_end's weights, and its
    torch oracle."""
    w = rng.standard_normal((6, 3, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    slope = rng.standard_normal(6).astype(np.float32)
    mean = rng.standard_normal(6).astype(np.float32)
    var = (np.abs(rng.standard_normal(6)) + 0.5).astype(np.float32)
    bnb = rng.standard_normal(6).astype(np.float32)
    wfc = rng.standard_normal((5, 6 * 4 * 4)).astype(np.float32)
    bfc = rng.standard_normal(5).astype(np.float32)
    blob = _bin((w, True), (b, False), (slope, False), (mean, False), (var, False),
                (bnb, False), (wfc, True), (bfc, False))

    def oracle(x):
        t = lambda a: torch.from_numpy(a)  # noqa: E731
        y = F.leaky_relu(F.conv2d(t(x), t(w), t(b), padding=1), 0.1)
        y = F.max_pool2d(y, 2, 2) + F.avg_pool2d(y, 2, 2)
        y = F.batch_norm(y, t(mean), t(var), t(slope), t(bnb), False, 0.0, 1e-3)
        return F.softmax(F.linear(y.flatten(1), t(wfc), t(bfc)), dim=1).numpy()

    return blob, oracle


def test_ncnn_param_parses_alike():
    for text in (NCNN_PARSE, NCNN_NET, NCNN_SLICE, NCNN_WEIGHTLESS):
        a, b = jncnn.parse_param(text), pncnn.parse_param(text)
        assert [vars(x) for x in a] == [vars(x) for x in b]
    assert pncnn.FLAG_FP32 == jncnn.FLAG_FP32 == 0


@pytest.mark.parametrize("case", ["end_to_end", "slice_binary", "weightless"])
def test_ncnn_fixture(case, rng):
    if case == "end_to_end":
        blob, oracle = ncnn_net(rng)
        text, shape = NCNN_NET, (1, 3, 8, 8)
    else:
        text, blob, shape, oracle = {"slice_binary": (NCNN_SLICE, b"", (1, 4, 4, 4), None),
                                     "weightless": (NCNN_WEIGHTLESS, None, (1, 8, 16, 16),
                                                    None)}[case]
    x = rng.standard_normal(shape).astype(np.float32)
    (got,) = _same_import_and_outputs(jncnn.from_ncnn(text, blob), pncnn.from_ncnn(text, blob),
                                      (x,))
    if oracle is not None:
        np.testing.assert_allclose(got.reshape(1, 5), oracle(x), rtol=2e-5, atol=2e-5)


# --- MXNet: tests/test_mxnet_frontend.py ---------------------------------------


def mxnet_net(rng):
    """tests/test_mxnet_frontend.py:test_mxnet_end_to_end's symbol, params
    and torch oracle."""
    nodes = [
        {"op": "null", "name": "data", "attrs": {}, "inputs": []},
        {"op": "null", "name": "c0_weight", "attrs": {}, "inputs": []},
        {"op": "null", "name": "c0_bias", "attrs": {}, "inputs": []},
        _mk("Convolution", "c0", [0, 1, 2], kernel="(3, 3)", stride="(1, 1)", pad="(1, 1)",
            num_filter=6),
        {"op": "null", "name": "bn_gamma", "attrs": {}, "inputs": []},
        {"op": "null", "name": "bn_beta", "attrs": {}, "inputs": []},
        {"op": "null", "name": "bn_mean", "attrs": {}, "inputs": []},
        {"op": "null", "name": "bn_var", "attrs": {}, "inputs": []},
        _mk("BatchNorm", "bn", [3, 4, 5, 6, 7], eps=0.001, fix_gamma="True"),
        _mk("Activation", "relu0", [8], act_type="relu"),
        _mk("_mul_scalar", "scaled", [9], scalar=0.5),
        _mk("elemwise_add", "skip", [9, 10]),
        _mk("Pooling", "pool0", [11], pool_type="max", kernel="(2, 2)", stride="(2, 2)",
            pad="(0, 0)"),
        _mk("Flatten", "flat", [12]),
        {"op": "null", "name": "fc_weight", "attrs": {}, "inputs": []},
        {"op": "null", "name": "fc_bias", "attrs": {}, "inputs": []},
        _mk("FullyConnected", "fc", [13, 14, 15], num_hidden=5),
        _mk("SoftmaxOutput", "softmax", [16]),
    ]
    sym = {"nodes": nodes, "arg_nodes": [0, 1, 2, 4, 5, 6, 7, 14, 15], "heads": [[17, 0, 0]]}
    w = rng.standard_normal((6, 3, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    gamma = rng.standard_normal(6).astype(np.float32)
    beta = rng.standard_normal(6).astype(np.float32)
    mean = rng.standard_normal(6).astype(np.float32)
    var = (np.abs(rng.standard_normal(6)) + 0.5).astype(np.float32)
    wfc = rng.standard_normal((5, 6 * 4 * 4)).astype(np.float32)
    bfc = rng.standard_normal(5).astype(np.float32)
    params = make_params({"arg:c0_weight": w, "arg:c0_bias": b, "arg:bn_gamma": gamma,
                          "arg:bn_beta": beta, "aux:bn_mean": mean, "aux:bn_var": var,
                          "arg:fc_weight": wfc, "arg:fc_bias": bfc})

    def oracle(x):
        t = lambda a: torch.from_numpy(a)  # noqa: E731
        y = F.conv2d(t(x), t(w), t(b), padding=1)
        y = F.relu(F.batch_norm(y, t(mean), t(var), torch.ones(6), t(beta), False, 0.0, 1e-3))
        y = F.max_pool2d(y + 0.5 * y, 2, 2).flatten(1)
        return F.softmax(F.linear(y, t(wfc), t(bfc)), dim=1).numpy()

    return json.dumps(sym), params, oracle


MXNET_WEIGHTLESS = json.dumps({"nodes": [
    {"op": "null", "name": "data", "attrs": {}, "inputs": []},
    _mk("Activation", "s", [0], act_type="sigmoid"),
    _mk("clip", "c", [1], a_min=0.1, a_max=0.9),
    _mk("transpose", "t", [2], axes="(0, 2, 3, 1)"),
], "heads": [[3, 0, 0]]})


def test_mxnet_params_parse_alike(rng):
    _, params, _ = mxnet_net(rng)
    a, b = jmx.parse_params(params), pmx.parse_params(params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert pmx.NDARRAY_V2 == jmx.NDARRAY_V2


@pytest.mark.parametrize("case", ["end_to_end", "weightless"])
def test_mxnet_fixture(case, rng):
    if case == "end_to_end":
        sym, params, oracle = mxnet_net(rng)
        shape = [1, 3, 8, 8]
    else:
        sym, params, oracle, shape = MXNET_WEIGHTLESS, None, None, [1, 2, 4, 4]
    x = rng.standard_normal(shape).astype(np.float32)
    jg = jmx.from_mxnet(sym, params, input_shape=shape)
    pg = pmx.from_mxnet(sym, params, input_shape=shape)
    assert [pg.nodes[i].name for i in pg.outputs] == [jg.nodes[i].name for i in jg.outputs]
    (got,) = _same_import_and_outputs(jg, pg, (x,))
    if oracle is not None:
        np.testing.assert_allclose(got.reshape(1, 5), oracle(x), rtol=2e-5, atol=2e-5)


# --- quantized: one convnet a format, node by node ---------------------------


def _quant_case(fmt, rng):
    """(port import, calibration / input batch) of a format's convnet."""
    if fmt == "onnx":
        return ponnx.from_onnx(onnx_case("convnet")[0]), rng.standard_normal((1, 3, 16, 16))
    if fmt == "caffe":
        return pcaffe.from_caffe(PROTOTXT, caffe_net(rng)), rng.standard_normal((1, 3, 8, 8))
    if fmt == "ncnn":
        return pncnn.from_ncnn(NCNN_NET, ncnn_net(rng)[0]), rng.standard_normal((1, 3, 8, 8))
    sym, params, _ = mxnet_net(rng)
    return (pmx.from_mxnet(sym, params, input_shape=[1, 3, 8, 8]),
            rng.standard_normal((1, 3, 8, 8)))


def assert_quantized_nodes_match_jax(pg, x, monkeypatch, opts=None):
    """pg quantized by the port (UINT8 MinMax on x), its bytes run by both
    engines under opts; every quantized node of the port within 1 LSB of the
    JAX node's output on the JAX node's inputs. Returns {node: (max LSB,
    share differing)}."""
    x = np.asarray(x, np.float32)
    qg = pt.quantize_graph(pg, [x], scheme="uint8", algorithm="minmax", device="cpu")
    blob = pt.graph_to_tm_bytes(qg)
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
    opts = opts or dict(quant_mode="fast")
    jax_env, _, _ = jax_run_all(blob, opts, xq, monkeypatch)
    seen, _ = port_run_forced(blob, opts, xq, jax_env, monkeypatch)
    assert seen, "no quantized node compared"
    for name, (worst, _) in seen.items():
        assert worst <= 1, (name, worst)
    return seen


@pytest.mark.parametrize("fmt", ["onnx", "caffe", "ncnn", "mxnet"])
def test_quantized_convnet_matches_jax_node_by_node(fmt, rng, monkeypatch):
    pg, x = _quant_case(fmt, rng)
    seen = assert_quantized_nodes_match_jax(pg, x, monkeypatch)
    assert any(pg.nodes[i].op == "Convolution" for i in range(len(pg.nodes)))
    assert len(seen) >= 3


# --- chip_smoke.py's encoders at small width -----------------------------------


@functools.lru_cache(maxsize=None)
def small_mobilenet():
    g = chip_smoke.build_mobilenet_v1_graph(pir, **SMALL_MOBILENET)
    return chip_smoke.mobilenet_layers(g)


def write_model(tmp_path, files):
    for name, data in files.items():
        (tmp_path / name).write_bytes(data.encode() if isinstance(data, str) else data)


@pytest.mark.parametrize("fmt,fn", [("onnx", "from_onnx"), ("caffe", "from_caffe"),
                                    ("ncnn", "from_ncnn"), ("mxnet", "from_mxnet")])
def test_chip_smoke_encoders_import_alike(fmt, fn, tmp_path):
    """chip_smoke.py's ONNX, Caffe, ncnn and MXNet encodings of mobilenet-v1
    import to the same bytes in both packages, and the port's fp32 forward
    equals the plain torch forward of the same weights (explicit pads)."""
    layers, shape = small_mobilenet()
    files, args = chip_smoke.FRONTEND_ENCODERS[fmt](layers, shape)
    write_model(tmp_path, files)
    paths = [str(tmp_path / a) for a in args if a in files]
    jg = getattr(sys.modules[f"tengine_tpu.convert.{fmt}_frontend"], fn)(*paths,
                                                                        input_shape=shape)
    pg = getattr(sys.modules[f"tengine_tpu_torch.convert.{fmt}_frontend"], fn)(*paths,
                                                                              input_shape=shape)
    assert pt.graph_to_tm_bytes(pg) == jax_bytes(jg)
    x = np.random.default_rng(2).standard_normal((2, *shape[1:])).astype(np.float32)
    (got,) = pt.compile_graph(pg, pt.Options(batch_size=2), device="cpu").run(x)
    want = chip_smoke.plain_mobilenet(torch, layers, torch.from_numpy(x), same=False).numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0, atol=1e-5)
