"""TensorFlow front-end: frozen GraphDef (.pb) -> IR Graph.

Reference: tools/convert_tool/tf/tf2tengine.cpp (GraphDef importer).

PyTorch port of tengine_tpu/convert/tf_frontend.py. That module parses the
GraphDef with the tensorflow package and decodes constants with
tf.make_ndarray; this one imports neither tensorflow nor protobuf. It
decodes the GraphDef on the ONNX front end's wire-format reader
(onnx_frontend._fields), reading only the fields the importer reads, by
their numbers in tensorflow/core/framework/*.proto:

  GraphDef: node=1
  NodeDef: name=1 op=2 input=3 device=4 attr=5 (map<string, AttrValue>:
    entries key=1 value=2)
  AttrValue: list=1 s=2 i=3 f=4 b=5 type=6 shape=7 tensor=8
  AttrValue.ListValue: s=2 i=3 f=4 b=5 type=6 shape=7 tensor=8
  TensorShapeProto: dim=2 (Dim: size=1 name=2) unknown_rank=3
  TensorProto: dtype=1 tensor_shape=2 tensor_content=4 half_val=13
    float_val=5 double_val=6 int_val=7 string_val=8 int64_val=10
    bool_val=11 uint32_val=16 uint64_val=17

make_ndarray keeps tf.make_ndarray's semantics: tensor_content is raw
little-endian bytes; otherwise the typed *_val list, padded to the shape
with its last value (a single value fills the shape), zeros if empty.

TF graphs are NHWC; the IR is NCHW-semantic (tmfile convention), so the
importer transposes the input shape and conv weights (HWIO -> OIHW,
depthwise HWCM -> [C*M,1,kh,kw]) and maps SAME padding to the IR's pad=-1
TF-SAME convention (ops/lowering.py:_conv_pads).

One fault of the reference is not copied: it emits a Reshape unchanged onto
the IR's NCHW tensor, so a rank-4 activation is flattened in C-H-W order
where TF flattens H-W-C. Here a Reshape of a rank-4 activation with
H*W > 1 first transposes it to NHWC (and a rank-4 result back to NCHW);
with H*W == 1 the IR is the reference's.

Two ops the reference's importer raises on are imported, so that the
published TF-slim frozen mobilenet_v1 imports (ROADMAP §3): its logits go
through SpatialSqueeze (a Squeeze), then slim's softmax tail, a Reshape, a
Softmax and a Reshape to Shape(logits). Squeeze maps its squeeze_dims from
NHWC to NCHW axes onto the IR's Squeeze (where the kept axes would not keep
TF's order, it squeezes an NHWC transpose); a Shape of a tensor whose shape
is static folds to a const.
"""

from __future__ import annotations

import copy
import struct
from typing import Dict, List, Optional

import numpy as np

from ..graph.ir import DType, Graph, TensorType
from ..serializer.tm2.format import ELT_SUM, ELT_PROD
from .onnx_frontend import _fields, _packed_varints, _signed

# ---------------------------------------------------------------------------
# GraphDef wire-format decoding
# ---------------------------------------------------------------------------

# DataType enum (types.proto) -> numpy; the quantized types as their storage
_TF_DT = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: np.object_, 9: np.int64, 10: np.bool_, 11: np.int8,
    12: np.uint8, 13: np.int32, 15: np.int16, 16: np.uint16, 17: np.uint16,
    19: np.float16, 22: np.uint32, 23: np.uint64,
}
# which *_val field holds a dtype's values (tf.make_ndarray)
_VAL_FIELD = {1: "float_val", 2: "double_val", 9: "int64_val", 10: "bool_val",
              19: "half_val", 22: "uint32_val", 23: "uint64_val", 7: "string_val"}


def _floats(w: int, v) -> List[float]:
    if w == 2:
        return np.frombuffer(bytes(v), "<f4").tolist()
    return [struct.unpack("<f", struct.pack("<I", v))[0]]


def _doubles(w: int, v) -> List[float]:
    if w == 2:
        return np.frombuffer(bytes(v), "<f8").tolist()
    return [struct.unpack("<d", struct.pack("<Q", v))[0]]


def _varints(w: int, v) -> List[int]:
    return _packed_varints(v) if w == 2 else [_signed(v)]


class TensorShape:
    """TensorShapeProto: dim sizes (-1 unknown) and unknown_rank."""

    __slots__ = ("dim", "unknown_rank")

    def __init__(self, mv=None):
        self.dim: List[_Dim] = []
        self.unknown_rank = False
        for f, _, v in _fields(mv) if mv is not None else ():
            if f == 2:
                self.dim.append(_Dim(v))
            elif f == 3:
                self.unknown_rank = bool(v)


class _Dim:
    __slots__ = ("size", "name")

    def __init__(self, mv):
        self.size, self.name = 0, ""
        for f, _, v in _fields(mv):
            if f == 1:
                self.size = _signed(v)
            elif f == 2:
                self.name = bytes(v).decode()


class TensorProto:
    """The TensorProto fields that make_ndarray reads."""

    def __init__(self, mv=None):
        self.dtype = 0
        self.tensor_shape = TensorShape()
        self.tensor_content = b""
        self.float_val: List[float] = []
        self.double_val: List[float] = []
        self.int_val: List[int] = []
        self.int64_val: List[int] = []
        self.bool_val: List[bool] = []
        self.half_val: List[int] = []
        self.uint32_val: List[int] = []
        self.uint64_val: List[int] = []
        self.string_val: List[bytes] = []
        for f, w, v in _fields(mv) if mv is not None else ():
            if f == 1:
                self.dtype = v
            elif f == 2:
                self.tensor_shape = TensorShape(v)
            elif f == 4:
                self.tensor_content = bytes(v)
            elif f == 5:
                self.float_val += _floats(w, v)
            elif f == 6:
                self.double_val += _doubles(w, v)
            elif f == 7:
                self.int_val += _varints(w, v)
            elif f == 8:
                self.string_val.append(bytes(v))
            elif f == 10:
                self.int64_val += _varints(w, v)
            elif f == 11:
                self.bool_val += [bool(x) for x in _varints(w, v)]
            elif f == 13:
                self.half_val += _varints(w, v)
            elif f == 16:
                self.uint32_val += _packed_varints(v) if w == 2 else [v]
            elif f == 17:
                self.uint64_val += [x & (2**64 - 1) for x in _varints(w, v)]


def make_ndarray(t: TensorProto) -> np.ndarray:
    """tf.make_ndarray on the port's TensorProto."""
    shape = [d.size for d in t.tensor_shape.dim]
    n = int(np.prod(shape, dtype=np.int64))
    dt = _TF_DT.get(t.dtype)
    if dt is None:
        raise NotImplementedError(f"tf tensor dtype {t.dtype}")
    if t.tensor_content:
        return np.frombuffer(t.tensor_content, np.dtype(dt).newbyteorder("<")).astype(
            dt).reshape(shape)
    vals = getattr(t, _VAL_FIELD.get(t.dtype, "int_val"))
    if t.dtype == 7:
        vals = list(vals) + [vals[-1] if vals else b""] * max(0, n - len(vals))
        return np.array(vals, dtype=object).reshape(shape)
    if t.dtype == 19:
        values = np.asarray(vals, np.uint16).view(np.float16)
    else:
        values = np.asarray(vals).astype(dt) if vals else np.zeros(0, dt)
    if values.size == 0:
        return np.zeros(shape, dt)
    if values.size != n:
        values = np.pad(values, (0, n - values.size), "edge")
    return values.reshape(shape)


class AttrList:
    """AttrValue.ListValue."""

    def __init__(self, mv=None):
        self.s: List[bytes] = []
        self.i: List[int] = []
        self.f: List[float] = []
        self.b: List[bool] = []
        self.type: List[int] = []
        self.shape: List[TensorShape] = []
        self.tensor: List[TensorProto] = []
        for f, w, v in _fields(mv) if mv is not None else ():
            if f == 2:
                self.s.append(bytes(v))
            elif f == 3:
                self.i += _varints(w, v)
            elif f == 4:
                self.f += _floats(w, v)
            elif f == 5:
                self.b += [bool(x) for x in _varints(w, v)]
            elif f == 6:
                self.type += _varints(w, v)
            elif f == 7:
                self.shape.append(TensorShape(v))
            elif f == 8:
                self.tensor.append(TensorProto(v))


class AttrValue:
    """AttrValue; an absent field reads its proto default, as with the
    protobuf classes (so does an absent attr: NodeDef.attr[key])."""

    def __init__(self, mv=None):
        self.list = AttrList()
        self.s = b""
        self.i = 0
        self.f = 0.0
        self.b = False
        self.type = 0
        self.shape = TensorShape()
        self.tensor = TensorProto()
        self.which = None
        for f, w, v in _fields(mv) if mv is not None else ():
            if f == 1:
                self.list, self.which = AttrList(v), "list"
            elif f == 2:
                self.s, self.which = bytes(v), "s"
            elif f == 3:
                self.i, self.which = _signed(v), "i"
            elif f == 4:
                self.f, self.which = _floats(w, v)[0], "f"
            elif f == 5:
                self.b, self.which = bool(v), "b"
            elif f == 6:
                self.type, self.which = v, "type"
            elif f == 7:
                self.shape, self.which = TensorShape(v), "shape"
            elif f == 8:
                self.tensor, self.which = TensorProto(v), "tensor"


class _Attrs(dict):
    def __missing__(self, key):
        return AttrValue()


class NodeDef:
    __slots__ = ("name", "op", "input", "device", "attr")

    def __init__(self, mv):
        self.name, self.op, self.device = "", "", ""
        self.input: List[str] = []
        self.attr: Dict[str, AttrValue] = _Attrs()
        for f, _, v in _fields(mv):
            if f == 1:
                self.name = bytes(v).decode()
            elif f == 2:
                self.op = bytes(v).decode()
            elif f == 3:
                self.input.append(bytes(v).decode())
            elif f == 4:
                self.device = bytes(v).decode()
            elif f == 5:
                key, val = "", None
                for f2, _, v2 in _fields(v):
                    if f2 == 1:
                        key = bytes(v2).decode()
                    elif f2 == 2:
                        val = v2
                self.attr[key] = AttrValue(val)


def parse_graphdef(data: bytes) -> List[NodeDef]:
    """GraphDef bytes -> its nodes, in file order."""
    return [NodeDef(v) for f, _, v in _fields(memoryview(data)) if f == 1]


# ---------------------------------------------------------------------------
# GraphDef -> IR
# ---------------------------------------------------------------------------


def _attr_list(node, name):
    return list(getattr(node.attr[name].list, "i", []))


def _static_shape(g: Graph, tid: int) -> List[int]:
    """The IR shape of tensor `tid`, from the port's shape inference over a
    copy of the graph built so far (the import does not carry shapes)."""
    from ..executor.engine import infer_shapes

    if g.tensors[tid].shape:
        return list(g.tensors[tid].shape)
    h = copy.deepcopy(g)
    h.outputs = [h.tensors[tid].producer]
    infer_shapes(h)
    return list(h.tensors[tid].shape)


def from_tf_graphdef(path_or_bytes, input_shape: Optional[List[int]] = None) -> Graph:
    """Import a frozen GraphDef. input_shape is NCHW (IR convention); when
    absent, the Placeholder's NHWC shape is transposed (unknown dims -> 1).

    Supported ops: Placeholder/Const/Identity, Conv2D,
    DepthwiseConv2dNative, BiasAdd, FusedBatchNorm(V2/V3), Relu/Relu6/
    LeakyRelu/Sigmoid/Tanh/Softmax, MaxPool/AvgPool/Mean(H,W), MatMul,
    Add/AddV2/Mul, ConcatV2, Reshape, Pad, Squeeze, Shape (of a tensor
    whose shape is static).
    """
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        nodes = parse_graphdef(bytes(path_or_bytes))
    else:
        with open(path_or_bytes, "rb") as f:
            nodes = parse_graphdef(f.read())

    g = Graph(name="tf", source_format="tensorflow")
    env: Dict[str, int] = {}
    const_vals: Dict[str, np.ndarray] = {}
    shapes: set = set()  # the consts folded from a Shape

    def const(name: str, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        t = g.add_tensor(name, DType.FP32 if arr.dtype == np.float32 else DType.INT32,
                         list(arr.shape), TensorType.CONST, data=arr)
        return t.idx

    def var(name: str) -> int:
        return g.add_tensor(name, DType.FP32, [], TensorType.VAR).idx

    def emit(op: str, name: str, inputs: List[int], params: Optional[dict] = None) -> int:
        out = var(name)
        g.add_node(op, name, inputs, [out], params=params or {})
        env[name] = out
        return out

    def ref(name: str) -> str:
        # strip :0 port and ^control deps
        return name.split(":")[0].lstrip("^")

    def inp(node, i: int = 0) -> int:
        nm = ref(node.input[i])
        if nm in env:
            return env[nm]
        if nm in const_vals:
            arr = const_vals[nm]
            if getattr(arr, "ndim", 0) == 4:
                # TF consts are NHWC; activations in the IR are NCHW
                arr = np.ascontiguousarray(np.transpose(arr, (0, 3, 1, 2)))
            env[nm] = const(nm, arr)
            return env[nm]
        raise KeyError(f"tf value {nm!r} referenced before definition")

    def cval(node, i: int) -> Optional[np.ndarray]:
        return const_vals.get(ref(node.input[i]))

    def conv_params(node, w_oihw, group):
        strides = list(node.attr["strides"].list.i)  # NHWC
        pad = node.attr["padding"].s.decode()
        pv = -1 if pad == "SAME" else 0
        dil = list(node.attr["dilations"].list.i) or [1, 1, 1, 1]
        return dict(
            kernel_h=int(w_oihw.shape[2]), kernel_w=int(w_oihw.shape[3]),
            stride_h=int(strides[1]), stride_w=int(strides[2]),
            dilation_h=int(dil[1]), dilation_w=int(dil[2]),
            input_channel=int(w_oihw.shape[1] * group),
            output_channel=int(w_oihw.shape[0]),
            group=group, activation=-1,
            pad_h0=pv, pad_h1=pv, pad_w0=pv, pad_w1=pv,
        )

    for node in nodes:
        op = node.op
        name = node.name

        if op == "Const":
            const_vals[name] = make_ndarray(node.attr["value"].tensor)
        elif op == "Placeholder":
            if input_shape:
                shape = list(input_shape)
            else:
                dims = [d.size for d in node.attr["shape"].shape.dim]
                dims = [1 if d < 0 else d for d in (dims or [1, 224, 224, 3])]
                shape = [dims[0], dims[3], dims[1], dims[2]]  # NHWC -> NCHW
            t = g.add_tensor(name, DType.FP32, shape, TensorType.INPUT)
            n = g.add_node("InputOp", name, [], [t.idx])
            g.inputs.append(n.idx)
            env[name] = t.idx
        elif op in ("Identity", "NoOp", "CheckNumerics", "StopGradient"):
            if node.input:
                nm = ref(node.input[0])
                if nm in const_vals:
                    const_vals[name] = const_vals[nm]
                elif nm in env:
                    env[name] = env[nm]
        elif op == "Conv2D":
            w = cval(node, 1)  # HWIO
            w_oihw = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
            emit("Convolution", name, [inp(node, 0), const(f"{name}/w", w_oihw)],
                 conv_params(node, w_oihw, 1))
        elif op == "DepthwiseConv2dNative":
            w = cval(node, 1)  # [kh,kw,C,M]
            kh, kw, C, M = w.shape
            w_oihw = np.ascontiguousarray(
                w.transpose(2, 3, 0, 1).reshape(C * M, 1, kh, kw)
            )
            emit("Convolution", name, [inp(node, 0), const(f"{name}/w", w_oihw)],
                 conv_params(node, w_oihw, C))
        elif op == "BiasAdd":
            # fold into the producing conv when possible, else Eltwise add
            src = g.tensors[inp(node, 0)]
            prod = g.nodes[src.producer] if src.producer is not None else None
            b = cval(node, 1)
            if prod is not None and prod.op in ("Convolution", "FullyConnected") and len(prod.inputs) == 2:
                prod.inputs.append(const(f"{name}/b", b))
                g.tensors[prod.inputs[-1]].consumers.append(prod.idx)
                env[name] = src.idx
            else:
                emit("Eltwise", name, [inp(node, 0), const(f"{name}/b", b)],
                     dict(type=ELT_SUM, caffe_flavor=0, shift=0.0, power=1.0, scale=1.0))
        elif op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            ins = [inp(node, i) for i in range(5)]  # x, gamma, beta, mean, var
            emit("BatchNormalization", name, ins, dict(
                rescale_factor=1.0, eps=float(node.attr["epsilon"].f or 1e-5),
                caffe_flavor=0))
        elif op == "Relu":
            emit("ReLu", name, [inp(node)], dict(negative_slope=0.0))
        elif op == "Relu6":
            emit("ReLu6", name, [inp(node)])
        elif op == "LeakyRelu":
            emit("ReLu", name, [inp(node)],
                 dict(negative_slope=float(node.attr["alpha"].f)))
        elif op == "Sigmoid":
            emit("Sigmoid", name, [inp(node)])
        elif op == "Tanh":
            emit("Tanh", name, [inp(node)])
        elif op == "Softmax":
            emit("Softmax", name, [inp(node)], dict(axis=1))
        elif op in ("MaxPool", "AvgPool"):
            k = list(node.attr["ksize"].list.i)
            s = list(node.attr["strides"].list.i)
            pad = node.attr["padding"].s.decode()
            pv = 0 if pad == "VALID" else -1  # SAME: the IR's TF-SAME pads
            emit("Pooling", name, [inp(node)], dict(
                alg=0 if op == "MaxPool" else 1,
                kernel_h=int(k[1]), kernel_w=int(k[2]),
                stride_h=int(s[1]), stride_w=int(s[2]),
                global_pool=0, caffe_flavor=0,
                pad_h0=pv, pad_h1=pv, pad_w0=pv, pad_w1=pv))
        elif op == "Mean":
            axes = cval(node, 1)
            if axes is not None and sorted(int(a) for a in np.asarray(axes).reshape(-1)) == [1, 2]:
                emit("Pooling", name, [inp(node, 0)], dict(
                    alg=1, kernel_h=0, kernel_w=0, stride_h=1, stride_w=1,
                    global_pool=1, caffe_flavor=0,
                    pad_h0=0, pad_h1=0, pad_w0=0, pad_w1=0))
                if not node.attr["keep_dims"].b:
                    prev = env[name]
                    emit("Flatten", f"{name}/flat", [prev], dict(axis=1, end_axis=-1))
                    env[name] = env[f"{name}/flat"]
            else:
                raise NotImplementedError("tf Mean over non-HW axes")
        elif op == "MatMul":
            w = cval(node, 1)
            if w is None:
                raise NotImplementedError("MatMul with non-const rhs")
            if not node.attr["transpose_b"].b:
                w = np.ascontiguousarray(w.T)  # -> [out, in]
            emit("FullyConnected", name, [inp(node, 0), const(f"{name}/w", w)],
                 dict(num_output=int(w.shape[0])))
        elif op in ("Add", "AddV2", "Mul", "Sub", "RealDiv", "Pow", "Minimum",
                    "Maximum"):
            from ..serializer.tm2.format import ELT_DIV, ELT_MAX, ELT_POW, ELT_SUB

            if op == "Minimum":
                emit("Minimum", name, [inp(node, 0), inp(node, 1)])
            else:
                emap = {"Add": ELT_SUM, "AddV2": ELT_SUM, "Mul": ELT_PROD,
                        "Sub": ELT_SUB, "RealDiv": ELT_DIV, "Pow": ELT_POW,
                        "Maximum": ELT_MAX}
                ins = []
                for i in range(2):
                    nm = ref(node.input[i])
                    ins.append(env[nm] if nm in env else inp(node, i))
                emit("Eltwise", name, ins, dict(
                    type=emap[op],
                    caffe_flavor=0, shift=0.0, power=1.0, scale=1.0))
        elif op == "AddN":
            ins = [inp(node, i) for i in range(len(node.input))]
            emit("Addn", name, ins, dict(axis=0))
        elif op in ("Exp", "Log", "Sqrt", "Rsqrt", "Abs", "Neg", "Floor",
                    "Ceil", "Square", "Sin", "Cos", "Reciprocal"):
            # unary_param.h types (the reference maps these to OP_ELTWISE;
            # our Unary op carries the same math)
            tmap = {"Abs": 0, "Neg": 1, "Floor": 2, "Ceil": 3, "Square": 4,
                    "Sqrt": 5, "Rsqrt": 6, "Exp": 7, "Log": 8, "Sin": 9,
                    "Cos": 10, "Reciprocal": 15}
            emit("Unary", name, [inp(node, 0)], dict(type=tmap[op]))
        elif op == "ConcatV2":
            n_in = len(node.input) - 1  # last input is the axis
            axis = int(np.asarray(cval(node, n_in)).reshape(()))
            # NHWC axis -> NCHW axis
            axis = {0: 0, 1: 2, 2: 3, 3: 1}.get(axis, axis)
            emit("Concat", name, [inp(node, i) for i in range(n_in)], dict(axis=axis))
        elif op == "Reshape":
            shape = [int(v) for v in np.asarray(cval(node, 1)).reshape(-1)]
            if ref(node.input[1]) in shapes:
                # a Shape folded at the import's batch: the batch is the
                # input's (0 copies it), so that the graph runs at any batch
                shape[0] = 0
            reshape_nhwc(g, emit, name, inp(node, 0), shape)
        elif op == "Shape":
            sh = _static_shape(g, inp(node, 0))
            if len(sh) == 4:
                sh = [sh[0], sh[2], sh[3], sh[1]]  # NCHW -> TF's NHWC
            const_vals[name] = np.asarray(sh, np.int32)
            shapes.add(name)
        elif op == "Squeeze":
            src = inp(node, 0)
            sh = _static_shape(g, src)
            tf_sh = [sh[0], sh[2], sh[3], sh[1]] if len(sh) == 4 else sh
            dims = sorted({int(d) % len(sh) for d in _attr_list(node, "squeeze_dims")}
                          or {k for k, d in enumerate(tf_sh) if d == 1})
            if len(sh) == 4:
                kept = [k for k in range(4) if k not in dims]
                if 3 in kept and (1 in kept or 2 in kept):
                    # C kept beside H or W: the NCHW squeeze would not keep
                    # TF's order of them
                    src = emit("Transpose", f"{name}/nhwc", [src], dict(perm=[0, 2, 3, 1]))
                else:
                    dims = [(0, 2, 3, 1)[d] for d in dims]  # NHWC axis -> NCHW axis
            emit("Squeeze", name, [src], {f"dim_{k}": int(k in dims) for k in range(4)})
        elif op == "Pad":
            pads = np.asarray(cval(node, 1)).reshape(-1, 2)  # NHWC rows
            emit("Pad", name, [inp(node, 0)], dict(
                mode=0, value=0.0,
                pad_n_0=int(pads[0, 0]), pad_n_1=int(pads[0, 1]),
                pad_c_0=int(pads[3, 0]), pad_c_1=int(pads[3, 1]),
                pad_h_0=int(pads[1, 0]), pad_h_1=int(pads[1, 1]),
                pad_w_0=int(pads[2, 0]), pad_w_1=int(pads[2, 1])))
        else:
            raise NotImplementedError(f"tf op {op!r} (node {name!r})")

    # graph outputs: nodes whose output nothing consumes
    consumed = set()
    for n in g.nodes:
        consumed.update(n.inputs)
    for n in g.nodes:
        if n.op in ("InputOp",) or not n.outputs:
            continue
        if not any(t in consumed for t in n.outputs):
            g.outputs.append(n.idx)
    return g


def reshape_nhwc(g: Graph, emit, name: str, src: int, shape: List[int],
                 src_shape: Optional[List[int]] = None) -> int:
    """A source-format (NHWC) Reshape of IR tensor `src` to `shape`. A rank-4
    input with H*W > 1 is transposed to NHWC first, so that the flatten
    follows the source's order, and a rank-4 result back to NCHW; otherwise
    the Reshape is emitted as the reference emits it. `emit(op, name, ins,
    params)` adds a node with one output named `name` and returns it;
    `src_shape` is the input's NCHW shape where the caller knows it."""
    params = dict(shape=shape, is_onnx=1, is_mxnet=0, reverse=0)
    if g.tensors[src].data is None:
        sh = src_shape if src_shape is not None else _static_shape(g, src)
        if len(sh) == 4 and sh[2] * sh[3] > 1:
            t = emit("Transpose", f"{name}/nhwc", [src], dict(perm=[0, 2, 3, 1]))
            if len(shape) != 4:
                return emit("Reshape", name, [t], params)
            t = emit("Reshape", f"{name}/reshape", [t], params)
            return emit("Transpose", name, [t], dict(perm=[0, 3, 1, 2]))
    return emit("Reshape", name, [src], params)
