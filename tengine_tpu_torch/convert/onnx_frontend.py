"""ONNX front-end: .onnx file -> IR Graph (convert_tool onnx2tengine.cpp
equivalent, tools/convert_tool/onnx/onnx2tengine.cpp in the reference).

The environment has no `onnx` package, so this module decodes the ONNX
protobuf wire format directly — a ~150-line reader for the stable subset of
the schema we need (ModelProto/GraphProto/NodeProto/AttributeProto/
TensorProto/ValueInfoProto). Field numbers follow the public onnx.proto3
schema, which has been wire-stable since IR version 3.

Layout convention matches tmfile: NCHW activations, conv weights
[O, I/g, kH, kW] — identical to ONNX's, so weights import zero-copy.

PyTorch port: a copy of tengine_tpu/convert/onnx_frontend.py (numpy and
struct only), so both packages build identical IR from one ModelProto. Its
wire-format reader (_fields, _signed, _packed_varints) is also the base of
the port's Caffe and TF front ends.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..graph.ir import DType, Graph, TensorType
from ..serializer.tm2.format import ELT_SUM, ELT_SUB, ELT_PROD, ELT_DIV

# ---------------------------------------------------------------------------
# Protobuf wire-format reader
# ---------------------------------------------------------------------------


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) for one serialized message.
    value is int for varint/fixed, memoryview for length-delimited."""
    i, n = 0, len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, v
        elif wire == 1:  # 64-bit
            yield field, wire, int.from_bytes(buf[i : i + 8], "little")
            i += 8
        elif wire == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, buf[i : i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            yield field, wire, int.from_bytes(buf[i : i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(mv: memoryview) -> List[int]:
    out, i, n = [], 0, len(mv)
    while i < n:
        v = 0
        shift = 0
        while True:
            b = mv[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        out.append(_signed(v))
    return out


_ONNX_DT = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(mv: memoryview) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray)."""
    dims: List[int] = []
    dtype = 1
    raw: Optional[memoryview] = None
    floats: List[float] = []
    i32: List[int] = []
    i64: List[int] = []
    dbl: List[float] = []
    name = ""
    for f, w, v in _fields(mv):
        if f == 1:
            dims.extend(_packed_varints(v) if w == 2 else [_signed(v)])
        elif f == 2:
            dtype = v
        elif f == 4:
            if w == 2:
                floats.extend(np.frombuffer(v, "<f4").tolist())
            else:
                floats.append(struct.unpack("<f", struct.pack("<I", v))[0])
        elif f == 5:
            i32.extend(_packed_varints(v) if w == 2 else [_signed(v)])
        elif f == 7:
            i64.extend(_packed_varints(v) if w == 2 else [_signed(v)])
        elif f == 8:
            name = bytes(v).decode()
        elif f == 9:
            raw = v
        elif f == 10:
            if w == 2:
                dbl.extend(np.frombuffer(v, "<f8").tolist())
            else:
                dbl.append(struct.unpack("<d", struct.pack("<Q", v))[0])
    np_dt = _ONNX_DT.get(dtype)
    if np_dt is None:
        raise NotImplementedError(f"ONNX tensor dtype {dtype}")
    if raw is not None:
        arr = np.frombuffer(bytes(raw), np_dt)
    elif floats:
        arr = np.asarray(floats, np_dt)
    elif i64:
        arr = np.asarray(i64, np_dt)
    elif i32:
        # int32_data stores int32/int16/int8/uint8/bool element-wise
        arr = np.asarray(i32).astype(np_dt)
    elif dbl:
        arr = np.asarray(dbl, np_dt)
    else:
        arr = np.zeros(0, np_dt)
    return name, arr.reshape(dims) if dims else arr


def _parse_attr(mv: memoryview) -> Tuple[str, Any]:
    """AttributeProto -> (name, python value)."""
    name = ""
    val: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for f, w, v in _fields(mv):
        if f == 1:
            name = bytes(v).decode()
        elif f == 2:
            val = struct.unpack("<f", struct.pack("<I", v))[0]
        elif f == 3:
            val = _signed(v)
        elif f == 4:
            val = bytes(v).decode(errors="replace")
        elif f == 5:
            val = _parse_tensor(v)[1]
        elif f == 7:
            floats.extend(
                np.frombuffer(v, "<f4").tolist()
                if w == 2
                else [struct.unpack("<f", struct.pack("<I", v))[0]]
            )
        elif f == 8:
            ints.extend(_packed_varints(v) if w == 2 else [_signed(v)])
        elif f == 9:
            strings.append(bytes(v))
    if floats:
        val = floats
    elif ints:
        val = ints
    elif strings:
        val = [s.decode() for s in strings]
    return name, val


def _parse_value_info(mv: memoryview) -> Tuple[str, List[int]]:
    """ValueInfoProto -> (name, shape) with dim_param/zero dims -> -1."""
    name = ""
    shape: List[int] = []
    for f, _, v in _fields(mv):
        if f == 1:
            name = bytes(v).decode()
        elif f == 2:  # TypeProto
            for f2, _, v2 in _fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 2:  # TensorShapeProto
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # Dimension
                                    dim = -1
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim = _signed(v5)
                                    shape.append(dim)
    return name, shape


class _OnnxNode:
    __slots__ = ("op", "name", "inputs", "outputs", "attrs")

    def __init__(self, mv: memoryview):
        self.op = ""
        self.name = ""
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.attrs: Dict[str, Any] = {}
        for f, _, v in _fields(mv):
            if f == 1:
                self.inputs.append(bytes(v).decode())
            elif f == 2:
                self.outputs.append(bytes(v).decode())
            elif f == 3:
                self.name = bytes(v).decode()
            elif f == 4:
                self.op = bytes(v).decode()
            elif f == 5:
                k, val = _parse_attr(v)
                self.attrs[k] = val


def _parse_graph(mv: memoryview):
    nodes: List[_OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    g_in: List[Tuple[str, List[int]]] = []
    g_out: List[str] = []
    name = ""
    for f, _, v in _fields(mv):
        if f == 1:
            nodes.append(_OnnxNode(v))
        elif f == 2:
            name = bytes(v).decode()
        elif f == 5:
            k, arr = _parse_tensor(v)
            inits[k] = arr
        elif f == 11:
            g_in.append(_parse_value_info(v))
        elif f == 12:
            g_out.append(_parse_value_info(v)[0])
    return name, nodes, inits, g_in, g_out


def parse_onnx(data: bytes):
    """ModelProto bytes -> (graph_name, nodes, initializers, inputs, outputs,
    opset)."""
    opset = 0
    graph = None
    for f, _, v in _fields(memoryview(data)):
        if f == 7:
            graph = v
        elif f == 8:  # OperatorSetIdProto
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    opset = max(opset, _signed(v2))
    if graph is None:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    return (*_parse_graph(graph), opset)


# ---------------------------------------------------------------------------
# ONNX graph -> IR
# ---------------------------------------------------------------------------


def from_onnx(path_or_bytes, input_shape: Optional[List[int]] = None) -> Graph:
    """Import an ONNX model into the IR.

    Supported op set mirrors what the reference's onnx2tengine.cpp handles
    for the model families in BASELINE (conv/pool/gemm/matmul/activations/
    eltwise/concat/reshape/flatten/transpose/resize/bn/clip/reduce-mean/
    pad/dropout/constant/identity/split-free paths).
    """
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
    gname, nodes, inits, g_in, g_out, opset = parse_onnx(data)

    g = Graph(name=gname or "onnx", source_format="onnx")
    env: Dict[str, int] = {}  # onnx value name -> IR tensor idx
    const_vals: Dict[str, np.ndarray] = dict(inits)  # foldable values

    def const(name: str, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        if arr.dtype in (np.int64, np.float64):
            arr = arr.astype(np.int32 if arr.dtype == np.int64 else np.float32)
        dt = {np.dtype(np.float32): DType.FP32, np.dtype(np.int32): DType.INT32,
              np.dtype(np.int8): DType.INT8, np.dtype(np.uint8): DType.UINT8,
              np.dtype(np.float16): DType.FP16}.get(arr.dtype, DType.FP32)
        if dt == DType.FP32 and arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        t = g.add_tensor(name, dt, list(arr.shape), TensorType.CONST, data=arr)
        return t.idx

    def var(name: str) -> int:
        return g.add_tensor(name, DType.FP32, [], TensorType.VAR).idx

    def emit(op: str, name: str, inputs: List[int], out_names: List[str],
             params: Optional[dict] = None) -> None:
        outs = [var(o) for o in out_names]
        g.add_node(op, name or out_names[0], inputs, outs, params=params or {})
        for nm, t in zip(out_names, outs):
            env[nm] = t

    def inp(node: _OnnxNode, i: int = 0) -> int:
        nm = node.inputs[i]
        if nm in env:
            return env[nm]
        if nm in const_vals:
            env[nm] = const(nm, const_vals[nm])
            return env[nm]
        raise KeyError(f"ONNX value {nm!r} referenced before definition")

    def cval(node: _OnnxNode, i: int) -> Optional[np.ndarray]:
        nm = node.inputs[i] if i < len(node.inputs) else ""
        return const_vals.get(nm)

    # graph inputs (skip initializer-backed ones)
    for nm, shape in g_in:
        if nm in inits:
            continue
        shape = list(input_shape) if input_shape else [1 if d < 0 else d for d in shape]
        t = g.add_tensor(nm, DType.FP32, shape, TensorType.INPUT)
        n = g.add_node("InputOp", nm, [], [t.idx])
        g.inputs.append(n.idx)
        env[nm] = t.idx

    eltmap = {"Add": ELT_SUM, "Sub": ELT_SUB, "Mul": ELT_PROD, "Div": ELT_DIV}

    # breadth-tier static tables (unary_param.h types; comparison.c types;
    # Reduction types per the reference RUNTIME dispatch — see
    # ops/lowering.py:lower_reduction)
    _UNARY_MAP = {
        "Abs": 0, "Neg": 1, "Floor": 2, "Ceil": 3, "Sqrt": 5, "Exp": 7,
        "Log": 8, "Sin": 9, "Cos": 10, "Tan": 11, "Asin": 12, "Acos": 13,
        "Atan": 14, "Reciprocal": 15, "Round": None,
    }
    _UNARY_MAP = {k: v for k, v in _UNARY_MAP.items() if v is not None}
    _CMP_MAP = {"Equal": 0, "Greater": 2, "GreaterOrEqual": 3, "Less": 4,
                "LessOrEqual": 5}
    _REDUCE_MAP = {"ReduceSum": 0, "ReduceMean": 1, "ReduceL1": 2,
                   "ReduceSumSquare": 3, "ReduceMax": 4, "ReduceMin": 5,
                   "ReduceProd": 6, "ReduceLogSum": 9, "ReduceLogSumExp": 10}
    # ONNX TensorProto dtype -> TM2 dtype enum (FP32=0 FP16=1 INT8=2 UINT8=3
    # INT32=4)
    _CAST_DT = {1: 0, 10: 1, 3: 2, 2: 3, 6: 4, 7: 4, 9: 4}

    for nd in nodes:
        op, a = nd.op, nd.attrs
        name = nd.name or nd.outputs[0]

        if op == "Constant":
            arr = a.get("value")
            if arr is None:
                arr = np.asarray(a.get("value_float", a.get("value_int", 0)), np.float32)
            const_vals[nd.outputs[0]] = np.asarray(arr)
            continue
        if op in ("Identity", "Dropout"):
            if nd.inputs[0] in const_vals and nd.inputs[0] not in env:
                const_vals[nd.outputs[0]] = const_vals[nd.inputs[0]]
            else:
                emit("Dropout", name, [inp(nd)], [nd.outputs[0]])
            continue

        if op == "Conv" or op == "ConvTranspose":
            w = cval(nd, 1)
            if w is None:
                raise NotImplementedError(f"{op} with non-const weights")
            kh, kw = (a.get("kernel_shape") or list(w.shape[2:]))[:2]
            sh, sw = (a.get("strides") or [1, 1])[:2]
            dh, dw_ = (a.get("dilations") or [1, 1])[:2]
            pads = a.get("pads") or [0, 0, 0, 0]
            grp = int(a.get("group", 1))
            if a.get("auto_pad") in ("SAME_UPPER", "SAME_LOWER"):
                pads = [-1, -1, -1, -1]
            ins = [inp(nd, 0), inp(nd, 1)]
            if len(nd.inputs) > 2 and nd.inputs[2]:
                ins.append(inp(nd, 2))
            if op == "Conv":
                emit("Convolution", name, ins, [nd.outputs[0]], dict(
                    kernel_h=int(kh), kernel_w=int(kw), stride_h=int(sh),
                    stride_w=int(sw), dilation_h=int(dh), dilation_w=int(dw_),
                    input_channel=int(w.shape[1] * grp), output_channel=int(w.shape[0]),
                    group=grp, activation=-1,
                    pad_h0=int(pads[0]), pad_w0=int(pads[1]),
                    pad_h1=int(pads[2]), pad_w1=int(pads[3])))
            else:
                emit("Deconvolution", name, ins, [nd.outputs[0]], dict(
                    kernel_h=int(kh), kernel_w=int(kw), stride_h=int(sh),
                    stride_w=int(sw), dilation_h=int(dh), dilation_w=int(dw_),
                    num_output=int(w.shape[1] * grp), group=grp, activation=-1,
                    pad_h0=int(pads[0]), pad_w0=int(pads[1]),
                    pad_h1=int(pads[2]), pad_w1=int(pads[3]),
                    output_pad_h0=int((a.get("output_padding") or [0, 0])[0]),
                    output_pad_w0=int((a.get("output_padding") or [0, 0])[1])))
        elif op == "Gemm":
            w = cval(nd, 1)
            if w is None:
                raise NotImplementedError("Gemm with non-const B")
            if not int(a.get("transB", 0)):
                w = np.ascontiguousarray(w.T)
            if int(a.get("transA", 0)):
                raise NotImplementedError("Gemm transA")
            ins = [inp(nd, 0), const(f"{name}/w", w * float(a.get("alpha", 1.0)))]
            if len(nd.inputs) > 2:
                ins.append(const(f"{name}/b", cval(nd, 2) * float(a.get("beta", 1.0))))
            emit("FullyConnected", name, ins, [nd.outputs[0]],
                 dict(num_output=int(w.shape[0])))
        elif op == "MatMul":
            w = cval(nd, 1)
            if w is None or w.ndim != 2:
                raise NotImplementedError("MatMul with non-const / non-2D rhs")
            emit("FullyConnected", name,
                 [inp(nd, 0), const(f"{name}/w", np.ascontiguousarray(w.T))],
                 [nd.outputs[0]], dict(num_output=int(w.shape[1])))
        elif op in ("Relu", "LeakyRelu"):
            emit("ReLu", name, [inp(nd)], [nd.outputs[0]],
                 dict(negative_slope=float(a.get("alpha", 0.0))))
        elif op == "Clip":
            lo = a.get("min", cval(nd, 1))
            hi = a.get("max", cval(nd, 2))
            lo = float(np.asarray(lo).reshape(()) if lo is not None else -np.inf)
            hi = float(np.asarray(hi).reshape(()) if hi is not None else np.inf)
            if lo == 0.0 and hi == 6.0:
                emit("ReLu6", name, [inp(nd)], [nd.outputs[0]])
            else:
                emit("Clip", name, [inp(nd)], [nd.outputs[0]], dict(min=lo, max=hi))
        elif op == "Sigmoid":
            emit("Sigmoid", name, [inp(nd)], [nd.outputs[0]])
        elif op == "Tanh":
            emit("Tanh", name, [inp(nd)], [nd.outputs[0]])
        elif op == "HardSwish":
            emit("HardSwish", name, [inp(nd)], [nd.outputs[0]],
                 dict(alpha=1.0 / 6.0, beta=0.5))
        elif op == "HardSigmoid":
            emit("Hardsigmoid", name, [inp(nd)], [nd.outputs[0]],
                 dict(alpha=float(a.get("alpha", 0.2)), beta=float(a.get("beta", 0.5))))
        elif op == "Elu":
            emit("Elu", name, [inp(nd)], [nd.outputs[0]],
                 dict(alpha=float(a.get("alpha", 1.0))))
        elif op == "Softmax":
            emit("Softmax", name, [inp(nd)], [nd.outputs[0]],
                 dict(axis=int(a.get("axis", -1))))
        elif op == "BatchNormalization":
            ins = [inp(nd, i) for i in range(5)]
            emit("BatchNormalization", name, ins, [nd.outputs[0]], dict(
                rescale_factor=1.0, eps=float(a.get("epsilon", 1e-5)), caffe_flavor=0))
        elif op in ("MaxPool", "AveragePool"):
            kh, kw = a["kernel_shape"][:2]
            sh, sw = (a.get("strides") or [1, 1])[:2]
            pads = a.get("pads") or [0, 0, 0, 0]
            caffe = 1 if int(a.get("ceil_mode", 0)) else 0
            if op == "AveragePool" and int(a.get("count_include_pad", 0)):
                caffe |= 0x10
            emit("Pooling", name, [inp(nd)], [nd.outputs[0]], dict(
                alg=0 if op == "MaxPool" else 1, kernel_h=int(kh), kernel_w=int(kw),
                stride_h=int(sh), stride_w=int(sw), global_pool=0, caffe_flavor=caffe,
                pad_h0=int(pads[0]), pad_w0=int(pads[1]),
                pad_h1=int(pads[2]), pad_w1=int(pads[3])))
        elif op in ("GlobalAveragePool", "GlobalMaxPool") or (
            op == "ReduceMean" and sorted(a.get("axes", [])) == [2, 3]
        ):
            emit("Pooling", name, [inp(nd)], [nd.outputs[0]], dict(
                alg=1 if op != "GlobalMaxPool" else 0, kernel_h=0, kernel_w=0,
                stride_h=1, stride_w=1, global_pool=1, caffe_flavor=0,
                pad_h0=0, pad_h1=0, pad_w0=0, pad_w1=0))
        elif op in eltmap:
            # const scalar/vector operand -> keep as const input
            ins = []
            for i in range(2):
                nm = nd.inputs[i]
                ins.append(env[nm] if nm in env else inp(nd, i))
            emit("Eltwise", name, ins, [nd.outputs[0]], dict(
                type=eltmap[op], caffe_flavor=0, shift=0.0, power=1.0, scale=1.0))
        elif op == "Concat":
            ins = [inp(nd, i) for i in range(len(nd.inputs))]
            emit("Concat", name, ins, [nd.outputs[0]], dict(axis=int(a.get("axis", 1))))
        elif op == "Reshape":
            shape = a.get("shape") or cval(nd, 1)
            if shape is None:
                raise NotImplementedError("Reshape with dynamic shape input")
            emit("Reshape", name, [inp(nd, 0)], [nd.outputs[0]], dict(
                shape=[int(s) for s in np.asarray(shape).reshape(-1)],
                is_onnx=1, is_mxnet=0, reverse=0))
        elif op == "Flatten":
            emit("Flatten", name, [inp(nd)], [nd.outputs[0]],
                 dict(axis=int(a.get("axis", 1)), end_axis=-1))
        elif op in ("Squeeze", "Unsqueeze"):
            axes = a.get("axes") or (cval(nd, 1) if len(nd.inputs) > 1 else None)
            axes = [int(x) for x in np.asarray(axes).reshape(-1)] if axes is not None else []
            emit(op, name, [inp(nd, 0)], [nd.outputs[0]], dict(axes=axes))
        elif op == "Transpose":
            emit("Transpose", name, [inp(nd)], [nd.outputs[0]],
                 dict(perm=[int(p) for p in a.get("perm", [])]))
        elif op in ("Upsample", "Resize"):
            scales = a.get("scales")
            if scales is None:
                for i in range(1, len(nd.inputs)):
                    v = cval(nd, i)
                    if v is not None and v.size == 4 and v.dtype.kind == "f":
                        scales = v
                        break
            sf = float(np.asarray(scales).reshape(-1)[-1]) if scales is not None else 2.0
            mode = a.get("mode", "nearest")
            if mode == "nearest":
                emit("Upsample", name, [inp(nd, 0)], [nd.outputs[0]], dict(scale=sf))
            else:
                emit("Interp", name, [inp(nd, 0)], [nd.outputs[0]], dict(
                    resize_type=2, width_scale=sf, height_scale=sf,
                    output_width=0, output_height=0))
        elif op == "Pad":
            pads = a.get("pads") or cval(nd, 1)
            pads = [int(p) for p in np.asarray(pads).reshape(-1)]
            cv = a.get("value", 0.0)
            if len(nd.inputs) > 2:
                cvv = cval(nd, 2)
                if cvv is not None:
                    cv = float(np.asarray(cvv).reshape(-1)[0])
            mode = {"constant": 0, "edge": 1, "reflect": 2}[a.get("mode", "constant")]
            rank = len(pads) // 2
            names = ["n", "c", "h", "w"][:rank]
            pp = {}
            for di, axn in enumerate(names):
                pp[f"pad_{axn}_0"] = pads[di]
                pp[f"pad_{axn}_1"] = pads[rank + di]
            for axn in ["n", "c", "h", "w"][rank:]:
                pp[f"pad_{axn}_0"] = pp[f"pad_{axn}_1"] = 0
            emit("Pad", name, [inp(nd, 0)], [nd.outputs[0]],
                 dict(mode=mode, value=float(cv), **pp))
        elif op == "Slice":
            starts = [int(x) for x in np.asarray(a.get("starts") if a.get("starts") is not None else cval(nd, 1)).reshape(-1)]
            ends = [int(x) for x in np.asarray(a.get("ends") if a.get("ends") is not None else cval(nd, 2)).reshape(-1)]
            axes_v = a.get("axes")
            if axes_v is None and len(nd.inputs) > 3:
                axes_v = cval(nd, 3)
            axes = ([int(x) for x in np.asarray(axes_v).reshape(-1)]
                    if axes_v is not None else list(range(len(starts))))
            steps_v = cval(nd, 4) if len(nd.inputs) > 4 else None
            steps = ([int(x) for x in np.asarray(steps_v).reshape(-1)]
                     if steps_v is not None else [1] * len(starts))
            if len(axes) == 1:
                emit("Slice", name, [inp(nd, 0)], [nd.outputs[0]], dict(
                    axis=axes[0], begin=starts[0], end=min(ends[0], 2**31 - 1),
                    step=steps[0], iscaffe=0, ismxnet=0, isonnx=1))
            else:
                if any(s != 1 for s in steps):
                    raise NotImplementedError("multi-axis ONNX Slice with steps")
                rank = max(axes) + 1
                begins, sizes = [0] * rank, [-1] * rank
                for ax, st, en in zip(axes, starts, ends):
                    if en >= 2**31 and st != 0:
                        raise NotImplementedError("open-ended multi-axis Slice")
                    begins[ax] = st
                    sizes[ax] = -1 if en >= 2**31 else en - st
                emit("Slice", name, [inp(nd, 0)], [nd.outputs[0]], dict(
                    begins=begins, sizes=sizes, iscaffe=0, ismxnet=0, isonnx=1))
        # --- breadth tier: the rest of onnx2tengine.cpp's op_load_map ------
        elif op in _UNARY_MAP:
            emit("Unary", name, [inp(nd)], [nd.outputs[0]],
                 dict(type=_UNARY_MAP[op]))
        elif op == "Round":
            emit("Round", name, [inp(nd)], [nd.outputs[0]])
        elif op == "Softplus":
            emit("Softplus", name, [inp(nd)], [nd.outputs[0]])
        elif op == "Selu":
            emit("Selu", name, [inp(nd)], [nd.outputs[0]],
                 dict(alpha=float(a.get("alpha", 1.67326)),
                      lambda_=float(a.get("gamma", 1.0507))))
        elif op == "Gelu":
            emit("Gelu", name, [inp(nd)], [nd.outputs[0]])
        elif op == "Mish":
            emit("Mish", name, [inp(nd)], [nd.outputs[0]])
        elif op == "PRelu":
            emit("PReLU", name, [inp(nd, 0), inp(nd, 1)], [nd.outputs[0]])
        elif op == "LogSoftmax":
            emit("LogSoftmax", name, [inp(nd)], [nd.outputs[0]],
                 dict(axis=int(a.get("axis", -1))))
        elif op == "Pow":
            emit("Eltwise", name, [inp(nd, 0), inp(nd, 1)], [nd.outputs[0]],
                 dict(type=16, caffe_flavor=0, shift=0.0, power=1.0, scale=1.0))
        elif op in ("Min", "Max"):
            kind = "Minimum" if op == "Min" else "Maximum"
            acc = inp(nd, 0)
            for i in range(1, len(nd.inputs)):
                out_nm = nd.outputs[0] if i == len(nd.inputs) - 1 else f"{name}/{kind}{i}"
                emit(kind, f"{name}/{i}", [acc, inp(nd, i)], [out_nm])
                acc = env[out_nm]
        elif op == "Mean":
            emit("Mean", name, [inp(nd, i) for i in range(len(nd.inputs))],
                 [nd.outputs[0]])
        elif op == "Sum":
            acc = inp(nd, 0)
            for i in range(1, len(nd.inputs)):
                out_nm = nd.outputs[0] if i == len(nd.inputs) - 1 else f"{name}/sum{i}"
                emit("Eltwise", f"{name}/{i}", [acc, inp(nd, i)], [out_nm],
                     dict(type=ELT_SUM, caffe_flavor=0, shift=0.0, power=1.0,
                          scale=1.0))
                acc = env[out_nm]
        elif op in ("And", "Or"):
            emit("Logical", name, [inp(nd, 0), inp(nd, 1)], [nd.outputs[0]],
                 dict(type=0 if op == "And" else 1))
        elif op in _CMP_MAP:
            emit("Comparison", name, [inp(nd, 0), inp(nd, 1)], [nd.outputs[0]],
                 dict(type=_CMP_MAP[op]))
        elif op == "Where":
            emit("Where", name, [inp(nd, i) for i in range(3)], [nd.outputs[0]])
        elif op in _REDUCE_MAP or op == "ReduceL2":
            axes = a.get("axes")
            if axes is None and len(nd.inputs) > 1:  # opset >= 18 axes input
                av = cval(nd, 1)
                axes = [int(x) for x in np.asarray(av).reshape(-1)] if av is not None else None
            axes = [int(x) for x in np.asarray(axes).reshape(-1)] if axes is not None else []
            keep = int(a.get("keepdims", 1))
            if op == "ReduceL2":
                # true L2 norm — the tmfile Reduction type 8 is NOT an L2
                # (reduction_kernel_ref.h computes sum|x| there); use the
                # dedicated ReduceL2 op
                if len(axes) != 1:
                    raise NotImplementedError("ReduceL2 with multiple axes")
                emit("ReduceL2", name, [inp(nd)], [nd.outputs[0]],
                     dict(axis=axes[0], keepdim=keep))
            else:
                dims = (axes + [-2] * 4)[:4]
                emit("Reduction", name, [inp(nd)], [nd.outputs[0]], dict(
                    dim_0=dims[0], dim_1=dims[1], dim_2=dims[2], dim_3=dims[3],
                    type=_REDUCE_MAP[op], keepdim=keep))
        elif op in ("ArgMax", "ArgMin"):
            emit(op, name, [inp(nd)], [nd.outputs[0]], dict(
                axis=int(a.get("axis", 0)), keepdims=int(a.get("keepdims", 1))))
        elif op == "Cast":
            emit("Cast", name, [inp(nd)], [nd.outputs[0]], dict(
                type_from=0, type_to=int(_CAST_DT.get(int(a.get("to", 1)), 0))))
        elif op in ("DepthToSpace", "SpaceToDepth"):
            emit(op, name, [inp(nd)], [nd.outputs[0]], dict(
                block_size=int(a["blocksize"]), mode=a.get("mode", "DCR")))
        elif op == "Expand":
            shp = cval(nd, 1)
            if shp is None:
                raise NotImplementedError("Expand with dynamic shape")
            emit("Expand", name, [inp(nd, 0)], [nd.outputs[0]], dict(
                shape=[int(s) for s in np.asarray(shp).reshape(-1)]))
        elif op == "Gather":
            idx_c = cval(nd, 1)
            ins = [inp(nd, 0)]
            if nd.inputs[1] in env:
                ins.append(env[nd.inputs[1]])
            else:
                ins.append(const(f"{name}/indices",
                                 np.asarray(idx_c).astype(np.int32)))
            emit("Gather", name, ins, [nd.outputs[0]], dict(
                axis=int(a.get("axis", 0)),
                indices_num=int(np.asarray(idx_c).size) if idx_c is not None else 0,
                is_onnx=1))
        elif op == "Tile":
            reps = cval(nd, 1)
            if reps is None:
                raise NotImplementedError("Tile with dynamic repeats")
            reps = [int(r) for r in np.asarray(reps).reshape(-1)]
            # IR Tile stores reps REVERSED (tile_ref.c: reps[0] repeats the
            # last axis); frame_flag 1 = onnx block-tile
            emit("Tile", name, [inp(nd, 0)], [nd.outputs[0]],
                 dict(frame_flag=1, reps=list(reversed(reps))))
        elif op in ("Scatter", "ScatterElements"):
            emit("Scatter", name, [inp(nd, i) for i in range(3)],
                 [nd.outputs[0]], dict(axis=int(a.get("axis", 0)), is_onnx=1))
        elif op == "Shape":
            emit("Shape", name, [inp(nd)], [nd.outputs[0]])
        elif op == "InstanceNormalization":
            emit("InstanceNorm", name, [inp(nd, i) for i in range(3)],
                 [nd.outputs[0]], dict(eps=float(a.get("epsilon", 1e-5))))
        elif op == "LRN":
            emit("LRN", name, [inp(nd)], [nd.outputs[0]], dict(
                local_size=int(a.get("size", 5)),
                alpha=float(a.get("alpha", 1e-4)),
                beta=float(a.get("beta", 0.75)), norm_region=0,
                k=float(a.get("bias", 1.0)), bias=float(a.get("bias", 1.0)),
                is_onnx=1))
        elif op == "LayerNormalization" or op == "LayerNorm":
            if int(a.get("axis", -1)) not in (-1,):
                raise NotImplementedError("LayerNormalization with axis != -1")
            ins = [inp(nd, i) for i in range(min(3, len(nd.inputs)))]
            emit("LayerNorm", name, ins, [nd.outputs[0]],
                 dict(eps=float(a.get("epsilon", 1e-5))))
        elif op == "Split":
            sizes = a.get("split")
            if sizes is None and len(nd.inputs) > 1:
                sv = cval(nd, 1)
                sizes = [int(x) for x in np.asarray(sv).reshape(-1)] if sv is not None else None
            emit("Split", name, [inp(nd, 0)], list(nd.outputs), dict(
                axis=int(a.get("axis", 0)),
                split_sizes=[int(s) for s in (sizes or [])], is_onnx=1))
        elif op in ("LSTM", "GRU"):
            if a.get("direction", "forward") != "forward":
                raise NotImplementedError(f"{op} direction {a.get('direction')}")
            H = int(a["hidden_size"])
            gates = 4 if op == "LSTM" else 3
            W = cval(nd, 1)
            R = cval(nd, 2)
            if W is None or R is None:
                raise NotImplementedError(f"{op} with non-const weights")
            ins = [inp(nd, 0),
                   const(f"{name}/W", np.asarray(W, np.float32).reshape(gates * H, -1)),
                   const(f"{name}/R", np.asarray(R, np.float32).reshape(gates * H, H))]
            if len(nd.inputs) > 3 and nd.inputs[3]:
                B = cval(nd, 3)
                if B is not None:
                    ins.append(const(f"{name}/B", np.asarray(B, np.float32).reshape(-1)))
            # our LSTM/GRU lowerings use the ONNX gate orders (iofc / zrh)
            # and emit Y as [T, 1, B, H]; Y_h/Y_c outputs are not produced
            emit(op, name, ins, [nd.outputs[0]], dict(hidden_size=H,
                 output_len=0, sequence_len=0, input_size=0))
        else:
            raise NotImplementedError(f"ONNX op {op!r} (node {name!r})")

    for nm in g_out:
        if nm in env:
            g.outputs.append(g.tensors[env[nm]].producer)
        else:
            raise ValueError(f"ONNX graph output {nm!r} not produced")
    return g
