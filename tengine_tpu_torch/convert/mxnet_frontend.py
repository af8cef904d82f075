"""MXNet front-end: symbol .json + .params (NDArray save file) -> IR Graph.

Behavior-parity source: the reference converter
`tools/convert_tool/mxnet/mxnet2tengine.cpp`:
  * .params binary layout (load_binary_file, mxnet2tengine.cpp:547-648):
    header {magic u64, reserved u64, block_num u64}; per block a u32 flag —
    0xF993FAC9 (V3: + u32 stype) / 0xF993FAC8 (V2) read dims as int64,
    legacy blocks use the flag itself as ndim with u32 dims; then
    dev_type/dev_id/type_flag (3×u32) and raw fp32 data; then u64 name
    count + (u64 len, bytes) names with the "arg:"/"aux:" prefix stripped
  * symbol JSON: nodes[{op,name,attrs,inputs[[id,out,ver]]}], heads
  * op mapping (register_op_load, mxnet2tengine.cpp:1516-1560)

Weights are NCHW/OIHW — the tmfile layout, no transposition needed.

PyTorch port: a copy of tengine_tpu/convert/mxnet_frontend.py (numpy only),
so both packages build identical IR from one symbol JSON and .params.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..graph.ir import DType, Graph, TensorType
from ..serializer.tm2.format import (
    ELT_DIV,
    ELT_PROD,
    ELT_PROD_SCALAR,
    ELT_SUB,
    ELT_SUM,
    ELT_SUM_SCALAR,
    POOL_AVG,
    POOL_MAX,
)

NDARRAY_V2 = 0xF993FAC8
NDARRAY_V3 = 0xF993FAC9

# mxnet type_flag -> numpy (mshadow type enum); the reference assumes fp32
_MX_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
              4: np.int32, 5: np.int8, 6: np.int64}


def parse_params(buf: bytes) -> Dict[str, np.ndarray]:
    """Parse an MXNet NDArray save file (mxnet2tengine.cpp:547-648)."""
    pos = 0

    def u32() -> int:
        nonlocal pos
        (v,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return v

    def u64() -> int:
        nonlocal pos
        (v,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        return v

    _magic, _reserved = u64(), u64()
    block_num = u64()
    arrays: List[np.ndarray] = []
    for _ in range(block_num):
        flag = u32()
        if flag == NDARRAY_V3:
            _stype = u32()
            ndim = u32()
            wide = True
        elif flag == NDARRAY_V2:
            ndim = u32()
            wide = True
        else:
            ndim = flag
            wide = False
        dims = []
        for _ in range(ndim):
            if wide:
                (d,) = struct.unpack_from("<q", buf, pos)
                pos += 8
            else:
                d = u32()
            dims.append(int(d))
        _dev_type, _dev_id = u32(), u32()
        type_flag = u32()
        dt = np.dtype(_MX_DTYPES.get(type_flag, np.float32))
        n = int(np.prod(dims)) if dims else 1
        arr = np.frombuffer(buf, dt, n, pos).reshape(dims)
        pos += n * dt.itemsize
        arrays.append(np.ascontiguousarray(arr.astype(np.float32)))

    name_count = u64()
    out: Dict[str, np.ndarray] = {}
    for i in range(name_count):
        ln = u64()
        name = buf[pos : pos + ln].decode()
        pos += ln
        if ":" in name:
            name = name.split(":", 1)[1]  # strip arg:/aux:
        out[name] = arrays[i]
    return out


def _attr_ints(s: str) -> List[int]:
    return [int(float(x)) for x in s.strip("()[] ").split(",") if x.strip()]


def _attr_bool(s, default: bool = False) -> bool:
    if s is None:
        return default
    return str(s).strip().lower() in ("true", "1")


def from_mxnet(symbol, params, input_shape=None, name: str = "mxnet") -> Graph:
    """Convert an MXNet model. `symbol` is a path to / text of the symbol
    JSON; `params` is a path to / bytes of the .params file (or a dict of
    numpy arrays, or None for a weight-less build)."""
    if isinstance(symbol, (str, os.PathLike)) and os.path.exists(symbol):
        with open(symbol) as f:
            symbol = f.read()
    sym = json.loads(symbol)

    if params is None:
        weights: Dict[str, np.ndarray] = {}
    elif isinstance(params, dict):
        weights = params
    else:
        if isinstance(params, (str, os.PathLike)):
            with open(params, "rb") as f:
                params = f.read()
        weights = parse_params(params)

    nodes = sym["nodes"]
    g = Graph(name=name, source_format="mxnet")
    env: Dict[int, int] = {}  # mxnet node id -> IR tensor idx (output 0)

    def const(nm: str, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr, np.float32)
        return g.add_tensor(nm, DType.FP32, arr.shape, TensorType.CONST, data=arr).idx

    def var(nm: str, shape=()) -> int:
        return g.add_tensor(nm, DType.FP32, list(shape), TensorType.VAR).idx

    def src(mx_node: dict) -> List[int]:
        return [env[i[0]] for i in mx_node["inputs"]]

    def attrs_of(mx_node: dict) -> Dict[str, str]:
        return mx_node.get("attrs") or mx_node.get("attr") or mx_node.get("param") or {}

    def in_data(mx_node: dict, k: int) -> Optional[np.ndarray]:
        ti = env[mx_node["inputs"][k][0]]
        return g.tensors[ti].data

    for nid, mx in enumerate(nodes):
        op = mx["op"]
        nm = mx["name"]
        a = attrs_of(mx)

        if op == "null":
            if nm in weights:
                env[nid] = const(nm, weights[nm])
            else:
                shape = list(input_shape) if input_shape else [1, 3, 224, 224]
                t = g.add_tensor(nm, DType.FP32, shape, TensorType.INPUT)
                n = g.add_node("InputOp", nm, [], [t.idx])
                g.inputs.append(n.idx)
                env[nid] = t.idx
            continue

        def emit(ir_op: str, ins: List[int], params: Dict[str, Any]) -> int:
            to = var(f"{nm}_0")
            g.add_node(ir_op, nm, ins, [to], params)
            env[nid] = to
            return to

        if op == "Convolution":
            kh, kw = _attr_ints(a.get("kernel", "(1,1)"))
            sh, sw = _attr_ints(a.get("stride", "(1,1)")) if "stride" in a else (1, 1)
            ph, pw = _attr_ints(a.get("pad", "(0,0)")) if "pad" in a else (0, 0)
            dh, dw = _attr_ints(a.get("dilate", "(1,1)")) if "dilate" in a else (1, 1)
            group = _attr_ints(a.get("num_group", "1"))[0]
            num_filter = _attr_ints(a["num_filter"])[0]
            ins = src(mx)
            if _attr_bool(a.get("no_bias")) and len(ins) > 2:
                ins = ins[:2]
            w = in_data(mx, 1)
            in_c = int(w.shape[1]) * group if w is not None else 0
            emit("Convolution", ins, dict(
                kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                pad_h0=ph, pad_h1=ph, pad_w0=pw, pad_w1=pw,
                dilation_h=dh, dilation_w=dw, group=group, activation=-1,
                input_channel=in_c, output_channel=num_filter))
        elif op == "Deconvolution":
            kh, kw = _attr_ints(a.get("kernel", "(1,1)"))
            sh, sw = _attr_ints(a.get("stride", "(1,1)")) if "stride" in a else (1, 1)
            ph, pw = _attr_ints(a.get("pad", "(0,0)")) if "pad" in a else (0, 0)
            group = _attr_ints(a.get("num_group", "1"))[0]
            num_filter = _attr_ints(a["num_filter"])[0]
            ins = src(mx)
            if _attr_bool(a.get("no_bias")) and len(ins) > 2:
                ins = ins[:2]
            emit("Deconvolution", ins, dict(
                kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                pad_h0=ph, pad_h1=ph, pad_w0=pw, pad_w1=pw,
                dilation_h=1, dilation_w=1, group=group, activation=-1,
                num_output=num_filter, output_pad_h0=0, output_pad_w0=0))
        elif op == "BatchNorm":
            # inputs: data, gamma, beta, moving_mean, moving_var
            ins = src(mx)
            eps = float(a.get("eps", 1e-3))  # mxnet default is 1e-3
            if _attr_bool(a.get("fix_gamma")):
                gamma = in_data(mx, 1)
                if gamma is not None:
                    c = gamma.shape[0]
                    ins[1] = const(f"{nm}_gamma_fixed", np.ones(c, np.float32))
            emit("BatchNormalization", ins, dict(
                rescale_factor=1.0, eps=eps, caffe_flavor=0))
        elif op == "Activation":
            act = a.get("act_type", "relu")
            if act == "relu":
                emit("ReLu", src(mx), dict(negative_slope=0.0))
            elif act == "sigmoid":
                emit("Sigmoid", src(mx), {})
            elif act == "tanh":
                emit("Tanh", src(mx), {})
            elif act == "softrelu":
                emit("Softplus", src(mx), {})
            else:
                raise NotImplementedError(f"mxnet Activation act_type={act!r}")
        elif op == "LeakyReLU":
            act = a.get("act_type", "leaky")
            if act == "leaky":
                emit("ReLu", src(mx), dict(negative_slope=float(a.get("slope", 0.25))))
            elif act == "prelu":
                emit("PReLU", src(mx), {})
            elif act == "elu":
                emit("Elu", src(mx), dict(alpha=float(a.get("slope", 0.25))))
            else:
                raise NotImplementedError(f"mxnet LeakyReLU act_type={act!r}")
        elif op == "Pooling":
            glob = _attr_bool(a.get("global_pool"))
            kh, kw = _attr_ints(a.get("kernel", "(1,1)")) if "kernel" in a else (1, 1)
            sh, sw = _attr_ints(a.get("stride", "(1,1)")) if "stride" in a else (1, 1)
            ph, pw = _attr_ints(a.get("pad", "(0,0)")) if "pad" in a else (0, 0)
            alg = POOL_MAX if a.get("pool_type", "max") == "max" else POOL_AVG
            # pooling_convention "full" = ceil-mode (caffe flavor)
            caffe = 1 if a.get("pooling_convention") == "full" else 0
            emit("Pooling", src(mx), dict(
                alg=alg, kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                global_pool=1 if glob else 0, caffe_flavor=caffe,
                pad_h0=ph, pad_h1=ph, pad_w0=pw, pad_w1=pw))
        elif op == "FullyConnected":
            num_hidden = _attr_ints(a["num_hidden"])[0]
            ins = src(mx)
            if _attr_bool(a.get("no_bias")) and len(ins) > 2:
                ins = ins[:2]
            emit("FullyConnected", ins, dict(num_output=num_hidden))
        elif op in ("SoftmaxOutput", "SoftmaxActivation", "softmax"):
            emit("Softmax", src(mx)[:1], dict(axis=int(a.get("axis", 1))))
        elif op == "Flatten":
            emit("Flatten", src(mx), dict(axis=1, end_axis=-1))
        elif op == "Reshape":
            shape = _attr_ints(a.get("shape", "()"))
            emit("Reshape", src(mx), dict(
                shape=shape, is_mxnet=1, is_onnx=0,
                reverse=1 if _attr_bool(a.get("reverse")) else 0))
        elif op == "Concat":
            emit("Concat", src(mx), dict(axis=int(a.get("dim", 1))))
        elif op == "elemwise_add" or op == "_Plus":
            emit("Eltwise", src(mx), dict(type=ELT_SUM, caffe_flavor=0,
                                          shift=0.0, power=1.0, scale=1.0))
        elif op == "elemwise_mul":
            emit("Eltwise", src(mx), dict(type=ELT_PROD, caffe_flavor=0,
                                          shift=0.0, power=1.0, scale=1.0))
        elif op in ("_minus_scalar", "_mul_scalar", "_plus_scalar", "_div_scalar"):
            scalar = np.asarray([float(a["scalar"])], np.float32)
            t = {"_minus_scalar": ELT_SUB, "_mul_scalar": ELT_PROD_SCALAR,
                 "_plus_scalar": ELT_SUM_SCALAR, "_div_scalar": ELT_DIV}[op]
            emit("Eltwise", src(mx) + [const(f"{nm}_scalar", scalar)],
                 dict(type=t, caffe_flavor=0, shift=0.0, power=1.0, scale=1.0))
        elif op == "add_n":
            emit("Addn", src(mx), {})
        elif op == "broadcast_mul":
            emit("BroadMul", src(mx), {})
        elif op in ("Dropout", "Copy", "identity", "BlockGrad"):
            emit("Dropout", src(mx)[:1], {})
        elif op == "transpose":
            emit("Transpose", src(mx), dict(perm=_attr_ints(a.get("axes", "()"))))
        elif op == "SwapAxis":
            emit("SwapAxis", src(mx), dict(dim_0=int(a.get("dim1", 0)),
                                           dim_1=int(a.get("dim2", 0))))
        elif op == "clip":
            emit("Clip", src(mx), dict(min=float(a["a_min"]), max=float(a["a_max"])))
        elif op == "UpSampling":
            scale = _attr_ints(a.get("scale", "2"))[0]
            emit("Upsample", src(mx)[:1], dict(scale=float(scale)))
        elif op == "L2Normalization":
            emit("L2Normalization", src(mx), {})
        elif op == "InstanceNorm":
            emit("InstanceNorm", src(mx), dict(eps=float(a.get("eps", 1e-3))))
        elif op == "Embedding":
            emit("Embedding", src(mx), dict(
                num_output=_attr_ints(a["output_dim"])[0],
                input_dim=_attr_ints(a["input_dim"])[0],
                weight_data_size=0, bias_term=0))
        elif op in ("abs", "neg", "ceil", "floor", "sin", "cos", "atan",
                    "reciprocal", "tan", "sqrt", "exp", "log"):
            # unary_param.h type table (15 = reciprocal)
            types = {"abs": 0, "neg": 1, "floor": 2, "ceil": 3, "sqrt": 5,
                     "exp": 7, "log": 8, "sin": 9, "cos": 10, "tan": 11,
                     "atan": 14, "reciprocal": 15}
            emit("Unary", src(mx), dict(type=types[op]))
        else:
            raise NotImplementedError(f"mxnet op {op!r} (node {nm!r})")

    # outputs = heads
    out_tids = set()
    for h in sym.get("heads", []):
        out_tids.add(env[h[0]])
    for nd in g.nodes:
        if nd.op != "InputOp" and any(t in out_tids for t in nd.outputs):
            g.outputs.append(nd.idx)
    if not g.outputs:
        consumed = set()
        for nd in g.nodes:
            consumed.update(nd.inputs)
        for nd in g.nodes:
            if nd.op == "InputOp" or not nd.outputs:
                continue
            if not any(t in consumed for t in nd.outputs):
                g.outputs.append(nd.idx)
    return g
