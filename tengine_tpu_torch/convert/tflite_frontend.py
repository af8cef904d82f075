"""TFLite front-end: .tflite flatbuffer -> IR Graph, quant params included.

Reference: tools/convert_tool/tf_lite/ (flatbuffer importer, the largest of
the reference's 7 front-ends).

PyTorch port of tengine_tpu/convert/tflite_frontend.py. That module reads
the flatbuffer through the schema classes bundled with tensorflow; this one
imports no tensorflow and no flatbuffers package: it reads the file with the
port's own reader (convert/_flatbuf.py), which knows the slots of the fields
read here and their schema defaults. It reads a buffer's inline data, or
the bytes that Buffer.offset / size place after the flatbuffer (the JAX
importer reads only the inline data).

TFLite is the quantization-native interchange format: per-tensor uint8
asymmetric and per-channel int8 tensors carry (scale, zero_point) exactly
like tmfile quant params, so quantized .tflite models import straight onto
the quantized execution engine (quant params land in Tensor.quant; conv
weights are dequantize-free). Per-channel zero points import as the file
gives them. INT8 activations carry QuantParam.full_range: TFLite's int8
tensors span [-128, 127], where the reference's symmetric int8 clips at
+-127; the JAX importer leaves the flag unset (ROADMAP §3), and the port's
TM2 writer records it (serializer/tm2/writer.py:_w_attrs).

Layouts: TFLite activations are NHWC and conv weights OHWI / depthwise
1HWC(M); the importer transposes to the IR's NCHW / OIHW convention like the
TF front-end. A RESHAPE of a rank-4 activation with H*W > 1 goes through an
NHWC transpose first (tf_frontend.reshape_nhwc), so that it flattens in
TFLite's order; the reference flattens the NCHW tensor as it stands.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..graph.ir import DType, Graph, QuantParam, TensorType
from ..serializer.tm2.format import ELT_PROD, ELT_SUM
from . import _flatbuf as fb
from .tf_frontend import reshape_nhwc

_DT = {0: DType.FP32, 2: DType.INT32, 3: DType.UINT8, 9: DType.INT8, 7: DType.INT16}

# fused_activation_function enum -> IR conv activation code
_ACT = {0: -1, 1: 0, 2: 1, 3: 6}  # NONE, RELU, RELU_N1_TO_1, RELU6


class _Options:
    """An operator's builtin options table; every field reads its schema
    default when the operator has none."""

    def __init__(self, table: Optional[fb.Table]):
        self.t = table

    def get(self, slot: int, fmt: str = "i", default=0):
        return default if self.t is None else self.t.scalar(slot, fmt, default)

    def vector(self, slot: int, dtype):
        return np.zeros(0, dtype) if self.t is None else self.t.vector(slot, dtype)


def from_tflite(path_or_bytes, input_shape: Optional[List[int]] = None) -> Graph:
    """Import a .tflite model (fp32 or quantized).

    Supported builtins: CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED,
    MAX/AVERAGE_POOL_2D, ADD, MUL, CONCATENATION, RESHAPE, SOFTMAX, RELU,
    RELU6, LOGISTIC, MEAN(H,W), PAD, RESIZE_NEAREST_NEIGHBOR.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    model = fb.Model(buf)
    sub = model.subgraphs[0]
    tensors = sub.tables(fb.SUBGRAPH_TENSORS)

    g = Graph(name="tflite", source_format="tflite")
    tmap: Dict[int, int] = {}  # tflite tensor idx -> IR tensor idx

    def shape_of(i: int) -> np.ndarray:
        return tensors[i].vector(fb.TENSOR_SHAPE, np.int32)

    def type_of(i: int) -> int:
        return tensors[i].scalar(fb.TENSOR_TYPE, "b", 0)

    def name_of(i: int) -> str:
        return (tensors[i].string(fb.TENSOR_NAME) or b"").decode()

    def quant_of(i: int, activation: bool) -> Optional[QuantParam]:
        """Tensor i's grid. An INT8 activation's spans TFLite's [-128, 127]
        (full_range; the JAX importer leaves it unset, so its engine clips
        such a tensor at -127, ROADMAP §3); a weight's is data."""
        q = tensors[i].table(fb.TENSOR_QUANTIZATION)
        if q is None:
            return None
        scales = q.vector(fb.QUANT_SCALE, np.float32).astype(np.float32)
        if len(scales) == 0:
            return None
        zps = q.vector(fb.QUANT_ZERO_POINT, np.int64)
        zps = zps.astype(np.int32) if len(zps) else np.zeros(len(scales), np.int32)
        if len(scales) == 1:
            qp = QuantParam.per_tensor(float(scales[0]), int(zps[0]), width=8)
        else:
            qp = QuantParam(scales=scales, zero_points=zps, width=8)
        qp.full_range = activation and _DT.get(type_of(i)) == DType.INT8
        return qp

    def tensor_data(i: int) -> Optional[np.ndarray]:
        raw = model.buffer_data(tensors[i].scalar(fb.TENSOR_BUFFER, "I", 0))
        if raw.size == 0:
            return None
        arr = raw.view(np.dtype(_DT[type_of(i)].np).newbyteorder("<"))
        shape = shape_of(i)
        return arr.reshape([int(d) for d in shape]) if len(shape) else arr

    def ir_tensor(i: int, transform=None, as_type=None, name_suffix="") -> int:
        """Materialize tflite tensor i into the IR (const or var)."""
        if name_suffix == "" and i in tmap:
            return tmap[i]
        name = name_of(i) + name_suffix
        dtype = _DT[type_of(i)]
        data = tensor_data(i)
        quant = quant_of(i, activation=data is None)
        if data is not None:
            if transform is not None:
                data = transform(data)
            tt = g.add_tensor(name, as_type or dtype, list(data.shape),
                              TensorType.CONST, data=np.ascontiguousarray(data),
                              quant=quant)
        else:
            tt = g.add_tensor(name, dtype, [], TensorType.VAR, quant=quant)
        if name_suffix == "":
            tmap[i] = tt.idx
        return tt.idx

    # graph inputs: NHWC -> NCHW shape
    for i in sub.vector(fb.SUBGRAPH_INPUTS, np.int32).tolist():
        dims = [int(d) for d in shape_of(i)]
        if input_shape:
            shape = list(input_shape)
        elif len(dims) == 4:
            shape = [dims[0], dims[3], dims[1], dims[2]]
        else:
            shape = dims
        tt = g.add_tensor(name_of(i) or "in", _DT[type_of(i)], shape,
                          TensorType.INPUT, quant=quant_of(i, activation=True))
        n = g.add_node("InputOp", tt.name, [], [tt.idx])
        g.inputs.append(n.idx)
        tmap[i] = tt.idx

    def emit(op: str, name: str, ins: List[int], out_i: int, params: dict):
        out = ir_tensor(out_i)
        g.add_node(op, name or f"op{out_i}", ins, [out], params=params)
        return out

    for op in sub.tables(fb.SUBGRAPH_OPERATORS):
        code = model.builtin_code(op.scalar(fb.OPERATOR_OPCODE_INDEX, "I", 0))
        ins = op.vector(fb.OPERATOR_INPUTS, np.int32).tolist()
        out_i = int(op.vector(fb.OPERATOR_OUTPUTS, np.int32)[0])
        name = name_of(out_i)
        opts = _Options(op.table(fb.OPERATOR_BUILTIN_OPTIONS))

        if code in (fb.CONV_2D, fb.DEPTHWISE_CONV_2D):
            wshape = [int(d) for d in shape_of(ins[1])]
            if code == fb.CONV_2D:
                # OHWI -> OIHW
                tr = lambda a: np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                O, kh, kw, I = wshape
                group = 1
                padding, sh, sw, act, dh, dw = (
                    fb.CONV_PADDING, fb.CONV_STRIDE_H, fb.CONV_STRIDE_W,
                    fb.CONV_FUSED_ACTIVATION, fb.CONV_DILATION_H, fb.CONV_DILATION_W)
            else:
                # [1, kh, kw, C*M] -> [C*M, 1, kh, kw]
                tr = lambda a: np.ascontiguousarray(a.transpose(3, 0, 1, 2))
                _, kh, kw, O = wshape
                I, group = 1, O // max(opts.get(fb.DW_DEPTH_MULTIPLIER), 1)
                padding, sh, sw, act, dh, dw = (
                    fb.DW_PADDING, fb.DW_STRIDE_H, fb.DW_STRIDE_W,
                    fb.DW_FUSED_ACTIVATION, fb.DW_DILATION_H, fb.DW_DILATION_W)
            w_idx = ir_tensor(ins[1], transform=tr)
            node_ins = [ir_tensor(ins[0]), w_idx]
            if len(ins) > 2 and ins[2] >= 0:
                node_ins.append(ir_tensor(ins[2]))
            pv = -1 if opts.get(padding, "b") == 0 else 0  # SAME / VALID
            emit("Convolution", name, node_ins, out_i, dict(
                kernel_h=kh, kernel_w=kw,
                stride_h=opts.get(sh), stride_w=opts.get(sw),
                dilation_h=max(opts.get(dh, "i", 1), 1),
                dilation_w=max(opts.get(dw, "i", 1), 1),
                input_channel=I * group, output_channel=O, group=group,
                activation=_ACT.get(opts.get(act, "b"), -1),
                pad_h0=pv, pad_h1=pv, pad_w0=pv, pad_w1=pv))
        elif code == fb.FULLY_CONNECTED:
            w_idx = ir_tensor(ins[1])  # already [out, in]
            node_ins = [ir_tensor(ins[0]), w_idx]
            if len(ins) > 2 and ins[2] >= 0:
                node_ins.append(ir_tensor(ins[2]))
            out_c = int(shape_of(ins[1])[0])
            act = _ACT.get(opts.get(fb.FC_FUSED_ACTIVATION, "b"), -1)
            emit("FullyConnected", name, node_ins, out_i, dict(num_output=out_c))
            if act >= 0:
                raise NotImplementedError("fused activation on FULLY_CONNECTED")
        elif code in (fb.MAX_POOL_2D, fb.AVERAGE_POOL_2D):
            pv = -1 if opts.get(fb.POOL_PADDING, "b") == 0 else 0
            emit("Pooling", name, [ir_tensor(ins[0])], out_i, dict(
                alg=0 if code == fb.MAX_POOL_2D else 1,
                kernel_h=opts.get(fb.POOL_FILTER_H), kernel_w=opts.get(fb.POOL_FILTER_W),
                stride_h=opts.get(fb.POOL_STRIDE_H), stride_w=opts.get(fb.POOL_STRIDE_W),
                global_pool=0, caffe_flavor=0,
                pad_h0=pv, pad_h1=pv, pad_w0=pv, pad_w1=pv))
        elif code in (fb.ADD, fb.MUL):
            emit("Eltwise", name, [ir_tensor(ins[0]), ir_tensor(ins[1])], out_i, dict(
                type=ELT_SUM if code == fb.ADD else ELT_PROD,
                caffe_flavor=0, shift=0.0, power=1.0, scale=1.0))
        elif code == fb.CONCATENATION:
            axis = int(opts.get(fb.CONCAT_AXIS))
            if len(shape_of(ins[0])) == 4:
                axis = {0: 0, 1: 2, 2: 3, 3: 1, -1: 1}.get(axis, axis)
            emit("Concat", name, [ir_tensor(i) for i in ins], out_i, dict(axis=axis))
        elif code == fb.RESHAPE:
            shp = tensor_data(ins[1]) if len(ins) > 1 else None
            if shp is None:
                shp = opts.vector(fb.RESHAPE_NEW_SHAPE, np.int32)
            shape = [int(v) for v in np.asarray(shp).reshape(-1)]
            src = ir_tensor(ins[0])
            dims = [int(d) for d in shape_of(ins[0])]
            src_shape = [dims[0], dims[3], dims[1], dims[2]] if len(dims) == 4 else dims

            def emit_part(op_, nm, ins_, params):
                if nm == name:
                    return emit(op_, nm, ins_, out_i, params)
                t_src = g.tensors[src]
                t = g.add_tensor(nm, t_src.dtype, [], TensorType.VAR, quant=t_src.quant)
                g.add_node(op_, nm, ins_, [t.idx], params=params)
                return t.idx

            reshape_nhwc(g, emit_part, name, src, shape, src_shape=src_shape)
        elif code == fb.SOFTMAX:
            emit("Softmax", name, [ir_tensor(ins[0])], out_i, dict(axis=1))
        elif code == fb.RELU:
            emit("ReLu", name, [ir_tensor(ins[0])], out_i, dict(negative_slope=0.0))
        elif code == fb.RELU6:
            emit("ReLu6", name, [ir_tensor(ins[0])], out_i, {})
        elif code == fb.LOGISTIC:
            emit("Sigmoid", name, [ir_tensor(ins[0])], out_i, {})
        elif code == fb.MEAN:
            axes = tensor_data(ins[1])
            if sorted(int(a) for a in np.asarray(axes).reshape(-1)) != [1, 2]:
                raise NotImplementedError("tflite MEAN over non-HW axes")
            emit("Pooling", name, [ir_tensor(ins[0])], out_i, dict(
                alg=1, kernel_h=0, kernel_w=0, stride_h=1, stride_w=1,
                global_pool=1, caffe_flavor=0,
                pad_h0=0, pad_h1=0, pad_w0=0, pad_w1=0))
        elif code == fb.PAD:
            pads = np.asarray(tensor_data(ins[1])).reshape(-1, 2)
            emit("Pad", name, [ir_tensor(ins[0])], out_i, dict(
                mode=0, value=0.0,
                pad_n_0=int(pads[0, 0]), pad_n_1=int(pads[0, 1]),
                pad_c_0=int(pads[3, 0]), pad_c_1=int(pads[3, 1]),
                pad_h_0=int(pads[1, 0]), pad_h_1=int(pads[1, 1]),
                pad_w_0=int(pads[2, 0]), pad_w_1=int(pads[2, 1])))
        elif code == fb.RESIZE_NEAREST_NEIGHBOR:
            size = tensor_data(ins[1])
            scale = float(np.asarray(size).reshape(-1)[0]) / float(shape_of(ins[0])[1])
            emit("Upsample", name, [ir_tensor(ins[0])], out_i, dict(scale=scale))
        else:
            raise NotImplementedError(f"tflite builtin op code {code}")

    for ti in sub.vector(fb.SUBGRAPH_OUTPUTS, np.int32).tolist():
        if ti in tmap:
            g.outputs.append(g.tensors[tmap[ti]].producer)
    return g
