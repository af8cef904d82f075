"""tmfile (TM2) importer: binary blob -> tengine_tpu_torch.graph.ir.Graph.

PyTorch port of tengine_tpu/serializer/tm2/reader.py: the native parser
(native/tm2_parser.cc) by default, the pure-Python one as its fallback and
oracle (load_tm_bytes_py).

Layout spec: Tengine's `source/serializer/tmfile/tm2_format.h`.
Loading pipeline mirrors the reference serializer
(`tm2_serializer.c:835-913`: tensors -> nodes -> graph I/O), but produces our
Python IR directly. CONST tensor data are zero-copy numpy views into the file
blob (like the reference's pointer fix-ups, `tm2_serializer.c:251`); buffers
with offset_data == 0 (weight-stripped benchmark tmfiles) are zero-filled,
matching `tm2_serializer.c:241-246`.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional

import numpy as np

from ... import native
from ...graph.ir import DType, Graph, Layout, QuantParam, Tensor, TensorType
from .format import OP_TYPE_TO_NAME, TM2_NOT_SET


class Blob:
    """Offset-addressed view over the tmfile bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self._np = np.frombuffer(data, np.uint8)

    def u32(self, off: int) -> int:
        return struct.unpack_from("<I", self.data, off)[0]

    def i32(self, off: int) -> int:
        return struct.unpack_from("<i", self.data, off)[0]

    def unpack(self, fmt: str, off: int):
        return struct.unpack_from("<" + fmt, self.data, off)

    def string(self, off: int) -> str:
        """TM2_String {size, offset_data} (tm2_format.h:360-364)."""
        if off == TM2_NOT_SET:
            return ""
        size, od = self.unpack("II", off)
        raw = self.data[od : od + size]
        return raw.split(b"\x00", 1)[0].decode("utf-8", "replace")

    def vec_u32(self, off: int) -> List[int]:
        """TM2_Vector_indices / _offsets {v_num, u32[v_num]}."""
        if off == TM2_NOT_SET:
            return []
        n = self.u32(off)
        return list(self.unpack(f"{n}I", off + 4))

    def vec_i32(self, off: int) -> List[int]:
        """TM2_Vector_dims {v_num, i32[v_num]}."""
        if off == TM2_NOT_SET:
            return []
        n = self.u32(off)
        return list(self.unpack(f"{n}i", off + 4))

    def vec_f32(self, off: int) -> List[float]:
        """TM2_Vector_floats {v_num, f32[v_num]}."""
        if off == TM2_NOT_SET:
            return []
        n = self.u32(off)
        return list(self.unpack(f"{n}f", off + 4))

    def vec_anchors(self, off: int) -> List[List[float]]:
        """TM2_Vector_anchors {v_num, f32[v_num][4]} (tm2_format.h:392-396)."""
        if off == TM2_NOT_SET:
            return []
        n = self.u32(off)
        flat = self.unpack(f"{n * 4}f", off + 4)
        return [list(flat[i * 4 : (i + 1) * 4]) for i in range(n)]

    def ndarray(self, off: int, size: int, dtype: np.dtype) -> np.ndarray:
        """Zero-copy typed view of `size` bytes at `off`."""
        count = size // dtype.itemsize
        return np.frombuffer(self.data, dtype, count=count, offset=off)


# ---------------------------------------------------------------------------
# Per-op param parsers (TM2_*Param structs, tm2_format.h:398-1015).
# Each takes (blob, param_offset) and returns the params dict stored on the
# IR node. Nested vector offsets are resolved here so the IR is self-contained.
# ---------------------------------------------------------------------------


def _fields(fmt: str, names: List[str]):
    def parse(b: Blob, off: int) -> Dict[str, Any]:
        vals = b.unpack(fmt, off)
        return dict(zip(names, vals))

    return parse


_parse_conv = _fields(
    "14i",
    [
        "kernel_h", "kernel_w", "stride_h", "stride_w", "dilation_h", "dilation_w",
        "input_channel", "output_channel", "group", "activation",
        "pad_h0", "pad_w0", "pad_h1", "pad_w1",
    ],
)

_parse_deconv = _fields(
    "14i",
    [
        "num_output", "kernel_h", "kernel_w", "stride_h", "stride_w",
        "pad_w0", "pad_h0", "pad_w1", "pad_h1", "dilation_h", "dilation_w",
        "group", "activation", "output_pad_h0",
    ],
)
# note: TM2_DeconvParam has one more field (output_pad_w0); keep parser tolerant
def _parse_deconv_full(b: Blob, off: int) -> Dict[str, Any]:
    d = _parse_deconv(b, off)
    d["output_pad_w0"] = b.i32(off + 14 * 4)
    return d


_parse_pool = _fields(
    "I10i",
    [
        "alg", "kernel_h", "kernel_w", "stride_h", "stride_w", "global_pool",
        "caffe_flavor", "pad_h0", "pad_w0", "pad_h1", "pad_w1",
    ],
)

_parse_eltwise = _fields("Iifff", ["type", "caffe_flavor", "shift", "power", "scale"])


def _parse_reshape(b: Blob, off: int) -> Dict[str, Any]:
    is_mxnet, reverse, off_shape, is_onnx = b.unpack("iiIi", off)
    return {
        "is_mxnet": is_mxnet,
        "reverse": reverse,
        "shape": b.vec_i32(off_shape),
        "is_onnx": is_onnx,
    }


def _parse_slice(b: Blob, off: int) -> Dict[str, Any]:
    axis, o_pts, o_begins, o_sizes, iscaffe, ismxnet, isonnx, begin, end, step = b.unpack(
        "iIIIiiiiii", off
    )
    return {
        "axis": axis,
        "slice_points": b.vec_i32(o_pts),
        "begins": b.vec_i32(o_begins),
        "sizes": b.vec_i32(o_sizes),
        "iscaffe": iscaffe,
        "ismxnet": ismxnet,
        "isonnx": isonnx,
        "begin": begin,
        "end": end,
        "step": step,
    }


def _parse_split(b: Blob, off: int) -> Dict[str, Any]:
    # {i32 axis, i32 split_dim, u8 is_caffe, u8 is_onnx, pad[2], u32 offset}
    axis, split_dim, is_caffe, is_onnx = b.unpack("iiBB", off)
    off_sizes = b.u32(off + 12)
    return {
        "axis": axis,
        "split_dim": split_dim,
        "is_caffe": bool(is_caffe),
        "is_onnx": bool(is_onnx),
        "split_sizes": b.vec_i32(off_sizes),
    }


def _parse_priorbox(b: Blob, off: int) -> Dict[str, Any]:
    (o_min, o_max, o_var, o_ar, flip, clip, img_size, img_h, img_w,
     step_w, step_h, offset, num_priors, out_dim) = b.unpack("IIIIiiiiifffii", off)
    return {
        "min_sizes": b.vec_f32(o_min),
        "max_sizes": b.vec_f32(o_max),
        "variances": b.vec_f32(o_var),
        "aspect_ratios": b.vec_f32(o_ar),
        "flip": flip,
        "clip": clip,
        "img_size": img_size,
        "img_h": img_h,
        "img_w": img_w,
        "step_w": step_w,
        "step_h": step_h,
        "offset": offset,
        "num_priors": num_priors,
        "out_dim": out_dim,
    }


def _parse_region(b: Blob, off: int) -> Dict[str, Any]:
    num_classes, side, num_box, coords, conf_th, nms_th, o_biases = b.unpack("iiiiffI", off)
    return {
        "num_classes": num_classes,
        "side": side,
        "num_box": num_box,
        "coords": coords,
        "confidence_threshold": conf_th,
        "nms_threshold": nms_th,
        "biases": b.vec_f32(o_biases),
    }


def _parse_rpn(b: Blob, off: int) -> Dict[str, Any]:
    (o_ratios, o_scales, feat_stride, basesize, min_size, per_nms_topn,
     post_nms_topn, nms_thresh, o_anchors) = b.unpack("IIiiiiifI", off)
    return {
        "ratios": b.vec_f32(o_ratios),
        "anchor_scales": b.vec_f32(o_scales),
        "feat_stride": feat_stride,
        "basesize": basesize,
        "min_size": min_size,
        "per_nms_topn": per_nms_topn,
        "post_nms_topn": post_nms_topn,
        "nms_thresh": nms_thresh,
        "anchors": b.vec_anchors(o_anchors),
    }


def _parse_dpp(b: Blob, off: int) -> Dict[str, Any]:
    max_det, max_cpd, score_th, iou_th, num_classes, o_scales = b.unpack("iiffiI", off)
    return {
        "max_detections": max_det,
        "max_classes_per_detection": max_cpd,
        "nms_score_threshold": score_th,
        "nms_iou_threshold": iou_th,
        "num_classes": num_classes,
        "scales": b.vec_f32(o_scales),
    }


def _parse_lrn(b: Blob, off: int) -> Dict[str, Any]:
    local_size, alpha, beta, norm_region, k, bias = b.unpack("iffiff", off)
    is_onnx = b.unpack("B", off + 24)[0]
    return {
        "local_size": local_size, "alpha": alpha, "beta": beta,
        "norm_region": norm_region, "k": k, "bias": bias, "is_onnx": bool(is_onnx),
    }


def _parse_gather(b: Blob, off: int) -> Dict[str, Any]:
    axis, indices_num, is_onnx = b.unpack("iiB", off)
    return {"axis": axis, "indices_num": indices_num, "is_onnx": bool(is_onnx)}


def _parse_transpose(b: Blob, off: int) -> Dict[str, Any]:
    return {"perm": b.vec_i32(b.u32(off))}


def _parse_unsqueeze(b: Blob, off: int) -> Dict[str, Any]:
    return {"axes": b.vec_i32(b.u32(off))}


def _parse_expand(b: Blob, off: int) -> Dict[str, Any]:
    o_shape, dim_num = b.unpack("Ii", off)
    return {"shape": b.vec_i32(o_shape), "dim_num": dim_num}


def _parse_tile(b: Blob, off: int) -> Dict[str, Any]:
    frame_flag, reps_size, o_reps = b.unpack("iiI", off)
    return {"frame_flag": frame_flag, "reps_size": reps_size, "reps": b.vec_i32(o_reps)}


def _parse_scatter(b: Blob, off: int) -> Dict[str, Any]:
    axis, is_onnx = b.unpack("iB", off)
    return {"axis": axis, "is_onnx": bool(is_onnx)}


def _parse_crop(b: Blob, off: int) -> Dict[str, Any]:
    num_args, offset_c, offset_h, offset_w, crop_h, crop_w, center = b.unpack("iiiiiiB", off)
    axis, flag = b.unpack("ii", off + 28)
    return {
        "num_args": num_args, "offset_c": offset_c, "offset_h": offset_h,
        "offset_w": offset_w, "crop_h": crop_h, "crop_w": crop_w,
        "center_crop": bool(center), "axis": axis, "flag": flag,
    }


def _parse_spatial_transformer(b: Blob, off: int) -> Dict[str, Any]:
    sampler, transformer, shape_size, o_shape = b.unpack("iiiI", off)
    return {
        "sampler_type": sampler, "transformer_type": transformer,
        "target_shape": b.vec_i32(o_shape),
    }


def _parse_generic(b: Blob, off: int) -> Dict[str, Any]:
    max_in, max_out, o_name = b.unpack("iiI", off)
    return {"max_input_num": max_in, "max_output_num": max_out, "op_name": b.string(o_name)}


PARAM_PARSERS = {
    "BatchNormalization": _fields("ffi", ["rescale_factor", "eps", "caffe_flavor"]),
    "BilinearResize": _fields("ffi", ["scale_x", "scale_y", "type"]),
    "Concat": _fields("i", ["axis"]),
    "Convolution": _parse_conv,
    "Deconvolution": _parse_deconv_full,
    "DetectionOutput": _fields(
        "iiiff",
        ["num_classes", "keep_top_k", "nms_top_k", "confidence_threshold", "nms_threshold"],
    ),
    "Eltwise": _parse_eltwise,
    "Flatten": _fields("ii", ["axis", "end_axis"]),
    "FullyConnected": _fields("i", ["num_output"]),
    "LRN": _parse_lrn,
    "Normalize": _fields("ii", ["across_spatial", "channel_shared"]),
    "Permute": _fields("5i", ["flag", "order0", "order1", "order2", "order3"]),
    "Pooling": _parse_pool,
    "PriorBox": _parse_priorbox,
    "Region": _parse_region,
    "ReLu": _fields("f", ["negative_slope"]),
    "Reorg": _fields("i", ["stride"]),
    "Reshape": _parse_reshape,
    "ROIPooling": _fields("iif", ["pooled_h", "pooled_w", "spatial_scale"]),
    "RPN": _parse_rpn,
    "Scale": _fields("iii", ["axis", "num_axes", "bias_term"]),
    "Slice": _parse_slice,
    "Softmax": _fields("i", ["axis"]),
    "Split": _parse_split,
    "DetectionPostProcess": _parse_dpp,
    "Gemm": _fields("ffii", ["alpha", "beta", "transA", "transB"]),
    "Generic": _parse_generic,
    "LSTM": _fields(
        "ff16i",
        [
            "forget_bias", "clip", "output_len", "sequence_len", "input_size",
            "hidden_size", "cell_size", "has_peephole", "has_projection", "has_clip",
            "has_bias", "has_init_state", "forget_act", "input_act", "output_act",
            "cellin_act", "cellout_act", "mxnet_flag",
        ],
    ),
    "RNN": _fields(
        "f8i",
        [
            "clip", "output_len", "sequence_len", "input_size", "hidden_size",
            "has_clip", "has_bias", "has_init_state", "activation",
        ],
    ),
    "Squeeze": _fields("4i", ["dim_0", "dim_1", "dim_2", "dim_3"]),
    "Pad": _fields(
        "8iif",
        [
            "pad_n_0", "pad_n_1", "pad_c_0", "pad_c_1",
            "pad_h_0", "pad_h_1", "pad_w_0", "pad_w_1", "mode", "value",
        ],
    ),
    "StridedSlice": _fields(
        "12i",
        [
            "begin_n", "end_n", "stride_n", "begin_c", "end_c", "stride_c",
            "begin_h", "end_h", "stride_h", "begin_w", "end_w", "stride_w",
        ],
    ),
    "ArgMax": _fields("ii", ["axis", "keepdims"]),
    "ArgMin": _fields("ii", ["axis", "keepdims"]),
    "TopKV2": _fields("ii", ["k", "sorted"]),
    "Reduction": _fields("6i", ["dim_0", "dim_1", "dim_2", "dim_3", "type", "keepdim"]),
    "GRU": _fields(
        "f9i",
        [
            "clip", "output_len", "sequence_len", "input_size", "hidden_size",
            "has_clip", "has_gate_bias", "has_candidate_bias", "has_init_state",
            "mxnet_flag",
        ],
    ),
    "Addn": _fields("i", ["axis"]),
    "SwapAxis": _fields("ii", ["dim_0", "dim_1"]),
    "Upsample": _fields("f", ["scale"]),
    "SpaceToBatchND": _fields(
        "6i",
        ["dilation_x", "dilation_y", "pad_top", "pad_bottom", "pad_left", "pad_right"],
    ),
    "BatchToSpaceND": _fields(
        "6i",
        ["dilation_x", "dilation_y", "crop_top", "crop_bottom", "crop_left", "crop_right"],
    ),
    "Resize": _fields("ffi", ["scale_x", "scale_y", "type"]),
    "ShuffleChannel": _fields("i", ["group"]),
    "Crop": _parse_crop,
    "Roialign": _fields("iif", ["pooled_width", "pooled_height", "spatial_scale"]),
    "Psroipooling": _fields("iifi", ["pooled_w", "pooled_h", "spatial_scale", "output_dim"]),
    "Unary": _fields("i", ["type"]),
    "Expanddims": _fields("i", ["axis"]),
    "Bias": _fields("i", ["bias_size"]),
    "Threshold": _fields("f", ["threshold"]),
    "Hardsigmoid": _fields("ff", ["alpha", "beta"]),
    "Embedding": _fields("4i", ["num_output", "input_dim", "bias_term", "weight_data_size"]),
    "InstanceNorm": _fields("f", ["eps"]),
    "MVN": _fields("iif", ["across_channels", "normalize_variance", "eps"]),
    "Cast": _fields("ii", ["type_from", "type_to"]),
    "HardSwish": _fields("ff", ["alpha", "beta"]),
    "Interp": _fields(
        "iffii",
        ["resize_type", "width_scale", "height_scale", "output_width", "output_height"],
    ),
    "Selu": _fields("ff", ["alpha", "lambda_"]),
    "Elu": _fields("f", ["alpha"]),
    "Logical": _fields("I", ["type"]),
    "Gather": _parse_gather,
    "Transpose": _parse_transpose,
    "Comparison": _fields("i", ["type"]),
    "SpaceToDepth": _fields("i", ["block_size"]),
    "DepthToSpace": _fields("i", ["block_size"]),
    "SparseToDense": _fields(
        "3i", ["output_shape_size0", "output_shape_size1", "default_value"]
    ),
    "Clip": _fields("ff", ["max", "min"]),
    "Unsqueeze": _parse_unsqueeze,
    "ReduceL2": _fields("ii", ["axis", "keepdim"]),
    "LogSoftmax": _fields("i", ["axis"]),
    "Scatter": _parse_scatter,
    "L2Pool": _fields(
        "5i", ["padding_type", "kernel_h", "kernel_w", "stride_h", "stride_w"]
    ),
    "Tile": _parse_tile,
    "SpatialTransformer": _parse_spatial_transformer,
    "Expand": _parse_expand,
    "LayerNorm": _fields("f", ["eps"]),
}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def load_tmfile(path: str, fill_missing_weights: str = "zero") -> Graph:
    """Parse a tmfile into an IR Graph.

    fill_missing_weights: what to do for CONST buffers with offset_data==0
    (weight-stripped benchmark tmfiles): "zero" (reference behavior,
    tm2_serializer.c:241-246) or "random" (useful for benchmarking so conv
    outputs aren't all-zero).
    """
    with open(path, "rb") as f:
        data = f.read()
    return load_tm_bytes(data, name=path, fill_missing_weights=fill_missing_weights)


def load_tm_bytes(data: bytes, name: str = "", fill_missing_weights: str = "zero") -> Graph:
    """Dispatch to the native C++ parser (tm2_parser.cc) when available —
    the default, like the reference's native serializer — with this module's
    pure-Python parser as fallback and cross-validation oracle
    (disable native with TT_NATIVE_PARSER=0)."""
    if os.environ.get("TT_NATIVE_PARSER", "1") != "0":
        wire = native.tm2_parse(data)
        if wire is not None:
            return _graph_from_wire(wire, data, name, fill_missing_weights)
    return load_tm_bytes_py(data, name, fill_missing_weights)


# --- wire-format decode (native parser output; see tm2_parser.cc header) ---


class _Wire:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self.buf, self.pos)
        self.pos += 4
        return v

    def f32(self) -> float:
        (v,) = struct.unpack_from("<f", self.buf, self.pos)
        self.pos += 4
        return v

    def str_(self) -> str:
        n = self.u32()
        raw = self.buf[self.pos : self.pos + n]
        self.pos += (n + 3) & ~3
        return raw.decode("utf-8", "replace")

    def vec(self, fmt: str) -> List:
        n = self.u32()
        vals = list(struct.unpack_from(f"<{n}{fmt}", self.buf, self.pos))
        self.pos += 4 * n
        return vals


def _graph_from_wire(
    wire: bytes, data: bytes, name: str, fill_missing_weights: str
) -> Graph:
    b = Blob(data)  # for zero-copy const views
    w = _Wire(wire)
    magic = wire[:4]
    if magic != b"TTW1":
        raise ValueError("bad native wire magic")
    w.pos = 4
    graph_layout = w.i32()
    model_layout = w.i32()
    orig_format = w.i32()
    model_name = w.str_()

    g = Graph(
        name=model_name or name,
        layout=Layout(graph_layout),
        model_layout=Layout(model_layout),
        source_format=str(orig_format),
    )
    g.inputs = w.vec("I")
    g.outputs = w.vec("I")
    graph_inputs, graph_outputs = g.inputs, g.outputs
    g.inputs, g.outputs = [], []  # set after nodes exist (order preserved)

    rng = np.random.default_rng(0)
    n_tensors = w.u32()
    for _ in range(n_tensors):
        tensor_id = w.u32()
        dtype = w.i32()
        ttype = w.i32()
        tname = w.str_()
        dims = w.vec("i")
        nq = w.u32()
        quant = None
        if nq:
            zps, scales, widths = [], [], []
            for _ in range(nq):
                zps.append(w.i32())
                scales.append(w.f32())
                widths.append(w.i32())
            if nq == 1:
                quant = QuantParam.per_tensor(scales[0], zps[0], widths[0])
            else:
                quant = QuantParam(
                    scales=np.asarray(scales, np.float32),
                    zero_points=np.asarray(zps, np.int32),
                    width=widths[0],
                )
        has_buf = w.u32()
        buf_size = w.u32()
        buf_off = w.u32()

        t = g.add_tensor(
            name=tname,
            dtype=DType(dtype),
            shape=dims,
            tensor_type=TensorType(ttype),
            quant=quant,
        )
        if t.idx != tensor_id:
            raise ValueError(f"non-sequential tensor id {tensor_id}")
        if has_buf:
            nbytes = t.elem_num * t.dtype.size
            if buf_off == TM2_NOT_SET:
                t.data = _fill_missing(t, fill_missing_weights, rng)
            else:
                if nbytes > buf_size:
                    raise ValueError(
                        f"const tensor {t.name}: model buffer too small "
                        f"({buf_size} < {nbytes})"
                    )
                t.data = b.ndarray(buf_off, nbytes, t.dtype.np).reshape(
                    t.shape or (t.elem_num,)
                )

    n_nodes = w.u32()
    for _ in range(n_nodes):
        node_id = w.u32()
        op_type = w.u32()
        nname = w.str_()
        nin = w.vec("I")
        nout = w.vec("I")
        n_params = w.u32()
        params: Dict[str, Any] = {}
        for _ in range(n_params):
            key = w.str_()
            kind = w.u32()
            if kind == 0:
                params[key] = w.i32()
            elif kind == 1:
                params[key] = w.f32()
            elif kind == 2:
                params[key] = bool(w.i32())
            elif kind == 3:
                params[key] = w.vec("i")
            elif kind == 4:
                params[key] = w.vec("f")
            elif kind == 5:
                params[key] = w.str_()
            elif kind == 6:
                n_anchors = w.u32()
                flat = struct.unpack_from(f"<{n_anchors * 4}f", w.buf, w.pos)
                w.pos += 16 * n_anchors
                params[key] = [list(flat[i * 4 : (i + 1) * 4]) for i in range(n_anchors)]
            elif kind == 7:
                params[key] = w.u32()
            else:
                raise ValueError(f"bad wire param kind {kind}")
        op_name = OP_TYPE_TO_NAME.get(op_type)
        if op_name is None:
            raise ValueError(f"unknown TM2 op type {op_type}")
        n = g.add_node(op=op_name, name=nname, inputs=nin, outputs=nout, params=params)
        if n.idx != node_id:
            raise ValueError(f"non-sequential node id {node_id}")

    g.inputs = graph_inputs
    g.outputs = graph_outputs
    _read_node_attrs(b, g)
    return g


def _apply_attrs(b: Blob, g: Graph, n, off_attrs: int) -> None:
    """What a node's attribute list (TM2_Attr {offset_s_attrname,
    offset_s_attrval, attr_type}) carries, as the port's writer records it
    (writer.py:_w_attrs): an Eltwise's fused activation into its params,
    and "full_range" onto the grids of the outputs it lists."""
    if off_attrs == TM2_NOT_SET:
        return
    for aoff in b.vec_u32(off_attrs):
        off_name, off_val, _ = b.unpack("IIi", aoff)
        key, val = b.string(off_name), b.string(off_val)
        if key == "activation" and n.op == "Eltwise":
            n.params["activation"] = int(val)
        elif key == "full_range":
            for k in val.split(","):
                q = g.tensors[n.outputs[int(k)]].quant
                if q is not None:
                    q.full_range = True


def _read_node_attrs(b: Blob, g: Graph) -> None:
    """Add to the graph what its nodes' attribute lists carry (the native
    parser does not read them)."""
    root = b.u32(8)
    (off_subgraphs,) = b.unpack("I", root + 8)
    soff = b.vec_u32(off_subgraphs)[0]
    (off_nodes,) = b.unpack("I", soff + 12 + 8)
    for noff in b.vec_u32(off_nodes):
        node_id, _, _, _, _, off_attrs = b.unpack("6I", noff)
        _apply_attrs(b, g, g.nodes[node_id], off_attrs)


def _fill_missing(t, fill_missing_weights: str, rng) -> np.ndarray:
    """Weight-stripped benchmark file handling (tm2_serializer.c:241-246)."""
    if fill_missing_weights == "random":
        if t.dtype in (DType.FP32, DType.FP16):
            arr = (rng.standard_normal(t.elem_num) * 0.05).astype(t.dtype.np)
            if len(t.shape) <= 1:
                arr = np.abs(arr) + np.asarray(0.01, t.dtype.np)
        else:
            info = np.iinfo(t.dtype.np)
            arr = rng.integers(
                max(info.min, -8), min(info.max, 8) + 1, t.elem_num
            ).astype(t.dtype.np)
        return arr.reshape(t.shape or (t.elem_num,))
    return np.zeros(t.shape or (t.elem_num,), t.dtype.np)


def load_tm_bytes_py(data: bytes, name: str = "", fill_missing_weights: str = "zero") -> Graph:
    b = Blob(data)

    ver_main, ver_sub, ver_compile = b.unpack("3H", 0)
    if ver_main != 2:
        raise ValueError(f"unsupported tmfile version {ver_main}.{ver_sub} (need 2.x)")
    root = b.u32(8)

    orig_format, sub_format, off_subgraphs, off_mname = b.unpack("iiII", root)
    sub_offsets = b.vec_u32(off_subgraphs)
    if len(sub_offsets) != 1:
        raise ValueError(f"expected 1 subgraph, got {len(sub_offsets)}")
    soff = sub_offsets[0]

    (subgraph_id, graph_layout, model_layout) = b.unpack("Iii", soff)
    (off_in, off_out, off_nodes, off_tensors, off_buffers, off_sname, off_subinfo) = b.unpack(
        "7I", soff + 12
    )

    g = Graph(
        name=b.string(off_mname) or name,
        layout=Layout(graph_layout),
        model_layout=Layout(model_layout),
        source_format=str(orig_format),
    )
    # The reference permutes NHWC-layout graphs to NCHW at load
    # (tm2_serializer.c:168-172); we record the original layouts and do layout
    # normalization as an IR pass instead (graph/passes.py).

    buffer_offsets = b.vec_u32(off_buffers)
    rng = np.random.default_rng(0)

    # --- tensors (tm2_serializer.c:157-466) ---
    for toff in b.vec_u32(off_tensors):
        (tensor_id, buffer_id, off_dims, off_tname, off_qp, layout, ttype, dtype) = b.unpack(
            "IIIIIiii", toff
        )
        t = g.add_tensor(
            name=b.string(off_tname),
            dtype=DType(dtype),
            shape=b.vec_i32(off_dims),
            tensor_type=TensorType(ttype),
        )
        assert t.idx == tensor_id, f"non-sequential tensor id {tensor_id}"

        # quant params: vector of offsets to TM2_QuantParam {i32 zp, f32 scale, i32 width}
        if off_qp != TM2_NOT_SET:
            qoffs = b.vec_u32(off_qp)
            if qoffs:
                zps, scales, widths = [], [], []
                for qo in qoffs:
                    zp, scale, width = b.unpack("ifi", qo)
                    zps.append(zp)
                    scales.append(scale)
                    widths.append(width)
                if len(qoffs) == 1:
                    t.quant = QuantParam.per_tensor(scales[0], zps[0], widths[0])
                else:
                    t.quant = QuantParam(
                        scales=np.asarray(scales, np.float32),
                        zero_points=np.asarray(zps, np.int32),
                        width=widths[0],
                    )

        if t.tensor_type == TensorType.CONST:
            size, off_data = b.unpack("II", buffer_offsets[buffer_id])
            nbytes = t.elem_num * t.dtype.size
            if off_data == TM2_NOT_SET:
                # weight-stripped benchmark file
                if fill_missing_weights == "random":
                    if t.dtype in (DType.FP32, DType.FP16):
                        arr = (rng.standard_normal(t.elem_num) * 0.05).astype(t.dtype.np)
                        if len(t.shape) <= 1:
                            # 1-D consts are biases / BN stats; variances must
                            # be positive or BN produces NaN
                            arr = np.abs(arr) + np.asarray(0.01, t.dtype.np)
                    else:
                        info = np.iinfo(t.dtype.np)
                        arr = rng.integers(
                            max(info.min, -8), min(info.max, 8) + 1, t.elem_num
                        ).astype(t.dtype.np)
                    t.data = arr.reshape(t.shape or (t.elem_num,))
                else:
                    t.data = np.zeros(t.shape or (t.elem_num,), t.dtype.np)
            else:
                if nbytes > size:
                    raise ValueError(
                        f"const tensor {t.name}: model buffer too small ({size} < {nbytes})"
                    )
                t.data = b.ndarray(off_data, nbytes, t.dtype.np).reshape(
                    t.shape or (t.elem_num,)
                )

    # --- nodes (tm2_serializer.c:468-732) ---
    for noff in b.vec_u32(off_nodes):
        node_id, off_nin, off_nout, off_op, off_nname, off_attrs = b.unpack("6I", noff)
        op_ver, op_type, off_param = b.unpack("3I", off_op)
        op_name = OP_TYPE_TO_NAME.get(op_type)
        if op_name is None:
            raise ValueError(f"unknown TM2 op type {op_type}")
        params: Dict[str, Any] = {}
        if off_param != TM2_NOT_SET and op_name in PARAM_PARSERS:
            params = PARAM_PARSERS[op_name](b, off_param)
        n = g.add_node(
            op=op_name,
            name=b.string(off_nname),
            inputs=b.vec_u32(off_nin),
            outputs=b.vec_u32(off_nout),
            params=params,
        )
        assert n.idx == node_id, f"non-sequential node id {node_id}"
        _apply_attrs(b, g, n, off_attrs)

    # --- graph I/O (tm2_serializer.c:734-768) ---
    g.inputs = b.vec_u32(off_in)
    g.outputs = b.vec_u32(off_out)
    return g
