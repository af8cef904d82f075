"""TM2 (tmfile) writer: IR Graph -> binary blob (PyTorch port of
tengine_tpu/serializer/tm2/writer.py, the same code with its buffer class
named Blob: numpy and struct only, so both packages write the same bytes
for the same graph).

The write-side of the serializer, mirroring the reference's save_graph tool
(tools/save_graph/tm2_generate.c, tm2_op_save.cpp). Layout follows
tm2_format.h exactly; offsets are explicit so emission order is free — we
reserve the 12-byte header, append objects with 4-byte alignment, then patch
the root offset. Graphs written here re-import bit-identically through
reader.py (tests/test_torch_tm2_writer.py round-trips fp32 and quantized
graphs and holds the bytes to the JAX package's writer).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

import numpy as np

from ...graph.ir import DType, Graph, Layout, QuantParam, Tensor, TensorType
from .format import OP_NAME_TO_TYPE, TM2_NOT_SET


class Blob:
    def __init__(self):
        self.buf = bytearray(12)  # reserved: TM2_Header

    def align(self, n: int = 4):
        while len(self.buf) % n:
            self.buf.append(0)

    def tell(self) -> int:
        return len(self.buf)

    def pack(self, fmt: str, *vals) -> int:
        self.align()
        off = self.tell()
        self.buf += struct.pack("<" + fmt, *vals)
        return off

    def raw(self, data: bytes) -> int:
        self.align()
        off = self.tell()
        self.buf += data
        return off

    def string(self, s: str) -> int:
        """TM2_String {size, offset_data}; size includes the NUL."""
        if not s:
            return TM2_NOT_SET
        data = s.encode("utf-8") + b"\x00"
        off_data = self.raw(data)
        return self.pack("II", len(data), off_data)

    def vec_u32(self, vals: List[int]) -> int:
        if not vals:
            return TM2_NOT_SET
        return self.pack(f"I{len(vals)}I", len(vals), *vals)

    def vec_i32(self, vals: List[int]) -> int:
        if not vals:
            return TM2_NOT_SET
        return self.pack(f"I{len(vals)}i", len(vals), *[int(v) for v in vals])

    def vec_f32(self, vals: List[float]) -> int:
        if not vals:
            return TM2_NOT_SET
        return self.pack(f"I{len(vals)}f", len(vals), *[float(v) for v in vals])

    def vec_anchors(self, vals: List[List[float]]) -> int:
        if not vals:
            return TM2_NOT_SET
        flat = [float(v) for row in vals for v in row]
        return self.pack(f"I{len(flat)}f", len(vals), *flat)


def _w_fields(fmt: str, names: List[str], defaults: Optional[Dict[str, Any]] = None,
              fixup=None):
    def write(b: Blob, p: Dict[str, Any]) -> int:
        if fixup is not None:
            p = fixup(p)
        d = defaults or {}
        vals = [p.get(n, d.get(n, 0)) for n in names]
        return b.pack(fmt, *vals)

    return write


def _w_conv(b: Blob, p: Dict[str, Any]) -> int:
    return b.pack(
        "14i",
        p["kernel_h"], p["kernel_w"], p["stride_h"], p["stride_w"],
        p.get("dilation_h", 1), p.get("dilation_w", 1),
        p.get("input_channel", 0), p.get("output_channel", 0),
        p.get("group", 1), p.get("activation", -1),
        p.get("pad_h0", 0), p.get("pad_w0", 0), p.get("pad_h1", 0), p.get("pad_w1", 0),
    )


def _w_pool(b: Blob, p: Dict[str, Any]) -> int:
    return b.pack(
        "I10i",
        p.get("alg", 0), p["kernel_h"], p["kernel_w"], p["stride_h"], p["stride_w"],
        p.get("global_pool", 0), p.get("caffe_flavor", 0),
        p.get("pad_h0", 0), p.get("pad_w0", 0), p.get("pad_h1", 0), p.get("pad_w1", 0),
    )


def _w_reshape(b: Blob, p: Dict[str, Any]) -> int:
    off_shape = b.vec_i32(p.get("shape") or [])
    return b.pack(
        "iiIi", p.get("is_mxnet", 0), p.get("reverse", 0), off_shape, p.get("is_onnx", 0)
    )


def _w_slice(b: Blob, p: Dict[str, Any]) -> int:
    o_pts = b.vec_i32(p.get("slice_points") or [])
    o_begins = b.vec_i32(p.get("begins") or [])
    o_sizes = b.vec_i32(p.get("sizes") or [])
    return b.pack(
        "iIIIiiiiii",
        p.get("axis", 0), o_pts, o_begins, o_sizes,
        p.get("iscaffe", 0), p.get("ismxnet", 0), p.get("isonnx", 0),
        p.get("begin", 0), p.get("end", 0), p.get("step", 1),
    )


def _w_split(b: Blob, p: Dict[str, Any]) -> int:
    off = b.vec_i32(p.get("split_sizes") or [])
    b.align()
    o = b.pack(
        "iiBBxx", p.get("axis", 0), p.get("split_dim", 0),
        1 if p.get("is_caffe") else 0, 1 if p.get("is_onnx") else 0,
    )
    b.pack("I", off)
    return o


def _w_priorbox(b: Blob, p: Dict[str, Any]) -> int:
    o_min = b.vec_f32(p.get("min_sizes") or [])
    o_max = b.vec_f32(p.get("max_sizes") or [])
    o_var = b.vec_f32(p.get("variances") or [])
    o_ar = b.vec_f32(p.get("aspect_ratios") or [])
    return b.pack(
        "IIIIiiiiifffii",
        o_min, o_max, o_var, o_ar,
        p.get("flip", 0), p.get("clip", 0), p.get("img_size", 0),
        p.get("img_h", 0), p.get("img_w", 0),
        p.get("step_w", 0.0), p.get("step_h", 0.0), p.get("offset", 0.5),
        p.get("num_priors", 0), p.get("out_dim", 0),
    )


def _w_lrn(b: Blob, p: Dict[str, Any]) -> int:
    return b.pack(
        "iffiffBxxx",
        p.get("local_size", 5), p.get("alpha", 1e-4), p.get("beta", 0.75),
        p.get("norm_region", 0), p.get("k", 2.0), p.get("bias", 1.0),
        1 if p.get("is_onnx") else 0,
    )


def _w_gather(b: Blob, p: Dict[str, Any]) -> int:
    return b.pack(
        "iiBxxx", p.get("axis", 0), p.get("indices_num", 0), 1 if p.get("is_onnx") else 0
    )


def _w_transpose(b: Blob, p: Dict[str, Any]) -> int:
    off = b.vec_i32(p.get("perm") or [])
    return b.pack("I", off)


def _w_unsqueeze(b: Blob, p: Dict[str, Any]) -> int:
    off = b.vec_i32(p.get("axes") or [])
    return b.pack("I", off)


def _w_attrs(b: Blob, n, graph: Graph) -> int:
    """The node's attribute list (TM2_Node.offset_vo_attrs: TM2_Attr
    {offset_s_attrname, offset_s_attrval, attr_type}). Two attributes are
    written: "activation", an Eltwise's fused activation, which
    split_concat_conv1x1 moves onto a sum and the Eltwise param record has
    no field for; and "full_range", the positions of the node's outputs
    ("0", "0,2") whose INT8 grid spans [-128, 127] (QuantParam.full_range:
    a TFLite full-int8 import's activations), which TM2_QuantParam has no
    field for. The JAX package writes no attributes and its reader skips
    them, so every other node's bytes are its writer's."""
    attrs = []
    act = n.params.get("activation", -1) if n.op == "Eltwise" else -1
    if act is not None and act >= 0:
        attrs.append(("activation", str(int(act))))
    full = [str(k) for k, tid in enumerate(n.outputs)
            if graph.tensors[tid].quant is not None and graph.tensors[tid].quant.full_range]
    if full:
        attrs.append(("full_range", ",".join(full)))
    if not attrs:
        return TM2_NOT_SET
    return b.vec_u32([b.pack("IIi", b.string(k), b.string(v), 0) for k, v in attrs])


PARAM_WRITERS = {
    "BatchNormalization": _w_fields(
        "ffi", ["rescale_factor", "eps", "caffe_flavor"], {"rescale_factor": 1.0, "eps": 1e-5}
    ),
    "BilinearResize": _w_fields("ffi", ["scale_x", "scale_y", "type"]),
    "Concat": _w_fields("i", ["axis"], {"axis": 1}),
    "Convolution": _w_conv,
    "DetectionOutput": _w_fields(
        "iiiff",
        ["num_classes", "keep_top_k", "nms_top_k", "confidence_threshold", "nms_threshold"],
    ),
    "Eltwise": _w_fields(
        "Iifff", ["type", "caffe_flavor", "shift", "power", "scale"],
        {"power": 1.0, "scale": 1.0},
    ),
    # end_axis: the reference's flatten infer_shape iterates axis..end_axis
    # literally (flatten.c:44-48), so any caffe-style negative value (-1,
    # -2, ...) would flatten zero dims there; normalize every negative
    # end_axis onto the 4-D range on the wire (ADVICE r3 item 3).
    "Flatten": _w_fields(
        "ii", ["axis", "end_axis"], {"axis": 1},
        fixup=lambda p: {**p, "end_axis": 3}
        if p.get("end_axis") is None
        else ({**p, "end_axis": p["end_axis"] % 4}
              if p["end_axis"] < 0 else p),
    ),
    "FullyConnected": _w_fields("i", ["num_output"]),
    "LRN": _w_lrn,
    "Normalize": _w_fields("ii", ["across_spatial", "channel_shared"]),
    "Permute": _w_fields("5i", ["flag", "order0", "order1", "order2", "order3"]),
    "Pooling": _w_pool,
    "PriorBox": _w_priorbox,
    "ReLu": _w_fields("f", ["negative_slope"]),
    "Reorg": _w_fields("i", ["stride"]),
    "Reshape": _w_reshape,
    "Scale": _w_fields("iii", ["axis", "num_axes", "bias_term"]),
    "Slice": _w_slice,
    "Softmax": _w_fields("i", ["axis"], {"axis": 1}),
    "Split": _w_split,
    "Gemm": _w_fields("ffii", ["alpha", "beta", "transA", "transB"], {"alpha": 1.0, "beta": 1.0}),
    "Squeeze": _w_fields("4i", ["dim_0", "dim_1", "dim_2", "dim_3"]),
    "Pad": _w_fields(
        "8iif",
        ["pad_n_0", "pad_n_1", "pad_c_0", "pad_c_1",
         "pad_h_0", "pad_h_1", "pad_w_0", "pad_w_1", "mode", "value"],
    ),
    "StridedSlice": _w_fields(
        "12i",
        ["begin_n", "end_n", "stride_n", "begin_c", "end_c", "stride_c",
         "begin_h", "end_h", "stride_h", "begin_w", "end_w", "stride_w"],
    ),
    "ArgMax": _w_fields("ii", ["axis", "keepdims"]),
    "ArgMin": _w_fields("ii", ["axis", "keepdims"]),
    "TopKV2": _w_fields("ii", ["k", "sorted"]),
    "Reduction": _w_fields("6i", ["dim_0", "dim_1", "dim_2", "dim_3", "type", "keepdim"]),
    "Addn": _w_fields("i", ["axis"]),
    "SwapAxis": _w_fields("ii", ["dim_0", "dim_1"]),
    "Upsample": _w_fields("f", ["scale"]),
    "Resize": _w_fields("ffi", ["scale_x", "scale_y", "type"]),
    "ShuffleChannel": _w_fields("i", ["group"]),
    "Roialign": _w_fields("iif", ["pooled_width", "pooled_height", "spatial_scale"]),
    "Psroipooling": _w_fields("iifi", ["pooled_w", "pooled_h", "spatial_scale", "output_dim"]),
    "Unary": _w_fields("i", ["type"]),
    "Expanddims": _w_fields("i", ["axis"]),
    "Bias": _w_fields("i", ["bias_size"]),
    "Threshold": _w_fields("f", ["threshold"]),
    "Hardsigmoid": _w_fields("ff", ["alpha", "beta"]),
    "Embedding": _w_fields("4i", ["num_output", "input_dim", "bias_term", "weight_data_size"]),
    "InstanceNorm": _w_fields("f", ["eps"]),
    "MVN": _w_fields("iif", ["across_channels", "normalize_variance", "eps"]),
    "Cast": _w_fields("ii", ["type_from", "type_to"]),
    "HardSwish": _w_fields("ff", ["alpha", "beta"]),
    "Interp": _w_fields(
        "iffii",
        ["resize_type", "width_scale", "height_scale", "output_width", "output_height"],
    ),
    "Selu": _w_fields("ff", ["alpha", "lambda_"]),
    "Elu": _w_fields("f", ["alpha"]),
    "Logical": _w_fields("I", ["type"]),
    "Gather": _w_gather,
    "Transpose": _w_transpose,
    "Comparison": _w_fields("i", ["type"]),
    "SpaceToDepth": _w_fields("i", ["block_size"]),
    "DepthToSpace": _w_fields("i", ["block_size"]),
    "Clip": _w_fields("ff", ["max", "min"]),
    "Unsqueeze": _w_unsqueeze,
    "ReduceL2": _w_fields("ii", ["axis", "keepdim"]),
    "LogSoftmax": _w_fields("i", ["axis"]),
    "L2Pool": _w_fields("5i", ["padding_type", "kernel_h", "kernel_w", "stride_h", "stride_w"]),
    "LayerNorm": _w_fields("f", ["eps"]),
}

# ops with no param record
_NO_PARAM_OPS = {
    "Accuracy", "Const", "Dropout", "InputOp", "PReLU", "ReLu6", "Logistic",
    "Tanh", "Sigmoid", "FusedBNScaleReLu", "Maximum", "Minimum", "Noop",
    "Absval", "BroadMul", "Mean", "MatMul", "Mish", "Shape", "Where",
    "ReLU1", "L2Normalization", "Softplus", "Reciprocal", "Gelu", "Ceil",
    "Round", "ZerosLike", "SquaredDifference", "Reverse", "SparseToDense",
}


def graph_to_tm_bytes(graph: Graph) -> bytes:
    if any(n.op == "Noop" and not n.outputs for n in graph.nodes):
        # fusion passes leave dead Noop shells; the reference loader
        # rejects output-less nodes — write a compacted graph instead
        from ...graph.passes import compact

        graph = compact(graph)
    b = Blob()

    # --- tensors + buffers ---
    buffer_offsets: List[int] = []
    tensor_offsets: List[int] = []
    for t in graph.tensors:
        buffer_id = 0
        if t.tensor_type == TensorType.CONST:
            data = np.ascontiguousarray(t.data)
            off_data = b.raw(data.tobytes())
            buffer_id = len(buffer_offsets)
            buffer_offsets.append(b.pack("II", data.nbytes, off_data))

        off_dims = b.vec_i32(list(t.shape)) if t.shape else TM2_NOT_SET
        off_name = b.string(t.name)

        off_qp = TM2_NOT_SET
        if t.quant is not None:
            scales = np.asarray(t.quant.scales, np.float32).reshape(-1)
            zps = np.asarray(t.quant.zero_points, np.int32).reshape(-1)
            if zps.size == 1 and scales.size > 1:
                zps = np.full(scales.size, int(zps[0]), np.int32)
            if (
                t.quant.width == 32
                and scales.size > 1
                and np.all(scales == scales[0])
                and np.all(zps == zps[0])
            ):
                # collapse a uniform bias scale list to ONE entry: the
                # reference's loader only sets the scalar tensor->scale when
                # v_num == 1 (tm2_serializer.c:442-449), and its per-tensor
                # kernels (e.g. ref_fc_uint8's bias_scale) read that scalar
                # — a redundant uniform list would leave it zero there
                scales, zps = scales[:1], zps[:1]
            qoffs = [
                b.pack("ifi", int(z), float(s), t.quant.width)
                for s, z in zip(scales, zps)
            ]
            off_qp = b.vec_u32(qoffs)

        tensor_offsets.append(
            b.pack(
                "IIIIIiii",
                t.idx,
                buffer_id,
                off_dims,
                off_name,
                off_qp,
                int(t.layout),
                int(t.tensor_type),
                int(t.dtype),
            )
        )

    # --- nodes ---
    node_offsets: List[int] = []
    for n in graph.nodes:
        op_type = OP_NAME_TO_TYPE.get(n.op)
        if op_type is None:
            raise ValueError(f"cannot serialize op {n.op!r}: no TM2 op type")
        off_param = TM2_NOT_SET
        writer = PARAM_WRITERS.get(n.op)
        if writer is not None and (n.params or n.op not in _NO_PARAM_OPS):
            off_param = writer(b, n.params)
        elif n.op not in _NO_PARAM_OPS and n.params:
            raise ValueError(f"op {n.op!r} has params but no TM2 param writer")
        off_op = b.pack("3I", 1, op_type, off_param)
        off_in = b.vec_u32(n.inputs)
        off_out = b.vec_u32(n.outputs)
        off_name = b.string(n.name)
        node_offsets.append(
            b.pack("6IBxxx", n.idx, off_in, off_out, off_op, off_name, _w_attrs(b, n, graph), 0)
        )

    # --- subgraph ---
    off_vo_tensors = b.vec_u32(tensor_offsets)
    off_vo_buffers = b.vec_u32(buffer_offsets) if buffer_offsets else b.vec_u32([0])
    off_vo_nodes = b.vec_u32(node_offsets)
    off_in_idx = b.vec_u32(graph.inputs)
    off_out_idx = b.vec_u32(graph.outputs)
    sub_off = b.pack(
        "Iii7I",
        0,
        int(graph.layout),
        int(graph.model_layout),
        off_in_idx,
        off_out_idx,
        off_vo_nodes,
        off_vo_tensors,
        off_vo_buffers,
        TM2_NOT_SET,
        TM2_NOT_SET,
    )
    off_vo_subgraphs = b.vec_u32([sub_off])
    off_mname = b.string(graph.name)
    root = b.pack("iiII", 0, 0, off_vo_subgraphs, off_mname)

    struct.pack_into("<3HxxI", b.buf, 0, 2, 0, 0, root)
    return bytes(b.buf)


def save_tmfile(graph: Graph, path: str) -> None:
    with open(path, "wb") as f:
        f.write(graph_to_tm_bytes(graph))


def _w_deconv(b: Blob, p: Dict[str, Any]) -> int:
    return b.pack(
        "15i",
        p.get("num_output", 0), p["kernel_h"], p["kernel_w"],
        p["stride_h"], p["stride_w"],
        p.get("pad_w0", 0), p.get("pad_h0", 0), p.get("pad_w1", 0), p.get("pad_h1", 0),
        p.get("dilation_h", 1), p.get("dilation_w", 1), p.get("group", 1),
        p.get("activation", -1), p.get("output_pad_h0", 0), p.get("output_pad_w0", 0),
    )


def _w_region(b: Blob, p: Dict[str, Any]) -> int:
    o_biases = b.vec_f32(p.get("biases") or [])
    return b.pack(
        "iiiiffI",
        p.get("num_classes", 0), p.get("side", 0), p.get("num_box", 0),
        p.get("coords", 4), p.get("confidence_threshold", 0.0),
        p.get("nms_threshold", 0.0), o_biases,
    )


def _w_rpn(b: Blob, p: Dict[str, Any]) -> int:
    o_ratios = b.vec_f32(p.get("ratios") or [])
    o_scales = b.vec_f32(p.get("anchor_scales") or [])
    o_anchors = b.vec_anchors(p.get("anchors") or [])
    return b.pack(
        "IIiiiiifI",
        o_ratios, o_scales, p.get("feat_stride", 16), p.get("basesize", 16),
        p.get("min_size", 16), p.get("per_nms_topn", 6000),
        p.get("post_nms_topn", 300), p.get("nms_thresh", 0.7), o_anchors,
    )


def _w_dpp(b: Blob, p: Dict[str, Any]) -> int:
    o_scales = b.vec_f32(p.get("scales") or [])
    return b.pack(
        "iiffiI",
        p.get("max_detections", 100), p.get("max_classes_per_detection", 1),
        p.get("nms_score_threshold", 0.0), p.get("nms_iou_threshold", 0.5),
        p.get("num_classes", 0), o_scales,
    )


def _w_crop(b: Blob, p: Dict[str, Any]) -> int:
    o = b.pack(
        "6iBxxx",
        p.get("num_args", 0), p.get("offset_c", 0), p.get("offset_h", 0),
        p.get("offset_w", 0), p.get("crop_h", 0), p.get("crop_w", 0),
        1 if p.get("center_crop") else 0,
    )
    b.pack("ii", p.get("axis", 2), p.get("flag", 0))
    return o


def _w_expand(b: Blob, p: Dict[str, Any]) -> int:
    o_shape = b.vec_i32(p.get("shape") or [])
    return b.pack("Ii", o_shape, p.get("dim_num", len(p.get("shape") or [])))


def _w_tile(b: Blob, p: Dict[str, Any]) -> int:
    o_reps = b.vec_i32(p.get("reps") or [])
    return b.pack("iiI", p.get("frame_flag", 0), len(p.get("reps") or []), o_reps)


def _w_scatter(b: Blob, p: Dict[str, Any]) -> int:
    return b.pack("iBxxx", p.get("axis", 0), 1 if p.get("is_onnx") else 0)


def _w_spatial_transformer(b: Blob, p: Dict[str, Any]) -> int:
    o_shape = b.vec_i32(p.get("target_shape") or [])
    return b.pack(
        "iiiI", p.get("sampler_type", 0), p.get("transformer_type", 0),
        len(p.get("target_shape") or []), o_shape,
    )


def _w_generic(b: Blob, p: Dict[str, Any]) -> int:
    o_name = b.string(p.get("op_name", ""))
    return b.pack("iiI", p.get("max_input_num", 1), p.get("max_output_num", 1), o_name)


PARAM_WRITERS.update({
    "Deconvolution": _w_deconv,
    "Region": _w_region,
    "RPN": _w_rpn,
    "DetectionPostProcess": _w_dpp,
    "Crop": _w_crop,
    "Expand": _w_expand,
    "Tile": _w_tile,
    "Scatter": _w_scatter,
    "SpatialTransformer": _w_spatial_transformer,
    "Generic": _w_generic,
    "ROIPooling": _w_fields("iif", ["pooled_h", "pooled_w", "spatial_scale"]),
    "SpaceToBatchND": _w_fields(
        "6i", ["dilation_x", "dilation_y", "pad_top", "pad_bottom", "pad_left", "pad_right"]
    ),
    "BatchToSpaceND": _w_fields(
        "6i", ["dilation_x", "dilation_y", "crop_top", "crop_bottom", "crop_left", "crop_right"]
    ),
    "SparseToDense": _w_fields(
        "3i", ["output_shape_size0", "output_shape_size1", "default_value"]
    ),
    "LSTM": _w_fields(
        "ff16i",
        ["forget_bias", "clip", "output_len", "sequence_len", "input_size",
         "hidden_size", "cell_size", "has_peephole", "has_projection", "has_clip",
         "has_bias", "has_init_state", "forget_act", "input_act", "output_act",
         "cellin_act", "cellout_act", "mxnet_flag"],
    ),
    "RNN": _w_fields(
        "f8i",
        ["clip", "output_len", "sequence_len", "input_size", "hidden_size",
         "has_clip", "has_bias", "has_init_state", "activation"],
    ),
    "GRU": _w_fields(
        "f9i",
        ["clip", "output_len", "sequence_len", "input_size", "hidden_size",
         "has_clip", "has_gate_bias", "has_candidate_bias", "has_init_state",
         "mxnet_flag"],
    ),
})
