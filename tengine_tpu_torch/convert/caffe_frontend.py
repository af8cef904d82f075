"""Caffe front-end: prototxt + caffemodel -> IR Graph.

Reference: tools/convert_tool/caffe/ (protobuf-based; the reference's
benchmark zoo is largely Caffe-derived). No caffe/protobuf-schema package is
assumed: the .prototxt is parsed with a small text-format protobuf reader
and the .caffemodel with the same wire-format decoder approach as the ONNX
front-end (convert/onnx_frontend.py), reading only the fields we need from
the public caffe.proto schema:

  NetParameter: name=1, input=3, input_dim=4, input_shape=8, layers=25
  (V1, ignored), layer=100 (LayerParameter)
  LayerParameter: name=1, type=2, bottom=3, top=4, blobs=7, phase? ...
    convolution_param=106, pooling_param=121, inner_product_param=117,
    lrn_param=118, relu_param=123, softmax_param=125, concat_param=104,
    batch_norm_param=139, scale_param=142, eltwise_param=110,
    dropout_param=108, reshape_param=133, flatten_param=135, slice_param=126,
    power_param=122, prelu_param=131, upsample? (nonstandard), crop_param=144,
    permute_param=202 (ssd fork), prior_box_param=203, detection_output_param=204,
    norm_param=206 (ssd Normalize), interp_param? (fork-specific, best effort)
  BlobProto: shape=7 (BlobShape dim=1), data=5 (packed float), num=1,
    channels=2, height=3, width=4 (legacy dims)

PyTorch port: a copy of tengine_tpu/convert/caffe_frontend.py (numpy only),
so both packages build identical IR from one prototxt and caffemodel.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..graph.ir import DType, Graph, TensorType
from ..serializer.tm2.format import ELT_PROD, ELT_SUM, ELT_MAX
from .onnx_frontend import _fields, _packed_varints, _signed

# ---------------------------------------------------------------------------
# prototxt: protobuf text format
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:(?P<comment>\#[^\n]*)|(?P<brace>[{}])|(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*(?P<colon>:)?|(?P<string>"(?:[^"\\]|\\.)*")|(?P<value>[^\s{}"]+))""",
)


def parse_prototxt(text: str) -> Dict[str, Any]:
    """Parse protobuf text format into nested dicts; repeated fields become
    lists. Enough for Caffe prototxt (no extensions/any)."""
    pos = 0
    n = len(text)

    def parse_block():
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < n:
            m = _TOKEN.match(text, pos)
            if m is None:
                break
            pos = m.end()
            if m.group("comment"):
                continue
            if m.group("brace") == "}":
                return out
            if m.group("brace") == "{":
                raise ValueError("unexpected '{'")
            if m.group("name") is None:
                raise ValueError(f"parse error at {text[pos:pos+40]!r}")
            key = m.group("name")
            # next: '{' for message, or scalar value
            m2 = _TOKEN.match(text, pos)
            if m2 and m2.group("brace") == "{":
                pos = m2.end()
                val = parse_block()
            else:
                if m2 is None:
                    raise ValueError("truncated prototxt")
                pos = m2.end()
                if m2.group("string") is not None:
                    val = m2.group("string")[1:-1]
                else:
                    raw = m2.group("value") or m2.group("name")
                    try:
                        val = int(raw)
                    except ValueError:
                        try:
                            val = float(raw)
                        except ValueError:
                            val = {"true": True, "false": False}.get(raw, raw)
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(val)
            else:
                out[key] = val
        return out

    return parse_block()


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# ---------------------------------------------------------------------------
# caffemodel: binary blobs per layer
# ---------------------------------------------------------------------------


def _parse_blob(mv) -> np.ndarray:
    shape: List[int] = []
    legacy = [0, 0, 0, 0]  # num, channels, height, width
    data: List[float] = []
    raw = None
    for f, w, v in _fields(mv):
        if f == 7 and w == 2:  # BlobShape
            for f2, w2, v2 in _fields(v):
                if f2 == 1:
                    shape.extend(_packed_varints(v2) if w2 == 2 else [_signed(v2)])
        elif f == 5:  # packed float data
            if w == 2:
                raw = np.frombuffer(bytes(v), "<f4")
            else:
                import struct

                data.append(struct.unpack("<f", struct.pack("<I", v))[0])
        elif f in (1, 2, 3, 4) and w == 0:
            legacy[f - 1] = _signed(v)
    arr = raw if raw is not None else np.asarray(data, np.float32)
    if not shape and any(legacy):
        shape = [d for d in legacy]
    if shape:
        arr = arr.reshape([int(d) for d in shape])
    return np.ascontiguousarray(arr, np.float32)


def parse_caffemodel(data: bytes) -> Dict[str, List[np.ndarray]]:
    """caffemodel -> {layer_name: [blobs]} (LayerParameter field 100/25)."""
    blobs: Dict[str, List[np.ndarray]] = {}
    for f, w, v in _fields(memoryview(data)):
        if f in (100, 25) and w == 2:  # layer / layers(V1)
            name = ""
            layer_blobs: List[np.ndarray] = []
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:
                    name = bytes(v2).decode()
                elif f2 in (7, 6) and w2 == 2:  # blobs (V1 uses 6)
                    layer_blobs.append(_parse_blob(v2))
            if name and layer_blobs:
                blobs[name] = layer_blobs
    return blobs


# ---------------------------------------------------------------------------
# layer mapping
# ---------------------------------------------------------------------------


def _pair(p: Dict, base: str, fallback=0) -> Tuple[int, int]:
    """kernel/stride/pad h,w resolution (caffe's  X, X_h/X_w convention)."""
    if f"{base}_h" in p or f"{base}_w" in p:
        return int(p.get(f"{base}_h", fallback)), int(p.get(f"{base}_w", fallback))
    v = _as_list(p.get(base))
    if not v:
        return fallback, fallback
    if len(v) == 1:
        return int(v[0]), int(v[0])
    return int(v[0]), int(v[1])


def from_caffe(prototxt: str, caffemodel: Optional[bytes] = None,
               input_shape: Optional[List[int]] = None) -> Graph:
    """Import a Caffe model. `prototxt` is the text (or a path), `caffemodel`
    the binary bytes (or a path); weights are matched to layers by name."""
    if "\n" not in prototxt and prototxt.endswith((".prototxt", ".txt")):
        with open(prototxt) as f:
            prototxt = f.read()
    if isinstance(caffemodel, str):
        with open(caffemodel, "rb") as f:
            caffemodel = f.read()
    net = parse_prototxt(prototxt)
    weights = parse_caffemodel(caffemodel) if caffemodel else {}

    g = Graph(name=str(net.get("name", "caffe")), source_format="caffe")
    env: Dict[str, int] = {}  # caffe top name -> tensor idx

    def const(name: str, arr: np.ndarray) -> int:
        t = g.add_tensor(name, DType.FP32, list(arr.shape), TensorType.CONST,
                         data=np.ascontiguousarray(arr, np.float32))
        return t.idx

    def var(name: str) -> int:
        return g.add_tensor(name, DType.FP32, [], TensorType.VAR).idx

    def emit(op: str, name: str, inputs: List[int], tops: List[str],
             params: Optional[dict] = None) -> None:
        outs = [var(t if t not in env else f"{name}/{t}") for t in tops]
        g.add_node(op, name, inputs, outs, params=params or {})
        for t, o in zip(tops, outs):
            env[t] = o

    # net-level input declaration
    if "input" in net:
        for i, in_name in enumerate(_as_list(net["input"])):
            if input_shape:
                shape = list(input_shape)
            elif "input_shape" in net:
                ish = _as_list(net["input_shape"])[i]
                shape = [int(d) for d in _as_list(ish.get("dim"))]
            elif "input_dim" in net:
                dims = [int(d) for d in _as_list(net["input_dim"])]
                shape = dims[4 * i : 4 * i + 4]
            else:
                shape = [1, 3, 224, 224]
            t = g.add_tensor(in_name, DType.FP32, shape, TensorType.INPUT)
            n = g.add_node("InputOp", in_name, [], [t.idx])
            g.inputs.append(n.idx)
            env[in_name] = t.idx

    layers = _as_list(net.get("layer") or net.get("layers"))
    for L in layers:
        ltype = str(L.get("type", ""))
        name = str(L.get("name", ltype))
        bottoms = [str(b) for b in _as_list(L.get("bottom"))]
        tops = [str(t) for t in _as_list(L.get("top"))]
        phase = L.get("include", {})
        if isinstance(phase, dict) and phase.get("phase") == "TRAIN":
            continue
        wb = weights.get(name, [])

        if ltype in ("Input", "Data", "ImageData"):
            shape = list(input_shape) if input_shape else None
            ip = L.get("input_param", {})
            if shape is None and isinstance(ip, dict) and "shape" in ip:
                shape = [int(d) for d in _as_list(_as_list(ip["shape"])[0].get("dim"))]
            t = g.add_tensor(tops[0], DType.FP32, shape or [1, 3, 224, 224],
                             TensorType.INPUT)
            n = g.add_node("InputOp", name, [], [t.idx])
            g.inputs.append(n.idx)
            env[tops[0]] = t.idx
        elif ltype in ("Convolution", "Deconvolution", "DeConvolution",
                       "DepthwiseConvolution", "ConvolutionDepthwise"):
            p = L.get("convolution_param", {})
            kh, kw = _pair(p, "kernel_size")
            sh, sw = _pair(p, "stride", 1)
            ph, pw = _pair(p, "pad", 0)
            group = int(p.get("group", 1))
            num_out = int(p.get("num_output"))
            dil = int(_as_list(p.get("dilation"))[0]) if p.get("dilation") else 1
            w = wb[0] if wb else np.zeros((num_out, 1, kh, kw), np.float32)
            if w.ndim != 4:
                w = w.reshape(num_out, -1, kh, kw)
            ins = [env[bottoms[0]], const(f"{name}/w", w)]
            if bool(p.get("bias_term", True)) and len(wb) > 1:
                ins.append(const(f"{name}/b", wb[1].reshape(-1)))
            op = "Deconvolution" if ltype in ("Deconvolution", "DeConvolution") else "Convolution"
            if ltype in ("DepthwiseConvolution", "ConvolutionDepthwise"):
                group = num_out
            params = dict(
                kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                dilation_h=dil, dilation_w=dil, group=group, activation=-1,
                pad_h0=ph, pad_h1=ph, pad_w0=pw, pad_w1=pw)
            if op == "Convolution":
                params.update(input_channel=int(w.shape[1] * group), output_channel=num_out)
            else:
                params.update(num_output=num_out, output_pad_h0=0, output_pad_w0=0)
            emit(op, name, ins, tops, params)
        elif ltype == "InnerProduct":
            p = L.get("inner_product_param", {})
            num_out = int(p.get("num_output"))
            w = wb[0].reshape(num_out, -1) if wb else np.zeros((num_out, 1), np.float32)
            ins = [env[bottoms[0]], const(f"{name}/w", w)]
            if len(wb) > 1:
                ins.append(const(f"{name}/b", wb[1].reshape(-1)))
            emit("FullyConnected", name, ins, tops, dict(num_output=num_out))
        elif ltype == "Pooling":
            p = L.get("pooling_param", {})
            kh, kw = _pair(p, "kernel_size")
            sh, sw = _pair(p, "stride", 1)
            ph, pw = _pair(p, "pad", 0)
            alg = 0 if str(p.get("pool", "MAX")).upper() == "MAX" else 1
            emit("Pooling", name, [env[bottoms[0]]], tops, dict(
                alg=alg, kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                global_pool=1 if p.get("global_pooling") else 0,
                caffe_flavor=1,  # caffe's ceil-mode output size
                pad_h0=ph, pad_h1=ph, pad_w0=pw, pad_w1=pw))
        elif ltype == "ReLU":
            p = L.get("relu_param", {})
            emit("ReLu", name, [env[bottoms[0]]], tops,
                 dict(negative_slope=float(p.get("negative_slope", 0.0))))
        elif ltype == "ReLU6":
            emit("ReLu6", name, [env[bottoms[0]]], tops)
        elif ltype == "PReLU":
            slope = wb[0].reshape(-1) if wb else np.zeros(1, np.float32)
            emit("PReLU", name, [env[bottoms[0]], const(f"{name}/slope", slope)], tops)
        elif ltype == "Sigmoid":
            emit("Sigmoid", name, [env[bottoms[0]]], tops)
        elif ltype == "TanH":
            emit("Tanh", name, [env[bottoms[0]]], tops)
        elif ltype == "Softmax":
            p = L.get("softmax_param", {})
            emit("Softmax", name, [env[bottoms[0]]], tops,
                 dict(axis=int(p.get("axis", 1))))
        elif ltype == "BatchNorm":
            mean = wb[0].reshape(-1) if wb else np.zeros(1, np.float32)
            varb = wb[1].reshape(-1) if len(wb) > 1 else np.ones(1, np.float32)
            sf = float(wb[2].reshape(-1)[0]) if len(wb) > 2 else 1.0
            p = L.get("batch_norm_param", {})
            c = mean.size
            ins = [
                env[bottoms[0]],
                const(f"{name}/gamma", np.ones(c, np.float32)),
                const(f"{name}/beta", np.zeros(c, np.float32)),
                const(f"{name}/mean", mean),
                const(f"{name}/var", varb),
            ]
            emit("BatchNormalization", name, ins, tops, dict(
                rescale_factor=sf if sf else 1.0,
                eps=float(p.get("eps", 1e-5)), caffe_flavor=1))
        elif ltype == "Scale":
            p = L.get("scale_param", {})
            gamma = wb[0].reshape(-1) if wb else np.ones(1, np.float32)
            ins = [env[bottoms[0]], const(f"{name}/gamma", gamma)]
            if bool(p.get("bias_term", False)) and len(wb) > 1:
                ins.append(const(f"{name}/beta", wb[1].reshape(-1)))
            emit("Scale", name, ins, tops, dict(axis=int(p.get("axis", 1)), num_axes=1))
        elif ltype == "Eltwise":
            p = L.get("eltwise_param", {})
            op_map = {"PROD": ELT_PROD, "SUM": ELT_SUM, "MAX": ELT_MAX}
            t = op_map[str(p.get("operation", "SUM")).upper()]
            emit("Eltwise", name, [env[b] for b in bottoms], tops, dict(
                type=t, caffe_flavor=1, shift=0.0, power=1.0, scale=1.0))
        elif ltype == "Concat":
            p = L.get("concat_param", {})
            emit("Concat", name, [env[b] for b in bottoms], tops,
                 dict(axis=int(p.get("axis", 1))))
        elif ltype == "Dropout":
            env[tops[0]] = env[bottoms[0]]
        elif ltype == "Flatten":
            p = L.get("flatten_param", {})
            emit("Flatten", name, [env[bottoms[0]]], tops,
                 dict(axis=int(p.get("axis", 1)), end_axis=int(p.get("end_axis", -1))))
        elif ltype == "Reshape":
            p = L.get("reshape_param", {})
            dims = [int(d) for d in _as_list(p.get("shape", {}).get("dim"))]
            emit("Reshape", name, [env[bottoms[0]]], tops,
                 dict(shape=dims, is_onnx=0, is_mxnet=0, reverse=0))
        elif ltype == "Permute":
            p = L.get("permute_param", {})
            emit("Transpose", name, [env[bottoms[0]]], tops,
                 dict(perm=[int(d) for d in _as_list(p.get("order"))]))
        elif ltype == "Upsample":
            p = L.get("upsample_param", {})
            emit("Upsample", name, [env[bottoms[0]]], tops,
                 dict(scale=float(p.get("scale", 2))))
        # --- breadth tier: the rest of caffe2tengine.cpp's op_load_map ------
        elif ltype == "AbsVal":
            emit("Absval", name, [env[bottoms[0]]], tops)
        elif ltype == "Clip":
            p = L.get("clip_param", {})
            emit("Clip", name, [env[bottoms[0]]], tops,
                 dict(min=float(p.get("min", 0.0)), max=float(p.get("max", 6.0))))
        elif ltype == "ELU":
            p = L.get("elu_param", {})
            emit("Elu", name, [env[bottoms[0]]], tops,
                 dict(alpha=float(p.get("alpha", 1.0))))
        elif ltype == "Threshold":
            p = L.get("threshold_param", {})
            emit("Threshold", name, [env[bottoms[0]]], tops,
                 dict(threshold=float(p.get("threshold", 0.0))))
        elif ltype == "Power":
            p = L.get("power_param", {})
            from ..serializer.tm2.format import ELT_POWER

            emit("Eltwise", name, [env[bottoms[0]]], tops, dict(
                type=ELT_POWER, caffe_flavor=1,
                shift=float(p.get("shift", 0.0)),
                power=float(p.get("power", 1.0)),
                scale=float(p.get("scale", 1.0))))
        elif ltype == "LRN":
            p = L.get("lrn_param", {})
            region = str(p.get("norm_region", "ACROSS_CHANNELS"))
            emit("LRN", name, [env[bottoms[0]]], tops, dict(
                local_size=int(p.get("local_size", 5)),
                alpha=float(p.get("alpha", 1e-4)),
                beta=float(p.get("beta", 0.75)),
                norm_region=0 if "ACROSS" in region.upper() or region == 0 else 1,
                k=float(p.get("k", 1.0)), bias=float(p.get("k", 1.0))))
        elif ltype == "MVN":
            p = L.get("mvn_param", {})
            emit("MVN", name, [env[bottoms[0]]], tops, dict(
                across_channels=1 if p.get("across_channels") else 0,
                normalize_variance=0 if p.get("normalize_variance") is False else 1,
                eps=float(p.get("eps", 1e-9))))
        elif ltype == "Normalize":
            p = L.get("norm_param", {})
            ins = [env[bottoms[0]]]
            if wb:
                ins.append(const(f"{name}/scale", wb[0].reshape(-1)))
            emit("Normalize", name, ins, tops, dict(
                across_spatial=1 if p.get("across_spatial") else 0,
                channel_shared=1 if p.get("channel_shared") else 0))
        elif ltype == "Crop":
            p = L.get("crop_param", {})
            offs = [int(o) for o in _as_list(p.get("offset"))] or [0]
            axis = int(p.get("axis", 2))
            ins = [env[b] for b in bottoms]
            emit("Crop", name, ins, tops, dict(
                num_args=len(offs), axis=axis, flag=0, center_crop=0,
                crop_h=0, crop_w=0,
                offset_h=offs[0] if axis <= 2 else 0,
                offset_w=offs[-1] if len(offs) > 1 or axis == 3 else offs[0],
                offset_c=offs[0] if axis == 1 else 0))
        elif ltype == "Reorg":
            p = L.get("reorg_param", {})
            emit("Reorg", name, [env[bottoms[0]]], tops,
                 dict(stride=int(p.get("stride", 2))))
        elif ltype == "ShuffleChannel":
            p = L.get("shuffle_channel_param", {})
            emit("ShuffleChannel", name, [env[bottoms[0]]], tops,
                 dict(group=int(p.get("group", 1))))
        elif ltype == "Slice":
            p = L.get("slice_param", {})
            points = [int(x) for x in _as_list(p.get("slice_point"))]
            emit("Slice", name, [env[bottoms[0]]], tops, dict(
                axis=int(p.get("axis", 1)), slice_points=points,
                iscaffe=1, ismxnet=0, isonnx=0))
        elif ltype == "Split":
            # caffe Split just fans the bottom out to several tops
            for t in tops:
                env[t] = env[bottoms[0]]
        elif ltype == "SoftmaxWithLoss":
            emit("Softmax", name, [env[bottoms[0]]], tops[:1], dict(axis=1))
        elif ltype == "Tile":
            p = L.get("tile_param", {})
            axis = int(p.get("axis", 1))
            tiles = int(p.get("tiles", 1))
            reps = [1, 1, 1, 1]
            reps[3 - axis] = tiles  # IR Tile reps are reversed (tile_ref.c)
            emit("Tile", name, [env[bottoms[0]]], tops,
                 dict(frame_flag=1, reps=reps))
        elif ltype == "Reduction":
            p = L.get("reduction_param", {})
            # caffe ops: SUM=1 ASUM=2 SUMSQ=3 MEAN=4 -> runtime types
            cmap = {1: 0, "SUM": 0, 2: 2, "ASUM": 2, 3: 3, "SUMSQ": 3,
                    4: 1, "MEAN": 1}
            axis = int(p.get("axis", 0))
            dims = list(range(axis, 4)) + [-2] * 4
            emit("Reduction", name, [env[bottoms[0]]], tops, dict(
                dim_0=dims[0], dim_1=dims[1], dim_2=dims[2], dim_3=dims[3],
                type=cmap[p.get("operation", "SUM")], keepdim=0))
        elif ltype == "Interp":
            p = L.get("interp_param", {})
            emit("Interp", name, [env[bottoms[0]]], tops, dict(
                resize_type=2,
                width_scale=float(p.get("zoom_factor", 0)) or 0.0,
                height_scale=float(p.get("zoom_factor", 0)) or 0.0,
                output_width=int(p.get("width", 0)),
                output_height=int(p.get("height", 0))))
        elif ltype == "Resize":
            p = L.get("resize_param", {})
            emit("Resize", name, [env[bottoms[0]]], tops, dict(
                scale_x=float(p.get("scale", 2.0)),
                scale_y=float(p.get("scale", 2.0)), type=0))
        elif ltype == "Embedding":
            p = L.get("embedding_param", {}) or L.get("embed_param", {})
            num_out = int(p.get("num_output", wb[0].shape[-1] if wb else 0))
            ins = [env[bottoms[0]]]
            if wb:
                ins.append(const(f"{name}/w", wb[0].reshape(-1, num_out)))
            if len(wb) > 1 and bool(p.get("bias_term", False)):
                ins.append(const(f"{name}/b", wb[1].reshape(-1)))
            emit("Embedding", name, ins, tops, dict(
                num_output=num_out, input_dim=int(p.get("input_dim", 0)),
                bias_term=1 if len(ins) > 2 else 0, weight_data_size=0))
        elif ltype == "ROIPooling":
            p = L.get("roi_pooling_param", {})
            emit("ROIPooling", name, [env[b] for b in bottoms], tops, dict(
                pooled_h=int(p.get("pooled_h", 0)),
                pooled_w=int(p.get("pooled_w", 0)),
                spatial_scale=float(p.get("spatial_scale", 1.0))))
        elif ltype == "PriorBox":
            p = L.get("prior_box_param", {})
            emit("PriorBox", name, [env[b] for b in bottoms], tops, dict(
                min_sizes=[float(v) for v in _as_list(p.get("min_size"))],
                max_sizes=[float(v) for v in _as_list(p.get("max_size"))],
                variances=[float(v) for v in _as_list(p.get("variance"))] or [0.1],
                aspect_ratios=[float(v) for v in _as_list(p.get("aspect_ratio"))],
                flip=1 if p.get("flip", True) else 0,
                clip=1 if p.get("clip") else 0,
                img_size=0, img_h=0, img_w=0,
                step_w=float(p.get("step", 0.0)),
                step_h=float(p.get("step", 0.0)),
                offset=float(p.get("offset", 0.5)),
                num_priors=0, out_dim=0))
        elif ltype == "DetectionOutput":
            p = L.get("detection_output_param", {})
            nmsp = p.get("nms_param", {}) if isinstance(p.get("nms_param"), dict) else {}
            emit("DetectionOutput", name, [env[b] for b in bottoms], tops, dict(
                num_classes=int(p.get("num_classes", 0)),
                keep_top_k=int(p.get("keep_top_k", 100)),
                nms_top_k=int(nmsp.get("top_k", 100)),
                confidence_threshold=float(p.get("confidence_threshold", 0.01)),
                nms_threshold=float(nmsp.get("nms_threshold", 0.45))))
        elif ltype == "RPN":
            p = L.get("rpn_param", {})
            emit("RPN", name, [env[b] for b in bottoms], tops, dict(
                feat_stride=int(p.get("feat_stride", 16)),
                basesize=int(p.get("basesize", 16)),
                min_size=int(p.get("min_size", 16)),
                per_nms_topn=int(p.get("per_nms_topn", 6000)),
                post_nms_topn=int(p.get("post_nms_topn", 300)),
                nms_thresh=float(p.get("nms_thresh", 0.7)),
                ratios=[float(v) for v in _as_list(p.get("ratio"))] or [0.5, 1, 2],
                anchor_scales=[float(v) for v in _as_list(p.get("anchor_scale"))] or [8, 16, 32],
                anchors=[]))
        else:
            raise NotImplementedError(f"caffe layer type {ltype!r} (layer {name!r})")

    # outputs: tops nobody consumes
    consumed = set()
    for n in g.nodes:
        consumed.update(n.inputs)
    for n in g.nodes:
        if n.op == "InputOp" or not n.outputs:
            continue
        if not any(t in consumed for t in n.outputs):
            g.outputs.append(n.idx)
    return g
