"""Darknet front-end: .cfg (INI-like network description) + .weights (raw
float blobs) -> IR Graph.

Behavior-parity source: the reference's converter
`tools/convert_tool/darknet/darknet2tengine.cpp`:
  * weights header: major/minor/revision int32, then `seen` as a double when
    (major*10+minor) >= 2 (darknet2tengine.cpp:43-86)
  * per-conv blob order: bias[n], then (if batch_normalize) scales/means/vars
    each [n], then weights[n*c/g*k*k]; batch-norm is folded into the conv
    weights at load time with scale = s/sqrt(var+1e-5)
    (load_conv_blob, darknet2tengine.cpp:214-284)
  * section -> op mapping (register_op_load, darknet2tengine.cpp:723-733):
    [convolutional]->Convolution (+ReLu(0.1) for leaky / Mish for mish,
    darknet2tengine.cpp:343-372), [shortcut]->Eltwise SUM,
    [route]->Concat with optional per-input channel Slice (groups/group_id,
    darknet2tengine.cpp:426-577), [upsample]->Upsample(scale=stride),
    [maxpool]->Pooling(caffe_flavor=2, default padding=size-1,
    darknet2tengine.cpp:600-640), [reorg]->Reorg, [region]->Region,
    [yolo]/[dropout]->passthrough Dropout (yolo grid decode is left to the
    application, like the reference examples' yolov3 postprocessing)

Extensions beyond the reference converter (darknet classifier zoo:
darknet19/53, extraction): [avgpool] (global), [softmax], [connected] (FC;
weight blob order bias[out] then weight[out*in], transposed when the header
signals pre-0.2 transposed layout).

PyTorch port: a copy of tengine_tpu/convert/darknet_frontend.py (numpy only),
so both packages build identical IR from one cfg. Sections whose ops have no
lowering in the port yet (Mish, Reorg, Region, Slice, Softmax) still build;
compile_graph raises on them, as on any unregistered op.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.ir import DType, Graph, TensorType
from ..serializer.tm2.format import ELT_SUM, POOL_AVG, POOL_MAX

Section = Tuple[str, Dict[str, str]]


def parse_cfg(text: str) -> List[Section]:
    """Parse darknet .cfg: `[section]` headers + `key=value` lines.

    Mirrors the reference's read_cfg/option list (te_darknet.hpp); comments
    start with '#' or ';'."""
    sections: List[Section] = []
    cur: Optional[Dict[str, str]] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("["):
            name = line[1 : line.index("]")].strip().lower()
            cur = {}
            sections.append((name, cur))
            continue
        if "=" not in line or cur is None:
            continue
        k, _, v = line.partition("=")
        cur[k.strip()] = v.split("#")[0].strip()
    return sections


class _WeightReader:
    """Sequential float reader over the .weights blob."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        major = self.ints(1)[0]
        minor = self.ints(1)[0]
        self.revision = self.ints(1)[0]
        if (major * 10 + minor) >= 2 and major < 1000 and minor < 1000:
            # darknet2tengine.cpp:66-75: seen stored as a double
            self.seen = int(np.frombuffer(buf, np.float64, 1, self.pos)[0])
            self.pos += 8
        else:
            self.seen = self.ints(1)[0]
        self.major, self.minor = major, minor
        # pre-0.2 darknet stored connected-layer weights transposed
        self.transpose = major > 1000 or minor > 1000

    def ints(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.buf, np.int32, n, self.pos)
        self.pos += 4 * n
        return out

    def floats(self, n: int) -> np.ndarray:
        if len(self.buf) - self.pos < 4 * n:
            raise ValueError(
                f"darknet weights file truncated: wanted {n} floats at "
                f"offset {self.pos}, have {(len(self.buf)-self.pos)//4}"
            )
        out = np.frombuffer(self.buf, np.float32, n, self.pos)
        self.pos += 4 * n
        return out

    @property
    def exhausted(self) -> bool:
        return len(self.buf) - self.pos < 4


def _geti(opt: Dict[str, str], key: str, default: int) -> int:
    return int(opt.get(key, default))


def _getf(opt: Dict[str, str], key: str, default: float) -> float:
    return float(opt.get(key, default))


def _int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def from_darknet(cfg, weights, name: str = "darknet") -> Graph:
    """Convert a darknet model. `cfg` is a path or cfg text; `weights` is a
    path or raw bytes (None builds the net with zero weights, like the
    benchmark tmfiles' weight-less graphs)."""
    if isinstance(cfg, str) and os.path.exists(cfg):
        with open(cfg) as f:
            cfg = f.read()
    sections = parse_cfg(cfg)
    if not sections or sections[0][0] not in ("net", "network"):
        raise ValueError("darknet cfg must start with a [net] section")

    if weights is None:
        rd = None
    else:
        if isinstance(weights, (str, os.PathLike)):
            with open(weights, "rb") as f:
                weights = f.read()
        rd = _WeightReader(weights)

    g = Graph(name=name, source_format="darknet")

    net_opt = sections[0][1]
    # batch is kept at 1 (the runtime rebatches via Options.batch_size)
    in_shape = [
        1,
        _geti(net_opt, "channels", 3),
        _geti(net_opt, "height", 416),
        _geti(net_opt, "width", 416),
    ]
    t_in = g.add_tensor("input_0", DType.FP32, in_shape, TensorType.INPUT)
    n_in = g.add_node("InputOp", "input", [], [t_in.idx])
    g.inputs.append(n_in.idx)

    # layer_out[i] = (tensor idx, shape) of section i's output; index 0 is the
    # input, matching the reference's tensor_name_map (darknet2tengine.cpp:106)
    layer_out: List[Tuple[int, List[int]]] = [(t_in.idx, list(in_shape))]

    def const(nm: str, arr: np.ndarray) -> int:
        return g.add_tensor(nm, DType.FP32, arr.shape, TensorType.CONST, data=arr).idx

    def out_tensor(nm: str, shape: List[int]) -> int:
        return g.add_tensor(nm, DType.FP32, shape, TensorType.VAR).idx

    for index, (stype, opt) in enumerate(sections[1:], start=1):
        node_name = f"{stype}_{index}"
        prev_t, prev_shape = layer_out[index - 1]
        nb, c_in, h_in, w_in = (prev_shape + [0, 0, 0, 0])[:4]

        if stype == "convolutional":
            n = _geti(opt, "filters", 1)
            size = _geti(opt, "size", 1)
            stride = _geti(opt, "stride", 1)
            padding = _geti(opt, "padding", 0)
            if _geti(opt, "pad", 0):
                padding = size // 2
            groups = _geti(opt, "groups", 1)
            bn = _geti(opt, "batch_normalize", 0)
            act = opt.get("activation", "logistic")

            if rd is not None:
                bias = rd.floats(n).copy()
                if bn:
                    scales = rd.floats(n)
                    means = rd.floats(n)
                    variances = rd.floats(n)
                w = rd.floats(n * (c_in // groups) * size * size).reshape(
                    n, c_in // groups, size, size
                )
                if bn:
                    # fold BN (load_conv_blob, darknet2tengine.cpp:268-281)
                    scale = scales / np.sqrt(variances + 1e-5)
                    w = w * scale[:, None, None, None]
                    bias = bias - means * scale
                w = np.ascontiguousarray(w, np.float32)
                bias = bias.astype(np.float32)
            else:
                w = np.zeros((n, c_in // groups, size, size), np.float32)
                bias = np.zeros(n, np.float32)

            out_h = (h_in + 2 * padding - size) // stride + 1
            out_w = (w_in + 2 * padding - size) // stride + 1
            to = out_tensor(f"{node_name}_0", [nb, n, out_h, out_w])
            g.add_node(
                "Convolution",
                node_name,
                [prev_t, const(f"{node_name}_w", w), const(f"{node_name}_b", bias)],
                [to],
                dict(
                    kernel_h=size, kernel_w=size, stride_h=stride, stride_w=stride,
                    pad_h0=padding, pad_h1=padding, pad_w0=padding, pad_w1=padding,
                    dilation_h=1, dilation_w=1, group=groups, activation=-1,
                    input_channel=c_in, output_channel=n,
                ),
            )
            if act == "leaky":
                ta = out_tensor(f"leaky_{index}_0", [nb, n, out_h, out_w])
                g.add_node("ReLu", f"leaky_{index}", [to], [ta],
                           dict(negative_slope=0.1))
                to = ta
            elif act == "mish":
                ta = out_tensor(f"mish_{index}_0", [nb, n, out_h, out_w])
                g.add_node("Mish", f"mish_{index}", [to], [ta])
                to = ta
            elif act == "relu":
                ta = out_tensor(f"relu_{index}_0", [nb, n, out_h, out_w])
                g.add_node("ReLu", f"relu_{index}", [to], [ta],
                           dict(negative_slope=0.0))
                to = ta
            layer_out.append((to, [nb, n, out_h, out_w]))

        elif stype == "shortcut":
            frm = int(opt["from"])
            # darknet2tengine.cpp:381-384: negative is relative; positive is
            # used as-is against the tensor map
            frm = index + frm if frm < 0 else frm
            t1, _ = layer_out[frm]
            to = out_tensor(f"{node_name}_0", list(prev_shape))
            g.add_node("Eltwise", node_name, [prev_t, t1], [to],
                       dict(type=ELT_SUM, caffe_flavor=1,
                            shift=0.0, power=1.0, scale=1.0))
            act = opt.get("activation", "linear")
            if act == "leaky":
                ta = out_tensor(f"leaky_{index}_0", list(prev_shape))
                g.add_node("ReLu", f"leaky_{index}", [to], [ta],
                           dict(negative_slope=0.1))
                to = ta
            layer_out.append((to, list(prev_shape)))

        elif stype == "route":
            layers = _int_list(opt["layers"])
            # darknet2tengine.cpp:440-447: negative relative to this section,
            # positive is the darknet layer number (map index + 1)
            srcs = [index + l if l < 0 else l + 1 for l in layers]
            groups_arr = _int_list(opt.get("groups", "")) or [1] * len(srcs)
            gid_arr = _int_list(opt.get("group_id", "")) or [0] * len(srcs)
            ins: List[int] = []
            out_c = 0
            ref_shape = None
            for i, src in enumerate(srcs):
                ti, shape = layer_out[src]
                ref_shape = ref_shape or shape
                if groups_arr[i] == 1:
                    ins.append(ti)
                    out_c += shape[1]
                else:
                    # CSP-style partial route -> channel Slice
                    step = shape[1] // groups_arr[i]
                    sl_shape = [shape[0], step, shape[2], shape[3]]
                    ts = out_tensor(f"route_slice_{index}{i}_0", sl_shape)
                    g.add_node(
                        "Slice", f"route_slice_{index}{i}", [ti], [ts],
                        dict(axis=1, isonnx=1, iscaffe=0, ismxnet=0,
                             begin=step * gid_arr[i],
                             end=step * (gid_arr[i] + 1)),
                    )
                    ins.append(ts)
                    out_c += step
            oshape = [ref_shape[0], out_c, ref_shape[2], ref_shape[3]]
            if len(ins) == 1:
                # single-source route is an identity/slice; still emit the
                # Concat for structural parity with the reference
                pass
            to = out_tensor(f"route_concat{index}_0", oshape)
            g.add_node("Concat", f"route_concat{index}", ins, [to], dict(axis=1))
            layer_out.append((to, oshape))

        elif stype == "upsample":
            scale = _geti(opt, "stride", 2)
            oshape = [nb, c_in, h_in * scale, w_in * scale]
            to = out_tensor(f"{node_name}_0", oshape)
            g.add_node("Upsample", node_name, [prev_t], [to], dict(scale=float(scale)))
            layer_out.append((to, oshape))

        elif stype in ("maxpool", "max"):
            stride = _geti(opt, "stride", 1)
            size = _geti(opt, "size", stride)
            padding = _geti(opt, "padding", size - 1)
            out_h = (h_in + padding - size) // stride + 1
            out_w = (w_in + padding - size) // stride + 1
            oshape = [nb, c_in, out_h, out_w]
            to = out_tensor(f"{node_name}_0", oshape)
            g.add_node(
                "Pooling", node_name, [prev_t], [to],
                dict(alg=POOL_MAX, kernel_h=size, kernel_w=size,
                     stride_h=stride, stride_w=stride, global_pool=0,
                     caffe_flavor=2,
                     pad_h0=padding, pad_h1=padding,
                     pad_w0=padding, pad_w1=padding),
            )
            layer_out.append((to, oshape))

        elif stype == "avgpool":
            oshape = [nb, c_in, 1, 1]
            to = out_tensor(f"{node_name}_0", oshape)
            g.add_node(
                "Pooling", node_name, [prev_t], [to],
                dict(alg=POOL_AVG, kernel_h=h_in, kernel_w=w_in,
                     stride_h=1, stride_w=1, global_pool=1, caffe_flavor=0,
                     pad_h0=0, pad_h1=0, pad_w0=0, pad_w1=0),
            )
            layer_out.append((to, oshape))

        elif stype == "connected":
            n = _geti(opt, "output", 1)
            in_features = c_in * max(h_in, 1) * max(w_in, 1)
            if rd is not None:
                bias = rd.floats(n).astype(np.float32)
                w = rd.floats(in_features * n)
                if rd.transpose:
                    w = w.reshape(in_features, n).T
                else:
                    w = w.reshape(n, in_features)
                w = np.ascontiguousarray(w, np.float32)
            else:
                w = np.zeros((n, in_features), np.float32)
                bias = np.zeros(n, np.float32)
            oshape = [nb, n]
            to = out_tensor(f"{node_name}_0", oshape)
            g.add_node(
                "FullyConnected", node_name,
                [prev_t, const(f"{node_name}_w", w), const(f"{node_name}_b", bias)],
                [to], dict(num_output=n),
            )
            act = opt.get("activation", "linear")
            if act == "leaky":
                ta = out_tensor(f"leaky_{index}_0", oshape)
                g.add_node("ReLu", f"leaky_{index}", [to], [ta],
                           dict(negative_slope=0.1))
                to = ta
            layer_out.append((to, oshape))

        elif stype == "softmax":
            oshape = list(prev_shape)
            to = out_tensor(f"{node_name}_0", oshape)
            g.add_node("Softmax", node_name, [prev_t], [to], dict(axis=1))
            layer_out.append((to, oshape))

        elif stype == "reorg":
            stride = _geti(opt, "stride", 1)
            oshape = [nb, c_in * stride * stride, h_in // stride, w_in // stride]
            to = out_tensor(f"{node_name}_0", oshape)
            g.add_node("Reorg", node_name, [prev_t], [to], dict(stride=stride))
            layer_out.append((to, oshape))

        elif stype == "region":
            p = dict(
                num_classes=_geti(opt, "classes", 20),
                num_box=_geti(opt, "num", 1),
                coords=_geti(opt, "coords", 4),
                nms_threshold=_getf(opt, "thresh", 0.5),
            )
            if "anchors" in opt:
                p["biases"] = [float(x) for x in opt["anchors"].split(",")]
            to = out_tensor(f"{node_name}_0", list(prev_shape))
            g.add_node("Region", node_name, [prev_t], [to], p)
            layer_out.append((to, list(prev_shape)))

        elif stype in ("yolo", "dropout"):
            # passthrough at inference (reference maps both to OP_DROPOUT,
            # darknet2tengine.cpp:727,733); keep yolo attrs for postprocess
            p = {}
            if stype == "yolo":
                p = dict(
                    classes=_geti(opt, "classes", 80),
                    num=_geti(opt, "num", 9),
                    mask=_int_list(opt.get("mask", "")),
                    anchors=[float(x) for x in opt.get("anchors", "").split(",") if x.strip()],
                )
            to = out_tensor(f"{node_name}_0", list(prev_shape))
            g.add_node("Dropout", node_name, [prev_t], [to], p)
            layer_out.append((to, list(prev_shape)))

        elif stype in ("cost",):
            layer_out.append((prev_t, list(prev_shape)))

        else:
            raise NotImplementedError(f"darknet section [{stype}] (section {index})")

    if rd is not None and not rd.exhausted:
        leftover = (len(rd.buf) - rd.pos) // 4
        raise ValueError(
            f"darknet weights not fully consumed: {leftover} floats left — "
            "cfg/weights mismatch"
        )

    # outputs: section outputs nobody consumes (yolo heads, classifier top)
    consumed = set()
    for nd in g.nodes:
        consumed.update(nd.inputs)
    for nd in g.nodes:
        if nd.op == "InputOp" or not nd.outputs:
            continue
        if not any(t in consumed for t in nd.outputs):
            g.outputs.append(nd.idx)
    return g
