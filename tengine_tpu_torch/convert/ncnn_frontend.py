"""ncnn front-end: .param (text graph) + .bin (weight blobs) -> IR Graph.

Behavior-parity source: the reference converter
`tools/convert_tool/ncnn/ncnn2tengine.cpp` and its per-op param-id schema
`tools/convert_tool/ncnn/operator_param.txt`:
  * .param text: magic 7767517, `layer_count blob_count`, then per layer
    `Type Name num_bottom num_top bottoms... tops... id=value...`
    (load_model_file, ncnn2tengine.cpp:168-360); array params use negative
    ids (real_id = -23300 - id) with a leading element count
  * .bin: per weight blob loaded "with flag" a u32 dtype tag precedes the
    data (0 = raw fp32; 0x01306B47 = fp16); blobs loaded "without flag"
    (BatchNorm/Scale/PReLU/Normalize contents, biases) are raw fp32
    (load_binary_file, ncnn2tengine.cpp:382-640). NOTE: the reference reads
    a tag before Scale/PReLU/Normalize blobs too — real ncnn files do not
    write one there (ncnn ModelBin::load(..., 1)); we follow real ncnn.
  * op mapping ncnn2tengine.cpp:1482-1502; this front-end additionally
    honors the full conv/pool schema (ids 11-16: rect kernels, asymmetric
    pads, fused activation_type) which the reference loader drops.

ncnn blobs have no batch dim; axes in .param are 0-based from channels, so
IR (NCHW) axes are ncnn axis + 1 (load_concat, ncnn2tengine.cpp:1150).

PyTorch port: a copy of tengine_tpu/convert/ncnn_frontend.py (numpy only),
so both packages build identical IR from one .param and .bin.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..graph.ir import DType, Graph, TensorType
from ..serializer.tm2.format import (
    ELT_DIV,
    ELT_MAX,
    ELT_POW,
    ELT_PROD,
    ELT_SUB,
    ELT_SUM,
    POOL_AVG,
    POOL_MAX,
)

NCNN_MAGIC = 7767517
FLAG_FP32 = 0
FLAG_FP16 = 0x01306B47
FLAG_INT8 = 0x000D4B38


class NcnnLayer:
    def __init__(self, op: str, name: str, bottoms: List[str], tops: List[str],
                 attrs: Dict[int, Any]):
        self.op = op
        self.name = name
        self.bottoms = bottoms
        self.tops = tops
        self.attrs = attrs

    def geti(self, k: int, default: int = 0) -> int:
        return int(float(self.attrs.get(k, default)))

    def getf(self, k: int, default: float = 0.0) -> float:
        return float(self.attrs.get(k, default))


def parse_param(text: str) -> List[NcnnLayer]:
    """Parse the .param text format (ncnn2tengine.cpp:168-360)."""
    toks: List[str] = []
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if line:
            toks.extend(line.split())
    pos = 0

    def tok() -> str:
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    magic = int(tok())
    if magic != NCNN_MAGIC:
        raise ValueError(f"not an ncnn param file (magic {magic})")
    layer_count, _blob_count = int(tok()), int(tok())
    layers: List[NcnnLayer] = []
    for _ in range(layer_count):
        op = tok()
        name = tok()
        nb, nt = int(tok()), int(tok())
        bottoms = [tok() for _ in range(nb)]
        tops = [tok() for _ in range(nt)]
        attrs: Dict[int, Any] = {}
        while pos < len(toks) and "=" in toks[pos]:
            kv = tok()
            k, _, v = kv.partition("=")
            k = int(k)
            if k <= -23300:
                k = -23300 - k
                is_array = True
            else:
                is_array = "," in v
            if is_array:
                # array param: "count,v1,v2,..." (ncnn2tengine.cpp:242-330)
                parts = v.split(",")
                attrs[k] = [float(x) for x in parts[1:]] if len(parts) > 1 else []
            else:
                attrs[k] = v
        layers.append(NcnnLayer(op, name, bottoms, tops, attrs))
    return layers


class _BinReader:
    """Sequential reader over the .bin blob."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def floats(self, n: int, with_flag: bool) -> np.ndarray:
        if with_flag:
            (flag,) = struct.unpack_from("<I", self.buf, self.pos)
            self.pos += 4
            if flag == FLAG_FP16:
                raw = np.frombuffer(self.buf, np.float16, n, self.pos)
                self.pos += 2 * n
                self.pos = (self.pos + 3) & ~3  # fp16 data padded to 4 bytes
                return raw.astype(np.float32)
            if flag != FLAG_FP32:
                raise NotImplementedError(f"ncnn weight tag 0x{flag:08X}")
        if len(self.buf) - self.pos < 4 * n:
            raise ValueError(
                f"ncnn bin truncated: wanted {n} floats at offset {self.pos}"
            )
        out = np.frombuffer(self.buf, np.float32, n, self.pos)
        self.pos += 4 * n
        return np.ascontiguousarray(out)


def from_ncnn(param, binfile=None, input_shape=None, name: str = "ncnn") -> Graph:
    """Convert an ncnn model. `param` is a path or .param text; `binfile` is
    a path or raw bytes (None builds weight-less)."""
    if isinstance(param, (str, os.PathLike)) and os.path.exists(param):
        with open(param) as f:
            param = f.read()
    layers = parse_param(param)

    if binfile is None:
        rd = None
    else:
        if isinstance(binfile, (str, os.PathLike)):
            with open(binfile, "rb") as f:
                binfile = f.read()
        rd = _BinReader(binfile)

    g = Graph(name=name, source_format="ncnn")
    env: Dict[str, int] = {}  # blob name -> tensor idx

    def const(nm: str, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr, np.float32)
        return g.add_tensor(nm, DType.FP32, arr.shape, TensorType.CONST, data=arr).idx

    def emit(ir_op: str, L: NcnnLayer, ins: List[int],
             params: Dict[str, Any], n_out: int = 1) -> List[int]:
        outs = [
            g.add_tensor(L.tops[i] if i < len(L.tops) else f"{L.name}_{i}",
                         DType.FP32, [], TensorType.VAR).idx
            for i in range(n_out)
        ]
        g.add_node(ir_op, L.name, ins, outs, params)
        for i, t in enumerate(L.tops[:n_out]):
            env[t] = outs[i]
        return outs

    def fused_activation(L: NcnnLayer):
        """ncnn conv/deconv/ip fused activation_type (id 9):
        1=relu 2=leaky(params[0]) 3=clip(min,max) 4=sigmoid 5=mish 6=hswish."""
        act = L.geti(9, 0)
        if act == 0:
            return
        ap = L.attrs.get(10, [])
        src_t = env[L.tops[0]]
        nm = f"{L.name}_act"
        to = g.add_tensor(f"{nm}_0", DType.FP32, [], TensorType.VAR).idx
        if act == 1:
            g.add_node("ReLu", nm, [src_t], [to], dict(negative_slope=0.0))
        elif act == 2:
            g.add_node("ReLu", nm, [src_t], [to],
                       dict(negative_slope=float(ap[0]) if ap else 0.1))
        elif act == 3:
            g.add_node("Clip", nm, [src_t], [to],
                       dict(min=float(ap[0]), max=float(ap[1])))
        elif act == 4:
            g.add_node("Sigmoid", nm, [src_t], [to], {})
        elif act == 5:
            g.add_node("Mish", nm, [src_t], [to], {})
        elif act == 6:
            g.add_node("HardSwish", nm, [src_t], [to],
                       dict(alpha=1.0 / 6.0, beta=0.5))
        else:
            raise NotImplementedError(f"ncnn activation_type {act}")
        env[L.tops[0]] = to

    for L in layers:
        op = L.op

        if op == "Input":
            # ids 0=w 1=h 2=c (blob has no batch dim)
            if input_shape:
                shape = list(input_shape)
            else:
                shape = [1, L.geti(2, 3), L.geti(1, 224), L.geti(0, 224)]
            t = g.add_tensor(L.tops[0], DType.FP32, shape, TensorType.INPUT)
            n = g.add_node("InputOp", L.name, [], [t.idx])
            g.inputs.append(n.idx)
            env[L.tops[0]] = t.idx

        elif op in ("Convolution", "ConvolutionDepthWise"):
            num_out = L.geti(0)
            kw = L.geti(1)
            kh = L.geti(11, kw)
            dw = L.geti(2, 1)
            dh = L.geti(12, dw)
            sw = L.geti(3, 1)
            sh = L.geti(13, sw)
            pl = L.geti(4, 0)
            pt = L.geti(14, pl)
            pr = L.geti(15, pl)
            pb = L.geti(16, pt)
            bias_term = L.geti(5, 0)
            wlen = L.geti(6)
            group = L.geti(7, num_out if op == "ConvolutionDepthWise" else 1)
            c = wlen // (num_out * kh * kw)  # = in_c/group
            if rd is not None:
                w = rd.floats(wlen, with_flag=True).reshape(num_out, c, kh, kw)
                b = rd.floats(num_out, with_flag=False) if bias_term else None
            else:
                w = np.zeros((num_out, c, kh, kw), np.float32)
                b = np.zeros(num_out, np.float32) if bias_term else None
            ins = [env[L.bottoms[0]], const(f"{L.name}_w", w)]
            if b is not None:
                ins.append(const(f"{L.name}_b", b))
            emit("Convolution", L, ins, dict(
                kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                pad_h0=pt, pad_h1=pb, pad_w0=pl, pad_w1=pr,
                dilation_h=dh, dilation_w=dw, group=group, activation=-1,
                input_channel=c * group, output_channel=num_out))
            fused_activation(L)

        elif op in ("Deconvolution", "DeconvolutionDepthWise"):
            num_out = L.geti(0)
            kw = L.geti(1)
            kh = L.geti(11, kw)
            sw = L.geti(3, 1)
            sh = L.geti(13, sw)
            pl = L.geti(4, 0)
            pt = L.geti(14, pl)
            pr = L.geti(15, pl)
            pb = L.geti(16, pt)
            bias_term = L.geti(5, 0)
            wlen = L.geti(6)
            group = L.geti(7, num_out if op == "DeconvolutionDepthWise" else 1)
            in_c = wlen * group // (num_out * kh * kw)
            if rd is not None:
                w = rd.floats(wlen, with_flag=True).reshape(
                    in_c, num_out // group, kh, kw)
                b = rd.floats(num_out, with_flag=False) if bias_term else None
            else:
                w = np.zeros((in_c, num_out // group, kh, kw), np.float32)
                b = np.zeros(num_out, np.float32) if bias_term else None
            ins = [env[L.bottoms[0]], const(f"{L.name}_w", w)]
            if b is not None:
                ins.append(const(f"{L.name}_b", b))
            emit("Deconvolution", L, ins, dict(
                kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                pad_h0=pt, pad_h1=pb, pad_w0=pl, pad_w1=pr,
                dilation_h=1, dilation_w=1, group=group, activation=-1,
                num_output=num_out, output_pad_h0=0, output_pad_w0=0))
            fused_activation(L)

        elif op == "InnerProduct":
            num_out = L.geti(0)
            bias_term = L.geti(1, 0)
            wlen = L.geti(2)
            if rd is not None:
                w = rd.floats(wlen, with_flag=True).reshape(num_out, -1)
                b = rd.floats(num_out, with_flag=False) if bias_term else None
            else:
                w = np.zeros((num_out, max(wlen // max(num_out, 1), 1)), np.float32)
                b = np.zeros(num_out, np.float32) if bias_term else None
            ins = [env[L.bottoms[0]], const(f"{L.name}_w", w)]
            if b is not None:
                ins.append(const(f"{L.name}_b", b))
            emit("FullyConnected", L, ins, dict(num_output=num_out))
            fused_activation(L)

        elif op == "BatchNorm":
            c = L.geti(0)
            eps = L.getf(1, 0.0)
            if rd is not None:
                slope = rd.floats(c, with_flag=False)
                mean = rd.floats(c, with_flag=False)
                var = rd.floats(c, with_flag=False)
                bias = rd.floats(c, with_flag=False)
            else:
                slope = np.ones(c, np.float32)
                mean = np.zeros(c, np.float32)
                var = np.ones(c, np.float32)
                bias = np.zeros(c, np.float32)
            ins = [env[L.bottoms[0]],
                   const(f"{L.name}_s", slope), const(f"{L.name}_b", bias),
                   const(f"{L.name}_m", mean), const(f"{L.name}_v", var)]
            emit("BatchNormalization", L, ins,
                 dict(rescale_factor=1.0, eps=eps, caffe_flavor=0))

        elif op == "Scale":
            c = L.geti(0)
            bias_term = L.geti(1, 0)
            if rd is not None:
                s = rd.floats(c, with_flag=False)
                b = rd.floats(c, with_flag=False) if bias_term else None
            else:
                s = np.ones(c, np.float32)
                b = np.zeros(c, np.float32) if bias_term else None
            ins = [env[L.bottoms[0]], const(f"{L.name}_s", s)]
            if b is not None:
                ins.append(const(f"{L.name}_b", b))
            emit("Scale", L, ins, dict(axis=1, num_axes=1))

        elif op == "PReLU":
            c = L.geti(0)
            slope = (rd.floats(c, with_flag=False) if rd is not None
                     else np.zeros(c, np.float32))
            emit("PReLU", L, [env[L.bottoms[0]], const(f"{L.name}_s", slope)], {})

        elif op == "Normalize":
            c = L.geti(3)
            s = (rd.floats(c, with_flag=False) if rd is not None
                 else np.ones(c, np.float32))
            emit("Normalize", L, [env[L.bottoms[0]], const(f"{L.name}_s", s)],
                 dict(across_spatial=L.geti(0, 0), channel_shared=L.geti(1, 0)))

        elif op == "MemoryData":
            dims = [L.geti(k) for k in (0, 1, 2) if k in L.attrs]
            n = int(np.prod(dims)) if dims else 1
            data = (rd.floats(n, with_flag=False) if rd is not None
                    else np.zeros(n, np.float32))
            # ncnn dims are (w, h, c) -> store (c, h, w)
            env[L.tops[0]] = const(L.name, data.reshape(list(reversed(dims))))

        elif op == "Pooling":
            ptype = L.geti(0, 0)
            kw = L.geti(1)
            kh = L.geti(11, kw)
            sw = L.geti(2, 1)
            sh = L.geti(12, sw)
            pl = L.geti(3, 0)
            pt = L.geti(13, pl)
            pr = L.geti(14, pl)
            pb = L.geti(15, pt)
            glob = L.geti(4, 0)
            # pad_mode id 5: 0=full (ceil), 1=valid (floor), 2/3 = tf-same
            pad_mode = L.geti(5, 0)
            emit("Pooling", L, [env[L.bottoms[0]]], dict(
                alg=POOL_MAX if ptype == 0 else POOL_AVG,
                kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                global_pool=glob, caffe_flavor=1 if pad_mode == 0 else 0,
                pad_h0=pt, pad_h1=pb, pad_w0=pl, pad_w1=pr))

        elif op == "ReLU":
            emit("ReLu", L, [env[L.bottoms[0]]],
                 dict(negative_slope=L.getf(0, 0.0)))
        elif op == "Sigmoid":
            emit("Sigmoid", L, [env[L.bottoms[0]]], {})
        elif op == "TanH":
            emit("Tanh", L, [env[L.bottoms[0]]], {})
        elif op == "AbsVal":
            emit("Absval", L, [env[L.bottoms[0]]], {})
        elif op == "ELU":
            emit("Elu", L, [env[L.bottoms[0]]], dict(alpha=L.getf(0, 0.1)))
        elif op == "HardSigmoid":
            emit("Hardsigmoid", L, [env[L.bottoms[0]]],
                 dict(alpha=L.getf(0, 0.2), beta=L.getf(1, 0.5)))
        elif op == "HardSwish":
            emit("HardSwish", L, [env[L.bottoms[0]]],
                 dict(alpha=L.getf(0, 0.2), beta=L.getf(1, 0.5)))
        elif op == "Mish":
            emit("Mish", L, [env[L.bottoms[0]]], {})
        elif op == "Clip":
            emit("Clip", L, [env[L.bottoms[0]]],
                 dict(min=L.getf(0, -3.4e38), max=L.getf(1, 3.4e38)))
        elif op == "Concat":
            emit("Concat", L, [env[b] for b in L.bottoms],
                 dict(axis=L.geti(0, 0) + 1))
        elif op == "Softmax":
            emit("Softmax", L, [env[L.bottoms[0]]],
                 dict(axis=L.geti(0, 0) + 1))
        elif op == "Dropout":
            emit("Dropout", L, [env[L.bottoms[0]]], {})
        elif op == "Flatten":
            emit("Flatten", L, [env[L.bottoms[0]]], dict(axis=1, end_axis=-1))
        elif op == "Reshape":
            # ids 0=w 1=h 2=c 3=d, -233 = unset (load_reshape,
            # ncnn2tengine.cpp:1246-1292); emitted outermost-first
            dims = []
            for k in (3, 2, 1, 0):
                if k in L.attrs and L.geti(k) != -233:
                    dims.append(L.geti(k))
            emit("Reshape", L, [env[L.bottoms[0]]],
                 dict(shape=[1] + dims, is_onnx=1, is_mxnet=0, reverse=0))
        elif op == "Eltwise":
            t = {0: ELT_PROD, 1: ELT_SUM, 2: ELT_MAX}.get(L.geti(0, 1), ELT_SUM)
            emit("Eltwise", L, [env[b] for b in L.bottoms],
                 dict(type=t, caffe_flavor=0, shift=0.0, power=1.0, scale=1.0))
        elif op == "BinaryOp":
            t = {0: ELT_SUM, 1: ELT_SUB, 2: ELT_PROD, 3: ELT_DIV,
                 4: ELT_MAX, 6: ELT_POW}.get(L.geti(0, 0))
            if t is None:
                raise NotImplementedError(f"ncnn BinaryOp type {L.geti(0)}")
            ins = [env[b] for b in L.bottoms]
            if L.geti(1, 0):  # with_scalar
                ins.append(const(f"{L.name}_b", np.asarray([L.getf(2)], np.float32)))
            emit("Eltwise", L, ins,
                 dict(type=t, caffe_flavor=0, shift=0.0, power=1.0, scale=1.0))
        elif op == "UnaryOp":
            emit("Unary", L, [env[L.bottoms[0]]], dict(type=L.geti(0, 0)))
        elif op == "Interp":
            emit("Interp", L, [env[L.bottoms[0]]], dict(
                resize_type=L.geti(0, 1),
                height_scale=L.getf(1, 1.0), width_scale=L.getf(2, 1.0),
                output_height=L.geti(3, 0), output_width=L.geti(4, 0)))
        elif op == "Slice":
            # id 0 array = per-output sizes; -233 = "take the remainder".
            # Caffe-style slice_points are the cut positions (cumsum of the
            # explicit sizes, at most len(tops)-1 cuts).
            sizes = [int(v) for v in L.attrs.get(0, []) if int(v) != -233]
            cuts = np.cumsum(sizes).tolist()[: max(len(L.tops) - 1, 0)]
            emit("Slice", L, [env[L.bottoms[0]]],
                 dict(axis=L.geti(1, 0) + 1, iscaffe=1, slice_points=cuts),
                 n_out=len(L.tops))
        elif op == "ShuffleChannel":
            emit("ShuffleChannel", L, [env[L.bottoms[0]]],
                 dict(group=L.geti(0, 1)))
        elif op == "Permute":
            # ncnn order id 0 on (c,h,w); 0=whc keep etc. Common cases map
            # to NCHW perms with batch fixed
            order = L.geti(0, 0)
            perms = {0: [0, 1, 2, 3], 1: [0, 1, 3, 2], 2: [0, 2, 1, 3],
                     3: [0, 2, 3, 1], 4: [0, 3, 1, 2], 5: [0, 3, 2, 1]}
            emit("Transpose", L, [env[L.bottoms[0]]], dict(perm=perms[order]))
        elif op == "Split":
            # tee: all tops alias the single bottom
            src_t = env[L.bottoms[0]]
            for t in L.tops:
                env[t] = src_t
        elif op == "Noop":
            emit("Noop", L, [env[b] for b in L.bottoms], {})
        else:
            raise NotImplementedError(f"ncnn layer {op!r} (layer {L.name!r})")

    # outputs: blobs nobody consumes
    consumed = set()
    for nd in g.nodes:
        consumed.update(nd.inputs)
    for nd in g.nodes:
        if nd.op == "InputOp" or not nd.outputs:
            continue
        if not any(t in consumed for t in nd.outputs):
            g.outputs.append(nd.idx)
    return g
