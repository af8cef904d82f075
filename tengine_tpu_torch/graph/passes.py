"""Graph-level optimization passes (PyTorch port of the subset of
tengine_tpu/graph/passes.py that the default compile pipeline and the
model builders run: fold_shuffle_gathers, the native-int8 plan's
to_native_int8 and the builders' optimize pipeline among them).

The reference runs these at convert time (tools/convert_tool/utils/
graph_optimizer/graph_opt.cpp:624-947: conv+bn fold, conv+relu fuse,
bn+scale fold, ...). Here they run on the IR before compilation. The passes
are numpy-only and copied unchanged, so both packages build the same IR
(compact, which the TM2 writer runs, too), except where fold_shuffle_gathers
leaves out two faults of the JAX pass (its docstring says which).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set

import numpy as np

from .ir import DType, Graph, Node, QuantParam, TensorType


def _replace_uses(g: Graph, old_tid: int, new_tid: int):
    for n in g.nodes:
        n.inputs = [new_tid if t == old_tid else t for t in n.inputs]
    old = g.tensors[old_tid]
    new = g.tensors[new_tid]
    new.consumers = sorted(set(new.consumers + old.consumers))
    old.consumers = []


def _single_consumer(g: Graph, node: Node) -> Optional[Node]:
    tid = node.outputs[0]
    consumers = [c for c in g.tensors[tid].consumers if c < len(g.nodes)]
    consumers = [c for c in consumers if node.outputs[0] in g.nodes[c].inputs]
    if len(consumers) != 1:
        return None
    return g.nodes[consumers[0]]


def fold_batchnorm(g: Graph) -> int:
    """Fold Conv -> BatchNormalization into the conv weights/bias
    (graph_opt.cpp fuse_conv_bn). Returns number of folds."""
    folds = 0
    for conv in list(g.nodes):
        if conv.op != "Convolution":
            continue
        bn = _single_consumer(g, conv)
        if bn is None or bn.op != "BatchNormalization" or bn.inputs[0] != conv.outputs[0]:
            continue
        p = bn.params
        mean = g.tensors[bn.inputs[3]].data.astype(np.float64)
        var = g.tensors[bn.inputs[4]].data.astype(np.float64)
        rf = p.get("rescale_factor", 1.0)
        rf = 1.0 / rf if rf else 0.0
        s = 1.0 / np.sqrt(var * rf + p.get("eps", 1e-5))
        b = -mean * rf * s
        if not p.get("caffe_flavor", 0):
            gamma = g.tensors[bn.inputs[1]].data.astype(np.float64)
            beta = g.tensors[bn.inputs[2]].data.astype(np.float64)
            s, b = gamma * s, gamma * b + beta

        wt = g.tensors[conv.inputs[1]]
        wt.data = (wt.data.astype(np.float64) * s.reshape(-1, 1, 1, 1)).astype(np.float32)
        if len(conv.inputs) > 2:
            bt = g.tensors[conv.inputs[2]]
            bt.data = (bt.data.astype(np.float64) * s + b).astype(np.float32)
        else:
            bt = g.add_tensor(
                f"{conv.name}/folded_bias", DType.FP32, [int(s.size)],
                TensorType.CONST, data=b.astype(np.float32),
            )
            conv.inputs.append(bt.idx)
            bt.consumers.append(conv.idx)

        # bypass the BN node
        _replace_uses(g, bn.outputs[0], conv.outputs[0])
        if bn.idx in g.outputs:
            g.outputs = [conv.idx if o == bn.idx else o for o in g.outputs]
        bn.op = "Noop"
        bn.inputs = []
        bn.outputs = []
        folds += 1
    if folds:
        dce(g)
    return folds


def fuse_activation(g: Graph) -> int:
    """Fuse Conv -> ReLU/ReLU6 into the conv's activation field
    (graph_opt.cpp fuse_relu). Returns number of fuses."""
    fuses = 0
    for conv in list(g.nodes):
        if conv.op not in ("Convolution", "Deconvolution"):
            continue
        if conv.params.get("activation", -1) >= 0:
            continue
        act = _single_consumer(g, conv)
        if act is None or act.inputs[:1] != [conv.outputs[0]]:
            continue
        if act.op == "ReLu" and not act.params.get("negative_slope"):
            code = 0
        elif act.op == "ReLu6":
            code = 6
        else:
            continue
        conv.params["activation"] = code
        _replace_uses(g, act.outputs[0], conv.outputs[0])
        if act.idx in g.outputs:
            g.outputs = [conv.idx if o == act.idx else o for o in g.outputs]
        act.op = "Noop"
        act.inputs = []
        act.outputs = []
        fuses += 1
    if fuses:
        dce(g)
    return fuses


def fuse_silu(g: Graph) -> int:
    """Fuse Conv -> Sigmoid -> Mul(conv_out, sigmoid_out) into the conv's
    activation field (ACT_SILU). The reference approximates this pattern
    with OP_HARDSWISH at convert time (tools/optimize/yolov5s-opt.py); we
    fuse the exact SiLU. In quantized graphs this removes two
    requant/dequant round-trips per conv (the sigmoid/mul intermediates
    disappear), which is both faster and more accurate."""
    from ..ops.lowering import ACT_SILU
    from ..serializer.tm2.format import ELT_PROD

    fuses = 0
    for conv in list(g.nodes):
        if conv.op != "Convolution" or conv.params.get("activation", -1) >= 0:
            continue
        t0 = conv.outputs[0] if conv.outputs else None
        if t0 is None or conv.idx in g.outputs:
            continue
        consumers = [
            g.nodes[c]
            for c in g.tensors[t0].consumers
            if c < len(g.nodes) and t0 in g.nodes[c].inputs
        ]
        if len(consumers) != 2:
            continue
        sig = next((n for n in consumers if n.op == "Sigmoid"), None)
        mul = next(
            (
                n
                for n in consumers
                if n.op == "BroadMul"
                or (n.op == "Eltwise" and n.params.get("type") == ELT_PROD)
            ),
            None,
        )
        if sig is None or mul is None or sig.idx == mul.idx:
            continue
        if sig.idx in g.outputs:
            continue
        t1 = sig.outputs[0]
        # sigmoid feeds only the mul; mul multiplies exactly {t0, t1}
        if [c for c in g.tensors[t1].consumers if t1 in g.nodes[c].inputs] != [mul.idx]:
            continue
        if sorted(mul.inputs) != sorted([t0, t1]):
            continue
        conv.params["activation"] = ACT_SILU
        _replace_uses(g, mul.outputs[0], t0)
        if mul.idx in g.outputs:
            g.outputs = [conv.idx if o == mul.idx else o for o in g.outputs]
        for n in (sig, mul):
            n.op = "Noop"
            n.inputs = []
            n.outputs = []
        g.tensors[t0].consumers = [
            c for c in g.tensors[t0].consumers if c not in (sig.idx, mul.idx)
        ]
        fuses += 1
    if fuses:
        dce(g)
    return fuses


def dce(g: Graph) -> int:
    """Drop nodes whose outputs nothing consumes (and aren't graph outputs),
    and orphaned Noop shells left by fusion passes."""
    out_nodes = set(g.outputs)
    removed = 0
    changed = True
    while changed:
        changed = False
        live_tensors: Set[int] = set()
        for n in g.nodes:
            if n.op == "Noop" and not n.outputs:
                continue
            live_tensors.update(n.inputs)
        for ni in out_nodes:
            live_tensors.update(g.nodes[ni].outputs)
        for n in g.nodes:
            if n.idx in out_nodes or n.op in ("InputOp",):
                continue
            if not n.outputs and n.op == "Noop":
                continue
            if n.outputs and not any(t in live_tensors for t in n.outputs):
                n.op = "Noop"
                for t in n.inputs:
                    g.tensors[t].consumers = [c for c in g.tensors[t].consumers if c != n.idx]
                n.inputs = []
                n.outputs = []
                removed += 1
                changed = True
    # physically drop dead Noop shells is unnecessary: toposorted() skips them
    return removed


def compact(g: Graph) -> Graph:
    """Rebuild the graph without the Noop shells fusion passes leave behind
    (and without the tensors nothing references any more), remapping node
    and tensor indices densely. Serialization needs this: the reference
    loader rejects nodes with no output ('node N has no output',
    tm2_serializer.c)."""
    ng = Graph(
        layout=g.layout,
        model_layout=g.model_layout,
        name=g.name,
        source_format=g.source_format,
    )
    keep = [n for n in g.nodes if not (n.op == "Noop" and not n.outputs)]
    live_tensors: Set[int] = set()
    for n in keep:
        live_tensors.update(n.inputs)
        live_tensors.update(n.outputs)

    t_map: Dict[int, int] = {}
    for t in g.tensors:
        if t.idx not in live_tensors:
            continue
        nt = ng.add_tensor(
            t.name, t.dtype, list(t.shape), t.tensor_type, data=t.data, quant=t.quant
        )
        nt.layout = t.layout
        t_map[t.idx] = nt.idx

    n_map: Dict[int, int] = {}
    for n in keep:
        nn = ng.add_node(
            n.op,
            n.name,
            [t_map[i] for i in n.inputs],
            [t_map[i] for i in n.outputs],
            params=dict(n.params),
        )
        n_map[n.idx] = nn.idx
    ng.inputs = [n_map[i] for i in g.inputs if i in n_map]
    ng.outputs = [n_map[i] for i in g.outputs if i in n_map]
    return ng

def fuse_focus(g: Graph) -> int:
    """Fold a YOLOv5 Focus stem — four stride-2 StridedSlices + channel
    Concat + KxK/s1 conv — into ONE 2Kx2K stride-2 conv on the original
    input, with the slice structure moved into the weights:

        w'[o, c, 2u+dy, 2v+dx] = w[o, s(dy,dx)*C + c, u, v]

    (s = position of the (dy,dx) slice in the concat). Exact — same sums,
    same padding semantics — i.e. the v6.0 "replace Focus with 6x6/s2 conv"
    change as a weight transform instead of a retrain. The folded conv is
    the stem that ops/cuda/stem_conv.py runs. The reference instead deletes
    Focus offline with ONNX surgery (tools/optimize/yolov5s-opt.py) and
    keeps the slices on the CPU side.
    """
    fused = 0
    for conv in list(g.nodes):
        if conv.op != "Convolution":
            continue
        p = conv.params
        if (
            p.get("group", 1) != 1
            or p.get("stride_h") != 1
            or p.get("stride_w") != 1
            or p.get("dilation_h", 1) != 1
            or p.get("dilation_w", 1) != 1
            or p.get("pad_h0", 0) != p.get("pad_h1", 0)
            or p.get("pad_w0", 0) != p.get("pad_w1", 0)
        ):
            continue
        kh, kw = p["kernel_h"], p["kernel_w"]
        cat_t = g.tensors[conv.inputs[0]]
        if cat_t.producer is None:
            continue
        cat = g.nodes[cat_t.producer]
        if cat.op != "Concat" or cat.params.get("axis") != 1 or len(cat.inputs) != 4:
            continue
        if [c for c in sorted(set(cat_t.consumers)) if cat_t.idx in g.nodes[c].inputs] != [conv.idx]:
            continue
        offs: List[tuple] = []
        src = None
        ok = True
        for tid in cat.inputs:
            t = g.tensors[tid]
            sl = g.nodes[t.producer] if t.producer is not None else None
            q = sl.params if sl is not None else {}
            if (
                sl is None
                or sl.op != "StridedSlice"
                or q.get("stride_h") != 2
                or q.get("stride_w") != 2
                or q.get("stride_c", 1) != 1
                or q.get("stride_n", 1) != 1
                or q.get("begin_c", 0) != 0
                or q.get("begin_n", 0) != 0
                # full-length slices: |end - begin| (the TM2 crop amount,
                # strided_slice.c) must be 0 on every axis
                or any(
                    q.get(f"end_{a}", 0) != q.get(f"begin_{a}", 0) for a in "nchw"
                )
            ):
                ok = False
                break
            if src is None:
                src = sl.inputs[0]
            if sl.inputs[0] != src:
                ok = False
                break
            if [c for c in sorted(set(t.consumers)) if tid in g.nodes[c].inputs] != [cat.idx]:
                ok = False
                break
            offs.append((q.get("begin_h", 0), q.get("begin_w", 0)))
        if not ok or sorted(offs) != [(0, 0), (0, 1), (1, 0), (1, 1)]:
            continue
        w_t = g.tensors[conv.inputs[1]]
        if w_t.data is None:
            continue
        w = np.asarray(w_t.data)
        O, C4 = int(w.shape[0]), int(w.shape[1])
        if C4 % 4:
            continue
        C = C4 // 4
        wn = np.zeros((O, C, 2 * kh, 2 * kw), dtype=w.dtype)
        for si, (dy, dx) in enumerate(offs):
            wn[:, :, dy::2, dx::2] = w[:, si * C : (si + 1) * C]
        w_t.data = np.ascontiguousarray(wn)
        w_t.shape = [O, C, 2 * kh, 2 * kw]
        conv.inputs[0] = src
        g.tensors[src].consumers = sorted(set(g.tensors[src].consumers) | {conv.idx})
        p.update(
            kernel_h=2 * kh,
            kernel_w=2 * kw,
            stride_h=2,
            stride_w=2,
            pad_h0=2 * p.get("pad_h0", 0),
            pad_h1=2 * p.get("pad_h1", 0),
            pad_w0=2 * p.get("pad_w0", 0),
            pad_w1=2 * p.get("pad_w1", 0),
            input_channel=C,
        )
        for nidx in [cat.idx] + [g.tensors[tid].producer for tid in cat.inputs]:
            dead = g.nodes[nidx]
            dead.op = "Noop"
            dead.inputs = []
            dead.outputs = []
        fused += 1
    return fused


def split_concat_conv1x1(g: Graph) -> int:
    """Eliminate channel-Concat nodes whose every consumer is a plain 1x1
    conv: Conv1x1(concat(a, b, ...)) == Conv1x1_a(a) + Conv1x1_b(b) + ...
    with the weight split along input channels (exact in exact arithmetic;
    fp32 differs only in summation order). The conv's fused activation moves
    onto the final sum. Kept so that the port builds the JAX package's IR:
    CSP/C3 blocks (yolov5), SPP tails, and PANet necks all hit this
    pattern. Returns number of concats eliminated."""
    from ..serializer.tm2 import format as tmfmt

    def _is_split_target(conv: Node, cat_out: int) -> bool:
        p = conv.params
        return (
            conv.op == "Convolution"
            and conv.inputs[0] == cat_out
            and p.get("kernel_h") == 1
            and p.get("kernel_w") == 1
            and p.get("stride_h") == 1
            and p.get("stride_w") == 1
            and p.get("group", 1) == 1
            and p.get("dilation_h", 1) == 1
            and p.get("dilation_w", 1) == 1
            and "fused_add_pos" not in p
        )

    split = 0
    for cat in list(g.nodes):
        if cat.op != "Concat" or cat.params.get("axis") != 1 or len(cat.inputs) < 2:
            continue
        cat_out = cat.outputs[0]
        t_cat = g.tensors[cat_out]
        cons = [
            g.nodes[c]
            for c in sorted(set(t_cat.consumers))
            if cat_out in g.nodes[c].inputs
        ]
        if not cons or cat.idx in g.outputs:
            continue
        if not all(_is_split_target(c, cat_out) for c in cons):
            continue
        # every consumer must use the concat ONLY as its data input
        if any(c.inputs.count(cat_out) != 1 for c in cons):
            continue
        if any(g.tensors[c.inputs[1]].data is None for c in cons):
            continue
        spans, off, ok = [], 0, True
        for tid in cat.inputs:
            sh = g.tensors[tid].shape
            if not sh or len(sh) != 4:
                ok = False
                break
            spans.append((off, off + int(sh[1])))
            off += int(sh[1])
        if not ok or any(np.asarray(g.tensors[c.inputs[1]].data).shape[1] != off for c in cons):
            continue

        for conv in cons:
            w_t = g.tensors[conv.inputs[1]]
            w = np.asarray(w_t.data)
            bias = conv.inputs[2] if len(conv.inputs) > 2 else None
            act = conv.params.get("activation", -1)
            part_params = dict(conv.params)
            part_params["activation"] = -1
            prev_tid = None
            part_tids = []
            for i, (src_tid, (c0, c1)) in enumerate(zip(cat.inputs, spans)):
                w_i = g.add_tensor(
                    f"{conv.name}/w_split{i}",
                    w_t.dtype,
                    [w.shape[0], c1 - c0, 1, 1],
                    TensorType.CONST,
                    data=np.ascontiguousarray(w[:, c0:c1]),
                )
                ins = [src_tid, w_i.idx]
                if i == 0 and bias is not None:
                    ins.append(bias)
                out_i = g.add_tensor(f"{conv.name}/part{i}", g.tensors[conv.outputs[0]].dtype)
                pp = dict(part_params)
                pp["input_channel"] = c1 - c0
                g.add_node("Convolution", f"{conv.name}/split{i}", ins, [out_i.idx], params=pp)
                part_tids.append(out_i.idx)
            # fold the parts with a sum tree; the original conv node becomes
            # the final Eltwise (keeps its output tensor + graph position)
            prev_tid = part_tids[0]
            for i, tid in enumerate(part_tids[1:-1]):
                s_out = g.add_tensor(f"{conv.name}/psum{i}", g.tensors[conv.outputs[0]].dtype)
                g.add_node(
                    "Eltwise",
                    f"{conv.name}/padd{i}",
                    [prev_tid, tid],
                    [s_out.idx],
                    params={"type": tmfmt.ELT_SUM},
                )
                prev_tid = s_out.idx
            for tid in conv.inputs:
                t = g.tensors[tid]
                t.consumers = [c for c in t.consumers if c != conv.idx]
            conv.op = "Eltwise"
            conv.inputs = [prev_tid, part_tids[-1]]
            conv.params = {"type": tmfmt.ELT_SUM, "activation": act}
            for tid in conv.inputs:
                t = g.tensors[tid]
                t.consumers = sorted(set(t.consumers) | {conv.idx})
        # retire the concat
        t_cat.consumers = []
        for tid in cat.inputs:
            t = g.tensors[tid]
            t.consumers = [c for c in t.consumers if c != cat.idx]
        cat.op = "Noop"
        cat.inputs = []
        cat.outputs = []
        split += 1
    return split


def stem_conv_s2d(g: Graph, max_in_c: int = 8, min_kernel: int = 4, min_hw: int = 320 * 320) -> int:
    """Rewrite small-input-channel stride-2 convs — the classic 3-channel
    stem (3x3s2 mobilenet, 7x7s2 resnet, 6x6s2 yolov5-after-focus-fold) —
    as SpaceToDepth(2) + a stride-1 conv over 4C channels with re-indexed
    weights. Exact: the same multiply-adds, permuted.

    Per spatial axis, an original tap at offset t (relative to 2*out_idx,
    t in [-p0, k-1-p0]) maps to s2d phase t%2 and plane shift floor(t/2):
        w'[o, (dy*2+dx)*C + c, fy(ty), fx(tx)] = w[o, c, ty+p0h, tx+p0w]
    (dy/dx = tap parities; the (dy,dx,c) channel order matches our
    SpaceToDepth lowering). New pads: p0' = ceil(p0/2); p1' fixed by the
    unchanged output size.

    Opt-in (Options.stem_s2d). Runs at compile time (prerun weight-repack
    analog, cpu_graph.c:143) so quantized weights are permuted too: an
    inserted zero tap encodes as the weight's zero point, each output
    channel's own for per-channel weights (the JAX pass fills those with
    0, which is a nonzero weight where a channel's zero point is not 0)."""
    rewrites = 0
    for conv in list(g.nodes):
        p = conv.params
        if (
            conv.op != "Convolution"
            or p.get("stride_h") != 2
            or p.get("stride_w") != 2
            or p.get("group", 1) != 1
            or p.get("dilation_h", 1) != 1
            or p.get("dilation_w", 1) != 1
            or "fused_add_pos" in p
        ):
            continue
        t_in = g.tensors[conv.inputs[0]]
        t_w = g.tensors[conv.inputs[1]]
        if t_w.data is None or not t_in.shape or len(t_in.shape) != 4:
            continue
        w = np.asarray(t_w.data)
        O, C = int(w.shape[0]), int(w.shape[1])
        if C > max_in_c:
            continue
        H, W = int(t_in.shape[2]), int(t_in.shape[3])
        if H % 2 or W % 2:
            continue
        kh, kw = p["kernel_h"], p["kernel_w"]
        if max(kh, kw) < min_kernel or H * W < min_hw:
            continue
        ph0, ph1 = p.get("pad_h0", 0), p.get("pad_h1", 0)
        pw0, pw1 = p.get("pad_w0", 0), p.get("pad_w1", 0)

        def axis_map(k, p0, p1, size):
            u0 = (-p0) // 2
            k2 = (k - 1 - p0) // 2 - u0 + 1
            out = (size + p0 + p1 - k) // 2 + 1
            p0_new = -u0
            p1_new = (out - 1) + k2 - size // 2 - p0_new
            return u0, k2, p0_new, p1_new, out

        u0y, k2h, p0h2, p1h2, _ = axis_map(kh, ph0, ph1, H)
        u0x, k2w, p0w2, p1w2, _ = axis_map(kw, pw0, pw1, W)
        if min(p1h2, p1w2) < 0:
            continue

        zps = np.asarray([] if t_w.quant is None else t_w.quant.zero_points,
                         np.int64).reshape(-1)
        fill = zps if zps.size == O else np.full(O, zps[0] if zps.size else 0)
        wn = np.empty((O, 4 * C, k2h, k2w), dtype=w.dtype)
        wn[...] = fill.reshape(O, 1, 1, 1).astype(w.dtype)
        for ty in range(-ph0, kh - ph0):
            dy = ty % 2
            uy = (ty - dy) // 2 - u0y
            for tx in range(-pw0, kw - pw0):
                dx = tx % 2
                ux = (tx - dx) // 2 - u0x
                wn[:, (dy * 2 + dx) * C : (dy * 2 + dx + 1) * C, uy, ux] = w[
                    :, :, ty + ph0, tx + pw0
                ]
        t_w.data = np.ascontiguousarray(wn)
        t_w.shape = [O, 4 * C, k2h, k2w]

        s2d_out = g.add_tensor(
            f"{conv.name}/s2d",
            t_in.dtype,
            [int(t_in.shape[0]), 4 * C, H // 2, W // 2],
            quant=t_in.quant,
        )
        g.add_node(
            "SpaceToDepth",
            f"{conv.name}/s2d",
            [conv.inputs[0]],
            [s2d_out.idx],
            # the weight re-indexing above assumes DCR channel order; the
            # engine default is CRD (reference parity), so say it explicitly
            params={"block_size": 2, "mode": "DCR"},
        )
        t_in.consumers = [c for c in t_in.consumers if c != conv.idx]
        conv.inputs[0] = s2d_out.idx
        s2d_out.consumers = sorted(set(s2d_out.consumers) | {conv.idx})
        p.update(
            kernel_h=k2h,
            kernel_w=k2w,
            stride_h=1,
            stride_w=1,
            pad_h0=p0h2,
            pad_h1=p1h2,
            pad_w0=p0w2,
            pad_w1=p1w2,
            input_channel=4 * C,
        )
        rewrites += 1
    return rewrites


def decompose_spp(g: Graph) -> int:
    """Rewrite parallel stride-1 same-pad odd-kernel max-pools of one tensor
    as a chain of the smallest pool (SPP -> SPPF): mp9 = mp5∘mp5,
    mp13 = mp5∘mp9. Max is associative and the pad value is the identity
    (dtype min), so this is exact, and the chained form reuses the smaller
    pools' results. Returns number of pools rewritten."""
    from collections import defaultdict

    by_src: Dict[int, List[Node]] = defaultdict(list)
    for n in g.nodes:
        p = n.params
        k = p.get("kernel_h", 0)
        if (
            n.op == "Pooling"
            and p.get("alg", 0) == 0
            and p.get("stride_h") == 1
            and p.get("stride_w") == 1
            and not p.get("global_pool")
            and p.get("kernel_w") == k
            and k % 2 == 1
            and k > 1
            and all(p.get(f"pad_{a}", -1) == (k - 1) // 2 for a in ("h0", "h1", "w0", "w1"))
        ):
            by_src[n.inputs[0]].append(n)

    rewrites = 0
    for src, pools in by_src.items():
        if len(pools) < 2:
            continue
        pools.sort(key=lambda n: n.params["kernel_h"])
        kernels = [n.params["kernel_h"] for n in pools]
        k0 = kernels[0]
        pad = (k0 - 1) // 2
        for i, (prev, cur) in enumerate(zip(pools, pools[1:])):
            if kernels[i + 1] != kernels[i] + (k0 - 1):
                break
            cur.inputs = [prev.outputs[0]]
            cur.params.update(
                kernel_h=k0, kernel_w=k0, pad_h0=pad, pad_h1=pad, pad_w0=pad, pad_w1=pad
            )
            t_prev = g.tensors[prev.outputs[0]]
            t_prev.consumers = sorted(set(t_prev.consumers) | {cur.idx})
            t_src = g.tensors[src]
            t_src.consumers = [c for c in t_src.consumers if c != cur.idx]
            rewrites += 1
    return rewrites


def _act_quant_ok(t) -> bool:
    return (
        t.quant is not None
        and not t.quant.per_channel
        and t.dtype.name in ("UINT8", "INT8")
    )


def _conv_residual_ok(g: Graph, n: Node, geometry: str = "pallas") -> bool:
    """geometry="pallas": envelope of the qconv_direct kernel
    (tengine_tpu/ops/pallas/qconv.py, not ported yet): group 1, dilation 1,
    stride 1/2, C % 128 == 0. geometry="any": the fast conv lowering's
    requant epilogue handles every conv."""
    if n.op != "Convolution" or len(n.inputs) < 2:
        return False
    p = n.params
    wt = g.tensors[n.inputs[1]]
    if len(wt.shape) != 4:
        return False
    if geometry == "any":
        return True
    k1 = p.get("kernel_h", 1) == 1 and p.get("kernel_w", 1) == 1
    return (
        p.get("group", 1) == 1
        and p.get("dilation_h", 1) == 1
        and p.get("dilation_w", 1) == 1
        and p.get("stride_h", 1) == p.get("stride_w", 1)
        and p.get("stride_h", 1) in (1, 2)
        and p.get("kernel_h", 1) * p.get("kernel_w", 1) <= 49
        and (k1 or int(wt.shape[1]) % 128 == 0)
    )


def fuse_conv_add(g: Graph, geometry: str = "pallas", relaxed_relu: bool = False) -> int:
    """Fuse quantized Convolution -> Eltwise(SUM) residual pairs (the resnet
    block tail) into the conv node, with the add folded into its
    requantization epilogue (ops/quantized.py:_requant_conv_out; bit-faithful:
    both requant steps are reproduced there). The residual tensor is appended
    to the conv's inputs; params record its position and the intermediate
    tensor's quant params. Returns number of fusions.

    Two departures from the JAX pass, which is at fault on the sum chains
    that split_concat_conv1x1 makes (ROADMAP §3): it drops the activation
    that pass moves onto the final sum (yolov5s's SiLU, SegFormer decoder's
    ReLU), and it fuses a second sum into a conv that already took one,
    dropping the first residual (a split of three or more parts). Here a
    sum's ReLU folds into the epilogue as fused_add_relu, a sum with another
    activation stays unfused (the epilogue applies none after the add), and
    a conv takes at most one sum."""
    from ..serializer.tm2 import format as tmfmt

    fused = 0
    for add in list(g.nodes):
        if add.op != "Eltwise" or add.params.get("type") != tmfmt.ELT_SUM:
            continue
        if len(add.inputs) != 2 or add.params.get("activation", -1) not in (-1, 0, None):
            continue  # an activation the epilogue does not apply after the add
        for which in (0, 1):
            mid_tid, r_tid = add.inputs[which], add.inputs[1 - which]
            mid = g.tensors[mid_tid]
            r = g.tensors[r_tid]
            if mid.producer is None or r.data is not None:
                continue
            conv = g.nodes[mid.producer]
            if not _conv_residual_ok(g, conv, geometry) or "fused_add_pos" in conv.params:
                continue
            if _single_consumer(g, conv) is not add:
                continue
            t_out = g.tensors[add.outputs[0]]
            t_x = g.tensors[conv.inputs[0]]
            if not all(_act_quant_ok(t) for t in (t_x, mid, r, t_out)):
                continue
            if not (t_x.dtype == mid.dtype == r.dtype == t_out.dtype):
                continue
            # spatial shapes must match exactly (no broadcast in-kernel)
            if mid.shape and r.shape and list(mid.shape) != list(r.shape):
                continue
            conv.inputs = list(conv.inputs) + [r_tid]
            conv.params["fused_add_pos"] = len(conv.inputs) - 1
            conv.params["fused_add_mid"] = mid_tid
            conv.outputs = [add.outputs[0]]
            g.tensors[add.outputs[0]].producer = conv.idx
            if add.idx in g.outputs:
                # the fused Eltwise was itself a graph output node: remap so
                # Graph.output_tensors keeps resolving its tensor
                g.outputs = [conv.idx if o == add.idx else o for o in g.outputs]
            r.consumers = sorted(set([c for c in r.consumers if c != add.idx] + [conv.idx]))
            mid.consumers = []
            add.op = "Noop"
            add.inputs = []
            add.outputs = []
            if add.params.get("activation", -1) == 0:
                # the sum's own ReLU: applied after the add, as a trailing
                # ReLu's is
                conv.params["fused_add_relu"] = True
            # absorb a trailing same-quant ReLu (relu commutes with the
            # monotonic quantization map: max(q, zp) in the q domain)
            relu = _single_consumer(g, conv)
            if (
                relu is not None
                and relu.op == "ReLu"
                and not relu.params.get("negative_slope")
                and add.idx not in g.outputs
                and conv.idx not in g.outputs
            ):
                t_ro = g.tensors[relu.outputs[0]]
                qo = t_out.quant
                qr = t_ro.quant
                # exact tier: only a same-quant relu commutes (max(q, zp)).
                # relaxed tier ("any" geometry): a relu at its OWN scale also
                # folds — the epilogue multipliers retarget the relu's
                # output grid and relu applies pre-round in that domain
                # (relu commutes with positive scaling); _requant_conv_out
                # handles it via ctx.out_tensor being the relu output.
                if qr is not None and not qr.per_channel and (
                    (
                        float(qo.scales) == float(qr.scales)
                        and int(qo.zero_points) == int(qr.zero_points)
                        and t_ro.dtype == t_out.dtype
                    )
                    or (
                        relaxed_relu
                        and geometry == "any"
                        and conv.params.get("activation", -1) < 0
                        and t_ro.dtype == t_out.dtype
                    )
                ):
                    conv.params["fused_add_relu"] = True
                    orphan_tid = conv.outputs[0]  # the Eltwise-output tensor
                    conv.outputs = [relu.outputs[0]]
                    t_ro.producer = conv.idx
                    g.tensors[orphan_tid].consumers = []
                    g.tensors[conv.params["fused_add_mid"]].consumers = []
                    if relu.idx in g.outputs:
                        g.outputs = [conv.idx if o == relu.idx else o for o in g.outputs]
                    relu.op = "Noop"
                    relu.inputs = []
                    relu.outputs = []
            fused += 1
            break
    return fused

def _consumers_of(g: Graph, tid: int) -> List[int]:
    return [c for c in g.tensors[tid].consumers if tid in g.nodes[c].inputs]


def _is_conv_geom(g: Graph, n, k: int, strides=(1,), pad: int = 0) -> bool:
    if n is None or n.op != "Convolution" or len(n.inputs) < 2:
        return False
    p = n.params
    wt = g.tensors[n.inputs[1]]
    if len(wt.shape) != 4 or int(wt.shape[2]) != k or int(wt.shape[3]) != k:
        return False
    return (
        p.get("group", 1) == 1
        and p.get("dilation_h", 1) == 1
        and p.get("dilation_w", 1) == 1
        and p.get("stride_h", 1) == p.get("stride_w", 1)
        and p.get("stride_h", 1) in strides
        and all(p.get(f"pad_{a}", 0) == pad for a in ("h0", "h1", "w0", "w1"))
    )


def _sym_int8_act(t) -> bool:
    """A symmetric INT8 activation: zero point 0, clipped at +-127 as the
    chain kernel clips. A full-range grid (a TFLite import's, the
    native-int8 plan's) clips at -128, which the kernel does not."""
    return (
        t.quant is not None
        and not t.quant.per_channel
        and t.dtype.name == "INT8"
        and int(np.asarray(t.quant.zero_points).reshape(-1)[0]) == 0
        and not t.quant.full_range
    )


def _sym_int8_weight(t) -> bool:
    if t.quant is None or t.dtype.name != "INT8":
        return False
    zps = np.asarray(t.quant.zero_points).reshape(-1)
    return bool(np.all(zps == 0))


def _match_bottleneck(g: Graph, add) -> Optional[dict]:
    """Match one quantized bottleneck: conv1x1(+act) -> conv3x3 s1 p1(+act)
    -> conv1x1 -> Eltwise SUM (+ optional trailing ReLu), residual = the
    conv1 input (identity) or a 1x1 projection conv on it. Downsample blocks
    (Caffe-resnet style: stride 2 in conv1 AND the projection, 3x3 stays
    stride 1) match too — stride-2 1x1 pad-0 convs consume only the
    even-subsampled input, so the lowering feeds x[::2, ::2] and runs the
    block as stride 1."""
    from ..serializer.tm2 import format as tmfmt

    if add.op != "Eltwise" or add.params.get("type") != tmfmt.ELT_SUM:
        return None
    if len(add.inputs) != 2 or add.params.get("activation", -1) not in (-1, None):
        return None
    for which in (0, 1):
        mid3_tid, r_tid = add.inputs[which], add.inputs[1 - which]
        mid3 = g.tensors[mid3_tid]
        if mid3.producer is None:
            continue
        conv3 = g.nodes[mid3.producer]
        if not _is_conv_geom(g, conv3, 1, (1,), 0):
            continue
        if conv3.params.get("activation", -1) not in (-1, None):
            continue
        mid2 = g.tensors[conv3.inputs[0]]
        if mid2.producer is None:
            continue
        conv2 = g.nodes[mid2.producer]
        if not _is_conv_geom(g, conv2, 3, (1,), 1):
            continue
        mid1 = g.tensors[conv2.inputs[0]]
        if mid1.producer is None:
            continue
        conv1 = g.nodes[mid1.producer]
        if not _is_conv_geom(g, conv1, 1, (1, 2), 0):
            continue
        stride = conv1.params.get("stride_h", 1)
        x_tid = conv1.inputs[0]

        conv4 = None
        if r_tid == x_tid:
            if stride != 1:
                continue
        else:
            r = g.tensors[r_tid]
            if r.producer is None:
                continue
            conv4 = g.nodes[r.producer]
            if not _is_conv_geom(g, conv4, 1, (stride,), 0):
                continue
            if conv4.inputs[0] != x_tid:
                continue
            if conv4.params.get("activation", -1) not in (-1, None):
                continue
            if _consumers_of(g, r_tid) != [add.idx]:
                continue
        # exclusive dataflow through the block
        if _consumers_of(g, mid1.idx) != [conv2.idx]:
            continue
        if _consumers_of(g, mid2.idx) != [conv3.idx]:
            continue
        if _consumers_of(g, mid3_tid) != [add.idx]:
            continue
        # optional trailing relu (any quant scale: the kernel reproduces the
        # separate-node requant)
        relu = _single_consumer(g, add)
        if (
            relu is not None
            and relu.op == "ReLu"
            and not relu.params.get("negative_slope")
            and add.idx not in g.outputs
        ):
            out_node, out_tid = relu, relu.outputs[0]
        else:
            relu, out_node, out_tid = None, add, add.outputs[0]

        # quantization scheme: every activation int8 symmetric
        acts = [g.tensors[t] for t in (x_tid, mid1.idx, mid2.idx, mid3_tid,
                                       r_tid, add.outputs[0], out_tid)]
        if not all(_sym_int8_act(t) for t in acts):
            continue
        convs = [conv1, conv2, conv3] + ([conv4] if conv4 else [])
        if not all(_sym_int8_weight(g.tensors[c.inputs[1]]) for c in convs):
            continue
        if not all(
            len(c.inputs) < 3 or g.tensors[c.inputs[2]].dtype.name == "INT32"
            for c in convs
        ):
            continue
        c_mid = int(g.tensors[conv2.inputs[1]].shape[0])
        c_out = int(g.tensors[conv3.inputs[1]].shape[0])
        c_in = int(g.tensors[conv1.inputs[1]].shape[1])
        return dict(
            conv1=conv1, conv2=conv2, conv3=conv3, conv4=conv4,
            add=add, relu=relu, x_tid=x_tid, r_tid=r_tid,
            mid1=mid1.idx, mid2=mid2.idx, mid3=mid3_tid,
            out_tid=out_tid, out_node=out_node, stride=stride,
            c_in=c_in, c_mid=c_mid, c_out=c_out,
        )
    return None


def fuse_resnet_blocks(g: Graph, min_cmid: int = 0) -> int:
    """Fuse runs of quantized bottleneck residual blocks into
    `FusedResBlockChain` nodes, lowered to the whole-chain kernel
    (ops/cuda/qblock.py) that keeps every intermediate of a block out of
    device memory. Returns the number of blocks fused. Runs before
    fuse_conv_add (which would otherwise absorb the Eltwise into conv3).
    The rewrite is the JAX pass's (tengine_tpu/graph/passes.py), node for
    node, so both engines compile the same IR.

    min_cmid: skip blocks narrower than this (Options.chain_min_cmid)."""
    matches = {}
    for add in g.nodes:
        m = _match_bottleneck(g, add)
        if m is not None and m["c_mid"] >= min_cmid:
            matches[m["x_tid"]] = m

    # debug/experiment knob: restrict fusion to listed c_mid widths
    # (TT_CHAIN_CMID="128,256,512" fuses only those stages)
    _cmid_env = os.environ.get("TT_CHAIN_CMID")
    if _cmid_env:
        allowed = {int(v) for v in _cmid_env.split(",") if v}
        matches = {k: m for k, m in matches.items() if m["c_mid"] in allowed}

    fused_blocks = 0
    consumed = set()
    heads = [
        m for x_tid, m in matches.items()
        # chain heads: blocks whose input is not another matched block's
        # output (those are picked up by walking forward from the head; a
        # broken link simply starts a fresh chain at the break because the
        # breaking conditions below are link-local)
        if not any(
            m2["out_tid"] == x_tid
            and set(_consumers_of(g, x_tid))
            == {m["conv1"].idx, (m["conv4"].idx if m["conv4"] else m["add"].idx)}
            and m2["c_mid"] == m["c_mid"] and m2["c_out"] == m["c_out"]
            and m["stride"] == 1 and m2["out_node"].idx not in g.outputs
            for m2 in matches.values()
        )
    ]
    for first in heads:
        if first["add"].idx in consumed:
            continue
        chain = [first]
        while True:
            nxt = matches.get(chain[-1]["out_tid"])
            if nxt is None or nxt["add"].idx in consumed:
                break
            # chain link: the block output feeds ONLY the next block
            # (conv1 + residual/projection), and geometry stays uniform
            cons = set(_consumers_of(g, chain[-1]["out_tid"]))
            nxt_cons = {nxt["conv1"].idx}
            nxt_cons.add(nxt["conv4"].idx if nxt["conv4"] else nxt["add"].idx)
            if cons != nxt_cons:
                break
            if nxt["stride"] != 1:
                break  # downsample blocks start a new chain (input resolution changes)
            if (nxt["c_mid"], nxt["c_out"]) != (chain[0]["c_mid"], chain[0]["c_out"]):
                break
            if chain[-1]["out_node"].idx in g.outputs:
                break
            chain.append(nxt)

        # build the fused node
        x_tid = first["x_tid"]
        inputs = [x_tid]
        binfos = []
        for m in chain:
            info = dict(
                act1=m["conv1"].params.get("activation", -1),
                act2=m["conv2"].params.get("activation", -1),
                stride=m["stride"],
                mid1=m["mid1"], mid2=m["mid2"], mid3=m["mid3"],
                r_tid=m["r_tid"], add_out=m["add"].outputs[0],
                out_tid=m["out_tid"], has_relu=m["relu"] is not None,
                proj=m["conv4"] is not None,
                c_in=m["c_in"], c_mid=m["c_mid"], c_out=m["c_out"],
            )
            for key, conv in (("w1", m["conv1"]), ("w2", m["conv2"]),
                              ("w3", m["conv3"]), ("w4", m["conv4"])):
                if conv is None:
                    continue
                info[key + "_pos"] = len(inputs)
                inputs.append(conv.inputs[1])
                if len(conv.inputs) > 2:
                    info[key.replace("w", "b") + "_pos"] = len(inputs)
                    inputs.append(conv.inputs[2])
            binfos.append(info)

        out_tid = chain[-1]["out_tid"]
        absorbed = []
        for m in chain:
            absorbed += [m["conv1"], m["conv2"], m["conv3"], m["add"]]
            if m["conv4"] is not None:
                absorbed.append(m["conv4"])
            if m["relu"] is not None:
                absorbed.append(m["relu"])
        absorbed_idx = {n.idx for n in absorbed}
        for tid in set(inputs):
            g.tensors[tid].consumers = [
                c for c in g.tensors[tid].consumers if c not in absorbed_idx
            ]
        node = g.add_node(
            "FusedResBlockChain",
            f"resblocks[{chain[0]['conv1'].name}..x{len(chain)}]",
            inputs, [out_tid], dict(blocks=binfos),
        )
        g.tensors[out_tid].producer = node.idx
        # orphaned intermediate tensors keep their quant params (the lowering
        # reads them by id), but no longer flow
        for m in chain:
            for tid in (m["mid1"], m["mid2"], m["mid3"]):
                g.tensors[tid].consumers = []
            if m is not chain[0]:
                g.tensors[m["x_tid"]].consumers = []
        last_out_node = chain[-1]["out_node"]
        if last_out_node.idx in g.outputs:
            g.outputs = [node.idx if o == last_out_node.idx else o for o in g.outputs]
        for n in absorbed:
            consumed.add(n.idx)
            n.op = "Noop"
            n.inputs = []
            n.outputs = []
        fused_blocks += len(chain)
    return fused_blocks


def optimize(g: Graph) -> Graph:
    """The standard pass pipeline (converter parity), in the JAX package's
    order: bn fold, activation fuses, the focus and SPP rewrites, shapes,
    the concat-conv split, dce. The model builders run it on the frontend's
    graph."""
    fold_batchnorm(g)
    fuse_activation(g)
    fuse_silu(g)
    fuse_focus(g)
    decompose_spp(g)
    ensure_shapes(g)
    split_concat_conv1x1(g)
    dce(g)
    return g


def ensure_shapes(g: Graph) -> None:
    """Fill tensor shapes via a shape-only pass if any Concat input lacks
    one (split_concat_conv1x1 needs channel spans). Best-effort: graphs that
    cannot trace (e.g. missing weights) simply skip shape-dependent passes."""
    need = any(
        not g.tensors[tid].shape
        for n in g.nodes
        if n.op == "Concat"
        for tid in n.inputs
    )
    if not need:
        return
    try:
        from ..executor.engine import infer_shapes

        infer_shapes(g)
    except Exception:
        pass


def _grid(t):
    """The one (scale, zero point, dtype) grid of a per-tensor quantized
    tensor, else None."""
    q = t.quant
    if q is None or q.per_channel:
        return None
    return (float(np.asarray(q.scales)), int(np.asarray(q.zero_points)), t.dtype)


def _scatter_fill(q: QuantParam, out_c: int):
    """The weight code that dequantizes to 0 in each out-channel row, shaped
    to broadcast over [O, C, kh, kw]: the zero point, per tensor or per out
    channel. None when a per-channel grid does not run along axis 0."""
    zps = np.asarray(q.zero_points).reshape(-1)
    if zps.size == 1:
        return zps[0]
    if zps.size != out_c:
        return None
    return zps.reshape(out_c, 1, 1, 1)


def fold_shuffle_gathers(g: Graph) -> int:
    """Fold ShuffleChannel -> Slice chains into their consumers (the
    shufflenet-v2 block tail: concat -> shuffle(g=2) -> slice halves).

    The shuffle materializes a full-C interleave copy and the conv-side
    slice half another C/2. Both vanish exactly:

      * a slice output consumed ONLY by group-1 convs folds into each
        conv's weight: the conv reads the shuffle's INPUT directly and its
        weight scatters to the gathered channel positions (unused columns
        hold the weight zero-point = exact zero contribution, so the
        engine's colsum zero-point corrections stay exact).
      * any other slice output becomes one ChannelGather (a single C/2
        interleave copy) instead of riding the full-C shuffle.

    Slice-less shuffles fold into group-1 conv consumers as a column
    permutation, and through a depthwise consumer into its consumers.

    Exact in the quantized domain because quantize_graph pins one grid
    across the chain (restricted-op scale sharing). Compile-time clone
    only. Returns the number of chains folded.

    Copied from the JAX pass but for two of its faults, which the port
    does not copy:
      * the unused columns of a per-channel weight hold each out-channel's
        own zero point (the JAX pass writes code 0 there, which dequantizes
        to -zp_c * s_c for a per-channel UINT8 weight); a per-channel grid
        that does not run along the out-channel axis takes the
        ChannelGather branch instead;
      * a caffe Slice whose slice_points do not split it into its outputs
        (len(points) != outputs - 1) is left alone (the JAX pass's zip
        truncates and leaves the other outputs without a producer)."""
    if any(
        n.op == "ShuffleChannel" and n.inputs
        and not g.tensors[n.inputs[0]].shape
        for n in g.nodes
    ):
        try:
            from ..executor.engine import infer_shapes

            infer_shapes(g)
        except Exception:
            return 0
    folded = 0
    for sh in list(g.nodes):
        if sh.op != "ShuffleChannel" or not sh.outputs:
            continue
        sl = _single_consumer(g, sh)
        if sl is None or sl.op != "Slice" or sl.inputs[0] != sh.outputs[0]:
            continue
        if sl.params.get("axis", 0) != 1 or not sl.params.get("iscaffe"):
            continue
        t_x = g.tensors[sh.inputs[0]]
        t_mid = g.tensors[sh.outputs[0]]
        if t_mid.idx in g.output_tensors or sh.idx in g.outputs or sl.idx in g.outputs:
            continue
        if not t_x.shape or len(t_x.shape) != 4:
            continue
        C = int(t_x.shape[1])
        grp = sh.params.get("group", 1)
        if grp <= 1 or C % grp:
            continue
        # same-grid requirement (the passes are exact only on one grid)
        g0 = _grid(t_x)
        if g0 is None or _grid(t_mid) != g0:
            continue
        perm = [(k % grp) * (C // grp) + k // grp for k in range(C)]
        points = list(sl.params.get("slice_points") or [])
        n_out = len(sl.outputs)
        if not points:
            step = C // n_out
            points = [step * (i + 1) for i in range(n_out - 1)]
        if len(points) != n_out - 1:
            continue  # a malformed slice: not every output has a range
        starts = [0] + points
        ends = points + [C]

        def _foldable(c, o_tid):
            if not (
                c.op == "Convolution"
                and c.params.get("group", 1) == 1
                and c.inputs and c.inputs[0] == o_tid
                and len(c.inputs) >= 2
            ):
                return False
            tw = g.tensors[c.inputs[1]]
            return (tw.is_const and tw.data is not None and tw.quant is not None
                    and _scatter_fill(tw.quant, int(tw.data.shape[0])) is not None)

        plans = []  # (out_tid, idx, conv_consumers or None)
        ok = True
        for o_tid, s, e in zip(sl.outputs, starts, ends):
            t_o = g.tensors[o_tid]
            if _grid(t_o) != g0 or o_tid in g.output_tensors:
                ok = False
                break
            idx = perm[s:e]
            consumers = [
                g.nodes[c] for c in t_o.consumers if o_tid in g.nodes[c].inputs
            ]
            conv_ok = consumers and all(_foldable(c, o_tid) for c in consumers)
            plans.append((o_tid, idx, consumers if conv_ok else None))
        if not ok:
            continue

        for o_tid, idx, convs in plans:
            t_o = g.tensors[o_tid]
            if convs is not None:
                for conv in convs:
                    tw = g.tensors[conv.inputs[1]]
                    w = tw.data
                    O = int(w.shape[0])
                    q = tw.quant
                    w_new = np.empty((O, C) + w.shape[2:], w.dtype)
                    w_new[...] = _scatter_fill(q, O)
                    w_new[:, idx] = w
                    # weights are often shared per-node in clones; make a
                    # private const so other consumers keep the original
                    wt2 = g.add_tensor(
                        f"{tw.name}/shfold", tw.dtype, list(w_new.shape),
                        TensorType.CONST, data=w_new,
                    )
                    wt2.quant = q
                    conv.inputs[1] = wt2.idx
                    wt2.consumers.append(conv.idx)
                    tw.consumers = [c for c in tw.consumers if c != conv.idx]
                    conv.params["input_channel"] = C
                    conv.inputs[0] = t_x.idx
                    t_x.consumers = sorted(set(t_x.consumers + [conv.idx]))
                t_o.consumers = []
            else:
                n = g.add_node(
                    "ChannelGather", f"{sh.name}/gather{o_tid}",
                    [t_x.idx], [o_tid], params=dict(indices=idx),
                )
                t_o.producer = n.idx
                t_x.consumers = sorted(set(t_x.consumers + [n.idx]))
        t_mid.consumers = []
        t_x.consumers = [c for c in t_x.consumers if c != sh.idx]
        for node in (sh, sl):
            node.op = "Noop"
            node.inputs = []
            node.outputs = []
        folded += 1

    # slice-less shuffles (the stride-2 downsample blocks feed both
    # branches the full shuffled tensor): a pure permutation folds into
    # group-1 conv consumers as W[:, inv_perm]
    for sh in list(g.nodes):
        if sh.op != "ShuffleChannel" or not sh.outputs or not sh.inputs:
            continue
        t_x = g.tensors[sh.inputs[0]]
        t_mid = g.tensors[sh.outputs[0]]
        if t_mid.idx in g.output_tensors or sh.idx in g.outputs:
            continue
        if not t_x.shape or len(t_x.shape) != 4:
            continue
        C = int(t_x.shape[1])
        grp = sh.params.get("group", 1)
        if grp <= 1 or C % grp:
            continue
        if _grid(t_x) is None or _grid(t_mid) != _grid(t_x):
            continue
        consumers = [
            g.nodes[c] for c in t_mid.consumers
            if t_mid.idx in g.nodes[c].inputs
        ]

        def _const_w(c):
            return (
                c.op == "Convolution"
                and c.inputs and c.inputs[0] == t_mid.idx
                and len(c.inputs) >= 2
                and g.tensors[c.inputs[1]].is_const
                and g.tensors[c.inputs[1]].data is not None
                and g.tensors[c.inputs[1]].quant is not None
            )

        def _dw_chain_ok(c):
            """depthwise consumer: the permutation propagates through its
            per-channel weights to ITS consumers, which must all be
            group-1 const-weight convs reading it at input 0."""
            if not (_const_w(c) and c.params.get("group", 1) == C
                    and int(g.tensors[c.inputs[1]].shape[1]) == 1):
                return False
            t_o = g.tensors[c.outputs[0]]
            if t_o.idx in g.output_tensors:
                return False
            nxt = [g.nodes[i] for i in t_o.consumers if t_o.idx in g.nodes[i].inputs]
            return nxt and all(
                n2.op == "Convolution"
                and n2.params.get("group", 1) == 1
                and n2.inputs and n2.inputs[0] == t_o.idx
                and len(n2.inputs) >= 2
                and g.tensors[n2.inputs[1]].is_const
                and g.tensors[n2.inputs[1]].data is not None
                and g.tensors[n2.inputs[1]].quant is not None
                for n2 in nxt
            )

        plain = [c for c in consumers if _const_w(c) and c.params.get("group", 1) == 1]
        dws = [c for c in consumers if c not in plain]
        if not consumers or len(plain) + len(dws) != len(consumers) or not all(
            _dw_chain_ok(c) for c in dws
        ):
            continue
        perm = [(k % grp) * (C // grp) + k // grp for k in range(C)]
        inv = np.argsort(np.asarray(perm))

        def _permuted_w(conv, w_new):
            tw = g.tensors[conv.inputs[1]]
            wt2 = g.add_tensor(
                f"{tw.name}/shperm", tw.dtype, list(w_new.shape),
                TensorType.CONST, data=np.ascontiguousarray(w_new),
            )
            wt2.quant = tw.quant
            conv.inputs[1] = wt2.idx
            wt2.consumers.append(conv.idx)
            tw.consumers = [c for c in tw.consumers if c != conv.idx]
            return tw

        for conv in plain:
            _permuted_w(conv, g.tensors[conv.inputs[1]].data[:, inv])
            conv.inputs[0] = t_x.idx
            t_x.consumers = sorted(set(t_x.consumers + [conv.idx]))
        import copy as _copy

        for dw in dws:
            tw = g.tensors[dw.inputs[1]]
            old = _permuted_w(dw, tw.data[inv])
            wt2 = g.tensors[dw.inputs[1]]
            if old.quant.per_channel:
                wt2.quant = _copy.deepcopy(old.quant)
                wt2.quant.scales = np.asarray(old.quant.scales)[inv]
                wt2.quant.zero_points = np.asarray(old.quant.zero_points)[inv]
            if len(dw.inputs) > 2:
                tb = g.tensors[dw.inputs[2]]
                if tb.data is not None:
                    bt2 = g.add_tensor(
                        f"{tb.name}/shperm", tb.dtype,
                        list(tb.data.shape), TensorType.CONST,
                        data=np.ascontiguousarray(tb.data[inv]),
                    )
                    bt2.quant = tb.quant
                    dw.inputs[2] = bt2.idx
                    bt2.consumers.append(dw.idx)
            dw.inputs[0] = t_x.idx
            t_x.consumers = sorted(set(t_x.consumers + [dw.idx]))
            # the dw's output now carries x-order channels: its consumers'
            # weights permute the same way
            t_o = g.tensors[dw.outputs[0]]
            for n2 in [g.nodes[i] for i in t_o.consumers if t_o.idx in g.nodes[i].inputs]:
                _permuted_w(n2, g.tensors[n2.inputs[1]].data[:, inv])
        t_mid.consumers = []
        t_x.consumers = [c for c in t_x.consumers if c != sh.idx]
        sh.op = "Noop"
        sh.inputs = []
        sh.outputs = []
        folded += 1
    return folded


def to_native_int8(g: Graph) -> int:
    """Rewrite a UINT8-asymmetric quantized graph for the native-int8
    storage/compute plan (Options.quant_native; a compile-time clone only,
    never serialized):

      * internal UINT8 activations shift to INT8: q' = q - 128,
        zp' = zp - 128, an exact relabeling of the same grid
        (QuantParam.full_range marks the [-128, 127] clip span). Graph
        inputs and outputs keep their dtype, so the buffer contract is
        unchanged; the first conv reads UINT8 and the last layer writes it.
      * conv/FC weights stored UINT8-asymmetric requantize to symmetric
        per-channel INT8 (s_c = max|w_f|/127, np.round: half to even). This
        re-rounds each weight once (<= s_c/2), the relaxed tier's contract;
        the exact uint8 engine stays behind quant_relaxed=False or
        quant_mode="ref". A weight shared with a non-conv consumer, or whose
        quant arrays are neither per-tensor nor per-out-channel, is left as
        it is.
      * raw int32 biases (scale s_in*s_w) are rescaled to the new weight
        scales as float32 data in the tensor still declared INT32: the
        dequantized bias values are identical, and every lowering the plan
        reaches reads a bias with astype(np.float32/np.float64).

    INT8-symmetric graphs are already in native form (zp = 0): the pass is a
    no-op there and the engine only flips the storage plan. Returns the
    number of tensors rewritten. Copied from the JAX pass unchanged."""
    boundary = set(g.input_tensors) | set(g.output_tensors)
    changed = 0
    for t in g.tensors:
        if (
            t.is_const
            or t.idx in boundary
            or t.dtype != DType.UINT8
            or t.quant is None
            or t.quant.per_channel
        ):
            continue
        t.dtype = DType.INT8
        t.quant.zero_points = np.asarray(
            int(np.asarray(t.quant.zero_points).reshape(-1)[0]) - 128, np.int32
        )
        t.quant.full_range = True
        changed += 1

    done: Set[int] = set()
    for n in g.nodes:
        if n.op not in ("Convolution", "FullyConnected") or len(n.inputs) < 2:
            continue
        if g.tensors[n.inputs[0]].dtype != DType.INT8:
            continue  # the consumer still reads UINT8 (a graph input)
        tw = g.tensors[n.inputs[1]]
        if (
            tw.idx in done
            or not tw.is_const
            or tw.data is None
            or tw.dtype != DType.UINT8
            or tw.quant is None
        ):
            continue
        if any(
            g.nodes[c].op not in ("Convolution", "FullyConnected")
            for c in tw.consumers
            if c < len(g.nodes) and tw.idx in g.nodes[c].inputs
        ):
            continue  # shared with a non-conv consumer: left as it is
        done.add(tw.idx)
        out_c = tw.shape[0]
        # per-tensor or per-channel uint8 weights: the old scales and zero
        # points broadcast along the out-channel axis 0 before dequantizing
        s_w_old = np.asarray(tw.quant.scales, np.float64).reshape(-1)
        zp_w_old = np.asarray(tw.quant.zero_points, np.float64).reshape(-1)
        if s_w_old.size not in (1, out_c) or zp_w_old.size not in (1, out_c):
            continue  # an unexpected quant-axis layout: left as it is
        if s_w_old.size == 1:
            s_w_old = np.full(out_c, s_w_old[0])
        if zp_w_old.size == 1:
            zp_w_old = np.full(out_c, zp_w_old[0])
        flat_q = tw.data.astype(np.float64).reshape(out_c, -1)
        flat = (flat_q - zp_w_old[:, None]) * s_w_old[:, None]
        s_new = np.maximum(np.abs(flat).max(axis=1) / 127.0, 1e-10)
        q = np.clip(np.round(flat / s_new[:, None]), -127, 127)
        tw.data = q.astype(np.int8).reshape(tw.data.shape)
        tw.dtype = DType.INT8
        tw.quant = QuantParam(
            scales=s_new.astype(np.float32),
            zero_points=np.zeros(out_c, np.int32),
            width=8,
        )
        changed += 1
        if len(n.inputs) > 2:
            tb = g.tensors[n.inputs[2]]
            if tb.data is not None and not np.issubdtype(
                np.asarray(tb.data).dtype, np.floating
            ):
                # raw bias at s_in*s_w_old -> float raw at s_in*s_new: the
                # dequantized value is unchanged
                tb.data = (
                    tb.data.astype(np.float64) * (s_w_old / s_new)
                ).astype(np.float32)
    return changed
