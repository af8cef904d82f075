"""Plain-torch op lowerings (the "reference kernel" tier) — PyTorch port of
the subset of tengine_tpu/ops/lowering.py that the quantized yolov5s path
and its fp32 calibration run: activations, Convolution, Pooling, Eltwise,
Concat, Upsample and Noop.

Each function lowers one IR node to eager torch calls on the engine's
device. Semantics follow the reference C kernels and shape-inference rules,
cited per op. These lowerings register at SCORE_REF; optimized candidates
register above them in ops/quantized.py and win selection unless
Options.force_ref_kernels is set. An op with no lowering here raises
NotImplementedError at compile time (ops/registry.py:select_kernel).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .layout import TArr, as_nchw, as_nhwc, as_semantic, like, nhwc, wrap
from .registry import LowerCtx, register_op
from .qmath import node_is_float
from ..serializer.tm2 import format as tmfmt


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


# fused-SiLU activation code — ours, beyond the reference's 0/1/6 clamp set
# (the reference approximates yolov5 SiLU with OP_HARDSWISH after ONNX
# surgery, yolov5s-opt.py; we fuse the exact x*sigmoid(x))
ACT_SILU = 100


def apply_activation(x: torch.Tensor, act: int) -> torch.Tensor:
    """Fused conv/eltwise activation clamp.

    Reference: conv_kernel_ref_fp32.c:112-127 — act 0 => relu, 1 => clamp to
    [-1, 1], 6 => relu6; negative => none. act 100 => SiLU (ours).
    """
    if act is None or act < 0:
        return x
    if act == ACT_SILU:
        return x * torch.sigmoid(x)
    if act == 1:
        return torch.clamp(x, -1.0, 1.0)
    x = torch.clamp_min(x, 0.0)
    if act > 0:
        x = torch.clamp_max(x, float(act))
    return x


def compute_dtype(ctx: LowerCtx) -> torch.dtype:
    """Compute dtype for float graphs: "fp32"/"fp32_fast" -> float32 (TF32
    off, see executor/engine.py), "bf16" -> bfloat16, "fp16" -> float16."""
    if ctx.options.precision == "bf16":
        return torch.bfloat16
    if ctx.options.precision == "fp16":
        return torch.float16
    return torch.float32


def _conv_pads(
    in_h: int, in_w: int, p: dict, kh_eff: int, kw_eff: int
) -> List[Tuple[int, int]]:
    """Explicit (lo, hi) padding; negative pads mean TF-SAME
    (convolution.c infer_shape: pad<0 => out=(in-1)/stride+1)."""
    pads = []
    for (p0, p1, k_eff, stride, size) in (
        (p["pad_h0"], p["pad_h1"], kh_eff, p["stride_h"], in_h),
        (p["pad_w0"], p["pad_w1"], kw_eff, p["stride_w"], in_w),
    ):
        if p0 < 0:
            out = (size - 1) // stride + 1
            total = max(0, (out - 1) * stride + k_eff - size)
            pads.append((total // 2, total - total // 2))
        else:
            pads.append((p0, p1))
    return pads


def conv2d_nhwc(xn, w, pads, stride, dilation, groups):
    """NHWC conv through torch's NCHW conv2d: the NCHW view of an NHWC
    tensor is channels-last, which conv2d takes as is. Asymmetric pads go
    through F.pad (conv2d only pads symmetrically). Returns an NHWC view."""
    x = xn.permute(0, 3, 1, 2)
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        padding = (pt, pl)
    else:
        x = F.pad(x, (pl, pr, pt, pb))
        padding = (0, 0)
    out = F.conv2d(x, w, stride=stride, padding=padding, dilation=dilation, groups=groups)
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------


@register_op("Convolution", predicate=node_is_float)
def lower_conv(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Conv2D with optional bias and fused activation.

    Reference: param convolution.c:35-196 (shape), conv_kernel_ref_fp32.c
    (numerics incl. activation clamp). Weight stays OIHW (torch's layout);
    the activation runs NHWC.
    """
    p = ctx.params
    dil_h, dil_w = p["dilation_h"], p["dilation_w"]
    kh_eff = (p["kernel_h"] - 1) * dil_h + 1
    kw_eff = (p["kernel_w"] - 1) * dil_w + 1

    xn = as_nhwc(x)
    n, in_h, in_w, in_c = xn.shape
    pads = _conv_pads(in_h, in_w, p, kh_eff, kw_eff)

    dt = compute_dtype(ctx)
    w = ctx.weight(1)
    out = conv2d_nhwc(
        xn.to(dt), w.to(dt), pads, (p["stride_h"], p["stride_w"]),
        (dil_h, dil_w), p["group"],
    ).to(torch.float32)
    if ctx.num_inputs > 2:
        out = out + ctx.weight(2).to(torch.float32)
    out = apply_activation(out, p.get("activation", -1))
    return nhwc(out.to(dt) if dt != torch.float32 else out)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def _pool_output_size(size: int, kernel: int, stride: int, pad: int, caffe: int) -> int:
    """pooling_param.h:59-81 calc_output_size."""
    if pad >= 0:
        if caffe == 1:
            out = 2 + (size - kernel + 2 * pad - 1) // stride
            if pad > 0 and (out - 1) * stride >= size + pad:
                out -= 1
            return out
        if caffe == 2:
            return 1 + (size - kernel + pad) // stride
        return 1 + (size - kernel + 2 * pad) // stride
    return 1 + (size - 1) // stride


def _pool_real_pads(out: int, size: int, kernel: int, stride: int, pad_org: int):
    """pooling_param.h:84-104 calc_real_pads."""
    pad_num = max((out - 1) * stride + kernel - size, 0)
    if pad_org < 0:
        return pad_num // 2, pad_num - pad_org
    return pad_org, pad_num - pad_org


@register_op("Pooling")
def lower_pooling(ctx: LowerCtx, x: TArr):
    """Max/avg pool (pooling.c infer_shape + pooling_kernel_ref_fp32.c:95-160).

    Avg divisor: caffe flavors count the window clipped to in+pad (pads
    included); otherwise only valid elements count. Max-pool of integer
    (quantized) values runs in float32, which holds them exactly.
    """
    p = dict(ctx.params)
    xn = as_nhwc(x)
    n, in_h, in_w, c = xn.shape
    caffe_all = p["caffe_flavor"]
    caffe = caffe_all & ~0x10

    glob = p["global_pool"]
    if (
        p["kernel_h"] == in_h
        and p["kernel_w"] == in_w
        and p["pad_h0"] == 0
        and p["pad_h1"] == 0
        and p["pad_w0"] == 0
        and p["pad_w1"] == 0
    ):
        glob = 1
    if glob:
        if p["alg"] == tmfmt.POOL_MAX:
            return nhwc(torch.amax(xn, dim=(1, 2), keepdim=True))
        return nhwc(torch.mean(xn, dim=(1, 2), keepdim=True))

    kh, kw = p["kernel_h"], p["kernel_w"]
    sh, sw = p["stride_h"], p["stride_w"]
    out_h = _pool_output_size(in_h, kh, sh, p["pad_h0"], caffe_all)
    out_w = _pool_output_size(in_w, kw, sw, p["pad_w0"], caffe_all)
    if caffe != 2:
        ph0, ph1 = _pool_real_pads(out_h, in_h, kh, sh, p["pad_h0"])
        pw0, pw1 = _pool_real_pads(out_w, in_w, kw, sw, p["pad_w0"])
    else:
        ph0 = p["pad_h0"] // 2
        ph1 = p["pad_h0"] - ph0
        pw0 = p["pad_w0"] // 2
        pw1 = p["pad_w0"] - pw0

    xc = xn.permute(0, 3, 1, 2)  # NCHW view
    if p["alg"] == tmfmt.POOL_MAX:
        xf = xc.to(torch.float32)
        xf = F.pad(xf, (pw0, pw1, ph0, ph1), value=float("-inf"))
        out = F.max_pool2d(xf, (kh, kw), (sh, sw))[:, :, :out_h, :out_w]
        return nhwc(out.to(xn.dtype).permute(0, 2, 3, 1))

    xf = F.pad(xc.to(torch.float32), (pw0, pw1, ph0, ph1))
    sums = F.avg_pool2d(xf, (kh, kw), (sh, sw), divisor_override=1)[:, :, :out_h, :out_w]

    # divisor per output position (pooling_kernel_ref_fp32.c:119-141)
    oh = np.arange(out_h)[:, None]
    ow = np.arange(out_w)[None, :]
    h_start = oh * sh - ph0
    w_start = ow * sw - pw0
    h_end = np.minimum(h_start + kh, in_h + ph0)
    w_end = np.minimum(w_start + kw, in_w + pw0)
    if caffe_all:
        count = (h_end - h_start) * (w_end - w_start)
    else:
        hs = np.maximum(h_start, 0)
        ws = np.maximum(w_start, 0)
        he = np.minimum(h_end, in_h)
        we = np.minimum(w_end, in_w)
        count = (he - hs) * (we - ws)
    count_t = torch.as_tensor(count.astype(np.float32), device=xf.device)
    out = sums / count_t
    return nhwc(out.permute(0, 2, 3, 1).to(xn.dtype))


# ---------------------------------------------------------------------------
# activations / elementwise unary
# ---------------------------------------------------------------------------


def _unary_op(fn):
    def lower(ctx: LowerCtx, x: TArr):
        return like(x, fn(x.x))

    return lower


register_op("Noop")(_unary_op(lambda x: x))


# ---------------------------------------------------------------------------
# binary / eltwise
# ---------------------------------------------------------------------------


def _bcast_eltwise(x0: torch.Tensor, x1: torch.Tensor, layout: Optional[str]):
    """Reference eltwise broadcast rules (eltwise_ref.c:48-120): scalar,
    same-size, per-channel (size == C), or per-plane (size == H*W)."""
    if x0.numel() == x1.numel() or x1.numel() == 1:
        if x0.shape != x1.shape and x0.numel() == x1.numel():
            x1 = x1.reshape(x0.shape)
        return x0, x1
    if x0.ndim == 4:
        n, a, b, c = x0.shape
        C = c if layout == "NHWC" else a
        H, W = (a, b) if layout == "NHWC" else (b, c)
        if x1.numel() == C:
            shape = [1, 1, 1, C] if layout == "NHWC" else [1, C, 1, 1]
            return x0, x1.reshape(shape)
        if x1.numel() == H * W:
            shape = [1, H, W, 1] if layout == "NHWC" else [1, 1, H, W]
            return x0, x1.reshape(shape)
    return x0, x1  # fall back to torch broadcasting


@register_op("Eltwise")
def lower_eltwise(ctx: LowerCtx, x0: TArr, *rest: TArr):
    """Eltwise binary/unary (eltwise_ref.c + eltwise_param.h types)."""
    t = ctx.params["type"]
    f = tmfmt
    unary = {
        f.ELT_RSQRT: torch.rsqrt, f.ELT_LOG: torch.log, f.ELT_EXP: torch.exp,
        f.ELT_SQRT: torch.sqrt, f.ELT_FLOOR: torch.floor, f.ELT_SQUARE: torch.square,
    }
    if t in unary:
        return like(x0, unary[t](x0.x))
    if t == f.ELT_POWER:
        # caffe Power layer: (shift + scale*x)^power (eltwise_ref.c:268-272)
        p = ctx.params
        return like(
            x0,
            torch.pow(p.get("shift", 0.0) + p.get("scale", 1.0) * x0.x, p.get("power", 1.0)),
        )

    if not rest:
        # scalar variants applied with params
        sc = ctx.params.get("scale", 0.0)
        if t == f.ELT_SUM_SCALAR:
            return like(x0, x0.x + sc)
        if t == f.ELT_PROD_SCALAR:
            return like(x0, x0.x * sc)
        if t == f.ELT_SUB_SCALAR:
            return like(x0, x0.x - sc)
        raise NotImplementedError(f"eltwise type {t} with one input")

    x1t = rest[0]
    # align layouts: prefer x0's
    if x0.x.ndim == 4 and x1t.x.ndim == 4 and x1t.layout != x0.layout:
        x1 = as_nhwc(x1t) if x0.layout == "NHWC" else as_nchw(x1t)
    else:
        x1 = x1t.x
    a, b = _bcast_eltwise(x0.x, x1, x0.layout)
    binary = {
        f.ELT_PROD: torch.mul, f.ELT_PROD_SCALAR: torch.mul,
        f.ELT_SUM: torch.add, f.ELT_SUM_SCALAR: torch.add,
        f.ELT_SUB: torch.sub, f.ELT_SUB_SCALAR: torch.sub,
        f.ELT_MAX: torch.maximum, f.ELT_MIN_SCALAR: torch.minimum,
        f.ELT_DIV: torch.div, f.ELT_POW: torch.pow,
    }
    if t not in binary:
        raise NotImplementedError(f"eltwise type {t}")
    out = binary[t](a, b)
    # our graph-pass extension (split_concat_conv1x1 moves a conv's fused
    # activation onto the sum node); the reference eltwise has no epilogue
    out = apply_activation(out, ctx.params.get("activation", -1))
    return like(x0, out)


# ---------------------------------------------------------------------------
# shape / data-movement ops
# ---------------------------------------------------------------------------


@register_op("Concat")
def lower_concat(ctx: LowerCtx, *xs: TArr):
    axis = ctx.params.get("axis", 1)
    if all(t.x.ndim == 4 for t in xs) and any(t.layout == "NHWC" for t in xs):
        # stay in NHWC, remap the axis
        arrs = [as_nhwc(t) for t in xs]
        return nhwc(torch.cat(arrs, dim={0: 0, 1: 3, 2: 1, 3: 2}[axis % 4]))
    arrs = [as_semantic(t) for t in xs]
    return wrap(torch.cat(arrs, dim=axis))


# ---------------------------------------------------------------------------
# resize / upsample
# ---------------------------------------------------------------------------


def _nearest_nhwc(xn: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize with the reference's scale-floor indexing
    (upsample_ref.c: in_idx = floor(out_idx / scale)), in f32 like the JAX
    lowering computes it."""
    n, h, w, c = xn.shape
    scale_h, scale_w = np.float32(out_h / h), np.float32(out_w / w)
    rows = np.floor(np.arange(out_h, dtype=np.float32) / scale_h).astype(np.int64)
    cols = np.floor(np.arange(out_w, dtype=np.float32) / scale_w).astype(np.int64)
    rows_t = torch.as_tensor(rows, device=xn.device)
    cols_t = torch.as_tensor(cols, device=xn.device)
    return xn.index_select(1, rows_t).index_select(2, cols_t)


@register_op("Upsample")
def lower_upsample(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Nearest upsample by integer scale (upsample_ref.c)."""
    scale = ctx.params.get("scale", 2.0)
    xn = as_nhwc(x)
    n, h, w, c = xn.shape
    return nhwc(_nearest_nhwc(xn, int(h * scale), int(w * scale)))
