"""Plain-torch op lowerings (the "reference kernel" tier) — PyTorch port of
tengine_tpu/ops/lowering.py, every op type it registers: Convolution and
Deconvolution, Pooling, FullyConnected, Gemm and MatMul, the
normalizations (BatchNormalization, Scale, Normalize, L2Normalization,
LRN, InstanceNorm, LayerNorm, MVN), the activations (ReLu incl. leaky,
PReLU, the unary table, Elu, Selu, HardSwish, Hardsigmoid, Clip,
Threshold, Unary), Dropout, Noop, the elementwise Eltwise, BroadMul,
Maximum, Minimum, SquaredDifference, Addn and Mean, Softmax and
LogSoftmax, the reductions and selections ArgMax, ArgMin, TopKV2,
Reduction and ReduceL2, the shape ops Concat, Flatten, Reshape, Permute,
Transpose, SwapAxis, Squeeze, Unsqueeze, Expanddims, Shape, Slice, Split,
StridedSlice, Crop, Pad, Tile, Expand, ShuffleChannel, ChannelGather,
SpaceToDepth, DepthToSpace and Reorg, Gather, Cast, Comparison, Logical,
Reverse and Where, and the resizes Upsample, Interp and
Resize/BilinearResize. Where torch's semantics are not JAX's (a float ->
int cast, jnp.take's indices, lax.top_k's order, jnp.mean's compiled
reciprocal), the lowering computes JAX's.

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

from .layout import (
    TArr, as_nchw, as_nhwc, as_semantic, channel_axis, like, nchw, nhwc, semantic_axis,
    semantic_shape, wrap,
)
from .detection import _top_k
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
    w = ctx.weight(1, tag="oihw")  # the tag parallel/sharding.py's rule reads
    out = conv2d_nhwc(
        xn.to(dt), w.to(dt), pads, (p["stride_h"], p["stride_w"]),
        (dil_h, dil_w), p["group"],
    ).to(torch.float32)
    if ctx.num_inputs > 2:
        out = out + ctx.weight(2).to(torch.float32)
    out = apply_activation(out, p.get("activation", -1))
    return nhwc(out.to(dt) if dt != torch.float32 else out)


@register_op("Deconvolution")
def lower_deconv(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Transposed conv (deconvolution.c infer_shape):
    out = (in - 1) * stride + out_pad + k_eff - pad0 - pad1.

    Also serves quantized graphs (deconv_ref uint8 semantics): the engine's
    generic wrapper dequantizes the activation and requantizes the output;
    quantized weights/bias are dequantized host-side here.

    The JAX lowering runs a forward conv of the stride-dilated input with the
    flipped kernel, padded by k_eff - 1 - pad (the hi side + output_pad).
    Here conv_transpose2d computes the full transposed conv (no padding, the
    same sums), and one F.pad crops pad0 from the front and pad1 - out_pad
    from the back (a negative crop appends zeros): the same window."""
    p = ctx.params
    dil_h, dil_w = p["dilation_h"], p["dilation_w"]
    group = p["group"]

    # the tmfile deconv weight is [in_c, out_c/group, kh, kw] (IOHW): the
    # layout conv_transpose2d takes as is
    def weight_f32(a: np.ndarray) -> np.ndarray:
        t_w = ctx.in_tensor(1)
        if t_w.quant is not None and not np.issubdtype(a.dtype, np.floating):
            from . import qmath

            a = qmath.dequantize_weight_np(a, t_w.quant, "Deconvolution", group)
        return a.astype(np.float32)

    w = ctx.weight(1, weight_f32, tag="iohw_f32")
    dt = compute_dtype(ctx)
    full = F.conv_transpose2d(
        as_nchw(x).to(dt), w.to(dt), stride=(p["stride_h"], p["stride_w"]),
        dilation=(dil_h, dil_w), groups=group,
    ).to(torch.float32)
    out = F.pad(full, (
        -p["pad_w0"], p.get("output_pad_w0", 0) - p["pad_w1"],
        -p["pad_h0"], p.get("output_pad_h0", 0) - p["pad_h1"],
    )).permute(0, 2, 3, 1)
    if ctx.num_inputs > 2:

        def bias_f():
            t_b = ctx.in_tensor(2)
            b = t_b.data
            if t_b.quant is not None and not np.issubdtype(b.dtype, np.floating):
                from . import qmath

                return qmath.dequantize_np(b, t_b.quant, channel_axis=0)
            return b.astype(np.float32)

        out = out + ctx.get_param("bias_deq", bias_f)
    out = apply_activation(out, p.get("activation", -1))
    return nhwc(out)


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

    def divisor():
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
        return count.astype(np.float32)

    # a compile-time param at the compiled size: the forward makes no host upload
    out = sums / ctx.get_param("avg_count", divisor)
    return nhwc(out.permute(0, 2, 3, 1).to(xn.dtype))


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


def fc_output(out: torch.Tensor, rank: int) -> TArr:
    """[M, N] FC result in the input's rank, trailing 1s in NCHW order
    ([M, N], [M, N, 1], [M, N, 1, 1]; fc.c infer_shape)."""
    m, n_out = out.shape
    if rank == 3:
        out = out.reshape(m, n_out, 1)
    elif rank == 4:
        out = out.reshape(m, n_out, 1, 1)
    return TArr(out, "NCHW" if rank == 4 else None)


@register_op("FullyConnected", predicate=node_is_float)
def lower_fc(ctx: LowerCtx, x: TArr, *rest: TArr):
    """FC: flatten input to [M, K] in NCHW order, weight [N, K] (fc.c
    infer_shape). Full float32 under "fp32" (TF32 off, executor/engine.py)."""
    xs = as_semantic(x)
    xf = xs.reshape(xs.shape[0], -1)
    dt = compute_dtype(ctx)
    out = (xf.to(dt) @ ctx.weight(1).to(dt).T).to(torch.float32)
    if ctx.num_inputs > 2:
        out = out + ctx.weight(2).to(torch.float32)
    return fc_output(out, xs.ndim)


def _reversed_axes(t: torch.Tensor) -> torch.Tensor:
    """numpy's .T: every axis reversed."""
    return t.permute(*range(t.ndim - 1, -1, -1))


@register_op("Gemm")
def lower_gemm(ctx: LowerCtx, a: TArr, b: TArr, *rest: TArr):
    """GEMM: alpha*op(A)op(B) + beta*C (gemm.c)."""
    p = ctx.params
    A = as_semantic(a)
    B = as_semantic(b)
    if p.get("transA"):
        A = _reversed_axes(A)
    if p.get("transB"):
        B = _reversed_axes(B)
    out = p.get("alpha", 1.0) * torch.matmul(A, B)
    if ctx.num_inputs > 2:
        out = out + p.get("beta", 1.0) * as_semantic(rest[0])
    return wrap(out)


@register_op("MatMul")
def lower_matmul(ctx: LowerCtx, a: TArr, b: TArr):
    """Batched matmul in fp32 (TF32 off, executor/engine.py), as the JAX
    lowering's Precision.HIGHEST: the attention's q@k and attn@v and every
    token Linear (x @ wT, the weight a const input)."""
    return wrap(torch.matmul(as_semantic(a), as_semantic(b)))


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


@register_op("BatchNormalization")
def lower_batchnorm(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Inference BN (batchnorm_ref.c:56-105): inputs
    [x, gamma, beta, mean, var]; rf = 1/rescale_factor (0 if unset);
    y = x * s + b with s = 1/sqrt(var*rf + eps), b = -mean*rf*s, then
    gamma/beta unless caffe_flavor. The fold runs in float64 on the host
    and [s, b] is cast to f32 once, a compile-time param. The channel axis
    is the layout's on a 4-D tensor, else axis 1 (the last one of a 2-D
    FC output), as in the JAX lowering."""
    p = ctx.params

    def folded():
        mean = ctx.const_data(3).astype(np.float64)
        var = ctx.const_data(4).astype(np.float64)
        rf = p["rescale_factor"]
        rf = 1.0 / rf if rf else 0.0
        s = 1.0 / np.sqrt(var * rf + p["eps"])
        b = -mean * rf * s
        if not p["caffe_flavor"]:
            gamma = ctx.const_data(1).astype(np.float64)
            beta = ctx.const_data(2).astype(np.float64)
            s, b = gamma * s, gamma * b + beta
        return np.stack([s, b]).astype(np.float32)

    sb = ctx.get_param("bn_sb", folded)
    s, b = sb[0], sb[1]
    nd = x.x.ndim
    shape = [1] * nd
    if nd == 4:
        shape[channel_axis(x)] = s.shape[0]
    else:
        shape[1 if nd > 1 else 0] = s.shape[0]
    return like(x, x.x * s.reshape(shape) + b.reshape(shape))


@register_op("Scale")
def lower_scale(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Caffe Scale: per-channel gamma (+ beta) (scale_ref.c)."""
    cax = channel_axis(x) if x.x.ndim == 4 else 1
    shape = [1] * x.x.ndim
    gamma = ctx.weight(1)
    shape[cax] = gamma.shape[0] if gamma.ndim else 1
    out = x.x * gamma.reshape(shape)
    if ctx.num_inputs > 2:
        out = out + ctx.weight(2).reshape(shape)
    return like(x, out)


@register_op("Normalize")
def lower_normalize(ctx: LowerCtx, x: TArr, *rest: TArr):
    """SSD Normalize: L2 across channels, per-channel scale
    (normalize_ref.c; across_spatial unsupported there too)."""
    xn = as_nhwc(x)
    out = xn * torch.rsqrt(torch.sum(xn * xn, dim=3, keepdim=True) + 1e-10)
    if ctx.num_inputs > 1:
        out = out * ctx.weight(1).reshape(1, 1, 1, -1)
    return nhwc(out)


@register_op("L2Normalization")
def lower_l2norm(ctx: LowerCtx, x: TArr):
    """L2-normalize over the channel axis, no epsilon: the reference kernel
    normalizes dims[1] elements (l2normalization_ref.c:115 channel_size =
    dims[1]), i.e. the embedding axis of (N, C) / (N, C, 1, 1) heads."""
    xs = as_semantic(x)
    axis = 1 if xs.ndim > 1 else 0
    return wrap(xs * torch.rsqrt(torch.sum(xs * xs, dim=axis, keepdim=True)))


def _mean(x: torch.Tensor, dims, keepdim: bool = True) -> torch.Tensor:
    """jnp.mean as XLA compiles it: the sum times the f32 reciprocal of the
    count (a division by a constant becomes a multiply; ROADMAP §3)."""
    dims = tuple(dims)
    n = int(np.prod([x.shape[d] for d in dims]))
    return torch.sum(x, dim=dims, keepdim=keepdim) * float(np.float32(1.0) / np.float32(n))


@register_op("LRN")
def lower_lrn(ctx: LowerCtx, x: TArr):
    """Across-channel LRN (lrn_ref.c:72-96):
    y = x * (1 + alpha/size * sum_{window} x^2)^(-beta), the window
    [c - (size-1)//2, c + size//2] summed as the JAX lowering unrolls it:
    the zero-padded squares' shifted slices added in order."""
    p = ctx.params
    size = p["local_size"]
    xn = as_nchw(x)
    sq = xn * xn
    c = sq.shape[1]
    sqp = F.pad(sq, (0, 0, 0, 0, (size - 1) // 2, size // 2))
    summed = sqp[:, 0:c]
    for d in range(1, size):
        summed = summed + sqp[:, d : d + c]
    return nchw(xn * torch.pow(1.0 + (p["alpha"] / size) * summed, -p["beta"]))


@register_op("InstanceNorm")
def lower_instancenorm(ctx: LowerCtx, x: TArr, *rest: TArr):
    """InstanceNorm over the spatial dims (instancenorm_ref.c), in NHWC on
    a 4-D tensor."""
    eps = ctx.params.get("eps", 1e-5)
    four = x.x.ndim == 4
    xn = as_nhwc(x) if four else x.x
    axes = (1, 2) if four else tuple(range(2, xn.ndim))
    mean = _mean(xn, axes)
    var = _mean((xn - mean) ** 2, axes)
    out = (xn - mean) * torch.rsqrt(var + eps)
    if ctx.num_inputs > 2:
        out = out * ctx.weight(1).reshape(1, 1, 1, -1) + ctx.weight(2).reshape(1, 1, 1, -1)
    return nhwc(out) if four else wrap(out)


@register_op("LayerNorm")
def lower_layernorm(ctx: LowerCtx, x: TArr, *rest: TArr):
    """LayerNorm over the last axis: the mean, the mean of the squared
    deviations, then rsqrt, as the JAX lowering computes it (not
    F.layer_norm, whose Welford sums round otherwise)."""
    eps = ctx.params.get("eps", 1e-5)
    xs = as_semantic(x)
    mean = _mean(xs, (-1,))
    var = _mean((xs - mean) ** 2, (-1,))
    out = (xs - mean) * torch.rsqrt(var + eps)
    if ctx.num_inputs > 2:
        out = out * ctx.weight(1) + ctx.weight(2)
    return wrap(out)


@register_op("MVN")
def lower_mvn(ctx: LowerCtx, x: TArr):
    """MVN with the reference's normalizer (mvn_ref.c:130-190): the
    denominator is sqrt(E[x^2]) of the raw input, the second moment and not
    the centered variance, plus eps."""
    p = ctx.params
    xn = as_nchw(x)
    axes = (1, 2, 3) if p["across_channels"] else (2, 3)
    out = xn - _mean(xn, axes)
    if p["normalize_variance"]:
        out = out / (torch.sqrt(_mean(xn * xn, axes)) + p["eps"])
    return nchw(out)


# ---------------------------------------------------------------------------
# activations / elementwise unary
# ---------------------------------------------------------------------------


def _unary_op(fn):
    def lower(ctx: LowerCtx, x: TArr):
        return like(x, fn(x.x))

    return lower


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, logaddexp(x, 0) as jnp computes it: max(x, 0) +
    log1p(exp(-|x|)) (F.softplus returns x itself above its threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


register_op("ReLu6")(_unary_op(lambda x: torch.clamp(x, 0.0, 6.0)))
register_op("ReLU1")(_unary_op(lambda x: torch.clamp(x, -1.0, 1.0)))
register_op("Logistic")(_unary_op(torch.sigmoid))
register_op("Sigmoid")(_unary_op(torch.sigmoid))
register_op("Tanh")(_unary_op(torch.tanh))
register_op("Absval")(_unary_op(torch.abs))
register_op("Mish")(_unary_op(lambda x: x * torch.tanh(_softplus(x))))
register_op("Softplus")(_unary_op(_softplus))
register_op("Reciprocal")(_unary_op(lambda x: 1.0 / x))
register_op("Ceil")(_unary_op(torch.ceil))
# torch.round and jnp.round both round half to even
register_op("Round")(_unary_op(torch.round))
register_op("ZerosLike")(_unary_op(torch.zeros_like))
# jax.nn.gelu(approximate=False): 0.5 * x * erfc(-x * sqrt(1/2))
register_op("Gelu")(_unary_op(lambda x: 0.5 * x * torch.erfc(-x * _SQRT_HALF)))
register_op("Noop")(_unary_op(lambda x: x))
register_op("Dropout")(_unary_op(lambda x: x))


@register_op("ReLu")
def lower_relu(ctx: LowerCtx, x: TArr):
    """ReLU / LeakyReLU (relu_ref.c): slope 0 => max(0,x)."""
    slope = ctx.params.get("negative_slope", 0.0)
    if slope == 0.0:
        return like(x, torch.clamp_min(x.x, 0))
    return like(x, torch.where(x.x > 0, x.x, x.x * slope))


@register_op("PReLU")
def lower_prelu(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Per-channel PReLU (prelu_ref.c): the slope on the layout's channel
    axis of a 4-D tensor, else broadcast as it is."""
    slope = ctx.weight(1)
    if x.x.ndim == 4:
        shape = [1, 1, 1, 1]
        shape[channel_axis(x)] = slope.shape[0]
        slope = slope.reshape(shape)
    return like(x, torch.where(x.x > 0, x.x, x.x * slope))


@register_op("Elu")
def lower_elu(ctx: LowerCtx, x: TArr):
    """alpha * (exp(x) - 1) below 0, as the JAX lowering (not expm1)."""
    alpha = ctx.params.get("alpha", 1.0)
    return like(x, torch.where(x.x > 0, x.x, alpha * (torch.exp(x.x) - 1.0)))


@register_op("Selu")
def lower_selu(ctx: LowerCtx, x: TArr):
    alpha = ctx.params.get("alpha", 1.6732632)
    lam = ctx.params.get("lambda_", 1.0507010)
    return like(x, lam * torch.where(x.x > 0, x.x, alpha * (torch.exp(x.x) - 1.0)))


@register_op("HardSwish")
def lower_hardswish(ctx: LowerCtx, x: TArr):
    """x * clip(alpha*x + beta, 0, 1) (hardswish_ref.c; default alpha=1/6,
    beta=0.5): the node's own params, not F.hardswish's constants."""
    alpha = ctx.params.get("alpha", 1.0 / 6.0)
    beta = ctx.params.get("beta", 0.5)
    return like(x, x.x * torch.clamp(alpha * x.x + beta, 0.0, 1.0))


@register_op("Hardsigmoid")
def lower_hardsigmoid(ctx: LowerCtx, x: TArr):
    alpha = ctx.params.get("alpha", 0.2)
    beta = ctx.params.get("beta", 0.5)
    return like(x, torch.clamp(alpha * x.x + beta, 0.0, 1.0))


@register_op("Clip")
def lower_clip(ctx: LowerCtx, x: TArr):
    return like(x, torch.clamp(x.x, ctx.params["min"], ctx.params["max"]))


@register_op("Threshold")
def lower_threshold(ctx: LowerCtx, x: TArr):
    return like(x, (x.x > ctx.params["threshold"]).to(x.x.dtype))


_UNARY = {
    0: torch.abs, 1: torch.negative, 2: torch.floor, 3: torch.ceil,
    4: torch.square, 5: torch.sqrt, 6: torch.rsqrt, 7: torch.exp,
    8: torch.log, 9: torch.sin, 10: torch.cos, 11: torch.tan,
    12: torch.asin, 13: torch.acos, 14: torch.atan,
    15: lambda v: 1.0 / v, 16: torch.tanh,
}


@register_op("Unary")
def lower_unary(ctx: LowerCtx, x: TArr):
    """Unary op dispatch (unary_param.h type table)."""
    return like(x, _UNARY[ctx.params["type"]](x.x))


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


def _align(a: TArr, b: TArr) -> torch.Tensor:
    """b in a's layout where both are 4-D."""
    if a.x.ndim == 4 and b.x.ndim == 4 and b.layout != a.layout:
        return as_nhwc(b) if a.layout == "NHWC" else as_nchw(b)
    return b.x


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

    a, b = _bcast_eltwise(x0.x, _align(x0, rest[0]), x0.layout)
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


@register_op("BroadMul")
def lower_broadmul(ctx: LowerCtx, x0: TArr, x1: TArr):
    """Broadcast multiply (broadmul_ref.c), as in SE blocks: x0 [N,C,H,W] *
    x1 [N,C,1,1]."""
    if x0.x.ndim == 4 and x1.x.ndim == 4:
        return like(x0, x0.x * (as_nhwc(x1) if x0.layout == "NHWC" else as_nchw(x1)))
    a, b = _bcast_eltwise(x0.x, x1.x, x0.layout)
    return like(x0, a * b)


register_op("Maximum")(lambda ctx, a, b: like(a, torch.maximum(a.x, _align(a, b))))
register_op("Minimum")(lambda ctx, a, b: like(a, torch.minimum(a.x, _align(a, b))))
register_op("SquaredDifference")(lambda ctx, a, b: like(a, torch.square(a.x - _align(a, b))))


@register_op("Addn")
def lower_addn(ctx: LowerCtx, *xs: TArr):
    out = xs[0].x
    for t in xs[1:]:
        out = out + _align(xs[0], t)
    return like(xs[0], out)


@register_op("Mean")
def lower_mean(ctx: LowerCtx, *xs: TArr):
    """ONNX Mean: elementwise mean of n inputs (mean_ref.c); the division by
    n a multiply by its f32 reciprocal, as XLA compiles the JAX lowering."""
    acc = xs[0].x
    for t in xs[1:]:
        acc = acc + _align(xs[0], t)
    return like(xs[0], acc * float(np.float32(1.0) / np.float32(len(xs))))


# ---------------------------------------------------------------------------
# softmax
# ---------------------------------------------------------------------------


@register_op("Softmax")
def lower_softmax(ctx: LowerCtx, x: TArr):
    axis = semantic_axis(x, ctx.params.get("axis", 1))
    return like(x, torch.softmax(x.x, dim=axis))


@register_op("LogSoftmax")
def lower_logsoftmax(ctx: LowerCtx, x: TArr):
    axis = semantic_axis(x, ctx.params.get("axis", 1))
    return like(x, torch.log_softmax(x.x, dim=axis))


def _arg_reduce(ctx: LowerCtx, x: TArr, fn) -> TArr:
    """ArgMax / ArgMin: int32 indices, the first of equal values."""
    axis = ctx.params.get("axis", 0)
    out = fn(as_semantic(x), dim=axis).to(torch.int32)
    if ctx.params.get("keepdims", 1):
        out = out.unsqueeze(axis)
    return wrap(out)


@register_op("ArgMax")
def lower_argmax(ctx: LowerCtx, x: TArr):
    return _arg_reduce(ctx, x, torch.argmax)


@register_op("ArgMin")
def lower_argmin(ctx: LowerCtx, x: TArr):
    return _arg_reduce(ctx, x, torch.argmin)


@register_op("TopKV2")
def lower_topk(ctx: LowerCtx, x: TArr):
    """lax.top_k over the last axis: values and int32 indices in its order
    (ops/detection.py:_top_k)."""
    values, order = _top_k(as_semantic(x).to(torch.float32), ctx.params["k"])
    return wrap(values), wrap(order.to(torch.int32))


def _prod(x: torch.Tensor, axis, keepdims: bool) -> torch.Tensor:
    """torch.prod takes one axis: the product over each in turn."""
    for d in axis:
        x = torch.prod(x, dim=d, keepdim=True)
    return x if keepdims else x.squeeze(axis)


def _sum(a, axis, keepdims):
    return torch.sum(a, dim=axis, keepdim=keepdims)


def _asum(a, axis, keepdims):
    return _sum(torch.abs(a), axis, keepdims)


# The reference RUNTIME's type table (reduction_kernel_ref.h's dispatch),
# which differs from its param header's names: 7 is a second asum; 8 ("l2")
# sums sqrt(x*x) = |x| element by element, not an L2 norm; 9 is log(sum);
# 10 the naive log(sum(exp(x))), not torch.logsumexp's shifted form.
_REDUCTIONS = {
    0: _sum,
    1: lambda a, axis, keepdims: _mean(a, axis, keepdims),
    2: _asum,
    3: lambda a, axis, keepdims: _sum(torch.square(a), axis, keepdims),
    4: lambda a, axis, keepdims: torch.amax(a, dim=axis, keepdim=keepdims),
    5: lambda a, axis, keepdims: torch.amin(a, dim=axis, keepdim=keepdims),
    6: _prod,
    7: _asum,
    8: _asum,
    9: lambda a, axis, keepdims: torch.log(_sum(a, axis, keepdims)),
    10: lambda a, axis, keepdims: torch.log(_sum(torch.exp(a), axis, keepdims)),
}


@register_op("Reduction")
def lower_reduction(ctx: LowerCtx, x: TArr):
    """Reduction over the dims dim_0..dim_3 (reduction_param.h; -2 unset,
    none set: every axis)."""
    p = ctx.params
    xs = as_semantic(x)
    dims = [d for d in (p["dim_0"], p["dim_1"], p["dim_2"], p["dim_3"]) if d != -2]
    axes = tuple(d % xs.ndim for d in dims) if dims else tuple(range(xs.ndim))
    return wrap(_REDUCTIONS[p.get("type", 0)](xs, axes, bool(p.get("keepdim", 0))))


@register_op("ReduceL2")
def lower_reducel2(ctx: LowerCtx, x: TArr):
    xs = as_semantic(x)
    axis = ctx.params["axis"] % xs.ndim
    return wrap(torch.sqrt(_sum(torch.square(xs), axis, bool(ctx.params.get("keepdim")))))


# ---------------------------------------------------------------------------
# shape / data-movement ops (layout-sensitive: normalize to NCHW semantics).
# Each is a view or a copy of its input's values, so on a quantized graph
# the same function runs on the stored integers (ops/quantized.py's
# passthroughs).
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


@register_op("Flatten")
def lower_flatten(ctx: LowerCtx, x: TArr):
    """Flatten dims[axis..end_axis] into one (flatten.c infer_shape:
    output is [n, prod(dims[axis..end_axis])]); end_axis < 0 counts from the
    end (converters write 3 for NCHW; -1 is the caffe default)."""
    xs = as_semantic(x)
    axis = ctx.params.get("axis", 1)
    end_axis = ctx.params.get("end_axis", -1)
    if end_axis < 0:
        end_axis = xs.ndim + end_axis
    mid = 1
    for d in xs.shape[axis : end_axis + 1]:
        mid *= d
    tail = xs.shape[end_axis + 1 :]
    return wrap(xs.reshape(*xs.shape[:axis], mid, *tail))


@register_op("Reshape")
def lower_reshape(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Reshape with caffe/onnx 0/-1 dim semantics (reshape.c infer_shape).
    A shape given as a second input must be const: it is read at compile
    time."""
    xs = as_semantic(x)
    shape = list(ctx.params.get("shape") or [])
    if not shape and rest:
        sh = ctx.const_data(1)
        if sh is None:
            raise NotImplementedError("dynamic reshape shape input")
        shape = [int(v) for v in np.asarray(sh).reshape(-1)]
    # 0 => copy the input's dim (caffe semantics); -1 => inferred
    new = [xs.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return wrap(xs.reshape(new))


@register_op("Permute")
def lower_permute(ctx: LowerCtx, x: TArr):
    """Permute with order0..3 (permute.c)."""
    p = ctx.params
    xs = as_semantic(x)
    order = [p["order0"], p["order1"], p["order2"], p["order3"]][: xs.ndim]
    return wrap(xs.permute(order))


@register_op("Transpose")
def lower_transpose(ctx: LowerCtx, x: TArr):
    return wrap(as_semantic(x).permute(list(ctx.params["perm"])))


@register_op("SwapAxis")
def lower_swapaxis(ctx: LowerCtx, x: TArr):
    return wrap(as_semantic(x).transpose(ctx.params["dim_0"], ctx.params["dim_1"]))


@register_op("Squeeze")
def lower_squeeze(ctx: LowerCtx, x: TArr):
    """Squeeze flagged dims (squeeze.c): dim_k == 1 marks axis k for removal;
    all-zero means squeeze all size-1 dims."""
    p = ctx.params
    xs = as_semantic(x)
    flags = [p.get("dim_0", 0), p.get("dim_1", 0), p.get("dim_2", 0), p.get("dim_3", 0)]
    axes = [i for i, f in enumerate(flags[: xs.ndim]) if f == 1 and xs.shape[i] == 1]
    if not axes:
        axes = [i for i, d in enumerate(xs.shape) if d == 1]
    return wrap(xs.squeeze(tuple(axes)))


@register_op("Unsqueeze")
def lower_unsqueeze(ctx: LowerCtx, x: TArr):
    xs = as_semantic(x)
    for ax in sorted(ctx.params.get("axes") or [0]):
        xs = xs.unsqueeze(ax)
    return wrap(xs)


@register_op("Expanddims")
def lower_expanddims(ctx: LowerCtx, x: TArr):
    return wrap(as_semantic(x).unsqueeze(ctx.params["axis"]))


@register_op("Shape")
def lower_shape(ctx: LowerCtx, x: TArr):
    """The input's semantic shape as int32: a compile-time param at the
    compiled size, so the forward uploads nothing."""
    shape = semantic_shape(x)
    return wrap(ctx.get_param("shape", lambda: np.asarray(shape, np.int32)))


def _along(xs: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    idx = [slice(None)] * xs.ndim
    idx[axis] = sl
    return xs[tuple(idx)]


@register_op("Slice")
def lower_slice(ctx: LowerCtx, x: TArr):
    """Slice: caffe multi-output split along axis via slice_points, or
    onnx/mxnet single range slice, or tflite begins/sizes (slice.c
    infer_shape, slice_ref.c)."""
    p = ctx.params
    xs = as_semantic(x)
    axis = p.get("axis", 0) % xs.ndim
    if p.get("iscaffe"):
        points = list(p.get("slice_points") or [])
        size = xs.shape[axis]
        n_out = len(ctx.node.outputs)
        if not points:
            step = size // n_out
            points = [step * (i + 1) for i in range(n_out - 1)]
        return tuple(wrap(_along(xs, axis, slice(s, e)))
                     for s, e in zip([0] + points, points + [size]))
    if p.get("isonnx") or p.get("ismxnet"):
        begins = p.get("begins") or []
        sizes = p.get("sizes") or []
        if begins:
            idx = [slice(None)] * xs.ndim
            for ax, (b, sz) in enumerate(zip(begins, sizes)):
                if sz >= 0:
                    idx[ax] = slice(b, b + sz)
            return wrap(xs[tuple(idx)])
        # scalar begin/end/step on one axis; end <= 0 means size + end
        # (slice_ref.c onnx_run:stop_k = end > 0 ? end : dims[k] + end)
        b, e, st = p.get("begin", 0), p.get("end", 0), p.get("step", 1) or 1
        size = xs.shape[axis]
        e = e if e > 0 else size + e
        return wrap(_along(xs, axis, slice(b, min(e, size), st)))
    # tflite-style: begins/sizes vectors
    begins = p.get("begins") or [0] * xs.ndim
    sizes = p.get("sizes") or list(xs.shape)
    idx = tuple(slice(b, (b + sz) if sz >= 0 else None) for b, sz in zip(begins, sizes))
    return wrap(xs[idx])


@register_op("Split")
def lower_split(ctx: LowerCtx, x: TArr):
    p = ctx.params
    xs = as_semantic(x)
    axis = p.get("axis", 0) % xs.ndim
    sizes = list(p.get("split_sizes") or [])
    if sizes:
        parts = torch.tensor_split(xs, np.cumsum(sizes)[:-1].tolist(), dim=axis)
    else:
        parts = torch.tensor_split(xs, len(ctx.node.outputs), dim=axis)
    return tuple(wrap(a) for a in parts)


@register_op("StridedSlice")
def lower_strided_slice(ctx: LowerCtx, x: TArr):
    """NCHW strided slice with the reference's crop semantics
    (strided_slice.c infer_shape + strided_slice_ref.c:67): per dim,
    out = ceil((in - |end - begin|) / stride) elements taken at
    begin + k*stride; end - begin is a total crop amount, not an exclusive
    end index (begin = end = 0, stride 2 is the yolov5 focus slice)."""
    p = ctx.params
    xs = as_semantic(x)
    idx = []
    for dim, (b, e, s) in enumerate([
        (p["begin_n"], p["end_n"], p["stride_n"]),
        (p["begin_c"], p["end_c"], p["stride_c"]),
        (p["begin_h"], p["end_h"], p["stride_h"]),
        (p["begin_w"], p["end_w"], p["stride_w"]),
    ][: xs.ndim]):
        s = s or 1
        out = max(1, -(-(xs.shape[dim] - abs(e - b)) // s))
        idx.append(slice(b, b + (out - 1) * s + 1, s))
    return wrap(xs[tuple(idx)])


@register_op("Crop")
def lower_crop(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Caffe Crop (crop_ref.c / crop.c infer_shape): crop x to the spatial
    size of the reference input (or crop_h/crop_w), starting at offsets."""
    p = ctx.params
    xs = as_nchw(x)
    n, c, h, w = xs.shape
    if p.get("crop_h") and p.get("crop_w"):
        th, tw = p["crop_h"], p["crop_w"]
    elif rest:
        ref_shape = semantic_shape(rest[0])
        th, tw = ref_shape[2], ref_shape[3]
    else:
        th, tw = h, w
    if p.get("center_crop"):
        oh, ow = (h - th) // 2, (w - tw) // 2
    else:
        oh = p.get("offset_h", 0)
        ow = p.get("offset_w", 0)
    return nchw(xs[:, :, oh : oh + th, ow : ow + tw])


def _index_pad(ctx: LowerCtx, xs: torch.Tensor, pads, mode: str) -> torch.Tensor:
    """Edge or reflect padding (np.pad's modes, which jnp.pad follows) as one
    index_select per padded axis; the index tables are compile-time params."""
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            size = xs.shape[axis]
            idx = ctx.get_param(f"pad_idx{axis}", lambda size=size, lo=lo, hi=hi: np.pad(
                np.arange(size, dtype=np.int64), (lo, hi), mode=mode))
            xs = xs.index_select(axis, idx)
    return xs


@register_op("Pad")
def lower_pad(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Pad NCHW (pad.c): mode 0=constant 1=edge 2=reflect; negative pads
    clamp to 0."""
    p = ctx.params
    xs = as_nchw(x) if x.x.ndim == 4 else as_semantic(x)
    pads = [
        (p["pad_n_0"], p["pad_n_1"]),
        (p["pad_c_0"], p["pad_c_1"]),
        (p["pad_h_0"], p["pad_h_1"]),
        (p["pad_w_0"], p["pad_w_1"]),
    ][: xs.ndim]
    pads = [(max(a, 0), max(b, 0)) for a, b in pads]
    mode = {0: "constant", 1: "edge", 2: "reflect"}[p.get("mode", 0)]
    if mode == "constant":
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        out = F.pad(xs, flat, value=float(p.get("value", 0.0)))
    else:
        out = _index_pad(ctx, xs, pads, mode)
    return nchw(out) if x.x.ndim == 4 else wrap(out)


@register_op("ShuffleChannel")
def lower_shufflechannel(ctx: LowerCtx, x: TArr):
    """Channel shuffle (shufflechannel_ref.c): [N,g,C/g,...] transpose."""
    g = ctx.params["group"]
    if x.layout == "NHWC":
        n, h, w, c = x.x.shape
        return nhwc(x.x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c))
    n, c, h, w = x.x.shape
    return nchw(x.x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w))


@register_op("ChannelGather")
def lower_channel_gather(ctx: LowerCtx, x: TArr):
    """Static channel gather (graph/passes.py:fold_shuffle_gathers) — the
    materialized residue of a folded shuffle+slice chain. The indices are a
    compile-time param."""
    idx = ctx.get_param("gather_idx", lambda: np.asarray(ctx.params["indices"], np.int64))
    if x.layout == "NHWC":
        return nhwc(x.x.index_select(3, idx))
    return wrap(as_semantic(x).index_select(1, idx))


@register_op("SpaceToDepth")
def lower_space_to_depth(ctx: LowerCtx, x: TArr):
    """mode DCR (ONNX): channel order (dy, dx, c); mode CRD (default, torch
    pixel_unshuffle — matches the DepthToSpace default so the pair
    round-trips). Computed in the input's own layout, as the JAX lowering
    does; the result is NCHW either way."""
    bs = ctx.params["block_size"]
    crd = ctx.params.get("mode", "CRD") == "CRD"
    if x.layout != "NHWC":
        n, c, h, w = x.x.shape
        v = x.x.reshape(n, c, h // bs, bs, w // bs, bs)
        v = v.permute(0, 1, 3, 5, 2, 4) if crd else v.permute(0, 3, 5, 1, 2, 4)
        return nchw(v.reshape(n, c * bs * bs, h // bs, w // bs))
    n, h, w, c = x.x.shape
    v = x.x.reshape(n, h // bs, bs, w // bs, bs, c)
    v = v.permute(0, 5, 2, 4, 1, 3) if crd else v.permute(0, 2, 4, 5, 1, 3)
    return nchw(v.reshape(n, bs * bs * c, h // bs, w // bs))


@register_op("DepthToSpace")
def lower_depth_to_space(ctx: LowerCtx, x: TArr):
    """Inverse of SpaceToDepth; mode CRD = torch pixel_shuffle, the default
    (depthtospace_ref.c hardcodes the CRD index map); ONNX-imported graphs
    carry an explicit mode."""
    bs = ctx.params["block_size"]
    crd = ctx.params.get("mode", "CRD") == "CRD"
    xn = as_nhwc(x)
    n, h, w, c = xn.shape
    c2 = c // (bs * bs)
    if crd:
        out = xn.reshape(n, h, w, c2, bs, bs).permute(0, 1, 4, 2, 5, 3)
    else:
        out = xn.reshape(n, h, w, bs, bs, c2).permute(0, 1, 3, 2, 4, 5)
    return nhwc(out.reshape(n, h * bs, w * bs, c2))


@register_op("Reorg")
def lower_reorg(ctx: LowerCtx, x: TArr):
    """YOLO reorg with darknet's inverse ("backward") index map, which the
    reference replicates exactly (reorg_ref.c:44-60, out_data[in_index] =
    in_data[out_index]): out_flat[(k*h + j)*w + i] =
    in_flat[(c2*(h*s) + h2)*(w*s) + w2] with c2 = k % oc, off = k // oc,
    h2 = j*s + off//s, w2 = i*s + off%s, the result read as
    (n, c*s*s, h//s, w//s). One gather per image; its flat index table is a
    compile-time param."""
    s = ctx.params["stride"]
    xs = as_nchw(x)
    n, c, h, w = xs.shape
    oc = c // (s * s)

    def table():
        k = np.arange(c)[:, None, None]
        off = k // oc
        h2 = np.arange(h)[None, :, None] * s + off // s
        w2 = np.arange(w)[None, None, :] * s + off % s
        return (((k % oc) * (h * s) + h2) * (w * s) + w2).reshape(-1).astype(np.int64)

    idx = ctx.get_param("reorg_idx", table)
    out = xs.reshape(n, c * h * w).index_select(1, idx)
    return nchw(out.reshape(n, c * s * s, h // s, w // s))


def _repeat_each(xs: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """np.repeat(xs, r, axis) as a broadcast view and a reshape (no repeat
    count uploaded, as repeat_interleave may)."""
    shape = list(xs.shape)
    v = xs.unsqueeze(axis + 1).expand(*shape[: axis + 1], r, *shape[axis + 1 :])
    shape[axis] *= r
    return v.reshape(shape)


@register_op("Tile")
def lower_tile(ctx: LowerCtx, x: TArr):
    """Tile with the reference's conventions (tile_ref.c): `reps` is stored
    reversed (reps[0] repeats W, reps[-1] repeats N); frame_flag 0 (caffe)
    repeats each element along the axis (np.repeat), frame_flag 1 (onnx)
    tiles whole blocks (np.tile)."""
    reps = list(ctx.params.get("reps") or [])
    xs = as_semantic(x)
    if not reps:
        return wrap(xs)
    reps = reps[::-1]
    reps = [1] * (xs.ndim - len(reps)) + reps if len(reps) < xs.ndim else reps[-xs.ndim:]
    if ctx.params.get("frame_flag", 0) == 0:
        for ax, r in enumerate(reps):
            if r != 1:
                xs = _repeat_each(xs, r, ax)
        return wrap(xs)
    return wrap(xs.repeat(reps))


@register_op("Expand")
def lower_expand(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Broadcast to shape (a param, or a const input read at compile
    time)."""
    shape = list(ctx.params.get("shape") or [])
    if not shape and rest and ctx.const_data(1) is not None:
        shape = [int(v) for v in np.asarray(ctx.const_data(1)).reshape(-1)]
    xs = as_semantic(x)
    return wrap(torch.broadcast_to(xs, np.broadcast_shapes(tuple(shape), tuple(xs.shape))))


def _to_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float -> integer cast as XLA converts: truncation toward zero,
    saturating at the dtype's range, NaN to 0. torch's cast wraps out of
    range and sends NaN to the lowest value."""
    info = torch.iinfo(dtype)
    x = torch.where(torch.isnan(x), 0.0, x)
    big, small = x >= float(info.max), x <= float(info.min)
    q = torch.where(big | small, 0.0, x).to(dtype)
    return torch.where(big, info.max, torch.where(small, info.min, q))


@register_op("Gather")
def lower_gather(ctx: LowerCtx, x: TArr, *rest: TArr):
    """jnp.take in its default mode (take). The indices are the second
    input's, cast to int32."""
    p = ctx.params
    xs = as_semantic(x)
    axis = p.get("axis", 0) % xs.ndim
    if rest and rest[0] is not None:
        idx = as_semantic(rest[0])
        idx = _to_int(idx, torch.int32) if idx.is_floating_point() else idx.to(torch.int32)
    else:
        idx = ctx.get_param("gather_idx", lambda: np.asarray(ctx.const_data(1), np.int32))
    return wrap(take(xs, idx, axis))


def take(xs: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """jnp.take(xs, idx, axis) in its default mode: an index in [-n, n)
    picks (a negative one wraps once); any other fills with NaN (the
    dtype's lowest value for an integer tensor)."""
    n = xs.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    picked = xs.index_select(axis, torch.where(ok, idx, 0).reshape(-1).long())
    out_shape = (*xs.shape[:axis], *idx.shape, *xs.shape[axis + 1 :])
    picked = picked.reshape(out_shape)
    fill = (float("nan") if xs.is_floating_point() else
            torch.iinfo(xs.dtype).min if xs.dtype.is_signed else torch.iinfo(xs.dtype).max)
    ok = ok.reshape((1,) * axis + tuple(idx.shape) + (1,) * (xs.ndim - axis - 1))
    return torch.where(ok, picked, fill)


@register_op("Cast")
def lower_cast(ctx: LowerCtx, x: TArr):
    """Cast to type_to; float -> integer as XLA converts it (_to_int)."""
    from ..graph.ir import DType
    from .qmath import TORCH_DTYPES

    to = TORCH_DTYPES[DType(ctx.params["type_to"])]
    if x.x.is_floating_point() and not to.is_floating_point:
        return like(x, _to_int(x.x, to))
    return like(x, x.x.to(to))


_COMPARISONS = {0: torch.eq, 1: torch.ne, 2: torch.gt, 3: torch.ge, 4: torch.lt, 5: torch.le}


@register_op("Comparison")
def lower_comparison(ctx: LowerCtx, a: TArr, b: TArr):
    """1.0 where the comparison holds, else 0.0 (float32)."""
    return like(a, _COMPARISONS[ctx.params["type"]](a.x, _align(a, b)).to(torch.float32))


@register_op("Logical")
def lower_logical(ctx: LowerCtx, a: TArr, *rest: TArr):
    """AND (0), OR (1) of the operands' nonzero-ness, NOT (2) of one: 1.0 or
    0.0 (float32)."""
    t = ctx.params["type"]
    if t == 2:
        return like(a, (a.x == 0).to(torch.float32))
    fn = {0: torch.logical_and, 1: torch.logical_or}[t]
    return like(a, fn(a.x != 0, _align(a, rest[0]) != 0).to(torch.float32))


@register_op("Reverse")
def lower_reverse(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Flip one axis: the first value of a const second input (read at
    compile time), else axis 0."""
    axis = 0
    if rest and ctx.const_data(1) is not None:
        axis = int(np.asarray(ctx.const_data(1)).reshape(-1)[0])
    return wrap(torch.flip(as_semantic(x), dims=(axis,)))


@register_op("Where")
def lower_where(ctx: LowerCtx, cond: TArr, a: TArr, b: TArr):
    return like(a, torch.where(cond.x != 0, a.x, _align(a, b)))


# ---------------------------------------------------------------------------
# resize / upsample
# ---------------------------------------------------------------------------


def _nearest_nhwc(ctx: LowerCtx, xn: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize with the reference's scale-floor indexing
    (upsample_ref.c: in_idx = floor(out_idx / scale)), in f32 like the JAX
    lowering computes it. The indices are compile-time params, at the
    compiled size."""
    n, h, w, c = xn.shape

    def index(out, size):
        scale = np.float32(out / size)
        return lambda: np.floor(np.arange(out, dtype=np.float32) / scale).astype(np.int64)

    rows = ctx.get_param("nearest_rows", index(out_h, h))
    cols = ctx.get_param("nearest_cols", index(out_w, w))
    return xn.index_select(1, rows).index_select(2, cols)


@register_op("Upsample")
def lower_upsample(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Nearest upsample by integer scale (upsample_ref.c)."""
    scale = ctx.params.get("scale", 2.0)
    xn = as_nhwc(x)
    n, h, w, c = xn.shape
    return nhwc(_nearest_nhwc(ctx, xn, int(h * scale), int(w * scale)))


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """One axis of jax.image.resize(method="bilinear") — its
    compute_weight_mat with translation 0 and antialias on — as an
    [in_size, out_size] float32 matrix: a triangle kernel widened by the
    scale when downscaling (antialiasing, which F.interpolate's bilinear
    mode does not do), each column normalized to sum 1, and zero where the
    sample falls outside the input."""
    f32 = np.float32
    inv = f32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _bilinear_nhwc(ctx: LowerCtx, xn: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """jax.image.resize's bilinear resize (half-pixel centers, antialiased
    when downscaling) as a contraction with one weight matrix per resized
    axis; an axis whose size does not change is left alone, as JAX leaves
    it. The matrices are compile-time params, at the compiled size."""
    n, h, w, c = xn.shape
    out = xn
    if out_h != h:
        wh = ctx.get_param("bilinear_h", lambda: _bilinear_weights(h, out_h))
        out = torch.einsum("nhwc,ho->nowc", out, wh)
    if out_w != w:
        ww = ctx.get_param("bilinear_w", lambda: _bilinear_weights(w, out_w))
        out = torch.einsum("nhwc,wp->nhpc", out, ww)
    return out


def _resize_nhwc(ctx: LowerCtx, xn: torch.Tensor, out_h: int, out_w: int,
                 method: str) -> torch.Tensor:
    if method == "nearest":
        return _nearest_nhwc(ctx, xn, out_h, out_w)
    # bilinear, half-pixel centers align with the reference interp
    # (interp_ref.c uses align_corners=false caffe style)
    return _bilinear_nhwc(ctx, xn, out_h, out_w)


@register_op("Interp")
def lower_interp(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Interp resize (interp_ref.c): resize_type 1=nearest 2=bilinear."""
    p = ctx.params
    xn = as_nhwc(x)
    n, h, w, c = xn.shape
    out_h, out_w = p.get("output_height", 0), p.get("output_width", 0)
    if out_h <= 0 or out_w <= 0:
        out_h = int(h * p.get("height_scale", 1.0))
        out_w = int(w * p.get("width_scale", 1.0))
    method = "nearest" if p.get("resize_type", 2) == 1 else "bilinear"
    return nhwc(_resize_nhwc(ctx, xn, out_h, out_w, method))


@register_op("Resize")
@register_op("BilinearResize")
def lower_resize(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Resize (resize.c): type 0=nearest, else bilinear; scales from param."""
    p = ctx.params
    xn = as_nhwc(x)
    n, h, w, c = xn.shape
    out_h = int(h * p.get("scale_y", p.get("scale_x", 1.0)))
    out_w = int(w * p.get("scale_x", 1.0))
    method = "nearest" if p.get("type", 0) == 0 else "bilinear"
    return nhwc(_resize_nhwc(ctx, xn, out_h, out_w, method))
