"""Quantized execution kernels (INT8 per-channel, UINT8 per-tensor) — PyTorch
port of the subset of tengine_tpu/ops/quantized.py that the yolov5s INT8
path, the yolov3 integer-storage path (quant_bf16_storage=False), the
YOLO-Fastest depthwise path (INT8 and UINT8), the ResNet-50 INT8 path
(FullyConnected, global average pool, ReLu; the bottleneck chains lower in
ops/fused.py), the native-int8 plan (UINT8 grids shifted to full-range
INT8, executor/engine.py) and the shape ops of the SSD, face and
shufflenet-v2 paths (the passthroughs, ShuffleChannel and ChannelGather
among them) run: every lowering the JAX module registers.

Two tiers, mirroring the reference's ref-vs-optimized kernel split:

  * SCORE_CANDO "ref" kernels — reproduce the reference C semantics
    literally: dequantize -> fp32 compute -> requantize with round-half-away
    and clip (conv_kernel_ref_int8.c). These are the accuracy oracle
    (TG_DEBUG_REF analog) and what quant_mode="ref" selects.

  * SCORE_BEST "fast" kernels — exact integer accumulation with the
    requantization folded into a single per-channel multiplier:
      acc = conv(x_i8, w_i8)   (exact; float64 holds every partial sum)
    then q = clip(round(acc * M[c] + B[c]) + zp_out). An INT8 conv at zero
    point 0 runs both in one launch of the int8 implicit GEMM on the card
    (qconv_fast; the float64 chain is its plain version); every other conv
    sums in a float64 library conv.

  * SCORE_STATIC kernel routes — hand-written CUDA kernels (ops/cuda/)
    behind the JAX engine's predicates and scores, unchanged, so both
    engines route every node alike: the stem, qconv_direct / qconv1x1,
    qgemm_requant and the depthwise dw_qconv.

Activations are stored as their integer dtype everywhere (the JAX engine's
bf16 storage holds the same values). Any op without a quant-aware kernel
runs under the engine's generic dequant -> fp32 kernel -> requant wrapper
(executor/engine.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..graph.ir import DType, QuantParam
from . import qmath
from .cuda.dw_conv import dw_qconv, pack_dw_taps
from .cuda.qconv import pack_qconv_weights, qconv1x1, qconv_direct, qconv_fast
from .cuda.qgemm import pack_qgemm_weights, qgemm_requant
from .cuda.requant import Epilogue, qrequant, qwiden, qwiden_for_conv
from .cuda.stem_conv import pack_stem_weights, stem_qconv
from .layout import TArr, as_nchw, as_nhwc, as_semantic, nhwc
from .lowering import ACT_SILU, _conv_pads, apply_activation, conv2d_nhwc, fc_output
from .registry import SCORE_BEST, SCORE_CANDO, SCORE_STATIC, LowerCtx, register_op


node_is_quant = qmath.node_is_quant


def _fast_enabled(ctx: LowerCtx) -> bool:
    return (
        node_is_quant(ctx)
        and ctx.options.quant_mode in ("auto", "fast")
        and not ctx.options.force_ref_kernels
    )


def _no_fused_add(ctx: LowerCtx) -> bool:
    # nodes carrying a fused residual add (fuse_conv_add pass) are only
    # lowerable by the fast kernels
    return "fused_add_pos" not in ctx.params


def _wscales(quant: QuantParam, out_c: int) -> np.ndarray:
    s = np.asarray(quant.scales, np.float32).reshape(-1)
    if s.size == 1:
        s = np.full((out_c,), s[0], np.float32)
    return s


def _zp_w(quant: QuantParam, out_c: int):
    """A weight grid's zero point: an int for a per-tensor grid, and for a
    per-channel grid each output channel's own, as an int64 [O, 1, 1, 1]
    array (it broadcasts over OIHW weights). The JAX package's fast
    lowerings take a per-channel grid's zero points as 0 (ROADMAP §3)."""
    zps = np.asarray(quant.zero_points).reshape(-1)
    if not quant.per_channel:
        return int(zps[0])
    return np.broadcast_to(zps.astype(np.int64), (out_c,)).reshape(out_c, 1, 1, 1)


def _pc_zero_points(t_w) -> bool:
    """Per-channel weights with a nonzero zero point (an imported graph's;
    no quantizer makes them). The integer kernels take one zero point a
    tensor, so such a conv or FC stays on its fast lowering."""
    q = t_w.quant
    return q is not None and q.per_channel and bool(np.any(np.asarray(q.zero_points)))


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------


def _ones_conv_np(w_raw, p, in_h, in_w, pads, dil):
    """conv(ones, w) window sums, computed on the host at fold time: the
    per-output-position sum of the weights whose tap lands inside the input
    (zero padding masks the rest). Returns [O] when the value is uniform
    (no padding / interior-only) else [oh, ow, O]. Exact: integer sums."""
    colsum = w_raw.sum(axis=1).astype(np.float64)  # [O, kh, kw]
    (pt, pb), (pl, pr) = pads
    sh, sw = p["stride_h"], p["stride_w"]
    dh, dw_ = dil
    kh, kw = p["kernel_h"], p["kernel_w"]
    if pt == pb == pl == pr == 0:
        return colsum.sum(axis=(1, 2))  # [O]
    kh_eff = (kh - 1) * dh + 1
    kw_eff = (kw - 1) * dw_ + 1
    oh = (in_h + pt + pb - kh_eff) // sh + 1
    ow = (in_w + pl + pr - kw_eff) // sw + 1
    oi = np.arange(oh) * sh - pt
    oj = np.arange(ow) * sw - pl
    out = np.zeros((oh, ow, colsum.shape[0]), np.float64)
    for a in range(kh):
        vi = (oi + a * dh >= 0) & (oi + a * dh < in_h)
        for b in range(kw):
            vj = (oj + b * dw_ >= 0) & (oj + b * dw_ < in_w)
            out += (vi[:, None] & vj[None, :])[:, :, None] * colsum[:, a, b]
    if np.all(out == out[0, 0]):
        return out[0, 0]
    return out


def _relaxed_fused_add(ctx: LowerCtx) -> bool:
    """Relaxed single-rounding fused-residual epilogue applies: no conv-own
    activation (its clamp thresholds live in the mid-scale domain)."""
    return (
        ctx.options.quant_relaxed
        and ctx.params.get("fused_add_pos") is not None
        and ctx.params.get("activation", -1) < 0
    )


def _conv_grid(ctx: LowerCtx):
    """The tensor whose grid the conv's own requant lands on. With a fused
    residual add (fuse_conv_add pass) that is the pre-add intermediate
    tensor; the add + second requant run in the epilogue
    (_requant_conv_out). Under the relaxed tier the mid grid is never
    materialized: multipliers fold straight to the final output scale and
    the residual joins pre-round (single rounding)."""
    if ctx.params.get("fused_add_pos") is None or _relaxed_fused_add(ctx):
        return ctx.out_tensor(0)
    return ctx.graph.tensors[ctx.params["fused_add_mid"]]


def _conv_quant_common(ctx: LowerCtx, x: TArr):
    """Shared quantized conv: returns (acc float64 NHWC, s_in, w_scales,
    corr), corr the f32 correction _requant_conv_out adds after acc·M + B
    (None where there is none). The stored input is widened to the conv's
    float64 buffer by qwiden.

    Two branches, as in tengine_tpu/ops/quantized.py:_conv_quant_common.

    Symmetric INT8 weights: exact integer accumulation of the raw values.
    The XLA conv there accumulates s8×s8 in int32; here a float64 conv does,
    which is exact while every partial sum stays below 2^53 (K·127² is at
    most ~10^8 in any conv net). A float32 conv would not be: it stops being
    exact once K·127² >= 2^24, K > 1040, and yolov5s reaches K = 9216. A
    nonzero zp_in is corrected by the compile-time constant
    -zp_in·conv(ones, w)·m.

    UINT8 / asymmetric weights: the conv of the shifted values
    (x - zp_in)·(w - zp_w), zp_w each output channel's own for a
    per-channel grid (the JAX branch takes those as 0, ROADMAP §3). The
    JAX branch feeds them to the conv as bf16
    (9-bit integers, exact) and sums in f32, which is exact while
    K·255² < 2^24, K <= 258: every conv that takes this branch on the
    YOLO-Fastest path (the stem, K = 27; the depthwise convs, K = 9). The
    float64 conv here computes those same sums. For a larger K the JAX sum
    rounds in an order that is XLA's own and this one stays exact, so such a
    conv is held to 1 LSB, not to the bit. The JAX branch's width fold and
    optimization barrier are layout and scheduling only and have no
    counterpart. A depthwise conv with zp_in != 0 keeps the JAX branch's
    dw_zp_fold arithmetic: the raw input padded with zp_in, and the constant
    f32(-zp_in·colsum(w - zp_w)·m) added after acc·M + B as a separate f32
    add (corr); that order decides .5 ties."""
    p = ctx.params
    group = p["group"]
    dil_h, dil_w = p["dilation_h"], p["dilation_w"]
    kh_eff = (p["kernel_h"] - 1) * dil_h + 1
    kw_eff = (p["kernel_w"] - 1) * dil_w + 1

    t_in = ctx.in_tensor(0)
    t_w = ctx.in_tensor(1)
    t_out = _conv_grid(ctx)
    in_q, w_q, out_q = t_in.quant, t_w.quant, t_out.quant

    xn = as_nhwc(x)
    n, in_h, in_w, _ = xn.shape
    pads = _conv_pads(in_h, in_w, p, kh_eff, kw_eff)
    out_c = t_w.shape[0]

    zp_in = int(np.asarray(in_q.zero_points).reshape(-1)[0])
    s_in = float(np.asarray(in_q.scales).reshape(-1)[0])
    w_scales = _wscales(w_q, out_c)
    zp_w = _zp_w(w_q, out_c)

    strides = (p["stride_h"], p["stride_w"])
    if not (t_in.dtype == DType.INT8 and t_w.dtype == DType.INT8 and not np.any(zp_w)):
        w = ctx.weight(1, lambda a: a.astype(np.float64) - zp_w, tag="oihw_zshift_f64")
        is_dw = group > 1 and group == out_c and int(t_w.shape[1]) == 1
        if is_dw and zp_in != 0:
            xs = qwiden(xn, zp_in=zp_in, mode="fill", pads=pads)
            acc = conv2d_nhwc(xs, w, ((0, 0), (0, 0)), strides, (dil_h, dil_w), group)
            s_out_f = float(np.asarray(out_q.scales).reshape(-1)[0])

            def _corr():
                w_raw = ctx.const_data(1).astype(np.int64)  # [C, 1, k, k]
                colsum = (w_raw - zp_w).sum(axis=(1, 2, 3))
                m = s_in * w_scales.astype(np.float64) / s_out_f
                return (-zp_in * colsum * m).astype(np.float32)

            dw_corr = ctx.get_param("dwzp_bm", _corr)
            return acc, s_in, w_scales, dw_corr
        xs, conv_pads = qwiden_for_conv(xn, zp_in=zp_in, mode="shift", pads=pads)
        acc = conv2d_nhwc(xs, w, conv_pads, strides, (dil_h, dil_w), group)
        return acc, s_in, w_scales, None
    w = ctx.weight(1, lambda a: np.asarray(a, np.float64), tag="oihw_f64")
    # zero padding in the integer domain; a nonzero zp_in is corrected below
    xs, conv_pads = qwiden_for_conv(xn, zp_in=zp_in, mode="raw", pads=pads)
    acc = conv2d_nhwc(xs, w, conv_pads, strides, (dil_h, dil_w), group)
    if zp_in != 0:
        # conv(x - zp, w) = conv(x, w) - zp * conv(ones, w): a compile-time
        # constant (native-int8-shifted uint8 grids, TFLite int8 imports)
        s_out_f = float(np.asarray(out_q.scales).reshape(-1)[0])

        def _zp_corr():
            w_raw = ctx.const_data(1).astype(np.int64)  # [O, I/g, kh, kw]
            m = (s_in * w_scales.astype(np.float64) / s_out_f)
            corr = _ones_conv_np(
                w_raw, p, in_h, in_w, pads, (dil_h, dil_w)
            )  # [oh, ow, O] or [O]
            return (-zp_in * corr * m).astype(np.float32)[None]

        zcorr = ctx.get_param("zp_corr", _zp_corr)
        return acc, s_in, w_scales, zcorr
    return acc, s_in, w_scales, None


def _requant_conv_out(ctx: LowerCtx, acc, s_in, w_scales, corr, residual=None):
    """Fold dequant-scale, bias, activation, and requant into one pass
    (qrequant): q = clip(round(acc*M[c] + B[c]) + zp_out). With a fused
    residual add (fuse_conv_add pass) the full unfused chain — requant to the
    mid tensor, dequant both operands, add, requant to the out tensor,
    optional trailing relu — runs there bit-exactly; under the relaxed tier
    the residual joins before the one rounding instead."""
    M, B, ep = _requant_epilogue(ctx, s_in, w_scales, residual is not None)
    return nhwc(qrequant(acc, M, B, corr, residual, ep))


def _requant_epilogue(ctx: LowerCtx, s_in: float, w_scales, fused_residual: bool):
    """The requant of _requant_conv_out onto _conv_grid(ctx): M [C2], B [C2]
    or None, and the Epilogue of its f32 steps."""
    t_mid, p = _conv_grid(ctx), ctx.params
    out_q, out_dtype = t_mid.quant, t_mid.dtype
    s_out = float(np.asarray(out_q.scales).reshape(-1)[0])
    zp_out = int(np.asarray(out_q.zero_points).reshape(-1)[0])

    def multipliers():
        return (s_in * w_scales / s_out).astype(np.float32)

    M = ctx.get_param("requant_m", multipliers)

    fused_pos = p.get("fused_add_pos")
    has_bias = (fused_pos == 3) if fused_pos is not None else ctx.num_inputs > 2
    # relaxed fused-residual: the residual zero-point term -zp_r*beta is a
    # constant folded into the bias vector
    relaxed_res = fused_residual and _relaxed_fused_add(ctx)
    beta = zp_shift = 0.0
    if relaxed_res:
        t_r = ctx.in_tensor(p["fused_add_pos"])
        s_r = float(np.asarray(t_r.quant.scales).reshape(-1)[0])
        zp_r = int(np.asarray(t_r.quant.zero_points).reshape(-1)[0])
        beta = s_r / s_out
        zp_shift = zp_r * beta
    B = None
    if has_bias:
        def bias_q():
            b = ctx.const_data(2).astype(np.float32)
            return (b * s_in * w_scales / s_out - zp_shift).astype(np.float32)

        B = ctx.get_param("requant_b", bias_q)
    act = p.get("activation", -1)
    lo, hi = qmath.qrange(out_dtype, out_q)
    ep = dict(zp_out=zp_out, lo=lo, hi=hi, s_out=s_out, act=-1 if act is None else act,
              zp_shift=float(np.float32(zp_shift)),
              out_u8=ctx.out_tensor(0).dtype == DType.UINT8,
              relu2=bool(p.get("fused_add_relu")))
    if relaxed_res:
        ep.update(residual="relaxed", beta=float(np.float32(beta)))
    elif fused_residual:
        # the mid tensor t is requantized through the unfused eltwise-sum
        # numerics: dequant both, add, requant. The JAX engine divides by
        # s_out2 inside jit, where XLA turns a division by a constant into a
        # multiply by its f32 reciprocal
        t_outf = ctx.out_tensor(0)
        t_r = ctx.in_tensor(fused_pos)
        s_out2 = float(np.asarray(t_outf.quant.scales).reshape(-1)[0])
        lo2, hi2 = qmath.qrange(t_outf.dtype, t_outf.quant)
        ep.update(residual="exact",
                  s_r=float(np.asarray(t_r.quant.scales).reshape(-1)[0]),
                  zp_r=int(np.asarray(t_r.quant.zero_points).reshape(-1)[0]),
                  inv_s_out2=float(np.float32(1.0) / np.float32(s_out2)),
                  zp_out2=int(np.asarray(t_outf.quant.zero_points).reshape(-1)[0]),
                  lo2=lo2, hi2=hi2)
    return M, B, Epilogue(**ep)


def _shifted_s8(ctx: LowerCtx) -> bool:
    """INT8 input with a nonzero zero-point (a native-int8-shifted uint8
    grid): the integer qconv/qgemm kernels assume symmetric zp=0."""
    t_in = ctx.in_tensor(0)
    return (
        t_in.dtype == DType.INT8
        and t_in.quant is not None
        and not t_in.quant.per_channel
        and int(np.asarray(t_in.quant.zero_points).reshape(-1)[0]) != 0
    )


def _pallas_qconv_ok(ctx: LowerCtx) -> bool:
    """The JAX engine's route to qconv_direct / qconv1x1
    (ops/pallas/qconv.py): integer storage mode, group 1, dilation 1,
    stride 1/2, C % 128 == 0 for k > 1."""
    if (
        not _fast_enabled(ctx)
        or not ctx.options.pallas_qconv
        or ctx.options.quant_bf16_storage
        or _shifted_s8(ctx)
    ):
        return False
    p = ctx.params
    t_w = ctx.in_tensor(1)
    in_c = int(t_w.shape[1])
    k1 = p["kernel_h"] == 1 and p["kernel_w"] == 1
    return (
        not _pc_zero_points(t_w)
        and p.get("activation", -1) != ACT_SILU
        and p["group"] == 1
        and p["dilation_h"] == 1
        and p["dilation_w"] == 1
        and p["stride_h"] == p["stride_w"]
        and p["stride_h"] in (1, 2)
        and p["kernel_h"] * p["kernel_w"] <= 49
        and (k1 or in_c % 128 == 0)
    )


def _pallas_conv1x1_ok(ctx: LowerCtx) -> bool:
    """The JAX engine's route to qgemm_requant for pointwise convs."""
    if (
        not _fast_enabled(ctx)
        or not _no_fused_add(ctx)
        or not ctx.options.pallas_qgemm
        or ctx.options.quant_bf16_storage
        or _shifted_s8(ctx)
    ):
        return False
    p = ctx.params
    t_w = ctx.in_tensor(1)
    out_c, in_c = t_w.shape[0], int(np.prod(t_w.shape[1:]))
    return (
        not _pc_zero_points(t_w)
        and p.get("activation", -1) != ACT_SILU
        and p["kernel_h"] == 1
        and p["kernel_w"] == 1
        and p["group"] == 1
        and p["pad_h0"] == 0
        and p["pad_w0"] == 0
        and p["pad_h1"] == 0
        and p["pad_w1"] == 0
        and in_c >= 128
        and out_c >= 128
    )


def _int_stored(ctx: LowerCtx, t) -> bool:
    """The JAX gate's _int_stored(ctx, t): tensor t stores its raw 1-byte
    dtype under the JAX engine's storage plan. The port stores every
    activation as its integer dtype, but routes as the JAX engine does: with
    quant_bf16_storage=False every tensor counts; under the native-int8 plan
    (executor/engine.py sets graph._bf16_tids to an empty set) every tensor
    not in _bf16_tids does. Otherwise the port builds no storage plan:
    _bf16_tids is unset, as the JAX engine's plan is on any graph with a
    depthwise conv, the only graphs this predicate routes."""
    if not ctx.options.quant_bf16_storage:
        return True
    plan = getattr(ctx.graph, "_bf16_tids", None)
    return plan is not None and t.idx not in plan


def _pallas_dw_ok(ctx: LowerCtx) -> bool:
    """The JAX engine's route to dw_qconv_hwcn (TT_DW_PALLAS gate):
    depthwise k in {3,5}, stride 1/2, batch >= 32, 1-byte stored input and
    output (_int_stored); and, in the port alone, TF-SAME pads."""
    if os.environ.get("TT_DW_PALLAS", "0") in ("0", "off", ""):
        return False
    if not _fast_enabled(ctx) or not _no_fused_add(ctx):
        return False
    p = ctx.params
    t_in, t_w, t_out = ctx.in_tensor(0), ctx.in_tensor(1), ctx.out_tensor(0)
    group = p.get("group", 1)
    out_c = int(t_w.shape[0]) if t_w.shape else 0
    if not (group > 1 and group == out_c and int(t_w.shape[1]) == 1):
        return False
    if out_c % 32 != 0:
        return False
    if t_in.quant is None or t_w.quant is None or t_out.quant is None:
        return False
    if t_in.quant.per_channel or t_out.quant.per_channel:
        return False
    if t_in.shape and len(t_in.shape) != 4:
        return False
    batch = ctx.options.batch_size or (int(t_in.shape[0]) if t_in.shape else 1)
    if batch < 32:
        return False
    # a conv built through the C API carries only the attrs its embedder set
    # (capi_bridge.set_node_attr): without a kernel size or a stride the
    # candidate declines, and an absent dilation is Tengine's default, 1. The
    # JAX gate indexes all of them and raises KeyError (ROADMAP §3).
    k, s_ = p.get("kernel_h"), p.get("stride_h")
    if k is None or s_ is None or p.get("kernel_w") is None or p.get("stride_w") is None:
        return False
    pads = [p.get(f"pad_{a}", -1) for a in ("h0", "h1", "w0", "w1")]
    # TF-SAME pads (all -1: the TF and TFLite imports') resolve at run time
    # (_conv_pads) to pads inside the kernel's envelope at every input size
    # for k in {3, 5}, stride 1 or 2. The JAX gate refuses them: a port-only
    # route (ROADMAP §3), within 1 LSB of the fast lowering.
    pad_ok = all(v == -1 for v in pads) or (
        all(v >= 0 for v in pads)
        and pads[1] <= max(0, k - s_ - pads[0]) + (s_ - 1)
        and pads[3] <= max(0, k - s_ - pads[2]) + (s_ - 1)
        and pads[0] <= k - 1
        and pads[2] <= k - 1
    )
    return (
        pad_ok
        and p.get("activation", -1) != ACT_SILU
        and k == p["kernel_w"]
        and k in (3, 5)
        and p.get("dilation_h", 1) == 1
        and p.get("dilation_w", 1) == 1
        and s_ == p["stride_w"]
        and s_ in (1, 2)
        and _int_stored(ctx, t_in)
        and _int_stored(ctx, t_out)
        and ctx.const_data(1) is not None
    )


def _env_stem_all() -> bool:
    return os.environ.get("TT_STEM_ALL", "") not in ("", "0")


def _pallas_stem_ok(ctx: LowerCtx) -> bool:
    """Fused stem kernel (ops/cuda/stem_conv.py): small-channel stride-2
    quantized conv on raw integer input. The gate is the JAX engine's,
    unchanged (W >= 512, or TT_STEM_ALL=1), so both engines route alike."""
    if not _fast_enabled(ctx) or not ctx.options.pallas_stem:
        return False
    p = ctx.params
    t_in = ctx.in_tensor(0)
    t_w = ctx.in_tensor(1)
    if t_in.dtype not in (DType.INT8, DType.UINT8):
        return False
    if t_in.quant is None or t_w.quant is None or ctx.out_tensor(0).quant is None:
        return False
    if not t_in.shape or len(t_in.shape) != 4:
        return False
    H, W = int(t_in.shape[2]), int(t_in.shape[3])
    kh, kw = p["kernel_h"], p["kernel_w"]
    pad = p.get("pad_h0", 0)
    return (
        "fused_add_pos" not in p
        and not _pc_zero_points(t_w)
        and p.get("group", 1) == 1
        and p.get("dilation_h", 1) == 1
        and p.get("dilation_w", 1) == 1
        and p["stride_h"] == 2
        and p["stride_w"] == 2
        and kh == kw
        and kh <= 7
        and int(t_w.shape[1]) <= 4
        and all(p.get(f"pad_{a}", -1) == pad for a in ("h0", "h1", "w0", "w1"))
        and kh <= 2 * pad + 2
        and H % 2 == 0
        and W % 2 == 0
        and (H // 2) % 8 == 0
        and (W >= 512 or _env_stem_all())
        and ctx.const_data(1) is not None
    )


@register_op("Convolution", score=SCORE_STATIC + 3, predicate=_pallas_dw_ok, quant=True)
def lower_conv_quant_pallas_dw(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Depthwise conv + requant in one CUDA kernel (ops/cuda/dw_conv.py):
    exact integer accumulation of the raw values with zp_in borders, the
    zero-point correction folded into B on the host."""
    p = ctx.params
    t_in, t_w, t_out = ctx.in_tensor(0), ctx.in_tensor(1), ctx.out_tensor(0)
    out_c = int(t_w.shape[0])
    k = p["kernel_h"]
    s_in = float(np.asarray(t_in.quant.scales).reshape(-1)[0])
    zp_in = int(np.asarray(t_in.quant.zero_points).reshape(-1)[0])
    w_scales = _wscales(t_w.quant, out_c)
    s_out = float(np.asarray(t_out.quant.scales).reshape(-1)[0])
    zp_out = int(np.asarray(t_out.quant.zero_points).reshape(-1)[0])
    zp_w = _zp_w(t_w.quant, out_c)

    def w_taps():
        # true tap values w - zp_w, [C, 1, k, k] -> [k*k, Cp] int16
        return pack_dw_taps(ctx.const_data(1).astype(np.float32) - zp_w)

    def mvec():
        return (s_in * w_scales / s_out).astype(np.float32)

    def bvec():
        w_raw = ctx.const_data(1).astype(np.float64)
        colsum = (w_raw - zp_w).reshape(out_c, -1).sum(axis=1)
        b = ctx.const_data(2).astype(np.float64) if ctx.num_inputs > 2 else 0.0
        m = s_in * w_scales.astype(np.float64) / s_out
        return ((b - zp_in * colsum) * m).astype(np.float32)

    wf = ctx.get_param("dwp_w", w_taps)
    M = ctx.get_param("dwp_m", mvec)
    B = ctx.get_param("dwp_b", bvec)

    xn = as_nhwc(x).contiguous()
    n, in_h, in_w, _ = xn.shape
    (pt, pb), (pl_, pr) = _conv_pads(in_h, in_w, p, k, k)
    lo, hi = qmath.qrange(t_out.dtype, t_out.quant)
    out = dw_qconv(
        xn, wf, M, B,
        k=k, stride=p["stride_h"], pad_t=int(pt), pad_b=int(pb), pad_l=int(pl_),
        pad_r=int(pr), zp_in=zp_in, zp_out=zp_out, act=p.get("activation", -1),
        s_out=s_out, lo=float(lo), hi=float(hi),
        out_u8=t_out.dtype == DType.UINT8,
    )
    return nhwc(out)


@register_op("Convolution", score=SCORE_STATIC + 2, predicate=_pallas_stem_ok, quant=True)
def lower_conv_quant_pallas_stem(ctx: LowerCtx, x: TArr, *rest: TArr):
    """First-layer conv + requant in one CUDA kernel (exact int32 MAC)."""
    p = ctx.params
    t_in, t_w, t_out = ctx.in_tensor(0), ctx.in_tensor(1), ctx.out_tensor(0)
    out_c = int(t_w.shape[0])
    s_in = float(np.asarray(t_in.quant.scales).reshape(-1)[0])
    zp_in = int(np.asarray(t_in.quant.zero_points).reshape(-1)[0])
    w_scales = _wscales(t_w.quant, out_c)
    s_out = float(np.asarray(t_out.quant.scales).reshape(-1)[0])
    zp_out = int(np.asarray(t_out.quant.zero_points).reshape(-1)[0])
    zp_w = (
        0
        if t_w.quant.per_channel
        else int(np.asarray(t_w.quant.zero_points).reshape(-1)[0])
    )
    signed_in = t_in.dtype == DType.INT8

    def packed():
        mult = (s_in * w_scales / s_out).astype(np.float32)
        b_q = (
            ctx.const_data(2).astype(np.float64)
            if ctx.num_inputs > 2
            else np.zeros(out_c, np.float64)
        )
        bias = (b_q * mult).astype(np.float32)
        return pack_stem_weights(
            ctx.const_data(1), mult, bias,
            k=p["kernel_h"], zp_in=zp_in, zp_w=zp_w, signed_in=signed_in,
        )

    wmat = ctx.get_param("stem_w", lambda: packed()[0])
    m_e = ctx.get_param("stem_m", lambda: packed()[1])
    b_e = ctx.get_param("stem_b", lambda: packed()[2])

    lo, hi = qmath.qrange(t_out.dtype, t_out.quant)
    out = stem_qconv(
        as_nchw(x).contiguous(), wmat, m_e, b_e,
        k=p["kernel_h"], pad=p.get("pad_h0", 0), w_corr=128 - zp_w if zp_w else 0,
        act=p.get("activation", -1), s_out=s_out,
        zp_in=zp_in, zp_out=zp_out, lo=float(lo), hi=float(hi),
    )
    return nhwc(out)


@register_op("Convolution", score=SCORE_STATIC + 1, predicate=_pallas_qconv_ok, quant=True)
def lower_conv_quant_pallas_direct(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Direct k×k conv through the int8 implicit-GEMM kernel (exact int32
    accumulation, fused requant; ops/cuda/qconv.py); optionally with a fused
    residual eltwise-sum (fuse_conv_add pass)."""
    p = ctx.params
    fused_pos = p.get("fused_add_pos")
    t_in, t_w = ctx.in_tensor(0), ctx.in_tensor(1)
    t_out = ctx.out_tensor(0)
    # the conv's own requant targets the pre-add intermediate tensor when the
    # residual add is fused
    t_mid = ctx.graph.tensors[p["fused_add_mid"]] if fused_pos is not None else t_out
    has_bias = (fused_pos == 3) if fused_pos is not None else (ctx.num_inputs > 2)
    kh, kw, s = p["kernel_h"], p["kernel_w"], p["stride_h"]
    out_c, in_c = int(t_w.shape[0]), int(t_w.shape[1])

    s_in = float(np.asarray(t_in.quant.scales).reshape(-1)[0])
    zp_in = int(np.asarray(t_in.quant.zero_points).reshape(-1)[0])
    w_scales = _wscales(t_w.quant, out_c)
    s_mid = float(np.asarray(t_mid.quant.scales).reshape(-1)[0])
    zp_mid = int(np.asarray(t_mid.quant.zero_points).reshape(-1)[0])

    is_u8 = t_in.dtype == DType.UINT8
    if is_u8:
        zp_w = int(np.asarray(t_w.quant.zero_points).reshape(-1)[0])
        cx, cw = 128 - zp_in, 128 - zp_w
    else:
        cx = cw = 0

    w = ctx.get_param("qconv_w", lambda: pack_qconv_weights(ctx.const_data(1), is_u8))
    M = ctx.get_param("qconv_m", lambda: (s_in * w_scales / s_mid).astype(np.float32))

    def bvec():
        if is_u8:
            wsh = ctx.const_data(1).astype(np.int32) - 128
            colsum = wsh.sum(axis=(1, 2, 3))
            K = in_c * kh * kw
            b0 = cx * colsum + K * cx * cw
        else:
            b0 = np.zeros(out_c, np.int64)
        if has_bias:
            b0 = b0 + ctx.const_data(2).astype(np.int64)
        m = s_in * w_scales / s_mid
        return (b0.astype(np.float64) * m + zp_mid).astype(np.float32)

    B = ctx.get_param("qconv_b", bvec)

    res = None
    residual = None
    if fused_pos is not None:
        t_r = ctx.in_tensor(fused_pos)
        s_r = float(np.asarray(t_r.quant.scales).reshape(-1)[0])
        zp_r = int(np.asarray(t_r.quant.zero_points).reshape(-1)[0])
        s_out2 = float(np.asarray(t_out.quant.scales).reshape(-1)[0])
        zp_out2 = int(np.asarray(t_out.quant.zero_points).reshape(-1)[0])
        res = (s_mid, zp_mid, s_r, zp_r, s_out2, zp_out2,
               bool(p.get("fused_add_relu")))
        residual = as_nhwc(rest[fused_pos - 1]).contiguous()

    xn = as_nhwc(x)
    if kh == 1 and kw == 1 and s == 2:
        # pointwise stride-2 (resnet downsample): pre-subsample, as the JAX
        # lowering does
        xn = xn[:, ::2, ::2, :]
        s = 1
    xn = xn.contiguous()
    n, in_h, in_w, _ = xn.shape
    pads = _conv_pads(in_h, in_w, p, kh, kw)
    (pt, pb), (pl_, pr) = pads[0], pads[1]
    lo, hi = qmath.qrange(t_out.dtype, t_out.quant)
    common = dict(
        res=res,
        cw=cw,
        act=p.get("activation", -1),
        inv_s_out=1.0 / s_mid, zp_out=zp_mid,
        lo=lo, hi=hi,
        out_dtype="uint8" if t_out.dtype == DType.UINT8 else "int8",
    )
    if kh == 1 and kw == 1 and s == 1 and not (pt or pb or pl_ or pr):
        out = qconv1x1(
            xn.reshape(n * in_h * in_w, in_c), w, M, B,
            residual=None if residual is None
            else residual.reshape(n * in_h * in_w, out_c),
            **common,
        )
        return nhwc(out.reshape(n, in_h, in_w, out_c))
    out = qconv_direct(
        xn, w, M, B,
        residual=residual,
        kh=kh, kw=kw, stride=s,
        pad_t=int(pt), pad_b=int(pb), pad_l=int(pl_), pad_r=int(pr),
        zp_in=zp_in,
        **common,
    )
    return nhwc(out)


def _qgemm_inputs(ctx: LowerCtx, w_idx: int = 1, b_idx: int = 2):
    """Shared folding for the qgemm path: shifted weights, requant
    multipliers, and the combined per-channel offset (zero-point correction
    terms + bias), all precomputed on the host as the JAX lowering does."""
    t_in, t_w, t_out = ctx.in_tensor(0), ctx.in_tensor(w_idx), ctx.out_tensor(0)
    s_in = float(np.asarray(t_in.quant.scales).reshape(-1)[0])
    zp_in = int(np.asarray(t_in.quant.zero_points).reshape(-1)[0])
    out_c = t_w.shape[0]
    w_scales = _wscales(t_w.quant, out_c)
    s_out = float(np.asarray(t_out.quant.scales).reshape(-1)[0])
    zp_out = int(np.asarray(t_out.quant.zero_points).reshape(-1)[0])

    is_u8 = t_in.dtype == DType.UINT8
    if is_u8:
        zp_w = int(np.asarray(t_w.quant.zero_points).reshape(-1)[0])
        cx = 128 - zp_in
        cw = 128 - zp_w
    else:
        cx = cw = 0

    def w_packed():
        a = ctx.const_data(w_idx)
        return pack_qgemm_weights(a.reshape(a.shape[0], -1), is_u8)

    w = ctx.get_param("qgemm_w", w_packed)

    def mult():
        return (s_in * w_scales / s_out).astype(np.float32)

    M = ctx.get_param("qgemm_m", mult)

    def bvec():
        a = ctx.const_data(w_idx)
        flat = a.reshape(a.shape[0], -1)
        K = flat.shape[1]
        if is_u8:
            wsh = (flat.astype(np.int32) - 128)
            colsum = wsh.sum(axis=1)
            b0 = cx * colsum + K * cx * cw
        else:
            b0 = np.zeros(out_c, np.int64)
        if len(ctx.node.inputs) > b_idx:
            b0 = b0 + ctx.const_data(b_idx).astype(np.int64)
        m = s_in * w_scales / s_out
        return (b0.astype(np.float64) * m + zp_out).astype(np.float32)

    B = ctx.get_param("qgemm_b", bvec)
    return w, M, B, cw, s_out, zp_out, is_u8


@register_op("Convolution", score=SCORE_STATIC, predicate=_pallas_conv1x1_ok, quant=True)
def lower_conv1x1_quant_pallas(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Pointwise conv through the fused int8 GEMM kernel (ops/cuda/qgemm.py)."""
    p = ctx.params
    t_out = ctx.out_tensor(0)
    w, M, B, cw, s_out, zp_out, _ = _qgemm_inputs(ctx)

    xn = as_nhwc(x)
    if p["stride_h"] > 1 or p["stride_w"] > 1:
        xn = xn[:, :: p["stride_h"], :: p["stride_w"], :]
    n, oh, ow, c = xn.shape
    lo, hi = qmath.qrange(t_out.dtype, t_out.quant)
    out = qgemm_requant(
        xn.contiguous().reshape(n * oh * ow, c),  # uint8 is shifted inside the kernel
        w, M, B,
        cw=cw,
        act=p.get("activation", -1),
        inv_s_out=1.0 / s_out,
        zp_out=zp_out,
        lo=lo, hi=hi,
        out_dtype="uint8" if t_out.dtype == DType.UINT8 else "int8",
    )
    return nhwc(out.reshape(n, oh, ow, -1))


def _pallas_fc_ok(ctx: LowerCtx) -> bool:
    return (
        _fast_enabled(ctx)
        and ctx.options.pallas_qgemm
        and not ctx.options.quant_bf16_storage
        and not _shifted_s8(ctx)  # int8 path assumes zp = 0
        and not _pc_zero_points(ctx.in_tensor(1))
    )


@register_op("FullyConnected", score=SCORE_STATIC, predicate=_pallas_fc_ok, quant=True)
def lower_fc_quant_pallas(ctx: LowerCtx, x: TArr, *rest: TArr):
    """FC through the fused int8 GEMM kernel (ops/cuda/qgemm.py)."""
    t_out = ctx.out_tensor(0)
    w, M, B, cw, s_out, zp_out, _ = _qgemm_inputs(ctx)

    xs = as_semantic(x)
    m = xs.shape[0]
    rank = xs.ndim
    xf = xs.contiguous().reshape(m, -1)
    lo, hi = qmath.qrange(t_out.dtype, t_out.quant)
    out = qgemm_requant(
        xf, w, M, B,
        cw=cw,
        act=-1,
        inv_s_out=1.0 / s_out,
        zp_out=zp_out,
        lo=lo, hi=hi,
        out_dtype="uint8" if t_out.dtype == DType.UINT8 else "int8",
    )
    return fc_output(out, rank)


def _igemm_fast_ok(ctx: LowerCtx) -> bool:
    """A fast-tier conv whose exact sums the int8 implicit GEMM
    (qconv_fast) computes, with the fast tier's requant in its epilogue: the
    INT8 branch of _conv_quant_common at input zero point 0, group 1,
    dilation 1, stride 1 or 2 both ways, windows to 49 taps (neither side
    above 16), and K·128² below 2^31, so that the kernel's int32 sums are
    exact."""
    p = ctx.params
    t_in, t_w = ctx.in_tensor(0), ctx.in_tensor(1)
    if not (t_in.dtype == DType.INT8 and t_w.dtype == DType.INT8 and t_in.quant is not None
            and t_w.quant is not None and not t_in.quant.per_channel
            and ctx.const_data(1) is not None):
        return False
    kh, kw = p["kernel_h"], p["kernel_w"]
    return (
        int(np.asarray(t_in.quant.zero_points).reshape(-1)[0]) == 0
        and not np.any(np.asarray(t_w.quant.zero_points))
        and p["group"] == 1
        and p["dilation_h"] == 1
        and p["dilation_w"] == 1
        and p["stride_h"] == p["stride_w"]
        and p["stride_h"] in (1, 2)
        and kh * kw <= 49
        and max(kh, kw) <= 16
        and int(t_w.shape[1]) * kh * kw * 128 * 128 < 2**31
    )


def _conv_quant_igemm(ctx: LowerCtx, x: TArr, residual):
    """The fast tier's INT8 conv through qconv_fast: the sums and the
    requant of lower_conv_quant_fast's float64 chain in one launch, the same
    bytes out."""
    p = ctx.params
    t_in, t_w = ctx.in_tensor(0), ctx.in_tensor(1)
    out_c = int(t_w.shape[0])
    s_in = float(np.asarray(t_in.quant.scales).reshape(-1)[0])
    M, B, ep = _requant_epilogue(ctx, s_in, _wscales(t_w.quant, out_c), residual is not None)
    # [O, kh, kw, Cp] int8: output channels on dim 0, as parallel/sharding.py
    # slices a conv weight
    w = ctx.weight(1, lambda a: pack_qconv_weights(a, False).reshape(
        out_c, p["kernel_h"], p["kernel_w"], -1), tag="ohwi_i8")
    xn = as_nhwc(x)
    pads = _conv_pads(int(xn.shape[1]), int(xn.shape[2]), p, p["kernel_h"], p["kernel_w"])
    return nhwc(qconv_fast(xn, w, M, B, residual, ep, stride=p["stride_h"], pads=pads))


@register_op("Convolution", score=SCORE_BEST, predicate=_fast_enabled, quant=True)
def lower_conv_quant_fast(ctx: LowerCtx, x: TArr, *rest: TArr):
    fused_pos = ctx.params.get("fused_add_pos")
    residual = as_nhwc(rest[fused_pos - 1]) if fused_pos is not None else None
    if _igemm_fast_ok(ctx):
        return _conv_quant_igemm(ctx, x, residual)
    acc, s_in, w_scales, corr = _conv_quant_common(ctx, x)
    return _requant_conv_out(ctx, acc, s_in, w_scales, corr, residual=residual)


@register_op(
    "Convolution",
    score=SCORE_CANDO,
    predicate=lambda c: node_is_quant(c) and _no_fused_add(c),
    quant=True,
)
def lower_conv_quant_ref(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Reference semantics: dequant -> fp32 conv -> activation -> requant
    (conv_kernel_ref_uint8.c:67-177 / conv_kernel_ref_int8.c)."""
    p = ctx.params
    dil_h, dil_w = p["dilation_h"], p["dilation_w"]
    kh_eff = (p["kernel_h"] - 1) * dil_h + 1
    kw_eff = (p["kernel_w"] - 1) * dil_w + 1

    t_in, t_w, t_out = ctx.in_tensor(0), ctx.in_tensor(1), ctx.out_tensor(0)
    s_in = float(np.asarray(t_in.quant.scales).reshape(-1)[0])
    w_scales = _wscales(t_w.quant, t_w.shape[0])

    xn = as_nhwc(x)
    n, in_h, in_w, _ = xn.shape
    pads = _conv_pads(in_h, in_w, p, kh_eff, kw_eff)

    xf = qmath.dequantize(xn, t_in.quant)
    # float32 as the JAX engine holds it (per-channel dequantize_np computes
    # in float64)
    w = ctx.weight(
        1,
        lambda a: qmath.dequantize_weight_np(a, t_w.quant, "Convolution").astype(np.float32),
        tag="oihw_deq",
    )
    out = conv2d_nhwc(xf, w, pads, (p["stride_h"], p["stride_w"]), (dil_h, dil_w), p["group"])
    if ctx.num_inputs > 2:
        def bias_f():
            b = ctx.const_data(2).astype(np.float32)
            return b * s_in * w_scales

        out = out + ctx.get_param("bias_deq", bias_f)
    out = apply_activation(out, p.get("activation", -1))
    return nhwc(qmath.requantize(out, t_out.quant, t_out.dtype))


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------


@register_op("FullyConnected", score=SCORE_BEST, predicate=_fast_enabled, quant=True)
def lower_fc_quant_fast(ctx: LowerCtx, x: TArr, *rest: TArr):
    """FC with exact integer accumulation and the folded requant
    q = clip(round(acc*M + B) + zp_out). Symmetric INT8 operands: the dot of
    the raw values (a nonzero zp_in corrected by the constant
    -zp_in*colsum(w)); otherwise the dot of the shifted values
    (x - zp_in)·(w - zp_w). The JAX lowering takes the second branch under
    its bf16 storage and sums exact bf16 products in f32, which rounds on
    the way once a partial sum passes 2^24; the float64 dot here sums
    exactly and rounds once to f32, so a row with such sums is held to
    1 LSB, not to the bit."""
    t_in, t_w, t_out = ctx.in_tensor(0), ctx.in_tensor(1), ctx.out_tensor(0)
    s_in = float(np.asarray(t_in.quant.scales).reshape(-1)[0])
    zp_in = int(np.asarray(t_in.quant.zero_points).reshape(-1)[0])
    out_c = t_w.shape[0]
    w_scales = _wscales(t_w.quant, out_c)
    s_out = float(np.asarray(t_out.quant.scales).reshape(-1)[0])
    zp_out = int(np.asarray(t_out.quant.zero_points).reshape(-1)[0])

    xs = as_semantic(x)
    xf = xs.reshape(xs.shape[0], -1).to(torch.float64)

    zp_w = _zp_w(t_w.quant, out_c)
    zc = None
    if t_in.dtype == DType.INT8 and t_w.dtype == DType.INT8 and not np.any(zp_w):
        w = ctx.weight(1, lambda a: np.ascontiguousarray(a.T, np.float64), tag="kt_f64")
        acc = xf @ w
        if zp_in != 0:
            zc = ctx.get_param(
                "fc_zp_corr",
                lambda: (
                    -float(zp_in)
                    * ctx.const_data(1).astype(np.int64).reshape(out_c, -1).sum(axis=1)
                ).astype(np.float32),
            )
    else:
        zp_rows = np.reshape(zp_w, (-1, 1))  # [out_c or 1, 1] against [out_c, K]
        w = ctx.weight(
            1, lambda a: np.ascontiguousarray((a.astype(np.float64) - zp_rows).T),
            tag="kt_zshift_f64",
        )
        acc = (xf - float(zp_in)) @ w

    M = ctx.get_param("requant_m", lambda: (s_in * w_scales / s_out).astype(np.float32))
    B = None
    if ctx.num_inputs > 2:
        B = ctx.get_param(
            "requant_b",
            lambda: (ctx.const_data(2).astype(np.float32) * s_in * w_scales / s_out).astype(
                np.float32
            ),
        )
    lo, hi = qmath.qrange(t_out.dtype, t_out.quant)
    ep = Epilogue(zp_out=zp_out, lo=lo, hi=hi, out_u8=t_out.dtype == DType.UINT8,
                  s_out=s_out, corr_first=True)
    return fc_output(qrequant(acc, M, B, zc, None, ep), xs.ndim)


@register_op("FullyConnected", score=SCORE_CANDO, predicate=node_is_quant, quant=True)
def lower_fc_quant_ref(ctx: LowerCtx, x: TArr, *rest: TArr):
    """fc_kernel_ref_uint8/int8 semantics: dequant -> fp32 dot -> requant."""
    t_in, t_w, t_out = ctx.in_tensor(0), ctx.in_tensor(1), ctx.out_tensor(0)
    s_in = float(np.asarray(t_in.quant.scales).reshape(-1)[0])
    w_scales = _wscales(t_w.quant, t_w.shape[0])

    xs = as_semantic(x)
    xf = qmath.dequantize(xs.reshape(xs.shape[0], -1), t_in.quant)
    w = ctx.weight(
        1,
        lambda a: np.ascontiguousarray(
            qmath.dequantize_weight_np(a, t_w.quant, "FullyConnected").astype(np.float32).T
        ),
        tag="kt_deq",
    )
    out = xf @ w
    if ctx.num_inputs > 2:
        out = out + ctx.get_param(
            "bias_deq", lambda: ctx.const_data(2).astype(np.float32) * s_in * w_scales
        )
    return fc_output(
        qmath.requantize(out, t_out.quant, t_out.dtype, reciprocal=True),
        xs.ndim,
    )


# ---------------------------------------------------------------------------
# Data-movement ops that stay in the quantized domain when scales match
# (the reference recomputes them through int math too): max-pool commutes
# with the (monotonic) quantization map.
# ---------------------------------------------------------------------------


def _same_quant(ctx: LowerCtx) -> bool:
    if not node_is_quant(ctx):
        return False
    qi, qo = ctx.in_tensor(0).quant, ctx.out_tensor(0).quant
    return (
        not qi.per_channel
        and not qo.per_channel
        and float(qi.scales) == float(qo.scales)
        and int(qi.zero_points) == int(qo.zero_points)
    )


@register_op("Pooling", score=SCORE_BEST, predicate=lambda c: _same_quant(c) and c.params.get("alg") == 0, quant=True)
def lower_maxpool_quant(ctx: LowerCtx, x: TArr):
    """Max-pool commutes with the quantization map when in/out quant params
    match (pooling_kernel_ref_uint8.c takes the same shortcut)."""
    from .lowering import lower_pooling

    return lower_pooling(ctx, x)


# ---------------------------------------------------------------------------
# Leaky ReLU and Dropout on quantized tensors. The JAX engine runs both under
# its generic dequant -> fp32 -> requant wrapper, inside jit, where XLA's
# algebraic simplifier rewrites the chain before it rounds anything: the
# division by the output scale becomes a multiply by its f32 reciprocal, and
# a multiply by a constant that follows a multiply by a constant folds into
# one multiply by their f32 product ((a*s)*0.1 -> a*(s*0.1)). A leaky ReLU
# on a shared grid lands on .5 ties (0.1*q) where the folded and unfolded
# forms round apart, so these lowerings compute the folded arithmetic
# itself, term for term, and both engines give the same integers.
# ---------------------------------------------------------------------------


def _f32_product(a, b) -> float:
    """Two constants multiplied in f32, as XLA folds them."""
    return float(np.float32(np.float32(a) * np.float32(b)))


def _per_tensor_quant(ctx: LowerCtx) -> bool:
    return (
        node_is_quant(ctx)
        and not ctx.in_tensor(0).quant.per_channel
        and not ctx.out_tensor(0).quant.per_channel
    )


def _quant_scalars(t):
    return (float(np.float32(np.asarray(t.quant.scales).reshape(-1)[0])),
            int(np.asarray(t.quant.zero_points).reshape(-1)[0]))


def _inv_out_scale(ctx: LowerCtx) -> float:
    return float(np.float32(1.0) / np.float32(_quant_scalars(ctx.out_tensor(0))[0]))


def _round_store(ctx: LowerCtx, x: TArr, q: torch.Tensor) -> TArr:
    """round(q) + zp_out, clipped to the output's range and stored."""
    t_out = ctx.out_tensor(0)
    lo, hi = qmath.qrange(t_out.dtype, t_out.quant)
    q = qmath.round_away(q) + float(_quant_scalars(t_out)[1])
    return TArr(qmath.clip_cast(q, lo, hi, qmath.TORCH_DTYPES[t_out.dtype]), x.layout)


@register_op(
    "ReLu", score=SCORE_BEST,
    predicate=lambda c: _per_tensor_quant(c) and bool(c.params.get("negative_slope")),
    quant=True,
)
def lower_leaky_relu_quant(ctx: LowerCtx, x: TArr):
    """where(v > 0, v, v*slope) with v = (q - zp_in)*s_in, requantized, in
    the JAX engine's compiled arithmetic (the negative branch is one
    multiply by f32(s_in*slope))."""
    s_in, zp_in = _quant_scalars(ctx.in_tensor(0))
    a = x.x.to(torch.float32) - float(zp_in)
    pos = a * s_in
    neg = a * _f32_product(s_in, ctx.params["negative_slope"])
    return _round_store(ctx, x, torch.where(pos > 0, pos, neg) * _inv_out_scale(ctx))


@register_op("Dropout", score=SCORE_BEST, predicate=_per_tensor_quant, quant=True)
def lower_dropout_quant(ctx: LowerCtx, x: TArr):
    """Identity with requantization: (q - zp_in) times one f32 constant
    f32(s_in * f32(1/s_out)), rounded — the JAX engine's compiled
    dequant -> identity -> requant."""
    s_in, zp_in = _quant_scalars(ctx.in_tensor(0))
    a = x.x.to(torch.float32) - float(zp_in)
    return _round_store(ctx, x, a * _f32_product(s_in, _inv_out_scale(ctx)))


# ---------------------------------------------------------------------------
# A classifier's tail: global average pool and ReLu in the quantized domain.
# ---------------------------------------------------------------------------


@register_op(
    "Pooling",
    score=SCORE_BEST,
    predicate=lambda c: node_is_quant(c)
    and c.params.get("alg") == 1
    and c.params.get("global_pool"),
    quant=True,
)
def lower_global_avgpool_quant(ctx: LowerCtx, x: TArr):
    """Global average pool on the raw quantized values: the mean commutes
    with the affine dequant map, so the reduce is an exact integer sum S and
    only the pooled [N, 1, 1, C] result pays the dequant -> requant affine
    (pooling_kernel_ref_uint8.c computes dequant-sum-divide-requant; the
    factored form differs in fp association, <= 1 LSB on round ties).

    The affine is the JAX engine's as XLA compiles it (both divisions by a
    constant become multiplies by its f32 reciprocal, and multiplies by
    constants that follow one another fold into one f32 constant): with
    zp_in = 0, q = round(S * f32(f32(f32(1/HW)*s_in) * f32(1/s_out))), bit
    for bit; else q = round((S*f32(1/HW) - zp_in) * f32(s_in*f32(1/s_out))),
    where XLA's CPU compiler contracts S*f32(1/HW) - zp_in into one fused
    multiply-add and this lowering rounds twice: 1 LSB apart on .5 ties."""
    t_in = ctx.in_tensor(0)
    s_in, zp_in = _quant_scalars(t_in)
    xn = as_nhwc(x)
    inv_hw = np.float32(1.0) / np.float32(int(xn.shape[1]) * int(xn.shape[2]))
    s = torch.sum(xn, dim=(1, 2), keepdim=True, dtype=torch.int32).to(torch.float32)
    if zp_in == 0:
        q = s * _f32_product(inv_hw * np.float32(s_in), _inv_out_scale(ctx))
    else:
        q = (s * float(inv_hw) - float(zp_in)) * _f32_product(s_in, _inv_out_scale(ctx))
    return _round_store(ctx, TArr(s, "NHWC"), q)


@register_op(
    "ReLu", score=SCORE_BEST,
    predicate=lambda c: _same_quant(c) and not c.params.get("negative_slope"),
    quant=True,
)
def lower_relu_quant(ctx: LowerCtx, x: TArr):
    """relu in the quantized domain: max(q, zp) (relu_ref uint8 path)."""
    zp = int(np.asarray(ctx.in_tensor(0).quant.zero_points).reshape(-1)[0])
    return TArr(torch.clamp_min(x.x, zp), x.layout)


# ---------------------------------------------------------------------------
# Quantized-domain passthrough for value-preserving data-movement ops: when
# every activation in/out shares one (scale, zp) grid they commute with the
# quantization map and run on the raw stored values (bit-equal; the
# quantizer pins these grids equal). The JAX package's list, ShuffleChannel
# and ChannelGather (the residue of graph/passes.py:fold_shuffle_gathers)
# among them. The port stores every activation as its 1-byte dtype, so no
# cast to a storage dtype follows.
# ---------------------------------------------------------------------------


def _passthrough_same_quant(ctx: LowerCtx) -> bool:
    if not node_is_quant(ctx):
        return False
    t0 = ctx.out_tensor(0)
    q0 = t0.quant
    if q0 is None or q0.per_channel:
        return False
    s0, z0 = float(np.asarray(q0.scales)), int(np.asarray(q0.zero_points))

    def same(t):
        q = t.quant
        return (
            q is not None
            and not q.per_channel
            and t.dtype == t0.dtype
            and float(np.asarray(q.scales)) == s0
            and int(np.asarray(q.zero_points)) == z0
        )

    for pos, tid in enumerate(ctx.node.inputs):
        t = ctx.graph.tensors[tid]
        if t.is_const:
            # a DATA const must share the grid too; integer shape/param
            # consts carry no quant and are allowed for single-data-input
            # ops at position > 0
            if same(t):
                continue
            if ctx.node.op != "Concat" and pos > 0 and t.quant is None:
                continue
            return False
        if not same(t):
            return False
    return all(same(ctx.graph.tensors[t]) for t in ctx.node.outputs)


def _register_passthrough(op: str, base_fn):
    @register_op(op, score=SCORE_BEST, predicate=_passthrough_same_quant, quant=True)
    def _lower(ctx: LowerCtx, *args):
        return base_fn(ctx, *args)

    _lower.__name__ = f"lower_{op.lower()}_quant_passthrough"
    return _lower


def _install_passthroughs():
    from . import lowering as L

    for op, fn in (
        ("ShuffleChannel", L.lower_shufflechannel),
        ("Reshape", L.lower_reshape),
        ("Flatten", L.lower_flatten),
        ("Squeeze", L.lower_squeeze),
        ("Permute", L.lower_permute),
        ("Transpose", L.lower_transpose),
        ("Slice", L.lower_slice),
        ("Concat", L.lower_concat),
        ("Split", L.lower_split),
        # nearest-neighbor upsample duplicates values; crop selects them —
        # both value-preserving (bilinear Interp is NOT and stays wrapped)
        ("Upsample", L.lower_upsample),
        ("Crop", L.lower_crop),
        ("ChannelGather", L.lower_channel_gather),
    ):
        _register_passthrough(op, fn)


_install_passthroughs()
