"""Quantized execution kernels (INT8 per-channel) — PyTorch port of the
subset of tengine_tpu/ops/quantized.py that the yolov5s INT8 path runs.

Two tiers, mirroring the reference's ref-vs-optimized kernel split:

  * SCORE_CANDO "ref" kernels — reproduce the reference C semantics
    literally: dequantize -> fp32 compute -> requantize with round-half-away
    and clip (conv_kernel_ref_int8.c). These are the accuracy oracle
    (TG_DEBUG_REF analog) and what quant_mode="ref" selects.

  * SCORE_BEST "fast" kernels — exact integer accumulation with the
    requantization folded into a single per-channel multiplier:
      acc = conv(x_i8, w_i8)   (exact; float64 holds every partial sum)
    then q = clip(round(acc * M[c] + B[c]) + zp_out).

Activations are stored as their integer dtype everywhere (the JAX engine's
bf16 storage holds the same values). Kernels the JAX engine would route to
but the port does not have yet (qconv_direct, qconv1x1, qgemm_requant,
dw_qconv_hwcn) register with the same predicates and raise
NotImplementedError naming the kernel, so no graph silently takes another
path. Any op without a quant-aware kernel runs under the engine's generic
dequant -> fp32 kernel -> requant wrapper (executor/engine.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..graph.ir import DType, QuantParam
from . import qmath
from .cuda.stem_conv import pack_stem_weights, stem_qconv
from .layout import TArr, as_nchw, as_nhwc, nhwc
from .lowering import ACT_SILU, _conv_pads, apply_activation, conv2d_nhwc
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


def _f32(x: torch.Tensor, v: float) -> torch.Tensor:
    """A 0-dim f32 tensor on x's device. Dividing by it is IEEE division on
    every device (CUDA turns division by a host scalar into a multiply by
    its reciprocal)."""
    return torch.full((), v, dtype=torch.float32, device=x.device)


def _unported(kernel: str, where: str):
    def lower(ctx: LowerCtx, *args):
        raise NotImplementedError(
            f"node {ctx.node.name!r} routes to the {kernel} kernel ({where}), "
            "which the PyTorch port does not have yet"
        )

    lower.__name__ = f"lower_{kernel}_unported"
    return lower


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


def _conv_quant_common(ctx: LowerCtx, x: TArr):
    """Shared quantized conv: returns (acc_f32 NHWC, params pack).

    The int8 branch of tengine_tpu/ops/quantized.py:_conv_quant_common —
    symmetric INT8 weights, exact integer accumulation. The XLA conv there
    accumulates s8×s8 in int32; here a float64 conv does, which is exact
    while every partial sum stays below 2^53 (K·127² is at most ~10^8 in
    any conv net). A float32 conv would not be: it stops being exact once
    K·127² >= 2^24, K > 1040, and yolov5s reaches K = 9216."""
    p = ctx.params
    group = p["group"]
    dil_h, dil_w = p["dilation_h"], p["dilation_w"]
    kh_eff = (p["kernel_h"] - 1) * dil_h + 1
    kw_eff = (p["kernel_w"] - 1) * dil_w + 1

    t_in = ctx.in_tensor(0)
    t_w = ctx.in_tensor(1)
    # with a fused residual add (fuse_conv_add pass) the conv's own requant
    # targets the pre-add intermediate tensor; the add + second requant run
    # in the epilogue (_requant_conv_out). Under the relaxed tier the mid
    # grid is never materialized: multipliers fold straight to the final
    # output scale and the residual joins pre-round (single rounding).
    if p.get("fused_add_pos") is not None:
        if _relaxed_fused_add(ctx):
            t_out = ctx.out_tensor(0)
        else:
            t_out = ctx.graph.tensors[p["fused_add_mid"]]
    else:
        t_out = ctx.out_tensor(0)
    in_q, w_q, out_q = t_in.quant, t_w.quant, t_out.quant

    xn = as_nhwc(x)
    n, in_h, in_w, _ = xn.shape
    pads = _conv_pads(in_h, in_w, p, kh_eff, kw_eff)
    out_c = t_w.shape[0]

    zp_in = int(np.asarray(in_q.zero_points).reshape(-1)[0])
    s_in = float(np.asarray(in_q.scales).reshape(-1)[0])
    w_scales = _wscales(w_q, out_c)
    zp_w = int(np.asarray(w_q.zero_points).reshape(-1)[0]) if not w_q.per_channel else 0

    if not (t_in.dtype == DType.INT8 and t_w.dtype == DType.INT8 and zp_w == 0):
        raise NotImplementedError(
            f"node {ctx.node.name!r}: the uint8 / asymmetric-weight fast branch "
            "(tengine_tpu/ops/quantized.py:265-397) is not ported yet"
        )
    w = ctx.weight(1, lambda a: np.asarray(a, np.float64), tag="oihw_f64")
    # zero padding in the integer domain; a nonzero zp_in is corrected below
    acc = conv2d_nhwc(
        xn.to(torch.float64), w, pads, (p["stride_h"], p["stride_w"]),
        (dil_h, dil_w), group,
    ).to(torch.float32)
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
        return acc, (s_in, w_scales, out_q, t_out.dtype, p, zcorr)
    return acc, (s_in, w_scales, out_q, t_out.dtype, p, None)


def _requant_conv_out(ctx: LowerCtx, acc, pack, residual=None):
    """Fold dequant-scale, bias, activation, and requant into one vector op:
    q = clip(round(acc*M[c] + B[c]) + zp_out). With a fused residual add
    (fuse_conv_add pass) the full unfused chain — requant to the mid tensor,
    dequant both operands, add, requant to the out tensor, optional trailing
    relu — runs here bit-exactly; under the relaxed tier the residual joins
    before the one rounding instead."""
    s_in, w_scales, out_q, out_dtype, p, zcorr = pack
    s_out = float(np.asarray(out_q.scales).reshape(-1)[0])
    zp_out = int(np.asarray(out_q.zero_points).reshape(-1)[0])

    def multipliers():
        return (s_in * w_scales / s_out).astype(np.float32)

    M = ctx.get_param("requant_m", multipliers)

    fused_pos = p.get("fused_add_pos")
    has_bias = (fused_pos == 3) if fused_pos is not None else ctx.num_inputs > 2
    # relaxed fused-residual: the residual zero-point term -zp_r*beta is a
    # constant folded into the bias vector
    relaxed_res = residual is not None and _relaxed_fused_add(ctx)
    beta = zp_shift = 0.0
    if relaxed_res:
        t_r = ctx.in_tensor(p["fused_add_pos"])
        s_r = float(np.asarray(t_r.quant.scales).reshape(-1)[0])
        zp_r = int(np.asarray(t_r.quant.zero_points).reshape(-1)[0])
        beta = s_r / s_out
        zp_shift = zp_r * beta
    act = p.get("activation", -1)
    if has_bias:
        def bias_q():
            b = ctx.const_data(2).astype(np.float32)
            return (b * s_in * w_scales / s_out - zp_shift).astype(np.float32)

        B = ctx.get_param("requant_b", bias_q)
        q = acc * M + B
    else:
        q = acc * M
        if zp_shift:
            q = q - float(np.float32(zp_shift))
    if zcorr is not None:
        q = q + zcorr

    if act is not None and act >= 0:
        # clamp thresholds move into the pre-round domain (x/s_out)
        if act == ACT_SILU:
            # silu(v)/s_out = (v/s_out) * sigmoid(v), v = q*s_out
            q = q * torch.sigmoid(q * s_out)
        elif act == 1:
            q = torch.clamp(q, -1.0 / s_out, 1.0 / s_out)
        else:
            q = torch.clamp_min(q, 0.0)
            if act > 0:
                q = torch.clamp_max(q, float(act) / s_out)
    lo, hi = qmath.qrange(out_dtype, out_q)
    store = qmath.TORCH_DTYPES[ctx.out_tensor(0).dtype]
    if relaxed_res:
        # relaxed tier: q is already folded to the FINAL output scale and
        # carries the folded -zp_r*beta constant; add the scaled residual and
        # round ONCE.
        y = q + residual.to(torch.float32) * float(np.float32(beta))
        if p.get("fused_add_relu"):
            y = torch.clamp_min(y, 0.0)
        return nhwc(qmath.clip_cast(qmath.round_away(y) + zp_out, lo, hi, store))
    t_pre = qmath.round_away(q) + zp_out
    if residual is None:
        return nhwc(qmath.clip_cast(t_pre, lo, hi, store))
    t = torch.clamp(t_pre, lo, hi)
    # fused residual: t is the quantized mid tensor; reproduce the unfused
    # eltwise-sum numerics exactly (dequant both, add, requant)
    t_outf = ctx.out_tensor(0)
    s_mid, zp_mid = s_out, zp_out
    t_r = ctx.in_tensor(fused_pos)
    s_r = float(np.asarray(t_r.quant.scales).reshape(-1)[0])
    zp_r = int(np.asarray(t_r.quant.zero_points).reshape(-1)[0])
    s_out2 = float(np.asarray(t_outf.quant.scales).reshape(-1)[0])
    zp_out2 = int(np.asarray(t_outf.quant.zero_points).reshape(-1)[0])
    tf = (t - zp_mid) * s_mid
    rf = (residual.to(torch.float32) - zp_r) * s_r
    y = qmath.round_away((tf + rf) / _f32(tf, s_out2)) + zp_out2
    if p.get("fused_add_relu"):
        y = torch.clamp_min(y, float(zp_out2))
    lo2, hi2 = qmath.qrange(t_outf.dtype, t_outf.quant)
    return nhwc(qmath.clip_cast(y, lo2, hi2, store))


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
        p.get("activation", -1) != ACT_SILU
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
        p.get("activation", -1) != ACT_SILU
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


def _pallas_dw_ok(ctx: LowerCtx) -> bool:
    """The JAX engine's route to dw_qconv_hwcn (TT_DW_PALLAS gate):
    depthwise k in {3,5}, stride 1/2, batch >= 32. The JAX gate also asks
    for 1-byte stored input and output, which the port's storage always is."""
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
    k, s_ = p["kernel_h"], p["stride_h"]
    pads = [p.get(f"pad_{a}", -1) for a in ("h0", "h1", "w0", "w1")]
    pad_ok = (
        all(v >= 0 for v in pads)
        and pads[1] <= max(0, k - s_ - pads[0]) + (s_ - 1)
        and pads[3] <= max(0, k - s_ - pads[2]) + (s_ - 1)
        and pads[0] <= k - 1
        and pads[2] <= k - 1
    )
    return (
        pad_ok
        and p.get("activation", -1) != ACT_SILU
        and p["kernel_h"] == p["kernel_w"]
        and k in (3, 5)
        and p["dilation_h"] == 1
        and p["dilation_w"] == 1
        and p["stride_h"] == p["stride_w"]
        and s_ in (1, 2)
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


register_op("Convolution", score=SCORE_STATIC + 3, predicate=_pallas_dw_ok, quant=True)(
    _unported("dw_qconv_hwcn", "tengine_tpu/ops/pallas/dw_conv.py:243")
)


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
        k=p["kernel_h"], pad=p.get("pad_h0", 0),
        act=p.get("activation", -1), s_out=s_out,
        zp_in=zp_in, zp_out=zp_out, lo=float(lo), hi=float(hi),
    )
    return nhwc(out)


register_op("Convolution", score=SCORE_STATIC + 1, predicate=_pallas_qconv_ok, quant=True)(
    _unported("qconv_direct/qconv1x1", "tengine_tpu/ops/pallas/qconv.py:232,413")
)
register_op("Convolution", score=SCORE_STATIC, predicate=_pallas_conv1x1_ok, quant=True)(
    _unported("qgemm_requant", "tengine_tpu/ops/pallas/qgemm.py:104")
)
register_op(
    "FullyConnected",
    score=SCORE_STATIC,
    predicate=lambda c: _fast_enabled(c)
    and c.options.pallas_qgemm
    and not c.options.quant_bf16_storage
    and not _shifted_s8(c),
    quant=True,
)(_unported("qgemm_requant", "tengine_tpu/ops/pallas/qgemm.py:104"))


@register_op("Convolution", score=SCORE_BEST, predicate=_fast_enabled, quant=True)
def lower_conv_quant_fast(ctx: LowerCtx, x: TArr, *rest: TArr):
    acc, pack = _conv_quant_common(ctx, x)
    fused_pos = ctx.params.get("fused_add_pos")
    residual = as_nhwc(rest[fused_pos - 1]) if fused_pos is not None else None
    return _requant_conv_out(ctx, acc, pack, residual=residual)


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
        lambda a: qmath.dequantize_np(a, t_w.quant, channel_axis=0).astype(np.float32),
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
# Quantized-domain passthrough for value-preserving data-movement ops: when
# every activation in/out shares one (scale, zp) grid they commute with the
# quantization map and run on the raw stored values (bit-equal; the
# quantizer pins these grids equal). Ported so far: Upsample and Concat.
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

    for op, fn in (("Concat", L.lower_concat), ("Upsample", L.lower_upsample)):
        _register_passthrough(op, fn)


_install_passthroughs()
