"""The remaining op lowerings: recurrent nets, ROI ops, region proposals and
the stragglers (PyTorch port of tengine_tpu/ops/lowering_extra.py, all 19
of its registrations), completing the reference's builtin set
(op.h:38-145).

Gate orders follow the reference kernels: LSTM rows [I, O, F, G]
(lstm_ref.c:87-91), GRU ONNX order [z, r, h]. The sequence length is
static, so the recurrence is a Python loop over the steps of plain tensor
ops (lax.scan in the JAX package): it reads nothing back to the host and
captures into a CUDA graph. The ROI ops are vectorized over the ROIs (vmap
in the JAX package). Where the JAX lowering divides by a constant, XLA
multiplies by its f32 reciprocal, and so does the port (`_recip`); a
float -> int cast saturates as XLA's does (lowering.py:_to_int). Host
values (anchors, the sampling grid) are compile-time params.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .detection import _top_k, padded_nms
from .layout import TArr, as_nchw, as_nhwc, as_semantic, like, nchw, nhwc, wrap
from .lowering import _to_int, take
from .registry import LowerCtx, register_op


def _recip(d) -> float:
    """The f32 reciprocal XLA multiplies by where the JAX lowering divides
    by the constant d."""
    return float(np.float32(1.0) / np.float32(d))


def _int32(x: torch.Tensor) -> torch.Tensor:
    """jnp's .astype(int32) of a float or integer tensor."""
    return _to_int(x, torch.int32) if x.is_floating_point() else x.to(torch.int32)


# ---------------------------------------------------------------------------
# recurrent
# ---------------------------------------------------------------------------


def _recurrent_weights(ctx: LowerCtx, gates: int, in_dim: int):
    """W^T [I, gates*H] and R^T [H, gates*H] as f32 compile-time params."""
    H = ctx.params["hidden_size"]
    wt = ctx.weight(1, lambda d: np.asarray(d, np.float32).reshape(gates * H, in_dim).T, "wT")
    rt = ctx.weight(2, lambda d: np.asarray(d, np.float32).reshape(gates * H, H).T, "rT")
    return wt, rt


def _bias_parts(ctx: LowerCtx, size: int):
    """The bias input's W-bias and R-bias, `size` values each, f32 on the
    host (the R-bias None where the input holds only the first); None
    without a bias input."""
    if ctx.num_inputs <= 3:
        return None
    d = np.asarray(ctx.const_data(3), np.float32).reshape(-1)
    return d[:size], (d[size : 2 * size] if d.size >= 2 * size else None)


def _steps(xs: torch.Tensor, wt: torch.Tensor, bias=None):
    """x_t W^T (+ bias) of every step in one product: [T, B, gates*H]."""
    T, B, I = xs.shape
    xw = (xs.reshape(T * B, I).to(torch.float32) @ wt).reshape(T, B, -1)
    return xw if bias is None else xw + bias


@register_op("LSTM")
def lower_lstm(ctx: LowerCtx, x: TArr, *rest: TArr):
    """ONNX-flavor LSTM (lstm_ref.c ref_lstm_* family): input [T, B, I],
    W [4H, I] rows ordered I,O,F,G; R [4H, H]; optional bias [8H] (W-bias
    then R-bias, summed; a 4H bias is the W-bias alone). Emits all
    timesteps [T, 1, B, H] (lstm_ref.c:744-768)."""
    H = ctx.params["hidden_size"]
    xs = as_semantic(x)
    T, B, I = xs.shape
    wt, rt = _recurrent_weights(ctx, 4, I)
    parts = _bias_parts(ctx, 4 * H)
    bias = None if parts is None else ctx.get_param(
        "bias", lambda: parts[0] + (np.float32(0.0) if parts[1] is None else parts[1]))
    xw = _steps(xs, wt)
    h = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(T):
        gates = xw[t] + h @ rt
        if bias is not None:
            gates = gates + bias
        i_g = torch.sigmoid(gates[:, 0 * H : 1 * H])
        o_g = torch.sigmoid(gates[:, 1 * H : 2 * H])
        f_g = torch.sigmoid(gates[:, 2 * H : 3 * H])
        g_g = torch.tanh(gates[:, 3 * H : 4 * H])
        c = f_g * c + i_g * g_g
        h = o_g * torch.tanh(c)
        hs.append(h)
    return wrap(torch.stack(hs)[:, None])  # [T, 1, B, H]


@register_op("RNN")
def lower_rnn(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Vanilla RNN (rnn_ref.c): h' = tanh(x W^T + h R^T + b), b the first H
    values of the bias input."""
    H = ctx.params["hidden_size"]
    xs = as_semantic(x)
    T, B, I = xs.shape
    wt, rt = _recurrent_weights(ctx, 1, I)
    parts = _bias_parts(ctx, H)
    bias = (torch.zeros(H, dtype=torch.float32, device=xs.device) if parts is None
            else ctx.get_param("bias", lambda: parts[0]))
    xw = _steps(xs, wt)
    h = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
    hs = []
    for t in range(T):
        h = torch.tanh(xw[t] + h @ rt + bias)
        hs.append(h)
    return wrap(torch.stack(hs)[:, None])


@register_op("GRU")
def lower_gru(ctx: LowerCtx, x: TArr, *rest: TArr):
    """GRU (gru_ref.c, ONNX gate order z,r,h):
    z = sigma(xWz + hRz), r = sigma(xWr + hRr),
    h~ = tanh(xWh + r*(hRh)), h' = (1-z)h~ + z h; bias [6H] (W-bias then
    R-bias; a 3H bias is the W-bias alone)."""
    H = ctx.params["hidden_size"]
    xs = as_semantic(x)
    T, B, I = xs.shape
    wt, rt = _recurrent_weights(ctx, 3, I)
    parts = _bias_parts(ctx, 3 * H)
    zero = torch.zeros(3 * H, dtype=torch.float32, device=xs.device)
    bw = zero if parts is None else ctx.get_param("bias_w", lambda: parts[0])
    br = zero if parts is None or parts[1] is None else ctx.get_param("bias_r", lambda: parts[1])
    gxs = _steps(xs, wt, bw)
    h = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
    hs = []
    for t in range(T):
        gx = gxs[t]
        gh = h @ rt + br
        z = torch.sigmoid(gx[:, :H] + gh[:, :H])
        r = torch.sigmoid(gx[:, H : 2 * H] + gh[:, H : 2 * H])
        hh = torch.tanh(gx[:, 2 * H :] + r * gh[:, 2 * H :])
        h = (1.0 - z) * hh + z * h
        hs.append(h)
    return wrap(torch.stack(hs)[:, None])


# ---------------------------------------------------------------------------
# ROI family
# ---------------------------------------------------------------------------


def _rois(ctx: LowerCtx, x: TArr, rois: TArr):
    """Image 0 of the feature map [C, H, W] (the reference reads one image)
    and the ROIs [R, 4] scaled by spatial_scale, in f32."""
    scale = ctx.params["spatial_scale"]
    return as_nchw(x)[0], as_semantic(rois).reshape(-1, 4) * scale


def _bin_max(feat: torch.Tensor, hmask: torch.Tensor, wmask: torch.Tensor) -> torch.Tensor:
    """The max of feat [C, H, W] over each bin hmask [R, ph, H] x wmask
    [R, pw, W], -inf where a bin is empty: [R, C, ph, pw]. Over W, then
    over H (max is exact, so the order is the JAX lowering's joint max)."""
    by_w = torch.where(wmask[:, None, None], feat[None, :, :, None, :], -math.inf).amax(-1)
    return torch.where(hmask[:, None, :, :, None], by_w[:, :, None], -math.inf).amax(3)


@register_op("ROIPooling")
def lower_roipooling(ctx: LowerCtx, x: TArr, rois: TArr):
    """Max ROI pooling (roipooling_ref.c): rois [R, 4] in image coords
    scaled by spatial_scale; output [R, C, ph, pw]. Corners rounded half to
    even (jnp.round, as torch.round) and cast saturating."""
    p = ctx.params
    ph, pw = p["pooled_h"], p["pooled_w"]
    feat, r = _rois(ctx, x, rois)
    C, H, W = feat.shape
    x0, y0, x1, y1 = (_to_int(torch.round(v), torch.int32) for v in r.unbind(1))
    rw = torch.clamp_min(x1 - x0 + 1, 1)
    rh = torch.clamp_min(y1 - y0 + 1, 1)
    bin_h = rh.to(torch.float32) * _recip(ph)
    bin_w = rw.to(torch.float32) * _recip(pw)
    dev = feat.device
    ys = torch.arange(ph, device=dev)
    xs = torch.arange(pw, device=dev)

    def edges(o, steps, bin_, size):
        lo = o[:, None] + _to_int(torch.floor(steps * bin_[:, None]), torch.int32)
        hi = o[:, None] + _to_int(torch.ceil((steps + 1) * bin_[:, None]), torch.int32)
        return torch.clamp(lo, 0, size - 1), torch.clamp(hi, 0, size)

    h0, h1 = edges(y0, ys, bin_h, H)
    w0, w1 = edges(x0, xs, bin_w, W)
    hh = torch.arange(H, device=dev)
    ww = torch.arange(W, device=dev)
    hmask = (hh >= h0[..., None]) & (hh < h1[..., None])  # [R, ph, H]
    wmask = (ww >= w0[..., None]) & (ww < w1[..., None])  # [R, pw, W]
    return wrap(_bin_max(feat, hmask, wmask))


@register_op("Roialign")
def lower_roialign(ctx: LowerCtx, x: TArr, rois: TArr):
    """ROI align with bilinear sampling (one sample per bin center, the
    reference's simplified kernel)."""
    p = ctx.params
    ph, pw = p["pooled_height"], p["pooled_width"]
    feat, r = _rois(ctx, x, rois)
    C, H, W = feat.shape
    x0, y0, x1, y1 = r.unbind(1)
    rw = torch.clamp_min(x1 - x0, 1.0)
    rh = torch.clamp_min(y1 - y0, 1.0)
    dev = feat.device
    half_y = torch.arange(ph, device=dev) + 0.5
    half_x = torch.arange(pw, device=dev) + 0.5
    ys = y0[:, None] + half_y * rh[:, None] * _recip(ph)  # [R, ph]
    xs = x0[:, None] + half_x * rw[:, None] * _recip(pw)
    yy = torch.clamp(ys[:, :, None].expand(-1, ph, pw), 0, H - 1)
    xx = torch.clamp(xs[:, None, :].expand(-1, ph, pw), 0, W - 1)
    yf = _to_int(torch.floor(yy), torch.int32)
    xf = _to_int(torch.floor(xx), torch.int32)
    yc = torch.clamp_max(yf + 1, H - 1)
    xc = torch.clamp_max(xf + 1, W - 1)
    wy = yy - yf
    wx = xx - xf
    yf, xf, yc, xc = (t.long() for t in (yf, xf, yc, xc))
    out = (
        feat[:, yf, xf] * (1 - wy) * (1 - wx)
        + feat[:, yf, xc] * (1 - wy) * wx
        + feat[:, yc, xf] * wy * (1 - wx)
        + feat[:, yc, xc] * wy * wx
    )  # [C, R, ph, pw]
    return wrap(out.permute(1, 0, 2, 3))


@register_op("Psroipooling")
def lower_psroipooling(ctx: LowerCtx, x: TArr, rois: TArr):
    """Position-sensitive ROI pooling (psroipooling ref): input
    [1, output_dim*ph*pw, H, W] -> [R, output_dim, ph, pw], the average of
    each bin over its own channel group (a true division by the bin's
    element count, which depends on the ROI)."""
    p = ctx.params
    ph, pw = p["pooled_h"], p["pooled_w"]
    od = p["output_dim"]
    feat, r = _rois(ctx, x, rois)
    C, H, W = feat.shape
    x0, y0, x1, y1 = r.unbind(1)
    bin_h = torch.clamp_min(y1 - y0, 0.1) * _recip(ph)
    bin_w = torch.clamp_min(x1 - x0, 0.1) * _recip(pw)
    dev = feat.device

    def mask(o, n, bin_, size):
        steps = torch.arange(n, device=dev)
        lo = _to_int(torch.floor(o[:, None] + steps * bin_[:, None]), torch.int32)
        hi = _to_int(torch.ceil(o[:, None] + (steps + 1) * bin_[:, None]), torch.int32)
        at = torch.arange(size, device=dev)
        return ((at >= torch.clamp(lo, 0, size)[..., None])
                & (at < torch.clamp(hi, 0, size)[..., None]))

    hmask, wmask = mask(y0, ph, bin_h, H), mask(x0, pw, bin_w, W)
    m = (hmask[:, :, None, :, None] & wmask[:, None, :, None, :]).to(torch.float32)
    cnt = torch.clamp_min(m.sum((3, 4)), 1.0)  # [R, ph, pw]
    sums = torch.einsum("dijhw,rijhw->rdij", feat.reshape(od, ph, pw, H, W), m)
    return wrap(sums / cnt[:, None])


def rpn_anchors(p: dict) -> np.ndarray:
    """The base anchors [A, 4]: the param's, or generated from ratios and
    scales as the reference's prerun does."""
    anchors = np.asarray(p["anchors"], np.float32)
    if anchors.size:
        return anchors.reshape(-1, 4)
    base = float(p.get("basesize", 16))
    gen = []
    for r_ in p.get("ratios") or [0.5, 1.0, 2.0]:
        ws = math.sqrt(base * base / r_)
        hs = ws * r_
        for s in p.get("anchor_scales") or [8.0, 16.0, 32.0]:
            w2, h2 = ws * s / 2.0, hs * s / 2.0
            c = (base - 1) / 2.0
            gen.append([c - w2, c - h2, c + w2, c + h2])
    return np.asarray(gen, np.float32)


def _anchor_geometry(p: dict, H: int, W: int) -> np.ndarray:
    """Width, height and center of every shifted anchor, [4, A, H, W] f32:
    what the JAX lowering computes from its constants (XLA folds them in
    f32)."""
    anchors = rpn_anchors(p)
    stride = p["feat_stride"]
    f32 = np.float32
    sx = (np.arange(W) * stride).astype(f32) if isinstance(stride, int) else (
        np.arange(W, dtype=f32) * f32(stride))
    sy = (np.arange(H) * stride).astype(f32) if isinstance(stride, int) else (
        np.arange(H, dtype=f32) * f32(stride))
    sy, sx = np.meshgrid(sy, sx, indexing="ij")
    anc = anchors[:, None, None, :] + np.stack([sx, sy, sx, sy], axis=-1)[None]
    aw = anc[..., 2] - anc[..., 0] + f32(1)
    ah = anc[..., 3] - anc[..., 1] + f32(1)
    return np.stack([aw, ah, anc[..., 0] + aw * f32(0.5), anc[..., 1] + ah * f32(0.5)])


@register_op("RPN")
def lower_rpn(ctx: LowerCtx, score: TArr, bbox_delta: TArr, im_info: TArr, *rest: TArr):
    """Region proposal network postprocess (rpn_ref.c): decode anchor
    deltas, clip to the image (im_info, a device tensor), take per_nms_topn
    by foreground score, greedy NMS, emit post_nms_topn proposals [N, 4]
    padded with zeros (fixed size; the reference's count is dynamic). The
    anchors are a compile-time param."""
    p = ctx.params
    sc = as_nchw(score)[0]  # [2A, H, W]
    bd = as_nchw(bbox_delta)[0]  # [4A, H, W]
    _, H, W = sc.shape
    geo = ctx.get_param("anchor_geometry", lambda: _anchor_geometry(p, H, W))
    aw, ah, acx, acy = geo.unbind(0)
    A = aw.shape[0]
    deltas = bd.reshape(A, 4, H, W)
    cx = deltas[:, 0] * aw + acx
    cy = deltas[:, 1] * ah + acy
    w2 = torch.exp(deltas[:, 2]) * aw
    h2 = torch.exp(deltas[:, 3]) * ah
    boxes = torch.stack([cx - w2 * 0.5, cy - h2 * 0.5, cx + w2 * 0.5, cy + h2 * 0.5],
                        dim=-1).reshape(-1, 4)
    scores = sc[A:].reshape(-1)

    im = as_semantic(im_info).reshape(-1)
    im_h, im_w = im[0], im[1]
    lim = torch.stack([im_w, im_h, im_w, im_h]) - 1
    boxes = torch.minimum(torch.clamp_min(boxes, 0), lim)
    min_size = p.get("min_size", 16)
    keep_size = ((boxes[:, 2] - boxes[:, 0] + 1) >= min_size) & (
        (boxes[:, 3] - boxes[:, 1] + 1) >= min_size)
    scores = torch.where(keep_size, scores, -math.inf)

    top = min(p.get("per_nms_topn", 6000), scores.shape[0])
    keep, order = padded_nms(boxes, scores, p.get("nms_thresh", 0.7), top)
    ranks = torch.arange(top, device=boxes.device)
    sel = torch.sort(torch.where(keep, ranks, top))[0][: p.get("post_nms_topn", 300)]
    picked = boxes[order[torch.clamp_max(sel, top - 1)]]
    return wrap(torch.where((sel < top)[:, None], picked, 0.0))


# ---------------------------------------------------------------------------
# misc stragglers
# ---------------------------------------------------------------------------


@register_op("SpaceToBatchND")
def lower_space_to_batch(ctx: LowerCtx, x: TArr):
    p = ctx.params
    bh, bw = p["dilation_y"], p["dilation_x"]
    xp = F.pad(as_nhwc(x), (0, 0, p["pad_left"], p["pad_right"], p["pad_top"], p["pad_bottom"]))
    n, hp, wp, c = xp.shape
    out = (
        xp.reshape(n, hp // bh, bh, wp // bw, bw, c)
        .permute(2, 4, 0, 1, 3, 5)
        .reshape(n * bh * bw, hp // bh, wp // bw, c)
    )
    return nhwc(out)


@register_op("BatchToSpaceND")
def lower_batch_to_space(ctx: LowerCtx, x: TArr):
    p = ctx.params
    xn = as_nhwc(x)
    bh, bw = p["dilation_y"], p["dilation_x"]
    nb, h, w, c = xn.shape
    n = nb // (bh * bw)
    out = (
        xn.reshape(bh, bw, n, h, w, c)
        .permute(2, 3, 0, 4, 1, 5)
        .reshape(n, h * bh, w * bw, c)
    )
    return nhwc(out[:, p["crop_top"] : out.shape[1] - p["crop_bottom"],
                    p["crop_left"] : out.shape[2] - p["crop_right"], :])


@register_op("L2Pool")
def lower_l2pool(ctx: LowerCtx, x: TArr):
    """sqrt(avg(x^2)) pooling (l2pool ref), VALID windows. Each window's
    squares are summed in row-major order in f32, as XLA's reduce_window
    sums them, on every device; the division by kh*kw is XLA's reciprocal
    multiply; the square root is taken in float64 and rounded, which is
    the correctly rounded f32 root (torch's f32 sqrt on the CPU is not)."""
    p = ctx.params
    kh, kw = p["kernel_h"], p["kernel_w"]
    sh, sw = p["stride_h"], p["stride_w"]
    sq = torch.square(as_nhwc(x).to(torch.float32))
    n, h, w, c = sq.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    sums = None
    for i in range(kh):
        for j in range(kw):
            tap = sq[:, i : i + sh * (oh - 1) + 1 : sh, j : j + sw * (ow - 1) + 1 : sw]
            sums = tap if sums is None else sums + tap
    return nhwc(torch.sqrt((sums * _recip(kh * kw)).double()).to(torch.float32))


def _per_channel(x: TArr, v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over a 4-D activation."""
    shape = [1] * x.x.ndim
    shape[3 if x.layout == "NHWC" else 1] = v.shape[0]
    return v.reshape(shape)


@register_op("Bias")
def lower_bias(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Add per-channel bias vector (bias ref)."""
    b = ctx.weight(1)
    return like(x, x.x + (_per_channel(x, b) if x.x.ndim == 4 else b))


@register_op("Embedding")
def lower_embedding(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Embedding lookup (embedding ref): indices -> rows of the weight, as
    jnp.take reads them (lowering.py:take: a negative index wraps once, an
    out-of-range one gives a row of NaN)."""
    idx = _int32(as_semantic(x)).reshape(-1)
    out = take(ctx.weight(1), idx, 0)
    if ctx.num_inputs > 2:
        out = out + ctx.weight(2)
    return wrap(out)


def _scatter_slots(idx: torch.Tensor, n: int):
    """Indices as jnp's scatter reads them: a negative one wraps once, and
    whether each is then in [0, n) (one that is not is dropped)."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


@register_op("Scatter")
def lower_scatter(ctx: LowerCtx, x: TArr, indices: TArr, updates: TArr):
    """ONNX ScatterElements along `axis` (jnp's .at[].set: negative
    indices wrap once, out-of-range ones are dropped). An update that is
    dropped lands in one padding slot past the axis's end, cut off after.
    Duplicate indices: which update wins is unspecified in both engines
    (ROADMAP §3)."""
    axis = ctx.params.get("axis", 0)
    xs = as_semantic(x)
    n = xs.shape[axis]
    idx, ok = _scatter_slots(_int32(as_semantic(indices)), n)
    upd = torch.broadcast_to(as_semantic(updates).to(xs.dtype), idx.shape)
    pad = [0, 0] * (xs.ndim - 1 - axis) + [0, 1]
    out = F.pad(xs, pad).scatter(axis, torch.where(ok, idx, n).long(), upd)
    return wrap(out.narrow(axis, 0, n))


@register_op("SparseToDense")
def lower_sparse_to_dense(ctx: LowerCtx, indices: TArr, output_shape: TArr, values: TArr, *rest):
    """A dense f32 tensor of default_value with values set at indices (jnp's
    .at[].set: negative indices wrap once per axis, an update with any
    out-of-range index is dropped)."""
    p = ctx.params
    shape = (p["output_shape_size0"],) + (
        (p["output_shape_size1"],) if p.get("output_shape_size1", 0) > 0 else ())
    idx = _int32(as_semantic(indices))
    cols = idx.reshape(-1, 1) if len(shape) == 1 else idx
    flat = torch.zeros(cols.shape[0], dtype=torch.int64, device=idx.device)
    ok = torch.ones(cols.shape[0], dtype=torch.bool, device=idx.device)
    for d, size in enumerate(shape):
        i, ok_d = _scatter_slots(cols[:, d], size)
        flat = flat * size + i
        ok = ok & ok_d
    total = int(np.prod(shape))
    vals = torch.broadcast_to(as_semantic(values).to(torch.float32).reshape(-1), flat.shape)
    dense = torch.full((total + 1,), float(p.get("default_value", 0)), dtype=torch.float32,
                       device=idx.device)
    dense = dense.scatter(0, torch.where(ok, flat, total), vals)
    return wrap(dense[:total].reshape(shape))


@register_op("DetectionPostProcess")
def lower_detection_postprocess(ctx: LowerCtx, boxes: TArr, scores: TArr, anchors: TArr):
    """TFLite-style SSD postprocess (detection_postprocess ref): decode
    center-size deltas against anchors with the 4 scale factors, NMS per
    class (all classes in one batched padded_nms), the max_detections best
    rows [1, max_detections, 6] (label, score, box; pad rows -1)."""
    p = ctx.params
    max_det = p["max_detections"]
    sc = p.get("scales") or [10.0, 10.0, 5.0, 5.0]

    bx = as_semantic(boxes).reshape(-1, 4)  # [P, 4] (cy, cx, h, w deltas)
    st = as_semantic(scores).reshape(bx.shape[0], -1)
    an = as_semantic(anchors).reshape(-1, 4)  # [P, 4] (cy, cx, h, w)

    ycenter = bx[:, 0] * _recip(sc[0]) * an[:, 2] + an[:, 0]
    xcenter = bx[:, 1] * _recip(sc[1]) * an[:, 3] + an[:, 1]
    hh = torch.exp(bx[:, 2] * _recip(sc[2])) * an[:, 2]
    ww = torch.exp(bx[:, 3] * _recip(sc[3])) * an[:, 3]
    decoded = torch.stack(
        [xcenter - ww * 0.5, ycenter - hh * 0.5, xcenter + ww * 0.5, ycenter + hh * 0.5], dim=1)

    score_th = p.get("nms_score_threshold", 0.0)
    k = min(max_det * 4, bx.shape[0])
    ncls = min(p["num_classes"], st.shape[1])
    s_all = st[:, :ncls].T  # [classes, P]
    s = torch.where(s_all >= score_th, s_all, 0.0)
    keep, order = padded_nms(decoded.expand(ncls, -1, -1), s, p.get("nms_iou_threshold", 0.5), k)
    sc_ = torch.gather(s_all, 1, order)  # [classes, k]
    valid = keep & (sc_ >= score_th)
    labels = torch.arange(ncls, dtype=torch.float32, device=bx.device)[:, None, None]
    rows = torch.cat([labels.expand(ncls, k, 1), sc_[..., None], decoded[order]], dim=-1)
    flat = torch.where(valid[..., None], rows, -1.0).reshape(-1, 6)
    svals = torch.where(flat[:, 0] >= 0, flat[:, 1], -1.0)
    top, idx = _top_k(svals, min(max_det, flat.shape[0]))
    return wrap(torch.where((top > 0)[:, None], flat[idx], -1.0)[None])


def _affine_grid(th: int, tw: int) -> np.ndarray:
    """[x; y; 1] of every target pixel, [3, th*tw] f32, on jnp.linspace(-1,
    1, n)'s values as the JAX lowering's compiled forward computes them:
    start * (1 - step) + stop * step with step = iota times the f32
    reciprocal of n - 1, the last value the stop itself."""
    f32 = np.float32

    def linspace(n):
        if n == 1:
            return np.array([-1.0], f32)
        step = np.arange(n - 1, dtype=f32) * f32(f32(1.0) / f32(n - 1))
        return np.append(f32(-1.0) * (f32(1.0) - step) + f32(1.0) * step, f32(1.0)).astype(f32)

    gy, gx = np.meshgrid(linspace(th), linspace(tw), indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1), np.ones(th * tw, f32)])


@register_op("SpatialTransformer")
def lower_spatial_transformer(ctx: LowerCtx, x: TArr, theta: TArr):
    """Affine spatial transformer (spatialtransformer ref): 2x3 theta,
    bilinear sampling onto target_shape. The grid is a compile-time
    param."""
    th, tw = (ctx.params.get("target_shape") or [0, 0])[:2]
    xn = as_nchw(x)
    n, c, h, w = xn.shape
    if th <= 0:
        th, tw = h, w
    grid = ctx.get_param("grid", lambda: _affine_grid(th, tw))
    src = as_semantic(theta).reshape(n, 2, 3).to(torch.float32) @ grid  # [n, 2, thw]
    sx = (src[:, 0] + 1.0) * (w - 1) * 0.5
    sy = (src[:, 1] + 1.0) * (h - 1) * 0.5
    x0 = torch.clamp(_to_int(torch.floor(sx), torch.int32), 0, w - 1)
    y0 = torch.clamp(_to_int(torch.floor(sy), torch.int32), 0, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    wx = sx - x0
    wy = sy - y0
    flat = xn.reshape(n, c, h * w)

    def at(yi, xi):
        return torch.gather(flat, 2, (yi * w + xi).long()[:, None].expand(n, c, -1))

    wx, wy = wx[:, None], wy[:, None]
    v = (
        at(y0, x0) * (1 - wy) * (1 - wx)
        + at(y0, x1) * (1 - wy) * wx
        + at(y1, x0) * wy * (1 - wx)
        + at(y1, x1) * wy * wx
    )
    return nchw(v.reshape(n, c, th, tw))


@register_op("FusedBNScaleReLu")
def lower_fused_bn_scale_relu(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Fused BN+Scale+ReLU (op 39): folded per-channel scale/shift then
    relu; consts are [scale, shift] vectors."""
    out = x.x * _per_channel(x, ctx.weight(1))
    if ctx.num_inputs > 2:
        out = out + _per_channel(x, ctx.weight(2))
    return like(x, torch.clamp_min(out, 0.0))


@register_op("Accuracy")
def lower_accuracy(ctx: LowerCtx, x: TArr, *rest: TArr):
    """Training-time op; identity at inference (reference has no kernel)."""
    return x


@register_op("Generic")
def lower_generic(ctx: LowerCtx, *args):
    raise NotImplementedError(
        f"Generic op {ctx.params.get('op_name')!r} requires a custom kernel; "
        "register one with tengine_tpu_torch.register_custom_op"
    )
