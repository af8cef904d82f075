"""Detection ops: PriorBox, DetectionOutput, Region (PyTorch port of
tengine_tpu/ops/detection.py).

The reference runs these as ordinary CPU nodes with data-dependent output
shapes (detection_output_ref.c). A data-dependent shape cannot be captured
into a CUDA graph, so the design is the JAX package's:
  * PriorBox — a pure function of static shapes/params: computed on the
    host at prepare time (priorbox_ref.c numerics, including its flip
    branch) and held as a compile-time param at the compiled input size.
  * DetectionOutput — decode + class-wise greedy NMS entirely on the device
    with *fixed-size padded* outputs [N, keep_top_k, 6]; invalid rows are
    -1. The greedy loop runs a fixed number of steps and never reads a
    value back to the host.

One departure from the JAX lowering, which is at fault at batch > 1: it
flattens the batch's priors and locations into one set
(tengine_tpu/ops/detection.py:104-106 with :171), so image 0's priors read
image 1's variances as boxes and every image's boxes go into one NMS. Here
each image is decoded and suppressed on its own: at batch N, image i's rows
are the JAX engine's rows at batch 1 on image i.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .layout import TArr, as_semantic, nchw, wrap
from .registry import LowerCtx, register_op


def compute_priorbox(
    feat_h: int,
    feat_w: int,
    data_h: int,
    data_w: int,
    p: dict,
) -> np.ndarray:
    """Numpy replication of priorbox_ref.c:93-175. Returns [2, out_dim]:
    row 0 = boxes (xmin,ymin,xmax,ymax normalized), row 1 = variances.

    Note: for flipped aspect ratios the reference normalizes x by image_h and
    y by image_w (priorbox_ref.c:142-148); we replicate that faithfully —
    SSD models use square inputs where it is equivalent.
    """
    image_h = p["img_h"] or data_h
    image_w = p["img_w"] or data_w
    step_w = p["step_w"] or float(image_w) / feat_w
    step_h = p["step_h"] or float(image_h) / feat_h
    offset = p["offset"]
    min_sizes = p["min_sizes"]
    max_sizes = p["max_sizes"]
    ars = p["aspect_ratios"]
    flip = p["flip"]

    boxes = []
    for h in range(feat_h):
        for w in range(feat_w):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            for s, mn in enumerate(min_sizes):
                mn = int(mn)
                bw = bh = mn
                boxes.append(
                    [(cx - bw * 0.5) / image_w, (cy - bh * 0.5) / image_h,
                     (cx + bw * 0.5) / image_w, (cy + bh * 0.5) / image_h]
                )
                if max_sizes:
                    mx = int(max_sizes[s])
                    bw = bh = math.sqrt(mn * mx)
                    boxes.append(
                        [(cx - bw * 0.5) / image_w, (cy - bh * 0.5) / image_h,
                         (cx + bw * 0.5) / image_w, (cy + bh * 0.5) / image_h]
                    )
                for ar in ars:
                    bw = mn * math.sqrt(ar)
                    bh = mn / math.sqrt(ar)
                    boxes.append(
                        [(cx - bw * 0.5) / image_w, (cy - bh * 0.5) / image_h,
                         (cx + bw * 0.5) / image_w, (cy + bh * 0.5) / image_h]
                    )
                    if flip:
                        boxes.append(
                            [(cx - bh * 0.5) / image_h, (cy - bw * 0.5) / image_w,
                             (cx + bh * 0.5) / image_h, (cy + bw * 0.5) / image_w]
                        )
    flat = np.asarray(boxes, np.float32).reshape(-1)
    if p["clip"]:
        flat = np.clip(flat, 0.0, 1.0)
    var = np.tile(np.asarray(p["variances"], np.float32), flat.size // 4)
    return np.stack([flat, var])


@register_op("PriorBox")
def lower_priorbox(ctx: LowerCtx, featmap: TArr, data: TArr):
    """The priors as a compile-time param at the compiled sizes, expanded
    over the batch without a copy; output [N, 2, out_dim, 1] (priorbox.c
    infer_shape)."""
    fshape = as_semantic(featmap).shape
    dshape = as_semantic(data).shape
    p = dict(ctx.params)
    priors = ctx.get_param(
        "priors",
        lambda: compute_priorbox(int(fshape[2]), int(fshape[3]), int(dshape[2]), int(dshape[3]), p),
    )
    n = int(dshape[0])
    return wrap(priors[None, :, :, None].expand(n, -1, -1, -1))


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., K, 4] xmin,ymin,xmax,ymax boxes: [..., K, K].
    A true division where the union is positive, as in the JAX lowering."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    area = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
    ix0 = torch.maximum(x0[..., :, None], x0[..., None, :])
    iy0 = torch.maximum(y0[..., :, None], y0[..., None, :])
    ix1 = torch.minimum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.minimum(y1[..., :, None], y1[..., None, :])
    inter = torch.clamp_min(ix1 - ix0, 0) * torch.clamp_min(iy1 - iy0, 0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis (float32) and their indices in
    lax.top_k's order: its total order (NaN above +inf, +0.0 above -0.0,
    -NaN last), the lower index first among equal values. torch.topk
    promises no order among ties and torch.sort takes -0.0 and +0.0 as
    equal, so this is a stable descending sort of the floats' bits mapped
    to that order, sliced."""
    bits = scores.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    order = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(scores, -1, order), order


def padded_nms(
    boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, top_k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a fixed top_k candidate set, batched over the leading
    axes: boxes [..., P, 4], scores [..., P].

    Returns (keep_mask [..., k] bool, order [..., k] indices into P), k =
    min(top_k, P). The classic sequential-greedy algorithm (reference:
    nms_sorted_bboxes in detection_output_ref.c) as k fixed steps over the
    score-sorted candidates: candidate i survives if no kept candidate
    ranked above it overlaps it by more than iou_threshold. No step reads a
    value back to the host, so the loop captures into a CUDA graph."""
    k = min(top_k, scores.shape[-1])
    top_scores, order = _top_k(scores, k)
    cand = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    iou = _iou_matrix(cand)
    keep = top_scores > -math.inf
    above = torch.ones(k, k, dtype=torch.bool, device=scores.device).tril(-1)  # j < i
    zero = torch.zeros((), dtype=iou.dtype, device=iou.device)
    for i in range(k):
        overlap = torch.where(above[i] & keep, iou[..., i, :], zero)
        ok = overlap.amax(-1) <= iou_threshold
        keep[..., i] &= ok
    return keep, order


@register_op("DetectionOutput")
def lower_detection_output(ctx: LowerCtx, loc: TArr, conf: TArr, priors: TArr):
    """SSD DetectionOutput (detection_output_ref.c): decode center-size
    offsets with per-prior variances, per-class NMS (skipping background
    class 0), keep the global top keep_top_k, each image on its own. Output
    padded [N, keep_top_k, 6], rows = [label, score, x0, y0, x1, y1]; pad
    rows are -1."""
    p = ctx.params
    num_classes = p["num_classes"]
    keep_top_k = p["keep_top_k"]
    conf_th = p["confidence_threshold"]

    loc_s = as_semantic(loc)
    n = loc_s.shape[0]
    locx = loc_s.reshape(n, -1, 4)  # [N, P, 4]
    pr = as_semantic(priors).reshape(n, 2, -1)
    num_prior = pr.shape[2] // 4
    confx = as_semantic(conf).reshape(n, num_prior, num_classes)
    pbox = pr[:, 0].reshape(n, num_prior, 4)
    pvar = pr[:, 1].reshape(n, num_prior, 4)

    # decode (detection_output_ref.c get_boxes)
    pw = pbox[..., 2] - pbox[..., 0]
    ph = pbox[..., 3] - pbox[..., 1]
    pcx = (pbox[..., 0] + pbox[..., 2]) * 0.5
    pcy = (pbox[..., 1] + pbox[..., 3]) * 0.5
    bcx = pvar[..., 0] * locx[..., 0] * pw + pcx
    bcy = pvar[..., 1] * locx[..., 1] * ph + pcy
    bw = pw * torch.exp(pvar[..., 2] * locx[..., 2])
    bh = ph * torch.exp(pvar[..., 3] * locx[..., 3])
    boxes = torch.stack(
        [bcx - bw * 0.5, bcy - bh * 0.5, bcx + bw * 0.5, bcy + bh * 0.5], dim=-1
    )  # [N, P, 4]

    # every foreground class of every image at once: [N, C-1, ...]
    k = min(p["nms_top_k"], num_prior)
    conf_c = confx[..., 1:].transpose(1, 2)  # [N, C-1, P]
    scores = torch.where(conf_c >= conf_th, conf_c, torch.zeros_like(conf_c))
    boxes_c = boxes[:, None].expand(-1, num_classes - 1, -1, -1)
    keep, order = padded_nms(boxes_c, scores, p["nms_threshold"], k)
    sc = torch.gather(conf_c, -1, order)
    valid = keep & (sc >= conf_th)
    labels = torch.arange(1, num_classes, dtype=torch.float32, device=sc.device)
    rows = torch.cat(
        [
            labels[None, :, None, None].expand(n, -1, k, 1),
            sc[..., None],
            torch.gather(boxes_c, -2, order[..., None].expand(-1, -1, -1, 4)),
        ],
        dim=-1,
    )  # [N, C-1, k, 6]
    rows = torch.where(valid[..., None], rows, torch.full_like(rows, -1.0))

    flat = rows.reshape(n, -1, 6)
    scores_all = torch.where(flat[..., 0] >= 0, flat[..., 1], torch.full_like(flat[..., 1], -1.0))
    top, idx = _top_k(scores_all, min(keep_top_k, flat.shape[1]))
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, 6))
    out = torch.where((top > 0)[..., None], out, torch.full_like(out, -1.0))
    return wrap(out)


@register_op("Region")
def lower_region(ctx: LowerCtx, x: TArr):
    """YOLOv2 Region (region_ref.c): apply logistic to box xy/objectness and
    softmax over classes, per anchor; raw grid output (no NMS — the
    reference leaves thresholding to the app)."""
    p = ctx.params
    num_box = p["num_box"]
    num_classes = p["num_classes"]
    coords = p.get("coords", 4)
    xs = as_semantic(x)
    n, c, h, w = xs.shape
    per = coords + 1 + num_classes
    xr = xs.reshape(n, num_box, per, h, w)
    xy = torch.sigmoid(xr[:, :, 0:2])
    wh = xr[:, :, 2:coords]
    obj = torch.sigmoid(xr[:, :, coords : coords + 1])
    cls = torch.softmax(xr[:, :, coords + 1 :], dim=2)
    out = torch.cat([xy, wh, obj, cls], dim=2).reshape(n, c, h, w)
    return nchw(out)
