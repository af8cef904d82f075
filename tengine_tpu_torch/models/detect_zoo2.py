"""Model families from the reference's examples zoo, batch 4
(examples/tm_yolox.cpp, tm_scrfd.cpp, tm_movenet.cpp): anchor-free
decoupled-head detection, face detection with keypoints, and center-based
single-person pose.

Clean-room torch modules mirroring each family's published architecture
shape (not ports), imported through the torch front-end like detect_zoo.py.
Together they exercise: SiLU CSP backbones with decoupled heads (yolox),
shared multi-level heads with per-level strides + keypoint regression
(scrfd), and center+offset heatmap decoding at stride 4 (movenet).
Weights are seeded random — the reference benchmarks weight-stripped nets
the same way (tm2_serializer.c:241-246).

PyTorch port: a copy of tengine_tpu/models/detect_zoo2.py, built through
the port's torch front-end and optimize pipeline, so that after one
torch.manual_seed both packages build the same IR."""

from __future__ import annotations

import numpy as np

__all__ = [
    "YOLOXLite",
    "SCRFDLite",
    "MoveNetLite",
    "build_yolox_graph",
    "build_scrfd_graph",
    "build_movenet_graph",
    "decode_yolox",
    "decode_scrfd",
    "decode_movenet",
    "scrfd_anchor_centers",
]


def _torch():
    import torch
    import torch.nn as nn

    return torch, nn


# ---------------------------------------------------------------------------
# YOLOX: CSPDarknet backbone (SiLU) + PAFPN + DECOUPLED head — separate
# cls / reg(+obj) conv branches per level, anchor-free grid decode
# (tm_yolox.cpp:40-120 decodes [reg4 | obj1 | clsC] maps at strides
# 8/16/32). The Focus stem is folded into an equivalent 6x6/s2 conv at
# build time, exactly like models/yolov5.py (fuse_focus pass rationale).
# ---------------------------------------------------------------------------


def YOLOXLite(num_classes: int = 80, width: int = 32):
    torch, nn = _torch()

    def cbs(ci, co, k=3, s=1):
        # (k-1)//2 keeps odd kernels 'same' and makes the 6x6/s2 stem an
        # exact halving (pad 2), matching the Focus fold in models/yolov5.py
        return nn.Sequential(
            nn.Conv2d(ci, co, k, s, (k - 1) // 2, bias=False),
            nn.BatchNorm2d(co),
            nn.SiLU(),
        )

    class CSP(nn.Module):
        def __init__(self, ci, co, n=1):
            super().__init__()
            mid = co // 2
            self.a = cbs(ci, mid, 1)
            self.b = cbs(ci, mid, 1)
            self.m = nn.Sequential(
                *[nn.Sequential(cbs(mid, mid, 1), cbs(mid, mid, 3)) for _ in range(n)]
            )
            self.out = cbs(2 * mid, co, 1)

        def forward(self, x):
            a = self.a(x)
            return self.out(torch.cat([self.m(a) + a, self.b(x)], 1))

    class Head(nn.Module):
        """Decoupled head shared-shape per level: stem 1x1 then separate
        2-conv cls and reg towers; outputs cat([reg4, obj1, clsC])."""

        def __init__(self, ci, feat, nc):
            super().__init__()
            self.stem = cbs(ci, feat, 1)
            self.cls_tower = nn.Sequential(cbs(feat, feat), cbs(feat, feat))
            self.reg_tower = nn.Sequential(cbs(feat, feat), cbs(feat, feat))
            self.cls_pred = nn.Conv2d(feat, nc, 1)
            self.reg_pred = nn.Conv2d(feat, 4, 1)
            self.obj_pred = nn.Conv2d(feat, 1, 1)

        def forward(self, x):
            x = self.stem(x)
            c = self.cls_tower(x)
            r = self.reg_tower(x)
            return torch.cat(
                [self.reg_pred(r), self.obj_pred(r), self.cls_pred(c)], 1
            )

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            w = width
            # stem: Focus(slice+cat+conv3) == one 6x6/s2 conv on the raw image
            self.stem = cbs(3, w, 6, 2)
            self.d2 = nn.Sequential(cbs(w, 2 * w, 3, 2), CSP(2 * w, 2 * w))
            self.d3 = nn.Sequential(cbs(2 * w, 4 * w, 3, 2), CSP(4 * w, 4 * w, 2))
            self.d4 = nn.Sequential(cbs(4 * w, 8 * w, 3, 2), CSP(8 * w, 8 * w, 2))
            self.d5 = nn.Sequential(cbs(8 * w, 16 * w, 3, 2), CSP(16 * w, 16 * w))
            # PAFPN (top-down then bottom-up)
            self.lat5 = cbs(16 * w, 8 * w, 1)
            self.c4 = CSP(16 * w, 8 * w)
            self.lat4 = cbs(8 * w, 4 * w, 1)
            self.c3 = CSP(8 * w, 4 * w)
            self.down3 = cbs(4 * w, 4 * w, 3, 2)
            self.c4u = CSP(8 * w, 8 * w)
            self.down4 = cbs(8 * w, 8 * w, 3, 2)
            self.c5u = CSP(16 * w, 16 * w)
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.heads = nn.ModuleList(
                [Head(4 * w, 4 * w, num_classes), Head(8 * w, 4 * w, num_classes),
                 Head(16 * w, 4 * w, num_classes)]
            )

        def forward(self, x):
            p3 = self.d3(self.d2(self.stem(x)))
            p4 = self.d4(p3)
            p5 = self.d5(p4)
            l5 = self.lat5(p5)
            m4 = self.c4(torch.cat([self.up(l5), p4], 1))
            l4 = self.lat4(m4)
            o3 = self.c3(torch.cat([self.up(l4), p3], 1))
            o4 = self.c4u(torch.cat([self.down3(o3), l4], 1))
            o5 = self.c5u(torch.cat([self.down4(o4), l5], 1))
            return tuple(h(f) for h, f in zip(self.heads, (o3, o4, o5)))

    return Net()


def build_yolox_graph(num_classes=80, img=416, width=32):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = YOLOXLite(num_classes, width)
    m.eval()
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "yolox"
    return m, optimize(g)


def decode_yolox(outputs, num_classes=80, strides=(8, 16, 32),
                 score_threshold=0.3):
    """Anchor-free grid decode of [N, 5+C, h, w] maps -> [M,6]
    (x0,y0,x1,y1,score,cls) in input pixels — tm_yolox.cpp's
    generate_yolox_proposals, vectorized."""
    dets = []
    for out, stride in zip(outputs, strides):
        n, c, h, w = out.shape
        o = out[0]
        gy, gx = np.mgrid[0:h, 0:w]
        cx = (o[0] + gx) * stride
        cy = (o[1] + gy) * stride
        bw = np.exp(np.clip(o[2], -10, 10)) * stride
        bh = np.exp(np.clip(o[3], -10, 10)) * stride
        obj = 1 / (1 + np.exp(-o[4]))
        cls = 1 / (1 + np.exp(-o[5 : 5 + num_classes]))
        score = obj * cls.max(axis=0)
        keep = score > score_threshold
        if not keep.any():
            continue
        cid = cls.argmax(axis=0)[keep]
        x0 = (cx - bw / 2)[keep]
        y0 = (cy - bh / 2)[keep]
        x1 = (cx + bw / 2)[keep]
        y1 = (cy + bh / 2)[keep]
        dets.append(
            np.stack([x0, y0, x1, y1, score[keep], cid.astype(np.float32)], 1)
        )
    if not dets:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(dets, 0).astype(np.float32)


# ---------------------------------------------------------------------------
# SCRFD: efficient face detector — residual backbone + PAFPN + shared
# per-level heads emitting score(A), bbox(4A) and 5-point kps(10A) maps at
# strides 8/16/32 with A=2 anchors per cell (tm_scrfd.cpp:60-140 decodes
# distance-to-center boxes and keypoint offsets).
# ---------------------------------------------------------------------------


def SCRFDLite(width: int = 16, anchors: int = 2):
    torch, nn = _torch()

    def cbr(ci, co, k=3, s=1, g=1):
        return nn.Sequential(
            nn.Conv2d(ci, co, k, s, k // 2, groups=g, bias=False),
            nn.BatchNorm2d(co),
            nn.ReLU(),
        )

    class Res(nn.Module):
        def __init__(self, ci, co, s=1):
            super().__init__()
            self.body = nn.Sequential(cbr(ci, co, 3, s), cbr(co, co, 3, 1))
            self.down = cbr(ci, co, 1, s) if (s != 1 or ci != co) else None
            self.relu = nn.ReLU()

        def forward(self, x):
            return self.relu(self.body(x) + (self.down(x) if self.down else x))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            w = width
            self.stem = cbr(3, w, 3, 2)
            self.s1 = Res(w, w, 2)            # /4
            self.s2 = Res(w, 2 * w, 2)        # /8
            self.s3 = Res(2 * w, 4 * w, 2)    # /16
            self.s4 = Res(4 * w, 8 * w, 2)    # /32
            self.l2 = nn.Conv2d(2 * w, 2 * w, 1)
            self.l3 = nn.Conv2d(4 * w, 2 * w, 1)
            self.l4 = nn.Conv2d(8 * w, 2 * w, 1)
            self.sm3 = cbr(2 * w, 2 * w)
            self.sm2 = cbr(2 * w, 2 * w)
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            # shared head: one tower, 3 predictors per level
            self.tower = nn.Sequential(cbr(2 * w, 2 * w), cbr(2 * w, 2 * w))
            self.score = nn.Conv2d(2 * w, anchors, 1)
            self.bbox = nn.Conv2d(2 * w, 4 * anchors, 1)
            self.kps = nn.Conv2d(2 * w, 10 * anchors, 1)

        def forward(self, x):
            c2 = self.s2(self.s1(self.stem(x)))
            c3 = self.s3(c2)
            c4 = self.s4(c3)
            f4 = self.l4(c4)
            f3 = self.sm3(self.l3(c3) + self.up(f4))
            f2 = self.sm2(self.l2(c2) + self.up(f3))
            outs = []
            for f in (f2, f3, f4):
                t = self.tower(f)
                outs.extend([self.score(t), self.bbox(t), self.kps(t)])
            return tuple(outs)

    return Net()


def build_scrfd_graph(img=320, width=16):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = SCRFDLite(width)
    m.eval()
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "scrfd"
    return m, optimize(g)


def scrfd_anchor_centers(h, w, stride, anchors=2):
    """[h*w*A, 2] anchor-center grid in input pixels (tm_scrfd.cpp:75-85)."""
    gy, gx = np.mgrid[0:h, 0:w]
    pts = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32) * stride
    return np.repeat(pts, anchors, axis=0)


def decode_scrfd(outputs, img, strides=(8, 16, 32), anchors=2,
                 score_threshold=0.5):
    """Decode per-level (score, bbox-distance, kps-offset) triplets ->
    (boxes [M,5], kps [M,5,2]) — tm_scrfd.cpp's generate_proposals."""
    boxes, kpss = [], []
    for i, stride in enumerate(strides):
        score = outputs[3 * i + 0][0]  # [A, h, w]
        bbox = outputs[3 * i + 1][0]
        kps = outputs[3 * i + 2][0]
        a, h, w = score.shape
        centers = scrfd_anchor_centers(h, w, stride, a)
        s = 1 / (1 + np.exp(-score.transpose(1, 2, 0).reshape(-1)))
        d = bbox.reshape(a, 4, h, w).transpose(2, 3, 0, 1).reshape(-1, 4) * stride
        k = kps.reshape(a, 10, h, w).transpose(2, 3, 0, 1).reshape(-1, 5, 2) * stride
        keep = s > score_threshold
        if not keep.any():
            continue
        c = centers[keep]
        d = d[keep]
        boxes.append(
            np.concatenate(
                [c[:, 0:1] - d[:, 0:1], c[:, 1:2] - d[:, 1:2],
                 c[:, 0:1] + d[:, 2:3], c[:, 1:2] + d[:, 3:4],
                 s[keep][:, None]], 1)
        )
        kpss.append(c[:, None, :] + k[keep])
    if not boxes:
        return np.zeros((0, 5), np.float32), np.zeros((0, 5, 2), np.float32)
    return (np.concatenate(boxes).astype(np.float32),
            np.concatenate(kpss).astype(np.float32))


# ---------------------------------------------------------------------------
# MoveNet: single-person pose — depthwise-separable backbone + upsample
# neck to stride 4, four heads: person-center heatmap(1), keypoint
# heatmaps(K), center->keypoint regression(2K), local offsets(2K)
# (tm_movenet.cpp decodes center argmax -> regressed keypoints -> refined
# by the local offset at each keypoint's heatmap argmax).
# ---------------------------------------------------------------------------


def MoveNetLite(num_joints: int = 17, width: int = 24):
    torch, nn = _torch()

    def dwsep(ci, co, s=1):
        return nn.Sequential(
            nn.Conv2d(ci, ci, 3, s, 1, groups=ci, bias=False),
            nn.BatchNorm2d(ci),
            nn.ReLU6(),
            nn.Conv2d(ci, co, 1, bias=False),
            nn.BatchNorm2d(co),
            nn.ReLU6(),
        )

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            w = width
            self.stem = nn.Sequential(
                nn.Conv2d(3, w, 3, 2, 1, bias=False), nn.BatchNorm2d(w), nn.ReLU6()
            )
            self.b1 = dwsep(w, 2 * w, 2)      # /4
            self.b2 = dwsep(2 * w, 4 * w, 2)  # /8
            self.b3 = dwsep(4 * w, 8 * w, 2)  # /16
            self.b4 = dwsep(8 * w, 8 * w, 1)
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.l8 = nn.Conv2d(4 * w, 4 * w, 1)
            self.l4 = nn.Conv2d(2 * w, 4 * w, 1)
            self.red = nn.Conv2d(8 * w, 4 * w, 1)
            self.smooth = dwsep(4 * w, 4 * w)
            k = num_joints
            self.head_center = nn.Sequential(dwsep(4 * w, 4 * w), nn.Conv2d(4 * w, 1, 1))
            self.head_heatmap = nn.Sequential(dwsep(4 * w, 4 * w), nn.Conv2d(4 * w, k, 1))
            self.head_reg = nn.Sequential(dwsep(4 * w, 4 * w), nn.Conv2d(4 * w, 2 * k, 1))
            self.head_offset = nn.Sequential(dwsep(4 * w, 4 * w), nn.Conv2d(4 * w, 2 * k, 1))

        def forward(self, x):
            c4 = self.b1(self.stem(x))
            c8 = self.b2(c4)
            c16 = self.b4(self.b3(c8))
            f = self.up(self.red(c16)) + self.l8(c8)
            f = self.smooth(self.up(f) + self.l4(c4))
            return (
                torch.sigmoid(self.head_center(f)),
                torch.sigmoid(self.head_heatmap(f)),
                self.head_reg(f),
                self.head_offset(f),
            )

    return Net()


def build_movenet_graph(num_joints=17, img=192, width=24):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = MoveNetLite(num_joints, width)
    m.eval()
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "movenet"
    return m, optimize(g)


def decode_movenet(center, heatmap, reg, offset, img: int):
    """Center-based decode -> (keypoints [K,2] in input px, scores [K]).

    tm_movenet.cpp's decode: argmax the person-center map, read the 2K
    regression at that cell to get coarse keypoints, then for each joint
    take the heatmap argmax in a neighborhood (here: global argmax weighted
    by distance prior, the 'ctr_weight' trick) and refine with the local
    offset map."""
    _, _, h, w = center.shape
    k = heatmap.shape[1]
    ci = center[0, 0].reshape(-1).argmax()
    cy, cx = divmod(int(ci), w)
    kps = np.zeros((k, 2), np.float32)
    scores = np.zeros((k,), np.float32)
    gy, gx = np.mgrid[0:h, 0:w]
    for j in range(k):
        ky = cy + reg[0, 2 * j + 1, cy, cx]
        kx = cx + reg[0, 2 * j, cy, cx]
        dist = np.sqrt((gy - ky) ** 2 + (gx - kx) ** 2) + 1.8
        scored = heatmap[0, j] / dist
        yi, xi = divmod(int(scored.reshape(-1).argmax()), w)
        ox = offset[0, 2 * j, yi, xi]
        oy = offset[0, 2 * j + 1, yi, xi]
        stride = img / w
        kps[j] = ((xi + ox) * stride, (yi + oy) * stride)
        scores[j] = heatmap[0, j, yi, xi]
    return kps, scores
