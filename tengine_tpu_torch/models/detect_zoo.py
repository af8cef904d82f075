"""More model families from the reference's integration-test zoo
(tests/models/test_model_{alphapose,nanodet_m,ultraface}.cpp): human-pose
heatmap regression, anchor-free detection (GFL head), and a slim SSD-style
face detector.

Clean-room torch modules mirroring each family's published architecture
shape (not ports of any implementation), imported through the fx
front-end. They exercise op families the other zoo nets don't hit
together: ConvTranspose + PixelShuffle heads (pose), ShuffleChannel +
multi-scale PAN adds (nanodet), and depthwise-separable SSD heads
(ultraface). Weights are seeded random — the reference benchmarks
weight-stripped nets the same way (tm2_serializer.c:241-246).

PyTorch port: a copy of tengine_tpu/models/detect_zoo.py, built through
the port's torch front-end and optimize pipeline, so that after one
torch.manual_seed both packages build the same IR."""

from __future__ import annotations

import numpy as np

__all__ = [
    "FastPose",
    "NanoDetM",
    "UltraFace",
    "build_fastpose_graph",
    "build_nanodet_graph",
    "build_ultraface_graph",
    "decode_pose_heatmaps",
    "decode_nanodet",
    "decode_ultraface",
]


def _torch():
    import torch
    import torch.nn as nn

    return torch, nn


# ---------------------------------------------------------------------------
# AlphaPose / FastPose: resnet-style backbone + DUC (pixel-shuffle) upsample
# head -> 17 COCO keypoint heatmaps (test_model_alphapose.cpp's output
# contract: [1, 17, H/4, W/4]).
# ---------------------------------------------------------------------------


def FastPose(num_joints: int = 17, width: int = 32):
    torch, nn = _torch()

    class Bottleneck(nn.Module):
        def __init__(self, ci, co, stride=1):
            super().__init__()
            mid = co // 4
            self.conv1 = nn.Conv2d(ci, mid, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(mid)
            self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(mid)
            self.conv3 = nn.Conv2d(mid, co, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(co)
            self.relu = nn.ReLU()
            self.down = (
                nn.Sequential(nn.Conv2d(ci, co, 1, stride, bias=False), nn.BatchNorm2d(co))
                if (stride != 1 or ci != co)
                else None
            )

        def forward(self, x):
            r = x if self.down is None else self.down(x)
            x = self.relu(self.bn1(self.conv1(x)))
            x = self.relu(self.bn2(self.conv2(x)))
            x = self.bn3(self.conv3(x))
            return self.relu(x + r)

    class DUC(nn.Module):
        """Dense upsampling conv: conv -> bn -> relu -> pixel shuffle x2."""

        def __init__(self, ci, co):
            super().__init__()
            self.conv = nn.Conv2d(ci, co, 3, 1, 1, bias=False)
            self.bn = nn.BatchNorm2d(co)
            self.relu = nn.ReLU()
            self.shuffle = nn.PixelShuffle(2)

        def forward(self, x):
            return self.shuffle(self.relu(self.bn(self.conv(x))))

    w = width

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, w, 7, 2, 3, bias=False), nn.BatchNorm2d(w), nn.ReLU(),
                nn.MaxPool2d(3, 2, 1),
            )
            self.layer1 = nn.Sequential(Bottleneck(w, w * 4), Bottleneck(w * 4, w * 4))
            self.layer2 = nn.Sequential(
                Bottleneck(w * 4, w * 8, 2), Bottleneck(w * 8, w * 8)
            )
            self.layer3 = nn.Sequential(
                Bottleneck(w * 8, w * 16, 2), Bottleneck(w * 16, w * 16)
            )
            self.layer4 = nn.Sequential(
                Bottleneck(w * 16, w * 32, 2), Bottleneck(w * 32, w * 32)
            )
            self.shuffle1 = nn.PixelShuffle(2)
            self.duc1 = DUC(w * 8, w * 16)
            self.duc2 = DUC(w * 4, w * 8)
            self.head = nn.Conv2d(w * 2, num_joints, 3, 1, 1)

        def forward(self, x):
            # /32 backbone + 3x2 upsampling -> /4 heatmaps (FastPose contract)
            x = self.stem(x)
            x = self.layer1(x)
            x = self.layer2(x)
            x = self.layer3(x)
            x = self.layer4(x)
            x = self.shuffle1(x)   # w*32 -> w*8, 2x up
            x = self.duc1(x)       # -> w*4, 2x up
            x = self.duc2(x)       # -> w*2, 2x up
            return self.head(x)

    return Net().eval()


def build_fastpose_graph(num_joints=17, img_h=256, img_w=192, width=32):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = FastPose(num_joints, width)
    g = from_torch(m, torch.zeros(1, 3, img_h, img_w))
    g.name = "fastpose"
    return m, optimize(g)


def decode_pose_heatmaps(hm: np.ndarray):
    """Heatmap -> (keypoints [N,J,2] in input pixels, scores [N,J]) — the
    argmax decode of test_model_alphapose.cpp."""
    n, j, h, w = hm.shape
    flat = hm.reshape(n, j, -1)
    idx = flat.argmax(axis=-1)
    scores = np.take_along_axis(flat, idx[..., None], axis=-1)[..., 0]
    ys, xs = idx // w, idx % w
    kps = np.stack([xs * 4.0, ys * 4.0], axis=-1)
    return kps, scores


# ---------------------------------------------------------------------------
# NanoDet-m: ShuffleNetV2-style backbone (channel shuffle) + PAN neck +
# shared GFL head -> per-level [cls(80) + 4*(reg_max+1)] maps
# (test_model_nanodet_m.cpp decodes strides 8/16/32 with reg_max=7).
# ---------------------------------------------------------------------------


def NanoDetM(num_classes: int = 80, reg_max: int = 7, width: int = 48):
    torch, nn = _torch()

    class ShuffleBlock(nn.Module):
        def __init__(self, ci, co, stride):
            super().__init__()
            self.stride = stride
            self.half = ci // 2
            branch = co // 2
            if stride == 2:
                self.b0 = nn.Sequential(
                    nn.Conv2d(ci, ci, 3, 2, 1, groups=ci, bias=False),
                    nn.BatchNorm2d(ci),
                    nn.Conv2d(ci, branch, 1, bias=False),
                    nn.BatchNorm2d(branch), nn.ReLU(),
                )
                cin1 = ci
            else:
                self.b0 = None
                cin1 = ci // 2
            self.b1 = nn.Sequential(
                nn.Conv2d(cin1, branch, 1, bias=False),
                nn.BatchNorm2d(branch), nn.ReLU(),
                nn.Conv2d(branch, branch, 3, stride, 1, groups=branch, bias=False),
                nn.BatchNorm2d(branch),
                nn.Conv2d(branch, branch, 1, bias=False),
                nn.BatchNorm2d(branch), nn.ReLU(),
            )
            self.shuffle = nn.ChannelShuffle(2)

        def forward(self, x):
            if self.stride == 2:
                out = torch.cat([self.b0(x), self.b1(x)], dim=1)
            else:
                a, b = x[:, : self.half], x[:, self.half :]
                out = torch.cat([a, self.b1(b)], dim=1)
            return self.shuffle(out)

    w0 = width

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, 24, 3, 2, 1, bias=False), nn.BatchNorm2d(24), nn.ReLU(),
                nn.MaxPool2d(3, 2, 1),
            )
            self.stage2 = nn.Sequential(
                ShuffleBlock(24, w0 * 2, 2), ShuffleBlock(w0 * 2, w0 * 2, 1)
            )
            self.stage3 = nn.Sequential(
                ShuffleBlock(w0 * 2, w0 * 4, 2), ShuffleBlock(w0 * 4, w0 * 4, 1)
            )
            self.stage4 = nn.Sequential(
                ShuffleBlock(w0 * 4, w0 * 8, 2), ShuffleBlock(w0 * 8, w0 * 8, 1)
            )
            neck = 96
            self.lat2 = nn.Conv2d(w0 * 2, neck, 1)
            self.lat3 = nn.Conv2d(w0 * 4, neck, 1)
            self.lat4 = nn.Conv2d(w0 * 8, neck, 1)
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.down = nn.Conv2d(neck, neck, 3, 2, 1)
            out_ch = num_classes + 4 * (reg_max + 1)
            self.heads = nn.ModuleList(
                nn.Sequential(
                    nn.Conv2d(neck, neck, 3, 1, 1, groups=neck, bias=False),
                    nn.BatchNorm2d(neck), nn.ReLU(),
                    nn.Conv2d(neck, neck, 1), nn.ReLU(),
                    nn.Conv2d(neck, out_ch, 1),
                )
                for _ in range(3)
            )

        def forward(self, x):
            x = self.stem(x)
            c2 = self.stage2(x)
            c3 = self.stage3(c2)
            c4 = self.stage4(c3)
            p4 = self.lat4(c4)
            p3 = self.lat3(c3) + self.up(p4)
            p2 = self.lat2(c2) + self.up(p3)
            n3 = p3 + self.down(p2)
            n4 = p4 + self.down(n3)
            return self.heads[0](p2), self.heads[1](n3), self.heads[2](n4)

    return Net().eval()


def build_nanodet_graph(num_classes=80, reg_max=7, img=320, width=48):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = NanoDetM(num_classes, reg_max, width)
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "nanodet_m"
    return m, optimize(g)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def decode_nanodet(outputs, num_classes=80, reg_max=7, strides=(8, 16, 32),
                   score_threshold=0.35):
    """GFL decode (test_model_nanodet_m.cpp): per-cell distribution
    expectation -> l/t/r/b distances -> boxes; returns [M, 6]
    (x0,y0,x1,y1,score,cls)."""
    dets = []
    for out, stride in zip(outputs, strides):
        n, c, h, w = out.shape
        cls = out[0, :num_classes].reshape(num_classes, -1).T          # [HW, C]
        reg = out[0, num_classes:].reshape(4, reg_max + 1, h * w)
        prob = _softmax(reg.transpose(2, 0, 1))                        # [HW,4,R]
        dist = (prob * np.arange(reg_max + 1)).sum(-1) * stride        # [HW,4]
        scores = 1.0 / (1.0 + np.exp(-cls))
        best = scores.max(axis=1)
        keep = np.where(best > score_threshold)[0]
        ys, xs = keep // w, keep % w
        cx, cy = (xs + 0.5) * stride, (ys + 0.5) * stride
        l, t, r, b = dist[keep].T
        for i, k in enumerate(keep):
            dets.append([cx[i] - l[i], cy[i] - t[i], cx[i] + r[i], cy[i] + b[i],
                         best[k], scores[k].argmax()])
    return np.asarray(dets, np.float32).reshape(-1, 6)


# ---------------------------------------------------------------------------
# UltraFace (version-slim style): depthwise-separable backbone + SSD heads
# on 4 scales (test_model_ultraface.cpp: scores [N,2], boxes [N,4]).
# ---------------------------------------------------------------------------


def UltraFace(width: int = 16):
    torch, nn = _torch()

    def dw_pw(ci, co, stride=1):
        return nn.Sequential(
            nn.Conv2d(ci, ci, 3, stride, 1, groups=ci, bias=False),
            nn.BatchNorm2d(ci), nn.ReLU(),
            nn.Conv2d(ci, co, 1, bias=False), nn.BatchNorm2d(co), nn.ReLU(),
        )

    w = width

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.s1 = nn.Sequential(  # /4 -> feature 1
                nn.Conv2d(3, w, 3, 2, 1, bias=False), nn.BatchNorm2d(w), nn.ReLU(),
                dw_pw(w, w * 2, 2), dw_pw(w * 2, w * 2), dw_pw(w * 2, w * 2),
            )
            self.s2 = nn.Sequential(dw_pw(w * 2, w * 4, 2), dw_pw(w * 4, w * 4))
            self.s3 = nn.Sequential(dw_pw(w * 4, w * 8, 2), dw_pw(w * 8, w * 8))
            self.s4 = nn.Sequential(dw_pw(w * 8, w * 16, 2), dw_pw(w * 16, w * 16))
            anchors = (3, 2, 2, 3)
            chans = (w * 2, w * 4, w * 8, w * 16)
            self.cls = nn.ModuleList(nn.Conv2d(c, a * 2, 3, 1, 1) for c, a in zip(chans, anchors))
            self.reg = nn.ModuleList(nn.Conv2d(c, a * 4, 3, 1, 1) for c, a in zip(chans, anchors))

        def forward(self, x):
            # raw per-scale conv maps [N, A*2|A*4, h, w]; host decode
            # flattens to the reference's [N, priors, 2|4] contract
            feats = []
            x = self.s1(x); feats.append(x)
            x = self.s2(x); feats.append(x)
            x = self.s3(x); feats.append(x)
            x = self.s4(x); feats.append(x)
            outs = []
            for f, c, r in zip(feats, self.cls, self.reg):
                outs.append(c(f))
                outs.append(r(f))
            return tuple(outs)

    return Net().eval()


def build_ultraface_graph(img_h=240, img_w=320, width=16):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = UltraFace(width)
    g = from_torch(m, torch.zeros(1, 3, img_h, img_w))
    g.name = "ultraface"
    return m, optimize(g)


def flatten_ultraface(outputs, anchors=(3, 2, 2, 3)):
    """Raw per-scale head maps -> ([N, priors, 2] scores, [N, priors, 4]
    boxes), the reference's output contract."""
    scores, boxes = [], []
    for i, _ in enumerate(anchors):
        s, b = np.asarray(outputs[2 * i]), np.asarray(outputs[2 * i + 1])
        n = s.shape[0]
        scores.append(s.transpose(0, 2, 3, 1).reshape(n, -1, 2))
        boxes.append(b.transpose(0, 2, 3, 1).reshape(n, -1, 4))
    return np.concatenate(scores, 1), np.concatenate(boxes, 1)


def decode_ultraface(scores, boxes, priors, score_threshold=0.7,
                     center_var=0.1, size_var=0.2):
    """SSD prior decode (test_model_ultraface.cpp semantics)."""
    s = _softmax(scores[0], axis=-1)[:, 1]
    keep = np.where(s > score_threshold)[0]
    b = boxes[0][keep]
    p = priors[keep]
    cxy = b[:, :2] * center_var * p[:, 2:] + p[:, :2]
    wh = np.exp(b[:, 2:] * size_var) * p[:, 2:]
    out = np.concatenate([cxy - wh / 2, cxy + wh / 2, s[keep, None]], axis=1)
    return out.astype(np.float32)


def ultraface_priors(img_h=240, img_w=320):
    """Anchor grid matching UltraFace's 4 scales (normalized cx,cy,w,h).

    ceil(size / stride) cells a scale, as the convs give and as the
    upstream project computes its feature maps (Linzaer's
    Ultra-Light-Fast-Generic-Face-Detector, vision/ssd/config/fd_config.py).
    The JAX package counts floor(size / stride): 17,610 priors against the
    net's 17,640 scores at the default 240x320 (ROADMAP §3)."""
    min_boxes = [[10, 16, 24], [32, 48], [64, 96], [128, 192, 256]]
    strides = [4, 8, 16, 32]
    priors = []
    for stride, sizes in zip(strides, min_boxes):
        fh, fw = -(-img_h // stride), -(-img_w // stride)
        for y in range(fh):
            for x in range(fw):
                for s in sizes:
                    priors.append([
                        (x + 0.5) * stride / img_w,
                        (y + 0.5) * stride / img_h,
                        s / img_w,
                        s / img_h,
                    ])
    return np.asarray(priors, np.float32)


# ---------------------------------------------------------------------------
# HRNet-style pose net (test_model_hrnet.cpp): parallel high/low-resolution
# branches with exchange units; heatmaps stay at /4 the whole way.
# ---------------------------------------------------------------------------


def HRNetSmall(num_joints: int = 16, width: int = 18):
    torch, nn = _torch()

    def conv_bn(ci, co, k=3, s=1, act=True):
        mods = [nn.Conv2d(ci, co, k, s, k // 2, bias=False), nn.BatchNorm2d(co)]
        if act:
            mods.append(nn.ReLU())
        return nn.Sequential(*mods)

    class Basic(nn.Module):
        def __init__(self, c):
            super().__init__()
            self.c1 = conv_bn(c, c)
            self.c2 = conv_bn(c, c, act=False)
            self.relu = nn.ReLU()

        def forward(self, x):
            return self.relu(x + self.c2(self.c1(x)))

    w = width

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(conv_bn(3, w, s=2), conv_bn(w, w, s=2))
            self.hr1 = nn.Sequential(Basic(w), Basic(w))
            self.make_lr = conv_bn(w, w * 2, s=2)
            self.hr2 = nn.Sequential(Basic(w), Basic(w))
            self.lr2 = nn.Sequential(Basic(w * 2), Basic(w * 2))
            # exchange unit
            self.lr_to_hr = nn.Sequential(
                nn.Conv2d(w * 2, w, 1, bias=False), nn.BatchNorm2d(w),
                nn.Upsample(scale_factor=2, mode="nearest"),
            )
            self.hr_to_lr = conv_bn(w, w * 2, s=2, act=False)
            self.relu = nn.ReLU()
            self.hr3 = nn.Sequential(Basic(w), Basic(w))
            self.lr3 = nn.Sequential(Basic(w * 2), Basic(w * 2))
            self.final_fuse = nn.Sequential(
                nn.Conv2d(w * 2, w, 1, bias=False), nn.BatchNorm2d(w),
                nn.Upsample(scale_factor=2, mode="nearest"),
            )
            self.head = nn.Conv2d(w, num_joints, 1)

        def forward(self, x):
            x = self.stem(x)                      # /4, w
            hr = self.hr1(x)
            lr = self.make_lr(hr)                 # /8, 2w
            hr, lr = self.hr2(hr), self.lr2(lr)
            hr2 = self.relu(hr + self.lr_to_hr(lr))
            lr2 = self.relu(lr + self.hr_to_lr(hr))
            hr3, lr3 = self.hr3(hr2), self.lr3(lr2)
            fused = self.relu(hr3 + self.final_fuse(lr3))
            return self.head(fused)               # [N, J, H/4, W/4]

    return Net().eval()


def build_hrnet_graph(num_joints=16, img=256, width=18):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = HRNetSmall(num_joints, width)
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "hrnet"
    return m, optimize(g)


# ---------------------------------------------------------------------------
# YOLACT-style instance segmentation (test_model_yolact.cpp): FPN backbone,
# protonet mask prototypes, per-anchor (cls, box, mask-coefficient) heads;
# masks assemble on the host as sigmoid(proto @ coeffs).
# ---------------------------------------------------------------------------


def Yolact(num_classes: int = 81, num_protos: int = 32, anchors: int = 3,
           width: int = 32):
    torch, nn = _torch()

    def conv_bn(ci, co, k=3, s=1):
        return nn.Sequential(
            nn.Conv2d(ci, co, k, s, k // 2, bias=False),
            nn.BatchNorm2d(co), nn.ReLU(),
        )

    w = width

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = conv_bn(3, w, s=2)
            self.c3 = nn.Sequential(conv_bn(w, w * 2, s=2), conv_bn(w * 2, w * 2),
                                    conv_bn(w * 2, w * 2, s=2))       # /8
            self.c4 = nn.Sequential(conv_bn(w * 2, w * 4, s=2), conv_bn(w * 4, w * 4))  # /16
            self.c5 = nn.Sequential(conv_bn(w * 4, w * 8, s=2), conv_bn(w * 8, w * 8))  # /32
            f = w * 4
            self.lat3 = nn.Conv2d(w * 2, f, 1)
            self.lat4 = nn.Conv2d(w * 4, f, 1)
            self.lat5 = nn.Conv2d(w * 8, f, 1)
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.smooth = nn.ModuleList(conv_bn(f, f) for _ in range(3))
            self.proto = nn.Sequential(
                conv_bn(f, f), conv_bn(f, f),
                nn.Upsample(scale_factor=2, mode="nearest"),
                conv_bn(f, f), nn.Conv2d(f, num_protos, 1),
            )
            self.tower = conv_bn(f, f)
            self.cls = nn.Conv2d(f, anchors * num_classes, 3, 1, 1)
            self.box = nn.Conv2d(f, anchors * 4, 3, 1, 1)
            self.coef = nn.Conv2d(f, anchors * num_protos, 3, 1, 1)

        def forward(self, x):
            x = self.stem(x)
            c3 = self.c3(x)
            c4 = self.c4(c3)
            c5 = self.c5(c4)
            p5 = self.lat5(c5)
            p4 = self.smooth[1](self.lat4(c4) + self.up(p5))
            p3 = self.smooth[0](self.lat3(c3) + self.up(p4))
            proto = self.proto(p3)                 # [N, protos, H/4, W/4]
            outs = [proto]
            for p in (p3, p4, p5):
                t = self.tower(p)
                outs += [self.cls(t), self.box(t), self.coef(t)]
            return tuple(outs)

    return Net().eval()


def build_yolact_graph(num_classes=81, img=256, width=32):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = Yolact(num_classes, width=width)
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "yolact"
    return m, optimize(g)


def assemble_yolact_masks(proto: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Host mask assembly: sigmoid(proto^T @ coeffs) per detection
    (yolact's linear-combination head). proto [P,H,W], coeffs [M,P] ->
    masks [M,H,W] in (0,1)."""
    p, h, w = proto.shape
    m = coeffs @ proto.reshape(p, -1)
    return (1.0 / (1.0 + np.exp(-m))).reshape(-1, h, w)


# ---------------------------------------------------------------------------
# OpenPose-style multi-stage 2-branch net (test_model_openpose.cpp): VGG
# feature trunk, then refinement stages each emitting PAFs (2*limbs) and
# part heatmaps (parts+1), concatenated with the trunk between stages.
# ---------------------------------------------------------------------------


def OpenPose(parts: int = 18, limbs: int = 19, stages: int = 2, width: int = 32):
    torch, nn = _torch()

    def convs(ci, co, n=1, k=3):
        mods = []
        for i in range(n):
            mods += [nn.Conv2d(ci if i == 0 else co, co, k, 1, k // 2), nn.ReLU()]
        return nn.Sequential(*mods)

    w = width
    paf_c, hm_c = 2 * limbs, parts + 1

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = nn.Sequential(
                convs(3, w, 2), nn.MaxPool2d(2, 2),
                convs(w, w * 2, 2), nn.MaxPool2d(2, 2),
                convs(w * 2, w * 4, 2), nn.MaxPool2d(2, 2),
                convs(w * 4, w * 4, 2),
            )
            feat = w * 4

            def branch(cin, cout):
                return nn.Sequential(convs(cin, w * 2, 3), nn.Conv2d(w * 2, cout, 1))

            self.paf0 = branch(feat, paf_c)
            self.hm0 = branch(feat, hm_c)
            self.refine = nn.ModuleList()
            for _ in range(stages - 1):
                cin = feat + paf_c + hm_c
                self.refine.append(nn.ModuleList([branch(cin, paf_c), branch(cin, hm_c)]))

        def forward(self, x):
            f = self.trunk(x)
            paf, hm = self.paf0(f), self.hm0(f)
            for pb, hb in self.refine:
                cat = torch.cat([f, paf, hm], dim=1)
                paf, hm = pb(cat), hb(cat)
            return paf, hm

    return Net().eval()


def build_openpose_graph(img=368, parts=18, limbs=19, stages=2, width=32):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = OpenPose(parts, limbs, stages, width)
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "openpose"
    return m, optimize(g)


# ---------------------------------------------------------------------------
# EfficientDet-lite style (test_model_efficientdet.c): MBConv+SE backbone,
# BiFPN-style weighted cross-scale fusion, shared box/cls heads.
# ---------------------------------------------------------------------------


def EfficientDetLite(num_classes: int = 90, anchors: int = 9, width: int = 16):
    torch, nn = _torch()

    class MBConv(nn.Module):
        def __init__(self, ci, co, stride=1, expand=4):
            super().__init__()
            mid = ci * expand
            self.expand = nn.Sequential(
                nn.Conv2d(ci, mid, 1, bias=False), nn.BatchNorm2d(mid), nn.SiLU()
            )
            self.dw = nn.Sequential(
                nn.Conv2d(mid, mid, 3, stride, 1, groups=mid, bias=False),
                nn.BatchNorm2d(mid), nn.SiLU(),
            )
            se = max(ci // 4, 4)
            self.se_pool = nn.AdaptiveAvgPool2d(1)
            self.se = nn.Sequential(
                nn.Conv2d(mid, se, 1), nn.SiLU(), nn.Conv2d(se, mid, 1), nn.Sigmoid()
            )
            self.project = nn.Sequential(
                nn.Conv2d(mid, co, 1, bias=False), nn.BatchNorm2d(co)
            )
            self.skip = stride == 1 and ci == co

        def forward(self, x):
            y = self.dw(self.expand(x))
            y = y * self.se(self.se_pool(y))      # squeeze-excite broadmul
            y = self.project(y)
            return x + y if self.skip else y

    w = width

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, w, 3, 2, 1, bias=False), nn.BatchNorm2d(w), nn.SiLU()
            )
            self.b1 = nn.Sequential(MBConv(w, w * 2, 2), MBConv(w * 2, w * 2))      # /4
            self.b2 = nn.Sequential(MBConv(w * 2, w * 4, 2), MBConv(w * 4, w * 4))  # /8  P3
            self.b3 = nn.Sequential(MBConv(w * 4, w * 6, 2), MBConv(w * 6, w * 6))  # /16 P4
            self.b4 = nn.Sequential(MBConv(w * 6, w * 8, 2), MBConv(w * 8, w * 8))  # /32 P5
            f = w * 4
            self.lat = nn.ModuleList([
                nn.Conv2d(w * 4, f, 1), nn.Conv2d(w * 6, f, 1), nn.Conv2d(w * 8, f, 1)
            ])
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.down = nn.MaxPool2d(3, 2, 1)
            # BiFPN fast-attention weights are relu-normalized learned
            # scalars — constants at inference; with the ones-init they
            # normalize to 0.5/0.5 (a converter folds trained values the
            # same way)
            self.w_fuse = 0.5
            self.fuse = nn.ModuleList(
                nn.Sequential(
                    nn.Conv2d(f, f, 3, 1, 1, groups=f, bias=False),
                    nn.Conv2d(f, f, 1, bias=False), nn.BatchNorm2d(f), nn.SiLU(),
                )
                for _ in range(4)
            )
            self.cls = nn.Conv2d(f, anchors * num_classes, 3, 1, 1)
            self.box = nn.Conv2d(f, anchors * 4, 3, 1, 1)

        def forward(self, x):
            x = self.stem(x)
            x = self.b1(x)
            c3 = self.b2(x)
            c4 = self.b3(c3)
            c5 = self.b4(c4)
            p3, p4, p5 = self.lat[0](c3), self.lat[1](c4), self.lat[2](c5)
            wf = self.w_fuse
            # top-down
            p4m = self.fuse[0](wf * p4 + wf * self.up(p5))
            p3o = self.fuse[1](wf * p3 + wf * self.up(p4m))
            # bottom-up
            p4o = self.fuse[2](wf * p4m + wf * self.down(p3o))
            p5o = self.fuse[3](wf * p5 + wf * self.down(p4o))
            outs = []
            for p in (p3o, p4o, p5o):
                outs += [self.cls(p), self.box(p)]
            return tuple(outs)

    return Net().eval()


def build_efficientdet_graph(num_classes=90, img=320, width=16):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = EfficientDetLite(num_classes, width=width)
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "efficientdet"
    return m, optimize(g)


# ---------------------------------------------------------------------------
# Face-landmark regression (test_model_landmark.cpp: 106 points x 2 coords
# from a mobilenet-ish backbone + FC).
# ---------------------------------------------------------------------------


def LandmarkNet(num_points: int = 106, width: int = 16):
    torch, nn = _torch()

    def dw_pw(ci, co, stride=1):
        return nn.Sequential(
            nn.Conv2d(ci, ci, 3, stride, 1, groups=ci, bias=False),
            nn.BatchNorm2d(ci), nn.ReLU(),
            nn.Conv2d(ci, co, 1, bias=False), nn.BatchNorm2d(co), nn.ReLU(),
        )

    w = width

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.net = nn.Sequential(
                nn.Conv2d(3, w, 3, 2, 1, bias=False), nn.BatchNorm2d(w), nn.ReLU(),
                dw_pw(w, w * 2, 2), dw_pw(w * 2, w * 2),
                dw_pw(w * 2, w * 4, 2), dw_pw(w * 4, w * 4),
                dw_pw(w * 4, w * 8, 2), dw_pw(w * 8, w * 8),
                nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                nn.Linear(w * 8, num_points * 2),
            )

        def forward(self, x):
            return self.net(x)

    return Net().eval()


def build_landmark_graph(num_points=106, img=160, width=16):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = LandmarkNet(num_points, width)
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "landmark"
    return m, optimize(g)
