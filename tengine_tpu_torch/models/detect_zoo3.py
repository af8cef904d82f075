"""Clean-room NanoDet-Plus and PicoDet model families.

Reference apps: Tengine's examples/tm_nanodet_plus.cpp (strides
{8,16,32,64}, one merged [priors, num_class + 4*(reg_max+1)] output decoded
against grid center priors, sigmoid cls + softmax-DFL boxes) and
tm_picodet.cpp (320x320, per-level cls_pred/dis_pred pairs, scores consumed
directly i.e. sigmoid applied in-model, (x+0.5)*stride centers).

Architectures follow the published designs at reduced widths (this is a
zero-egress environment: structure over pretrained weights, like the rest of
the zoo): NanoDet-Plus = ShuffleNetV2 backbone + GhostPAN neck + shared
depthwise GFL head; PicoDet = ESNet (shuffle blocks with SE) + CSP-PAN +
VFL/GFL head.

PyTorch port: a copy of tengine_tpu/models/detect_zoo3.py, built through
the port's torch front-end and optimize pipeline, so that after one
torch.manual_seed both packages build the same IR.
"""

from __future__ import annotations

import numpy as np


def _torch():
    import torch
    import torch.nn as nn

    return torch, nn


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


# ---------------------------------------------------------------------------
# shared backbone pieces
# ---------------------------------------------------------------------------


def _shuffle_block(nn, torch, ci, co, stride, se=False):
    class SE(nn.Module):
        def __init__(self, c):
            super().__init__()
            m = max(c // 4, 4)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Sequential(
                nn.Conv2d(c, m, 1), nn.ReLU(), nn.Conv2d(m, c, 1),
                nn.Hardsigmoid(),
            )

        def forward(self, x):
            return x * self.fc(self.pool(x))

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.stride = stride
            self.half = ci // 2
            branch = co // 2
            cin1 = ci if stride == 2 else ci // 2
            if stride == 2:
                self.b0 = nn.Sequential(
                    nn.Conv2d(ci, ci, 3, 2, 1, groups=ci, bias=False),
                    nn.BatchNorm2d(ci),
                    nn.Conv2d(ci, branch, 1, bias=False),
                    nn.BatchNorm2d(branch), nn.ReLU(),
                )
            else:
                self.b0 = None
            mods = [
                nn.Conv2d(cin1, branch, 1, bias=False),
                nn.BatchNorm2d(branch), nn.ReLU(),
                nn.Conv2d(branch, branch, 3, stride, 1, groups=branch, bias=False),
                nn.BatchNorm2d(branch),
                nn.Conv2d(branch, branch, 1, bias=False),
                nn.BatchNorm2d(branch), nn.ReLU(),
            ]
            self.b1 = nn.Sequential(*mods)
            self.se = SE(branch) if se else None
            self.shuffle = nn.ChannelShuffle(2)

        def forward(self, x):
            if self.stride == 2:
                b = self.b1(x)
                if self.se is not None:
                    b = self.se(b)
                out = torch.cat([self.b0(x), b], dim=1)
            else:
                a, b = x[:, : self.half], x[:, self.half :]
                b = self.b1(b)
                if self.se is not None:
                    b = self.se(b)
                out = torch.cat([a, b], dim=1)
            return self.shuffle(out)

    return Block()


# ---------------------------------------------------------------------------
# NanoDet-Plus
# ---------------------------------------------------------------------------


def NanoDetPlus(num_classes: int = 80, reg_max: int = 7, width: int = 32,
                neck: int = 64):
    torch, nn = _torch()
    w0 = width

    class Ghost(nn.Module):
        """GhostConv: half the features from a 1x1, half from a cheap dw3x3."""

        def __init__(self, ci, co):
            super().__init__()
            h = co // 2
            self.primary = nn.Sequential(
                nn.Conv2d(ci, h, 1, bias=False), nn.BatchNorm2d(h), nn.ReLU()
            )
            self.cheap = nn.Sequential(
                nn.Conv2d(h, h, 3, 1, 1, groups=h, bias=False),
                nn.BatchNorm2d(h), nn.ReLU(),
            )

        def forward(self, x):
            p = self.primary(x)
            return torch.cat([p, self.cheap(p)], dim=1)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, 24, 3, 2, 1, bias=False), nn.BatchNorm2d(24),
                nn.ReLU(), nn.MaxPool2d(3, 2, 1),
            )
            self.stage2 = nn.Sequential(
                _shuffle_block(nn, torch, 24, w0 * 2, 2),
                _shuffle_block(nn, torch, w0 * 2, w0 * 2, 1),
            )
            self.stage3 = nn.Sequential(
                _shuffle_block(nn, torch, w0 * 2, w0 * 4, 2),
                _shuffle_block(nn, torch, w0 * 4, w0 * 4, 1),
            )
            self.stage4 = nn.Sequential(
                _shuffle_block(nn, torch, w0 * 4, w0 * 8, 2),
                _shuffle_block(nn, torch, w0 * 8, w0 * 8, 1),
            )
            self.lat = nn.ModuleList([
                nn.Conv2d(w0 * 2, neck, 1), nn.Conv2d(w0 * 4, neck, 1),
                nn.Conv2d(w0 * 8, neck, 1),
            ])
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.g_td = nn.ModuleList([Ghost(neck, neck) for _ in range(2)])
            self.down = nn.ModuleList([
                nn.Sequential(
                    nn.Conv2d(neck, neck, 3, 2, 1, groups=neck, bias=False),
                    nn.BatchNorm2d(neck),
                    nn.Conv2d(neck, neck, 1, bias=False),
                    nn.BatchNorm2d(neck), nn.ReLU(),
                )
                for _ in range(2)
            ])
            self.g_bu = nn.ModuleList([Ghost(neck, neck) for _ in range(2)])
            # extra stride-64 level from the deepest PAN output
            self.extra = nn.Sequential(
                nn.Conv2d(neck, neck, 3, 2, 1, groups=neck, bias=False),
                nn.BatchNorm2d(neck),
                nn.Conv2d(neck, neck, 1, bias=False),
                nn.BatchNorm2d(neck), nn.ReLU(),
            )
            out_ch = num_classes + 4 * (reg_max + 1)
            self.head = nn.ModuleList([
                nn.Sequential(
                    nn.Conv2d(neck, neck, 3, 1, 1, groups=neck, bias=False),
                    nn.BatchNorm2d(neck), nn.ReLU(),
                    nn.Conv2d(neck, neck, 1, bias=False),
                    nn.BatchNorm2d(neck), nn.ReLU(),
                    nn.Conv2d(neck, out_ch, 1),
                )
                for _ in range(4)
            ])

        def forward(self, x):
            x = self.stem(x)
            c2 = self.stage2(x)
            c3 = self.stage3(c2)
            c4 = self.stage4(c3)
            p4 = self.lat[2](c4)
            p3 = self.g_td[0](self.lat[1](c3) + self.up(p4))
            p2 = self.g_td[1](self.lat[0](c2) + self.up(p3))
            n3 = self.g_bu[0](p3 + self.down[0](p2))
            n4 = self.g_bu[1](p4 + self.down[1](n3))
            n5 = self.extra(n4)
            outs = []
            for lvl, p in enumerate((p2, n3, n4, n5)):
                o = self.head[lvl](p)          # [N, C, h, w]
                outs.append(o.flatten(2))      # [N, C, h*w]
            # merged prior-major output like the reference app decodes:
            # [N, num_priors, num_class + 4*(reg_max+1)]
            return torch.cat(outs, dim=2).permute(0, 2, 1)

    return Net().eval()


def build_nanodet_plus_graph(num_classes=80, reg_max=7, img=416, width=32):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = NanoDetPlus(num_classes, reg_max, width)
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "nanodet_plus"
    return m, optimize(g)


def decode_nanodet_plus(output, img, num_classes=80, reg_max=7,
                        strides=(8, 16, 32, 64), score_threshold=0.35):
    """Merged-output decode (tm_nanodet_plus.cpp:102-213): grid center
    priors per stride, sigmoid cls scores, softmax-DFL distances * stride."""
    out = np.asarray(output)
    if out.ndim == 3:
        out = out[0]
    cls = 1.0 / (1.0 + np.exp(-out[:, :num_classes]))
    dfl = out[:, num_classes:].reshape(-1, 4, reg_max + 1)
    dist = (_softmax(dfl) * np.arange(reg_max + 1)).sum(-1)  # [P, 4]

    dets = []
    row = 0
    for s in strides:
        fw = fh = -(-img // s)
        n = fw * fh
        ys, xs = np.divmod(np.arange(n), fw)
        c = cls[row : row + n]
        d = dist[row : row + n] * s
        best = c.argmax(axis=1)
        score = c[np.arange(n), best]
        keep = score > score_threshold
        if keep.any():
            cx, cy = xs[keep] * s, ys[keep] * s
            dk = d[keep]
            dets.append(np.stack([
                cx - dk[:, 0], cy - dk[:, 1], cx + dk[:, 2], cy + dk[:, 3],
                score[keep], best[keep].astype(np.float64),
            ], axis=1))
        row += n
    if not dets:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(dets).astype(np.float32)


# ---------------------------------------------------------------------------
# PicoDet
# ---------------------------------------------------------------------------


def PicoDet(num_classes: int = 80, reg_max: int = 7, width: int = 32,
            neck: int = 64):
    torch, nn = _torch()
    w0 = width

    class CSPBlock(nn.Module):
        """Lightweight CSP fuse stage of the CSP-PAN neck."""

        def __init__(self, ci, co):
            super().__init__()
            h = co // 2
            self.a = nn.Sequential(
                nn.Conv2d(ci, h, 1, bias=False), nn.BatchNorm2d(h), nn.ReLU()
            )
            self.b = nn.Sequential(
                nn.Conv2d(ci, h, 1, bias=False), nn.BatchNorm2d(h), nn.ReLU(),
                nn.Conv2d(h, h, 3, 1, 1, groups=h, bias=False),
                nn.BatchNorm2d(h),
                nn.Conv2d(h, h, 1, bias=False), nn.BatchNorm2d(h), nn.ReLU(),
            )
            self.fuse = nn.Sequential(
                nn.Conv2d(2 * h, co, 1, bias=False), nn.BatchNorm2d(co),
                nn.ReLU(),
            )

        def forward(self, x):
            return self.fuse(torch.cat([self.a(x), self.b(x)], dim=1))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, 24, 3, 2, 1, bias=False), nn.BatchNorm2d(24),
                nn.ReLU(),
            )
            # ESNet stages: shuffle blocks with SE on the stride-2 entries
            self.stage2 = nn.Sequential(
                _shuffle_block(nn, torch, 24, w0 * 2, 2, se=True),
                _shuffle_block(nn, torch, w0 * 2, w0 * 2, 1),
            )
            self.stage3 = nn.Sequential(
                _shuffle_block(nn, torch, w0 * 2, w0 * 4, 2, se=True),
                _shuffle_block(nn, torch, w0 * 4, w0 * 4, 1),
            )
            self.stage4 = nn.Sequential(
                _shuffle_block(nn, torch, w0 * 4, w0 * 8, 2, se=True),
                _shuffle_block(nn, torch, w0 * 8, w0 * 8, 1),
            )
            self.lat = nn.ModuleList([
                nn.Conv2d(w0 * 2, neck, 1), nn.Conv2d(w0 * 4, neck, 1),
                nn.Conv2d(w0 * 8, neck, 1),
            ])
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.csp_td = nn.ModuleList([CSPBlock(neck, neck) for _ in range(2)])
            self.dw_down = nn.ModuleList([
                nn.Sequential(
                    nn.Conv2d(neck, neck, 3, 2, 1, groups=neck, bias=False),
                    nn.BatchNorm2d(neck),
                    nn.Conv2d(neck, neck, 1, bias=False),
                    nn.BatchNorm2d(neck), nn.ReLU(),
                )
                for _ in range(3)
            ])
            self.csp_bu = nn.ModuleList([CSPBlock(neck, neck) for _ in range(2)])
            self.cls_head = nn.ModuleList([
                nn.Sequential(
                    nn.Conv2d(neck, neck, 3, 1, 1, groups=neck, bias=False),
                    nn.BatchNorm2d(neck), nn.ReLU(),
                    nn.Conv2d(neck, neck, 1, bias=False),
                    nn.BatchNorm2d(neck), nn.ReLU(),
                    nn.Conv2d(neck, num_classes, 1),
                    nn.Sigmoid(),   # tm_picodet.cpp consumes scores directly
                )
                for _ in range(4)
            ])
            self.dis_head = nn.ModuleList([
                nn.Conv2d(neck, 4 * (reg_max + 1), 1) for _ in range(4)
            ])

        def forward(self, x):
            x = self.stem(x)
            c2 = self.stage2(x)
            c3 = self.stage3(c2)
            c4 = self.stage4(c3)
            p4 = self.lat[2](c4)
            p3 = self.csp_td[0](self.lat[1](c3) + self.up(p4))
            p2 = self.csp_td[1](self.lat[0](c2) + self.up(p3))
            n3 = self.csp_bu[0](p3 + self.dw_down[0](p2))
            n4 = self.csp_bu[1](p4 + self.dw_down[1](n3))
            n5 = self.dw_down[2](n4)
            outs = []
            for lvl, p in enumerate((p2, n3, n4, n5)):
                outs.append(self.cls_head[lvl](p))
            for lvl, p in enumerate((p2, n3, n4, n5)):
                outs.append(self.dis_head[lvl](p))
            return tuple(outs)

    return Net().eval()


def build_picodet_graph(num_classes=80, reg_max=7, img=320, width=32):
    torch, _ = _torch()

    from ..convert.torch_frontend import from_torch
    from ..graph.passes import optimize

    m = PicoDet(num_classes, reg_max, width)
    g = from_torch(m, torch.zeros(1, 3, img, img))
    g.name = "picodet"
    return m, optimize(g)


def decode_picodet(outputs, img, num_classes=80, reg_max=7,
                   strides=(8, 16, 32, 64), score_threshold=0.35):
    """Per-level (cls_pred, dis_pred) decode (tm_picodet.cpp:180-232):
    centers at (x+0.5)*stride, softmax-DFL distances * stride; cls scores
    are already sigmoid outputs."""
    n_lvl = len(strides)
    dets = []
    for lvl, s in enumerate(strides):
        cls = np.asarray(outputs[lvl])[0]                  # [NC, h, w]
        dis = np.asarray(outputs[n_lvl + lvl])[0]          # [4*(R+1), h, w]
        nc, h, w = cls.shape
        c = cls.reshape(nc, -1).T                           # [n, NC]
        d = dis.reshape(4, reg_max + 1, -1).transpose(2, 0, 1)
        dist = (_softmax(d) * np.arange(reg_max + 1)).sum(-1) * s
        best = c.argmax(axis=1)
        score = c[np.arange(c.shape[0]), best]
        keep = score > score_threshold
        if keep.any():
            ys, xs = np.divmod(np.arange(h * w)[keep], w)
            cx, cy = (xs + 0.5) * s, (ys + 0.5) * s
            dk = dist[keep]
            dets.append(np.stack([
                cx - dk[:, 0], cy - dk[:, 1], cx + dk[:, 2], cy + dk[:, 3],
                score[keep], best[keep].astype(np.float64),
            ], axis=1))
    if not dets:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(dets).astype(np.float32)
