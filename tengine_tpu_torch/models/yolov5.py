"""Clean-room YOLOv5s (v5.0 architecture) — BASELINE.json config 4.

The reference supports yolov5s via offline ONNX surgery (removing the Focus
slices and the host-side detect decode, `tools/optimize/yolov5s-opt.py`) and
an example app (`examples/tm_yolov5s.cpp`). Here the model is defined as a
torch module (written from the public architecture description: CSPDarknet
backbone with Focus stem, C3 blocks, SPP, PANet neck, three 1x1 detect
heads) and imported through the torch.fx front-end — the Focus slices are
folded into the stem conv by passes.fuse_focus, and only the anchor decode +
NMS run host-side, exactly like the reference app.

PyTorch port: a copy of tengine_tpu/models/yolov5.py — the same module, the
same seed-0 weights and the same pass sequence, so both packages build the
same IR.
"""

from __future__ import annotations

import math
from typing import Optional

__all__ = ["YOLOv5", "build_yolov5s_graph", "YOLOV5_ANCHORS", "YOLOV5_STRIDES"]

# yolov5s anchors (models/yolov5s.yaml upstream), per stride
YOLOV5_STRIDES = (8, 16, 32)
YOLOV5_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),      # P3/8
    ((30, 61), (62, 45), (59, 119)),     # P4/16
    ((116, 90), (156, 198), (373, 326)), # P5/32
)


def _torch_modules(width: float, depth: float, num_classes: int):
    import torch
    import torch.nn as nn

    def cdiv(c):  # width-scaled channels, rounded to multiple of 8
        return max(int(round(c * width / 8)) * 8, 8)

    def rep(n):  # depth-scaled block repeats
        return max(round(n * depth), 1)

    class ConvBNSiLU(nn.Module):
        def __init__(self, c1, c2, k=1, s=1, p=None, g=1):
            super().__init__()
            p = k // 2 if p is None else p
            self.conv = nn.Conv2d(c1, c2, k, s, p, groups=g, bias=False)
            self.bn = nn.BatchNorm2d(c2)
            self.act = nn.SiLU()

        def forward(self, x):
            return self.act(self.bn(self.conv(x)))

    class Bottleneck(nn.Module):
        def __init__(self, c1, c2, shortcut=True, e=0.5):
            super().__init__()
            ch = int(c2 * e)
            self.cv1 = ConvBNSiLU(c1, ch, 1)
            self.cv2 = ConvBNSiLU(ch, c2, 3)
            self.add = shortcut and c1 == c2

        def forward(self, x):
            y = self.cv2(self.cv1(x))
            return x + y if self.add else y

    class C3(nn.Module):
        def __init__(self, c1, c2, n=1, shortcut=True, e=0.5):
            super().__init__()
            ch = int(c2 * e)
            self.cv1 = ConvBNSiLU(c1, ch, 1)
            self.cv2 = ConvBNSiLU(c1, ch, 1)
            self.cv3 = ConvBNSiLU(2 * ch, c2, 1)
            self.m = nn.Sequential(
                *(Bottleneck(ch, ch, shortcut, e=1.0) for _ in range(n))
            )

        def forward(self, x):
            return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))

    class Focus(nn.Module):
        """Space-to-depth stem: concat of the 4 stride-2 pixel phases."""

        def __init__(self, c1, c2, k=3):
            super().__init__()
            self.conv = ConvBNSiLU(c1 * 4, c2, k)

        def forward(self, x):
            return self.conv(
                torch.cat(
                    (
                        x[..., ::2, ::2],
                        x[..., 1::2, ::2],
                        x[..., ::2, 1::2],
                        x[..., 1::2, 1::2],
                    ),
                    1,
                )
            )

    class SPP(nn.Module):
        def __init__(self, c1, c2, ks=(5, 9, 13)):
            super().__init__()
            ch = c1 // 2
            self.cv1 = ConvBNSiLU(c1, ch, 1)
            self.m = nn.ModuleList(
                nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2) for k in ks
            )
            self.cv2 = ConvBNSiLU(ch * (len(ks) + 1), c2, 1)

        def forward(self, x):
            x = self.cv1(x)
            return self.cv2(torch.cat([x] + [m(x) for m in self.m], 1))

    return cdiv, rep, ConvBNSiLU, Bottleneck, C3, Focus, SPP


def YOLOv5(num_classes: int = 80, width: float = 0.50, depth: float = 0.33):
    """Build the torch module. Outputs the three RAW head maps
    [N, 3*(5+nc), H/8, W/8], [.../16], [.../32] — decode is host-side
    (tm_yolov5s.cpp does the same)."""
    import torch
    import torch.nn as nn

    cdiv, rep, Conv, _Bn, C3, Focus, SPP = _torch_modules(width, depth, num_classes)
    no = 3 * (5 + num_classes)

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            c64, c128, c256, c512, c1024 = (cdiv(c) for c in (64, 128, 256, 512, 1024))
            # backbone (CSPDarknet)
            self.stem = Focus(3, c64)
            self.b1 = Conv(c64, c128, 3, 2)
            self.c1 = C3(c128, c128, rep(3))
            self.b2 = Conv(c128, c256, 3, 2)
            self.c2 = C3(c256, c256, rep(9))      # -> P3 skip
            self.b3 = Conv(c256, c512, 3, 2)
            self.c3 = C3(c512, c512, rep(9))      # -> P4 skip
            self.b4 = Conv(c512, c1024, 3, 2)
            self.spp = SPP(c1024, c1024)
            self.c4 = C3(c1024, c1024, rep(3), shortcut=False)
            # PANet neck
            self.n1 = Conv(c1024, c512, 1, 1)
            self.up = nn.Upsample(scale_factor=2.0, mode="nearest")
            self.nc3a = C3(c1024, c512, rep(3), shortcut=False)
            self.n2 = Conv(c512, c256, 1, 1)
            self.nc3b = C3(c512, c256, rep(3), shortcut=False)   # -> P3 out
            self.d1 = Conv(c256, c256, 3, 2)
            self.nc3c = C3(c512, c512, rep(3), shortcut=False)   # -> P4 out
            self.d2 = Conv(c512, c512, 3, 2)
            self.nc3d = C3(c1024, c1024, rep(3), shortcut=False) # -> P5 out
            # detect heads
            self.h3 = nn.Conv2d(c256, no, 1)
            self.h4 = nn.Conv2d(c512, no, 1)
            self.h5 = nn.Conv2d(c1024, no, 1)

        def forward(self, x):
            x = self.stem(x)
            x = self.c1(self.b1(x))
            p3 = self.c2(self.b2(x))
            p4 = self.c3(self.b3(p3))
            p5 = self.c4(self.spp(self.b4(p4)))
            t5 = self.n1(p5)
            m4 = self.nc3a(torch.cat((self.up(t5), p4), 1))
            t4 = self.n2(m4)
            o3 = self.nc3b(torch.cat((self.up(t4), p3), 1))
            o4 = self.nc3c(torch.cat((self.d1(o3), t4), 1))
            o5 = self.nc3d(torch.cat((self.d2(o4), t5), 1))
            return self.h3(o3), self.h4(o4), self.h5(o5)

    m = Model().eval()
    # deterministic, well-scaled random weights (benchmark nets are
    # weight-stripped in the reference too, tm2_serializer.c:241-246)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            if p.ndim > 1:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        for mod in m.modules():
            import torch.nn as nn

            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=gen) * 0.1)
                mod.running_var.copy_(1.0 + 0.1 * torch.rand(mod.running_var.shape, generator=gen))
    return m


def build_yolov5s_graph(
    num_classes: int = 80,
    img: int = 640,
    fold_bn: bool = True,
    batch: int = 1,
    fuse_silu: bool = True,
    fold_focus: bool = True,
):
    """torch YOLOv5s -> IR Graph (via the fx front-end) + the torch oracle.

    fuse_silu=False keeps the explicit Sigmoid/Mul nodes — needed when the
    graph is exported to a tmfile for the reference C engine, whose conv
    kernels don't know our ACT_SILU epilogue code. fold_focus=False keeps
    the Focus stem as explicit StridedSlice/Concat nodes (see
    passes.fuse_focus)."""
    import torch

    from ..convert.torch_frontend import from_torch
    from ..graph import passes

    m = YOLOv5(num_classes=num_classes)
    ex = torch.zeros(batch, 3, img, img)
    g = from_torch(m, ex)
    g.name = "yolov5s"
    if fold_bn:
        passes.fold_batchnorm(g)
        passes.fuse_activation(g)
        if fuse_silu:
            passes.fuse_silu(g)
        if fold_focus:
            passes.fuse_focus(g)
        passes.decompose_spp(g)
        if fold_focus:
            passes.ensure_shapes(g)
            passes.split_concat_conv1x1(g)
        passes.dce(g)
    return m, g
