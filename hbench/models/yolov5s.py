"""YOLOv5s v5.0 as a torch module, imported into the program through its
public torch front end (tengine_tpu_torch.convert.torch_frontend.from_torch)
and the pass sequence that tengine_tpu_torch.models.yolov5.build_yolov5s_graph
applies, so that a change to the import layer is measured too.

The module is a copy of the repository's tengine_tpu_torch/models/yolov5.py
(CSPDarknet backbone with Focus stem, C3 blocks, SPP, PANet neck, three 1x1
detect heads), kept here so that the benchmark's model does not move with the
program. Its parameters are the fp32 tensors the harness drew, by the names of
hbench/reference/yolov5s.py."""

from __future__ import annotations


def _module(cfg: dict):
    import torch
    import torch.nn as nn

    width, depth, nc = cfg["width_multiple"], cfg["depth_multiple"], cfg["classes"]

    def ch(c):
        return max(int(round(c * width / 8)) * 8, 8)

    def rep(n):
        return max(round(n * depth), 1)

    class Conv(nn.Module):
        def __init__(self, c1, c2, k=1, s=1):
            super().__init__()
            self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
            self.bn = nn.BatchNorm2d(c2)
            self.act = nn.SiLU()

        def forward(self, x):
            return self.act(self.bn(self.conv(x)))

    class Bottleneck(nn.Module):
        def __init__(self, c1, c2, shortcut=True):
            super().__init__()
            self.cv1 = Conv(c1, c2, 1)
            self.cv2 = Conv(c2, c2, 3)
            self.add = shortcut and c1 == c2

        def forward(self, x):
            y = self.cv2(self.cv1(x))
            return x + y if self.add else y

    class C3(nn.Module):
        def __init__(self, c1, c2, n=1, shortcut=True):
            super().__init__()
            c_ = c2 // 2
            self.cv1 = Conv(c1, c_, 1)
            self.cv2 = Conv(c1, c_, 1)
            self.cv3 = Conv(2 * c_, c2, 1)
            self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut) for _ in range(n)))

        def forward(self, x):
            return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))

    class Focus(nn.Module):
        def __init__(self, c1, c2, k=3):
            super().__init__()
            self.conv = Conv(c1 * 4, c2, k)

        def forward(self, x):
            return self.conv(torch.cat((x[..., ::2, ::2], x[..., 1::2, ::2],
                                        x[..., ::2, 1::2], x[..., 1::2, 1::2]), 1))

    class SPP(nn.Module):
        def __init__(self, c1, c2, ks=(5, 9, 13)):
            super().__init__()
            c_ = c1 // 2
            self.cv1 = Conv(c1, c_, 1)
            self.m = nn.ModuleList(nn.MaxPool2d(k, 1, k // 2) for k in ks)
            self.cv2 = Conv(c_ * (len(ks) + 1), c2, 1)

        def forward(self, x):
            x = self.cv1(x)
            return self.cv2(torch.cat([x] + [m(x) for m in self.m], 1))

    no = 3 * (5 + nc)

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            c64, c128, c256, c512, c1024 = (ch(c) for c in (64, 128, 256, 512, 1024))
            self.stem = Focus(3, c64)
            self.b1 = Conv(c64, c128, 3, 2)
            self.c1 = C3(c128, c128, rep(3))
            self.b2 = Conv(c128, c256, 3, 2)
            self.c2 = C3(c256, c256, rep(9))
            self.b3 = Conv(c256, c512, 3, 2)
            self.c3 = C3(c512, c512, rep(9))
            self.b4 = Conv(c512, c1024, 3, 2)
            self.spp = SPP(c1024, c1024)
            self.c4 = C3(c1024, c1024, rep(3), False)
            self.n1 = Conv(c1024, c512, 1, 1)
            self.up = nn.Upsample(scale_factor=2.0, mode="nearest")
            self.nc3a = C3(c1024, c512, rep(3), False)
            self.n2 = Conv(c512, c256, 1, 1)
            self.nc3b = C3(c512, c256, rep(3), False)
            self.d1 = Conv(c256, c256, 3, 2)
            self.nc3c = C3(c512, c512, rep(3), False)
            self.d2 = Conv(c512, c512, 3, 2)
            self.nc3d = C3(c1024, c1024, rep(3), False)
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

    return Model().eval()


def build(cfg: dict, p: dict):
    """The fp32 IR graph [1, 3, img, img] -> the three raw head maps, through
    the program's torch import and its yolov5s pass sequence; `p` maps each
    parameter's name to a float32 numpy array."""
    import torch

    from tengine_tpu_torch.convert.torch_frontend import from_torch
    from tengine_tpu_torch.graph import passes

    m = _module(cfg)
    state = m.state_dict()
    want = {k for k in state if not k.endswith("num_batches_tracked")}
    if want != set(p):
        raise KeyError(f"parameters differ from the module's: missing "
                       f"{sorted(want - set(p))[:5]}, extra {sorted(set(p) - want)[:5]}")
    with torch.no_grad():
        for k in want:
            if tuple(state[k].shape) != tuple(p[k].shape):
                raise ValueError(f"{k}: shape {tuple(p[k].shape)}, the module's "
                                 f"{tuple(state[k].shape)}")
            state[k].copy_(torch.from_numpy(p[k]))
    g = from_torch(m, torch.zeros(1, 3, cfg["img"], cfg["img"]))
    g.name = "yolov5s"
    passes.fold_batchnorm(g)
    passes.fuse_activation(g)
    passes.fuse_silu(g)
    passes.fuse_focus(g)
    passes.decompose_spp(g)
    passes.ensure_shapes(g)
    passes.split_concat_conv1x1(g)
    passes.dce(g)
    return g
