"""ResNet-50 (He et al. 2015, arXiv:1512.03385, Table 1, the 50-layer
column) in Caffe style, as Tengine's benchmark model has it: conv 7x7 s2
(ReLU), max-pool 3x3 s2, four stages of 3, 4, 6 and 3 bottlenecks (a 1x1
conv to c_mid (ReLU), a 3x3 conv (ReLU), a 1x1 conv to 4 c_mid, the
Eltwise sum with the shortcut, then a ReLU of its own), global average
pooling, a fully connected layer to the logits. A stage's stride 2 sits in
its first block's first 1x1 conv and in that block's 1x1 projection, the
shortcut of the first block of every stage. Batch norm is folded into the
convolutions' weights and biases; the Softmax is left out (the program's
model ends at the logits).

`params(cfg)` lists every fp32 parameter with the distribution the harness
draws it from; `forward(ctx, p, x)` is the network over the ops of
hbench/reference/qsim.py. Op names are the output tensors' names in the
model the harness builds for the program (hbench/models/resnet50.py), so
the two sides' grids can be compared by name.
"""

from __future__ import annotations

import math


def blocks(cfg: dict):
    """(name, c_mid, c_out, stride, has projection) of every bottleneck."""
    out = []
    for stage, (c_mid, depth) in enumerate(zip(cfg["widths"], cfg["depths"])):
        for i in range(depth):
            out.append((f"res{stage + 2}{chr(ord('a') + i)}", c_mid, cfg["expansion"] * c_mid,
                        2 if (i == 0 and stage > 0) else 1, i == 0))
    return out


def params(cfg: dict):
    """(name, shape, mean, std) of every parameter: He-normal weights with
    batch norm folded away, each block's last conv and its projection at
    half that, biases N(0, 0.05^2)."""
    out = []

    def conv(name, c_out, c_in, k, gain=1.0):
        out.append((f"{name}.w", (c_out, c_in, k, k), 0.0, gain * math.sqrt(2.0 / (c_in * k * k))))
        out.append((f"{name}.b", (c_out,), 0.0, 0.05))

    c = cfg["stem_width"]
    conv("conv1", c, 3, 7)
    for name, c_mid, c_out, _, proj in blocks(cfg):
        conv(f"{name}.c1", c_mid, c, 1)
        conv(f"{name}.c2", c_mid, c_mid, 3)
        conv(f"{name}.c3", c_out, c_mid, 1, gain=0.5)
        if proj:
            conv(f"{name}.c4", c_out, c, 1, gain=0.5)
        c = c_out
    out.append(("fc.w", (cfg["classes"], c), 0.0, math.sqrt(1.0 / c)))
    out.append(("fc.b", (cfg["classes"],), 0.0, 0.05))
    return out


def forward(ctx, p, x, cfg):
    """The logits [N, classes, 1, 1]."""
    t = ctx.input("data", x)
    t = ctx.conv("conv1.out", t, p["conv1.w"], p["conv1.b"], 2, 3, 1, "relu")
    t = ctx.maxpool("pool1.out", t, 3, 2, 1)
    for name, _, _, stride, proj in blocks(cfg):
        m = ctx.conv(f"{name}.c1.out", t, p[f"{name}.c1.w"], p[f"{name}.c1.b"], stride, 0, 1,
                     "relu")
        m = ctx.conv(f"{name}.c2.out", m, p[f"{name}.c2.w"], p[f"{name}.c2.b"], 1, 1, 1, "relu")
        m = ctx.conv(f"{name}.c3.out", m, p[f"{name}.c3.w"], p[f"{name}.c3.b"])
        r = t
        if proj:
            r = ctx.conv(f"{name}.c4.out", t, p[f"{name}.c4.w"], p[f"{name}.c4.b"], stride)
        t = ctx.relu(f"{name}.relu", ctx.add(f"{name}.sum", m, r))
    t = ctx.global_avgpool("pool5.out", t)
    return [ctx.fc("fc.out", t, p["fc.w"], p["fc.b"])]


def grid_names(cfg: dict):
    """Inner grids compared with the program's by name: every op output."""
    names = ["conv1.out", "pool1.out"]
    for name, _, _, _, proj in blocks(cfg):
        names += [f"{name}.c1.out", f"{name}.c2.out", f"{name}.c3.out"]
        names += [f"{name}.c4.out"] if proj else []
        names += [f"{name}.sum", f"{name}.relu"]
    return names + ["pool5.out"]
