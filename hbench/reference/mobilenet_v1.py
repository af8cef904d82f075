"""MobileNet-v1 (Howard et al. 2017, arXiv:1704.04861, Table 1) in Caffe
style, as Tengine's benchmark model has it: conv 3x3 s2 (ReLU), 13 blocks
of a depthwise 3x3 conv (ReLU) and a pointwise 1x1 conv (ReLU), global
average pooling, a fully connected layer to the logits. Batch norm is
folded into the convolutions' weights and biases; the Softmax is left out
(the program's model ends at the logits).

`params(cfg)` lists every fp32 parameter with the distribution the harness
draws it from; `forward(ctx, p, x)` is the network over the ops of
hbench/reference/qsim.py. Op names are the output tensors' names in the
model the harness builds for the program (hbench/models/mobilenet_v1.py),
so the two sides' grids can be compared by name.
"""

from __future__ import annotations

import math


def params(cfg: dict):
    """(name, shape, mean, std) of every parameter: He-normal weights with
    batch norm folded away, biases N(0, 0.05^2)."""
    widths, strides = cfg["widths"], cfg["strides"]
    out = []

    def conv(name, c_out, c_in_g, k):
        out.append((f"{name}.w", (c_out, c_in_g, k, k), 0.0, math.sqrt(2.0 / (c_in_g * k * k))))
        out.append((f"{name}.b", (c_out,), 0.0, 0.05))

    conv("conv1", widths[0], 3, 3)
    for i in range(len(strides)):
        conv(f"conv{i + 2}_dw", widths[i], 1, 3)
        conv(f"conv{i + 2}_pw", widths[i + 1], widths[i], 1)
    c = widths[-1]
    out.append(("fc7.w", (cfg["classes"], c), 0.0, math.sqrt(1.0 / c)))
    out.append(("fc7.b", (cfg["classes"],), 0.0, 0.05))
    return out


def forward(ctx, p, x, cfg):
    """The logits [N, classes, 1, 1]."""
    widths, strides = cfg["widths"], cfg["strides"]
    t = ctx.input("data", x)
    t = ctx.conv("conv1.out", t, p["conv1.w"], p["conv1.b"], 2, 1, 1, "relu")
    for i, s in enumerate(strides):
        n = f"conv{i + 2}"
        t = ctx.conv(f"{n}_dw.out", t, p[f"{n}_dw.w"], p[f"{n}_dw.b"], s, 1, widths[i], "relu")
        t = ctx.conv(f"{n}_pw.out", t, p[f"{n}_pw.w"], p[f"{n}_pw.b"], 1, 0, 1, "relu")
    t = ctx.global_avgpool("pool6.out", t)
    return [ctx.fc("fc7.out", t, p["fc7.w"], p["fc7.b"])]


def grid_names(cfg: dict):
    """Inner grids compared with the program's by name: every op output."""
    names = ["conv1.out"]
    for i in range(len(cfg["strides"])):
        names += [f"conv{i + 2}_dw.out", f"conv{i + 2}_pw.out"]
    return names + ["pool6.out"]
