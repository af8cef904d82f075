"""YOLOv5s v5.0 (ultralytics/yolov5 v5.0 models/yolov5s.yaml: depth_multiple
0.33, width_multiple 0.50; Focus stem, C3 blocks, SPP, PANet neck, three
1x1 detect heads) as plain functions over hbench/reference/qsim.py.

Parameters carry the names of the torch module the harness imports into the
program (hbench/models/yolov5s.py), so one dict of fp32 tensors feeds both.
Each Conv is conv (no bias) -> BatchNorm2d (eps 1e-5) -> SiLU; batch norm is
folded into the conv here, in float64. The heads are the raw maps
[N, 3 * (5 + classes), H / s, W / s] for s = 8, 16, 32; the anchor decode
and NMS run on the host and are not part of the network.

The quantized network is the one the import's pass sequence defines: there
no channel concat is kept, for every concat feeds only 1x1 convs; each such
conv is the sum of one partial conv a concatenated input, on grids of their
own, with its activation after the last sum. (A concat requantized onto one
grid, as a graph that keeps it would have, puts branches whose ranges lie
two orders apart on the wider one's grid and rounds the narrow branch away.)
Op names are the program's tensor names, so the grids compare by name.
"""

from __future__ import annotations

import math

BN_EPS = 1e-5


def _layout(cfg: dict):
    """The network's Conv layers (name, c_in, c_out, k, stride) in the
    module's order, and the C3 blocks (name, c_in, c_out, n, shortcut)."""
    w, d = cfg["width_multiple"], cfg["depth_multiple"]

    def ch(c):
        return max(int(round(c * w / 8)) * 8, 8)

    def rep(n):
        return max(round(n * d), 1)

    c64, c128, c256, c512, c1024 = (ch(c) for c in (64, 128, 256, 512, 1024))
    convs, c3s = [], []

    def conv(name, c1, c2, k=1, s=1):
        convs.append((name, c1, c2, k, s))

    def c3(name, c1, c2, n, shortcut=True):
        c_ = c2 // 2
        conv(f"{name}.cv1", c1, c_)
        conv(f"{name}.cv2", c1, c_)
        conv(f"{name}.cv3", 2 * c_, c2)
        for i in range(n):
            conv(f"{name}.m.{i}.cv1", c_, c_)
            conv(f"{name}.m.{i}.cv2", c_, c_, 3)
        c3s.append((name, c1, c2, n, shortcut))

    conv("stem.conv", 12, c64, 3)
    conv("b1", c64, c128, 3, 2)
    c3("c1", c128, c128, rep(3))
    conv("b2", c128, c256, 3, 2)
    c3("c2", c256, c256, rep(9))
    conv("b3", c256, c512, 3, 2)
    c3("c3", c512, c512, rep(9))
    conv("b4", c512, c1024, 3, 2)
    conv("spp.cv1", c1024, c1024 // 2)
    conv("spp.cv2", c1024 // 2 * 4, c1024)
    c3("c4", c1024, c1024, rep(3), False)
    conv("n1", c1024, c512)
    c3("nc3a", c1024, c512, rep(3), False)
    conv("n2", c512, c256)
    c3("nc3b", c512, c256, rep(3), False)
    conv("d1", c256, c256, 3, 2)
    c3("nc3c", c512, c512, rep(3), False)
    conv("d2", c512, c512, 3, 2)
    c3("nc3d", c1024, c1024, rep(3), False)
    heads = [("h3", c256), ("h4", c512), ("h5", c1024)]
    return convs, {name: (n, sc) for name, _, _, n, sc in c3s}, heads


def params(cfg: dict):
    """(name, shape, mean, std, abs) of every parameter and batch-norm
    buffer, from the configuration's `init`: conv weights N(0, gain /
    fan_in), batch norm's gamma N(gamma_mean, gamma_std^2), beta and running
    mean N(0, beta_std^2) and N(0, mean_std^2), running var 1 + |N(0,
    var_std^2)|; the heads' weights N(0, 1 / fan_in), their biases N(0,
    head_bias_std^2)."""
    init = cfg["init"]
    convs, _, heads = _layout(cfg)
    no = 3 * (5 + cfg["classes"])
    out = []
    for name, c1, c2, k, _ in convs:
        out.append((f"{name}.conv.weight", (c2, c1, k, k), 0.0,
                    math.sqrt(init["conv_gain"] / (c1 * k * k)), False))
        out.append((f"{name}.bn.weight", (c2,), init["gamma_mean"], init["gamma_std"], False))
        out.append((f"{name}.bn.bias", (c2,), 0.0, init["beta_std"], False))
        out.append((f"{name}.bn.running_mean", (c2,), 0.0, init["mean_std"], False))
        out.append((f"{name}.bn.running_var", (c2,), 1.0, init["var_std"], True))
    for name, c in heads:
        out.append((f"{name}.weight", (no, c, 1, 1), 0.0, math.sqrt(1.0 / c), False))
        out.append((f"{name}.bias", (no,), 0.0, init["head_bias_std"], False))
    return out


def _folded(p, name):
    """A Conv's weight and bias with its batch norm folded in (float64)."""
    g = p[f"{name}.bn.weight"].double()
    s = g / (p[f"{name}.bn.running_var"].double() + BN_EPS).sqrt()
    w = p[f"{name}.conv.weight"].double() * s.reshape(-1, 1, 1, 1)
    b = p[f"{name}.bn.bias"].double() - p[f"{name}.bn.running_mean"].double() * s
    return w, b


def forward(ctx, p, x, cfg):
    """The three raw head maps (strides 8, 16, 32)."""
    _, c3s, _ = _layout(cfg)
    folded = {}

    def wb(name):
        if name not in folded:
            folded[name] = _folded(p, name)
        return folded[name]

    def conv(name, t, k=1, s=1):
        w, b = wb(name)
        return ctx.conv(_op(name), t, w, b, s, k // 2, 1, "silu")

    def conv_parts(name, parts):
        """A 1x1 Conv over the channel concat of `parts`, as the sum of one
        partial conv a part (the weight split along its input channels, the
        bias on the first), each on its own grid, summed left to right on
        grids of their own; the activation on the last sum."""
        if len(parts) == 1:
            return conv(name, parts[0])
        if ctx.mode == "count":
            # the least work: one conv over the concat's view, no partial
            # sum stored (the same operations as the parts)
            return conv(name, ctx.concat(f"{_op(name)}/cat", parts))
        w, b = wb(name)
        op, outs, c0 = _op(name), [], 0
        for i, t in enumerate(parts):
            c1 = c0 + int(t.q.shape[1] if hasattr(t, "q") else t.shape[1])
            outs.append(ctx.conv(f"{op}/part{i}", t, w[:, c0:c1], b if i == 0 else None,
                                 1, 0, 1, None))
            c0 = c1
        acc = outs[0]
        for i, o in enumerate(outs[1:-1]):
            acc = ctx.add(f"{op}/psum{i}", acc, o)
        return ctx.add(op, acc, outs[-1], "silu")

    def c3(name, ts):
        n, shortcut = c3s[name]
        a = conv_parts(f"{name}.cv1", ts)
        for i in range(n):
            y = conv(f"{name}.m.{i}.cv2", conv(f"{name}.m.{i}.cv1", a), 3)
            a = ctx.add(f"{name}.m.{i}.add", a, y) if shortcut else y
        return conv_parts(f"{name}.cv3", [a, conv_parts(f"{name}.cv2", ts)])

    def head(name, t):
        return ctx.conv(name, t, p[f"{name}.weight"], p[f"{name}.bias"], 1, 0, 1, None)

    t = ctx.input("data", x)
    t = conv("stem.conv", ctx.space_to_depth("stem.s2d", t), 3)
    t = c3("c1", [conv("b1", t, 3, 2)])
    p3 = c3("c2", [conv("b2", t, 3, 2)])
    p4 = c3("c3", [conv("b3", p3, 3, 2)])
    t = conv("spp.cv1", conv("b4", p4, 3, 2))
    pools = [t]
    for i in range(3):  # 5, 9, 13: a chain of 5x5 pools, exactly as max is
        pools.append(ctx.maxpool(f"spp/m/{i}", pools[-1], 5, 1, 2))
    p5 = c3("c4", [conv_parts("spp.cv2", pools)])
    t5 = conv("n1", p5)
    m4 = c3("nc3a", [ctx.upsample2("up5", t5), p4])
    t4 = conv("n2", m4)
    o3 = c3("nc3b", [ctx.upsample2("up4", t4), p3])
    o4 = c3("nc3c", [conv("d1", o3, 3, 2), t4])
    o5 = c3("nc3d", [conv("d2", o4, 3, 2), t5])
    return [head("h3", o3), head("h4", o4), head("h5", o5)]


def _op(name: str) -> str:
    """The output tensor's name of Conv `name` in the program's import of
    hbench/models/yolov5s.py: the module's path with slashes, then /conv."""
    return name.replace(".", "/") + "/conv"


def grid_names(cfg: dict):
    """Inner grids compared with the program's by name: every Conv's output
    (after its activation; for a 1x1 Conv over a concat, the last sum)."""
    convs, _, _ = _layout(cfg)
    return [_op(name) for name, *_ in convs]
