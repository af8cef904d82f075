"""MobileNet-v1 built for the program as its own IR graph, from the fp32
parameters the harness drew (names and layers of
hbench/reference/mobilenet_v1.py). The graph is the one of the repository's
chip_smoke.py:build_mobilenet_v1_graph (Caffe style, as Tengine's benchmark
model has it), kept here so that the benchmark's model does not move with
the program."""

from __future__ import annotations

import numpy as np


def build(cfg: dict, p: dict):
    """The fp32 IR graph [1, 3, img, img] -> logits [1, classes, 1, 1]; `p`
    maps each parameter's name to a float32 numpy array."""
    from tengine_tpu_torch.graph import ir

    DType, TensorType = ir.DType, ir.TensorType
    widths, strides, img = cfg["widths"], cfg["strides"], cfg["img"]
    g = ir.Graph(name=f"mobilenet-v1-{img}")

    def conv(name, x, c_out, k, stride=1, pad=0, group=1):
        n, c_in, h, w = x.shape
        wt = g.add_tensor(f"{name}.w", DType.FP32, [c_out, c_in // group, k, k],
                          TensorType.CONST, data=np.ascontiguousarray(p[f"{name}.w"]))
        bt = g.add_tensor(f"{name}.b", DType.FP32, [c_out], TensorType.CONST,
                          data=np.ascontiguousarray(p[f"{name}.b"]))
        oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        y = g.add_tensor(f"{name}.out", DType.FP32, [n, c_out, oh, ow], TensorType.VAR)
        g.add_node("Convolution", name, [x.idx, wt.idx, bt.idx], [y.idx], dict(
            kernel_h=k, kernel_w=k, stride_h=stride, stride_w=stride, dilation_h=1,
            dilation_w=1, input_channel=c_in, output_channel=c_out, group=group, activation=0,
            pad_h0=pad, pad_w0=pad, pad_h1=pad, pad_w1=pad))
        return y

    x = g.add_tensor("data", DType.FP32, [1, 3, img, img], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    g.inputs = [inp.idx]
    t = conv("conv1", x, widths[0], 3, stride=2, pad=1)
    for i, stride in enumerate(strides):
        c = widths[i]
        t = conv(f"conv{i + 2}_dw", t, c, 3, stride=stride, pad=1, group=c)
        t = conv(f"conv{i + 2}_pw", t, widths[i + 1], 1)
    n, c, h, w = t.shape
    gap = g.add_tensor("pool6.out", DType.FP32, [n, c, 1, 1], TensorType.VAR)
    g.add_node("Pooling", "pool6", [t.idx], [gap.idx], dict(
        alg=1, kernel_h=h, kernel_w=w, stride_h=1, stride_w=1, global_pool=1, caffe_flavor=0,
        pad_h0=0, pad_w0=0, pad_h1=0, pad_w1=0))
    classes = cfg["classes"]
    wt = g.add_tensor("fc7.w", DType.FP32, [classes, c], TensorType.CONST,
                      data=np.ascontiguousarray(p["fc7.w"]))
    bt = g.add_tensor("fc7.b", DType.FP32, [classes], TensorType.CONST,
                      data=np.ascontiguousarray(p["fc7.b"]))
    out = g.add_tensor("fc7.out", DType.FP32, [n, classes, 1, 1], TensorType.VAR)
    fc = g.add_node("FullyConnected", "fc7", [gap.idx, wt.idx, bt.idx], [out.idx],
                    dict(num_output=classes))
    g.outputs = [fc.idx]
    return g
