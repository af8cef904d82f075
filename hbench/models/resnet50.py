"""ResNet-50 built for the program as its own IR graph, from the fp32
parameters the harness drew (names and layers of
hbench/reference/resnet50.py). The graph is the one of the repository's
chip_smoke.py:build_resnet50_graph (Caffe style, as Tengine's benchmark
model has it: the Eltwise sum, then a ReLu node of its own), kept here so
that the benchmark's model does not move with the program."""

from __future__ import annotations

import numpy as np

from hbench.reference.resnet50 import blocks


def build(cfg: dict, p: dict):
    """The fp32 IR graph [1, 3, img, img] -> logits [1, classes, 1, 1]; `p`
    maps each parameter's name to a float32 numpy array."""
    from tengine_tpu_torch.graph import ir

    DType, TensorType = ir.DType, ir.TensorType
    img = cfg["img"]
    g = ir.Graph(name=f"resnet50-{img}")

    def conv(name, x, k, stride=1, pad=0, act=-1):
        n, c_in, h, w = x.shape
        c_out = p[f"{name}.w"].shape[0]
        wt = g.add_tensor(f"{name}.w", DType.FP32, [c_out, c_in, k, k], TensorType.CONST,
                          data=np.ascontiguousarray(p[f"{name}.w"]))
        bt = g.add_tensor(f"{name}.b", DType.FP32, [c_out], TensorType.CONST,
                          data=np.ascontiguousarray(p[f"{name}.b"]))
        oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        y = g.add_tensor(f"{name}.out", DType.FP32, [n, c_out, oh, ow], TensorType.VAR)
        g.add_node("Convolution", name, [x.idx, wt.idx, bt.idx], [y.idx], dict(
            kernel_h=k, kernel_w=k, stride_h=stride, stride_w=stride, dilation_h=1,
            dilation_w=1, input_channel=c_in, output_channel=c_out, group=1, activation=act,
            pad_h0=pad, pad_w0=pad, pad_h1=pad, pad_w1=pad))
        return y

    x = g.add_tensor("data", DType.FP32, [1, 3, img, img], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    g.inputs = [inp.idx]
    t = conv("conv1", x, 7, stride=2, pad=3, act=0)
    n, c, h, w = t.shape
    ph, pw = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    pooled = g.add_tensor("pool1.out", DType.FP32, [n, c, ph, pw], TensorType.VAR)
    g.add_node("Pooling", "pool1", [t.idx], [pooled.idx], dict(
        alg=0, kernel_h=3, kernel_w=3, stride_h=2, stride_w=2, global_pool=0, caffe_flavor=0,
        pad_h0=1, pad_w0=1, pad_h1=1, pad_w1=1))
    t = pooled
    for name, _, _, stride, proj in blocks(cfg):
        m = conv(f"{name}.c1", t, 1, stride=stride, act=0)
        m = conv(f"{name}.c2", m, 3, pad=1, act=0)
        m = conv(f"{name}.c3", m, 1)
        r = conv(f"{name}.c4", t, 1, stride=stride) if proj else t
        s = g.add_tensor(f"{name}.sum", DType.FP32, list(m.shape), TensorType.VAR)
        g.add_node("Eltwise", f"{name}.add", [m.idx, r.idx], [s.idx], dict(type=2))  # ELT_SUM
        t = g.add_tensor(f"{name}.relu", DType.FP32, list(m.shape), TensorType.VAR)
        g.add_node("ReLu", f"{name}.r", [s.idx], [t.idx], dict(negative_slope=0.0))
    n, c, h, w = t.shape
    gap = g.add_tensor("pool5.out", DType.FP32, [n, c, 1, 1], TensorType.VAR)
    g.add_node("Pooling", "pool5", [t.idx], [gap.idx], dict(
        alg=1, kernel_h=h, kernel_w=w, stride_h=1, stride_w=1, global_pool=1, caffe_flavor=0,
        pad_h0=0, pad_w0=0, pad_h1=0, pad_w1=0))
    classes = cfg["classes"]
    wt = g.add_tensor("fc.w", DType.FP32, [classes, c], TensorType.CONST,
                      data=np.ascontiguousarray(p["fc.w"]))
    bt = g.add_tensor("fc.b", DType.FP32, [classes], TensorType.CONST,
                      data=np.ascontiguousarray(p["fc.b"]))
    out = g.add_tensor("fc.out", DType.FP32, [n, classes, 1, 1], TensorType.VAR)
    fc = g.add_node("FullyConnected", "fc", [gap.idx, wt.idx, bt.idx], [out.idx],
                    dict(num_output=classes))
    g.outputs = [fc.idx]
    return g
