#!/usr/bin/env python3
"""Run the PyTorch port (tengine_tpu_torch) on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # the check, on one card
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one
                                     # yolov5s batch, one yolov3 batch (A), one
                                     # YOLO-Fastest batch (D, int8), one
                                     # ResNet-50 batch each under F and H, and
                                     # one batch of each of tiers I-L
    python3 chip_smoke.py --tiles    # also the implicit-GEMM kernel's time
                                     # under every tile and route at each
                                     # timed shape, and the chain kernel's
                                     # under every spatial tile at each of
                                     # ResNet-50's four chains, and the
                                     # depthwise kernel's under every tile
                                     # at six of its shapes

Phases, in order; any failure raises and the exit code is not 0:
  1. build     nvcc builds every tengine_tpu_torch/csrc/*.cu for sm_90a, one
               process per source, all started together.
  2. kernels   each kernel against its plain version on the card, on the
               test grid (tests/test_torch_cuda.py) and at the main path's
               largest launch shape of its kind; kernel, plain and
               library-call times (CUDA events) and the least time the card
               could take (bound). The int8 implicit-GEMM kernel
               (qconv_direct, qconv1x1, qgemm_requant): the grid and the
               edge cases under the tile it picks and under every tile and
               route forced (wgmma, mma.sync), 0 LSB; the built library's
               SASS must hold tensor-core instructions (IMMA or IGMMA); at
               the three main shapes, three ResNet-50 shapes and two narrow
               YOLO-Fastest shapes the tile picked and the device time, taken by replaying the launches
               from a CUDA graph (the kernels run shorter than their
               wrappers' host time). qblock_chain: its library's SASS must
               hold IMMA and no IDP.4A; the grid, exact and relaxed, under
               every spatial tile and the one picked, then ResNet-50-224's
               four chains at batch 32 (stages 1-4), 0 differing elements
               required, each timed by graph replay. stem_qconv: its
               library's SASS must hold IMMA or IGMMA; the grid and the edge
               cases, int8/uint8 and f32 out, 0 LSB (SiLU within 1), then
               yolov5s-640 b8 timed by graph replay with SiLU and without.
               dw_qconv: the grid and the edge cases under the tile it picks
               and tiles forced, 0 LSB, its library's IDP.2A / IDP.4A / IMAD
               counts printed; then YOLO-Fastest-320 b32's 13 depthwise
               launches (the two 160x160x32 ones int8 and uint8) and
               mobilenet-v1-224 b32's 13, 0 LSB, each timed by graph replay
               beside cuDNN's fp16 depthwise conv, with each net's sum;
               then mobilenet-v1-224's 13 at batch 128 on the native-int8
               plan's grid (int8 input, zp_in -101, the full range
               [-128, 127], ReLU), 0 LSB, timed the same way.
  3. main path yolov5s 640x640 INT8 (MinMax), seed-0 weights: quantize_graph
               on the card with one seeded calibration image, compile_graph
               at batch 8, one untimed forward, 3 timed batches. Then
               yolov3 416x416 INT8 (MinMax, seed-0 weights) on the
               integer-storage tier, one untimed and 3 timed batches of 8
               under each of
                 A  Options(quant_mode="fast", quant_bf16_storage=False):
                    qconv_direct and qconv1x1
                 B  A + pallas_qconv=False, pallas_qgemm=True: qgemm_requant
                 C  A + pallas_qconv=False: every conv on the float64 fast
                    lowering (timed only: the port's own "before").
               Then YOLO-Fastest 320x320 (seed-0 weights, MinMax from one
               seeded image) at batch 32 on the same integer-storage tier,
               INT8 and then UINT8, one untimed and 3 timed batches under
                 D  TT_DW_PALLAS=1: the 13 depthwise convs on dw_qconv, the
                    29 1x1 convs on qconv1x1, the stem on the fast lowering
                 E  TT_DW_PALLAS=0: the 13 on the fast lowering too (the
                    port's own "before").
               Then ResNet-50 224x224 INT8 (build_resnet50_graph below:
               the published widths and depths, seed-0 weights, MinMax from
               one seeded image) at batch 32, one untimed and 3 timed batches
               under each of
                 F  Options(quant_mode="fast", fuse_resblock=True,
                    quant_relaxed=False): the 16 bottlenecks as 4
                    FusedResBlockChain nodes (3, 4, 6, 3 blocks) on
                    qblock_chain, one launch per chain, exact epilogue;
                    stem and FC on the fast lowerings
                 R  F + quant_relaxed=True, quant_native="off": the kernel's
                    relaxed epilogue, one rounding per block
                 G  F without fuse_resblock: the 52 bottleneck convs on the
                    fast lowering with fuse_conv_add (timed only: the port's
                    own "before").
                 H  G + quant_bf16_storage=False, pallas_qgemm=True: conv by
                    conv on the implicit-GEMM kernel, 13 qconv_direct (the
                    3x3 convs with C_in % 128 == 0), 36 qconv1x1 (the fused
                    residual among them), the FC on qgemm_requant; the stem
                    and stage 1's 3x3 convs stay on the fast lowering.
               Then bench.py's own configs under default Options,
               Options(quant_mode="fast", batch_size=128), at 224 and batch
               128 (seed-0 weights, calibrated from one seeded image):
                 I  ResNet-50 INT8, KL calibration: the native-int8 plan
                    (a no-op on a symmetric INT8 graph); no chains, every
                    conv on the fast lowering, no kernel launched
                 J  ResNet-50 UINT8, MinMax: the plan's UINT8 -> INT8
                    shift; no kernel launched
                 K  mobilenet-v1 UINT8, MinMax (build_mobilenet_v1_graph
                    below), TT_DW_PALLAS unset: the default route (no plan
                    on a depthwise net), every conv on the fast lowering
                 L  K with quant_native="on" and TT_DW_PALLAS=1: the plan,
                    the 13 depthwise convs on dw_qconv on shifted INT8.
               Every kernel's launch count is set to 0 just before each
               timed run and read just after; the counts must be exact.
  4. check     every head's dequantized cosine against the port's fp32 engine
               (yolov5s > 0.95, the gate of tests/test_yolov5.py; yolov3
               and YOLO-Fastest > 0.99); each net's card run (each yolov3
               tier's, YOLO-Fastest's D under each scheme, the CPU run
               compiled with the same Options and TT_DW_PALLAS) within
               1 LSB of the port's CPU run on the first image; yolov3's B
               and C heads against A's: within 1 LSB at img=64 batch 2, and
               at 416 (where the two lowerings' host folds round a few
               near-tie elements apart and the difference propagates) a
               dequantized cosine > 0.99, the gate each tier meets against
               fp32. YOLO-Fastest's E heads against D's the same way: at
               img=64 batch 32 within 1 LSB under INT8 and, under UINT8
               (where the dw route folds -zp_in*colsum*m into B in float64
               and the fast lowering adds it as a second f32 term, so two
               depthwise layers part by 1 LSB on a few elements in 100,000),
               within 8 LSB with 85% of the elements equal; at 320 the
               cosine gate. ResNet-50: the logits' dequantized cosine against
               the fp32 engine > 0.99 under F, R, G and H, top-1 agreement
               printed; F and H on the card within 1 LSB of the port's CPU
               run on the first image; H against G by cosine > 0.99; G against F within 1 LSB at img=32 with
               widths/8 and depths (2, 2, 2, 2), and by cosine > 0.99 at 224;
               R against F by cosine > 0.99 at 224 and, at the output of the
               full-width stage-1 chain (img=64, 3 bottlenecks, no head), by
               the relaxed tier's own bounds (tests/test_relaxed_tier.py: at
               most 6 LSB, under 10% beyond 1 LSB, under 1% beyond 3; 16
               blocks on, at the logits, each skipped rounding has spread and
               those bounds no longer describe it). Tiers I-L: the
               logits' dequantized cosine against the fp32 engine > 0.99,
               top-1 agreement printed; each within 1 LSB of the port's CPU
               run (same Options and TT_DW_PALLAS, same routes) on the first
               image; I against R on the first 32 images and L against K by
               cosine > 0.99.

The last lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}. Nothing here imports JAX or
the JAX package; without a card, or without the package beside it, the
script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same sheet

# yolov3-416 batch 8: the largest launch of each kernel on the main path, by
# bytes moved (from the IR: the stride-2 3x3 conv 104x104x128 -> 52x52x256,
# the 1x1 conv 208x208x64 -> 32, the 1x1 conv 52x52x384 -> 128 of the third
# head)
YOLOV3_DIRECT = dict(N=8, H=104, C=128, O=256, k=3, s=2, pad=1)
YOLOV3_1X1 = dict(M=8 * 208 * 208, K=64, N=32)
YOLOV3_QGEMM = dict(M=8 * 52 * 52, K=384, N=128)
# the integer-storage tiers of phase 3 and their launches per forward
YOLOV3_TIERS = {
    "A": (dict(), {"qconv_direct": 32, "qconv1x1": 37, "qgemm_requant": 0, "stem_qconv": 0}),
    "B": (dict(pallas_qconv=False, pallas_qgemm=True),
          {"qconv_direct": 0, "qconv1x1": 0, "qgemm_requant": 34, "stem_qconv": 0}),
    "C": (dict(pallas_qconv=False),
          {"qconv_direct": 0, "qconv1x1": 0, "qgemm_requant": 0, "stem_qconv": 0}),
}
# YOLO-Fastest-320 batch 32: the largest dw_qconv launch of each stride (the
# first two depthwise convs, 160x160x32), and the tiers of phase 3c with the
# value of TT_DW_PALLAS, the launches per forward and the convs left on the
# fast lowering
FASTEST_BATCH = 32
FASTEST_DW = dict(N=32, H=160, C=32, k=3, pad=1)
# YOLO-Fastest-320 batch 32's depthwise convs beyond FASTEST_DW's two, and
# mobilenet-v1-224 batch 32's (3x3, Caffe pads 1), as (input H = W, C,
# stride, launches a forward): 13 launches each
FASTEST_DW_MORE = [(80, 64, 1, 1), (80, 64, 2, 1), (40, 128, 1, 1), (40, 128, 2, 1),
                   (20, 192, 1, 3), (20, 288, 2, 1), (10, 576, 1, 2), (10, 192, 1, 1)]
MOBILENET_DW = [(112, 32, 1, 1), (112, 64, 2, 1), (56, 128, 1, 1), (56, 128, 2, 1),
                (28, 256, 1, 1), (28, 256, 2, 1), (14, 512, 1, 5), (14, 512, 2, 1),
                (7, 1024, 1, 1)]
# with --tiles, the dw tile sweep's shapes (H, C, stride)
DW_SWEEP_SHAPES = [(160, 32, 1), (160, 32, 2), (40, 128, 1), (10, 576, 1), (28, 256, 1),
                   (7, 1024, 1)]
FASTEST_OPTS = dict(quant_mode="fast", quant_bf16_storage=False, batch_size=FASTEST_BATCH)
FASTEST_TIERS = {
    "D": ("1", {"dw_qconv": 13, "qconv1x1": 29, "qconv_direct": 0, "qgemm_requant": 0,
                "stem_qconv": 0}, 1),
    "E": ("0", {"dw_qconv": 0, "qconv1x1": 29, "qconv_direct": 0, "qgemm_requant": 0,
                "stem_qconv": 0}, 14),
}


RESNET_BATCH = 32
# the tiers of phase 3d and their launches per forward (qblock_chain: one per
# FusedResBlockChain node; H: the 13 3x3 convs with C_in % 128 == 0, the 36
# 1x1 convs and the FC)
RESNET_TIERS = {
    "F": (dict(fuse_resblock=True, quant_relaxed=False), {"qblock_chain": 4}),
    "R": (dict(fuse_resblock=True, quant_relaxed=True, quant_native="off"), {"qblock_chain": 4}),
    "G": (dict(quant_relaxed=False), {}),
    "H": (dict(quant_relaxed=False, quant_bf16_storage=False, pallas_qgemm=True),
          {"qconv_direct": 13, "qconv1x1": 36, "qgemm_requant": 1}),
}
# ResNet-50-224's four chains at batch 32 as qblock_inputs cases
# (tests/test_torch_cuda.py), each with a projection head, the later ones
# after the head's stride 2: stage 1 (56x56, 64 -> 64 -> 256, 3 blocks),
# stage 2 (28x28, 256 -> 128 -> 512, 4), stage 3 (14x14, 512 -> 256 -> 1024,
# 6), stage 4 (7x7, 1024 -> 512 -> 2048, 3). The kernels line's qblock_chain
# entry is stage 3's, the largest by operations.
RESNET_CHAINS = {
    "stage1": (RESNET_BATCH, 56, 56, 64, 64, 256, 3, True, True, "own", (0, 0)),
    "stage2": (RESNET_BATCH, 28, 28, 256, 128, 512, 4, True, True, "own", (0, 0)),
    "stage3": (RESNET_BATCH, 14, 14, 512, 256, 1024, 6, True, True, "own", (0, 0)),
    "stage4": (RESNET_BATCH, 7, 7, 1024, 512, 2048, 3, True, True, "own", (0, 0)),
}
QBLOCK_ENTRY_CHAIN = "stage3"
RESNET50_WIDTHS = (64, 128, 256, 512)  # c_mid per stage; c_out = 4 * c_mid
RESNET50_DEPTHS = (3, 4, 6, 3)
# phase 3e: bench.py's own configs under default Options at its batch, 128
# (bench.py:381, resnet50 int8 with KL calibration; bench.py:342-368, the
# mobilenet-v1 uint8 headline). Per tier: the net, the scheme, the
# calibration, the Options beyond Options(quant_mode="fast",
# batch_size=DEFAULT_BATCH), TT_DW_PALLAS while compile_graph runs (None:
# unset), whether the native-int8 plan is taken, and the launches per forward
DEFAULT_BATCH = 128
DEFAULT_TIERS = {
    "I": ("resnet50", "int8", "kl", {}, None, True, {}),
    "J": ("resnet50", "uint8", "minmax", {}, None, True, {}),
    "K": ("mobilenet-v1", "uint8", "minmax", {}, None, False, {}),
    "L": ("mobilenet-v1", "uint8", "minmax", dict(quant_native="on"), "1", True, {"dw_qconv": 13}),
}


def build_resnet50_graph(ir, img=224, classes=1000, seed=0, widths=RESNET50_WIDTHS,
                         depths=RESNET50_DEPTHS, head=True):
    """ResNet-50 (Caffe style: the stride 2 of a stage's first bottleneck sits
    in its first 1x1 conv and in the 1x1 projection) as a float IR graph with
    seeded weights, built with the IR module `ir` it is given:
    conv 7x7 s2 p3 (relu) -> max-pool 3x3 s2 p1 -> stages of bottlenecks
    1x1 (relu) -> 3x3 s1 p1 (relu) -> 1x1 -> Eltwise SUM -> ReLu node, c_mid
    `widths`, c_out 4x that -> global average pool -> FullyConnected; with
    head=False the graph ends at the last bottleneck's ReLu.
    Weights are He-normal with batch norm folded away; each block's last conv
    is scaled by 0.5 so that the residual stream keeps its variance over 16
    blocks."""
    DType, Graph, TensorType = ir.DType, ir.Graph, ir.TensorType
    rng = np.random.default_rng(seed)
    g = Graph(name=f"resnet50-{img}")

    def conv(name, x, c_out, k, stride=1, pad=0, act=-1, gain=1.0):
        n, c_in, h, w = x.shape
        std = gain * np.sqrt(2.0 / (c_in * k * k))
        wt = g.add_tensor(f"{name}.w", DType.FP32, [c_out, c_in, k, k], TensorType.CONST,
                          data=(rng.standard_normal((c_out, c_in, k, k)) * std).astype(np.float32))
        bt = g.add_tensor(f"{name}.b", DType.FP32, [c_out], TensorType.CONST,
                          data=(rng.standard_normal(c_out) * 0.05).astype(np.float32))
        oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        y = g.add_tensor(f"{name}.out", DType.FP32, [n, c_out, oh, ow], TensorType.VAR)
        g.add_node("Convolution", name, [x.idx, wt.idx, bt.idx], [y.idx], dict(
            kernel_h=k, kernel_w=k, stride_h=stride, stride_w=stride, dilation_h=1,
            dilation_w=1, input_channel=c_in, output_channel=c_out, group=1, activation=act,
            pad_h0=pad, pad_w0=pad, pad_h1=pad, pad_w1=pad))
        return y

    x = g.add_tensor("data", DType.FP32, [1, 3, img, img], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    t = conv("conv1", x, widths[0], 7, stride=2, pad=3, act=0)
    n, c, h, w = t.shape
    ph, pw = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    pooled = g.add_tensor("pool1.out", DType.FP32, [n, c, ph, pw], TensorType.VAR)
    g.add_node("Pooling", "pool1", [t.idx], [pooled.idx], dict(
        alg=0, kernel_h=3, kernel_w=3, stride_h=2, stride_w=2, global_pool=0, caffe_flavor=0,
        pad_h0=1, pad_w0=1, pad_h1=1, pad_w1=1))
    t = pooled
    for stage, (c_mid, depth) in enumerate(zip(widths, depths)):
        c_out = 4 * c_mid
        for i in range(depth):
            name = f"res{stage + 2}{chr(ord('a') + i)}"
            stride = 2 if (i == 0 and stage > 0) else 1
            m = conv(f"{name}.c1", t, c_mid, 1, stride=stride, act=0)
            m = conv(f"{name}.c2", m, c_mid, 3, pad=1, act=0)
            m = conv(f"{name}.c3", m, c_out, 1, gain=0.5)
            r = conv(f"{name}.c4", t, c_out, 1, stride=stride, gain=0.5) if i == 0 else t
            s = g.add_tensor(f"{name}.sum", DType.FP32, list(m.shape), TensorType.VAR)
            g.add_node("Eltwise", f"{name}.add", [m.idx, r.idx], [s.idx], dict(type=2))  # ELT_SUM
            t = g.add_tensor(f"{name}.relu", DType.FP32, list(m.shape), TensorType.VAR)
            g.add_node("ReLu", f"{name}.r", [s.idx], [t.idx], dict(negative_slope=0.0))
    g.inputs = [inp.idx]
    if not head:
        g.outputs = [g.tensors[t.idx].producer]
        return g
    n, c, h, w = t.shape
    gap = g.add_tensor("pool5.out", DType.FP32, [n, c, 1, 1], TensorType.VAR)
    g.add_node("Pooling", "pool5", [t.idx], [gap.idx], dict(
        alg=1, kernel_h=h, kernel_w=w, stride_h=1, stride_w=1, global_pool=1, caffe_flavor=0,
        pad_h0=0, pad_w0=0, pad_h1=0, pad_w1=0))
    wt = g.add_tensor("fc.w", DType.FP32, [classes, c], TensorType.CONST,
                      data=(rng.standard_normal((classes, c)) * np.sqrt(1.0 / c)).astype(np.float32))
    bt = g.add_tensor("fc.b", DType.FP32, [classes], TensorType.CONST,
                      data=(rng.standard_normal(classes) * 0.05).astype(np.float32))
    out = g.add_tensor("fc.out", DType.FP32, [n, classes, 1, 1], TensorType.VAR)
    fc = g.add_node("FullyConnected", "fc", [gap.idx, wt.idx, bt.idx], [out.idx],
                    dict(num_output=classes))
    g.outputs = [fc.idx]
    return g


# mobilenet-v1-224 at width 1.0 (Howard et al. 2017, Table 1): the stem's
# width, then the 13 pointwise convs' widths, and the 13 depthwise convs'
# strides
MOBILENET_WIDTHS = (32, 64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512, 1024, 1024)
MOBILENET_STRIDES = (1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1)


def build_mobilenet_v1_graph(ir, img=224, classes=1000, seed=0, widths=MOBILENET_WIDTHS,
                             strides=MOBILENET_STRIDES, head=True):
    """MobileNet-v1 (Caffe style, as Tengine's benchmark tmfile has it) as a
    float IR graph with seeded weights, built with the IR module `ir` it is
    given: conv 3x3 s2 p1 (relu) to widths[0] -> for each of the
    len(strides) blocks a depthwise 3x3 p1 conv at that stride (relu) and a
    pointwise 1x1 conv (relu) to the next width -> global average pool ->
    FullyConnected. With head=False the graph ends at the last pointwise
    conv. Weights are He-normal with batch norm folded away. The graph ends
    at the FC's logits: the Softmax of the published net is not ported yet,
    so it is left out in both packages."""
    DType, Graph, TensorType = ir.DType, ir.Graph, ir.TensorType
    if len(widths) != len(strides) + 1:
        raise ValueError(f"{len(strides)} blocks need {len(strides) + 1} widths, got {len(widths)}")
    rng = np.random.default_rng(seed)
    g = Graph(name=f"mobilenet-v1-{img}")

    def conv(name, x, c_out, k, stride=1, pad=0, group=1):
        n, c_in, h, w = x.shape
        fan_in = c_in // group * k * k
        wt = g.add_tensor(f"{name}.w", DType.FP32, [c_out, c_in // group, k, k], TensorType.CONST,
                          data=(rng.standard_normal((c_out, c_in // group, k, k))
                                * np.sqrt(2.0 / fan_in)).astype(np.float32))
        bt = g.add_tensor(f"{name}.b", DType.FP32, [c_out], TensorType.CONST,
                          data=(rng.standard_normal(c_out) * 0.05).astype(np.float32))
        oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        y = g.add_tensor(f"{name}.out", DType.FP32, [n, c_out, oh, ow], TensorType.VAR)
        node = g.add_node("Convolution", name, [x.idx, wt.idx, bt.idx], [y.idx], dict(
            kernel_h=k, kernel_w=k, stride_h=stride, stride_w=stride, dilation_h=1,
            dilation_w=1, input_channel=c_in, output_channel=c_out, group=group, activation=0,
            pad_h0=pad, pad_w0=pad, pad_h1=pad, pad_w1=pad))
        return y, node

    x = g.add_tensor("data", DType.FP32, [1, 3, img, img], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [x.idx])
    g.inputs = [inp.idx]
    t, last = conv("conv1", x, widths[0], 3, stride=2, pad=1)
    for i, stride in enumerate(strides):
        c = widths[i]
        t, _ = conv(f"conv{i + 2}_dw", t, c, 3, stride=stride, pad=1, group=c)
        t, last = conv(f"conv{i + 2}_pw", t, widths[i + 1], 1)
    if not head:
        g.outputs = [last.idx]
        return g
    n, c, h, w = t.shape
    gap = g.add_tensor("pool6.out", DType.FP32, [n, c, 1, 1], TensorType.VAR)
    g.add_node("Pooling", "pool6", [t.idx], [gap.idx], dict(
        alg=1, kernel_h=h, kernel_w=w, stride_h=1, stride_w=1, global_pool=1, caffe_flavor=0,
        pad_h0=0, pad_w0=0, pad_h1=0, pad_w1=0))
    wt = g.add_tensor("fc7.w", DType.FP32, [classes, c], TensorType.CONST,
                      data=(rng.standard_normal((classes, c)) * np.sqrt(1.0 / c)).astype(np.float32))
    bt = g.add_tensor("fc7.b", DType.FP32, [classes], TensorType.CONST,
                      data=(rng.standard_normal(classes) * 0.05).astype(np.float32))
    out = g.add_tensor("fc7.out", DType.FP32, [n, classes, 1, 1], TensorType.VAR)
    fc = g.add_node("FullyConnected", "fc7", [gap.idx, wt.idx, bt.idx], [out.idx],
                    dict(num_output=classes))
    g.outputs = [fc.idx]
    return g


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls captured into one CUDA
    graph and replayed: the launches run back to back on the card with no
    host work between them, so a kernel shorter than its wrapper's host time
    (tens of microseconds) is still timed as the card runs it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture needs
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_entry(name, source, replaces, err, ms, plain_ms, moved, ops, library_ms):
    """One kernel's entry of the kernels line (launches filled in by phase
    3). Bound: the larger of bytes over the HBM rate and int8 operations over
    the int8 tensor-core rate."""
    t_bytes, t_ops = moved / H100_BYTES_PER_S * 1e3, ops / H100_INT8_OPS_PER_S * 1e3
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"  {name} timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, "
        f"bound {entry['bound_ms']:.4f} ms by {entry['bound_by']} ({moved} bytes, {ops} int8 ops)")
    return entry


def max_lsb(torch, got, want, what) -> int:
    """Largest |kernel - plain| in LSB; raises above 1 (0 expected)."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs plain "
                             f"{want.dtype} {tuple(want.shape)}")
    d = (got.int() - want.int()).abs()
    err = int(d.max().item())
    log(f"  {what}: max|d|={err} LSB, {int((d > 0).sum())} of {d.numel()} elements differ")
    if err > 1:
        raise AssertionError(f"{what}: kernel disagrees with its plain version by {err} LSB")
    return err


def _check_smem_mirror(lib, fn_name, mirror, arg_lists) -> None:
    """The wrapper's copy of a kernel's shared-memory layout must give the
    bytes the kernel's own (an exported C function) gives."""
    import ctypes

    from tengine_tpu_torch.ops.cuda.build import load

    fn = getattr(load(lib), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(arg_lists[0])
    for args in arg_lists:
        want, got = fn(*[int(a) for a in args]), mirror(*args)
        if want != got:
            raise AssertionError(f"{lib}: {fn_name}{tuple(args)} = {want}, the wrapper's copy {got}")


def check_stem_kernel(torch):
    """Phase 2 for the stem kernel: bit for bit against its plain version
    (SiLU within 1 LSB) on the test grid and the edge cases
    (tests/test_torch_cuda.py), int8/uint8 and f32 out, then at yolov5s-640
    b8, timed by graph replay with SiLU and without (the epilogue's share).
    Returns its kernels-line entry."""
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import (
        STEM_CASES, STEM_EDGE_CASES, stem_edge_inputs, stem_inputs, stem_port_args,
    )

    from tengine_tpu_torch.ops.cuda.stem_conv import (
        REPLACES, SOURCE, pick_stem_tile, stem_qconv, stem_qconv_plain, stem_smem_bytes,
        stem_true_weights,
    )

    cases = []
    for k, pad, act, mode, zp_w, B, H in STEM_CASES:
        x, w, mult, bias, q = stem_inputs(k, mode, zp_w, B, H, seed=k * 100 + H + zp_w)
        cases.append((f"k={k} {mode} zp_w={zp_w} {B}x{H}", x, w, mult, bias, q, k, zp_w,
                      dict(k=k, pad=pad, act=act, **q)))
    for case in STEM_EDGE_CASES:
        x, w, mult, bias, q, run = stem_edge_inputs(case, seed=sum(case[5:]))
        cases.append((f"edge {case}", x, w, mult, bias, q, case[0], case[4], run))
    worst = 0.0
    for what, x, w, mult, bias, q, k, zp_w, run in cases:
        tensors, w_corr = stem_port_args(x, w, mult, bias, q, k, zp_w)
        args = [t.cuda() for t in tensors]
        for out_f32 in (False, True):
            got = stem_qconv(*args, w_corr=w_corr, out_f32=out_f32, **run)
            want = stem_qconv_plain(*args, w_corr=w_corr, out_f32=out_f32, **run)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs().max().item()
            if d > (1 if run["act"] == 100 else 0):
                raise AssertionError(f"stem kernel disagrees with its plain version at {what} "
                                     f"out_f32={out_f32}: {d}")
            worst = max(worst, d)
    log(f"  stem grid: {len(cases)} cases x int/f32 out, max|d|={worst:g} (SiLU may differ by 1)")
    _check_smem_mirror("stem_conv", "stem_qconv_smem_bytes", stem_smem_bytes,
                       [(c_, k_, *pick_stem_tile(oh, ow), f32) for c_, k_, oh, ow in
                        [(3, 6, 320, 320), (1, 3, 17, 17), (4, 7, 8, 330)] for f32 in (0, 1)])

    # the main path's shape: yolov5s-640 batch 8, s8 in and out, SiLU
    k, pad, B, H, C, Cout = 6, 2, 8, 640, 3, 32
    x, w, mult, bias, q = stem_inputs(k, "s8", 0, B, H, seed=640, C=C, Cout=Cout)
    tensors, w_corr = stem_port_args(x, w, mult, bias, q, k, 0)
    args = [t.cuda() for t in tensors]
    run = dict(k=k, pad=pad, act=100, w_corr=w_corr, **q)
    got = stem_qconv(*args, **run)
    want = stem_qconv_plain(*args, **run)
    err = max_lsb(torch, got, want, "stem yolov5s-640 b8 (SiLU)")

    ms = graph_ms(lambda: stem_qconv(*args, **run), iters=50)
    no_act = dict(run, act=-1)
    ms_no_act = graph_ms(lambda: stem_qconv(*args, **no_act), iters=50)
    log(f"  stem yolov5s-640 b8: {ms:.4f} ms with SiLU, {ms_no_act:.4f} ms without "
        f"(the SiLU epilogue {ms - ms_no_act:.4f} ms)")
    plain_ms = cuda_ms(lambda: stem_qconv_plain(*args, **run), iters=5, warmup=1)
    # library yardstick: one cuDNN conv in bf16 on the re-centred values
    # (exact: |acc| < 2^24 at K = 108); the conv alone, no requant epilogue
    xb = args[0].to(torch.bfloat16)
    wb = stem_true_weights(args[1], Cout, C, k, w_corr).to(torch.bfloat16)
    library_ms = graph_ms(lambda: F.conv2d(xb, wb, stride=2, padding=pad), iters=20)
    oh = ow = H // 2
    moved = (args[0].numel() * args[0].element_size() + got.numel() * got.element_size()
             + sum(a.numel() * a.element_size() for a in args[1:]))
    ops = 2 * B * oh * ow * Cout * C * k * k
    return kernel_entry("stem_qconv", SOURCE, REPLACES, err, ms, plain_ms, moved, ops, library_ms)


def check_igemm_grid(torch) -> None:
    """Phase 2 on the test grids (tests/test_torch_cuda.py): qconv_direct and
    qconv1x1 with and without a fused residual, and qgemm_requant, each
    kernel bit for bit against its plain version: the grid and the edge cases
    under the tile pick_tile chooses and under every tile forced."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import (
        IGEMM_TILES, QCONV_CASES, QCONV_EDGE_CASES, QCONV_RES_CASES, QGEMM_CASES,
        QGEMM_EDGE_CASES, port_qconv, port_qgemm, qconv_edge_inputs, qconv_inputs,
        qgemm_edge_inputs, qgemm_inputs, wgmma_refused,
    )

    from tengine_tpu_torch.ops.cuda.qconv import TILES

    if sorted({t[:2] for t in IGEMM_TILES}) != sorted(TILES):
        raise AssertionError(f"the tests force tiles {IGEMM_TILES}, the kernel is built for {TILES}")
    conv = [qconv_inputs(c, seed=sum(c[:5]), with_res=False) for c in QCONV_CASES]
    conv += [qconv_inputs(c, seed=sum(c[:5]), with_res=True) for c in QCONV_RES_CASES]
    conv += [qconv_edge_inputs(c, seed=sum(c[:7])) for c in QCONV_EDGE_CASES]
    gemm = [qgemm_inputs(c, seed=sum(c[:3])) for c in QGEMM_CASES]
    gemm += [qgemm_edge_inputs(c, seed=sum(c[:3])) for c in QGEMM_EDGE_CASES]
    worst = runs = 0
    for port, inputs in ((port_qconv, conv), (port_qgemm, gemm)):
        for inp in inputs:
            want = port(inp, "cuda", kernel=False).astype(np.int32)
            for tile in [None] + IGEMM_TILES:
                if wgmma_refused(inp, tile):  # uint8 input: the mma.sync route only
                    continue
                got = port(inp, "cuda", kernel=True, tile=tile).astype(np.int32)
                worst = max(worst, int(np.abs(got - want).max()))
                runs += 1
    log(f"  qconv/qgemm grid: {len(conv)} qconv and {len(gemm)} qgemm cases, each under the "
        f"chosen tile and {len(IGEMM_TILES)} forced tiles and routes (wgmma: int8 input only) = "
        f"{runs} runs, max|d|={worst} LSB")
    if worst:
        raise AssertionError(f"qconv/qgemm kernels disagree with their plain versions: {worst} LSB")


def check_tensor_core_sass(build) -> None:
    """The built qconv, qblock and stem_conv libraries must reach the int8
    tensor cores: count the IMMA (mma.sync), IGMMA (wgmma) and IDP.4A (dp4a)
    instructions in their SASS. qconv and stem_conv need IMMA or IGMMA;
    qblock IMMA and no IDP.4A. The dw_conv library's packed dots (IDP.2A,
    IDP.4A) and IMADs are counted and printed."""
    import shutil

    tool = shutil.which("cuobjdump") or str(Path(build._nvcc()).with_name("cuobjdump"))

    def sass(name):
        return subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout

    for name in ("qconv", "qblock", "stem_conv"):
        text = sass(name)
        imma, igmma, dp4a = text.count("IMMA."), text.count("IGMMA."), text.count("IDP.4A")
        log(f"  {name} library SASS: {imma} IMMA, {igmma} IGMMA, {dp4a} IDP.4A instructions")
        if imma + igmma == 0 or (name == "qblock" and (imma == 0 or dp4a)):
            raise AssertionError(f"the {name} library does not compute its products on the "
                                 f"int8 tensor cores")
    text = sass("dw_conv")
    log(f"  dw_conv library SASS: {text.count('IDP.2A')} IDP.2A, {text.count('IDP.4A')} IDP.4A, "
        f"{text.count('IMAD')} IMAD instructions")


def _requant_vectors(rng, n, k):
    """A multiplier and bias per channel that put int8 outputs around +-50
    at fan-in k (|acc| ~ sqrt(k)*73^2 for uniform int8 operands)."""
    m = (rng.uniform(0.5, 1.5, n) * 50.0 / (np.sqrt(k) * 73.0 * 73.0)).astype(np.float32)
    b = rng.uniform(-20.0, 20.0, n).astype(np.float32)
    return m, b


def check_igemm_main(torch, sweep=False):
    """Phase 2 at yolov3-416 b8's largest launch of each kernel: returns the
    kernels-line entries of qconv_direct, qconv1x1 and qgemm_requant. Kernel
    and library times are device times (graph_ms); the wrapper's eager time
    per call is logged beside them. Then, as log lines, three ResNet-50 b32
    shapes of tier H and two narrow YOLO-Fastest shapes. With sweep, every
    tile's time at every shape."""
    import torch.nn.functional as F

    from tengine_tpu_torch.ops.cuda import qconv as pq
    from tengine_tpu_torch.ops.cuda import qgemm as pg

    rng = np.random.default_rng(416)
    entries = {}
    common = dict(lo=-127, hi=127)

    def measure(name, what, fn, plain, library, m_rows, c2, moved, ops, source, replaces,
                entry=True):
        got = fn()
        err = max_lsb(torch, got, plain(), f"{name} {what}")
        tile = pq.pick_tile(m_rows, c2)
        route = "wgmma" if tile in pq.WGMMA_TILES else "mma.sync"  # int8 input, no rowsum
        tiles = -(-m_rows // tile[0]) * -(-c2 // tile[1])
        ms, eager_ms = graph_ms(fn, iters=20), cuda_ms(fn, iters=20)
        library_ms = graph_ms(library, iters=20)
        log(f"  {name} {what}: tile {tile[0]}x{tile[1]} by {route} ({tiles} tiles), device "
            f"{ms:.4f} ms, eager wrapper {eager_ms:.4f} ms a call, {ops / ms / 1e9:.1f} T int8 ops/s, "
            f"{moved / ms / 1e6:.0f} GB/s")
        if sweep:
            forced = [t + (r,) for t in pq.TILES for r in (("mma", "wgmma") if t in pq.WGMMA_TILES else ("mma",))]
            times = {t: graph_ms(lambda: fn(tile=t), iters=20) for t in forced}
            log("    by tile: " + ", ".join(f"{t[0]}x{t[1]} {t[2]} {v:.4f}" for t, v in times.items()))
        if not entry:
            t_bound = max(moved / H100_BYTES_PER_S, ops / H100_INT8_OPS_PER_S) * 1e3
            log(f"    library {library_ms:.4f} ms, bound {t_bound:.4f} ms ({moved} bytes, {ops} int8 ops)")
            return
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        entries[name] = kernel_entry(name, source, replaces, err, ms, plain_ms, moved, ops, library_ms)

    def conv_case(name, N, H, C, O, k, s, pad, act, what, entry=True):
        x = torch.from_numpy(rng.integers(-127, 128, (N, H, H, C), dtype=np.int8)).cuda()
        w_oihw = rng.integers(-127, 128, (O, C, k, k), dtype=np.int8)
        w = torch.from_numpy(pq.pack_qconv_weights(w_oihw, False)).cuda()
        m, b = (torch.from_numpy(a).cuda() for a in _requant_vectors(rng, O, C * k * k))
        geo = dict(kh=k, kw=k, stride=s, pad_t=pad, pad_b=pad, pad_l=pad, pad_r=pad, act=act, **common)
        oh = (H + 2 * pad - k) // s + 1
        # library yardstick: cuDNN fp16 conv, channels-last, the conv alone (not
        # exact: fp16 holds int8 values but not every int32 sum)
        xh = x.permute(0, 3, 1, 2).half().contiguous(memory_format=torch.channels_last)
        wh = torch.from_numpy(w_oihw).cuda().half().contiguous(memory_format=torch.channels_last)
        measure(name, f"{what} {H}x{H}x{C} -> {oh}x{oh}x{O} k{k} s{s}",
                lambda tile=None: pq.qconv_direct(x, w, m, b, tile=tile, **geo),
                lambda: pq.qconv_direct_plain(x, w, m, b, **geo),
                lambda: F.conv2d(xh, wh, stride=s, padding=pad), N * oh * oh, O,
                x.numel() + w_oihw.size + 8 * O + N * oh * oh * O, 2 * N * oh * oh * O * C * k * k,
                pq.SOURCE, pq.REPLACES_DIRECT, entry)

    def gemm_case(name, M, K, Nn, act, what, with_res=False, entry=True):
        x = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).cuda()
        w_nk = rng.integers(-127, 128, (Nn, K), dtype=np.int8)
        m, b = (torch.from_numpy(a).cuda() for a in _requant_vectors(rng, Nn, K))
        kw = dict(act=act, **common)
        if name == "qconv1x1":
            w = torch.from_numpy(pq.pack_qconv_weights(w_nk.reshape(Nn, K, 1, 1), False)).cuda()
            fn, plain, source, replaces = pq.qconv1x1, pq.qconv1x1_plain, pq.SOURCE, pq.REPLACES_1X1
            if with_res:
                r = torch.from_numpy(rng.integers(-127, 128, (M, Nn), dtype=np.int8)).cuda()
                kw.update(residual=r, res=(0.05, 0, 0.03, 0, 0.07, 0, True), inv_s_out=20.0)
        else:
            w = torch.from_numpy(pg.pack_qgemm_weights(w_nk, False)).cuda()
            fn, plain, source, replaces = pg.qgemm_requant, pg.qgemm_requant_plain, pg.SOURCE, pg.REPLACES
        # library yardstick: torch._int_mm on the same operands (the GEMM alone,
        # int32 out), the weights column-major as cuBLASLt takes them
        wt = torch.from_numpy(w_nk).cuda().t()
        try:
            torch._int_mm(x, wt)
        except RuntimeError as exc:
            log(f"  torch._int_mm refused the column-major operand ({exc}); timing a row-major copy")
            wt = wt.contiguous()
        measure(name, f"{what} [{M},{K}]x[{K},{Nn}]" + (" + residual + relu" if with_res else ""),
                lambda tile=None: fn(x, w, m, b, tile=tile, **kw), lambda: plain(x, w, m, b, **kw),
                lambda: torch._int_mm(x, wt), M, Nn,
                M * K + Nn * K + 8 * Nn + M * Nn * (2 if with_res else 1), 2 * M * K * Nn,
                source, replaces, entry)

    d = YOLOV3_DIRECT
    conv_case("qconv_direct", d["N"], d["H"], d["C"], d["O"], d["k"], d["s"], d["pad"], -1, "yolov3-416 b8")
    gemm_case("qconv1x1", YOLOV3_1X1["M"], YOLOV3_1X1["K"], YOLOV3_1X1["N"], -1, "yolov3-416 b8")
    gemm_case("qgemm_requant", YOLOV3_QGEMM["M"], YOLOV3_QGEMM["K"], YOLOV3_QGEMM["N"], -1, "yolov3-416 b8")
    # tier H's shapes, log lines only: a stage-3 3x3, the stage-4 pointwise
    # convs (the second with the fused residual and relu)
    b = RESNET_BATCH
    conv_case("qconv_direct", b, 14, 256, 256, 3, 1, 1, 0, f"resnet50-224 b{b}", entry=False)
    gemm_case("qconv1x1", b * 7 * 7, 2048, 512, 0, f"resnet50-224 b{b}", entry=False)
    gemm_case("qconv1x1", b * 7 * 7, 512, 2048, -1, f"resnet50-224 b{b}", with_res=True, entry=False)
    # YOLO-Fastest-320 b32's narrowest pointwise convs (C_in 8: 8-byte copies)
    gemm_case("qconv1x1", FASTEST_BATCH * 160 * 160, 8, 8, -1, f"yolofastest-320 b{FASTEST_BATCH}", entry=False)
    gemm_case("qconv1x1", FASTEST_BATCH * 80 * 80, 16, 48, -1, f"yolofastest-320 b{FASTEST_BATCH}", entry=False)
    return entries


def _dw_inputs_on_card(torch, rng, N, H, C, k, u8, shifted=False):
    """Seeded dw_qconv operands on the card: raw NHWC x, packed taps, M, the
    folded B, the true taps and the quant keywords. shifted: the native-int8
    plan's grid, a UINT8 grid moved to INT8 (full range [-128, 127], zp_in
    and zp_out near -128, so the pad bytes carry a negative zp_in)."""
    from tengine_tpu_torch.ops.cuda import dw_conv as pd

    if shifted:
        x = rng.integers(-128, 128, (N, H, H, C), dtype=np.int8)
        w_true = rng.integers(-127, 128, (C, 1, k, k))
        q = dict(zp_in=-101, zp_out=-120, lo=-128.0, hi=127.0, out_u8=False)
    elif u8:
        x = rng.integers(0, 256, (N, H, H, C), dtype=np.uint8)
        w_true = rng.integers(-255, 256, (C, 1, k, k))
        q = dict(zp_in=119, zp_out=131, lo=0.0, hi=255.0, out_u8=True)
    else:
        x = rng.integers(-127, 128, (N, H, H, C), dtype=np.int8)
        w_true = rng.integers(-127, 128, (C, 1, k, k))
        q = dict(zp_in=0, zp_out=0, lo=-127.0, hi=127.0, out_u8=False)
    m = (rng.uniform(0.5, 1.5, C) * 50.0 / (3.0 * 73.0 * (146.0 if u8 else 73.0))).astype(np.float32)
    colsum = w_true.reshape(C, -1).sum(axis=1)
    b = ((rng.integers(-500, 500, C) - q["zp_in"] * colsum) * m.astype(np.float64)).astype(np.float32)
    dev = [torch.from_numpy(a).cuda() for a in (x, pd.pack_dw_taps(w_true), m, b)]
    return dev, w_true, q


def _dw_sweep_tiles(pd, N, H, C, k, stride):
    """Every block tile worth timing at one shape: channel groups of 4-32
    words, 1-16 column slots, 1-8 row strips, each row walk, 32-256 threads,
    at most 100 KB of shared memory."""
    cwords = -(-C // 4)
    tiles = []
    for rpt in pd.THREAD_TILE[(k, stride)][1]:
        for cgw in (4, 8, 16, 32):
            for ncs in (1, 2, 4, 8, 16):
                for nrs in (1, 2, 4, 8):
                    if (cgw <= cwords and 32 <= cgw * ncs * nrs <= pd.MAX_THREADS
                            and pd.dw_smem_bytes(k, stride, cgw, ncs, nrs, rpt) <= 100 * 1024):
                        tiles.append((cgw, ncs, nrs, rpt))
    return tiles


def check_dw_kernel(torch, sweep=False):
    """Phase 2 for dw_qconv: bit for bit against dw_qconv_plain on the test
    grid and the redesign's edge cases under forced tiles
    (tests/test_torch_cuda.py); then at YOLO-Fastest-320 batch 32's 13
    depthwise launches (its two 160x160x32 shapes int8 and uint8, the rest
    int8) and mobilenet-v1-224's 13 (Caffe pads 1) at batch 32 int8 and at
    DEFAULT_BATCH on the native-int8 plan's grid (tier L: int8 input with a
    negative zp_in, the full range [-128, 127], ReLU), each at 0 LSB and
    timed by graph replay beside cuDNN's fp16 depthwise conv, with each
    net's sum over its 13 launches. With sweep, every tile's time at six of
    the batch-32 int8 shapes. Returns the kernels-line entry (160x160x32 s1
    int8)."""
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import DW_CASES, DW_EDGE_CASES, DW_EXTRA_CASES, dw_inputs, port_dw

    from tengine_tpu_torch.ops.cuda import dw_conv as pd

    worst = runs = 0
    for case in DW_CASES + DW_EXTRA_CASES:
        inp = dw_inputs(case, seed=sum(case[:5]))
        got, want = port_dw(inp, "cuda", kernel=True), port_dw(inp, "cuda", kernel=False)
        worst = max(worst, int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()))
        runs += 1
    for case, tiles in DW_EDGE_CASES:
        inp = dw_inputs(case, seed=sum(case[:5]), extremes=True)
        want = port_dw(inp, "cuda", kernel=False).astype(np.int32)
        for tile in tiles:
            got = port_dw(inp, "cuda", kernel=True, tile=tile).astype(np.int32)
            worst = max(worst, int(np.abs(got - want).max()))
            runs += 1
    log(f"  dw_qconv grid and edge cases: {runs} runs, max|d|={worst} LSB")
    _check_smem_mirror("dw_conv", "dw_qconv_smem_bytes", pd.dw_smem_bytes,
                       [(k_, s_, *pd.pick_dw_tile(N_, oh, oh, c_, k_, s_))
                        for N_, oh, c_, k_, s_ in [(32, 160, 32, 3, 1), (32, 80, 32, 3, 2),
                                                   (32, 7, 1024, 3, 1), (2, 9, 30, 5, 1),
                                                   (3, 6, 30, 5, 2)]])
    if worst:
        raise AssertionError(f"dw_qconv disagrees with its plain version on the grid: {worst} LSB")

    k, pad, N = 3, 1, FASTEST_BATCH
    # (net, batch, H, C, stride, mode, launches a forward); mode s8, u8 or
    # shifted (the native-int8 plan's grid)
    shapes = [("yolofastest-320", N, FASTEST_DW["H"], FASTEST_DW["C"], s, m, 1)
              for m in ("s8", "u8") for s in (1, 2)]
    shapes += [("yolofastest-320", N, H, C, s, "s8", n) for H, C, s, n in FASTEST_DW_MORE]
    shapes += [("mobilenet-v1-224", N, H, C, s, "s8", n) for H, C, s, n in MOBILENET_DW]
    shapes += [("mobilenet-v1-224", DEFAULT_BATCH, H, C, s, "shifted", n)
               for H, C, s, n in MOBILENET_DW]
    rng = np.random.default_rng(320)
    entry = None
    sums = {}  # per net, batch and s8/shifted: kernel, cuDNN, bound ms, launches a forward
    for net, N, H, C, stride, mode, count in shapes:
        u8 = mode == "u8"
        (xd, wd, md, bd), w_true, q = _dw_inputs_on_card(torch, rng, N, H, C, k, u8,
                                                         shifted=mode == "shifted")
        run = dict(k=k, stride=stride, pad_t=pad, pad_b=pad, pad_l=pad, pad_r=pad,
                   act=0 if mode == "shifted" else -1, s_out=0.05, **q)
        got = pd.dw_qconv(xd, wd, md, bd, **run)
        OH = got.shape[1]
        what = f"dw_qconv {net} b{N} {mode} {H}x{H}x{C} s{stride} -> {OH}x{OH}"
        err = max_lsb(torch, got, pd.dw_qconv_plain(xd, wd, md, bd, **run), what)
        if err:
            raise AssertionError(f"{what}: kernel disagrees with its plain version")
        # device time: the kernel is shorter than its wrapper's host time
        ms = graph_ms(lambda: pd.dw_qconv(xd, wd, md, bd, **run), iters=50)
        # library yardstick: one fp16 depthwise conv2d, channels-last, the
        # conv alone (not exact: the fp16 result rounds; no requant epilogue)
        xh = xd.permute(0, 3, 1, 2).half().contiguous(memory_format=torch.channels_last)
        wh = torch.from_numpy(w_true.astype(np.float16)).cuda()
        library_ms = graph_ms(lambda: F.conv2d(xh, wh, stride=stride, padding=pad, groups=C),
                              iters=20)
        moved = xd.numel() + got.numel() + wd.numel() * 2 + 8 * C
        bound = moved / H100_BYTES_PER_S * 1e3
        tile = pd.pick_dw_tile(N, OH, OH, C, k, stride)
        log(f"  {what}: tile {tile}, kernel {ms:.4f} ms, bound {bound:.4f} ms "
            f"({moved} bytes, {moved / ms / 1e6:.1f} GB/s, {bound / ms:.1%} of HBM), "
            f"cuDNN fp16 {library_ms:.4f} ms, max|d|={err} LSB"
            + (f", x{count} a forward" if count > 1 else ""))
        if not u8:
            tot = sums.setdefault(f"{net} b{N} {mode}", [0.0, 0.0, 0.0, 0])
            for i, v in enumerate((ms, library_ms, bound, 1)):
                tot[i] += count * v
        if sweep and (H, C, stride) in DW_SWEEP_SHAPES and mode == "s8" and N == FASTEST_BATCH:
            times = []
            for t in _dw_sweep_tiles(pd, N, H, C, k, stride):
                got_t = pd.dw_qconv(xd, wd, md, bd, tile=t, **run)
                if not torch.equal(got_t, got):
                    raise AssertionError(f"{what}: tile {t} disagrees with tile {tile}")
                times.append((graph_ms(lambda: pd.dw_qconv(xd, wd, md, bd, tile=t, **run),
                                       iters=20), t))
            times.sort()
            log(f"    tiles by time: " + ", ".join(f"{t} {v:.4f}" for v, t in times[:6])
                + f" ... {len(times)} tiles, the picked {tile} ranks "
                f"{[t for _, t in times].index(tile) + 1 if tile in [t for _, t in times] else '-'}")
        if (H, C, stride, mode) == (FASTEST_DW["H"], FASTEST_DW["C"], 1, "s8"):
            plain_ms = cuda_ms(lambda: pd.dw_qconv_plain(xd, wd, md, bd, **run), iters=3, warmup=1)
            entry = kernel_entry("dw_qconv", pd.SOURCE, pd.REPLACES, err, ms, plain_ms, moved,
                                 2 * got.numel() * k * k, library_ms)
    for net, (ms, lib, bound, n) in sums.items():
        log(f"  dw_qconv {net}, {n} launches a forward: kernel {ms:.4f} ms, bound "
            f"{bound:.4f} ms, cuDNN fp16 {lib:.4f} ms")
    return entry


def check_qblock_kernel(torch, sweep=False):
    """Phase 2 for qblock_chain: bit for bit against qblock_chain_plain on the
    test grid (tests/test_torch_cuda.py), exact and relaxed, under every
    spatial tile and the one picked, and at ResNet-50-224's four chains at
    batch 32 under the tile picked; device time (graph_ms) of each chain,
    plain time of each exact one. With sweep, every built tile's time (and
    result) at each chain. Returns the kernels-line entry of stage 3's exact
    chain."""
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import (
        QBLOCK_CASES, QBLOCK_EXTRA_CASES, QBLOCK_TILES, port_qblock, qblock_inputs,
    )

    from tengine_tpu_torch.ops.cuda import qblock as pqb

    if sorted(QBLOCK_TILES) != sorted(pqb.TILES):
        raise AssertionError(f"the tests force tiles {QBLOCK_TILES}, the kernel is built for {pqb.TILES}")
    worst = runs = 0
    for case in QBLOCK_CASES + QBLOCK_EXTRA_CASES:
        for relaxed in (False, True):
            inp = qblock_inputs(case, seed=sum(case[:7]), relaxed=relaxed)
            want = port_qblock(inp, "cuda", kernel=False)
            for tile in QBLOCK_TILES + [None]:
                got = port_qblock(inp, "cuda", kernel=True, tile=tile)
                worst = max(worst, int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()))
                runs += 1
    log(f"  qblock_chain grid: {runs} runs (cases x exact/relaxed x tiles), max|d|={worst} LSB")
    if worst:
        raise AssertionError(f"qblock_chain disagrees with its plain version on the grid: {worst} LSB")

    entry = None
    for name, case in RESNET_CHAINS.items():
        N, H, W, c0, c_mid, c_out, nblocks = case[:7]
        tile = pqb.pick_tile(N, H, W)
        for relaxed in (False, True):
            inp = qblock_inputs(case, seed=224, relaxed=relaxed)
            x = torch.from_numpy(inp["x"]).cuda()
            arrays = [torch.from_numpy(a).cuda() for a in inp["arrays"]]
            run = dict(blocks=inp["blocks"], relaxed=relaxed)
            got = pqb.qblock_chain(x, arrays, **run)
            want = pqb.qblock_chain_plain(x, arrays, **run)
            tier = "relaxed" if relaxed else "exact"
            what = (f"qblock_chain resnet50-224 b{N} {name} {tier} {H}x{W}x{c0} -> {c_mid} -> "
                    f"{c_out}, {nblocks} blocks, tile {tile}")
            if max_lsb(torch, got, want, what):
                raise AssertionError(f"{what}: kernel disagrees with its plain version")
            # ops as the JAX kernel's cost estimate counts them; bytes: the
            # chain's input and output and every weight, M and B once
            ops = sum(2 * N * H * W * (b.c_in * b.c_mid + 9 * b.c_mid * b.c_mid + b.c_mid * b.c_out
                                       + (b.c_in * b.c_out if b.proj else 0)) for b in inp["blocks"])
            moved = x.numel() + got.numel() + sum(a.numel() * a.element_size() for a in arrays)
            ms = graph_ms(lambda: pqb.qblock_chain(x, arrays, **run), iters=10)
            bound = max(moved / H100_BYTES_PER_S, ops / H100_INT8_OPS_PER_S) * 1e3
            log(f"  {what}: device {ms:.4f} ms, {ops / ms / 1e9:.1f} T int8 ops/s, "
                f"{ms / bound:.1f}x its bound {bound:.4f} ms, one launch for the {nblocks} blocks")
            if relaxed:
                continue
            if sweep:
                times = {}
                for t in pqb.TILES:
                    err = int((pqb.qblock_chain(x, arrays, tile=t, **run).int() - want.int()).abs().max())
                    if err:
                        raise AssertionError(f"{what}: tile {t} disagrees by {err} LSB")
                    times[t] = graph_ms(lambda: pqb.qblock_chain(x, arrays, tile=t, **run), iters=5)
                log("    by tile: " + ", ".join(f"{t[0]}x{t[1]} {v:.4f}" for t, v in times.items()))
            plain_ms = cuda_ms(lambda: pqb.qblock_chain_plain(x, arrays, **run), iters=2, warmup=1)
            e = kernel_entry("qblock_chain", pqb.SOURCE, pqb.REPLACES, 0, ms, plain_ms, moved,
                             ops, None)
            if name == QBLOCK_ENTRY_CHAIN:
                entry = e

    # context, not a yardstick of the same function: one stage-3 identity
    # bottleneck's three convs alone in cuDNN fp16, channels-last, no requant,
    # no residual (no single PyTorch call computes a bottleneck)
    N, H, W = RESNET_CHAINS["stage3"][:3]
    xh = torch.randn(N, 1024, H, W, device="cuda").half().contiguous(memory_format=torch.channels_last)
    ws = [torch.randn(o, c, k, k, device="cuda").half().contiguous(memory_format=torch.channels_last)
          for o, c, k in ((256, 1024, 1), (256, 256, 3), (1024, 256, 1))]

    def three_convs():
        return F.conv2d(F.conv2d(F.conv2d(xh, ws[0]), ws[1], padding=1), ws[2])

    log(f"  context: one stage-3 identity bottleneck's three cuDNN fp16 convs alone "
        f"{graph_ms(three_convs, iters=20):.4f} ms (the kernel's chain runs 6 bottlenecks)")
    return entry


@contextlib.contextmanager
def dw_gate(value):
    """TT_DW_PALLAS set to `value` (None: unset) while a graph compiles
    (kernel selection reads it), then restored."""
    before = os.environ.get("TT_DW_PALLAS")
    if value is None:
        os.environ.pop("TT_DW_PALLAS", None)
    else:
        os.environ["TT_DW_PALLAS"] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("TT_DW_PALLAS", None)
        else:
            os.environ["TT_DW_PALLAS"] = before


def dequant(torch, out, t):
    return (out.float() - float(np.asarray(t.quant.zero_points))) * float(np.asarray(t.quant.scales))


def drive(torch, cg, x_dev, counters, n_batches=3):
    """The main path's run: one untimed forward first (it pays cuDNN's
    algorithm choice and the allocator's growth), then every launch count
    set to 0, n_batches forwards timed with CUDA events, the counts read.
    Returns (last outputs, ms per batch, launches by kernel)."""
    cg(x_dev)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    batch_ms = []
    for _ in range(n_batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = cg(x_dev)
        end.record()
        torch.cuda.synchronize()
        batch_ms.append(start.elapsed_time(end))
    return outs, batch_ms, {name: c.launches for name, c in counters.items()}


def check_heads(torch, what, heads, outs, fouts, gate, out_dtype):
    """Finite fp32 heads of the int8 heads' shape; cosine of each dequantized
    int8 head against the fp32 engine's above `gate`."""
    for t, q, f in zip(heads, outs, fouts):
        if not bool(torch.isfinite(f).all()) or q.shape != f.shape or q.dtype != out_dtype:
            raise AssertionError(f"{what} head {t.name}: bad output {q.shape} {q.dtype} vs fp32 {f.shape}")
        a, b = dequant(torch, q, t).double().ravel(), f.double().ravel()
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        log(f"  {what} head {t.name} {tuple(q.shape)}: cosine vs fp32 engine {cos:.5f}")
        if not cos > gate:
            raise AssertionError(f"{what} head {t.name}: cosine {cos:.5f} <= {gate}")


def check_within_lsb(what, outs_a, outs_b, heads):
    for t, a, b in zip(heads, outs_a, outs_b):
        a = a.cpu().numpy() if hasattr(a, "cpu") else a
        b = b.cpu().numpy() if hasattr(b, "cpu") else b
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        log(f"  {what} head {t.name}: max|d|={d.max()} LSB, equal fraction {(d == 0).mean():.6f}")
        if d.max() > 1:
            raise AssertionError(f"{what} head {t.name}: {d.max()} LSB apart")


def check_tiers_agree(torch, what, outs, outs_a, heads, gate=0.99, heads_a=None):
    """Two runs' heads, each dequantized on its own grid (heads_a: outs_a's
    tensors, where they differ from heads), held to the dequantized cosine
    gate that each run meets against the fp32 engine, the LSB difference
    logged. Tiers A, B and C at 416: the direct route and the fast lowering
    fold the requant bias on the host in different precisions (float64 then
    f32, against f32 throughout, as the JAX package's two lowerings do), so
    a few near-tie elements per layer round apart and the difference
    propagates to the heads (the JAX package's tiers part the same way, from
    img 160)."""
    for t, q, a, t_a in zip(heads, outs, outs_a, heads_a or heads):
        d = (q.int() - a.int()).abs()
        x, y = dequant(torch, q, t).double().ravel(), dequant(torch, a, t_a).double().ravel()
        cos = float(x @ y / (x.norm() * y.norm() + 1e-12))
        log(f"  {what} head {t.name}: max|d|={int(d.max())} LSB, equal fraction "
            f"{float((d == 0).double().mean()):.6f}, cosine {cos:.6f}")
        if not cos > gate:
            raise AssertionError(f"{what} head {t.name}: cosine {cos:.6f} <= {gate}")


def check_tiers_exact_small(torch, tt, build_yolov3_graph, qmath, img=64, batch=2):
    """Tiers A, B and C within 1 LSB at img=64 batch 2, where the JAX
    package measures them equal bit for bit. Calibrated on the CPU, as the
    tests calibrate, so the graph is the one tests/test_torch_yolov3.py
    runs; the tiers then run on the card."""
    g = build_yolov3_graph(img=img)
    images = np.random.default_rng(1).standard_normal((batch, 3, img, img)).astype(np.float32)
    qg = tt.quantize_graph(g, [images[:1]], scheme="int8", algorithm="minmax", device="cpu")
    t_in = qg.tensors[qg.input_tensors[0]]
    x = torch.from_numpy(qmath.quantize_np(images, t_in.quant, t_in.dtype)).cuda()
    outs = {}
    for tier, (extra, _) in YOLOV3_TIERS.items():
        opts = dict(quant_mode="fast", quant_bf16_storage=False, batch_size=batch, **extra)
        cg = tt.compile_graph(qg, tt.Options(**opts))
        outs[tier] = cg(x)
    heads = [cg.graph.tensors[t] for t in cg.output_ids]
    for tier in ("B", "C"):
        check_within_lsb(f"yolov3-{img} b{batch} {tier} vs A", outs[tier], outs["A"], heads)


def check_fastest_small(torch, tt, build_yolofastest_graph, qmath, img=64):
    """YOLO-Fastest's tier E against D at img=64 batch 32, calibrated on the
    CPU, so the graphs and data are those of tests/test_torch_yolofastest.py;
    the tiers then run on the card. INT8: within 1 LSB. UINT8: within 8 LSB
    and 85% of the elements equal: the two routes fold the input zero-point
    term differently (module docstring), so whether they part depends on
    whether an element meets a .5 tie. That test measures 3 LSB and 97% on
    the graph the JAX package quantized; on this one, 0 LSB so far."""
    g = build_yolofastest_graph(img=img)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((FASTEST_BATCH, 3, img, img)).astype(np.float32)
    for scheme in ("int8", "uint8"):
        qg = tt.quantize_graph(g, [images[:1]], scheme=scheme, algorithm="minmax", device="cpu")
        t_in = qg.tensors[qg.input_tensors[0]]
        x = torch.from_numpy(qmath.quantize_np(images, t_in.quant, t_in.dtype)).cuda()
        outs = {}
        for tier, (gate, _, _) in FASTEST_TIERS.items():
            with dw_gate(gate):
                cg = tt.compile_graph(qg, tt.Options(**FASTEST_OPTS))
            outs[tier] = cg(x)
        heads = [cg.graph.tensors[t] for t in cg.output_ids]
        what = f"yolofastest-{img} {scheme} b{FASTEST_BATCH} E vs D"
        if scheme == "int8":
            check_within_lsb(what, outs["E"], outs["D"], heads)
            continue
        for t, a, b in zip(heads, outs["E"], outs["D"]):
            d = (a.int() - b.int()).abs()
            equal = float((d == 0).double().mean())
            log(f"  {what} head {t.name}: max|d|={int(d.max())} LSB, equal fraction {equal:.6f}")
            if int(d.max()) > 8 or equal < 0.85:
                raise AssertionError(f"{what} head {t.name}: {int(d.max())} LSB, {equal:.4f} equal")


def check_resnet_small(torch, tt, ir, qmath):
    """ResNet-50's tiers against each other on the card at small sizes,
    calibrated on the CPU as the tests calibrate. G against F at img=32,
    widths/8, depths (2, 2, 2, 2), batch 2 (the graph of
    tests/test_torch_resnet.py): within 1 LSB at the logits. R against F at
    the output of the full-width stage-1 chain (img=64, 3 bottlenecks, no
    head, batch 4): the relaxed tier's bounds (tests/test_relaxed_tier.py)."""
    def run_tiers(tiers, batch, **cfg):
        g = build_resnet50_graph(ir, **cfg)
        images = np.random.default_rng(1).standard_normal(
            (batch, 3, cfg["img"], cfg["img"])).astype(np.float32)
        qg = tt.quantize_graph(g, [images[:1]], scheme="int8", algorithm="minmax", device="cpu")
        t_in = qg.tensors[qg.input_tensors[0]]
        x = torch.from_numpy(qmath.quantize_np(images, t_in.quant, t_in.dtype)).cuda()
        outs = {}
        for tier in tiers:
            opts = dict(quant_mode="fast", batch_size=batch, **RESNET_TIERS[tier][0])
            cg = tt.compile_graph(qg, tt.Options(**opts))
            outs[tier] = cg(x)
        return outs, [cg.graph.tensors[t] for t in cg.output_ids]

    outs, heads = run_tiers("FG", 2, img=32, classes=16, widths=(8, 16, 32, 64), depths=(2, 2, 2, 2))
    check_within_lsb("resnet50-32 widths/8 b2 G vs F", outs["G"], outs["F"], heads)
    outs, _ = run_tiers("FR", 4, img=64, widths=RESNET50_WIDTHS[:1], depths=RESNET50_DEPTHS[:1],
                        head=False)
    d = (outs["R"][0].int() - outs["F"][0].int()).abs()
    worst, over1, over3 = int(d.max()), float((d > 1).double().mean()), float((d > 3).double().mean())
    log(f"  resnet50 stage-1 chain {tuple(d.shape)} R vs F: max|d|={worst} LSB, "
        f"{over1:.4f} beyond 1 LSB, {over3:.6f} beyond 3")
    if worst > 6 or over1 >= 0.10 or over3 >= 0.01:
        raise AssertionError("resnet50 stage-1 chain: R leaves the relaxed tier's bounds against F")


def run_default_tiers(torch, tt, qmath, counters, graphs, images):
    """Phase 3e: tiers I-L at 224 and DEFAULT_BATCH under default Options on
    the float graphs `graphs` ({"resnet50": ..., "mobilenet-v1": ...}), each
    calibrated on the card from images[:1], one untimed and 3 timed
    batches, its routes and storage plan checked from the compiled graph and
    its launch counts exact. Returns {tier: (CompiledGraph, outputs, opts,
    TT_DW_PALLAS, quantized graph, quantized input)}."""
    qgs, out = {}, {}
    for tier, (net, scheme, algorithm, extra, gate, plan, per_forward) in DEFAULT_TIERS.items():
        t1 = time.time()
        if (net, scheme, algorithm) not in qgs:
            qg = tt.quantize_graph(graphs[net], [images[:1]], scheme=scheme, algorithm=algorithm)
            t_in = qg.tensors[qg.input_tensors[0]]
            xq = qmath.quantize_np(images, t_in.quant, t_in.dtype)
            qgs[net, scheme, algorithm] = (qg, xq, torch.from_numpy(xq).cuda())
            log(f"  {net} {scheme} {algorithm} set-up (build graph, calibrate): "
                f"{time.time() - t1:.1f} s")
        qg, xq, x_dev = qgs[net, scheme, algorithm]
        opts = dict(quant_mode="fast", batch_size=DEFAULT_BATCH, **extra)
        with dw_gate(gate):
            cg = tt.compile_graph(qg, tt.Options(**opts))
        g = cg.graph
        routes = [cg.kernels[n.name] for n in g.nodes if n.op == "Convolution"]
        n_dw = per_forward.get("dw_qconv", 0)
        want_routes = (n_dw, len(routes) - n_dw)
        got_routes = (routes.count("lower_conv_quant_pallas_dw"), routes.count("lower_conv_quant_fast"))
        shifted = [t for t in g.tensors if t.quant is not None and t.quant.full_range]
        took_plan = getattr(g, "_bf16_tids", None) == set()
        if (got_routes != want_routes or len(routes) != (53 if net == "resnet50" else 27)
                or any(n.op == "FusedResBlockChain" for n in g.nodes) or took_plan != plan
                or bool(shifted) != (plan and scheme == "uint8")):
            raise AssertionError(f"{net} {scheme} {tier}: convs by route {got_routes}, expected "
                                 f"{want_routes}; native-int8 plan {took_plan}, {len(shifted)} "
                                 f"shifted tensors")
        outs, batch_ms, launches = drive(torch, cg, x_dev, counters)
        want = dict.fromkeys(counters, 0) | {name: 3 * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{net} {scheme} {tier}: launches {launches}, expected {want}")
        out[tier] = (cg, outs, opts, gate, qg, xq)
        med = float(np.median(batch_ms))
        log(f"phase 3 main path: {net}-224 {scheme} ({algorithm}) batch {DEFAULT_BATCH} tier "
            f"{tier} Options({opts}) TT_DW_PALLAS={gate}: native-int8 plan {took_plan} "
            f"({len(shifted)} tensors shifted to full-range int8), ms/batch {batch_ms} (median "
            f"{med:.3f}), {DEFAULT_BATCH * 1e3 / med:.1f} img/s, launches {launches} "
            f"[{time.time() - t1:.1f} s]")
    return out


def check_default_tiers(torch, tt, default, fp32, resnet_r):
    """Phase 4 for tiers I-L: the logits' dequantized cosine against the fp32
    engine > 0.99 with top-1 agreement printed; each tier's card run within
    1 LSB of the port's CPU run (same Options and TT_DW_PALLAS, the same
    routes) on the first image; I against R (same net, MinMax and the
    relaxed chains, batch RESNET_BATCH: the first RESNET_BATCH images) and
    L against K by cosine > 0.99."""
    def logits(cg):
        return [cg.graph.tensors[t] for t in cg.output_ids]

    for tier, (cg, outs, opts, gate, qg, xq) in default.items():
        net, scheme = DEFAULT_TIERS[tier][:2]
        heads = logits(cg)
        out_dtype = torch.uint8 if scheme == "uint8" else torch.int8
        check_heads(torch, f"{net} {scheme} {tier}", heads, outs, fp32[net], 0.99, out_dtype)
        if outs[0].shape != (DEFAULT_BATCH, 1000, 1, 1):
            raise AssertionError(f"{net} {tier}: logits of shape {tuple(outs[0].shape)}")
        top1 = (outs[0].reshape(DEFAULT_BATCH, -1).argmax(1)
                == fp32[net][0].reshape(DEFAULT_BATCH, -1).argmax(1)).double().mean()
        log(f"  {net} {scheme} {tier}: top-1 agreement with the fp32 engine {float(top1):.4f} "
            f"over {DEFAULT_BATCH} images")
        t1 = time.time()
        with dw_gate(gate):  # the same Options: the dw gate reads batch_size
            cg_cpu = tt.compile_graph(qg, tt.Options(**opts), device="cpu")
        if cg_cpu.kernels != cg.kernels:
            raise AssertionError(f"{net} {scheme} {tier}: the CPU compile took other routes")
        couts = cg_cpu.run(xq[:1])
        log(f"  {net}-224 {scheme} {tier} on the CPU, image 0: {time.time() - t1:.1f} s")
        check_within_lsb(f"{net} {scheme} {tier} card vs CPU (image 0)", [o[:1] for o in outs],
                         couts, heads)

    (cg_i, outs_i), (cg_r, outs_r) = default["I"][:2], resnet_r[:2]
    check_tiers_agree(torch, f"resnet50-224 I (KL, default Options) vs R (MinMax, relaxed "
                      f"chains), first {RESNET_BATCH} images", [outs_i[0][:RESNET_BATCH]],
                      outs_r, logits(cg_i), heads_a=logits(cg_r))
    (cg_l, outs_l), (cg_k, outs_k) = default["L"][:2], default["K"][:2]
    check_tiers_agree(torch, "mobilenet-v1-224 L (plan, dw_qconv) vs K (default route)", outs_l,
                      outs_k, logits(cg_l), heads_a=logits(cg_k))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import tengine_tpu_torch as tt
    from tengine_tpu_torch.models.darknet_zoo import build_yolofastest_graph, build_yolov3_graph
    from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph
    from tengine_tpu_torch.ops import qmath
    from tengine_tpu_torch.ops.cuda import build
    from tengine_tpu_torch.graph import ir
    from tengine_tpu_torch.ops.cuda.dw_conv import dw_qconv
    from tengine_tpu_torch.ops.cuda.qblock import qblock_chain
    from tengine_tpu_torch.ops.cuda.qconv import qconv1x1, qconv_direct
    from tengine_tpu_torch.ops.cuda.qgemm import qgemm_requant
    from tengine_tpu_torch.ops.cuda.stem_conv import stem_qconv

    t_start = time.time()
    gpu = gpu_name_and_power_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} [{gpu}]")

    # 1. build
    t0 = time.time()
    build.build_all()
    log(f"phase 1 build: {time.time() - t0:.1f} s")

    # 2. kernels against their plain versions
    t0 = time.time()
    entries = {"stem_qconv": check_stem_kernel(torch)}
    check_igemm_grid(torch)
    check_tensor_core_sass(build)
    entries.update(check_igemm_main(torch, sweep="--tiles" in argv))
    entries["dw_qconv"] = check_dw_kernel(torch, sweep="--tiles" in argv)
    entries["qblock_chain"] = check_qblock_kernel(torch, sweep="--tiles" in argv)
    counters = {"stem_qconv": stem_qconv, "qconv_direct": qconv_direct, "qconv1x1": qconv1x1,
                "qgemm_requant": qgemm_requant, "dw_qconv": dw_qconv, "qblock_chain": qblock_chain}
    log(f"phase 2 kernels: {time.time() - t0:.1f} s")

    # 3a. main path: yolov5s-640 INT8 at batch 8
    t0 = time.time()
    batch, img = 8, 640
    _, g5 = build_yolov5s_graph(num_classes=80, img=img)
    rng = np.random.default_rng(0)
    images5 = rng.standard_normal((batch, 3, img, img)).astype(np.float32)
    qg5 = tt.quantize_graph(g5, [images5[:1]], scheme="int8", algorithm="minmax")
    cg5 = tt.compile_graph(qg5, tt.Options(quant_mode="fast", batch_size=batch))
    stems = [n for n, k in cg5.kernels.items() if k == "lower_conv_quant_pallas_stem"]
    if len(stems) != 1:
        raise AssertionError(f"expected one stem-kernel node, got {stems}")
    t_in = qg5.tensors[qg5.input_tensors[0]]
    xq5 = qmath.quantize_np(images5, t_in.quant, t_in.dtype)
    x5 = torch.from_numpy(xq5).cuda()
    log(f"  yolov5s set-up (build graph, calibrate, compile): {time.time() - t0:.1f} s")
    outs5, batch_ms, launches = drive(torch, cg5, x5, counters)
    want = dict.fromkeys(counters, 0) | {"stem_qconv": 3}
    if launches != want:
        raise AssertionError(f"yolov5s launches {launches}, expected {want}")
    entries["stem_qconv"]["launches"] = launches["stem_qconv"]
    med = float(np.median(batch_ms))
    log(f"phase 3 main path: yolov5s-{img} int8 batch {batch}: ms/batch {batch_ms} "
        f"(median {med:.3f}), {batch * 1e3 / med:.1f} img/s, launches {launches} "
        f"[{time.time() - t0:.1f} s]")

    # 3b. main path: yolov3-416 INT8 at batch 8 on the integer-storage tier
    t0 = time.time()
    img3 = 416
    g3 = build_yolov3_graph(img=img3)
    images3 = np.random.default_rng(0).standard_normal((batch, 3, img3, img3)).astype(np.float32)
    qg3 = tt.quantize_graph(g3, [images3[:1]], scheme="int8", algorithm="minmax")
    t_in = qg3.tensors[qg3.input_tensors[0]]
    xq3 = qmath.quantize_np(images3, t_in.quant, t_in.dtype)
    x3 = torch.from_numpy(xq3).cuda()
    log(f"  yolov3 set-up (build graph, calibrate): {time.time() - t0:.1f} s")
    tiers = {}
    for tier, (extra, per_forward) in YOLOV3_TIERS.items():
        t1 = time.time()
        opts = dict(quant_mode="fast", quant_bf16_storage=False, batch_size=batch, **extra)
        cg3 = tt.compile_graph(qg3, tt.Options(**opts))
        outs3, batch_ms, launches = drive(torch, cg3, x3, counters)
        want = dict.fromkeys(counters, 0) | {name: 3 * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"yolov3 {tier}: launches {launches}, expected {want}")
        tiers[tier] = (cg3, outs3, opts)
        med = float(np.median(batch_ms))
        log(f"phase 3 main path: yolov3-{img3} int8 batch {batch} tier {tier} {extra}: ms/batch "
            f"{batch_ms} (median {med:.3f}), {batch * 1e3 / med:.1f} img/s, launches {launches} "
            f"[{time.time() - t1:.1f} s]")
    entries["qconv_direct"]["launches"] = 3 * YOLOV3_TIERS["A"][1]["qconv_direct"]
    entries["qconv1x1"]["launches"] = 3 * YOLOV3_TIERS["A"][1]["qconv1x1"]
    entries["qgemm_requant"]["launches"] = 3 * YOLOV3_TIERS["B"][1]["qgemm_requant"]

    # 3c. main path: YOLO-Fastest-320 at batch 32 on the integer-storage tier,
    # the depthwise convs on dw_qconv (D) or on the fast lowering (E)
    t0 = time.time()
    imgf = 320
    gf = build_yolofastest_graph(img=imgf)
    imagesf = np.random.default_rng(0).standard_normal(
        (FASTEST_BATCH, 3, imgf, imgf)).astype(np.float32)
    fastest = {}
    for scheme in ("int8", "uint8"):
        qgf = tt.quantize_graph(gf, [imagesf[:1]], scheme=scheme, algorithm="minmax")
        t_in = qgf.tensors[qgf.input_tensors[0]]
        xqf = qmath.quantize_np(imagesf, t_in.quant, t_in.dtype)
        xf = torch.from_numpy(xqf).cuda()
        for tier, (gate, per_forward, n_fast) in FASTEST_TIERS.items():
            t1 = time.time()
            with dw_gate(gate):
                cgf = tt.compile_graph(qgf, tt.Options(**FASTEST_OPTS))
            routes = [cgf.kernels[n.name] for n in cgf.graph.nodes if n.op == "Convolution"]
            by_route = (routes.count("lower_conv_quant_pallas_dw"),
                        routes.count("lower_conv_quant_pallas_direct"),
                        routes.count("lower_conv_quant_fast"))
            if by_route != (per_forward["dw_qconv"], per_forward["qconv1x1"], n_fast):
                raise AssertionError(f"yolofastest {scheme} {tier}: convs by route {by_route}")
            outsf, batch_ms, launches = drive(torch, cgf, xf, counters)
            want = dict.fromkeys(counters, 0) | {name: 3 * n for name, n in per_forward.items()}
            if launches != want:
                raise AssertionError(f"yolofastest {scheme} {tier}: launches {launches}, expected {want}")
            fastest[scheme, tier] = (cgf, outsf, qgf, xqf, xf)
            med = float(np.median(batch_ms))
            log(f"phase 3 main path: yolofastest-{imgf} {scheme} batch {FASTEST_BATCH} tier {tier} "
                f"(TT_DW_PALLAS={gate}): ms/batch {batch_ms} (median {med:.3f}), "
                f"{FASTEST_BATCH * 1e3 / med:.1f} img/s, launches {launches} [{time.time() - t1:.1f} s]")
    entries["dw_qconv"]["launches"] = 3 * FASTEST_TIERS["D"][1]["dw_qconv"]
    log(f"  yolofastest in all: {time.time() - t0:.1f} s")

    # 3d. main path: ResNet-50-224 INT8 at batch 32, the bottlenecks on
    # qblock_chain (F exact, R relaxed) or on the fast lowering (G)
    t0 = time.time()
    imgr = 224
    gr = build_resnet50_graph(ir, img=imgr)
    imagesr = np.random.default_rng(0).standard_normal(
        (RESNET_BATCH, 3, imgr, imgr)).astype(np.float32)
    qgr = tt.quantize_graph(gr, [imagesr[:1]], scheme="int8", algorithm="minmax")
    t_in = qgr.tensors[qgr.input_tensors[0]]
    xqr = qmath.quantize_np(imagesr, t_in.quant, t_in.dtype)
    xr = torch.from_numpy(xqr).cuda()
    log(f"  resnet50 set-up (build graph, calibrate): {time.time() - t0:.1f} s")
    resnet = {}
    for tier, (extra, per_forward) in RESNET_TIERS.items():
        t1 = time.time()
        opts = dict(quant_mode="fast", batch_size=RESNET_BATCH, **extra)
        cgr = tt.compile_graph(qgr, tt.Options(**opts))
        chains = [len(n.params["blocks"]) for n in cgr.graph.nodes if n.op == "FusedResBlockChain"]
        convs = [n for n in cgr.graph.nodes if n.op == "Convolution"]
        if (chains, len(convs)) != (([3, 4, 6, 3], 1) if "qblock_chain" in per_forward else ([], 53)):
            raise AssertionError(f"resnet50 {tier}: chains {chains}, {len(convs)} convs left")
        routed = [cgr.kernels[n.name] for n in convs].count("lower_conv_quant_pallas_direct")
        if tier == "H":
            # from the IR: a conv takes the kernel if it is 1x1, or k x k with
            # C_in % 128 == 0; the 1x1 convs go to qconv1x1 (the stride-2 ones
            # after a subsample), the FC to qgemm_requant
            ks = [(n.params["kernel_h"], int(cgr.graph.tensors[n.inputs[1]].shape[1])) for n in convs]
            derived = {"qconv_direct": sum(k > 1 and c % 128 == 0 for k, c in ks),
                       "qconv1x1": sum(k == 1 for k, _ in ks), "qgemm_requant": 1}
            fc = [cgr.kernels[n.name] for n in cgr.graph.nodes if n.op == "FullyConnected"]
            if derived != per_forward or routed != 49 or fc != ["lower_fc_quant_pallas"]:
                raise AssertionError(f"resnet50 H: the IR gives {derived}, {routed} convs took "
                                     f"the kernel's lowering, FC on {fc}")
        elif routed:
            raise AssertionError(f"resnet50 {tier}: a conv left the fast lowering")
        outsr, batch_ms, launches = drive(torch, cgr, xr, counters)
        want = dict.fromkeys(counters, 0) | {name: 3 * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"resnet50 {tier}: launches {launches}, expected {want}")
        resnet[tier] = (cgr, outsr, opts)
        med = float(np.median(batch_ms))
        log(f"phase 3 main path: resnet50-{imgr} int8 batch {RESNET_BATCH} tier {tier} {extra}: "
            f"ms/batch {batch_ms} (median {med:.3f}), {RESNET_BATCH * 1e3 / med:.1f} img/s, "
            f"launches {launches} [{time.time() - t1:.1f} s]")
    entries["qblock_chain"]["launches"] = 3 * RESNET_TIERS["F"][1]["qblock_chain"]
    log(f"  resnet50 in all: {time.time() - t0:.1f} s")

    # 3e. main path: bench.py's configs under default Options at batch 128,
    # ResNet-50-224 INT8 (KL) and UINT8 on the native-int8 plan (I, J), the
    # mobilenet-v1-224 UINT8 headline on the default route (K) and on the
    # plan with its depthwise convs on dw_qconv (L)
    t0 = time.time()
    graphs = {"resnet50": gr, "mobilenet-v1": build_mobilenet_v1_graph(ir, img=imgr)}
    images_d = np.random.default_rng(0).standard_normal(
        (DEFAULT_BATCH, 3, imgr, imgr)).astype(np.float32)
    default = run_default_tiers(torch, tt, qmath, counters, graphs, images_d)
    entries["dw_qconv"]["launches"] += 3 * DEFAULT_TIERS["L"][-1]["dw_qconv"]
    log(f"  default-Options tiers in all: {time.time() - t0:.1f} s")


    # 4. correctness: fp32 engine on the card, and the port's CPU run
    t0 = time.time()
    heads5 = [cg5.graph.tensors[t] for t in cg5.output_ids]
    fouts5 = tt.compile_graph(g5, tt.Options(precision="fp32", batch_size=batch))(
        torch.from_numpy(images5).cuda())
    check_heads(torch, "yolov5s", heads5, outs5, fouts5, 0.95, torch.int8)
    couts5 = tt.compile_graph(qg5, tt.Options(quant_mode="fast", batch_size=1), device="cpu").run(xq5[:1])
    check_within_lsb("yolov5s card vs CPU (image 0)", [o[:1] for o in outs5], couts5, heads5)

    cg3a, outs3a, opts_a = tiers["A"]
    heads3 = [cg3a.graph.tensors[t] for t in cg3a.output_ids]
    fouts3 = tt.compile_graph(g3, tt.Options(precision="fp32", batch_size=batch))(
        torch.from_numpy(images3).cuda())
    check_heads(torch, "yolov3 A", heads3, outs3a, fouts3, 0.99, torch.int8)
    for tier in ("B", "C"):
        check_tiers_agree(torch, f"yolov3-{img3} {tier} vs A", tiers[tier][1], outs3a, heads3)
    check_tiers_exact_small(torch, tt, build_yolov3_graph, qmath)
    for tier, (_, outs3, opts) in tiers.items():
        t1 = time.time()
        couts3 = tt.compile_graph(qg3, tt.Options(**dict(opts, batch_size=1)), device="cpu").run(xq3[:1])
        log(f"  yolov3-{img3} {tier} on the CPU, image 0: {time.time() - t1:.1f} s")
        check_within_lsb(f"yolov3 {tier} card vs CPU (image 0)", [o[:1] for o in outs3], couts3, heads3)

    foutsf = tt.compile_graph(gf, tt.Options(precision="fp32", batch_size=FASTEST_BATCH))(
        torch.from_numpy(imagesf).cuda())
    for scheme in ("int8", "uint8"):
        cgd, outsd, qgf, xqf, _ = fastest[scheme, "D"]
        headsf = [cgd.graph.tensors[t] for t in cgd.output_ids]
        out_dtype = torch.uint8 if scheme == "uint8" else torch.int8
        check_heads(torch, f"yolofastest {scheme} D", headsf, outsd, foutsf, 0.99, out_dtype)
        check_tiers_agree(torch, f"yolofastest-{imgf} {scheme} E vs D", fastest[scheme, "E"][1],
                          outsd, headsf)
        with dw_gate(FASTEST_TIERS["D"][0]):
            cg_cpu = tt.compile_graph(qgf, tt.Options(**FASTEST_OPTS), device="cpu")
        if cg_cpu.kernels != cgd.kernels:
            raise AssertionError(f"yolofastest {scheme} D: the CPU compile took other routes")
        check_within_lsb(f"yolofastest {scheme} D card vs CPU (image 0)", [o[:1] for o in outsd],
                         cg_cpu.run(xqf[:1]), headsf)
    check_fastest_small(torch, tt, build_yolofastest_graph, qmath)

    cg_f, outs_f, opts_f = resnet["F"]
    logits = [cg_f.graph.tensors[t] for t in cg_f.output_ids]
    foutsr = tt.compile_graph(gr, tt.Options(precision="fp32", batch_size=RESNET_BATCH))(
        torch.from_numpy(imagesr).cuda())
    for tier, (_, outsr, _) in resnet.items():
        check_heads(torch, f"resnet50 {tier}", logits, outsr, foutsr, 0.99, torch.int8)
        if outsr[0].shape != (RESNET_BATCH, 1000, 1, 1):
            raise AssertionError(f"resnet50 {tier}: logits of shape {tuple(outsr[0].shape)}")
        top1 = (outsr[0].reshape(RESNET_BATCH, -1).argmax(1)
                == foutsr[0].reshape(RESNET_BATCH, -1).argmax(1)).double().mean()
        log(f"  resnet50 {tier}: top-1 agreement with the fp32 engine {float(top1):.4f} "
            f"over {RESNET_BATCH} images")
    for tier in ("G", "R"):
        check_tiers_agree(torch, f"resnet50-{imgr} {tier} vs F", resnet[tier][1], outs_f, logits)
    check_tiers_agree(torch, f"resnet50-{imgr} H vs G", resnet["H"][1], resnet["G"][1], logits)
    for tier in ("F", "H"):
        t1 = time.time()
        opts = dict(resnet[tier][2], batch_size=1)
        coutsr = tt.compile_graph(qgr, tt.Options(**opts), device="cpu").run(xqr[:1])
        log(f"  resnet50-{imgr} {tier} on the CPU, image 0: {time.time() - t1:.1f} s")
        check_within_lsb(f"resnet50 {tier} card vs CPU (image 0)",
                         [o[:1] for o in resnet[tier][1]], coutsr, logits)
    check_resnet_small(torch, tt, ir, qmath)
    images_dev = torch.from_numpy(images_d).cuda()
    fp32 = {net: tt.compile_graph(g, tt.Options(precision="fp32", batch_size=DEFAULT_BATCH))(
        images_dev) for net, g in graphs.items()}
    check_default_tiers(torch, tt, default, fp32, resnet["R"])
    log(f"phase 4 check: {time.time() - t0:.1f} s")

    if "--profile" in argv:
        profile_batch(torch, cg5, x5)
        profile_batch(torch, cg3a, x3)
        profile_batch(torch, fastest["int8", "D"][0], fastest["int8", "D"][4])
        profile_batch(torch, resnet["F"][0], xr)
        profile_batch(torch, resnet["H"][0], xr)
        for tier, (cg, _, _, _, _, xq) in default.items():
            log(f"profile of tier {tier}:")
            profile_batch(torch, cg, torch.from_numpy(xq).cuda())

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "tengine_tpu"))
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked[:5]}")
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(gpu_name_and_power_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def profile_batch(torch, cg, x_dev) -> None:
    """Device time by kernel over one batch, and the device's busy share of
    the batch's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cg(x_dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cg(x_dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def self_device_us(r):  # the attribute's name changed across torch versions
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0)

    # device-side rows only: the aten:: rows repeat the time of their kernels
    dev = [(r.key, self_device_us(r) / 1e3, r.count) for r in prof.key_averages()
           if r.device_type == DeviceType.CUDA and self_device_us(r) > 0]
    total = sum(ms for _, ms, _ in dev)
    log(f"profile: one batch, wall {wall_ms:.3f} ms, kernels {total:.3f} ms, "
        f"device idle {100 * (1 - total / wall_ms):.1f}% of the wall time, "
        f"{sum(c for _, _, c in dev)} kernel launches")
    ranked = sorted(dev, key=lambda r: -r[1])

    def is_own(key):  # the port's hand-written kernels
        return any(k in key for k in ("qconv", "qblock")) and "at::" not in key

    own = [r for r in ranked[15:] if is_own(r[0])]
    for key, ms, count in ranked[:15] + own:  # the top 15, then the port's own kernels below them
        log(f"  {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{count:<4d} {key[:90]}")
    # the library's convolution and GEMM kernels: on a quantized net, the fast
    # lowering's exact float64 convs and the FC's float64 product
    lib = [(ms, c) for k, ms, c in dev
           if not is_own(k) and any(w in k.lower() for w in ("conv", "dgemm", "gemm"))]
    lib_ms = sum(ms for ms, _ in lib)
    log(f"  library conv/GEMM kernels (float64 on a quantized net): {lib_ms:.3f} ms, "
        f"{100 * lib_ms / max(total, 1e-9):.1f}% of the kernel time, {sum(c for _, c in lib)} "
        f"launches")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
