#!/usr/bin/env python3
"""Run the PyTorch port (tengine_tpu_torch) on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # the check, on one card
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one
                                     # captured batch of every tier (YOLO-Fastest
                                     # int8 only): kernels, launches, the card's
                                     # idle share
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
  3. main path every tier below runs through the compiled forward
               (CompiledGraph.__call__: a CUDA graph captured at the first
               call, replayed after) and then eagerly (forward_fn) on the same
               batch (drive): the first call untimed (a warm-up forward, the
               capture, a replay), 3 captured batches timed with CUDA events
               around the call, then one untimed and 3 timed eager batches;
               captured = eager at 0 LSB required; the device launches a
               forward from cost_analysis(). Each tier's CompiledGraph, and
               with it its CUDA graph's memory pool, is dropped before the
               next tier. yolov5s 640x640 INT8 (MinMax), seed-0 weights:
               quantize_graph on the card with one seeded calibration image,
               compile_graph at batch 8: the stem on stem_qconv, the other
               80 convs on qconv_fast (the fast lowering's INT8 convs at
               zero point 0, fast_igemm below; 0 LSB from its plain
               version, the float64 chain, required). Then
               yolov3 416x416 INT8 (MinMax, seed-0 weights) on the
               integer-storage tier, batch 8, under each of
                 A  Options(quant_mode="fast", quant_bf16_storage=False):
                    qconv_direct and qconv1x1
                 B  A + pallas_qconv=False, pallas_qgemm=True: qgemm_requant
                 C  A + pallas_qconv=False: every conv on the fast
                    lowering, and so on qconv_fast
               (qconv_fast takes 6, 41 and 75 convs a forward).
               Then YOLO-Fastest 320x320 (seed-0 weights, MinMax from one
               seeded image) at batch 32 on the same integer-storage tier,
               INT8 and then UINT8, under
                 D  TT_DW_PALLAS=1: the 13 depthwise convs on dw_qconv, the
                    29 1x1 convs on qconv1x1, the stem on the fast lowering
                    (on qconv_fast in the INT8 graph)
                 E  TT_DW_PALLAS=0: the 13 on the fast lowering too (the
                    port's own "before").
               Then ResNet-50 224x224 INT8 (build_resnet50_graph below:
               the published widths and depths, seed-0 weights, MinMax from
               one seeded image) at batch 32, under each of
                 F  Options(quant_mode="fast", fuse_resblock=True,
                    quant_relaxed=False): the 16 bottlenecks as 4
                    FusedResBlockChain nodes (3, 4, 6, 3 blocks) on
                    qblock_chain, one launch per chain, exact epilogue;
                    stem and FC on the fast lowerings (the stem on
                    qconv_fast)
                 R  F + quant_relaxed=True, quant_native="off": the kernel's
                    relaxed epilogue, one rounding per block
                 G  F without fuse_resblock: the 52 bottleneck convs on the
                    fast lowering with fuse_conv_add, all 53 convs on
                    qconv_fast.
                 H  G + quant_bf16_storage=False, pallas_qgemm=True: conv by
                    conv on the implicit-GEMM kernel, 13 qconv_direct (the
                    3x3 convs with C_in % 128 == 0), 36 qconv1x1 (the fused
                    residual among them), the FC on qgemm_requant; the stem
                    and stage 1's 3x3 convs stay on the fast lowering, on
                    qconv_fast.
               Then bench.py's own configs under default Options,
               Options(quant_mode="fast", batch_size=128), at 224 and batch
               128 (seed-0 weights, calibrated from one seeded image):
                 I  ResNet-50 INT8, KL calibration: the native-int8 plan
                    (a no-op on a symmetric INT8 graph); no chains, every
                    conv on the fast lowering, on qconv_fast
                 J  ResNet-50 UINT8, MinMax: the plan's UINT8 -> INT8
                    shift; no kernel launched
                 K  mobilenet-v1 UINT8, MinMax (build_mobilenet_v1_graph
                    below), TT_DW_PALLAS unset: the default route (no plan
                    on a depthwise net), every conv on the fast lowering
                 L  K with quant_native="on" and TT_DW_PALLAS=1: the plan,
                    the 13 depthwise convs on dw_qconv on shifted INT8
                 M  K at batch 1 (bench.py:221-238, bench_model_quant_b1:
                    the headline's batch-1 latency).
               Then mobilenet-SSD-300 UINT8 (build_mobilenet_ssd_graph
               below: chuanqi305's deploy.prototxt at its widths, 21
               classes, 1,917 priors, the NMS on the card; seed-0 weights,
               MinMax from one seeded image; bench.py:388's config) under
                 SSD-S  Options(quant_mode="fast", batch_size=8): every conv
                        on the fast lowering
                 SSD-T  SSD-S + quant_bf16_storage=False: 29 1x1 convs on
                        qconv1x1, the extras' three 3x3 s2 convs with
                        C_in % 128 == 0 on qconv_direct
                 SSD-U  SSD-T at batch 32 with TT_DW_PALLAS=1: the 13
                        depthwise convs on dw_qconv too;
               each tier's kernel launches of one more eager forward held
               against their plain versions on the same inputs (the path's
               own shapes), each of the first 8 images' detection rows at
               batch 1 against its rows in the batch (labels and scores
               equal, boxes within 1e-5), at least 10 valid rows an image.
               Then the face pipeline (bench.py:265-298): RetinaFace
               mnet0.25 320x240 UINT8 at batch 1 and MobileFaceNet-112
               UINT8 at batch 8 (build_retinaface_mnet_graph,
               build_mobilefacenet_graph below; seed-0 weights, MinMax
               from one seeded image each) under
                 FACE-S  Options(quant_mode="fast", batch_size=...): every
                         conv on the fast lowering; PReLU, Softmax, Crop,
                         BatchNormalization and L2Normalization through
                         the generic wrapper
                 FACE-T  FACE-S + quant_bf16_storage=False: every group-1
                         1x1 conv on qconv1x1 (25 and 31 a forward; no
                         k x k conv has C_in % 128 == 0)
                 FACE-U  MobileFaceNet alone at batch 32, FACE-T with
                         TT_DW_PALLAS=1: its 16 3x3 depthwise convs on
                         dw_qconv too, the 7x7 GDConv on the fast lowering;
               the detect ms, embed ms and frames/s = 1000 / (detect +
               embed) of FACE-S and FACE-T, captured and eager. Then
               shufflenet-v2 1.0x 224 UINT8 (build_shufflenet_v2_graph
               below) at batch 32 under
                 SHUF-T  Options(quant_mode="fast", quant_bf16_storage=
                         False): fold_shuffle_gathers folds its 16
                         shuffles (ChannelGather nodes on the
                         passthrough, scattered and permuted 1x1 weights),
                         its 36 1x1 convs on qconv1x1.
               Each face and shufflenet tier is checked right after it
               runs (run_quant_tier): its kernels' launches derived from
               the IR, the fold count, every kernel launch of one eager
               forward against its plain version, each output's cosine
               against the fp32 engine > 0.99, the first 8 images at batch
               1 equal to their rows in the batch, and the card within
               1 LSB of the port's CPU run with the same Options on image 0.
               Then the transformers (models/transformer_zoo.py) INT8 at
               batch 1, MinMax from one seeded image: ViT at DeiT-Ti's
               widths and depth (224, patch 16, dim 192, 12 blocks, 3
               heads, 1000 classes) and SegFormer at the ADE20K setting
               (512x512, 150 classes, the builder's widths), under
                 VIT-S, SEG-S  Options(quant_mode="fast"): every MatMul,
                         LayerNorm, SwapAxis, Softmax, Gelu and Reduction
                         through the generic wrapper, the convs and the FC
                         on the fast lowerings
                 VIT-T   VIT-S + quant_bf16_storage=False, pallas_qgemm=
                         True: the head FC ([1, 192] x [192, 1000]) on
                         qgemm_requant
                 SEG-T   SEG-S + quant_bf16_storage=False: the decoder's
                         four split fuse convs and classify on qconv1x1,
                         embeds/3 and stage 3's two spatial reductions on
                         qconv_direct;
               each checked right after it runs (run_transformer_tiers):
               launches derived from the IR, every kernel launch against
               its plain version, the dequantized output's cosine against
               the fp32 engine (> 0.95 ViT, > 0.99 SegFormer), the card
               held to the port's CPU run node by node, each node fed the
               CPU's inputs (within 1 LSB on at most 0.1% of a node's
               elements), and the free-running output's cosine against
               the CPU's >= 0.999; SegFormer's class map printed.
               Then the OCR and segmentation nets (models/extra.py) at
               batch 1, seed-0 weights: CRNN at build_crnn_graph's defaults
               (32x100, widths 32-128, two LSTMs of hidden 128, 37
               classes) INT8 MinMax from one seeded image, and U-Net at
               Ronneberger et al.'s widths (64 -> 1024, depth 4, 2
               classes) UINT8 MinMax at 512x512, under
                 CRNN-S, UNET-S  Options(quant_mode="fast"): the convs on
                         the fast lowering, the LSTMs and Deconvolutions
                         through the generic wrapper
                 CRNN-T  CRNN-S + quant_bf16_storage=False, pallas_qgemm=
                         True: conv6 and conv7 (C_in 128) on qconv_direct,
                         the FC ([24, 128] x [128, 37]) on qgemm_requant
                 CRNN-E  CRNN-T on equalize_graph (DFQ) then
                         quantize_graph(algorithm="eq") over 4 seeded
                         images
                 UNET-T  UNET-S + quant_bf16_storage=False, quant_native=
                         "off": the 14 3x3 convs with C_in 128-1024 on
                         qconv_direct, the 1x1 head (N = 2) on qconv1x1;
               each checked right after it runs (run_extra_tiers) as the
               transformers are, U-Net node by node at 128x128 with the
               same widths, every kernel launch at 0 LSB; CRNN's CTC
               string printed beside the fp32 engine's. Then
                 S2D     yolov5s-640 b8 (phase 3a's graph) with
                         Options(stem_s2d=True): SpaceToDepth + a 3x3 s1
                         conv over 12 channels on the fast lowering, no
                         stem_qconv launch; its heads within 1 LSB of 3a's,
                         at batch 1 every tensor of both graphs within
                         1 LSB, its cosine against fp32 in phase 4.
               Then each of the 19 lowerings of ops/lowering_extra.py on a
               one-node graph, run captured on the card and held to the
               port's CPU run (extra_op_cases; RPN at per_nms_topn 300).
               Then the front ends (phase 3n, run_frontends):
               mobilenet-v1-224 written by this script's own encoders as
               ONNX, Caffe (prototxt + caffemodel), ncnn (param + bin),
               MXNet (symbol JSON + params), a frozen TF GraphDef and a
               TFLite flatbuffer (TF and TFLite with TF-SAME pads), each
               imported by `python -m tengine_tpu_torch.tools.convert_tool
               ... --optimize` in a subprocess (the six started together)
               and read back with load_model; fp32 at batch 8 against a
               plain torch forward of the same weights and pads (cosine
               >= 0.99999, max |d| <= 1e-3 of the logits' scale); then
                 ONNX-U  the ONNX import UINT8 MinMax under SSD-U's set at
                         batch 32: 13 dw_qconv, 13 qconv1x1; equal at 0
                         LSB to the in-code graph run alike
                 TFL-D   the full-int8 TFLite file (the fp32 TFLite
                         import's UINT8 grids shifted by -128, per-channel
                         int8 weights, int32 biases), no calibration,
                         default Options at batch 8
                 TFL-U   the same at batch 32 under SSD-U's set: 13
                         dw_qconv, the pointwise convs on the fast lowering
                         (shifted INT8);
               each checked by run_quant_tier.
               Then the C ABI (phase 3o, run_capi): phase 3a's graph
               written as a tmfile; tengine_tpu_torch/native/capi_example.c,
               built with gcc against the port's C ABI library, starts the
               interpreter and runs it on the card (no device request) at
               batch 1 (3 images) and batch 8 (3 batches), printing each
               run_graph call's host ms; the same file through ctypes in
               this process; every head of both equal at 0 LSB to a
               CompiledGraph of the file; a conv -> C custom kernel ->
               conv graph built through the construction calls, captured
               with the kernel's run() as a host node, on two inputs
               against the CPU.
               Then the mesh (phase 3p, run_mesh), in child processes of
               this script (no process group outlives the phase here), the
               graphs passed as tmfile bytes: (a) one rank on NCCL, mesh
               (1, 1): tier L's graph at b128 through shard_compiled,
               captured, its launches and logits equal to the unsharded
               CompiledGraph's and tier L's; phase 3k's requests behind
               InferenceServer(mesh=global_mesh(tp=1)), every answer equal
               to 3k's; (b) two ranks on the card on gloo (NCCL takes one
               rank a card): tier L's graph at b32 on mesh (1, 2), its
               pointwise convs and FC on channel slices, and (2, 1), 16 rows
               a rank, eager, both equal to the unsharded forward; phase
               3k's frames through the multi-host loop, two hosts of one
               rank, each answer equal to 3k's, an idle second that
               dispatches nothing.
               Then the CLIs (phase 3q, run_clis): tm_benchmark's
               `-m mobilenetv1 --uint8 -b 128` with TT_DW_PALLAS=1 on the
               seeded mobilenet-v1-224 tmfile (tier K's route: the tool's
               Options take no native-int8 plan on a depthwise net, so the
               dw gate stays shut; its ms within 10% of tier K's);
               tm_yolov5 -q int8 at 640 in this process (one stem_qconv a
               forward, its heads within 1 LSB of the CPU run of its graph
               and of the same command with --device cpu) and as a
               `python -m` command, which must print the same; the host tool
               chain: quant_tool -t uint8 --evaluate on mobilenet-v1-224's
               fp32 tmfile, tm_classification -m on the card = with
               --device cpu (top-5), align_tool (fast within 1 LSB of ref);
               every other example at its default size with the scheme of
               the reference's variant (CLI_EXAMPLES), the -m ones on
               tmfiles the phase writes; each example's launches derived
               from its CompiledGraph (check_cli_launches).
               Every launch of qgemm_requant (yolov3 B, ResNet-50 H,
               VIT-T), qconv1x1, qconv_direct, dw_qconv and stem_qconv
               (yolov5s in 3a, on the C path in 3o, in 3p(b)'s
               multi-host loop and in 3q's tm_yolov5; dw_qconv in both of
               3p(b)'s meshes) and qblock_chain (3m's FastPose, 3q's
               tm_pose) in one eager forward of a tier that launches one
               is held against its plain version (check_path_kernels,
               check_chain_kernels).
               Every kernel's launch count is set to 0 just before each
               tier's captured run and read just after it; the counts must be
               exact: a wrapper launches its kernel in the warm-up forward
               and in the capture, which records the launch into the graph
               (WRAPPER_RUNS = 2 forwards); the replays launch the recorded
               kernels without a wrapper call.
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
               cosine > 0.99; M against K's first image within 1 LSB. The
               mobilenet-SSD (checked right after each of its tiers, so
               that the tier's CUDA graph can go before the next): the loc
               and softmax-ed conf heads' dequantized cosine against the
               fp32 engine > 0.99, and each tier's card run against the
               port's CPU run with the same Options on the first image
               (rows as above, heads within 1 LSB). The
               debug tools on yolov3-64 tier A: profile_graph (every node in
               topological order, the top nodes printed) and
               dump_graph_tensors into a temporary directory, each file the
               CPU run's in header and line count, values within 1 LSB.

The last lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}. Nothing here imports JAX or
the JAX package; without a card, or without the package beside it, the
script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same sheet

# yolov5s-640 INT8 under Options(quant_mode="fast"), launches per forward:
# the stem (6x6 s2, C_in 3) on stem_qconv, its other 80 convs on qconv_fast
YOLOV5S_LAUNCHES = {"stem_qconv": 1, "qconv_fast": 80}

# yolov3-416 batch 8: the largest launch of each kernel on the main path, by
# bytes moved (from the IR: the stride-2 3x3 conv 104x104x128 -> 52x52x256,
# the 1x1 conv 208x208x64 -> 32, the 1x1 conv 52x52x384 -> 128 of the third
# head)
YOLOV3_DIRECT = dict(N=8, H=104, C=128, O=256, k=3, s=2, pad=1)
YOLOV3_1X1 = dict(M=8 * 208 * 208, K=64, N=32)
YOLOV3_QGEMM = dict(M=8 * 52 * 52, K=384, N=128)
# the integer-storage tiers of phase 3 and their launches per forward; the
# convs no other kernel takes run on qconv_fast (of 75: A's 6 k x k convs
# with C_in % 128 != 0, B's 41 convs beside the 34 1x1 ones on
# qgemm_requant, all of C's)
YOLOV3_TIERS = {
    "A": (dict(), {"qconv_direct": 32, "qconv1x1": 37, "qgemm_requant": 0, "stem_qconv": 0,
                   "qconv_fast": 6}),
    "B": (dict(pallas_qconv=False, pallas_qgemm=True),
          {"qconv_direct": 0, "qconv1x1": 0, "qgemm_requant": 34, "stem_qconv": 0,
           "qconv_fast": 41}),
    "C": (dict(pallas_qconv=False),
          {"qconv_direct": 0, "qconv1x1": 0, "qgemm_requant": 0, "stem_qconv": 0,
           "qconv_fast": 75}),
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
# the stem (3x3 s2, C_in 3) of the INT8 graph runs on qconv_fast in both
# tiers; the UINT8 graph's convs never do
FASTEST_FAST = {"int8": 1, "uint8": 0}
FASTEST_TIERS = {
    "D": ("1", {"dw_qconv": 13, "qconv1x1": 29, "qconv_direct": 0, "qgemm_requant": 0,
                "stem_qconv": 0}, 1),
    "E": ("0", {"dw_qconv": 0, "qconv1x1": 29, "qconv_direct": 0, "qgemm_requant": 0,
                "stem_qconv": 0}, 14),
}


RESNET_BATCH = 32
# the tiers of phase 3d and their launches per forward (qblock_chain: one per
# FusedResBlockChain node; H: the 13 3x3 convs with C_in % 128 == 0, the 36
# 1x1 convs and the FC; qconv_fast: F's and R's stem, G's 53 convs, H's stem
# and its three 3x3 convs with C_in 64)
RESNET_TIERS = {
    "F": (dict(fuse_resblock=True, quant_relaxed=False), {"qblock_chain": 4, "qconv_fast": 1}),
    "R": (dict(fuse_resblock=True, quant_relaxed=True, quant_native="off"),
          {"qblock_chain": 4, "qconv_fast": 1}),
    "G": (dict(quant_relaxed=False), {"qconv_fast": 53}),
    "H": (dict(quant_relaxed=False, quant_bf16_storage=False, pallas_qgemm=True),
          {"qconv_direct": 13, "qconv1x1": 36, "qgemm_requant": 1, "qconv_fast": 4}),
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
# mobilenet-v1 uint8 headline), and the headline at batch 1. Per tier: the
# net, the scheme, the calibration, the Options beyond
# Options(quant_mode="fast", batch_size=batch), TT_DW_PALLAS while
# compile_graph runs (None: unset), whether the native-int8 plan is taken,
# the launches per forward, and the batch
DEFAULT_BATCH = 128
DEFAULT_TIERS = {
    "I": ("resnet50", "int8", "kl", {}, None, True, {"qconv_fast": 53}, DEFAULT_BATCH),
    "J": ("resnet50", "uint8", "minmax", {}, None, True, {}, DEFAULT_BATCH),
    "K": ("mobilenet-v1", "uint8", "minmax", {}, None, False, {}, DEFAULT_BATCH),
    "L": ("mobilenet-v1", "uint8", "minmax", dict(quant_native="on"), "1", True,
          {"dw_qconv": 13}, DEFAULT_BATCH),
    # bench.py:221-238's batch-1 latency config (bench_model_quant_b1) on
    # the headline net: K's graph and Options at batch 1
    "M": ("mobilenet-v1", "uint8", "minmax", {}, None, False, {}, 1),
}
# phase 3f: mobilenet-SSD-300 UINT8 (bench.py:388, bench_model_quant("mssd",
# batch=8, scheme="uint8")), MinMax from one seeded image. Per tier: the
# Options beyond Options(quant_mode="fast", batch_size=batch), TT_DW_PALLAS
# while compile_graph runs (None: unset), the launches per forward, and the
# batch. T: the 13 pointwise convs, the extras' four 1x1 and the 12 heads on
# qconv1x1, the extras' 3x3 s2 convs with C_in % 128 == 0 (256, 128, 128)
# on qconv_direct; U: T at batch 32, the 13 depthwise convs on dw_qconv
SSD_BATCH, SSD_U_BATCH = 8, 32
SSD_T_LAUNCHES = {"qconv1x1": 29, "qconv_direct": 3}
SSD_TIERS = {
    "SSD-S": ({}, None, {}, SSD_BATCH),
    "SSD-T": (dict(quant_bf16_storage=False), None, SSD_T_LAUNCHES, SSD_BATCH),
    "SSD-U": (dict(quant_bf16_storage=False), "1", dict(SSD_T_LAUNCHES, dw_qconv=13),
              SSD_U_BATCH),
}
# phase 3g: the face pipeline (bench.py:265-298, bench_face_pipeline):
# RetinaFace mnet0.25 UINT8 at batch 1 (the detector on one 320x240 frame),
# then MobileFaceNet-112 UINT8 at batch 8 (the worst case of 8 faces a
# frame), MinMax from one seeded image each. Per tier: the Options beyond
# Options(quant_mode="fast", batch_size=batch), TT_DW_PALLAS while
# compile_graph runs (None: unset), and per net its launches per forward and
# its batch. T: every group-1 1x1 conv on qconv1x1 (RetinaFace's 13
# pointwise, 3 laterals and 9 heads; MobileFaceNet's 15 expansions, 15
# projections and conv5); no k x k conv of either net has C_in % 128 == 0,
# so none reaches qconv_direct (both derived from the IR and asserted). U:
# MobileFaceNet at batch 32 (the dw gate's least batch) with its 16 3x3
# depthwise convs (64, 128, 256 and 512 channels) on dw_qconv too; the 7x7
# GDConv stays on the fast lowering
FACE_T_LAUNCHES = {"retinaface": {"qconv1x1": 25}, "mobilefacenet": {"qconv1x1": 31}}
FACE_TIERS = {
    "FACE-S": ({}, None, {"retinaface": ({}, 1), "mobilefacenet": ({}, 8)}),
    "FACE-T": (dict(quant_bf16_storage=False), None,
               {"retinaface": (FACE_T_LAUNCHES["retinaface"], 1),
                "mobilefacenet": (FACE_T_LAUNCHES["mobilefacenet"], 8)}),
    "FACE-U": (dict(quant_bf16_storage=False), "1",
               {"mobilefacenet": (dict(FACE_T_LAUNCHES["mobilefacenet"], dw_qconv=16), 32)}),
}
# phase 3h: shufflenet-v2 1.0x UINT8 at batch 32 on the integer-storage
# tier: fold_shuffle_gathers folds its 16 shuffles (13 with a Slice: one
# half into a ChannelGather, the other into its 1x1 conv's scattered
# weights; 3 into permuted weights), and its 36 1x1 convs, the folded ones
# among them, run on qconv1x1; its depthwise convs stay on the fast
# lowering (TT_DW_PALLAS unset)
SHUF_TIERS = {"SHUF-T": (dict(quant_bf16_storage=False), None, {"qconv1x1": 36}, 32)}
SHUF_FOLDS = 16
# phase 3i: the transformers (models/transformer_zoo.py) at batch 1, which
# the builders bake into their token reshapes; INT8 MinMax from one seeded
# image. ViT at DeiT-Ti's published widths and depth (Touvron et al. 2021,
# Table 1: patch 16, dim 192, 12 blocks, 3 heads; 224, 1000 classes; the
# builder's own default depth is 6); SegFormer at the paper's ADE20K setting
# (Xie et al. 2021: 512x512, 150 classes) with the builder's B0-shaped
# widths (dims 32/64/128/192, heads 1/2/4/8, sr 8/4/2/1, depths 2/2/2/2,
# decoder 64; B0 itself is 32/64/160/256 with a decoder of 256, and the
# builder takes neither argument). Per tier: the net, the Options beyond
# Options(quant_mode="fast"), the launches per forward (derived from the IR
# and asserted), and the cosine gate of the dequantized output against the
# fp32 engine (ViT: tests/test_transformer_zoo.py's). T: ViT's head FC on
# qgemm_requant; SegFormer's decoder (the four split fuse convs and
# classify) on qconv1x1, embeds/3 (3x3 s2) and stage 3's two 2x2 s2 spatial
# reductions (C_in 128) on qconv_direct. qconv_fast takes SegFormer's group-1
# convs that no other kernel does (stride 1 or 2, at most 49 taps): S's 10,
# T's 2; ViT's one conv, its 16x16 s16 patch embed, it refuses
VIT_CONFIG = dict(num_classes=1000, img=224, patch=16, dim=192, depth=12, nheads=3)
SEG_CONFIG = dict(num_classes=150, img=512)
TRANSFORMER_TIERS = {
    "VIT-S": ("vit", {}, {}, 0.95),
    "VIT-T": ("vit", dict(quant_bf16_storage=False, pallas_qgemm=True), {"qgemm_requant": 1},
              0.95),
    "SEG-S": ("segformer", {}, {"qconv_fast": 10}, 0.99),
    "SEG-T": ("segformer", dict(quant_bf16_storage=False),
              {"qconv_direct": 3, "qconv1x1": 5, "qconv_fast": 2}, 0.99),
}
# phase 3j: the OCR and segmentation nets (models/extra.py, Tengine's
# examples/tm_crnn.cpp and tm_unet.cpp) at batch 1. CRNN at build_crnn_graph's
# defaults (32x100 grey input, widths 32-128, two LSTMs of hidden 128,
# 37 classes, T = 24) INT8 MinMax from one seeded image; E: equalize_graph
# (DFQ) then quantize_graph(algorithm="eq") on EQ_IMAGES seeded images.
# U-Net at Ronneberger et al.'s widths (64 -> 1024, depth 4, 2 classes) UINT8
# and INT8 MinMax at 512x512 (ISBI-2012's image size); the INT8 graph's
# deconvs take per-channel scales by output channel (the JAX quantizer
# refuses it, ROADMAP §3) and run on the generic dequantize -> fp32
# conv_transpose2d -> requantize wrapper. Per tier: the net, the Options beyond
# Options(quant_mode="fast"), the launches per forward (derived from the IR
# and asserted), the cosine gate against the fp32 engine. T: CRNN's conv6
# (3x3 at 4x25) and conv7 (2x2 at 2x25), C_in 128, on qconv_direct, the FC
# ([24, 128] x [128, 37]) on qgemm_requant; U-Net's 14 3x3 convs with C_in
# 128-1024 on qconv_direct, the 1x1 head (N = 2) on qconv1x1, in UINT8
# (UNET-T) and in INT8 (UNET-I8-T). In the INT8 nets qconv_fast takes the
# other convs: CRNN's 7 (S) or 5 (T, E), U-Net's 19 (S) or 4 (T).
CRNN_CONFIG = dict(img_w=100, img_h=32, hidden=128)
UNET_CONFIG = dict(img=512, base=64, depth=4, num_classes=2)
UNET_CHECK_IMG = 128  # the card held to the CPU node by node at this size
EQ_IMAGES = 4
CRNN_T = dict(quant_bf16_storage=False, pallas_qgemm=True)
EXTRA_TIERS = {
    "CRNN-S": ("crnn", {}, {"qconv_fast": 7}, 0.99),
    "CRNN-T": ("crnn", CRNN_T, {"qconv_direct": 2, "qgemm_requant": 1, "qconv_fast": 5}, 0.99),
    "CRNN-E": ("crnn-eq", CRNN_T, {"qconv_direct": 2, "qgemm_requant": 1, "qconv_fast": 5},
               0.99),
    "UNET-S": ("unet", {}, {}, 0.99),
    "UNET-T": ("unet", dict(quant_bf16_storage=False, quant_native="off"),
               {"qconv_direct": 14, "qconv1x1": 1}, 0.99),
    "UNET-I8-S": ("unet-i8", {}, {"qconv_fast": 19}, 0.99),
    "UNET-I8-T": ("unet-i8", dict(quant_bf16_storage=False, quant_native="off"),
                  {"qconv_direct": 14, "qconv1x1": 1, "qconv_fast": 4}, 0.99),
}
# yolov5s-640 INT8 b8 (phase 3a's graph) with Options(stem_s2d=True): the 6x6
# s2 stem becomes SpaceToDepth + a 3x3 s1 conv over 12 channels, which the
# stem kernel's gate refuses (C_in <= 4): the fast lowering takes it, on
# qconv_fast as the other 80
S2D_OPTS = dict(quant_mode="fast", stem_s2d=True)
# RPN in phase 3j's one-node graphs: per_nms_topn 300 (the reference's 6000
# makes padded_nms a 6000-step loop: correct, and too slow for this phase)
RPN_SMOKE_TOPN = 300

# the forwards of a tier's main-path run that call the kernels' wrappers: the
# captured forward's warm-up and its capture (drive)
WRAPPER_RUNS = 2

# phase 3k: phase 3a's yolov5s-640 INT8 graph behind InferenceServer
# (parallel/serving.py) under Options(quant_mode="fast"), max_batch 8, a 5 ms
# window: one CompiledGraph and CUDA graph per bucket. Seeded uint8 frames of
# three camera sizes, letterboxed to 640 by native.letterbox, scaled by 1/255
# and INT8-quantized on the input's grid; requests in bursts of 8, 3 and 1
# (buckets 8, 4 and 1), SERVER_ROUNDS times; each answer decoded on the host
# (tm_yolov5.py's threshold and NMS IoU), the SERVER_TOPK highest scores
# kept before NMS
SERVER_BUCKETS = (1, 2, 4, 8)
SERVER_FRAME_SIZES = ((480, 640), (720, 1280), (640, 640))
SERVER_BURSTS = (8, 3, 1)
SERVER_ROUNDS = 2
SERVER_WAIT_MS = 5.0
SERVER_TOPK = 1000
SERVER_CONF, SERVER_IOU = 0.25, 0.45
# phase 3l: phase 3g's RetinaFace (b1) and MobileFaceNet (b8) under FACE-T
# as a four-stage Pipeline (utils/pipeline.py), each stage on its own thread:
# pre (native.preprocess_batch onto the detector's grid, mean 127.5, scale
# 1/128), detect, crop (faces from the score maps as tm_face_pipeline.py's
# decode_retinaface finds them: a box of 4 strides at each position whose
# face probability exceeds FACE_SCORE, at most MAX_FACES, else its centred
# box; native.letterbox to 112, preprocess_batch onto the embedder's grid,
# padded to MAX_FACES) and embed, over FACE_FRAMES seeded 480x640 frames
FACE_FRAMES = 16
FACE_FRAME_HW = (480, 640)
FACE_SCORE = 0.5
MAX_FACES = 8
FACE_MEAN, FACE_SCALE = 127.5, 1 / 128
# phase 3m: every detector of models/detect_zoo*.py and darknet_zoo's
# yolov4-tiny at its builder's default size, batch 1 (the builders'
# torch modules seeded by torch.manual_seed(0)); MinMax from one seeded image,
# INT8 (nanodet UINT8, as tests/test_detect_zoo.py quantizes it), default
# Options. Per net: the models module, the builder, the scheme, the dequantized
# cosine gate against the fp32 engine (tests/test_detect_zoo.py's: 0.95,
# UltraFace 0.85), and the NMS IoU of its example (None: it calls none)
ZOO_NETS = {
    "fastpose": ("detect_zoo", "build_fastpose_graph", "int8", 0.95, None),
    "nanodet": ("detect_zoo", "build_nanodet_graph", "uint8", 0.95, 0.6),
    "ultraface": ("detect_zoo", "build_ultraface_graph", "int8", 0.85, 0.5),
    "hrnet": ("detect_zoo", "build_hrnet_graph", "int8", 0.95, None),
    "yolact": ("detect_zoo", "build_yolact_graph", "int8", 0.95, None),
    "openpose": ("detect_zoo", "build_openpose_graph", "int8", 0.95, None),
    "efficientdet": ("detect_zoo", "build_efficientdet_graph", "int8", 0.95, None),
    "landmark": ("detect_zoo", "build_landmark_graph", "int8", 0.95, None),
    "yolox": ("detect_zoo2", "build_yolox_graph", "int8", 0.95, 0.45),
    "scrfd": ("detect_zoo2", "build_scrfd_graph", "int8", 0.95, 0.45),
    "movenet": ("detect_zoo2", "build_movenet_graph", "int8", 0.95, None),
    "nanodet-plus": ("detect_zoo3", "build_nanodet_plus_graph", "int8", 0.95, 0.6),
    "picodet": ("detect_zoo3", "build_picodet_graph", "int8", 0.95, 0.5),
    "yolov4-tiny": ("darknet_zoo", "build_yolov4_tiny_graph", "int8", 0.95, 0.45),
}
INT32_MAX = 2**31 - 1
# phase 3n: mobilenet-v1-224 (build_mobilenet_v1_graph, seed-0 weights)
# written in the six formats of the port's front ends and imported through
# its convert tool. TF and TFLite pad TF-SAME, as TensorFlow's published
# mobilenet_v1 does; the other four carry the graph's explicit pads. fp32 at
# FRONTEND_BATCH; then per quantized tier: the Options, TT_DW_PALLAS while
# compile_graph runs (None: unset), the launches per forward, and the batch.
# ONNX-U: the ONNX import UINT8 MinMax under SSD-U's set (13 dw_qconv, 13
# qconv1x1); TFL-D, TFL-U: the full-int8 TFLite import under default
# Options and under SSD-U's set, whose shifted INT8 keeps the pointwise
# convs off qconv1x1
FRONTEND_FORMATS = ("onnx", "caffe", "ncnn", "mxnet", "tf", "tflite")
SAME_PAD_FORMATS = ("tf", "tflite")
FRONTEND_BATCH, FRONTEND_U_BATCH = 8, 32
FRONTEND_TIERS = {
    "ONNX-U": (dict(quant_mode="fast", quant_bf16_storage=False), "1",
               {"dw_qconv": 13, "qconv1x1": 13}, FRONTEND_U_BATCH),
    "TFL-D": (dict(quant_mode="fast"), None, {}, FRONTEND_BATCH),
    "TFL-U": (dict(quant_mode="fast", quant_bf16_storage=False), "1", {"dw_qconv": 13},
              FRONTEND_U_BATCH),
}

# phase 3o: phase 3a's yolov5s-640 INT8 graph written by the port's TM2
# writer and driven through the port's C ABI (native/c_api_shim.c) under
# default Options, as an embedder drives it: a C program
# (tengine_tpu_torch/native/capi_example.c, gcc at run time) that starts the
# interpreter runs CAPI_B1_RUNS images at batch 1, then CAPI_BATCHED_RUNS
# batches of CAPI_BATCH; the same file in this process through ctypes
# (attach mode). Then a conv -> C custom kernel (y = 2x) -> conv graph of
# CK_SHAPE fp32, built through the construction calls and captured on the
# card with the kernel's run() as a host node, run on two inputs
CAPI_B1_RUNS, CAPI_BATCH, CAPI_BATCHED_RUNS = 3, 8, 3
CK_SHAPE = (1, 32, 112, 112)


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


# MobileNet-SSD (chuanqi305/MobileNet-SSD deploy.prototxt, VOC0712, as
# Tengine's benchmark tmfile has it): the extras as (1x1 width, 3x3 s2
# width), and per feature map (19, 10, 5, 3, 2, 1 at 300) the PriorBox's
# min_size, max_size (None: none) and aspect ratios
SSD_EXTRAS = ((256, 512), (128, 256), (128, 256), (64, 128))
SSD_PRIORS = ((60, None, (2,)), (105, 150, (2, 3)), (150, 195, (2, 3)), (195, 240, (2, 3)),
              (240, 285, (2, 3)), (285, 300, (2, 3)))
SSD_CLASSES = 21
SSD_NUM_PRIORS = 1917  # at 300: 19²·3 + (10² + 5² + 3² + 2² + 1²)·6
# the conf head's gain over He-normal: the softmax of logits this wide puts
# a class of most priors above DetectionOutput's 0.25 threshold, so every
# image yields valid detections with seeded weights
SSD_CONF_GAIN = 4.0


def build_mobilenet_ssd_graph(ir, img=300, classes=SSD_CLASSES, seed=0, widths=MOBILENET_WIDTHS,
                              extras=SSD_EXTRAS, conf_gain=SSD_CONF_GAIN):
    """MobileNet-SSD as Tengine's benchmark tmfile has it (chuanqi305's
    deploy.prototxt, batch norm merged into the convs) as a float IR graph
    with seeded weights, built with the IR module `ir` it is given:
    build_mobilenet_v1_graph's backbone without its head, the outputs of
    the 11th and 13th pointwise convs (19x19x512 and 10x10x1024 at 300) as
    the first two feature maps, then for each of `extras` a 1x1 conv (relu)
    and a 3x3 s2 p1 conv (relu), one more feature map each (5, 3, 2, 1 at
    300). On each map a 1x1 loc conv and a 1x1 conf conv, each through
    Permute(0, 2, 3, 1) and Flatten(axis 1), concatenated on axis 1 over
    the maps; the conf branch then Reshape(0, -1, classes), Softmax(axis
    2), Flatten. A PriorBox per map (offset 0.5, variances 0.1/0.1/0.2/0.2,
    clip 0, flip 1; SSD_PRIORS), concatenated on axis 2. DetectionOutput:
    nms_threshold 0.45, nms_top_k 100, keep_top_k 100, confidence_threshold
    0.25. Outputs: the detections [N, 100, 6], the concatenated loc head
    and the softmax-ed conf head (flattened)."""
    DType, TensorType = ir.DType, ir.TensorType
    g = build_mobilenet_v1_graph(ir, img=img, seed=seed, widths=widths, head=False)
    g.name = f"mobilenet-ssd-{img}"
    rng = np.random.default_rng(seed + 1)
    data = g.tensors[g.input_tensors[0]]
    by_name = {t.name: t for t in g.tensors}
    maps = [by_name["conv12_pw.out"], by_name[f"conv{len(widths)}_pw.out"]]

    def var(name, shape):
        return g.add_tensor(name, DType.FP32, list(shape), TensorType.VAR)

    def node(op, name, inputs, shape, params):
        y = var(f"{name}.out", shape)
        return y, g.add_node(op, name, [t.idx for t in inputs], [y.idx], params)

    def conv(name, x, c_out, k, stride=1, pad=0, act=0, gain=1.0):
        n, c_in, h, w = x.shape
        wt = g.add_tensor(f"{name}.w", DType.FP32, [c_out, c_in, k, k], TensorType.CONST,
                          data=(rng.standard_normal((c_out, c_in, k, k))
                                * (gain * np.sqrt(2.0 / (c_in * k * k)))).astype(np.float32))
        bt = g.add_tensor(f"{name}.b", DType.FP32, [c_out], TensorType.CONST,
                          data=(rng.standard_normal(c_out) * 0.05).astype(np.float32))
        oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        y, _ = node("Convolution", name, [x, wt, bt], [n, c_out, oh, ow], dict(
            kernel_h=k, kernel_w=k, stride_h=stride, stride_w=stride, dilation_h=1,
            dilation_w=1, input_channel=c_in, output_channel=c_out, group=1, activation=act,
            pad_h0=pad, pad_w0=pad, pad_h1=pad, pad_w1=pad))
        return y

    t = maps[-1]
    for j, (c1, c2) in enumerate(extras):
        t = conv(f"conv{len(widths) + j + 1}_1", t, c1, 1)
        t = conv(f"conv{len(widths) + j + 1}_2", t, c2, 3, stride=2, pad=1)
        maps.append(t)
    if len(maps) != len(SSD_PRIORS):
        raise ValueError(f"{len(maps)} feature maps, SSD_PRIORS has {len(SSD_PRIORS)}")

    n = data.shape[0]
    locs, confs, priors = [], [], []
    for fm, (min_size, max_size, ratios) in zip(maps, SSD_PRIORS):
        _, _, h, w = fm.shape
        per = (2 if max_size else 1) + 2 * len(ratios)  # flip: each ratio and 1/ratio
        src = fm.name[:-len(".out")]
        for head, width, gain, out in (("loc", 4, 0.5, locs), ("conf", classes, conf_gain, confs)):
            y = conv(f"{src}_mbox_{head}", fm, per * width, 1, act=-1, gain=gain)
            y, _ = node("Permute", f"{src}_mbox_{head}_perm", [y], [n, h, w, per * width],
                        dict(flag=0, order0=0, order1=2, order2=3, order3=1))
            y, _ = node("Flatten", f"{src}_mbox_{head}_flat", [y], [n, h * w * per * width],
                        dict(axis=1, end_axis=3))
            out.append(y)
        y, _ = node("PriorBox", f"{src}_mbox_priorbox", [fm, data], [n, 2, h * w * per * 4, 1],
                    dict(min_sizes=[float(min_size)],
                         max_sizes=[float(max_size)] if max_size else [],
                         variances=[0.1, 0.1, 0.2, 0.2],
                         aspect_ratios=[float(r) for r in ratios], flip=1, clip=0, img_size=0,
                         img_h=0, img_w=0, step_w=0.0, step_h=0.0, offset=0.5,
                         num_priors=per, out_dim=h * w * per * 4))
        priors.append(y)
    num_priors = sum(p.shape[2] for p in priors) // 4
    loc, loc_node = node("Concat", "mbox_loc", locs, [n, num_priors * 4], dict(axis=1))
    conf, _ = node("Concat", "mbox_conf", confs, [n, num_priors * classes], dict(axis=1))
    prior, _ = node("Concat", "mbox_priorbox", priors, [n, 2, num_priors * 4, 1], dict(axis=2))
    conf, _ = node("Reshape", "mbox_conf_reshape", [conf], [n, num_priors, classes],
                   dict(is_mxnet=0, reverse=0, shape=[0, -1, classes], is_onnx=0))
    conf, _ = node("Softmax", "mbox_conf_softmax", [conf], [n, num_priors, classes], dict(axis=2))
    conf, conf_node = node("Flatten", "mbox_conf_flatten", [conf], [n, num_priors * classes],
                           dict(axis=1, end_axis=-1))
    _, det_node = node("DetectionOutput", "detection_out", [loc, conf, prior], [n, 100, 6],
                       dict(num_classes=classes, keep_top_k=100, nms_top_k=100,
                            confidence_threshold=0.25, nms_threshold=0.45))
    g.outputs = [det_node.idx, loc_node.idx, conf_node.idx]
    return g


class _NetMaker:
    """The IR-building steps the face nets and shufflenet-v2 share: seeded
    He-normal convs with a small bias (batch norm folded away), PReLU,
    and plain nodes, on a Graph of the IR module `ir`."""

    def __init__(self, ir, name, seed):
        self.ir, self.rng = ir, np.random.default_rng(seed)
        self.g = ir.Graph(name=name)

    def const(self, name, data):
        return self.g.add_tensor(name, self.ir.DType.FP32, list(data.shape),
                                 self.ir.TensorType.CONST, data=data.astype(np.float32))

    def node(self, op, name, inputs, shape, params):
        y = self.g.add_tensor(f"{name}.out", self.ir.DType.FP32, list(shape), self.ir.TensorType.VAR)
        self.g.add_node(op, name, [t.idx for t in inputs], [y.idx], params)
        return y

    def conv(self, name, x, c_out, k, stride=1, pad=0, group=1, act=-1, gain=1.0):
        n, c_in, h, w = x.shape
        fan_in = c_in // group * k * k
        wt = self.const(f"{name}.w", self.rng.standard_normal((c_out, c_in // group, k, k))
                        * (gain * np.sqrt(2.0 / fan_in)))
        bt = self.const(f"{name}.b", self.rng.standard_normal(c_out) * 0.05)
        oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        return self.node("Convolution", name, [x, wt, bt], [n, c_out, oh, ow], dict(
            kernel_h=k, kernel_w=k, stride_h=stride, stride_w=stride, dilation_h=1,
            dilation_w=1, input_channel=c_in, output_channel=c_out, group=group,
            activation=act, pad_h0=pad, pad_w0=pad, pad_h1=pad, pad_w1=pad))

    def prelu(self, name, x):
        slope = self.const(f"{name}.slope", self.rng.uniform(0.1, 0.4, x.shape[1]))
        return self.node("PReLU", name, [x, slope], x.shape, {})

    def input(self, shape):
        x = self.g.add_tensor("data", self.ir.DType.FP32, list(shape), self.ir.TensorType.INPUT)
        self.g.inputs = [self.g.add_node("InputOp", "input", [], [x.idx]).idx]
        return x

    def finish(self, outputs):
        self.g.outputs = [self.g.tensors[t.idx].producer for t in outputs]
        return self.g


# RetinaFace mnet0.25 (insightface's mnet.25, the model Tengine's
# tm_retinaface example loads): MobileNet-0.25's widths (build_mobilenet_v1
# _graph's strides), the pyramid's and the SSH modules' width, and the
# anchors a position
RETINAFACE_WIDTHS = tuple(c // 4 for c in MOBILENET_WIDTHS)
RETINAFACE_FPN = 64
RETINAFACE_ANCHORS = 2


def build_retinaface_mnet_graph(ir, h=320, w=240, seed=0, widths=RETINAFACE_WIDTHS,
                                fpn=RETINAFACE_FPN):
    """RetinaFace (Deng et al., "RetinaFace: Single-stage Dense Face
    Localisation in the Wild", 2019) as insightface's mnet.25, the model
    Tengine's tm_retinaface example loads, as a float IR graph with seeded
    weights (batch norm folded into the convs), built with the IR module
    `ir` it is given; input (1, 3, h, w), zoo.py's (1, 3, 320, 240).

    Backbone: MobileNet-0.25 (conv 3x3 s2 p1 to widths[0] -> 13 depthwise
    3x3 p1 at build_mobilenet_v1_graph's strides and pointwise 1x1 convs to
    widths 16, 32, 32, 64, 64, 128 x6, 256, 256), every conv with ReLU.
    The stride-8, -16 and -32 maps are the 5th, 11th and 13th pointwise
    outputs. Pyramid (insightface's rf_c*_lateral / rf_c*_aggr): a 1x1
    lateral conv (ReLU) to `fpn` on each; top-down, the coarser map through
    Upsample x2 (nearest), Crop to the lateral's size (at 320x240 the
    stride-32 map is 10x8, its upsample 20x16 crops to the stride-16 map's
    20x15), an Eltwise sum with the lateral, and a 3x3 p1 conv (ReLU).
    SSH module on each level (insightface's ssh_detection_module): a 3x3
    conv to fpn/2, and the context branch's 3x3 to fpn/4 (ReLU) feeding a
    3x3 to fpn/4 and a 3x3 (ReLU) -> 3x3 to fpn/4, the three concatenated
    (fpn channels), then a ReLu node. Heads a level, RETINAFACE_ANCHORS = 2
    anchors a position: cls 1x1 to 4 -> Reshape (0, 2, -1, 0) -> Softmax
    (axis 1) -> Reshape (0, 4, -1, 0); bbox 1x1 to 8; landmark 1x1 to 20.
    Outputs, stride 32, 16, 8 in turn: cls prob, bbox, landmark (9).
    Assumed where the published graph's details are not in the repo: the
    weights' scales (He-normal, bias 0.05) and the names of the nodes."""
    m = _NetMaker(ir, f"retinaface-mnet025-{h}x{w}", seed)
    x = m.input([1, 3, h, w])
    t = m.conv("conv1", x, widths[0], 3, stride=2, pad=1, act=0)
    maps = {}
    for i, stride in enumerate(MOBILENET_STRIDES):
        t = m.conv(f"conv{i + 2}_dw", t, widths[i], 3, stride=stride, pad=1, group=widths[i],
                   act=0)
        t = m.conv(f"conv{i + 2}_pw", t, widths[i + 1], 1, act=0)
        if i + 1 in (5, 11, 13):
            maps[{5: 8, 11: 16, 13: 32}[i + 1]] = t
    levels = {32: m.conv("rf_c3_lateral", maps[32], fpn, 1, act=0)}
    for s, coarse in ((16, 32), (8, 16)):
        lateral = m.conv(f"rf_c{s // 8}_lateral", maps[s], fpn, 1, act=0)
        n, c, lh, lw = lateral.shape
        up = levels[coarse]
        up = m.node("Upsample", f"rf_c{coarse // 8}_upsampling", [up],
                    [n, c, 2 * up.shape[2], 2 * up.shape[3]], dict(scale=2.0))
        up = m.node("Crop", f"rf_c{coarse // 8}_crop", [up, lateral], [n, c, lh, lw], dict(
            num_args=2, offset_c=0, offset_h=0, offset_w=0, crop_h=0, crop_w=0,
            center_crop=False, axis=2, flag=0))
        t = m.node("Eltwise", f"rf_c{s // 8}_sum", [lateral, up], lateral.shape, dict(type=2))
        levels[s] = m.conv(f"rf_c{s // 8}_aggr", t, fpn, 3, pad=1, act=0)
    outputs = []
    for s in (32, 16, 8):
        name = f"rf_c{s // 8}_det"
        t = levels[s]
        a = m.conv(f"{name}_conv1", t, fpn // 2, 3, pad=1)
        ctx = m.conv(f"{name}_context_conv1", t, fpn // 4, 3, pad=1, act=0)
        b = m.conv(f"{name}_context_conv2", ctx, fpn // 4, 3, pad=1)
        c = m.conv(f"{name}_context_conv3_1", ctx, fpn // 4, 3, pad=1, act=0)
        c = m.conv(f"{name}_context_conv3_2", c, fpn // 4, 3, pad=1)
        n, _, lh, lw = t.shape
        t = m.node("Concat", f"{name}_concat", [a, b, c], [n, fpn, lh, lw], dict(axis=1))
        t = m.node("ReLu", f"{name}_relu", [t], t.shape, dict(negative_slope=0.0))
        k = RETINAFACE_ANCHORS
        cls = m.conv(f"face_rpn_cls_score_stride{s}", t, 2 * k, 1)
        cls = m.node("Reshape", f"face_rpn_cls_score_reshape_stride{s}", [cls],
                     [n, 2, k * lh, lw], dict(is_mxnet=0, reverse=0, shape=[0, 2, -1, 0],
                                              is_onnx=0))
        cls = m.node("Softmax", f"face_rpn_cls_prob_stride{s}", [cls], cls.shape, dict(axis=1))
        cls = m.node("Reshape", f"face_rpn_cls_prob_reshape_stride{s}", [cls],
                     [n, 2 * k, lh, lw], dict(is_mxnet=0, reverse=0, shape=[0, 2 * k, -1, 0],
                                              is_onnx=0))
        outputs += [cls, m.conv(f"face_rpn_bbox_pred_stride{s}", t, 4 * k, 1),
                    m.conv(f"face_rpn_landmark_pred_stride{s}", t, 10 * k, 1)]
    return m.finish(outputs)


# MobileFaceNet (Chen et al. 2018, Table 1): the stem's width, the
# bottlenecks (expansion t, width c, repeats n, first stride s), the last
# conv's width and the embedding's
MOBILEFACENET_BOTTLENECKS = ((2, 64, 5, 2), (4, 128, 1, 2), (2, 128, 6, 1), (4, 128, 1, 2),
                             (2, 128, 2, 1))
MOBILEFACENET_STEM, MOBILEFACENET_CONV5, MOBILEFACENET_EMBEDDING = 64, 512, 128


def build_mobilefacenet_graph(ir, img=112, seed=0, stem=MOBILEFACENET_STEM,
                              bottlenecks=MOBILEFACENET_BOTTLENECKS, conv5=MOBILEFACENET_CONV5,
                              embedding=MOBILEFACENET_EMBEDDING):
    """MobileFaceNet (Chen et al., "MobileFaceNets: Efficient CNNs for
    Accurate Real-Time Face Verification on Mobile Devices", 2018, Table 1)
    as a float IR graph with seeded weights (batch norm folded into the
    convs), built with the IR module `ir` it is given; input (1, 3, img,
    img), 112 as zoo.py's. conv 3x3 s2 p1 to `stem` (PReLU) -> depthwise
    3x3 p1 (PReLU) -> bottlenecks (t, c, n, s): 1x1 expansion to t x c_in
    (PReLU) -> depthwise 3x3 p1 at stride s for the first of the n, 1 after
    (PReLU) -> linear 1x1 projection to c, an Eltwise sum with the block's
    input where the stride is 1 and the width stays -> 1x1 conv to `conv5`
    (PReLU) -> linear GDConv (depthwise, its kernel the map's size, img/16:
    7x7 at 112) -> insightface's fc1 form of the embedding: Flatten ->
    FullyConnected to `embedding` -> BatchNormalization (gamma 1:
    insightface's fix_gamma; eps 2e-5) -> L2Normalization. Output: the
    unit embedding [N, embedding]. PReLU follows every non-linear conv, a
    node of its own (slopes seeded in [0.1, 0.4]). Assumed: the weights'
    scales (He-normal, bias 0.05; the projections at gain 0.5 so that the
    residual stream keeps its variance), the BN's statistics (seeded), the
    names of the nodes."""
    m = _NetMaker(ir, f"mobilefacenet-{img}", seed)
    x = m.input([1, 3, img, img])
    t = m.prelu("conv1_prelu", m.conv("conv1", x, stem, 3, stride=2, pad=1))
    t = m.prelu("conv2_dw_prelu", m.conv("conv2_dw", t, stem, 3, pad=1, group=stem))
    for b, (expand, c, repeats, first) in enumerate(bottlenecks):
        for i in range(repeats):
            name = f"res{b + 3}_{i + 1}"
            stride = first if i == 0 else 1
            c_in = t.shape[1]
            y = m.prelu(f"{name}_expand_prelu", m.conv(f"{name}_expand", t, expand * c_in, 1))
            y = m.prelu(f"{name}_dw_prelu", m.conv(f"{name}_dw", y, expand * c_in, 3,
                                                   stride=stride, pad=1, group=expand * c_in))
            y = m.conv(f"{name}_project", y, c, 1, gain=0.5)
            if stride == 1 and c_in == c:
                y = m.node("Eltwise", f"{name}_add", [y, t], y.shape, dict(type=2))
            t = y
    t = m.prelu("conv5_prelu", m.conv("conv5", t, conv5, 1))
    n, c, h, w = t.shape
    t = m.conv("conv6_dw", t, c, h, group=c)  # GDConv
    t = m.node("Flatten", "conv6_flatten", [t], [n, c], dict(axis=1, end_axis=3))
    wt = m.const("fc1.w", m.rng.standard_normal((embedding, c)) * np.sqrt(1.0 / c))
    bt = m.const("fc1.b", m.rng.standard_normal(embedding) * 0.05)
    t = m.node("FullyConnected", "fc1_dense", [t, wt, bt], [n, embedding],
               dict(num_output=embedding))
    bn = [m.const("fc1.gamma", np.ones(embedding)),
          m.const("fc1.beta", m.rng.standard_normal(embedding) * 0.1),
          m.const("fc1.mean", m.rng.standard_normal(embedding) * 0.1),
          m.const("fc1.var", m.rng.uniform(0.5, 2.0, embedding))]
    t = m.node("BatchNormalization", "fc1", [t] + bn, t.shape,
               dict(rescale_factor=1.0, eps=2e-5, caffe_flavor=0))
    return m.finish([m.node("L2Normalization", "embedding", [t], t.shape, {})])


# ShuffleNet V2 1.0x (Ma et al. 2018, Table 5): the stem's width, each
# stage's width and units, the last conv's width
SHUFFLENET_STEM, SHUFFLENET_WIDTHS, SHUFFLENET_UNITS = 24, (116, 232, 464), (4, 8, 4)
SHUFFLENET_CONV5 = 1024


def build_shufflenet_v2_graph(ir, img=224, classes=1000, seed=0, stem=SHUFFLENET_STEM,
                              widths=SHUFFLENET_WIDTHS, units=SHUFFLENET_UNITS,
                              conv5=SHUFFLENET_CONV5):
    """ShuffleNet V2 1.0x (Ma et al., "ShuffleNet V2: Practical Guidelines
    for Efficient CNN Architecture Design", 2018, Table 5) in its Caffe
    form, as a float IR graph with seeded weights (batch norm folded into
    the convs), built with the IR module `ir` it is given; input (1, 3,
    img, img). conv 3x3 s2 p1 to `stem` (ReLU) -> max-pool 3x3 s2 p1 ->
    stages of `widths` channels and `units` units -> 1x1 conv to `conv5`
    (ReLU) -> global average pool -> FullyConnected. A stage's first unit
    (stride 2) runs two branches on its whole input: depthwise 3x3 s2
    (linear) -> 1x1 (ReLU), and 1x1 (ReLU) -> depthwise 3x3 s2 (linear) ->
    1x1 (ReLU), each to half the stage's width. Every later unit starts
    with a Slice (axis 1, iscaffe) into halves, keeps the first and runs the
    second through 1x1 (ReLU) -> depthwise 3x3 (linear) -> 1x1 (ReLU).
    Every unit ends in Concat -> ShuffleChannel(group 2): the chain
    fold_shuffle_gathers folds. Assumed: the weights' scales (He-normal,
    bias 0.05) and the names of the nodes."""
    m = _NetMaker(ir, f"shufflenet-v2-{img}", seed)
    x = m.input([1, 3, img, img])
    t = m.conv("conv1", x, stem, 3, stride=2, pad=1, act=0)
    n, c, h, w = t.shape
    t = m.node("Pooling", "pool1", [t], [n, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1], dict(
        alg=0, kernel_h=3, kernel_w=3, stride_h=2, stride_w=2, global_pool=0, caffe_flavor=0,
        pad_h0=1, pad_w0=1, pad_h1=1, pad_w1=1))
    for s, (width, repeats) in enumerate(zip(widths, units)):
        half = width // 2
        for i in range(repeats):
            name = f"stage{s + 2}_{i + 1}"
            n, c, h, w = t.shape
            if i == 0:
                a = m.conv(f"{name}_branch1_dw", t, c, 3, stride=2, pad=1, group=c)
                a = m.conv(f"{name}_branch1_pw", a, half, 1, act=0)
                b = m.conv(f"{name}_branch2_pw1", t, half, 1, act=0)
                b = m.conv(f"{name}_branch2_dw", b, half, 3, stride=2, pad=1, group=half)
            else:
                a = m.g.add_tensor(f"{name}_slice.out0", ir.DType.FP32, [n, half, h, w],
                                   ir.TensorType.VAR)
                b = m.g.add_tensor(f"{name}_slice.out1", ir.DType.FP32, [n, half, h, w],
                                   ir.TensorType.VAR)
                m.g.add_node("Slice", f"{name}_slice", [t.idx], [a.idx, b.idx], dict(
                    axis=1, iscaffe=1, slice_points=[half], begins=[], sizes=[]))
                b = m.conv(f"{name}_branch2_pw1", b, half, 1, act=0)
                b = m.conv(f"{name}_branch2_dw", b, half, 3, pad=1, group=half)
            b = m.conv(f"{name}_branch2_pw2", b, half, 1, act=0)
            n, _, h, w = b.shape
            t = m.node("Concat", f"{name}_concat", [a, b], [n, width, h, w], dict(axis=1))
            t = m.node("ShuffleChannel", f"{name}_shuffle", [t], t.shape, dict(group=2))
    t = m.conv("conv5", t, conv5, 1, act=0)
    n, c, h, w = t.shape
    t = m.node("Pooling", "pool5", [t], [n, c, 1, 1], dict(
        alg=1, kernel_h=h, kernel_w=w, stride_h=1, stride_w=1, global_pool=1, caffe_flavor=0,
        pad_h0=0, pad_w0=0, pad_h1=0, pad_w1=0))
    wt = m.const("fc.w", m.rng.standard_normal((classes, c)) * np.sqrt(1.0 / c))
    bt = m.const("fc.b", m.rng.standard_normal(classes) * 0.05)
    return m.finish([m.node("FullyConnected", "fc", [t, wt, bt], [n, classes, 1, 1],
                            dict(num_output=classes))])


# ---------------------------------------------------------------------------
# Phase 3n: mobilenet-v1 written in the six source formats of the port's
# front ends (tengine_tpu_torch/convert/) by encoders of this script's own,
# with struct and numpy only: the card's machine has no onnx, caffe, ncnn,
# mxnet, tensorflow, protobuf or flatbuffers package. Each writes the layer
# list of build_mobilenet_v1_graph's float graph (mobilenet_layers).
# ---------------------------------------------------------------------------


def mobilenet_layers(g):
    """build_mobilenet_v1_graph's float graph as a layer list, and its input
    shape: ("conv", name, OIHW weight, bias, stride, pad, group), each
    followed by a ReLU; ("gap", name); ("fc", name, [O, C] weight, bias)."""
    layers = []
    for n in g.toposorted():
        p = n.params
        if n.op == "Convolution":
            if p["activation"] != 0 or p["kernel_h"] != p["kernel_w"]:
                raise ValueError(f"{n.name}: not a square conv with a ReLU")
            layers.append(("conv", n.name, g.tensors[n.inputs[1]].data,
                           g.tensors[n.inputs[2]].data, p["stride_h"], p["pad_h0"], p["group"]))
        elif n.op == "Pooling":
            layers.append(("gap", n.name))
        elif n.op == "FullyConnected":
            layers.append(("fc", n.name, g.tensors[n.inputs[1]].data, g.tensors[n.inputs[2]].data))
    return layers, list(g.tensors[g.input_tensors[0]].shape)


# --- protocol buffers (the wire format: a varint key field << 3 | wire type,
# then a varint, 4 bytes, or a varint length and the bytes) ---


def _pb_varint(v: int) -> bytes:
    out, v = bytearray(), v & (2**64 - 1)
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


def _pb_ld(field: int, payload: bytes) -> bytes:
    return _pb_varint(field << 3 | 2) + _pb_varint(len(payload)) + payload


def _pb_str(field: int, s: str) -> bytes:
    return _pb_ld(field, s.encode())


def _pb_int(field: int, v: int) -> bytes:
    return _pb_varint(field << 3) + _pb_varint(int(v))


def _pb_f32(field: int, v: float) -> bytes:
    return _pb_varint(field << 3 | 5) + struct.pack("<f", v)


def _pb_packed(field: int, vals) -> bytes:
    return _pb_ld(field, b"".join(_pb_varint(int(v)) for v in vals))


def encode_onnx(layers, shape):
    """An ONNX ModelProto (onnx.proto3: ModelProto ir_version=1 graph=7
    opset_import=8; GraphProto node=1 name=2 initializer=5 input=11
    output=12; NodeProto input=1 output=2 name=3 op_type=4 attribute=5;
    AttributeProto name=1 f=2 i=3 ints=8 type=20; TensorProto dims=1
    data_type=2 name=8 raw_data=9): Conv + Relu, GlobalAveragePool,
    Flatten, Gemm."""
    def attr(name, val):
        out = _pb_str(1, name)
        if isinstance(val, list):
            return out + _pb_packed(8, val) + _pb_int(20, 7)
        if isinstance(val, float):
            return out + _pb_f32(2, val) + _pb_int(20, 1)
        return out + _pb_int(3, val) + _pb_int(20, 2)

    def node(op, ins, outs, name, **attrs):
        return (b"".join(_pb_str(1, i) for i in ins) + b"".join(_pb_str(2, o) for o in outs)
                + _pb_str(3, name) + _pb_str(4, op)
                + b"".join(_pb_ld(5, attr(k, v)) for k, v in attrs.items()))

    def tensor(name, arr):
        arr = np.ascontiguousarray(arr, np.float32)
        return _pb_packed(1, arr.shape) + _pb_int(2, 1) + _pb_str(8, name) + _pb_ld(9, arr.tobytes())

    def value_info(name, dims):  # ValueInfoProto name=1 type=2: TypeProto.tensor_type=1
        dims_pb = b"".join(_pb_ld(1, _pb_int(1, d)) for d in dims)  # Dimension dim_value=1
        return _pb_str(1, name) + _pb_ld(2, _pb_ld(1, _pb_int(1, 1) + _pb_ld(2, dims_pb)))

    nodes, inits, x = [], [], "data"
    for layer in layers:
        if layer[0] == "conv":
            _, name, w, b, s, pad, group = layer
            k = int(w.shape[2])
            nodes.append(node("Conv", [x, f"{name}.w", f"{name}.b"], [name], name,
                              kernel_shape=[k, k], pads=[pad] * 4, strides=[s, s], group=group,
                              dilations=[1, 1]))
            nodes.append(node("Relu", [name], [f"{name}.relu"], f"{name}/relu"))
            inits += [tensor(f"{name}.w", w), tensor(f"{name}.b", b)]
            x = f"{name}.relu"
        elif layer[0] == "gap":
            nodes.append(node("GlobalAveragePool", [x], [layer[1]], layer[1]))
            nodes.append(node("Flatten", [layer[1]], [f"{layer[1]}.flat"], f"{layer[1]}/flat",
                              axis=1))
            x = f"{layer[1]}.flat"
        else:
            _, name, w, b = layer
            nodes.append(node("Gemm", [x, f"{name}.w", f"{name}.b"], [name], name, transB=1,
                              alpha=1.0, beta=1.0))
            inits += [tensor(f"{name}.w", w), tensor(f"{name}.b", b)]
            x = name
    graph = (b"".join(_pb_ld(1, n) for n in nodes) + _pb_str(2, "mobilenet-v1")
             + b"".join(_pb_ld(5, t) for t in inits) + _pb_ld(11, value_info("data", shape))
             + _pb_ld(12, value_info(x, [shape[0], len(layers[-1][3])])))
    model = _pb_int(1, 8) + _pb_ld(7, graph) + _pb_ld(8, _pb_str(1, "") + _pb_int(2, 13))
    return {"model.onnx": model}, ["-m", "model.onnx"]


def encode_caffe(layers, shape):
    """A Caffe deploy prototxt (Convolution with group, in-place ReLU,
    Pooling AVE global_pooling, InnerProduct) and its caffemodel
    (caffe.proto: NetParameter layer=100; LayerParameter name=1 blobs=7;
    BlobProto data=5 shape=7; BlobShape dim=1)."""
    def blob(arr):
        arr = np.ascontiguousarray(arr, np.float32)
        return _pb_ld(7, _pb_packed(1, arr.shape)) + _pb_ld(5, arr.tobytes())

    lines = ['name: "mobilenet-v1"', 'input: "data"',
             "input_shape { " + " ".join(f"dim: {d}" for d in shape) + " }"]
    model, x = [], "data"
    for layer in layers:
        name = layer[1]
        if layer[0] == "conv":
            _, _, w, b, s, pad, group = layer
            lines.append(f'layer {{ name: "{name}" type: "Convolution" bottom: "{x}" top: "{name}" '
                         f"convolution_param {{ num_output: {w.shape[0]} kernel_size: {w.shape[2]} "
                         f"stride: {s} pad: {pad} group: {group} bias_term: true }} }}")
            lines.append(f'layer {{ name: "{name}/relu" type: "ReLU" bottom: "{name}" '
                         f'top: "{name}" }}')
        elif layer[0] == "gap":
            lines.append(f'layer {{ name: "{name}" type: "Pooling" bottom: "{x}" top: "{name}" '
                         "pooling_param { pool: AVE global_pooling: true } }")
        else:
            w, b = layer[2], layer[3]
            lines.append(f'layer {{ name: "{name}" type: "InnerProduct" bottom: "{x}" '
                         f'top: "{name}" inner_product_param {{ num_output: {w.shape[0]} }} }}')
        if layer[0] != "gap":
            model.append(_pb_ld(100, _pb_str(1, name) + _pb_ld(7, blob(layer[2]))
                                + _pb_ld(7, blob(layer[3]))))
        x = name
    files = {"deploy.prototxt": "\n".join(lines) + "\n", "weights.caffemodel": b"".join(model)}
    return files, ["-m", "deploy.prototxt", "-w", "weights.caffemodel"]


def encode_ncnn(layers, shape):
    """An ncnn .param (magic 7767517; Convolution / ConvolutionDepthWise with
    the fused ReLU 9=1, Pooling global average 0=1 4=1, InnerProduct) and
    .bin (each weight after a u32 tag 0: fp32; each bias raw)."""
    lines, blobs, x = [f"Input data 0 1 data 0={shape[3]} 1={shape[2]} 2={shape[1]}"], [], "data"
    tag = struct.pack("<I", 0)
    for layer in layers:
        name = layer[1]
        if layer[0] == "conv":
            _, _, w, b, s, pad, group = layer
            kind, extra = ("ConvolutionDepthWise", f" 7={group}") if group > 1 else ("Convolution", "")
            lines.append(f"{kind} {name} 1 1 {x} {name} 0={w.shape[0]} 1={w.shape[2]} 3={s} "
                         f"4={pad} 5=1 6={w.size}{extra} 9=1")
        elif layer[0] == "gap":
            lines.append(f"Pooling {name} 1 1 {x} {name} 0=1 4=1")
        else:
            w = layer[2]
            lines.append(f"InnerProduct {name} 1 1 {x} {name} 0={w.shape[0]} 1=1 2={w.size}")
        if layer[0] != "gap":
            blobs += [tag + np.ascontiguousarray(layer[2], np.float32).tobytes(),
                      np.ascontiguousarray(layer[3], np.float32).tobytes()]
        x = name
    text = f"7767517\n{len(lines)} {len(lines)}\n" + "\n".join(lines) + "\n"
    return {"model.param": text, "model.bin": b"".join(blobs)}, ["-m", "model.param", "-w", "model.bin"]


def encode_mxnet(layers, shape):
    """An MXNet symbol JSON (Convolution, Activation relu, Pooling global avg,
    Flatten, FullyConnected) and .params (NDArray save file: u64 magic,
    reserved and count; per array the V2 flag 0xF993FAC8, ndim, int64
    dims, dev_type, dev_id, type_flag 0 = fp32 and the data; then the
    names, arg:-prefixed)."""
    nodes, params = [{"op": "null", "name": "data", "attrs": {}, "inputs": []}], {}

    def add(op, name, inputs=(), **attrs):
        nodes.append({"op": op, "name": name, "attrs": {k: str(v) for k, v in attrs.items()},
                      "inputs": [[i, 0, 0] for i in inputs]})
        return len(nodes) - 1

    def weights(name, w, b):
        params[f"arg:{name}_weight"], params[f"arg:{name}_bias"] = w, b
        return add("null", f"{name}_weight"), add("null", f"{name}_bias")

    x = 0
    for layer in layers:
        name = layer[1]
        if layer[0] == "conv":
            _, _, w, b, s, pad, group = layer
            k = int(w.shape[2])
            wi, bi = weights(name, w, b)
            c = add("Convolution", name, [x, wi, bi], kernel=f"({k}, {k})", stride=f"({s}, {s})",
                    pad=f"({pad}, {pad})", num_filter=w.shape[0], num_group=group, no_bias=False)
            x = add("Activation", f"{name}_relu", [c], act_type="relu")
        elif layer[0] == "gap":
            x = add("Pooling", name, [x], global_pool=True, pool_type="avg", kernel="(1, 1)")
            x = add("Flatten", f"{name}_flat", [x])
        else:
            wi, bi = weights(name, layer[2], layer[3])
            x = add("FullyConnected", name, [x, wi, bi], num_hidden=layer[2].shape[0])
    sym = {"nodes": nodes, "arg_nodes": [i for i, n in enumerate(nodes) if n["op"] == "null"],
           "heads": [[x, 0, 0]]}
    blob = struct.pack("<QQQ", 0x112, 0, len(params))
    for arr in params.values():
        arr = np.ascontiguousarray(arr, np.float32)
        blob += struct.pack("<II", 0xF993FAC8, arr.ndim) + struct.pack(f"<{arr.ndim}q", *arr.shape)
        blob += struct.pack("<III", 1, 0, 0) + arr.tobytes()
    blob += struct.pack("<Q", len(params))
    for name in params:
        blob += struct.pack("<Q", len(name)) + name.encode()
    files = {"model-symbol.json": json.dumps(sym), "model-0000.params": blob}
    return files, ["-m", "model-symbol.json", "-w", "model-0000.params"]


def encode_tf_graphdef(layers, shape, slim=False):
    """A frozen TF GraphDef, NHWC, convs with TF-SAME padding as TensorFlow's
    published mobilenet_v1 (graph.proto: GraphDef node=1 versions=4;
    node_def.proto: NodeDef name=1 op=2 input=3 attr=5, a map of entries
    key=1 value=2; attr_value.proto: AttrValue list=1 s=2 b=5 type=6 shape=7
    tensor=8, ListValue i=3; tensor.proto: TensorProto dtype=1
    tensor_shape=2 tensor_content=4; tensor_shape.proto: dim=2, Dim size=1;
    types.proto: DT_FLOAT 1, DT_INT32 3). Conv2D / DepthwiseConv2dNative +
    BiasAdd + Relu, Mean over H and W, MatMul + BiasAdd. With `slim`, the
    classifier ends as TF-slim's frozen mobilenet_v1 ends: AvgPool over the
    whole map (VALID, keep dims), the FC a 1x1 Conv2D + BiasAdd
    (Logits/Conv2d_1c_1x1), SpatialSqueeze (Squeeze, squeeze_dims [1, 2]),
    then Predictions: Reshape [-1, classes], Softmax, Reshape to
    Shape(logits); the Placeholder's batch unknown."""
    def shape_pb(dims):
        return b"".join(_pb_ld(2, _pb_int(1, d)) for d in dims)

    def tensor(arr):
        dt = {np.dtype(np.float32): 1, np.dtype(np.int32): 3}[arr.dtype]
        return _pb_ld(8, _pb_int(1, dt) + _pb_ld(2, shape_pb(arr.shape))
                      + _pb_ld(4, np.ascontiguousarray(arr).tobytes()))

    def dtype(t):
        return _pb_int(6, t)

    def ints(v):
        return _pb_ld(1, _pb_packed(3, v))

    def text(s):
        return _pb_ld(2, s.encode())

    def flag(v):
        return _pb_int(5, int(v))

    def node(name, op, ins, **attrs):
        body = _pb_str(1, name) + _pb_str(2, op) + b"".join(_pb_str(3, i) for i in ins)
        body += b"".join(_pb_ld(5, _pb_str(1, k) + _pb_ld(2, attrs[k])) for k in sorted(attrs))
        return _pb_ld(1, body)

    def const(name, arr):
        return node(name, "Const", [], dtype=dtype(1 if arr.dtype == np.float32 else 3),
                    value=tensor(arr))

    n, c, h, w = shape
    out = [node("input", "Placeholder", [], dtype=dtype(1),
                shape=_pb_ld(7, shape_pb([-1 if slim else n, h, w, c])))]
    x = "input"
    for layer in layers:
        name = layer[1]
        if layer[0] == "conv":
            _, _, wt, b, s, _, group = layer
            h, w = -(-h // s), -(-w // s)  # SAME
            op, hw = (("Conv2D", wt.transpose(2, 3, 1, 0)) if group == 1  # OIHW -> HWIO
                      else ("DepthwiseConv2dNative", wt.transpose(2, 3, 0, 1)))  # -> [k, k, C, 1]
            out.append(const(f"{name}/weights", np.ascontiguousarray(hw, np.float32)))
            out.append(node(f"{name}/conv", op, [x, f"{name}/weights"], T=dtype(1),
                            strides=ints([1, s, s, 1]), padding=text("SAME"),
                            data_format=text("NHWC"), dilations=ints([1, 1, 1, 1])))
            out.append(const(f"{name}/biases", np.asarray(b, np.float32)))
            out.append(node(f"{name}/bias", "BiasAdd", [f"{name}/conv", f"{name}/biases"],
                            T=dtype(1), data_format=text("NHWC")))
            out.append(node(name, "Relu", [f"{name}/bias"], T=dtype(1)))
        elif layer[0] == "gap" and slim:
            out.append(node(name, "AvgPool", [x], T=dtype(1), ksize=ints([1, h, w, 1]),
                            strides=ints([1, 1, 1, 1]), padding=text("VALID"),
                            data_format=text("NHWC")))
        elif layer[0] == "gap":
            out.append(const(f"{name}/axes", np.asarray([1, 2], np.int32)))
            out.append(node(name, "Mean", [x, f"{name}/axes"], T=dtype(1), Tidx=dtype(3),
                            keep_dims=flag(False)))
        elif slim:
            _, _, wt, b = layer
            classes = int(wt.shape[0])
            out.append(const(f"{name}/weights", np.ascontiguousarray(
                wt.T.reshape(1, 1, -1, classes), np.float32)))
            out.append(node(f"{name}/conv", "Conv2D", [x, f"{name}/weights"], T=dtype(1),
                            strides=ints([1, 1, 1, 1]), padding=text("SAME"),
                            data_format=text("NHWC"), dilations=ints([1, 1, 1, 1])))
            out.append(const(f"{name}/biases", np.asarray(b, np.float32)))
            out.append(node(f"{name}/bias", "BiasAdd", [f"{name}/conv", f"{name}/biases"],
                            T=dtype(1), data_format=text("NHWC")))
            out.append(node("SpatialSqueeze", "Squeeze", [f"{name}/bias"], T=dtype(1),
                            squeeze_dims=ints([1, 2])))
            out.append(const("Predictions/shape", np.asarray([-1, classes], np.int32)))
            out.append(node("Predictions/Reshape", "Reshape", ["SpatialSqueeze", "Predictions/shape"],
                            T=dtype(1), Tshape=dtype(3)))
            out.append(node("Predictions/Softmax", "Softmax", ["Predictions/Reshape"], T=dtype(1)))
            out.append(node("Predictions/Shape", "Shape", ["SpatialSqueeze"], T=dtype(1),
                            out_type=dtype(3)))
            name = "Predictions/Reshape_1"
            out.append(node(name, "Reshape", ["Predictions/Softmax", "Predictions/Shape"],
                            T=dtype(1), Tshape=dtype(3)))
        else:
            _, _, wt, b = layer
            out.append(const(f"{name}/weights", np.ascontiguousarray(wt.T, np.float32)))
            out.append(node(f"{name}/matmul", "MatMul", [x, f"{name}/weights"], T=dtype(1),
                            transpose_a=flag(False), transpose_b=flag(False)))
            out.append(const(f"{name}/biases", np.asarray(b, np.float32)))
            out.append(node(name, "BiasAdd", [f"{name}/matmul", f"{name}/biases"], T=dtype(1),
                            data_format=text("NHWC")))
        x = name
    gd = b"".join(out) + _pb_ld(4, _pb_int(1, 1))  # versions: VersionDef producer=1
    return {"frozen.pb": gd}, ["-m", "frozen.pb"]


# --- FlatBuffers (the TFLite file), written front to back: a table is its
# vtable (u16 size, u16 table size, a u16 field offset a slot) then its soffset
# (i32, back to the vtable) and its fields; a table, vector or string a field
# refers to comes after it (a uoffset is unsigned and points forward) ---


# the objects _fb_build writes: ("table", {slot: value}) where a value is a
# scalar (struct format, value) or another object; ("vec", struct format,
# values or raw bytes, alignment of the elements); ("tables", [table, ...]);
# ("str", text)
_FB_REFS = ("table", "vec", "tables", "str")


def _fb_table(fields):
    return ("table", fields)


def _fb_vec(fmt, values, align=4):
    return ("vec", fmt, values, align)


def _fb_build(root, ident: bytes) -> bytes:
    """The FlatBuffer of `root` (a table), with file identifier `ident`."""
    buf = bytearray(b"\0\0\0\0" + ident)

    def align(n, extra=0):
        while (len(buf) + extra) % n:
            buf.append(0)

    def patch(at, target):
        struct.pack_into("<I", buf, at, target - at)

    def write(obj) -> int:
        kind = obj[0]
        if kind == "str":
            align(4)
            pos, data = len(buf), obj[1].encode()
            buf.extend(struct.pack("<I", len(data)) + data + b"\0")
            return pos
        if kind == "vec":
            _, fmt, values, el_align = obj
            align(max(4, el_align), extra=4)
            pos = len(buf)
            if isinstance(values, bytes):
                buf.extend(struct.pack("<I", len(values)) + values)
            else:
                buf.extend(struct.pack(f"<I{len(values)}{fmt}", len(values), *values))
            return pos
        if kind == "tables":
            align(4)
            pos = len(buf)
            buf.extend(struct.pack("<I", len(obj[1])) + b"\0" * (4 * len(obj[1])))
            for i, t in enumerate(obj[1]):
                patch(pos + 4 + 4 * i, write(t))
            return pos
        fields = obj[1]
        n_slots = max(fields) + 1 if fields else 0
        layout, off = {}, 4
        for slot in sorted(fields):
            size = 4 if fields[slot][0] in _FB_REFS else struct.calcsize("<" + fields[slot][0])
            off = (off + size - 1) // size * size
            layout[slot] = (off, size)
            off += size
        vt = struct.pack(f"<HH{n_slots}H", 4 + 2 * n_slots, off,
                         *[layout[s][0] if s in layout else 0 for s in range(n_slots)])
        align(4, extra=len(vt))
        vt_pos = len(buf)
        buf.extend(vt)
        pos = len(buf)
        buf.extend(struct.pack("<i", pos - vt_pos) + b"\0" * (off - 4))
        refs = []
        for slot, (o, size) in layout.items():
            v = fields[slot]
            if v[0] in _FB_REFS:
                refs.append((pos + o, v))
            else:
                struct.pack_into("<" + v[0], buf, pos + o, v[1])
        for at, child in refs:
            patch(at, write(child))
        return pos

    patch(0, write(root))
    return bytes(buf)


# schema.fbs: BuiltinOperator codes, the options tables' BuiltinOptions
# union types, TensorType and ActivationFunctionType values
_TFL_CONV_2D, _TFL_DEPTHWISE_CONV_2D, _TFL_FULLY_CONNECTED, _TFL_MEAN = 3, 4, 9, 40
_TFL_OPTS_CONV, _TFL_OPTS_DW, _TFL_OPTS_FC, _TFL_OPTS_REDUCER = 1, 2, 8, 27
_TFL_FLOAT32, _TFL_INT32, _TFL_INT8 = 0, 2, 9
_TFL_RELU = 1


def encode_tflite(layers, shape, grids=None):
    """A TFLite flatbuffer (schema.fbs, identifier TFL3), NHWC, convs with
    SAME padding and a fused RELU, MEAN over H and W, FULLY_CONNECTED.
    fp32, or with `grids` ({tensor name: (scale, uint8 zero point)}: a
    calibration's uint8 MinMax grids) TFLite's full-int8 scheme: int8
    activations on those grids shifted by -128, per-channel symmetric int8
    weights (quantized_dimension 0, 3 for the depthwise [1, k, k, C]) and
    int32 biases at s_in * s_w, zero points 0. Tables and slots written:
    Model version=0 operator_codes=1 subgraphs=2 description=3 buffers=4;
    SubGraph tensors=0 inputs=1 outputs=2 operators=3 name=4; Tensor shape=0
    type=1 buffer=2 name=3 quantization=4; QuantizationParameters scale=2
    zero_point=3 quantized_dimension=6; Buffer data=0; Operator
    opcode_index=0 inputs=1 outputs=2 builtin_options_type=3
    builtin_options=4; OperatorCode deprecated_builtin_code=0 version=2
    builtin_code=3; Conv2DOptions padding=0 stride_w=1 stride_h=2
    fused_activation_function=3; DepthwiseConv2DOptions padding=0
    stride_w=1 stride_h=2 depth_multiplier=3 fused_activation_function=4;
    ReducerOptions keep_dims=0; FullyConnectedOptions
    fused_activation_function=0."""
    tensors, buffers, ops, codes = [], [_fb_table({})], [], []

    def quant(scales, zps, dim=0):
        return _fb_table({2: _fb_vec("f", scales), 3: _fb_vec("q", zps, 8), 6: ("i", dim)})

    def act_grid(name):
        s, zp = grids[name]
        return quant([s], [zp - 128])

    def add_tensor(name, dims, ttype, data=None, q=None):
        fields = {0: _fb_vec("i", dims), 1: ("b", ttype), 2: ("I", 0), 3: ("str", name)}
        if data is not None:
            fields[2] = ("I", len(buffers))
            buffers.append(_fb_table({0: _fb_vec("B", np.ascontiguousarray(data).tobytes(), 16)}))
        if q is not None:
            fields[4] = q
        tensors.append(_fb_table(fields))
        return len(tensors) - 1

    def activation(name, dims):
        if grids is None:
            return add_tensor(name, dims, _TFL_FLOAT32)
        return add_tensor(name, dims, _TFL_INT8, q=act_grid(name))

    def add_op(code, ins, outs, opts_type, opts):
        if code not in codes:
            codes.append(code)
        ops.append(_fb_table({0: ("I", codes.index(code)), 1: _fb_vec("i", ins),
                              2: _fb_vec("i", outs), 3: ("B", opts_type), 4: _fb_table(opts)}))

    def weights(name, w, dims, axis, s_in):
        """The weight tensor (fp32, or per-channel int8 along `axis`) and
        its bias (fp32, or int32 at s_in * s_w)."""
        w_src, b = w
        if grids is None:
            return (add_tensor(f"{name}/weights", dims, _TFL_FLOAT32,
                               np.asarray(w_src, np.float32)),
                    add_tensor(f"{name}/biases", [len(b)], _TFL_FLOAT32, np.asarray(b, np.float32)))
        red = tuple(i for i in range(w_src.ndim) if i != axis)
        s_w = np.maximum(np.abs(w_src).max(axis=red), 1e-12).astype(np.float64) / 127
        bshape = [-1 if i == axis else 1 for i in range(w_src.ndim)]
        wq = np.clip(np.round(w_src / s_w.reshape(bshape)), -127, 127).astype(np.int8)
        s_b = s_in * s_w
        bq = np.round(np.asarray(b, np.float64) / s_b).astype(np.int32)
        n = len(s_w)
        return (add_tensor(f"{name}/weights", dims, _TFL_INT8, wq,
                           quant(s_w.astype(np.float32).tolist(), [0] * n, axis)),
                add_tensor(f"{name}/biases", [n], _TFL_INT32, bq,
                           quant(s_b.astype(np.float32).tolist(), [0] * n)))

    n, c, h, w = shape
    x = activation("input", [n, h, w, c])
    x_name, cur = "input", [n, h, w, c]
    for layer in layers:
        name = layer[1]
        s_in = grids[x_name][0] if grids is not None else None
        if layer[0] == "conv":
            _, _, wt, b, s, _, group = layer
            o, k = int(wt.shape[0]), int(wt.shape[2])
            oh, ow = -(-cur[1] // s), -(-cur[2] // s)  # SAME
            if group == 1:
                wi, bi = weights(name, (wt.transpose(0, 2, 3, 1), b), [o, k, k, cur[3]], 0, s_in)
                code, opts_type = _TFL_CONV_2D, _TFL_OPTS_CONV
                opts = {0: ("b", 0), 1: ("i", s), 2: ("i", s), 3: ("b", _TFL_RELU)}
            else:
                wi, bi = weights(name, (wt.transpose(1, 2, 3, 0), b), [1, k, k, o], 3, s_in)
                code, opts_type = _TFL_DEPTHWISE_CONV_2D, _TFL_OPTS_DW
                opts = {0: ("b", 0), 1: ("i", s), 2: ("i", s), 3: ("i", 1), 4: ("b", _TFL_RELU)}
            cur = [n, oh, ow, o]
            y = activation(name, cur)
            add_op(code, [x, wi, bi], [y], opts_type, opts)
        elif layer[0] == "gap":
            axes = add_tensor(f"{name}/axes", [2], _TFL_INT32, np.asarray([1, 2], np.int32))
            cur = [n, cur[3]]
            y = activation(name, cur)
            add_op(_TFL_MEAN, [x, axes], [y], _TFL_OPTS_REDUCER, {0: ("B", 0)})
        else:
            _, _, wt, b = layer
            wi, bi = weights(name, (wt, b), list(wt.shape), 0, s_in)
            cur = [n, int(wt.shape[0])]
            y = activation(name, cur)
            add_op(_TFL_FULLY_CONNECTED, [x, wi, bi], [y], _TFL_OPTS_FC, {0: ("b", 0)})
        x, x_name = y, name
    subgraph = _fb_table({0: ("tables", tensors), 1: _fb_vec("i", [0]), 2: _fb_vec("i", [x]),
                          3: ("tables", ops), 4: ("str", "main")})
    model = _fb_table({
        0: ("I", 3),
        1: ("tables", [_fb_table({0: ("b", min(cd, 127)), 2: ("i", 1), 3: ("i", cd)})
                       for cd in codes]),
        2: ("tables", [subgraph]), 3: ("str", "chip_smoke"), 4: ("tables", buffers)})
    name = "model_int8.tflite" if grids is not None else "model.tflite"
    return {name: _fb_build(model, b"TFL3")}, ["-m", name]


FRONTEND_ENCODERS = {"onnx": encode_onnx, "caffe": encode_caffe, "ncnn": encode_ncnn,
                     "mxnet": encode_mxnet, "tf": encode_tf_graphdef, "tflite": encode_tflite}


def convert_models(tmp: Path, models, shape):
    """Each encoded model through the port's convert tool (python -m
    tengine_tpu_torch.tools.convert_tool -f FMT ... --optimize -o
    FMT.tmfile), one subprocess a format, all started together from the
    repository's root; each must exit 0. Returns {format: (tmfile path,
    seconds)}."""
    procs = {}
    for fmt, (files, args) in models.items():
        d = tmp / fmt
        d.mkdir(parents=True, exist_ok=True)
        for name, data in files.items():
            (d / name).write_bytes(data.encode() if isinstance(data, str) else data)
        args = [str(d / a) if a in files else a for a in args]
        cmd = [sys.executable, "-m", "tengine_tpu_torch.tools.convert_tool",
               "-f", fmt.split("-")[0], *args,
               "--input-shape", ",".join(map(str, shape)), "--optimize",
               "-o", str(d / f"{fmt}.tmfile")]
        procs[fmt] = (subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), time.perf_counter())
    out = {}
    for fmt, (proc, t0) in procs.items():
        text, _ = proc.communicate(timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"convert_tool -f {fmt} exited {proc.returncode}: {text[-2000:]}")
        log(f"  {fmt}: convert_tool {seconds:.2f} s: {' | '.join(text.strip().splitlines())}")
        out[fmt] = (tmp / fmt / f"{fmt}.tmfile", seconds)
    return out


def plain_mobilenet(torch, layers, x, same):
    """The layer list's forward in plain torch (F.conv2d, F.relu, mean,
    F.linear) on NCHW x: each conv padded as build_mobilenet_v1_graph pads
    it, or TF-SAME (the pad total max(0, (out - 1) * s + k - in), its
    smaller half before) where `same`. Returns [N, classes] logits."""
    import torch.nn.functional as F

    for layer in layers:
        if layer[0] == "conv":
            _, _, w, b, s, pad, group = layer
            wt, bt = torch.from_numpy(w).to(x.device), torch.from_numpy(b).to(x.device)
            k = w.shape[2]
            if same:
                tot = [max(0, (-(-size // s) - 1) * s + k - size) for size in x.shape[2:]]
                x = F.pad(x, (tot[1] // 2, tot[1] - tot[1] // 2, tot[0] // 2, tot[0] - tot[0] // 2))
                pad = 0
            x = F.relu(F.conv2d(x, wt, bt, stride=s, padding=pad, groups=group))
        elif layer[0] == "gap":
            x = x.mean((2, 3))
        else:
            x = F.linear(x, torch.from_numpy(layer[2]).to(x.device),
                         torch.from_numpy(layer[3]).to(x.device))
    return x


def tflite_grids(qg):
    """{tensor name: (scale, zero point)} of a quantized graph's activations
    (its input's and every node output's)."""
    return {t.name: (float(np.asarray(t.quant.scales).reshape(-1)[0]),
                     int(np.asarray(t.quant.zero_points).reshape(-1)[0]))
            for t in qg.tensors if t.data is None and t.quant is not None}


def check_fp32_import(what, out, want):
    """An imported graph's fp32 logits against the plain forward's: cosine
    >= 0.99999 and max |d| <= 1e-3 of the plain logits' largest magnitude."""
    a, b = out.reshape(want.shape).double(), want.double()
    cos = float((a * b).sum() / (a.norm() * b.norm() + 1e-30))
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    log(f"  {what}: cosine {cos:.8f}, max |d| {err:.3e} (logits' scale {scale:.3f})")
    if not (cos >= 0.99999 and err <= 1e-3 * scale):
        raise AssertionError(f"{what}: cosine {cos}, max |d| {err} against the plain forward")


def run_frontends(torch, tt, qmath, ir, counters, default, profile):
    """Phase 3n: mobilenet-v1-224 (build_mobilenet_v1_graph, seed-0 weights)
    written in each of the six formats by this script's encoders, imported
    through the port's convert tool (convert_models) and read back with
    tt.load_model; each graph's 27 convs must carry the fused ReLU that
    --optimize folds in. fp32: each format at batch 8 against
    plain_mobilenet with its pads (cosine >= 0.99999, max |d| <= 1e-3 of
    the logits' scale; TF32 off). Then, checked by run_quant_tier (the
    routes derived from the IR, captured = eager at 0 LSB, every kernel
    launch against its plain version, the dequantized logits' cosine
    against the fp32 import's > 0.99, batch-1 rows, card = CPU within
    1 LSB):
      ONNX-U  the ONNX import, quantize_graph UINT8 MinMax on the card
              from images[:1], under FRONTEND_TIERS["ONNX-U"]: 13 dw_qconv
              and 13 qconv1x1; its outputs equal, at 0 LSB, those of the
              in-code graph put through the same optimize, quantizer and
              Options;
      TFL-D / TFL-U  the full-int8 TFLite file that encode_tflite writes on
              the UINT8 MinMax grids of the fp32 TFLite import (calibrated
              likewise), imported with no calibration: default Options at
              batch 8 (no kernel), and at batch 32 13 dw_qconv and no
              qconv1x1 (the pointwise convs' shifted INT8 input keeps them
              on the fast lowering). Every INT8 activation of the tool's
              tmfile carries full_range (TFLite's [-128, 127]); on the
              card under TFL-U's Options conv1 and the dw_qconv outputs
              hold -128 (their shares printed), which the JAX engine
              clips to -127 (ROADMAP §3).
    The TF-slim tail: the GraphDef with encode_tf_graphdef(slim=True)'s
    classifier (AvgPool, a 1x1 conv, Squeeze, Reshape, Softmax, Reshape to
    Shape(logits)) through the tool, its output at batch 8 against the
    plain forward's logits (check_slim_tail).
    Prints each import's seconds and the quantized tiers' ms per batch
    beside tiers K and L. Returns the launches by kernel."""
    from tengine_tpu_torch.graph.passes import optimize

    t1 = time.time()
    g = build_mobilenet_v1_graph(ir)
    layers, shape = mobilenet_layers(g)
    images = np.random.default_rng(0).standard_normal(
        (FRONTEND_U_BATCH, 3, shape[2], shape[3])).astype(np.float32)
    x_dev = torch.from_numpy(images).cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = dict.fromkeys(counters, 0)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        models = {fmt: FRONTEND_ENCODERS[fmt](layers, shape) for fmt in FRONTEND_FORMATS}
        models["tf-slim"] = encode_tf_graphdef(layers, shape, slim=True)
        log(f"  mobilenet-v1-{shape[2]} encoded in {len(models)} formats: {time.time() - t1:.1f} s")
        tms = convert_models(tmp, models, shape)
        log("phase 3n import seconds (convert_tool --optimize, the seven at once): "
            + ", ".join(f"{fmt} {s:.2f}" for fmt, (_, s) in tms.items()))
        slim_path, _ = tms.pop("tf-slim")
        graphs = {fmt: tt.load_model(str(path)) for fmt, (path, _) in tms.items()}
        for fmt, gi in graphs.items():
            convs = [n for n in gi.nodes if n.op == "Convolution"]
            if len(convs) != 27 or any(n.params["activation"] != 0 for n in convs) or any(
                    n.op in ("ReLu", "BatchNormalization") for n in gi.nodes):
                raise AssertionError(f"{fmt}: the import is not mobilenet-v1 with fused ReLUs")

        fp32_u = {}
        for fmt, gi in graphs.items():
            cg = tt.compile_graph(gi, tt.Options(precision="fp32", batch_size=FRONTEND_BATCH))
            (out,) = eager(torch, cg, x_dev[:FRONTEND_BATCH])
            want = plain_mobilenet(torch, layers, x_dev[:FRONTEND_BATCH],
                                   same=fmt in SAME_PAD_FORMATS)
            check_fp32_import(f"{fmt} import fp32 b{FRONTEND_BATCH} vs plain torch", out, want)
            if fmt in ("onnx", "tflite"):
                cg = tt.compile_graph(gi, tt.Options(precision="fp32",
                                                     batch_size=FRONTEND_U_BATCH))
                fp32_u[fmt] = eager(torch, cg, x_dev)
            del cg
        check_slim_tail(torch, tt, tt.load_model(str(slim_path)), layers,
                        x_dev[:FRONTEND_BATCH])

        opts, gate, per_forward, batch = FRONTEND_TIERS["ONNX-U"]
        q_onnx = tt.quantize_graph(graphs["onnx"], [images[:1]], scheme="uint8",
                                   algorithm="minmax")
        sink = []
        got, *rows["ONNX-U"] = run_quant_tier(
            torch, tt, qmath, counters, f"mobilenet-v1-{shape[2]} onnx import uint8 b{batch} tier ONNX-U",
            q_onnx, fp32_u["onnx"], images, dict(opts, batch_size=batch), gate, per_forward,
            batch, 0, profile, outs_sink=sink)
        launches = {k: launches[k] + got[k] for k in launches}
        g_ref = build_mobilenet_v1_graph(ir)
        optimize(g_ref)
        q_ref = tt.quantize_graph(g_ref, [images[:1]], scheme="uint8", algorithm="minmax")
        t_in, t_ref = (q.tensors[q.input_tensors[0]] for q in (q_onnx, q_ref))
        if not (np.array_equal(t_in.quant.scales, t_ref.quant.scales)
                and np.array_equal(t_in.quant.zero_points, t_ref.quant.zero_points)):
            raise AssertionError("onnx import and in-code graph: the input grids differ")
        with dw_gate(gate):
            cg_ref = tt.compile_graph(q_ref, tt.Options(**dict(opts, batch_size=batch)))
        xq = torch.from_numpy(qmath.quantize_np(images, t_in.quant, t_in.dtype)).cuda()
        (ref_out,) = eager(torch, cg_ref, xq)
        d = (sink[0][0].reshape(batch, -1).int() - ref_out.reshape(batch, -1).int()).abs()
        log(f"  ONNX-U vs the in-code graph (optimize, quantize, compile alike): max |d| "
            f"{int(d.max())} LSB over {d.numel()} logits")
        if int(d.max()) != 0:
            raise AssertionError("ONNX-U: the onnx import parts from the in-code graph")
        del cg_ref, sink

        grids = tflite_grids(tt.quantize_graph(graphs["tflite"], [images[:1]], scheme="uint8",
                                               algorithm="minmax"))
        ((path, seconds),) = convert_models(
            tmp, {"tflite-int8": encode_tflite(layers, shape, grids)}, shape).values()
        g8 = tt.load_model(str(path))
        bare = [t.name for t in g8.tensors if t.quant is None]
        if bare or not any(t.dtype == ir.DType.INT8 for t in g8.tensors):
            raise AssertionError(f"tflite int8 import: tensors without a grid {bare[:5]}")
        acts = [t for t in g8.tensors if t.data is None and t.dtype == ir.DType.INT8]
        short = [t.name for t in acts if not t.quant.full_range]
        if short:
            raise AssertionError(f"tflite int8 import: activations clipped at -127 after the "
                                 f"tool's tmfile {short[:5]}")
        log(f"  tflite full-int8 import: {seconds:.2f} s, no calibration; its {len(acts)} INT8 "
            f"activations all full_range ([-128, 127]) after the tool's tmfile")
        for tier in ("TFL-D", "TFL-U"):
            opts, gate, per_forward, batch = FRONTEND_TIERS[tier]
            got, *rows[tier] = run_quant_tier(
                torch, tt, qmath, counters,
                f"mobilenet-v1-{shape[2]} tflite full-int8 import b{batch} tier {tier}", g8,
                fp32_u["tflite"], images, dict(opts, batch_size=batch), gate, per_forward, batch,
                0, profile, out_dtype=torch.int8)
            launches = {k: launches[k] + got[k] for k in launches}
        check_minus_128(torch, tt, qmath, g8, images)
    log("phase 3n ms/batch captured, eager: " + ", ".join(
        f"{tier} {cap:.3f}, {eag:.3f}" for tier, (cap, eag) in rows.items())
        + "; beside mobilenet-v1-224 uint8 b128 " + ", ".join(
            f"{tier} {default[tier][6][0]:.3f}, {default[tier][6][1]:.3f}" for tier in ("K", "L"))
        + f" [{gpu_name_and_power_limit()}]")
    return launches


def check_slim_tail(torch, tt, gs, layers, x):
    """The TF-slim tail's import (encode_tf_graphdef(slim=True) through the
    tool): one Squeeze, the Shape folded into the last Reshape; fp32 at
    x's batch. Its output is a softmax: the log of it, centred per image,
    against the plain forward's logits centred, as check_fp32_import holds
    logits (the probabilities of the seeded net are all near 1/classes,
    and would agree in cosine whatever the logits)."""
    ops = [n.op for n in gs.nodes]
    if ops.count("Squeeze") != 1 or ops.count("Softmax") != 1 or "Shape" in ops:
        raise AssertionError(f"tf-slim tail: imported as {ops[-6:]}")
    cg = tt.compile_graph(gs, tt.Options(precision="fp32", batch_size=x.shape[0]))
    (out,) = eager(torch, cg, x)
    if tuple(out.shape) != (x.shape[0], layers[-1][2].shape[0]):
        raise AssertionError(f"tf-slim tail: output of shape {tuple(out.shape)}")
    got = out.double().log()
    want = plain_mobilenet(torch, layers, x, same=True).double()
    check_fp32_import(f"tf-slim tail ({', '.join(ops[-5:])}) import fp32 b{x.shape[0]}: log "
                      f"softmax centred vs the plain logits centred", got - got.mean(1, True),
                      want - want.mean(1, True))
    del cg


def check_minus_128(torch, tt, qmath, g8, images):
    """The full-int8 TFLite import under TFL-U's Options on the card, every
    tensor of one eager forward: conv1 (ReLU, zero point -128) and the
    outputs of the dw_qconv launches hold -128, the bottom of TFLite's int8
    range, which the JAX engine clips to -127 (ROADMAP §3). The launches
    equal their plain versions (run_quant_tier), so the kernel's epilogue
    clips where qrange says. Prints the shares of -128."""
    opts, gate, _, batch = FRONTEND_TIERS["TFL-U"]
    with dw_gate(gate):
        cg = tt.compile_graph(g8, tt.Options(**dict(opts, batch_size=batch)))
    t_in = g8.tensors[g8.input_tensors[0]]
    xq = torch.from_numpy(qmath.quantize_np(images[:batch], t_in.quant, t_in.dtype)).cuda()
    acts = tensors_by_name(torch, cg, xq)
    dw = [cg.graph.tensors[n.outputs[0]].name for n in cg.graph.nodes
          if cg.kernels.get(n.name) == "lower_conv_quant_pallas_dw"]
    floor = {name: float((acts[name] == -128).double().mean()) for name in ["conv1", *dw]}
    if not floor["conv1"] > 0 or not all(floor[name] > 0 for name in dw):
        raise AssertionError(f"TFL-U: no -128 where TFLite's ReLU zero is {floor}")
    log(f"  TFL-U b{batch} on the card: share of -128 at conv1 {floor['conv1']:.4f}, in the "
        f"{len(dw)} dw_qconv outputs {min(floor[n] for n in dw):.4f}-"
        f"{max(floor[n] for n in dw):.4f} (the JAX engine clips them to -127)")
    del cg
    check_igemm_full_range(torch)


# two INT8 cases of tests/test_torch_cuda.py:QCONV_EDGE_CASES without an
# activation: a 1x1 conv (qconv1x1) and a 3x3 stride-2 conv (qconv_direct)
IGEMM_FULL_RANGE_CASES = (1, 13)
IGEMM_FULL_RANGE_ZP = -100


def check_igemm_full_range(torch) -> None:
    """qconv1x1 and qconv_direct writing a full-range INT8 grid, as a conv
    whose output a TFLite import or the native-int8 plan marks full_range
    does: the edge cases' outputs (about +-50 on the grid) moved to zero
    point IGEMM_FULL_RANGE_ZP and clipped to [-128, 127], so that a share of
    them sits at -128; each kernel = its plain version at 0 LSB under the
    tile pick_tile chooses. A kernel that clipped at -127 would part there."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import QCONV_EDGE_CASES, port_qconv, qconv_edge_inputs

    shares = {}
    for i in IGEMM_FULL_RANGE_CASES:
        case = QCONV_EDGE_CASES[i]
        inp = qconv_edge_inputs(case, seed=sum(case[:7]))
        inp["B"] = inp["B"] + np.float32(IGEMM_FULL_RANGE_ZP)
        inp["kw_args"].update(zp_out=IGEMM_FULL_RANGE_ZP, lo=-128, hi=127)
        want = port_qconv(inp, "cuda", kernel=False)
        got = port_qconv(inp, "cuda", kernel=True)
        name = "qconv1x1" if inp["pointwise"] else "qconv_direct"
        err = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
        shares[name] = float((got == -128).mean())
        if err or not shares[name] > 0:
            raise AssertionError(f"{name} on a full-range grid: {err} LSB from its plain "
                                 f"version, share of -128 {shares[name]}")
    log(f"  qconv1x1 / qconv_direct on a full-range INT8 grid (zero point "
        f"{IGEMM_FULL_RANGE_ZP}): = plain at 0 LSB, share of -128 "
        + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))


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


def check_requant_kernels(torch):
    """Phase 2 for the passes around the fast tier's library conv
    (ops/cuda/requant.py): qwiden and qrequant against their plain versions
    at the main path's largest shapes, in both layouts the library conv
    hands over, bit for bit, and timed (graph_ms) beside the plain
    versions; bound by bytes (1 in and 8 out, 8 in and 1 out)."""
    from tengine_tpu_torch.ops.cuda import requant as rq

    def same(got, want, what):
        torch.cuda.synchronize()
        if got.stride() != want.stride() or not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel != plain (strides {got.stride()} / "
                                 f"{want.stride()})")
        return 0

    def nhwc(shape, dtype, layout, lo, hi, gen):
        """Random integers in [lo, hi), NHWC memory or the NHWC view of NCHW."""
        n, h, w, c = shape
        t = torch.randint(lo, hi, (n, c, h, w) if layout == "nchw" else shape, generator=gen,
                          device="cuda", dtype=dtype)
        return t.permute(0, 2, 3, 1) if layout == "nchw" else t

    gen = torch.Generator(device="cuda").manual_seed(24)
    entries = {}
    # the main path's largest launches, in the layout they run in there
    # first (both nets run NCHW from their NCHW input on; yolov5s's first
    # convs read the stem's NHWC output): mobilenet-v1-224 b128's dw conv2_2
    # input 112x112x64 (UINT8 after ReLU, zp_in 0: "shift", the conv pads)
    # and its pointwise conv2_1 output, requantized to UINT8 with ReLU;
    # yolov5s-640 b8's largest SiLU conv, 320x320x32 raw INT8 in and
    # 160x160x64 out; then the depthwise zp fold ("fill", zp_in 101) at
    # mobilenet's shape, which the benchmark's nets do not take
    widen = [("mobilenet b128 shift", (128, 112, 112, 64), torch.uint8, 0, "shift", None,
              ("nchw", "nhwc")),
             ("yolov5s b8 raw", (8, 320, 320, 32), torch.int8, 0, "raw", None, ("nhwc", "nchw")),
             ("zp fold b128 fill", (128, 112, 112, 64), torch.uint8, 101, "fill",
              ((1, 1), (1, 1)), ("nhwc", "nchw"))]
    requant = [("mobilenet b128 u8 relu", (128, 112, 112, 64), 0, True, ("nchw", "nhwc")),
               ("yolov5s b8 s8 silu", (8, 160, 160, 64), 100, False, ("nchw", "nhwc"))]
    for what, shape, dtype, zp, mode, pads, layouts in widen:
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        for layout in layouts:
            x = nhwc(shape, dtype, layout, lo, hi, gen)
            kw = dict(zp_in=zp, mode=mode, pads=pads)
            err = same(rq.qwiden(x, **kw), rq.qwiden_plain(x, **kw), f"qwiden {what} {layout}")
            ms = graph_ms(lambda: rq.qwiden(x, **kw), iters=20)
            plain_ms = graph_ms(lambda: rq.qwiden_plain(x, **kw), iters=5)
            out = rq.qwiden_plain(x, **kw)
            log(f"  qwiden {what} {layout} {tuple(shape)}:")
            entries.setdefault("qwiden", kernel_entry(
                "qwiden", rq.SOURCE, None, err, ms, plain_ms, x.numel() + 8 * out.numel(), 0,
                None))
    for what, shape, act, u8, layouts in requant:
        C = shape[3]
        mult = (torch.rand(C, generator=gen, device="cuda") * 1e-3 + 1e-4).float()
        bias = (torch.randn(C, generator=gen, device="cuda") * 20).float()
        ep = rq.Epilogue(zp_out=117 if u8 else 0, lo=0 if u8 else -127, hi=255 if u8 else 127,
                         out_u8=u8, s_out=0.0473, act=act)
        for layout in layouts:
            acc = nhwc(shape, torch.float64, layout, -2**20, 2**20, gen)
            err = same(rq.qrequant(acc, mult, bias, None, None, ep),
                       rq.qrequant_plain(acc, mult, bias, None, None, ep),
                       f"qrequant {what} {layout}")
            ms = graph_ms(lambda: rq.qrequant(acc, mult, bias, None, None, ep), iters=20)
            plain_ms = graph_ms(lambda: rq.qrequant_plain(acc, mult, bias, None, None, ep),
                                iters=5)
            log(f"  qrequant {what} {layout} {tuple(shape)}:")
            entries.setdefault("qrequant", kernel_entry(
                "qrequant", rq.SOURCE, None, err, ms, plain_ms, 9 * acc.numel(), 0, None))
    return entries


def check_qconv_fast(torch, resnet_batch=128):
    """Phase 2 for the fast tier's INT8 convs (ops/cuda/qconv.py:
    qconv_fast, csrc/qconv.cu's fast-epilogue mode): yolov5s-640 b8's 80
    convs after the stem (tests/test_torch_qconv_fast.py:yolov5s_convs) and
    ResNet-50-224's 53 at resnet_batch, each bit for bit against its plain
    version on the card (the float64 chain: qwiden's kernel, a float64
    library conv, qrequant's kernel) and timed by graph replay beside it and
    beside the library conv alone; each net's sums over its convs. Returns
    the kernels-line entry: yolov5s's largest SiLU conv (8x320x320x32, 3x3
    s2 to 64 channels)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_qconv_fast import (
        fast_inputs, resnet50_convs, run_fast, run_plain, yolov5s_convs,
    )

    from tengine_tpu_torch.ops.cuda import qconv as pq
    from tengine_tpu_torch.ops.cuda import requant as rq
    from tengine_tpu_torch.ops.lowering import conv2d_nhwc

    entry = None
    for net, batch, convs in (("yolov5s-640", 8, yolov5s_convs(640)[1:]),
                              ("resnet50-224", resnet_batch, resnet50_convs(224))):
        tot = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0)
        for i, conv in enumerate(convs):
            inp = fast_inputs(batch, conv, seed=i, device="cuda")
            got, want = run_fast(inp), run_plain(inp)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"qconv_fast {net} conv {i} {conv}: "
                                     f"{int((got != want).sum())} bytes differ from the plain chain")
            ms = graph_ms(lambda: run_fast(inp), iters=20)
            plain_ms = graph_ms(lambda: run_plain(inp), iters=3)
            x, wf = inp["x"], inp["wp"][..., :conv[2]].to(torch.float64).permute(0, 3, 1, 2)
            xs, pads = rq.qwiden_for_conv(x, mode="raw", pads=inp["pads"])
            lib_ms = graph_ms(lambda: conv2d_nhwc(xs, wf, pads, (conv[5],) * 2, (1, 1), 1),
                              iters=3)
            ops = 2 * got.numel() * conv[2] * conv[4] ** 2
            moved = x.numel() + inp["wp"].numel() + got.numel() * (
                2 if inp["residual"] is not None else 1)
            bound = max(moved / H100_BYTES_PER_S, ops / H100_INT8_OPS_PER_S) * 1e3
            for k, v in (("ms", ms), ("plain", plain_ms), ("lib", lib_ms), ("bound", bound)):
                tot[k] += v
            log(f"  qconv_fast {net} b{batch} conv {i} {conv[:7]} tile "
                f"{pq.pick_tile(got.numel() // got.shape[-1], got.shape[-1])}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f}, library conv {lib_ms:.4f}, bound {bound:.4f}")
            if entry is None and conv[2:6] == (32, 64, 3, 2):
                log(f"  qconv_fast {net} b{batch} largest SiLU conv {tuple(x.shape)}:")
                entry = kernel_entry("qconv_fast", pq.SOURCE, None, 0, ms, plain_ms, moved, ops,
                                     lib_ms)
        log(f"  qconv_fast {net} b{batch}, {len(convs)} convs: kernel {tot['ms']:.4f} ms, "
            f"plain {tot['plain']:.4f}, library conv {tot['lib']:.4f}, bound {tot['bound']:.4f}")
    return entry


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


def timed_ms(torch, fn) -> float:
    """One call of fn() between two CUDA events, in ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def drive(torch, cg, x_dev, counters, what, profile=False, n_batches=3):
    """One tier's main-path run through the captured forward, then its eager
    forward on the same batch.

    Every launch count is set to 0; CompiledGraph.__call__'s first call
    runs one forward to warm up (the kernels' build, cuDNN's set-up, the
    allocator's growth) and captures the next into a CUDA graph, which it
    replays; n_batches more calls are timed with CUDA events around the
    call; the counts are read. A wrapper counts where it launches its
    kernel: in the warm-up forward, and in the capture, which records the
    launch into the graph (WRAPPER_RUNS forwards); a replay relaunches the
    recorded kernels and calls no wrapper. Then cost_analysis() counts the
    device operations of one forward (torch.profiler over one eager forward,
    which also warms the eager path up), and n_batches eager forwards
    (forward_fn) on the same batch are timed, the first one's outputs held
    equal to the captured ones at 0 LSB. The seconds each part took are
    printed. With profile, a torch.profiler breakdown of one captured
    batch. Returns (captured outputs, captured ms per batch, launches by
    kernel, eager ms per batch)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    outs = cg(x_dev)  # the warm-up forward, the capture and a replay
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batch_ms = [timed_ms(torch, lambda: cg(x_dev)) for _ in range(n_batches)]
    launches = {name: c.launches for name, c in counters.items()}
    t2 = time.perf_counter()
    per_forward = cg.cost_analysis()["launches"]
    t3 = time.perf_counter()
    eager, eager_ms = None, []
    with torch.inference_mode():
        for _ in range(n_batches):
            res = []
            eager_ms.append(timed_ms(torch, lambda: res.append(cg.forward_fn(cg.params, x_dev))))
            eager = eager or res[0]
    t4 = time.perf_counter()
    for o, e in zip(outs, eager):
        if o.shape != e.shape or o.dtype != e.dtype or not torch.equal(o, e):
            d = int((o.int() - e.int()).abs().max()) if o.shape == e.shape else -1
            raise AssertionError(f"{what}: captured and eager forwards differ by {d} LSB")
    batch = x_dev.shape[0]
    cap, eag = float(np.median(batch_ms)), float(np.median(eager_ms))
    log(f"  {what}: captured ms/batch {batch_ms} (median {cap:.3f}, {batch * 1e3 / cap:.1f} "
        f"img/s), eager ms/batch {eager_ms} (median {eag:.3f}), captured = eager at 0 LSB, "
        f"{per_forward} device launches a forward (cost_analysis), wrapper launches {launches}; "
        f"seconds: warm-up + capture + replay {t1 - t0:.2f}, timed replays {t2 - t1:.2f}, "
        f"cost_analysis {t3 - t2:.2f}, eager {t4 - t3:.2f}")
    if profile:
        profile_batch(torch, cg, x_dev)
    return outs, batch_ms, launches, eager_ms


def eager(torch, cg, x):
    """The eager forward's outputs (forward_fn): the fp32 references, which
    phase 4 runs once each, need no capture."""
    with torch.inference_mode():
        return cg.forward_fn(cg.params, x)


def keep(cg):
    """What phase 4 reads of a tier's CompiledGraph, so that the tier's CUDA
    graph and the memory pool it holds go with the CompiledGraph before the
    next tier runs."""
    return types.SimpleNamespace(graph=cg.graph, output_ids=cg.output_ids,
                                 kernels=dict(cg.kernels))


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
    runs; the tiers then run on the card. Returns the quantized graph and
    its input (numpy)."""
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
    return qg, qmath.quantize_np(images, t_in.quant, t_in.dtype)


def check_debug_tools(tt, qg, xq):
    """executor/debug.py on the card, on yolov3-64 (check_tiers_exact_small's
    graph and input) under tier A's Options: profile_graph times every node
    eagerly with CUDA events, in topological order (the top nodes printed);
    dump_graph_tensors writes every tensor of the forward but the consts into
    a temporary directory, file for file and line for line what the port's
    CPU run writes, every value within 1 LSB of it, on the first image (the
    text files cost more time than the forward). The seconds each tool took
    are printed."""
    from tengine_tpu_torch.executor.debug import dump_graph_tensors, profile_graph

    t0 = time.perf_counter()
    opts = tt.Options(quant_mode="fast", quant_bf16_storage=False, batch_size=len(xq))
    prof = profile_graph(qg, [xq], opts)
    if [t.node for t in prof.timings] != [n.name for n in qg.toposorted()]:
        raise AssertionError("profile_graph: the nodes are not the graph's, in topological order")
    log(f"  profile_graph yolov3-64 b{len(xq)} tier A on the card: {len(prof.timings)} nodes, "
        f"{prof.total_ms:.3f} ms node by node; the top 8:")
    for t in sorted(prof.timings, key=lambda t: -t.ms)[:8]:
        log(f"    {t.ms:8.3f} ms {t.gflops_rate:9.1f} GFLOP/s  {t.op:16} {t.node}")
    t1 = time.perf_counter()
    opts = tt.Options(quant_mode="fast", quant_bf16_storage=False, batch_size=1)
    with tempfile.TemporaryDirectory() as card, tempfile.TemporaryDirectory() as cpu:
        files = dump_graph_tensors(qg, [xq[:1]], card, opts)
        want = dump_graph_tensors(qg, [xq[:1]], cpu, opts, device="cpu")
        if sorted(Path(f).name for f in files) != sorted(Path(f).name for f in want):
            raise AssertionError("dump_graph_tensors: the card and the CPU wrote other files")
        worst = 0
        for name in (Path(f).name for f in files):
            a, b = (Path(d, name).read_text().splitlines() for d in (card, cpu))
            if a[0] != b[0] or len(a) != len(b):
                raise AssertionError(f"dump_graph_tensors {name}: {a[0]} vs {b[0]} on the CPU")
            worst = max(worst, float(np.abs(np.array(a[1:], np.float64)
                                            - np.array(b[1:], np.float64)).max(initial=0)))
        log(f"  dump_graph_tensors yolov3-64 b1 tier A: {len(files)} files, each with the CPU "
            f"run's header and line count, values at most {worst:g} apart; seconds: "
            f"profile_graph {t1 - t0:.2f}, dump_graph_tensors and compare "
            f"{time.perf_counter() - t1:.2f}")
        if worst > 1:
            raise AssertionError(f"dump_graph_tensors: card and CPU {worst} apart")


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


def run_default_tiers(torch, tt, qmath, counters, graphs, images, profile):
    """Phase 3e: tiers I-M at 224 under default Options on the float graphs
    `graphs` ({"resnet50": ..., "mobilenet-v1": ...}), each calibrated on
    the card from images[:1], at its batch (the first images), driven as
    drive does, its routes and storage plan checked from the compiled graph
    and its launch counts exact. Returns {tier: (what phase 4 reads of the
    CompiledGraph, outputs, opts, TT_DW_PALLAS, quantized graph, quantized
    input, captured and eager ms per batch)}."""
    qgs, out = {}, {}
    for tier, spec in DEFAULT_TIERS.items():
        net, scheme, algorithm, extra, gate, plan, per_forward, batch = spec
        t1 = time.time()
        if (net, scheme, algorithm) not in qgs:
            qg = tt.quantize_graph(graphs[net], [images[:1]], scheme=scheme, algorithm=algorithm)
            t_in = qg.tensors[qg.input_tensors[0]]
            xq = qmath.quantize_np(images, t_in.quant, t_in.dtype)
            qgs[net, scheme, algorithm] = (qg, xq, torch.from_numpy(xq).cuda())
            log(f"  {net} {scheme} {algorithm} set-up (build graph, calibrate): "
                f"{time.time() - t1:.1f} s")
        qg, xq, x_dev = qgs[net, scheme, algorithm]
        xq, x_dev = xq[:batch], x_dev[:batch]
        opts = dict(quant_mode="fast", batch_size=batch, **extra)
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
        per_forward = with_fast(cg, per_forward)
        outs, batch_ms, launches, eager_ms = drive(torch, cg, x_dev, counters,
                                                f"{net}-224 {scheme} b{batch} tier {tier}", profile)
        want = dict.fromkeys(counters, 0) | {
            name: WRAPPER_RUNS * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{net} {scheme} {tier}: launches {launches}, expected {want}")
        if "qconv_fast" in per_forward:
            check_path_kernels(torch, cg, x_dev, f"{net}-224 {scheme} b{batch} tier {tier}",
                               per_forward)
        out[tier] = (keep(cg), outs, opts, gate, qg, xq,
                     (float(np.median(batch_ms)), float(np.median(eager_ms))))
        del cg
        log(f"phase 3 main path: {net}-224 {scheme} ({algorithm}) batch {batch} tier "
            f"{tier} Options({opts}) TT_DW_PALLAS={gate}: native-int8 plan {took_plan} "
            f"({len(shifted)} tensors shifted to full-range int8) [{time.time() - t1:.1f} s]")
    return out


def check_default_tiers(torch, tt, default, fp32, resnet_r):
    """Phase 4 for tiers I-M: the logits' dequantized cosine against the fp32
    engine > 0.99 with top-1 agreement printed; each tier's card run within
    1 LSB of the port's CPU run (same Options and TT_DW_PALLAS, the same
    routes) on the first image; I against R (same net, MinMax and the
    relaxed chains, batch RESNET_BATCH: the first RESNET_BATCH images) and
    L against K by cosine > 0.99; M (batch 1) against K's first image within
    1 LSB (the same graph, Options and routes at another batch)."""
    def logits(cg):
        return [cg.graph.tensors[t] for t in cg.output_ids]

    for tier, (cg, outs, opts, gate, qg, xq, _) in default.items():
        net, scheme, batch = DEFAULT_TIERS[tier][0], DEFAULT_TIERS[tier][1], DEFAULT_TIERS[tier][7]
        heads = logits(cg)
        out_dtype = torch.uint8 if scheme == "uint8" else torch.int8
        fouts = [f[:batch] for f in fp32[net]]
        check_heads(torch, f"{net} {scheme} {tier}", heads, outs, fouts, 0.99, out_dtype)
        if outs[0].shape != (batch, 1000, 1, 1):
            raise AssertionError(f"{net} {tier}: logits of shape {tuple(outs[0].shape)}")
        top1 = (outs[0].reshape(batch, -1).argmax(1)
                == fouts[0].reshape(batch, -1).argmax(1)).double().mean()
        log(f"  {net} {scheme} {tier}: top-1 agreement with the fp32 engine {float(top1):.4f} "
            f"over {batch} images")
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
    check_within_lsb("mobilenet-v1-224 M (batch 1) vs K's image 0", default["M"][1],
                     [o[:1] for o in outs_k], logits(cg_k))


def check_rows(what, got, want, min_valid=10):
    """Detection rows [N, keep_top_k, 6] (label, score, box): labels and
    scores equal, boxes within 1e-5; at least min_valid valid rows (label
    >= 0) an image. Returns the largest box difference."""
    got, want = (np.asarray(a.cpu() if hasattr(a, "cpu") else a) for a in (got, want))
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: rows {got.shape} against {want.shape}, or not finite")
    valid = (got[..., 0] >= 0).sum(axis=1)
    box = float(np.abs(got[..., 2:] - want[..., 2:]).max(initial=0.0))
    if (not np.array_equal(got[..., :2], want[..., :2]) or box > 1e-5
            or valid.min() < min_valid):
        raise AssertionError(f"{what}: labels/scores equal {np.array_equal(got[..., :2], want[..., :2])}, "
                             f"boxes {box:g} apart, valid rows an image {valid.tolist()}")
    return box


def check_path_kernels(torch, cg, x, what, per_forward):
    """Every launch of qconv1x1, qconv_direct, qgemm_requant, dw_qconv,
    stem_qconv and qconv_fast in one eager forward of cg (the main path's
    shapes and data) held against its plain version on the same inputs: at
    most 1 LSB (0 expected; qconv_fast, whose plain version is the float64
    chain it replaces, 0 required), and the launches checked those of
    per_forward ({kernel: launches}). These launches come after drive has
    read the counts, so they count for no tier. Returns {kernel:
    [launches, max LSB]}."""
    import tengine_tpu_torch.ops.quantized as quantized
    from tengine_tpu_torch.ops.cuda import dw_conv, qconv, qgemm, stem_conv

    pairs = {"qconv1x1": qconv.qconv1x1_plain, "qconv_direct": qconv.qconv_direct_plain,
             "qgemm_requant": qgemm.qgemm_requant_plain, "dw_qconv": dw_conv.dw_qconv_plain,
             "stem_qconv": stem_conv.stem_qconv_plain, "qconv_fast": qconv.qconv_fast_plain}
    seen = {name: [0, 0] for name in pairs}

    def checked(name, fn, plain):
        def run(*args, **kw):
            out = fn(*args, **kw)
            kw.pop("tile", None)
            err = max_lsb(torch, out, plain(*args, **kw), f"{what} {name} {tuple(out.shape)}")
            seen[name][0] += 1
            seen[name][1] = max(seen[name][1], err)
            return out
        return run

    originals = {name: getattr(quantized, name) for name in pairs}
    try:
        for name, plain in pairs.items():
            setattr(quantized, name, checked(name, originals[name], plain))
        eager(torch, cg, x)
    finally:
        for name, fn in originals.items():
            setattr(quantized, name, fn)
    log(f"  {what}: kernel vs plain at the path's shapes, launches checked and max LSB: {seen}")
    if (any(n != per_forward.get(name, 0) for name, (n, _) in seen.items())
            or seen["qconv_fast"][1]):
        raise AssertionError(f"{what}: checked {seen}, expected {per_forward}")
    return seen


def run_ssd_tiers(torch, tt, qmath, counters, g, fp32_outs, images, profile):
    """Phase 3f: mobilenet-SSD-300 UINT8 under SSD_TIERS, calibrated on the
    card from images[:1], each tier driven as drive does (captured = eager
    at 0 LSB), its routes and launch counts exact; then, on the tier's own
    CompiledGraph: every kernel launch of one eager forward against its
    plain version (check_path_kernels); each of the first SSD_BATCH images
    at batch 1 against its rows at the tier's batch; the loc and softmax-ed
    conf heads' dequantized cosine against the fp32 engine > 0.99; and the
    card against the port's CPU run with the same Options on image 0
    (detection rows, and the integer heads within 1 LSB). Returns the
    launches by kernel summed over the tiers' main-path runs."""
    t0 = time.time()
    qg = tt.quantize_graph(g, [images[:1]], scheme="uint8", algorithm="minmax")
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(images, t_in.quant, t_in.dtype)
    x_all = torch.from_numpy(xq).cuda()
    log(f"  mobilenet-ssd set-up (build graph, calibrate): {time.time() - t0:.1f} s")
    total = dict.fromkeys(counters, 0)
    for tier, (extra, gate, per_forward, batch) in SSD_TIERS.items():
        t1 = time.time()
        opts = dict(quant_mode="fast", batch_size=batch, **extra)
        with dw_gate(gate):
            cg = tt.compile_graph(qg, tt.Options(**opts))
        routes = [cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution"]
        got = (routes.count("lower_conv_quant_pallas_dw"),
               routes.count("lower_conv_quant_pallas_direct"))
        want = (per_forward.get("dw_qconv", 0),
                per_forward.get("qconv1x1", 0) + per_forward.get("qconv_direct", 0))
        if got != want or len(routes) != 47:
            raise AssertionError(f"mobilenet-ssd {tier}: convs on (dw, direct/1x1) {got}, "
                                 f"expected {want}, of {len(routes)}")
        x = x_all[:batch]
        per_forward = with_fast(cg, per_forward)
        outs, _, launches, _ = drive(torch, cg, x, counters, f"mobilenet-ssd-300 uint8 b{batch} "
                                  f"tier {tier}", profile)
        want = dict.fromkeys(counters, 0) | {
            name: WRAPPER_RUNS * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"mobilenet-ssd {tier}: launches {launches}, expected {want}")
        for name, n in launches.items():
            total[name] += n
        if per_forward:
            check_path_kernels(torch, cg, x, f"mobilenet-ssd {tier}", per_forward)
        det = outs[0]
        worst = max(check_rows(f"mobilenet-ssd {tier} image {i}: batch 1 vs batch {batch}",
                               cg(x[i:i + 1])[0], det[i:i + 1]) for i in range(SSD_BATCH))
        heads = [cg.graph.tensors[t] for t in cg.output_ids[1:]]
        check_heads(torch, f"mobilenet-ssd {tier}", heads, outs[1:],
                    [f[:batch] for f in fp32_outs[1:]], 0.99, torch.uint8)
        with dw_gate(gate):
            cg_cpu = tt.compile_graph(qg, tt.Options(**opts), device="cpu")
        if cg_cpu.kernels != cg.kernels:
            raise AssertionError(f"mobilenet-ssd {tier}: the CPU compile took other routes")
        couts = cg_cpu.run(xq[:1])
        box = check_rows(f"mobilenet-ssd {tier} card vs CPU (image 0)", det[:1], couts[0])
        check_within_lsb(f"mobilenet-ssd {tier} card vs CPU (image 0)",
                         [o[:1] for o in outs[1:]], couts[1:], heads)
        valid = (det[..., 0] >= 0).sum(1).tolist()
        log(f"phase 3 main path: mobilenet-ssd-300 uint8 batch {batch} tier {tier} "
            f"Options({opts}) TT_DW_PALLAS={gate}: valid rows an image {valid}; rows at batch 1 "
            f"= at batch {batch} (boxes within {worst:g}), card = CPU (boxes within {box:g}) "
            f"[{time.time() - t1:.1f} s]")
        del cg
    return total


def fast_igemm(g, n) -> bool:
    """Whether the fast lowering runs conv node n of g on qconv_fast, as
    ops/quantized.py:_igemm_fast_ok reads the IR: INT8 input at zero point 0
    and INT8 const weights at zero point 0, group 1, dilation 1, stride 1
    or 2 both ways, at most 49 taps and 16 a side, K·128² below 2^31."""
    t_in, t_w, p = g.tensors[n.inputs[0]], g.tensors[n.inputs[1]], n.params
    if (t_in.dtype.name != "INT8" or t_w.dtype.name != "INT8" or t_in.quant is None
            or t_w.quant is None or t_in.quant.per_channel or t_w.data is None):
        return False
    kh, kw = p["kernel_h"], p["kernel_w"]
    return (int(np.asarray(t_in.quant.zero_points).reshape(-1)[0]) == 0
            and not np.any(np.asarray(t_w.quant.zero_points)) and p["group"] == 1
            and p["dilation_h"] == p["dilation_w"] == 1 and p["stride_h"] == p["stride_w"]
            and p["stride_h"] in (1, 2) and kh * kw <= 49 and max(kh, kw) <= 16
            and int(t_w.shape[1]) * kh * kw * 128 * 128 < 2**31)


def fast_convs(cg) -> int:
    """The qconv_fast launches a forward of cg makes: its convs on the fast
    lowering where fast_igemm holds, which must be those that stored
    qconv_fast's weight (t<idx>/ohwi_i8)."""
    convs = [n for n in cg.graph.nodes if n.op == "Convolution" and n.name in cg.kernels]
    want = sum(cg.kernels[n.name] == "lower_conv_quant_fast" and fast_igemm(cg.graph, n)
               for n in convs)
    got = sum(f"t{n.inputs[1]}/ohwi_i8" in cg.params for n in convs)
    if got != want:
        raise AssertionError(f"{cg.graph.name}: {got} convs on qconv_fast, the IR gives {want}")
    return got


def with_fast(cg, per_forward) -> dict:
    """per_forward ({kernel: launches a forward}) with cg's qconv_fast
    launches (fast_convs) where it has any; a count per_forward gives must
    be that one."""
    n = fast_convs(cg)
    if per_forward.get("qconv_fast", n) != n:
        raise AssertionError(f"{cg.graph.name}: {n} convs on qconv_fast, expected "
                             f"{per_forward['qconv_fast']}")
    return dict(per_forward, qconv_fast=n) if n else dict(per_forward)


def derived_launches(cg, gate):
    """The kernel launches a forward of cg makes, derived from its IR as the
    routes' gates read it: on the integer-storage tier a group-1 1x1 conv
    goes to qconv1x1 and a k x k one with C_in % 128 == 0 to qconv_direct;
    with the dw gate on (TT_DW_PALLAS=1, batch >= 32) a 3x3 or 5x5
    depthwise conv with C % 32 == 0 to dw_qconv. Counted over the convs
    that took the kernels' lowerings, which must be all of those; with
    pallas_qgemm on that tier, every FC goes to qgemm_requant. An INT8
    input with a zero point (a shifted grid: a TFLite full-int8 import's)
    keeps a group-1 conv and an FC off those kernels. A conv left on the
    fast lowering goes to qconv_fast where fast_igemm holds (fast_convs)."""
    def shifted(n):
        t = cg.graph.tensors[n.inputs[0]]
        return (t.dtype.name == "INT8" and t.quant is not None and not t.quant.per_channel
                and int(np.asarray(t.quant.zero_points).reshape(-1)[0]) != 0)

    got = dict.fromkeys(("qconv1x1", "qconv_direct", "qgemm_requant", "dw_qconv"), 0)
    want = dict(got)
    for n in cg.graph.nodes:
        if n.op == "FullyConnected":
            want["qgemm_requant"] += (cg.options.pallas_qgemm and not cg.options.quant_bf16_storage
                                      and not shifted(n))
            got["qgemm_requant"] += cg.kernels[n.name] == "lower_fc_quant_pallas"
        if n.op != "Convolution":
            continue
        p, route = n.params, cg.kernels[n.name]
        c_in = int(cg.graph.tensors[n.inputs[1]].shape[1])
        k = p["kernel_h"]
        if p["group"] == 1 and not cg.options.quant_bf16_storage and not shifted(n):
            name = "qconv1x1" if k == 1 else "qconv_direct" if c_in % 128 == 0 else None
        elif p["group"] > 1 and c_in == 1 and gate == "1" and k in (3, 5) and p["group"] % 32 == 0:
            name = "dw_qconv"
        else:
            name = None
        if name:
            want[name] += 1
        if route == "lower_conv_quant_pallas_direct":
            got["qconv1x1" if k == 1 else "qconv_direct"] += 1
        elif route == "lower_conv_quant_pallas_dw":
            got["dw_qconv"] += 1
    if got != want:
        raise AssertionError(f"{cg.graph.name}: convs on the kernels' routes {got}, the IR gives {want}")
    return with_fast(cg, {name: n for name, n in got.items() if n})


def run_quant_tier(torch, tt, qmath, counters, what, qg, fp32_outs, images, opts, gate,
                   per_forward, batch, folds, profile, out_dtype=None, outs_sink=None):
    """One tier of a UINT8 net (phases 3g and 3h), checked right after it
    runs so that its CUDA graph can go before the next: compiled with opts
    (TT_DW_PALLAS = gate while it compiles), the convs on the kernels'
    routes derived from the IR and equal to per_forward; driven as drive
    does (captured = eager at 0 LSB), the wrapper launches exact; every
    kernel launch of one eager forward against its plain version
    (check_path_kernels); each output's dequantized cosine against the fp32
    engine > 0.99; the first images at batch 1 equal to their rows in the
    batch; the card against the port's CPU run with the same Options on
    image 0, within 1 LSB. fold_shuffle_gathers must fold `folds` shuffles
    and leave none. out_dtype: the outputs' dtype (uint8 by default);
    outs_sink: a list the captured outputs are appended to. Returns the
    launches by kernel and the captured and eager ms per batch (medians)."""
    from tengine_tpu_torch.graph.passes import fold_shuffle_gathers

    t1 = time.time()
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(images[:batch], t_in.quant, t_in.dtype)
    x = torch.from_numpy(xq).cuda()
    with dw_gate(gate):
        cg = tt.compile_graph(qg, tt.Options(**opts))
    derived, per_forward = derived_launches(cg, gate), with_fast(cg, per_forward)
    if derived != per_forward:
        raise AssertionError(f"{what}: the IR gives {derived}, expected {per_forward}")
    folded = fold_shuffle_gathers(qg.clone())
    left = sum(n.op == "ShuffleChannel" for n in cg.graph.nodes)
    if folded != folds or left:
        raise AssertionError(f"{what}: {folded} shuffles folded, {left} left; expected {folds}")
    outs, batch_ms, launches, eager_ms = drive(torch, cg, x, counters, what, profile)
    want = dict.fromkeys(counters, 0) | {name: WRAPPER_RUNS * n for name, n in per_forward.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    if per_forward:
        check_path_kernels(torch, cg, x, what, per_forward)
    heads = [cg.graph.tensors[t] for t in cg.output_ids]
    check_heads(torch, what, heads, outs, [f[:batch] for f in fp32_outs], 0.99,
                out_dtype or torch.uint8)
    if outs_sink is not None:
        outs_sink.append(outs)
    for i in range(min(batch, 8) if batch > 1 else 0):
        one = cg(x[i : i + 1])
        if not all(torch.equal(a, b[i : i + 1]) for a, b in zip(one, outs)):
            raise AssertionError(f"{what}: image {i} at batch 1 differs from its rows in the batch")
    with dw_gate(gate):
        cg_cpu = tt.compile_graph(qg, tt.Options(**opts), device="cpu")
    if cg_cpu.kernels != cg.kernels:
        raise AssertionError(f"{what}: the CPU compile took other routes")
    check_within_lsb(f"{what} card vs CPU (image 0)", [o[:1] for o in outs],
                     cg_cpu.run(xq[:1]), heads)
    log(f"phase 3 main path: {what} Options({opts}) TT_DW_PALLAS={gate}: kernels a forward "
        f"{per_forward}, shuffles folded {folded}; rows at batch 1 = in the batch "
        f"({min(batch, 8) if batch > 1 else 0} images), card = CPU [{time.time() - t1:.1f} s]")
    del cg
    return launches, float(np.median(batch_ms)), float(np.median(eager_ms))


def run_face_pipeline(torch, tt, qmath, counters, ir, profile):
    """Phase 3g: RetinaFace mnet0.25 320x240 and MobileFaceNet-112, UINT8
    MinMax from one seeded image each (calibrated on the card), under
    FACE_TIERS (run_quant_tier); prints the face pipeline's detect ms,
    embed ms and frames/s = 1000 / (detect + embed) under FACE-S and
    FACE-T, captured and eager. Returns the launches by kernel summed over
    the tiers' main-path runs, the two quantized graphs by net (phase 3l
    serves them) and the captured frames/s by tier."""
    t0 = time.time()
    nets = {"retinaface": build_retinaface_mnet_graph(ir),
            "mobilefacenet": build_mobilefacenet_graph(ir)}
    big = max(b for _, _, per in FACE_TIERS.values() for _, b in per.values())
    total = dict.fromkeys(counters, 0)
    quantized, fp32, images = {}, {}, {}
    for net, g in nets.items():
        shape = g.tensors[g.input_tensors[0]].shape[1:]
        images[net] = np.random.default_rng(0).standard_normal((big, *shape)).astype(np.float32)
        quantized[net] = tt.quantize_graph(g, [images[net][:1]], scheme="uint8", algorithm="minmax")
        fp32[net] = eager(torch, tt.compile_graph(g, tt.Options(precision="fp32", batch_size=big)),
                          torch.from_numpy(images[net]).cuda())
    log(f"  face set-up (build graphs, calibrate, fp32 references): {time.time() - t0:.1f} s")
    fps = {}
    for tier, (extra, gate, per_net) in FACE_TIERS.items():
        ms = {}
        for net, (per_forward, batch) in per_net.items():
            opts = dict(quant_mode="fast", batch_size=batch, **extra)
            launches, *ms[net] = run_quant_tier(
                torch, tt, qmath, counters, f"{net} uint8 b{batch} tier {tier}", quantized[net],
                fp32[net], images[net], opts, gate, per_forward, batch, 0, profile)
            for name, n in launches.items():
                total[name] += n
        if len(ms) == 2:
            (dc, de), (ec, ee) = ms["retinaface"], ms["mobilefacenet"]
            fps[tier] = 1e3 / (dc + ec)
            log(f"phase 3 face pipeline {tier}: detect (retinaface b1) {dc:.3f} ms, embed "
                f"(mobilefacenet b8) {ec:.3f} ms, {1e3 / (dc + ec):.1f} frames/s captured; eager "
                f"{de:.3f} + {ee:.3f} ms, {1e3 / (de + ee):.1f} frames/s")
    return total, quantized, fps


def check_nodes_against_cpu(torch, tt, qg, opts, cg, xq, what):
    """The card held to the CPU node by node: the CPU compile of qg under
    the same Options (the same routes required) runs its forward step by
    step on xq, and each step of cg's forward runs on the card on that
    step's CPU inputs (its params the card's); every integer output within
    1 LSB on at most 0.1% of its elements. The card's fp32 products and
    sums run in another order than the CPU's, so a requant tie can part by
    1 LSB; fed the CPU's inputs, a parting does not carry forward. Returns
    the CPU's outputs, the largest LSB gap and the share of equal elements
    over every compared element."""
    from tengine_tpu_torch.executor.engine import bind_inputs
    from tengine_tpu_torch.ops.layout import TArr, as_semantic

    cg_cpu = tt.compile_graph(qg, tt.Options(**opts), device="cpu")
    if cg_cpu.kernels != cg.kernels:
        raise AssertionError(f"{what}: the CPU compile took other routes")
    env = bind_inputs(cg_cpu.graph, cg_cpu.options, [torch.from_numpy(xq)])
    worst, equal, total, nodes = 0, 0, 0, 0
    with torch.inference_mode():
        for s_cpu, s_dev in zip(cg_cpu.forward_fn.plan, cg.forward_fn.plan, strict=True):
            if s_cpu.node.name != s_dev.node.name:
                raise AssertionError(f"{what}: {s_cpu.node.name} against {s_dev.node.name}")
            outs = s_cpu.apply(s_cpu.args(env))
            on_card = {tid: TArr(env[tid].x.to(cg.device), env[tid].layout)
                       for tid in s_dev.node.inputs if tid in env}
            outs_dev = s_dev.apply(s_dev.args(on_card))
            for tid, o, d in zip(s_cpu.node.outputs, outs, outs_dev, strict=True):
                env[tid] = o
                if o.x.is_floating_point():
                    continue
                gap = (as_semantic(d).cpu().int() - as_semantic(o).int()).abs()
                share = float((gap > 0).double().mean())
                if int(gap.max()) > 1 or share > 1e-3:
                    raise AssertionError(f"{what} node {s_dev.node.name}: card {int(gap.max())} "
                                         f"LSB from the CPU on {share:.5f} of its elements")
                worst, nodes = max(worst, int(gap.max())), nodes + 1
                equal, total = equal + int((gap == 0).sum()), total + gap.numel()
    log(f"  {what}: card vs CPU node by node ({nodes} nodes, each fed the CPU's inputs): "
        f"largest gap {worst} LSB, equal share {equal / total:.6f}")
    outs = tuple(as_semantic(env[tid]).contiguous() for tid in cg_cpu.output_ids)
    return outs, worst, equal / total


def run_transformer_tiers(torch, tt, qmath, counters, profile):
    """Phase 3i: ViT (DeiT-Ti-224, depth 12) and SegFormer-512 (150
    classes) INT8 under TRANSFORMER_TIERS, calibrated on the card from one
    seeded image; each tier compiled with its Options, its kernels'
    launches derived from the IR and equal to the table's, driven as drive
    does (captured = eager at 0 LSB), the wrapper launches exact; every
    kernel launch of one eager forward against its plain version; the
    dequantized output's cosine against the fp32 engine above the tier's
    gate; the card held to the port's CPU run node by node
    (check_nodes_against_cpu) and the free-running output's dequantized
    cosine against the CPU's at least 0.999. Prints each tier's ms per
    forward, launches and (with profile) idle share, and SegFormer's class
    map at stride 4. Returns the launches by kernel summed over the tiers'
    main-path runs."""
    from tengine_tpu_torch.models.transformer_zoo import (
        build_segformer_graph, build_vit_graph, segformer_classmap,
    )

    t0 = time.time()
    builders = {"vit": (build_vit_graph, VIT_CONFIG), "segformer": (build_segformer_graph,
                                                                    SEG_CONFIG)}
    nets = {}
    for net, (build, config) in builders.items():
        torch.manual_seed(0)
        _, g = build(**config)
        img = config["img"]
        x = np.random.default_rng(0).standard_normal((1, 3, img, img)).astype(np.float32)
        qg = tt.quantize_graph(g, [x], scheme="int8", algorithm="minmax")
        t_in = qg.tensors[qg.input_tensors[0]]
        xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
        fp32 = eager(torch, tt.compile_graph(g, tt.Options(precision="fp32")),
                     torch.from_numpy(x).cuda())[0]
        nets[net] = (qg, xq, fp32)
    log(f"  transformer set-up (build graphs, calibrate, fp32 references): "
        f"{time.time() - t0:.1f} s")
    total = dict.fromkeys(counters, 0)
    for tier, (net, extra, per_forward, gate) in TRANSFORMER_TIERS.items():
        t1 = time.time()
        qg, xq, fp32 = nets[net]
        opts = dict(quant_mode="fast", **extra)
        what = f"{net} int8 b1 tier {tier}"
        cg = tt.compile_graph(qg, tt.Options(**opts))
        derived, per_forward = derived_launches(cg, None), with_fast(cg, per_forward)
        if derived != per_forward:
            raise AssertionError(f"{what}: the IR gives {derived}, expected {per_forward}")
        x = torch.from_numpy(xq).cuda()
        outs, batch_ms, launches, eager_ms = drive(torch, cg, x, counters, what, profile)
        want = dict.fromkeys(counters, 0) | {
            name: WRAPPER_RUNS * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, expected {want}")
        for name, n in launches.items():
            total[name] += n
        if per_forward:
            check_path_kernels(torch, cg, x, what, per_forward)
        out = cg.graph.tensors[cg.output_ids[0]]
        check_heads(torch, what, [out], outs, [fp32], gate, torch.int8)
        cpu_outs, worst, equal = check_nodes_against_cpu(torch, tt, qg, opts, cg, xq, what)
        a = dequant(torch, outs[0].cpu(), out).double().ravel()
        b = dequant(torch, cpu_outs[0], out).double().ravel()
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        gap = (outs[0].cpu().int() - cpu_outs[0].int()).abs()
        log(f"  {what}: free-running output card vs CPU: cosine {cos:.6f}, largest gap "
            f"{int(gap.max())} LSB, equal share {float((gap == 0).double().mean()):.6f}")
        if not cos >= 0.999:
            raise AssertionError(f"{what}: card vs CPU cosine {cos:.6f} < 0.999")
        if net == "segformer":
            classes = segformer_classmap(outs[0].cpu().numpy())
            ref = segformer_classmap(fp32.cpu().numpy())
            counts = np.bincount(classes.ravel(), minlength=SEG_CONFIG["num_classes"])
            top = np.argsort(-counts, kind="stable")[:5]
            log(f"  {what}: class map {classes.shape} at stride 4, {int((counts > 0).sum())} "
                f"classes, top 5 (class: pixels) {dict(zip(top.tolist(), counts[top].tolist()))}, "
                f"{float((classes == ref).mean()):.4f} of the pixels the fp32 engine's class")
        log(f"phase 3 main path: {what} Options({opts}): captured {np.median(batch_ms):.3f} ms, "
            f"eager {np.median(eager_ms):.3f} ms a forward; kernels a forward {per_forward} "
            f"[{time.time() - t1:.1f} s]")
        del cg
    return total


def run_extra_tiers(torch, tt, qmath, counters, profile):
    """Phase 3j: CRNN INT8 and U-Net-512 UINT8 and INT8 (models/extra.py) under
    EXTRA_TIERS, calibrated on the card; each tier compiled with its
    Options, its kernels' launches derived from the IR and equal to the
    table's, driven as drive does (captured = eager at 0 LSB), the wrapper
    launches exact; every kernel launch of one eager forward equal to its
    plain version at 0 LSB; the dequantized output's cosine against the
    fp32 engine above the gate; the card held to the port's CPU run node by
    node (check_nodes_against_cpu; U-Net at UNET_CHECK_IMG with the same
    widths, its own calibration). Prints CRNN's CTC string beside the fp32
    engine's and U-Net's mask agreement with fp32. Returns the launches by
    kernel summed over the tiers' main-path runs."""
    from tengine_tpu_torch.models.extra import (
        build_crnn_graph, build_unet_graph, ctc_greedy_decode,
    )
    from tengine_tpu_torch.quantize.dfq import equalize_graph

    t0 = time.time()
    rng = np.random.default_rng(0)
    g, _ = build_crnn_graph(**CRNN_CONFIG)
    xc = rng.standard_normal((EQ_IMAGES, 1, CRNN_CONFIG["img_h"], CRNN_CONFIG["img_w"])).astype(
        np.float32)
    fp32_c = eager(torch, tt.compile_graph(g, tt.Options(precision="fp32")),
                   torch.from_numpy(xc[:1]).cuda())[0]
    ge = g.clone()
    pairs = equalize_graph(ge)
    nets = {
        "crnn": (tt.quantize_graph(g, [xc[:1]], scheme="int8", algorithm="minmax"), xc[:1],
                 fp32_c, None),
        "crnn-eq": (tt.quantize_graph(ge, [xc[i : i + 1] for i in range(EQ_IMAGES)],
                                      scheme="int8", algorithm="eq"), xc[:1], fp32_c, None),
    }
    unet = {}
    for img in (UNET_CONFIG["img"], UNET_CHECK_IMG):
        _, gu = build_unet_graph(**dict(UNET_CONFIG, img=img))
        xu = rng.standard_normal((1, 3, img, img)).astype(np.float32)
        unet[img] = {scheme: tt.quantize_graph(gu, [xu], scheme=scheme, algorithm="minmax")
                     for scheme in ("uint8", "int8")}, xu, gu
    qu, xu, gu = unet[UNET_CONFIG["img"]]
    fp32_u = eager(torch, tt.compile_graph(gu, tt.Options(precision="fp32")),
                   torch.from_numpy(xu).cuda())[0]
    qs, xs, _ = unet[UNET_CHECK_IMG]
    for net, scheme in (("unet", "uint8"), ("unet-i8", "int8")):
        nets[net] = (qu[scheme], xu, fp32_u, (qs[scheme], xs))
    check_no_saturated_bias(qu["int8"], "unet-512 int8")
    deconv_scales = {n.name: qu["int8"].tensors[n.inputs[1]].quant.scales.shape
                     for n in qu["int8"].nodes if n.op == "Deconvolution"}
    log(f"  unet-512 int8: per-channel weight scales of the {len(deconv_scales)} deconvs by "
        f"output channel {sorted(set(deconv_scales.values()))}")
    log(f"  crnn / unet set-up (build graphs, DFQ over {pairs} conv pairs, MinMax and EQ "
        f"calibration, fp32 references): {time.time() - t0:.1f} s")
    total = dict.fromkeys(counters, 0)
    for tier, (net, extra, per_forward, gate) in EXTRA_TIERS.items():
        t1 = time.time()
        qg, x, fp32, small = nets[net]
        opts = dict(quant_mode="fast", **extra)
        what = f"{net.split('-')[0]} {'uint8' if net == 'unet' else 'int8'} b1 tier {tier}"
        cg = tt.compile_graph(qg, tt.Options(**opts))
        derived, per_forward = derived_launches(cg, None), with_fast(cg, per_forward)
        if derived != per_forward:
            raise AssertionError(f"{what}: the IR gives {derived}, expected {per_forward}")
        t_in = qg.tensors[qg.input_tensors[0]]
        xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
        xd = torch.from_numpy(xq).cuda()
        outs, batch_ms, launches, eager_ms = drive(torch, cg, xd, counters, what, profile)
        want = dict.fromkeys(counters, 0) | {
            name: WRAPPER_RUNS * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, expected {want}")
        for name, n in launches.items():
            total[name] += n
        if per_forward:
            seen = check_path_kernels(torch, cg, xd, what, per_forward)
            if any(err for _, err in seen.values()):
                raise AssertionError(f"{what}: a kernel launch differs from its plain version {seen}")
        out = cg.graph.tensors[cg.output_ids[0]]
        check_heads(torch, what, [out], outs, [fp32], gate,
                    torch.uint8 if net == "unet" else torch.int8)
        if small is None:
            check_nodes_against_cpu(torch, tt, qg, opts, cg, xq, what)
        else:
            qs, xs = small
            t_s = qs.tensors[qs.input_tensors[0]]
            xqs = qmath.quantize_np(xs, t_s.quant, t_s.dtype)
            cgs = tt.compile_graph(qs, tt.Options(**opts))
            check_nodes_against_cpu(torch, tt, qs, opts, cgs, xqs, f"{what} at {UNET_CHECK_IMG}")
            del cgs
        deq = dequant(torch, outs[0], out).cpu().numpy()
        if net.startswith("unet"):
            agree = float((deq.argmax(1) == fp32.cpu().numpy().argmax(1)).mean())
            log(f"  {what}: mask {deq.shape[2:]}, {agree:.4f} of the pixels the fp32 engine's class")
        else:
            log(f"  {what}: CTC string {ctc_greedy_decode(deq)!r}, the fp32 engine's "
                f"{ctc_greedy_decode(fp32.cpu().numpy())!r}")
        log(f"phase 3 main path: {what} Options({opts}): captured {np.median(batch_ms):.3f} ms, "
            f"eager {np.median(eager_ms):.3f} ms a forward; kernels a forward {per_forward} "
            f"[{time.time() - t1:.1f} s]")
        del cg
    return total


def tensors_by_name(torch, cg, x) -> dict:
    """Every tensor of one eager forward of cg on x, by name."""
    from tengine_tpu_torch.executor.engine import build_forward

    fwd, _, _ = build_forward(cg.graph, cg.options, cg.forward_fn.store, return_all=True,
                              plan=cg.forward_fn.plan)
    with torch.inference_mode():
        env = fwd(cg.params, x)
    return {cg.graph.tensors[t].name: v for t, v in env.items()}


def run_s2d_tier(torch, tt, counters, qg5, x5, outs5, profile):
    """Phase 3j: yolov5s-640 INT8 b8 (phase 3a's graph) under S2D_OPTS: the
    stem rewritten as SpaceToDepth + a 3x3 s1 conv over 12 channels on the
    fast lowering, which runs it on qconv_fast with the other 80 convs (no
    stem kernel launched); driven as drive does; the heads
    within 1 LSB of phase 3a's; at batch 1, every tensor both graphs hold
    within 1 LSB of the default tier's, on at most 0.1% of its elements.
    Returns the outputs and the tier's kept graph."""
    t1 = time.time()
    batch = x5.shape[0]
    what = f"yolov5s-{x5.shape[-1]} int8 b{batch} tier S2D"
    cg = tt.compile_graph(qg5, tt.Options(batch_size=batch, **S2D_OPTS))
    (stem,) = [n for n in cg.graph.nodes if n.op == "Convolution" and n.inputs[0] in [
        m.outputs[0] for m in cg.graph.nodes if m.op == "SpaceToDepth"]]
    p = stem.params
    if ((p["kernel_h"], p["stride_h"], p["input_channel"]) != (3, 1, 12)
            or cg.kernels[stem.name] != "lower_conv_quant_fast"):
        raise AssertionError(f"{what}: stem {p['kernel_h']}x{p['kernel_w']} s{p['stride_h']} "
                             f"C_in {p['input_channel']} on {cg.kernels[stem.name]}")
    per_forward = with_fast(cg, {"qconv_fast": YOLOV5S_LAUNCHES["qconv_fast"] + 1})
    outs, batch_ms, launches, eager_ms = drive(torch, cg, x5, counters, what, profile)
    want = dict.fromkeys(counters, 0) | {k: WRAPPER_RUNS * n for k, n in per_forward.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    check_path_kernels(torch, cg, x5, what, per_forward)
    heads = [cg.graph.tensors[t] for t in cg.output_ids]
    check_within_lsb(f"{what} vs the default tier", outs, outs5, heads)
    one = {}
    for name, opts in (("default", dict(quant_mode="fast")), ("s2d", S2D_OPTS)):
        one[name] = tensors_by_name(torch, tt.compile_graph(qg5, tt.Options(batch_size=1, **opts)),
                                    x5[:1])
    worst, compared = 0, 0
    for name, a in one["s2d"].items():
        b = one["default"].get(name)
        if b is None or a.is_floating_point() or a.shape != b.shape:
            continue
        gap = (a.int() - b.int()).abs()
        share = float((gap > 0).double().mean())
        if int(gap.max()) > 1 or share > 1e-3:
            raise AssertionError(f"{what} node {name}: {int(gap.max())} LSB from the default "
                                 f"tier on {share:.5f} of its elements")
        worst, compared = max(worst, int(gap.max())), compared + 1
    log(f"  {what}: vs the default tier at batch 1, {compared} tensors: largest gap {worst} LSB")
    log(f"phase 3 main path: {what} Options({S2D_OPTS}): captured {np.median(batch_ms):.3f} ms, "
        f"eager {np.median(eager_ms):.3f} ms a batch; stem {stem.name} on the fast lowering, "
        f"kernels a forward {per_forward} [{time.time() - t1:.1f} s]")
    kept = keep(cg)
    del cg
    return outs, kept


def extra_op_cases(ir):
    """The 19 lowerings of ops/lowering_extra.py, each as a small one-node
    graph of seeded constants and its seeded inputs: (name, graph, inputs,
    exact). exact: data movement, selection and max, which the card must
    compute bit for bit as the CPU does; the rest hold to rtol 1e-5 (exp,
    sigmoid and tanh, and the products' order, round apart in the last
    bits)."""
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    rois = np.array([[0, 0, 3, 3], [2, 1, 7, 6], [1.5, 2.5, 4.4, 8.6], [-3, -2, 20, 15],
                     [5, 5, 4, 4], [1e10, -1e10, 3e9, 2.0]], np.float32)
    anchors = np.concatenate([rng.uniform(0.2, 0.8, (40, 2)), rng.uniform(0.1, 0.3, (40, 2))],
                             1).astype(np.float32)
    H = 16
    cases = [  # op, params, inputs, consts, exact
        ("LSTM", dict(hidden_size=H), [normal(24, 2, 32)],
         [normal(4 * H, 32, scale=0.2), normal(4 * H, H, scale=0.2), normal(8 * H)], False),
        ("RNN", dict(hidden_size=H), [normal(24, 2, 32)],
         [normal(H, 32, scale=0.2), normal(H, H, scale=0.2), normal(2 * H)], False),
        ("GRU", dict(hidden_size=H), [normal(24, 2, 32)],
         [normal(3 * H, 32, scale=0.2), normal(3 * H, H, scale=0.2), normal(6 * H)], False),
        ("ROIPooling", dict(pooled_h=2, pooled_w=3, spatial_scale=1.0),
         [normal(1, 16, 8, 10), rois], [], True),
        ("Roialign", dict(pooled_height=2, pooled_width=3, spatial_scale=0.5),
         [normal(1, 16, 8, 10), rois[:5] * 2.3], [], False),
        ("Psroipooling", dict(pooled_h=2, pooled_w=3, spatial_scale=1.0, output_dim=2),
         [normal(1, 12, 8, 10), rois], [], False),
        ("RPN", dict(feat_stride=16, basesize=16, min_size=16, per_nms_topn=RPN_SMOKE_TOPN,
                     post_nms_topn=50, nms_thresh=0.7, ratios=[0.5, 1.0, 2.0],
                     anchor_scales=[2.0, 4.0, 8.0], anchors=[]),
         [normal(1, 18, 6, 6), normal(1, 36, 6, 6, scale=0.3),
          np.array([[96.0, 80.0, 1.0]], np.float32)], [], False),
        ("SpaceToBatchND", dict(dilation_x=2, dilation_y=2, pad_top=1, pad_bottom=0,
                                pad_left=0, pad_right=1), [normal(1, 6, 7, 9)], [], True),
        ("BatchToSpaceND", dict(dilation_x=2, dilation_y=2, crop_top=1, crop_bottom=0,
                                crop_left=0, crop_right=1), [normal(4, 6, 3, 5)], [], True),
        ("L2Pool", dict(padding_type=0, kernel_h=3, kernel_w=3, stride_h=2, stride_w=2),
         [normal(2, 6, 7, 9)], [], True),
        ("Bias", dict(bias_size=6), [normal(2, 6, 7, 9)], [normal(6)], True),
        ("Embedding", dict(num_output=6, input_dim=10, bias_term=1, weight_data_size=60),
         [np.array([1.0, 5.0, 9.0, -1.0, 3.7, -10.0, 10.0, 12.0], np.float32)],
         [normal(10, 6), normal(6)], True),
        ("Scatter", dict(axis=0, is_onnx=True),
         [normal(5, 4), np.array([[0, -1, 7, 2], [3, 1, -2, -6]], np.float32), normal(2, 4)],
         [], True),
        ("SparseToDense", dict(output_shape_size0=4, output_shape_size1=5, default_value=0),
         [np.array([[0, 0], [3, 4], [-1, 2], [1, 7], [4, 0]], np.float32)],
         [np.array([4, 5], np.int32)], True),
        ("DetectionPostProcess", dict(max_detections=6, max_classes_per_detection=1,
                                      nms_score_threshold=0.3, nms_iou_threshold=0.5,
                                      num_classes=3, scales=[10.0, 10.0, 5.0, 5.0]),
         [normal(1, 40, 4, scale=0.5), rng.uniform(0, 1, (1, 40, 3)).astype(np.float32),
          anchors], [], False),
        ("SpatialTransformer", dict(target_shape=[5, 7]),
         [normal(2, 3, 6, 8), np.array([1, 0, 0, 0, 1, 0], np.float32) + normal(2, 6,
                                                                                 scale=0.2)],
         [], False),
        ("FusedBNScaleReLu", {}, [normal(2, 6, 7, 9)], [normal(6), normal(6)], False),
        ("Accuracy", {}, [normal(2, 6, 7, 9)], [], True),
        ("Generic", dict(max_input_num=1, max_output_num=1, op_name="MyOp"), [normal(1, 4)], [],
         True),
    ]
    out = []
    for op, params, inputs, consts, exact in cases:
        g = ir.Graph(name=op)
        data = g.add_tensor("in0", ir.DType.FP32, list(inputs[0].shape), ir.TensorType.INPUT)
        nodes = [g.add_node("InputOp", "input0", [], [data.idx]).idx]
        ins = [data.idx]
        if op == "SparseToDense":  # indices, the shape const, then the values input
            consts, extra = consts, [normal(5)]
        else:
            extra = inputs[1:]
        for i, c in enumerate(consts):
            dt = ir.DType.INT32 if c.dtype == np.int32 else ir.DType.FP32
            ins.append(g.add_tensor(f"c{i}", dt, list(c.shape), ir.TensorType.CONST, data=c).idx)
        for i, a in enumerate(extra):
            t = g.add_tensor(f"in{i + 1}", ir.DType.FP32, list(a.shape), ir.TensorType.INPUT)
            nodes.append(g.add_node("InputOp", f"input{i + 1}", [], [t.idx]).idx)
            ins.append(t.idx)
        y = g.add_tensor("out", ir.DType.FP32, [], ir.TensorType.VAR)
        g.add_node(op, op.lower(), ins, [y.idx], params)
        g.inputs, g.outputs = nodes, [g.nodes[-1].idx]
        out.append((op, g, [inputs[0]] + list(extra), exact))
    return out


def check_extra_lowerings(torch, tt, ir) -> None:
    """Phase 3j: each of the 19 lowerings of ops/lowering_extra.py compiled
    on its one-node graph (extra_op_cases) and run captured on the card
    (CompiledGraph.__call__: a capture fails on a host read or upload, or
    on a data-dependent shape), held to the port's CPU run: bit for bit
    where exact, else within rtol 1e-5 with a floor of 1e-6 of the largest
    magnitude. Generic must refuse to compile on both, naming
    register_custom_op."""
    worst = {}
    for op, g, inputs, exact in extra_op_cases(ir):
        if op == "Generic":
            for device in (None, "cpu"):
                try:
                    tt.compile_graph(g, tt.Options(), device=device)
                except NotImplementedError as e:
                    if "register_custom_op" not in str(e):
                        raise
                else:
                    raise AssertionError("Generic compiled without a custom kernel")
            continue
        cg = tt.compile_graph(g, tt.Options())
        xs = [torch.from_numpy(a).cuda() for a in inputs]
        got = cg(*xs)[0]  # captured at this first call, then replayed
        again = cg(*xs)[0]  # a second replay of the graph
        want = tt.compile_graph(g, tt.Options(), device="cpu").run(*inputs)[0]
        got, again = got.cpu().numpy(), again.cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got, again, equal_nan=True):
            raise AssertionError(f"{op}: card {got.shape} against CPU {want.shape}, or replays differ")
        if exact:
            ok = np.array_equal(got, want, equal_nan=True)
            dev = 0.0 if ok else float(np.nanmax(np.abs(got - want)))
        else:
            dev = float(np.nanmax(np.abs(got - want)))
            ok = np.allclose(got, want, rtol=1e-5, atol=1e-6 * float(np.nanmax(np.abs(want))),
                             equal_nan=True)
        worst[op] = dev
        if not ok:
            raise AssertionError(f"{op}: card against CPU, largest gap {dev:g}")
    log(f"  lowering_extra: {len(worst)} lowerings captured on the card = the CPU run "
        f"(largest gap: {worst}); Generic refused on both")


def decode_v5_head(out, anchors, stride, conf_th):
    """examples/tm_yolov5.py:decode_v5_head, vectorised: one dequantized
    head [3 * (5 + nc), g, g] -> [N, 6] (x0, y0, x1, y1, score, class), the
    positions whose objectness exceeds conf_th and whose best class score
    reaches it, in the example's order (anchor, row, column)."""
    ch, gh, gw = out.shape
    p = 1 / (1 + np.exp(-out.reshape(3, ch // 3, gh, gw)))
    scores = p[:, 4:5] * p[:, 5:]
    c = scores.argmax(1)
    score = np.take_along_axis(scores, c[:, None], 1)[:, 0]
    a, y, x = np.nonzero((p[:, 4] > conf_th) & (score >= conf_th))
    aw, ah = (np.asarray(anchors, np.float32)[a, i] for i in (0, 1))
    bx = (2 * p[a, 0, y, x] - 0.5 + x) * stride
    by = (2 * p[a, 1, y, x] - 0.5 + y) * stride
    bw = (2 * p[a, 2, y, x]) ** 2 * aw
    bh = (2 * p[a, 3, y, x]) ** 2 * ah
    return np.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2, score[a, y, x],
                     c[a, y, x]], 1).astype(np.float32).reshape(-1, 6)


def check_nms(native, what, boxes, scores, iou):
    """native.nms against the port's numpy NMS on the same boxes: the same
    indices required. Returns the kept count."""
    keep = native.nms(boxes, scores, iou)
    plain = native._nms_np(np.ascontiguousarray(boxes, np.float32),
                           np.ascontiguousarray(scores, np.float32), iou, len(scores))
    if not np.array_equal(keep, plain):
        raise AssertionError(f"{what}: native NMS kept {keep[:10]}, numpy {plain[:10]}")
    return len(keep)


def decode_yolov5(native, qmath, heads, outs):
    """One request's three int8 heads -> its detections after class-aware
    NMS (tm_yolo.py:nms's per-class offset), the top SERVER_TOPK scores
    kept before it; native.nms held to the numpy NMS."""
    from tengine_tpu_torch.models.yolov5 import YOLOV5_ANCHORS, YOLOV5_STRIDES

    maps = sorted(((qmath.dequantize_np(o[0].astype(np.float32), t.quant), t)
                   for t, o in zip(heads, outs)), key=lambda m: -m[0].shape[1])
    dets = np.concatenate([decode_v5_head(m, YOLOV5_ANCHORS[i], YOLOV5_STRIDES[i], SERVER_CONF)
                           for i, (m, _) in enumerate(maps)])
    dets = dets[np.argsort(-dets[:, 4], kind="stable")[:SERVER_TOPK]]
    span = float(dets[:, :4].max(initial=0.0)) + 1.0
    n = check_nms(native, "yolov5s request", dets[:, :4] + dets[:, 5:6] * span, dets[:, 4],
                  SERVER_IOU)
    return len(dets), n


def run_server(torch, tt, qmath, native, counters, qg):
    """Phase 3k: qg (phase 3a's yolov5s-640 INT8 graph) behind
    InferenceServer. Each bucket gets one untimed round (its compile, its
    first call's warm-up forward and capture), its stem-kernel launches
    counted; then SERVER_ROUNDS x SERVER_BURSTS requests, each burst
    submitted at once and awaited, are timed. Checks: every request
    answered; fewer batches than requests; buckets 8, 4 and 1 served; the
    stem kernel launched WRAPPER_RUNS times in each bucket, qconv_fast 80
    times that, and no other kernel; every answer equal at 0 LSB to its frame through the bucket-1
    CompiledGraph; each answer decoded, native.nms = the numpy NMS. Prints
    the server's latency percentiles over the timed requests, requests/s
    and each bucket's param bytes of its own. Returns the launches by
    kernel, the timed requests' quantized frames and their answers (phase
    3p serves them again on a mesh)."""
    from tengine_tpu_torch.parallel.serving import InferenceServer

    t0 = time.time()
    t_in = qg.tensors[qg.input_tensors[0]]
    img = t_in.shape[2]
    rng = np.random.default_rng(0)
    n_timed = SERVER_ROUNDS * sum(SERVER_BURSTS)
    frames = [rng.integers(0, 256, (*SERVER_FRAME_SIZES[i % len(SERVER_FRAME_SIZES)], 3),
                           dtype=np.uint8) for i in range(n_timed)]
    xs = []
    for f in frames:
        boxed = native.letterbox(f, img, img)
        x = np.ascontiguousarray((boxed.astype(np.float32) / 255.0).transpose(2, 0, 1)[None])
        xs.append(qmath.quantize_np(x, t_in.quant, t_in.dtype))
    server = InferenceServer(qg, tt.Options(quant_mode="fast"), max_batch=max(SERVER_BUCKETS),
                             max_wait_ms=SERVER_WAIT_MS)
    for c in counters.values():
        c.launches = 0
    served = dict.fromkeys(SERVER_BUCKETS, 0)
    per_bucket = {}
    server.start()
    try:
        for b in sorted(SERVER_BUCKETS, reverse=True):  # one untimed round a bucket
            t1 = time.time()
            before = counters["stem_qconv"].launches
            for f in [server.submit(x) for x in xs[:b]]:
                f.result(timeout=600)
            per_bucket[b] = counters["stem_qconv"].launches - before
            log(f"  server warm-up, bucket {b}: compile, capture and first batch "
                f"{time.time() - t1:.1f} s, stem launches {per_bucket[b]}")
        if sorted(server._compiled) != sorted(SERVER_BUCKETS):
            raise AssertionError(f"server: warm-up compiled buckets {sorted(server._compiled)}")
        runs = {b: cg.run for b, cg in server._compiled.items()}
        for b, cg in server._compiled.items():  # which bucket serves each batch
            cg.run = lambda *a, b=b: served.__setitem__(b, served[b] + 1) or runs[b](*a)
        server._latencies.clear()  # latency_stats over the timed requests only
        stats0 = dict(server.stats)
        answers, i = [], 0
        t1 = time.perf_counter()
        for _ in range(SERVER_ROUNDS):
            for burst in SERVER_BURSTS:
                futures = [server.submit(x) for x in xs[i:i + burst]]
                answers += [f.result(timeout=600) for f in futures]
                i += burst
        wall = time.perf_counter() - t1
        latency = server.latency_stats()
        stats = {k: server.stats[k] - stats0[k] for k in stats0}
    finally:
        server.stop()
    launches = {name: c.launches for name, c in counters.items()}
    want = dict.fromkeys(counters, 0) | {
        k: WRAPPER_RUNS * len(SERVER_BUCKETS) * n for k, n in YOLOV5S_LAUNCHES.items()}
    if launches != want or any(n != WRAPPER_RUNS for n in per_bucket.values()):
        raise AssertionError(f"server: launches {launches} ({per_bucket} by bucket), "
                             f"expected {want}")
    if (len(answers) != n_timed or stats["requests"] != n_timed
            or not stats["batches"] < stats["requests"]):
        raise AssertionError(f"server: {len(answers)} answers, stats {stats}")
    if not all(served[b] for b in (8, 4, 1)):
        raise AssertionError(f"server: batches by bucket {served}")
    heads = [qg.tensors[t] for t in qg.output_tensors]
    found = kept = 0
    for x, answer in zip(xs, answers):
        for a, b in zip(answer, runs[1](x), strict=True):
            if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError("server: an answer differs from its frame at batch 1")
        n_dets, n_kept = decode_yolov5(native, qmath, heads, answer)
        found, kept = found + n_dets, kept + n_kept
    seen, own = set(), {}
    for b, cg in server._compiled.items():  # compile order: 8, 4, 2, 1
        tensors = {t.data_ptr(): t.numel() * t.element_size() for t in cg.params.values()}
        own[b] = sum(n for ptr, n in tensors.items() if ptr not in seen)
        seen |= set(tensors)
    log(f"phase 3 main path: yolov5s-{img} int8 served by InferenceServer(max_batch="
        f"{max(SERVER_BUCKETS)}, max_wait_ms={SERVER_WAIT_MS}): {n_timed} timed requests in "
        f"{stats['batches']} batches (padded rows {stats['padded']}), batches by bucket "
        f"{served}, {n_timed / wall:.1f} requests/s over {wall * 1e3:.1f} ms; latency_stats "
        f"{json.dumps(latency)}; stem launches by bucket {per_bucket}; param bytes of its own "
        f"by bucket (compile order) {own}; every answer = batch 1 at 0 LSB; decoded "
        f"{found} boxes (top {SERVER_TOPK} a request), {kept} after NMS, native = numpy NMS "
        f"[{gpu_name_and_power_limit()}] [{time.time() - t0:.1f} s]")
    return launches, xs, answers


def find_faces(qmath, heads, outs, det_hw):
    """tm_face_pipeline.py:decode_retinaface on the port's RetinaFace
    heads: each cls-prob head (stride 32, 16, 8; channels [anchors:] the
    face class) gives a box of 4 strides at each position whose face
    probability exceeds FACE_SCORE, level by level in row order, at most
    MAX_FACES; none gives the example's centred box. Boxes in the
    detector's input pixels."""
    boxes = []
    for i, stride in zip((0, 3, 6), (32, 16, 8)):
        prob = qmath.dequantize_np(outs[i][0].astype(np.float32), heads[i].quant)
        face = prob[RETINAFACE_ANCHORS:].max(0)
        for y, x in zip(*np.nonzero(face > FACE_SCORE)):
            boxes.append((x * stride, y * stride, (x + 4) * stride, (y + 4) * stride,
                          float(face[y, x])))
    dh, dw = det_hw
    return boxes[:MAX_FACES] or [(dw // 4, dh // 4, 3 * dw // 4, 3 * dh // 4, 1.0)]


def run_face_pipeline_threads(torch, tt, qmath, native, counters, graphs, face_fps):
    """Phase 3l: phase 3g's two UINT8 graphs under FACE-T (RetinaFace b1,
    MobileFaceNet b8) as a Pipeline: source -> pre -> detect -> crop ->
    embed, each stage on its own thread. The two CompiledGraphs are new:
    their first calls capture inside the stage threads, beside each other.
    Then the same four stages called in turn on the main thread, timed,
    and the pipeline once more, timed. Every frame's embeddings in both
    pipeline runs equal the sequential ones at 0 LSB; qconv1x1's launches
    are those of the two captures. Returns the launches by kernel."""
    from tengine_tpu_torch.utils.pipeline import Pipeline

    t0 = time.time()
    det_g, emb_g = graphs["retinaface"], graphs["mobilefacenet"]
    extra = FACE_TIERS["FACE-T"][0]
    det = tt.compile_graph(det_g, tt.Options(quant_mode="fast", batch_size=1, **extra))
    emb = tt.compile_graph(emb_g, tt.Options(quant_mode="fast", batch_size=MAX_FACES, **extra))
    det_in, emb_in = (g.tensors[g.input_tensors[0]] for g in (det_g, emb_g))
    det_hw, emb_hw = tuple(det_in.shape[2:]), tuple(emb_in.shape[2:])
    det_heads = [det.graph.tensors[t] for t in det.output_ids]
    quant = {n: (float(np.asarray(t.quant.scales).ravel()[0]),
                 int(np.asarray(t.quant.zero_points).ravel()[0])) for n, t in
             (("det", det_in), ("emb", emb_in))}
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (*FACE_FRAME_HW, 3), dtype=np.uint8) for _ in range(FACE_FRAMES)]
    mean, scale = [FACE_MEAN] * 3, [FACE_SCALE] * 3

    def pre(item):
        i, frame = item
        return i, frame, native.preprocess_batch([frame], *det_hw, mean, scale,
                                                 quant=quant["det"], n_threads=1)

    def detect(item):
        i, frame, x = item
        return i, frame, det.run(x)

    def crop(item):
        i, frame, outs = item
        sy, sx = frame.shape[0] / det_hw[0], frame.shape[1] / det_hw[1]
        crops = []
        for x0, y0, x1, y1, _ in find_faces(qmath, det_heads, outs, det_hw):
            fx0, fy0, fx1, fy1 = int(x0 * sx), int(y0 * sy), int(x1 * sx), int(y1 * sy)
            c = frame[max(fy0, 0):max(fy1, 1), max(fx0, 0):max(fx1, 1)]
            if c.size:
                crops.append(native.letterbox(c, *emb_hw))
        batch = np.full((MAX_FACES, 3, *emb_hw), quant["emb"][1], np.uint8)
        if crops:
            batch[:len(crops)] = native.preprocess_batch(crops, *emb_hw, mean, scale,
                                                         quant=quant["emb"], n_threads=1)
        return i, batch, len(crops)

    def embed(item):
        i, batch, n = item
        return i, [o[:n] for o in emb.run(batch)]

    stages = (pre, detect, crop, embed)

    def pipelined():
        p = Pipeline()
        edge = p.source(enumerate(frames))
        for fn in stages:
            edge = p.node(fn, edge, name=fn.__name__)
        t1 = time.perf_counter()
        out = p.run_to_list(edge, timeout=600)
        return sorted(out, key=lambda r: r[0]), time.perf_counter() - t1

    for c in counters.values():
        c.launches = 0
    first, _ = pipelined()  # the captures run in the detect and embed threads
    launches = {name: c.launches for name, c in counters.items()}
    per_forward = {net: FACE_TIERS["FACE-T"][2][net][0]["qconv1x1"]
                   for net in ("retinaface", "mobilefacenet")}
    want = dict.fromkeys(counters, 0) | {"qconv1x1": WRAPPER_RUNS * sum(per_forward.values())}
    if launches != want or len(det._graphs) != 1 or len(emb._graphs) != 1:
        raise AssertionError(f"face pipeline: launches {launches}, expected {want}")
    t1 = time.perf_counter()
    sequential = []
    for item in enumerate(frames):
        for fn in stages:
            item = fn(item)
        sequential.append(item)
    seq_s = time.perf_counter() - t1
    second, pipe_s = pipelined()
    faces = 0
    for run in (first, second):
        if len(run) != FACE_FRAMES:
            raise AssertionError(f"face pipeline: {len(run)} frames out of {FACE_FRAMES}")
        for (i, got), (j, want_e) in zip(run, sequential):
            if i != j or any(a.shape != b.shape or not np.array_equal(a, b)
                             for a, b in zip(got, want_e, strict=True)):
                raise AssertionError(f"face pipeline: frame {j}'s embeddings differ from the "
                                     "sequential run")
    faces = sum(len(e[0]) for _, e in sequential)
    log(f"phase 3 face pipeline on Pipeline (FACE-T, {FACE_FRAMES} frames "
        f"{FACE_FRAME_HW[0]}x{FACE_FRAME_HW[1]}, {faces} faces embedded): pipelined "
        f"{FACE_FRAMES / pipe_s:.1f} frames/s, the four stages in turn on one thread "
        f"{FACE_FRAMES / seq_s:.1f} frames/s, phase 3g's FACE-T detect + embed "
        f"{face_fps['FACE-T']:.1f} frames/s; both pipeline runs = sequential at 0 LSB; "
        f"qconv1x1 launches {launches['qconv1x1']} (the two captures, in the stage "
        f"threads) [{gpu_name_and_power_limit()}] [{time.time() - t0:.1f} s]")
    return launches


def check_no_saturated_bias(g, what):
    """No int32 bias of quantized graph g sits at +-(2^31 - 1): where a bias
    would not fit, the port's quantizer raises the weight scale
    (quantize/quantizer.py:fit_bias) where the JAX quantizer saturates it
    (ROADMAP §3). Returns the number of int32 biases read."""
    biases = [t for t in g.tensors if t.data is not None and t.dtype.name == "INT32"
              and t.quant is not None and t.quant.width == 32]
    at = [t.name for t in biases if (np.abs(t.data.astype(np.int64)) >= INT32_MAX).any()]
    if at:
        raise AssertionError(f"{what}: int32 biases at +-(2^31 - 1): {at[:5]}")
    return len(biases)


def check_chain_kernels(torch, cg, x, what, chains):
    """Every qblock_chain launch of one eager forward of cg held against
    its plain version on the same inputs (at most 1 LSB, 0 expected); the
    launches checked must be `chains`. Like check_path_kernels, these come
    after the counts were read."""
    import tengine_tpu_torch.ops.fused as fused
    from tengine_tpu_torch.ops.cuda.qblock import qblock_chain_plain

    original, seen = fused.qblock_chain, []

    def checked(x_, block_args, blocks, relaxed=False, tile=None):
        out = original(x_, block_args, blocks, relaxed=relaxed, tile=tile)
        seen.append(max_lsb(torch, out, qblock_chain_plain(x_, block_args, blocks,
                                                           relaxed=relaxed),
                            f"{what} qblock_chain {tuple(out.shape)}"))
        return out

    fused.qblock_chain = checked
    try:
        eager(torch, cg, x)
    finally:
        fused.qblock_chain = original
    if len(seen) != chains:
        raise AssertionError(f"{what}: {len(seen)} chain launches checked, expected {chains}")


def zoo_decode(name, mod, g, outs, img_hw):
    """The net's host decode on its dequantized outputs: (detections for
    NMS [N, >= 5] or None, a summary)."""
    h, w = img_hw
    if name in ("fastpose", "hrnet"):
        kps, scores = mod.decode_pose_heatmaps(outs[0])
        return None, f"keypoints {kps.shape}"
    if name == "nanodet":
        return mod.decode_nanodet(outs, score_threshold=0.35), ""
    if name == "ultraface":
        priors = mod.ultraface_priors(h, w)
        dets = mod.decode_ultraface(*mod.flatten_ultraface(outs), priors, score_threshold=0.7)
        px = dets.copy()
        px[:, :4] *= np.asarray([w, h, w, h], np.float32)
        return px, ""
    if name == "yolact":
        coeffs = np.random.default_rng(1).standard_normal((5, outs[0].shape[1])).astype(np.float32)
        return None, f"masks {mod.assemble_yolact_masks(outs[0][0], coeffs).shape}"
    if name == "yolox":
        return mod.decode_yolox(outs, score_threshold=0.3), ""
    if name == "scrfd":
        boxes, kps = mod.decode_scrfd(outs, h, score_threshold=0.5)
        return boxes, f"keypoints {kps.shape}"
    if name == "movenet":
        kps, scores = mod.decode_movenet(*outs, img=h)
        return None, f"keypoints {kps.shape}"
    if name == "nanodet-plus":
        return mod.decode_nanodet_plus(outs[0].reshape(1, -1, 80 + 32), h,
                                       score_threshold=0.35), ""
    if name == "picodet":
        return mod.decode_picodet(outs, h, score_threshold=0.35), ""
    if name == "yolov4-tiny":
        params = [n.params for n in g.nodes if n.op == "Dropout" and "classes" in n.params]
        return mod.decode_darknet_yolo(outs, params, h, 0.25), ""
    return None, "no host decoder"


def run_zoo(torch, tt, qmath, native, counters, profile):
    """Phase 3m: each net of ZOO_NETS at batch 1, its builder's default
    size: quantized on the card from one seeded image, compiled under
    default Options, driven as drive does (captured = eager at 0 LSB; under
    default Options the INT8 nets' convs that fast_igemm admits run on
    qconv_fast and no other conv meets a kernel's gate, and quant_relaxed's
    chain pass gives the nets with bottlenecks of c_mid >= 256
    FusedResBlockChain nodes: their qblock_chain and qconv_fast launches
    exact, each held to its plain version); no int32 bias at +-(2^31 - 1)
    (check_no_saturated_bias: the seeded YOLOX's and UltraFace's heads
    raise their weight scales instead, ROADMAP §3); every head's
    dequantized cosine against the fp32 engine above the net's gate; the
    heads within 1 LSB of the port's CPU run; the
    host decoder on the dequantized heads, native.nms = the numpy NMS where
    the example calls NMS. Returns the launches by kernel summed over the
    nets' main-path runs."""
    import importlib

    t0 = time.time()
    rows = []
    total = dict.fromkeys(counters, 0)
    for name, (module, builder, scheme, gate, iou) in ZOO_NETS.items():
        t1 = time.time()
        mod = importlib.import_module(f"tengine_tpu_torch.models.{module}")
        torch.manual_seed(0)
        built = getattr(mod, builder)()
        g = built[1] if isinstance(built, tuple) else built
        shape = g.tensors[g.input_tensors[0]].shape
        x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
        qg = tt.quantize_graph(g, [x], scheme=scheme, algorithm="minmax")
        biases = check_no_saturated_bias(qg, name)
        t_in = qg.tensors[qg.input_tensors[0]]
        xq = qmath.quantize_np(x, t_in.quant, t_in.dtype)
        fouts = eager(torch, tt.compile_graph(g, tt.Options(precision="fp32")),
                      torch.from_numpy(x).cuda())
        cg = tt.compile_graph(qg, tt.Options())
        x_dev = torch.from_numpy(xq).cuda()
        outs, batch_ms, launches, _ = drive(torch, cg, x_dev, counters, f"{name} {scheme} b1",
                                            profile=False)
        chains = sum(n.op == "FusedResBlockChain" for n in cg.graph.nodes)
        per_forward = derived_launches(cg, None) | ({"qblock_chain": chains} if chains else {})
        want = dict.fromkeys(counters, 0) | {k: WRAPPER_RUNS * n for k, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")
        if chains:
            check_chain_kernels(torch, cg, x_dev, name, chains)
        path = {k: n for k, n in per_forward.items() if k != "qblock_chain"}
        if path:
            check_path_kernels(torch, cg, x_dev, name, path)
        for k, n in launches.items():
            total[k] += n
        heads = [qg.tensors[t] for t in qg.output_tensors]
        cosines = []
        for t, q, f in zip(heads, outs, fouts, strict=True):
            a = qmath.dequantize_np(q.cpu().numpy().astype(np.float32), t.quant).ravel()
            b = f.double().cpu().numpy().ravel()
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
            cosines.append(round(cos, 5))
            if not cos > gate:
                raise AssertionError(f"{name} head {t.name}: cosine {cos:.5f} <= {gate}")
        couts = tt.compile_graph(qg, tt.Options(), device="cpu").run(xq)
        check_within_lsb(f"{name} card vs CPU", outs, couts, heads)
        deq = [qmath.dequantize_np(o.cpu().numpy().astype(np.float32), t.quant)
               for t, o in zip(heads, outs)]
        dets, summary = zoo_decode(name, mod, g, deq, shape[2:])
        if dets is not None:
            summary = f"{len(dets)} detections"
            if iou is not None and len(dets):
                summary += f", {check_nms(native, name, dets[:, :4], dets[:, 4], iou)} after NMS"
        ms = float(np.median(batch_ms))
        rows.append((name, ms))
        log(f"phase 3 zoo: {name} {tuple(shape)} {scheme}: captured {ms:.3f} ms/batch, "
            f"{cg.cost_analysis()['launches']} device launches a forward, kernels a forward "
            f"{per_forward or 'none'}, heads' cosine vs fp32 "
            f"{cosines} (gate {gate}; every head; {biases} int32 biases, none at +-(2^31 - 1)), "
            f"card = CPU within 1 LSB, decode: {summary} [{time.time() - t1:.1f} s]")
        del cg
    log(f"phase 3 zoo: captured ms/batch {dict(rows)} [{gpu_name_and_power_limit()}] "
        f"[{time.time() - t0:.1f} s]")
    return total


# --- the C ABI (phase 3o) ---------------------------------------------------

_V, _I, _S = "void_p", "int", "char_p"
# name -> (restype, argtypes) of the C ABI functions called through ctypes,
# as c_api.h declares them (ctypes type names)
CAPI_SIGNATURES = {
    "init_tengine": (_I, []),
    "get_tengine_version": (_S, []),
    "create_graph": (_V, [_V, _S, _S]),
    "destroy_graph": (_I, [_V]),
    "prerun_graph": (_I, [_V]),
    "run_graph": (_I, [_V, _I]),
    "get_graph_input_tensor": (_V, [_V, _I, _I]),
    "get_graph_output_tensor": (_V, [_V, _I, _I]),
    "get_graph_output_node_number": (_I, [_V]),
    "get_graph_node": (_V, [_V, _S]),
    "get_tensor_shape": (_I, [_V, "int*", _I]),
    "set_tensor_shape": (_I, [_V, "int*", _I]),
    "get_tensor_buffer_size": (_I, [_V]),
    "get_tensor_buffer": (_V, [_V]),
    "set_tensor_buffer": (_I, [_V, _V, _I]),
    "set_tensor_quant_param": (_I, [_V, "float*", "int*", _I]),
    "create_context": (_V, [_S, _I]),
    "set_context_device": (_I, [_V, _S, _V, "size_t"]),
    "create_graph_node": (_V, [_V, _S, _S]),
    "create_graph_tensor": (_V, [_V, _S, _I]),
    "set_node_input_tensor": (_I, [_V, _I, _V]),
    "set_node_output_tensor": (_I, [_V, _I, _V, _I]),
    "set_node_attr_int": (_I, [_V, _S, "int*"]),
    "set_graph_input_node": (_I, [_V, "char_p*", _I]),
    "set_graph_output_node": (_I, [_V, "char_p*", _I]),
    "set_custom_kernel": (_I, [_V, _S, _V]),
    "load_tengine_plugin": (_I, [_S, _S, _S]),
    "unload_tengine_plugin": (_I, [_S, _S]),
    "set_default_device": (_I, [_S]),
    "set_graph_layout": (_I, [_V, _I]),
}


def capi_attach(path):
    """A C ABI library (the port's or the JAX package's) loaded into this
    process (attach mode: it shares this interpreter), its functions typed
    by CAPI_SIGNATURES, init_tengine called."""
    import ctypes

    def ctype(name):
        if name.endswith("*"):
            return ctypes.POINTER(ctype(name[:-1]))
        return getattr(ctypes, f"c_{name}")

    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in CAPI_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctype(restype), [ctype(a) for a in argtypes]
    if lib.init_tengine() != 0:
        raise AssertionError(f"init_tengine failed in {path}")
    return lib


def capi_output(lib, g, k=0) -> bytes:
    """Output k of graph g, read through get_tensor_buffer."""
    import ctypes

    t = lib.get_graph_output_tensor(g, k, 0)
    return ctypes.string_at(lib.get_tensor_buffer(t), lib.get_tensor_buffer_size(t))


def capi_build_graph(lib, ctx, nodes, tensors):
    """Build a graph through the C API's construction calls: tensors
    {name: (TENGINE_DT code, shape, TENSOR_TYPE, data or None, (scale, zp)
    or None)}, nodes [(name, op, inputs, outputs, {attr: int})]; the InputOp
    nodes are the graph's inputs, the last node its output. Returns the
    graph handle."""
    import ctypes

    g = lib.create_graph(ctx, None, None)
    if not g:
        raise AssertionError("create_graph(ctx, NULL, NULL) failed")
    handles, types = {}, {}

    def ok(rc, what):
        if rc != 0:
            raise AssertionError(f"{what} returned {rc}")

    for name, (code, shape, ttype, _, quant) in tensors.items():
        handles[name] = t = lib.create_graph_tensor(g, name.encode(), code)
        types[name] = ttype
        if shape:
            ok(lib.set_tensor_shape(t, (ctypes.c_int * len(shape))(*shape), len(shape)),
               f"set_tensor_shape {name}")
        if quant is not None:
            ok(lib.set_tensor_quant_param(t, (ctypes.c_float * 1)(quant[0]),
                                          (ctypes.c_int * 1)(quant[1]), 1), f"quant {name}")
    for name, op, ins, outs, attrs in nodes:
        n = lib.create_graph_node(g, name.encode(), op.encode())
        for i, t in enumerate(ins):
            ok(lib.set_node_input_tensor(n, i, handles[t]), f"{name} input {i}")
        for i, t in enumerate(outs):
            ok(lib.set_node_output_tensor(n, i, handles[t], types[t]), f"{name} output {i}")
        for k, v in attrs.items():
            ok(lib.set_node_attr_int(n, k.encode(), ctypes.byref(ctypes.c_int(v))), f"{name}.{k}")
    for fn, names in ((lib.set_graph_input_node, [n[0] for n in nodes if n[1] == "InputOp"]),
                      (lib.set_graph_output_node, [nodes[-1][0]])):
        ok(fn(g, (ctypes.c_char_p * len(names))(*[n.encode() for n in names]), len(names)),
           "set_graph_input_node / set_graph_output_node")
    for name, (_, _, _, data, _) in tensors.items():
        if data is not None:
            data = np.ascontiguousarray(data)
            ok(lib.set_tensor_buffer(handles[name], data.ctypes.data, data.nbytes),
               f"set_tensor_buffer {name}")
    return g


def build_c_example(shim: Path, out: Path, shared: bool) -> Path:
    """tengine_tpu_torch/native/capi_example.c built with gcc against the C
    ABI library `shim`: the embedding program, or (shared) a library that
    gives example_double_ops(), the y = 2x custom kernel."""
    src = Path(__file__).resolve().parent / "tengine_tpu_torch" / "native" / "capi_example.c"
    cmd = ["gcc", "-O2", "-Wall", *(["-fPIC", "-shared"] if shared else []), str(src),
           str(shim), f"-Wl,-rpath,{shim.parent}", "-o", str(out)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise AssertionError(f"gcc failed on capi_example.c:\n{r.stdout}{r.stderr}")
    return out


def ck_graph_spec(rng, shape=CK_SHAPE):
    """conv 3x3 -> the C custom kernel (a ReLu node named "double", y = 2x)
    -> conv 3x3, fp32, channels kept: capi_build_graph's nodes and tensors,
    weights from rng."""
    n, c, h, w = shape
    conv = dict(kernel_h=3, kernel_w=3, stride_h=1, stride_w=1, dilation_h=1, dilation_w=1,
                pad_h0=1, pad_h1=1, pad_w0=1, pad_w1=1, group=1, input_channel=c,
                output_channel=c, activation=-1)
    tensors = {"x": (0, list(shape), 3, None, None)}
    nodes = [("input", "InputOp", [], ["x"], {})]
    src = "x"
    for i in (1, 2):
        wt = (rng.standard_normal((c, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32)
        bt = (0.1 * rng.standard_normal(c)).astype(np.float32)
        tensors |= {f"w{i}": (0, [c, c, 3, 3], 2, wt, None), f"b{i}": (0, [c], 2, bt, None),
                    f"y{i}": (0, [], 1, None, None)}
        nodes += [(f"w{i}", "Const", [], [f"w{i}"], {}), (f"b{i}", "Const", [], [f"b{i}"], {}),
                  (f"conv{i}", "Convolution", [src, f"w{i}", f"b{i}"], [f"y{i}"], conv)]
        if i == 1:
            tensors["d"] = (0, [], 1, None, None)
            nodes.append(("double", "ReLu", ["y1"], ["d"], {}))
            src = "d"
    return nodes, tensors


def run_ck_graph(lib, ctx, ops, spec, xs):
    """Build the custom-kernel graph through the C API on ctx (None: no
    device request), set the kernel ops on its "double" node, prerun once
    and run it on each input in turn. Returns the graph and the outputs."""
    g = capi_build_graph(lib, ctx, *spec)
    if lib.set_custom_kernel(lib.get_graph_node(g, b"double"), b"CUDA", ops) != 0:
        raise AssertionError("set_custom_kernel failed")
    t_in = lib.get_graph_input_tensor(g, 0, 0)
    if lib.prerun_graph(g) != 0:
        raise AssertionError("prerun_graph of the custom-kernel graph failed")
    outs = []
    for x in xs:
        if lib.set_tensor_buffer(t_in, x.ctypes.data, x.nbytes) != 0 or lib.run_graph(g, 1) != 0:
            raise AssertionError("run_graph of the custom-kernel graph failed")
        outs.append(np.frombuffer(capi_output(lib, g), np.float32).copy())
    return g, outs


def run_capi(torch, tt, native, counters, qg5, xq5):
    """Phase 3o: the C ABI on the card. Phase 3a's yolov5s-640 INT8 graph,
    written with the port's TM2 writer to a temporary tmfile, under default
    Options:
      embed   where this python has a shared libpython: capi_example.c,
              built with gcc against the port's C ABI library, starts the
              interpreter (PYTHONPATH: the checkout and this python's
              site-packages) and, with no device request, runs on the card
              CAPI_B1_RUNS images at batch 1 and CAPI_BATCHED_RUNS batches of
              CAPI_BATCH, printing each run_graph call's host ms; every head
              of every run equal at 0 LSB to this process's CompiledGraph of
              the same file on the same input. Without a shared libpython the
              phase says so and runs attach mode alone.
      attach  the same file through ctypes.CDLL of the library in this
              process, the same runs: heads equal to the CompiledGraph's at 0
              LSB, the launch counts (set to 0 before, read after) exactly
              stem_qconv's WRAPPER_RUNS a captured batch size, and every
              stem_qconv launch of one eager forward of the C path's
              CompiledGraph at batch CAPI_BATCH equal to stem_qconv_plain at
              0 LSB (check_path_kernels).
    Then the conv -> C custom kernel -> conv graph (ck_graph_spec), built
    through the construction calls with example_double_ops() from
    capi_example.c built as a library: with no device request on the card,
    captured, run on two inputs; with a "CPU" context on the CPU on the same
    two. Each card output within 1e-4 of the CPU's largest |value| (the two
    devices sum each conv's 288 products in other orders, TF32 off); the
    host node launched WRAPPER_RUNS times (the warm-up forward and the
    capture), its run() called once in the warm-up and once a replay; the
    C path's CompiledGraph holds one captured CUDA graph. Prints run_graph's
    ms beside CompiledGraph.__call__'s captured ms at each batch. Returns
    the launches by kernel."""
    import ctypes
    import site

    from tengine_tpu_torch import capi_bridge
    from tengine_tpu_torch.ops.cuda.host_node import custom_kernel, staging

    t1 = time.time()
    repo = Path(__file__).resolve().parent
    libpython = native.shared_libpython()
    shim = native.build_capi()
    log(f"phase 3o: C ABI {shim.name}; shared libpython: "
        + (str(libpython) if libpython else "none, so a C program cannot start this python: "
           "embed mode cannot run here, attach mode only"))
    batches = {1: [xq5[i : i + 1] for i in range(CAPI_B1_RUNS)],
               CAPI_BATCH: [xq5[:CAPI_BATCH]] * CAPI_BATCHED_RUNS}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tmfile = tmp / "yolov5s-640-int8.tmfile"
        tt.save_tmfile(qg5, str(tmfile))
        images = tmp / "images.bin"
        np.ascontiguousarray(xq5[:CAPI_BATCH]).tofile(images)

        run_ms = {}
        if libpython is not None:
            exe = build_c_example(shim, tmp / "capi_example", shared=False)
            env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(repo), *site.getsitepackages()]))
            torch.cuda.empty_cache()
            t2 = time.time()
            r = subprocess.run(
                [str(exe), str(tmfile), str(images), str(CAPI_B1_RUNS), str(CAPI_BATCH),
                 str(CAPI_BATCHED_RUNS), str(tmp / "heads")],
                capture_output=True, text=True, env=env, timeout=300)
            if r.returncode != 0 or "capi_example ok" not in r.stdout:
                raise AssertionError(f"capi_example exited {r.returncode}:\n{r.stdout}\n"
                                     f"{r.stderr[-4000:]}")
            for b in batches:
                run_ms[b] = [float(line.rsplit(" ", 2)[1]) for line in r.stdout.splitlines()
                             if line.startswith(f"run_graph b{b} #")]
            log(f"  3o embed: {r.stdout.splitlines()[0]}; run_graph host ms {run_ms} "
                f"(the first at each batch: warm-up + capture) [{time.time() - t2:.1f} s]")

        # this process's CompiledGraph of the same file: the reference, and
        # the captured ms at each batch
        cg = tt.compile_graph(tt.load_tmfile(str(tmfile)), tt.Options.from_env())
        ref, captured_ms = {}, {}
        for b, xs in batches.items():
            ref[b] = [cg(torch.from_numpy(x).cuda()) for x in xs]
            x_dev = torch.from_numpy(xs[0]).cuda()
            captured_ms[b] = float(np.median([timed_ms(torch, lambda: cg(x_dev)) for _ in range(3)]))
        del cg

        def check_heads_equal(what, got, want):
            for k, (a, w) in enumerate(zip(got, want, strict=True)):
                a = torch.from_numpy(np.frombuffer(a, w.cpu().numpy().dtype)
                                     .reshape(tuple(w.shape)).copy())
                if not torch.equal(a, w.cpu()):
                    d = int((a.int() - w.cpu().int()).abs().max())
                    raise AssertionError(f"3o {what} head {k}: {d} LSB from the CompiledGraph")

        if libpython is not None:
            for b, xs in batches.items():
                for i in range(len(xs)):
                    heads = [(tmp / f"heads_b{b}_r{i}_{k}.bin").read_bytes()
                             for k in range(len(ref[b][i]))]
                    check_heads_equal(f"embed b{b} run {i}", heads, ref[b][i])

        lib = capi_attach(shim)
        for c in counters.values():
            c.launches = 0
        g = lib.create_graph(None, b"tengine", str(tmfile).encode())
        t_in = lib.get_graph_input_tensor(g, 0, 0)
        n_out = lib.get_graph_output_node_number(g)
        attach_ms = {}
        for b, xs in batches.items():
            dims = (ctypes.c_int * 4)(b, *xs[0].shape[1:])
            if lib.set_tensor_shape(t_in, dims, 4) != 0 or lib.prerun_graph(g) != 0:
                raise AssertionError(f"3o attach: prerun_graph at batch {b} failed")
            attach_ms[b] = []
            for i, x in enumerate(xs):
                x = np.ascontiguousarray(x)
                t2 = time.perf_counter()
                if lib.set_tensor_buffer(t_in, x.ctypes.data, x.nbytes) != 0 or lib.run_graph(g, 1):
                    raise AssertionError(f"3o attach: run {i} at batch {b} failed")
                attach_ms[b].append(round((time.perf_counter() - t2) * 1e3, 3))
                check_heads_equal(f"attach b{b} run {i}", [capi_output(lib, g, k)
                                                           for k in range(n_out)], ref[b][i])
        launches = {name: c.launches for name, c in counters.items()}
        want = dict.fromkeys(counters, 0) | {
            k: WRAPPER_RUNS * len(batches) * n for k, n in YOLOV5S_LAUNCHES.items()}
        if launches != want:
            raise AssertionError(f"3o attach: launches {launches}, expected {want}")
        seen = check_path_kernels(torch, capi_bridge._graphs[g]._compiled,
                                  torch.from_numpy(batches[CAPI_BATCH][0]).cuda(),
                                  f"3o C path b{CAPI_BATCH}", YOLOV5S_LAUNCHES)
        if seen["stem_qconv"][1] != 0:
            raise AssertionError("3o: stem_qconv differs from stem_qconv_plain on the C path")
        lib.destroy_graph(g)
        log(f"  3o attach: run_graph host ms {attach_ms}, heads = the CompiledGraph's at 0 LSB, "
            f"launches {launches}")
        log(f"phase 3o: yolov5s-640 int8 through the C ABI, run_graph host ms "
            f"({'embed' if run_ms else 'attach'}): "
            + ", ".join(f"b{b} {v}" for b, v in (run_ms or attach_ms).items())
            + "; CompiledGraph.__call__ captured ms (CUDA events): "
            + ", ".join(f"b{b} {v:.3f}" for b, v in captured_ms.items())
            + f" [{gpu_name_and_power_limit()}]")

        # a graph built from C with a C custom kernel, captured on the card
        example = ctypes.CDLL(str(build_c_example(shim, tmp / "libcapi_example.so", shared=True)))
        example.example_double_ops.restype = ctypes.c_void_p
        ops = example.example_double_ops()
        rng = np.random.default_rng(7)
        spec = ck_graph_spec(rng)
        xs = [rng.standard_normal(CK_SHAPE).astype(np.float32) for _ in range(2)]
        custom_kernel.launches = 0
        g_card, card = run_ck_graph(lib, None, ops, spec, xs)
        host_launches = custom_kernel.launches
        ctx = lib.create_context(b"cpu", 1)
        if lib.set_context_device(ctx, b"CPU", None, 0) != 0:
            raise AssertionError("set_context_device(ctx, \"CPU\") failed")
        g_cpu, cpu = run_ck_graph(lib, ctx, ops, spec, xs)
        errs = [float(np.abs(a - b).max()) for a, b in zip(card, cpu)]
        scale = max(float(np.abs(b).max()) for b in cpu)
        graph = capi_bridge._graphs[g_card]
        key = next(n.params["_custom_kernel"] for n in graph.ir.nodes if n.name == "double")
        (st,) = staging(key)
        sigs = list(graph._compiled._graphs)
        log(f"  3o custom kernel: conv -> C run() -> conv {CK_SHAPE} fp32 on the card, two "
            f"inputs: max |card - CPU| {errs} of a scale {scale:.4f}; host node launches "
            f"{host_launches}, run() calls {st.node.calls} (1 warm-up + 1 a replay), rc "
            f"{st.node.rc}; the CompiledGraph holds {len(sigs)} captured CUDA graph(s), "
            f"signature {sigs}")
        if (max(errs) > 1e-4 * scale or host_launches != WRAPPER_RUNS or st.node.rc != 0
                or st.node.calls != 1 + len(xs) or len(sigs) != 1
                or np.array_equal(card[0], card[1])):
            raise AssertionError("3o: the custom kernel's host node did not run as it should")
        for h in (g_card, g_cpu):
            lib.destroy_graph(h)
    log(f"phase 3o: the C ABI [{time.time() - t1:.1f} s]")
    return launches


# phase 3p: the mesh (parallel/mesh.py, sharding.py, distributed.py, the
# server's mesh half), run in child processes of this script so that no
# process group outlives the phase in this one; the graphs pass to them as
# tmfile bytes (the port's TM2 writer), phase 3k's frames and answers as
# arrays. (a) one rank on NCCL, mesh (1, 1): tier L's mobilenet-v1-224 UINT8
# b128 through shard_compiled, captured, against the unsharded CompiledGraph
# and tier L's logits; phase 3a's yolov5s-640 INT8 graph behind
# InferenceServer(mesh=global_mesh(tp=1)) under phase 3k's settings, its
# answers against 3k's. (b) two ranks on the one card on gloo, the backend
# named (NCCL takes one rank a card): mobilenet-v1-224 UINT8 b32 under tier
# L's Options at mesh (1, 2) (TP: the pointwise convs' float64 weights and
# the FC sliced, dw_qconv replicated) and (2, 1) (DP: 16 rows a rank on the
# b32 plan), eager, the gathers staged through host memory; phase 3k's
# frames behind the multi-host loop, two hosts of one rank, each submitting
# its own half in bursts of MESH_LOCAL_BATCH, then MESH_IDLE_S with no work
MESH_B_BATCH = 32
MESH_LOCAL_BATCH = 4
MESH_IDLE_S = 1.0
MESH_CHILD_TIMEOUT_S = 180


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(entry: str, world: int, args, tmp: Path, timeout_s: float, what: str) -> None:
    """`entry(argv)` ("module.function" of a module beside this script) in
    `world` processes, argv = [rank, world, port, *args], on a free port;
    each one's output goes to a file in tmp and is printed here after,
    prefixed with `what` and the rank. Fails unless every rank exits 0; at
    the first failure, or after timeout_s, the rest are killed (a rank left
    alone would wait in a collective for its peers)."""
    module, fn = entry.split(".")
    code = (f"import sys; sys.path.insert(0, sys.argv[1]); import {module}; "
            f"sys.exit({module}.{fn}(sys.argv[2:]))")
    port, deadline = free_port(), time.time() + timeout_s
    logs = [tmp / f"log_{what}_{rank}.txt".replace(" ", "_") for rank in range(world)]
    procs = []
    try:
        for rank, path in enumerate(logs):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(Path(__file__).resolve().parent), str(rank),
                     str(world), str(port), *map(str, args)],
                    stdout=out, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, path in enumerate(logs):
        for line in path.read_text().splitlines():
            log(f"  [{what} rank {rank}] {line}")
    rcs = [p.returncode for p in procs]
    if rcs != [0] * world:
        raise AssertionError(f"{what}: the ranks exited {rcs} (negative: killed)")


def run_mesh(torch, tt, counters, default, qg5, server_xs, server_answers) -> dict:
    """Phase 3p: part (a) in one child process, then part (b) in two (see
    MESH_B_BATCH above). A child's non-zero exit, or its timeout, fails the
    phase. Each child's log is printed here, prefixed; the children's
    wrapper launches of the mesh path are returned, by kernel."""
    from tengine_tpu_torch.serializer.tm2.writer import graph_to_tm_bytes

    _, outs_l, _, _, qg_l, xq_l, _ = default["L"]
    launches = dict.fromkeys(counters, 0)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        (tmp / "mobilenet.tmfile").write_bytes(graph_to_tm_bytes(qg_l))
        np.save(tmp / "mobilenet_x.npy", xq_l)
        np.save(tmp / "mobilenet_L.npy", outs_l[0].cpu().numpy())
        (tmp / "yolov5s.tmfile").write_bytes(graph_to_tm_bytes(qg5))
        np.save(tmp / "server_x.npy", np.stack(server_xs))
        np.savez(tmp / "server_answers.npz",
                 *[np.concatenate([a[i] for a in server_answers]) for i in range(len(server_answers[0]))])
        for part, world in (("a", 1), ("b", 2)):
            t0 = time.time()
            run_ranks("chip_smoke.mesh_child", world, (d, part), tmp, MESH_CHILD_TIMEOUT_S,
                      f"3p({part})")
            for rank in range(world):
                res = json.loads((tmp / f"result_{part}{rank}.json").read_text())
                for name, n in res["launches"].items():
                    launches[name] += n
            log(f"phase 3 main path: mesh part ({part}), {world} rank(s), backend "
                f"{'nccl' if part == 'a' else 'gloo'}: [{time.time() - t0:.1f} s]")
    return launches


def mesh_child(argv) -> int:
    """One rank of phase 3p (run_ranks): `rank world port dir part`.
    Initializes the process group (part a: NCCL on the card, the default;
    part b: gloo, named, two hosts of one rank), runs its part, writes its
    launches to dir/result_<part><rank>.json and destroys the group."""
    rank, world, port, tmp, part = int(argv[0]), int(argv[1]), argv[2], Path(argv[3]), argv[4]
    import torch

    import tengine_tpu_torch as tt
    from tengine_tpu_torch.ops.cuda.dw_conv import dw_qconv
    from tengine_tpu_torch.ops.cuda.stem_conv import stem_qconv
    from tengine_tpu_torch.parallel.distributed import init_distributed, shutdown_distributed

    counters = {"dw_qconv": dw_qconv, "stem_qconv": stem_qconv}
    t0 = time.time()
    init_distributed(f"localhost:{port}", world, rank, backend=None if part == "a" else "gloo",
                     ranks_per_host=1)
    try:
        launches = (mesh_part_a if part == "a" else mesh_part_b)(torch, tt, counters, rank, tmp)
    finally:
        shutdown_distributed()
    log(f"part ({part}) rank {rank}: {time.time() - t0:.1f} s in the child [{gpu_name_and_power_limit()}]")
    (tmp / f"result_{part}{rank}.json").write_text(json.dumps({"launches": launches}))
    return 0


def _mesh_inputs(tt, tmp):
    """Phase 3p's graphs and data, as run_mesh wrote them."""
    answers = np.load(tmp / "server_answers.npz")
    return (tt.load_tm_bytes((tmp / "mobilenet.tmfile").read_bytes()),
            np.load(tmp / "mobilenet_x.npy"), np.load(tmp / "mobilenet_L.npy"),
            tt.load_tm_bytes((tmp / "yolov5s.tmfile").read_bytes()),
            np.load(tmp / "server_x.npy"), [answers[k] for k in sorted(answers.files)])


def _tier_l(tt, qg, batch):
    """Tier L's CompiledGraph of qg at `batch`: 13 dw_qconv required."""
    _, _, _, extra, gate, _, per_forward, _ = DEFAULT_TIERS["L"]
    with dw_gate(gate):
        cg = tt.compile_graph(qg, tt.Options(quant_mode="fast", batch_size=batch, **extra))
    n_dw = list(cg.kernels.values()).count("lower_conv_quant_pallas_dw")
    if n_dw != per_forward["dw_qconv"]:
        raise AssertionError(f"mobilenet-v1 tier L at b{batch}: {n_dw} convs on dw_qconv")
    return cg


def _check_answers(what, got, xs_idx, answers) -> None:
    for i, answer in zip(xs_idx, got):
        for h, (a, want) in enumerate(zip(answer, answers, strict=True)):
            if a.shape != (1, *want.shape[1:]) or a.dtype != want.dtype or not np.array_equal(a[0], want[i]):
                raise AssertionError(f"{what}: request {i} head {h} differs from phase 3k's answer")


def mesh_part_a(torch, tt, counters, rank, tmp) -> dict:
    """Phase 3p(a), one rank on NCCL, mesh (1, 1)."""
    from tengine_tpu_torch.parallel.distributed import global_mesh
    from tengine_tpu_torch.parallel.serving import InferenceServer
    from tengine_tpu_torch.parallel.sharding import ShardedGraph, shard_compiled

    qg, xq, want, qg5, xs, answers = _mesh_inputs(tt, tmp)
    mesh = global_mesh(tp=1)
    t0 = time.time()
    cg = _tier_l(tt, qg, DEFAULT_BATCH)
    sharded = shard_compiled(cg, mesh)
    x_dev = torch.from_numpy(xq).cuda()
    what = f"mobilenet-v1-224 uint8 b{DEFAULT_BATCH} tier L"
    outs_u, ms_u, launches_u, _ = drive(torch, cg, x_dev, counters, f"{what} unsharded")
    outs_s, ms_s, launches_s, _ = drive(torch, sharded, x_dev, counters,
                                        f"{what} shard_compiled on mesh (1, 1), nccl")
    per_u, per_s = cg.cost_analysis()["launches"], sharded.cost_analysis()["launches"]
    want_launches = {"dw_qconv": WRAPPER_RUNS * DEFAULT_TIERS["L"][6]["dw_qconv"], "stem_qconv": 0}
    if launches_u != want_launches or launches_s != want_launches or per_u != per_s:
        raise AssertionError(f"{what}: wrapper launches {launches_u} unsharded, {launches_s} "
                             f"sharded; device launches a forward {per_u}, {per_s}")
    if not (torch.equal(outs_s[0], outs_u[0]) and np.array_equal(outs_s[0].cpu().numpy(), want)):
        raise AssertionError(f"{what}: the sharded logits differ from the unsharded ones or tier L's")
    log(f"  {what}: sharded = unsharded = tier L at 0 LSB; captured ms/batch median "
        f"{float(np.median(ms_s)):.3f} sharded, {float(np.median(ms_u)):.3f} unsharded, the same "
        f"launches ({per_s} device launches a forward, wrapper launches {launches_s}) "
        f"[{gpu_name_and_power_limit()}] [{time.time() - t0:.1f} s]")
    launches = dict(launches_s)
    del cg, sharded, outs_u, outs_s

    t0 = time.time()
    server = InferenceServer(qg5, tt.Options(quant_mode="fast"), mesh=mesh,
                             max_batch=max(SERVER_BUCKETS), max_wait_ms=SERVER_WAIT_MS)
    for c in counters.values():
        c.launches = 0
    server.start()
    try:
        for b in sorted(SERVER_BUCKETS, reverse=True):  # one untimed round a bucket
            for f in [server.submit(x) for x in xs[:b]]:
                f.result(timeout=600)
        server._latencies.clear()
        got, i = [], 0
        t1 = time.perf_counter()
        for _ in range(SERVER_ROUNDS):
            for burst in SERVER_BURSTS:
                futures = [server.submit(x) for x in xs[i:i + burst]]
                got += [f.result(timeout=600) for f in futures]
                i += burst
        wall = time.perf_counter() - t1
        latency = server.latency_stats()
    finally:
        server.stop()
    served = {b: type(cg).__name__ for b, cg in server._compiled.items()}
    stem = counters["stem_qconv"].launches
    if (sorted(served) != sorted(SERVER_BUCKETS) or set(served.values()) != {ShardedGraph.__name__}
            or stem != WRAPPER_RUNS * len(SERVER_BUCKETS)):
        raise AssertionError(f"3p(a) server: buckets {served}, stem launches {stem}")
    _check_answers("3p(a) server", got, range(len(got)), answers)
    log(f"  yolov5s-640 int8 behind InferenceServer(mesh=global_mesh(tp=1)), nccl: {len(got)} "
        f"timed requests, every answer = phase 3k's at 0 LSB, {len(got) / wall:.1f} requests/s; "
        f"p50 {latency['p50_ms']:.3f} ms, p99 {latency['p99_ms']:.3f} ms; buckets {served}; stem "
        f"launches {stem} [{gpu_name_and_power_limit()}] [{time.time() - t0:.1f} s]")
    launches["stem_qconv"] += stem
    return launches


def mesh_part_b(torch, tt, counters, rank, tmp) -> dict:
    """Phase 3p(b), one of two ranks on the card, gloo."""
    from tengine_tpu_torch.parallel.distributed import global_mesh

    qg, xq, _, qg5, xs, answers = _mesh_inputs(tt, tmp)
    t0 = time.time()
    cg = _tier_l(tt, qg, MESH_B_BATCH)
    x_dev = torch.from_numpy(xq[:MESH_B_BATCH]).cuda()
    (want,) = eager(torch, cg, x_dev)
    eager_ms = [timed_ms(torch, lambda: eager(torch, cg, x_dev)) for _ in range(3)]
    what = f"mobilenet-v1-224 uint8 b{MESH_B_BATCH} tier L"
    log(f"  {what} unsharded, eager ms/batch {[round(m, 3) for m in eager_ms]} "
        f"[{gpu_name_and_power_limit()}]")
    launches = check_mesh_shapes(torch, cg, x_dev, want, ((1, 2), (2, 1)), counters,
                                 DEFAULT_TIERS["L"][6], what, rank)
    log(f"  {what} on two meshes: {time.time() - t0:.1f} s")
    del cg

    mine = list(range(rank, len(xs), 2))  # this host's own frames
    launches["stem_qconv"] += serve_multihost(
        torch, tt, qg5, global_mesh(tp=1), xs, mine, answers, counters,
        f"yolov5s-640 int8 multi-host loop, host {rank} of 2, tp 1")
    return launches


def check_mesh_shapes(torch, cg, x, want, shapes, counters, per_forward, what, rank) -> dict:
    """cg through shard_compiled at each (data, model) shape of `shapes`
    (phase 3p(b); chip_mesh.py across cards): one call of the sharded
    forward on the global batch x launches each kernel of per_forward its
    count a forward (WRAPPER_RUNS forwards on NCCL, which captures: the
    warm-up and the capture; one on gloo, eager, the gathers staged through
    host memory) and equals `want` at 0 LSB; three timed calls; every kernel
    launch of one eager forward of this rank's rows held to its plain
    version. Returns the launches of the first calls, by kernel."""
    import torch.distributed as dist

    from tengine_tpu_torch.executor.engine import _meta_env
    from tengine_tpu_torch.parallel.mesh import make_mesh
    from tengine_tpu_torch.parallel.sharding import TP_GATHER, shard_compiled, sharded_nodes

    backend = dist.get_backend()
    runs = WRAPPER_RUNS if backend == "nccl" else 1
    launches = dict.fromkeys(counters, 0)
    for shape in shapes:
        sharded = shard_compiled(cg, make_mesh(shape=shape))
        for c in counters.values():
            c.launches = 0
        (got,) = sharded(x)  # the main path's call on this mesh
        seen = {name: c.launches for name, c in counters.items()}
        expect = {name: runs * per_forward.get(name, 0) for name in counters}
        for name, n in seen.items():
            launches[name] += n
        if seen != expect or not torch.equal(got, want):
            raise AssertionError(f"{what} mesh {shape} rank {rank}: launches {seen}, expected "
                                 f"{expect}; {int((got.int() - want.int()).abs().max())} LSB")
        ms = [timed_ms(torch, lambda: sharded(x)) for _ in range(3)]
        rows = x.shape[0] // shape[0]
        lo = sharded.data_rank * rows
        check_path_kernels(torch, sharded, x[lo:lo + rows], f"{what} mesh {shape} rank {rank}",
                           per_forward)
        env, _ = _meta_env(sharded.graph, sharded.options, sharded.forward_fn.store,
                           sharded.forward_fn.plan)
        gathered = sum(  # the gathers' outputs at the global batch, on this data group
            env[n.outputs[0]].numel() * env[n.outputs[0]].element_size()
            for n in sharded.graph.nodes if n.op == TP_GATHER) // shape[0]
        how = "captured" if runs > 1 else "eager, the gathers staged through host memory"
        log(f"  {what} mesh {shape} rank {rank}, {backend} ({how}): "
            f"{len(sharded_nodes(cg, shape[1]))} nodes on channel slices, sharded = unsharded "
            f"at 0 LSB; ms/batch {[round(m, 3) for m in ms]}; the gathers' outputs {gathered} "
            f"bytes a forward a rank [{gpu_name_and_power_limit()}]")
        del sharded
    return launches


def serve_multihost(torch, tt, qg5, mesh, xs, mine, answers, counters, what) -> int:
    """qg5 behind the multi-host loop on `mesh` (phase 3p(b); chip_mesh.py
    across cards), a local bucket of MESH_LOCAL_BATCH rows: after one
    untimed request, each host's queue holder submits this host's frames
    xs[mine] in bursts of MESH_LOCAL_BATCH, and every answer equals
    `answers` (a list by head, indexed by frame) at 0 LSB; then MESH_IDLE_S
    with no request dispatches no batch and counts idle rounds. stem_qconv
    launches once a batch on gloo (eager), WRAPPER_RUNS times on NCCL (the
    bucket's capture); each launch of one eager forward of the bucket's
    rank-local program is held to its plain version after. Returns the
    loop's stem_qconv launches."""
    import torch.distributed as dist

    from tengine_tpu_torch.parallel.serving import InferenceServer

    t0 = time.time()
    # this function's barriers, on a gloo group of their own beside the
    # loop's collectives (an NCCL barrier here could interleave its kernels
    # with the loop's in another order on each card)
    sync = dist.new_group(backend="gloo")
    server = InferenceServer(qg5, tt.Options(quant_mode="fast"), mesh=mesh,
                             max_batch=MESH_LOCAL_BATCH, max_wait_ms=SERVER_WAIT_MS)
    leads = mesh.get_local_rank(1) == 0  # holds its TP group's queue
    for c in counters.values():
        c.launches = 0
    server.start()
    got = []
    try:
        # the loop compiles the global bucket as it starts, and the first
        # forward sets up the card's libraries
        if leads:
            server.submit(xs[mine[0]]).result(timeout=600)
        dist.barrier(group=sync)
        server._latencies.clear()
        if leads:
            for i in range(0, len(mine), MESH_LOCAL_BATCH):
                futures = [server.submit(xs[j]) for j in mine[i:i + MESH_LOCAL_BATCH]]
                got += [f.result(timeout=600) for f in futures]
        dist.barrier(group=sync)  # every host's work is done
        time.sleep(MESH_IDLE_S / 4)  # the last round's bookkeeping ends on every rank
        batches = server.stats["batches"]
        time.sleep(MESH_IDLE_S)
        stats, latency = dict(server.stats), server.latency_stats()
    finally:
        server.stop()
    stem = counters["stem_qconv"].launches
    want_stem = WRAPPER_RUNS if dist.get_backend() == "nccl" else batches
    if stats["batches"] != batches or not stats.get("idle_rounds") or stem != want_stem:
        raise AssertionError(f"{what}: stats {stats} ({batches} batches before the idle "
                             f"second), stem launches {stem}, expected {want_stem}")
    _check_answers(what, got, mine, answers)
    (cg5,) = server._compiled.values()
    local = np.concatenate([xs[j] for j in mine[:MESH_LOCAL_BATCH]])
    check_path_kernels(torch, cg5, torch.from_numpy(local).to(cg5.device), what,
                       YOLOV5S_LAUNCHES)
    log(f"  {what}, {dist.get_backend()}: {len(got)} own requests, every answer = the "
        f"unsharded one at 0 LSB; stats {stats}; latency {json.dumps(latency)}; stem launches "
        f"{stem}; {MESH_IDLE_S} s idle: no batch, {stats['idle_rounds']} idle rounds "
        f"[{gpu_name_and_power_limit()}] [{time.time() - t0:.1f} s]")
    return stem


# --- the CLIs (phase 3q) ----------------------------------------------------

# phase 3q: the port's example and tool CLIs (tengine_tpu_torch/examples,
# tengine_tpu_torch/tools) in this process on the card, each at its default
# size, quantized with the scheme of the reference's variant of the app (its
# *_uint8 app, or the -q its usage line names; fp32 where there is none):
# the arguments beyond the defaults. The -m examples read tmfiles the phase
# writes ({key}: run_clis's files); tm_classification runs in the host tool
# chain, tm_yolov5 on its own. tm_ultraface at its default 240x320 with -t
# 0.5: faces scored in the stride-32 head's last row decode against the
# priors the port counts by ceil (the JAX example raises IndexError there,
# ROADMAP §3)
ULTRAFACE_SCORES = 17640  # at 240x320: 3·(60·80 + 8·10) + 2·(30·40 + 15·20)
CLI_EXAMPLES = {
    "tm_efficientdet": ["-q", "uint8"],
    "tm_hrnet": ["-q", "uint8"],
    "tm_landmark": ["-q", "uint8"],
    "tm_nanodet_plus": ["-q", "uint8"],
    "tm_openpose": ["-q", "uint8"],
    "tm_picodet": ["-q", "uint8"],
    "tm_yolact": ["-q", "uint8"],
    "tm_yolofastest": ["-q", "uint8"],
    "tm_crnn": [],
    "tm_movenet": ["-q", "int8"],
    "tm_nanodet": ["-q", "uint8"],
    "tm_pose": ["-q", "int8"],
    "tm_scrfd": ["-q", "uint8"],
    "tm_segformer": ["-q", "int8"],
    "tm_ultraface": ["-q", "uint8", "-t", "0.5"],
    "tm_unet": ["-q", "uint8"],
    "tm_vit": ["-q", "int8"],
    "tm_yolov3_full": ["-q", "int8"],
    "tm_yolov4": ["-q", "int8"],
    "tm_yolox": ["-q", "int8"],
    "tm_detection": ["-m", "{ssd_uint8}"],
    "tm_yolo": ["-m", "{yolov4_tiny}"],
    "tm_face_pipeline": ["--detector", "{retinaface}", "--embedder", "{mobilefacenet}"],
}
CLI_BENCH_BATCH = 128
CLI_BENCH_TOLERANCE = 0.10  # the benchmark's ms against the same route's captured tier

# a timing in a CLI's printed line ("12.34 ms", "0.5s"), dropped where two
# runs' lines are compared
PRINTED_TIMING = re.compile(r"[-+]?\d+(?:\.\d+)?\s*(?:ms\b|s\b)")
PRINTED_TOKEN = re.compile(r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?|[A-Za-z_][\w\-]*|\S")
PRINTED_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def printed_lines(text):
    return [PRINTED_TIMING.sub("<time>", line) for line in text.splitlines() if line.strip()]


def _same_token(a, b):
    if a == b:
        return True
    if not (PRINTED_NUMBER.fullmatch(a) and PRINTED_NUMBER.fullmatch(b)):
        return False
    digits = [len(t.split(".")[1]) if "." in t and "e" not in t.lower() else 0 for t in (a, b)]
    return digits[0] == digits[1] and abs(float(a) - float(b)) <= 10.0 ** -digits[0] * (1 + 1e-9)


def same_line(a, b):
    ta, tb = PRINTED_TOKEN.findall(a), PRINTED_TOKEN.findall(b)
    return len(ta) == len(tb) and all(map(_same_token, ta, tb))


def printout_mismatch(want_text, got_text, any_order=False):
    """None when two runs of a CLI printed the same: each timing dropped, the
    same number of lines, the same words, each number within one unit of
    its last printed digit (any_order: each line of want_text matches a line
    of its own in got_text, for detections of equal printed score that NMS
    takes in the order of their float scores). Else what differs."""
    want, got = printed_lines(want_text), printed_lines(got_text)
    if not want or len(want) != len(got):
        return f"{len(want)} lines against {len(got)}"
    if not any_order:
        return next((f"{a!r} against {b!r}" for a, b in zip(want, got) if not same_line(a, b)),
                    None)
    left = list(got)
    for a in want:
        match = next((i for i, b in enumerate(left) if same_line(a, b)), None)
        if match is None:
            return f"{a!r} has no counterpart"
        del left[match]
    return None


def cli_run(torch, counters, module, args, what, **kw):
    """main(args) of tengine_tpu_torch.<module> in this process, what it
    prints captured; every launch count set to 0 just before and read just
    after. Logs the first and last printed lines and the seconds. Returns
    (what main returned, the printed text, launches by kernel)."""
    import importlib
    import io

    mod = importlib.import_module(f"tengine_tpu_torch.{module}")
    for c in counters.values():
        c.launches = 0
    buf, t0 = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = mod.main(list(args), **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    lines = buf.getvalue().strip().splitlines() or [""]
    shown = lines[0] if len(lines) == 1 else f"{lines[0]} | ... | {lines[-1]}"
    log(f"  {what}: {seconds:.2f} s: {shown} (wrapper launches "
        f"{ {k: n for k, n in launches.items() if n} or 'none'})")
    return result, buf.getvalue(), launches


def session_launches(cg):
    """The kernel launches one forward of an example's CompiledGraph makes,
    from its IR (derived_launches, TT_DW_PALLAS unset), its stem-kernel
    nodes and its fused chains."""
    per_forward = derived_launches(cg, None)
    stems = sum(k == "lower_conv_quant_pallas_stem" for k in cg.kernels.values())
    chains = sum(n.op == "FusedResBlockChain" for n in cg.graph.nodes)
    return per_forward | ({"stem_qconv": stems} if stems else {}) | (
        {"qblock_chain": chains} if chains else {})


def check_cli_launches(torch, counters, what, result, launches):
    """An example's launches: WRAPPER_RUNS times what one forward of its
    CompiledGraph launches (its first call warms up and captures; the
    timed calls replay), each launch of one eager forward held against its
    plain version. Returns the launches."""
    cg = result["session"]
    per_forward = session_launches(cg)
    want = dict.fromkeys(counters, 0) | {k: WRAPPER_RUNS * n for k, n in per_forward.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    x = torch.from_numpy(np.ascontiguousarray(result["input"])).cuda()
    path = {k: n for k, n in per_forward.items() if k != "qblock_chain"}
    if path:
        check_path_kernels(torch, cg, x, what, path)
    if "qblock_chain" in per_forward:
        check_chain_kernels(torch, cg, x, what, per_forward["qblock_chain"])
    return launches


def write_cli_models(tt, ir, tmp):
    """The tmfiles of phase 3q, by the port's writer from this script's
    builders at their default sizes: mobilenet-v1-224 fp32, mobilenet-SSD-300
    UINT8 (MinMax on the card from one seeded image, as tm_mobilenet_ssd_uint8
    loads it), RetinaFace 320x240 and MobileFaceNet-112 fp32, and the darknet
    zoo's yolov4-tiny-416 fp32 (tm_yolo decodes yolov3-tiny's two heads,
    13x13 and 26x26 at 416, which yolov4-tiny shares)."""
    from tengine_tpu_torch.models.darknet_zoo import build_yolov4_tiny_graph
    from tengine_tpu_torch.serializer.tm2.writer import save_tmfile

    ssd = build_mobilenet_ssd_graph(ir)
    x = np.random.default_rng(0).standard_normal((1, 3, 300, 300)).astype(np.float32)
    graphs = {
        "mobilenet": build_mobilenet_v1_graph(ir),
        "ssd_uint8": tt.quantize_graph(ssd, [x], scheme="uint8", algorithm="minmax"),
        "retinaface": build_retinaface_mnet_graph(ir),
        "mobilefacenet": build_mobilefacenet_graph(ir),
        "yolov4_tiny": build_yolov4_tiny_graph(img=416),
    }
    files = {}
    for key, g in graphs.items():
        files[key] = str(tmp / f"{key}.tmfile")
        save_tmfile(g, files[key])
    return files


def check_ultraface_cli(res):
    """tm_ultraface -t 0.5 at 240x320: ULTRAFACE_SCORES scores and as many
    priors, faces printed, and the share of them the JAX priors lack (a
    score in their last 30 rows)."""
    from tengine_tpu_torch.models.detect_zoo import flatten_ultraface, ultraface_priors

    scores, _ = flatten_ultraface(res["outs"])
    priors = ultraface_priors(240, 320)
    prob = np.exp(scores[0]) / np.exp(scores[0]).sum(-1, keepdims=True)
    if scores.shape[1] != ULTRAFACE_SCORES or len(priors) != ULTRAFACE_SCORES:
        raise AssertionError(f"tm_ultraface: {scores.shape[1]} scores, {len(priors)} priors")
    if not len(res["dets"]):
        raise AssertionError("tm_ultraface -t 0.5: no face printed")
    log(f"  tm_ultraface -q uint8 -t 0.5 (240x320): {scores.shape[1]} scores and priors, "
        f"{len(res['dets'])} faces after NMS; {int((prob[:, 1] > 0.5).sum())} scores above "
        f"0.5, {int((prob[-30:, 1] > 0.5).sum())} of them in the last 30 rows (past the JAX "
        f"priors' {ULTRAFACE_SCORES - 30})")


def run_clis(torch, tt, qmath, ir, counters, default):
    """Phase 3q: the CLIs on the card, in this process unless said.

    The benchmark: tm_benchmark's `-m mobilenetv1 --uint8 -b 128` with
    TT_DW_PALLAS=1, from a working directory whose benchmark/models holds
    the seeded mobilenet-v1-224 tmfile. The tool compiles under
    Options(quant_mode="fast", batch_size=128), the JAX tool's: that takes
    the native-int8 plan only where _native_profitable, which no depthwise
    graph is, and the dw route wants integer storage, so TT_DW_PALLAS=1
    routes nothing and the tool runs tier K's route (27 convs on the fast
    lowering, no plan, no kernel launch; checked); its average ms within
    10% of tier K's captured ms. Then tm_yolov5 -q int8 (640) as a
    `python -m` subprocess, started beside the in-process runs: what it
    prints = what the in-process run printed (printout_mismatch). In
    process: tm_yolov5 -q int8: one stem_qconv a forward, each launch of
    one eager forward = the plain version, its heads within 1 LSB of the
    port's CPU run of its quantized graph and of the same command with
    --device cpu. The host tool chain: mobilenet-v1-224's fp32 tmfile ->
    quant_tool -t uint8 --evaluate -> tm_classification -m on the card and
    with --device cpu (the same top-5 classes, values within one step of
    the output grid) -> align_tool (fast tier within 1 LSB of the ref
    tier). Every example of CLI_EXAMPLES: its launches derived from its
    CompiledGraph, each held to the plain version (check_cli_launches).
    Returns the launches by kernel summed over the in-process runs."""
    total = dict.fromkeys(counters, 0)

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        t0 = time.time()
        files = write_cli_models(tt, ir, tmp)
        log(f"  3q tmfiles (build, calibrate the SSD, write): {time.time() - t0:.1f} s")

        # the benchmark, on an otherwise idle card
        models = tmp / "bench" / "benchmark" / "models"
        models.mkdir(parents=True)
        (models / "mobilenet_benchmark.tmfile").write_bytes(Path(files["mobilenet"]).read_bytes())
        here = os.getcwd()
        os.chdir(models.parents[1])
        try:
            with dw_gate("1"):
                bench, _, launches = cli_run(
                    torch, counters, "tools.benchmark",
                    ["-m", "mobilenetv1", "--uint8", "-b", str(CLI_BENCH_BATCH)],
                    f"benchmark -m mobilenetv1 --uint8 -b {CLI_BENCH_BATCH} (TT_DW_PALLAS=1)",
                    keep=True)
        finally:
            os.chdir(here)
        if bench["failed"] or any(launches.values()):
            raise AssertionError(f"benchmark: failed {bench['failed']}, launches {launches}")
        (row,) = bench["rows"]
        cg = row["cg"]
        routes = [cg.kernels[n.name] for n in cg.graph.nodes if n.op == "Convolution"]
        if (routes != ["lower_conv_quant_fast"] * 27
                or getattr(cg.graph, "_bf16_tids", None) is not None):
            raise AssertionError(f"benchmark: routes {set(routes)}, plan "
                                 f"{getattr(cg.graph, '_bf16_tids', None) is not None}")
        check_path_kernels(torch, cg, row["x"], "benchmark mobilenetv1 uint8 b128", {})
        k_ms = default["K"][6][0]
        log(f"  benchmark mobilenetv1 uint8 b{CLI_BENCH_BATCH}: min {row['min_ms']:.3f} ms, avg "
            f"{row['avg_ms']:.3f} ms, {row['img_s']:.1f} img/s; tier K (the same route, "
            f"captured) {k_ms:.3f} ms [{gpu_name_and_power_limit()}]")
        if abs(row["avg_ms"] - k_ms) > CLI_BENCH_TOLERANCE * k_ms:
            raise AssertionError(f"benchmark: {row['avg_ms']:.3f} ms against tier K's {k_ms:.3f}")
        del bench, row, cg

        # tm_yolov5 from the command line, beside the in-process runs
        cmd = [sys.executable, "-m", "tengine_tpu_torch.examples.tm_yolov5", "-q", "int8"]
        proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t_proc = time.perf_counter()

        res, text5, launches = cli_run(torch, counters, "examples.tm_yolov5", ["-q", "int8"],
                                       "tm_yolov5 -q int8 (640)")
        if session_launches(res["session"]) != YOLOV5S_LAUNCHES:
            raise AssertionError(f"tm_yolov5: {session_launches(res['session'])}")
        add(check_cli_launches(torch, counters, "tm_yolov5 -q int8", res, launches))
        cg = res["session"]
        x5 = torch.from_numpy(res["input"]).cuda()
        captured = [timed_ms(torch, lambda: cg(x5)) for _ in range(3)]
        log(f"  tm_yolov5 -q int8 (640, b1): printed (host wall, one warm run) {res['ms']:.3f} ms; "
            f"its CompiledGraph captured {captured} ms (median {float(np.median(captured)):.3f}) "
            f"[{gpu_name_and_power_limit()}]")
        heads = [cg.graph.tensors[t] for t in cg.output_ids]
        t1 = time.time()
        own = tt.compile_graph(res["graph"], tt.Options(quant_mode="fast"),
                               device="cpu").run(res["input"])
        check_within_lsb("tm_yolov5 card vs its graph on the CPU", res["raw"], own, heads)
        cpu, text_cpu, _ = cli_run(torch, counters, "examples.tm_yolov5",
                                   ["-q", "int8", "--device", "cpu"], "tm_yolov5 -q int8 --device cpu")
        grids = max(abs(float(np.asarray(a.quant.scales).ravel()[0])
                        / float(np.asarray(b.quant.scales).ravel()[0]) - 1)
                    for a, b in zip(res["graph"].tensors, cpu["graph"].tensors)
                    if a.quant is not None and a.data is None)
        log(f"  tm_yolov5: the card's and the CPU's calibrations, activation scales apart "
            f"by at most {grids:.3g} relative; the CPU run {time.time() - t1:.1f} s")
        check_within_lsb("tm_yolov5 -q int8 card vs --device cpu", res["raw"], cpu["raw"], heads)
        del res, cpu, cg, own, x5

        # the host tool chain
        u8 = str(tmp / "mobilenet_uint8.tmfile")
        quant, _, launches = cli_run(torch, counters, "tools.quant_tool",
                                     ["-m", files["mobilenet"], "-o", u8, "-t", "uint8",
                                      "--evaluate"], "quant_tool -t uint8 --evaluate")
        if any(launches.values()) or min(quant["cosines"].values()) <= 0.99:
            raise AssertionError(f"quant_tool: launches {launches}, least cosine "
                                 f"{min(quant['cosines'].values())}")
        card, _, launches = cli_run(torch, counters, "examples.tm_classification", ["-m", u8],
                                    "tm_classification -m (uint8)")
        add(check_cli_launches(torch, counters, "tm_classification", card, launches))
        host, _, _ = cli_run(torch, counters, "examples.tm_classification",
                             ["-m", u8, "--device", "cpu"], "tm_classification -m (uint8) --device cpu")
        t_out = card["session"].graph.tensors[card["session"].output_ids[0]]
        step = float(np.asarray(t_out.quant.scales).ravel()[0])
        if ([i for _, i in card["top5"]] != [i for _, i in host["top5"]]
                or any(abs(a - b) > step * 1.0001 for (a, _), (b, _) in zip(card["top5"], host["top5"]))):
            raise AssertionError(f"tm_classification: card top-5 {card['top5']}, CPU {host['top5']}")
        align, _, _ = cli_run(torch, counters, "tools.align_tool", ["-m", u8], "align_tool")
        if not align["max_abs"] <= 1:
            raise AssertionError(f"align_tool: fast tier {align['max_abs']} LSB from the ref tier")
        del quant, card, host, align

        # every other example
        for name, args in CLI_EXAMPLES.items():
            args = [a.format(**files) for a in args]
            res, _, launches = cli_run(torch, counters, f"examples.{name}", args,
                                       f"{name} {' '.join(args)}".replace(str(tmp) + "/", ""))
            if "session" in res:
                add(check_cli_launches(torch, counters, name, res, launches))
            elif any(launches.values()):
                raise AssertionError(f"{name}: launches {launches}")
            if name == "tm_ultraface":
                check_ultraface_cli(res)
            del res

        out, err = proc.communicate(timeout=600)
        log(f"  python -m tengine_tpu_torch.examples.tm_yolov5 -q int8: exit {proc.returncode}, "
            f"{time.perf_counter() - t_proc:.1f} s: {out.strip().splitlines()[:1]}")
        if proc.returncode != 0:
            raise AssertionError(f"tm_yolov5 as a command exited {proc.returncode}: {err[-2000:]}")
        differs = printout_mismatch(text5, out)
        if differs:
            raise AssertionError(f"tm_yolov5: the command printed otherwise: {differs}")
    return total


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import tengine_tpu_torch as tt
    from tengine_tpu_torch import native
    from tengine_tpu_torch.models.darknet_zoo import build_yolofastest_graph, build_yolov3_graph
    from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph
    from tengine_tpu_torch.ops import qmath
    from tengine_tpu_torch.ops.cuda import build
    from tengine_tpu_torch.graph import ir
    from tengine_tpu_torch.ops.cuda.dw_conv import dw_qconv
    from tengine_tpu_torch.ops.cuda.qblock import qblock_chain
    from tengine_tpu_torch.ops.cuda.qconv import qconv1x1, qconv_direct, qconv_fast
    from tengine_tpu_torch.ops.cuda.qgemm import qgemm_requant
    from tengine_tpu_torch.ops.cuda.stem_conv import stem_qconv

    t_start = time.time()
    profile = "--profile" in argv
    gpu = gpu_name_and_power_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} [{gpu}]")

    # 1. build: the kernels (one nvcc each) and, beside them, the host library
    t0 = time.time()
    host = threading.Thread(target=native.available)
    host.start()
    build.build_all()
    host.join()
    if not native.available():
        raise AssertionError("the native host library did not build (g++)")
    log(f"phase 1 build: {time.time() - t0:.1f} s ({native.library_path().name} beside the kernels)")

    # 2. kernels against their plain versions
    t0 = time.time()
    entries = {"stem_qconv": check_stem_kernel(torch)}
    check_igemm_grid(torch)
    check_tensor_core_sass(build)
    entries.update(check_igemm_main(torch, sweep="--tiles" in argv))
    entries["dw_qconv"] = check_dw_kernel(torch, sweep="--tiles" in argv)
    entries["qblock_chain"] = check_qblock_kernel(torch, sweep="--tiles" in argv)
    entries.update(check_requant_kernels(torch))
    entries["qconv_fast"] = check_qconv_fast(torch)
    counters = {"stem_qconv": stem_qconv, "qconv_direct": qconv_direct, "qconv1x1": qconv1x1,
                "qgemm_requant": qgemm_requant, "dw_qconv": dw_qconv, "qblock_chain": qblock_chain,
                "qconv_fast": qconv_fast}
    log(f"phase 2 kernels: {time.time() - t0:.1f} s")

    # 3a. main path: yolov5s-640 INT8 at batch 8
    t0 = time.time()
    batch, img = 8, 640
    _, g5 = build_yolov5s_graph(num_classes=80, img=img)
    rng = np.random.default_rng(0)
    images5 = rng.standard_normal((batch, 3, img, img)).astype(np.float32)
    qg5 = tt.quantize_graph(g5, [images5[:1]], scheme="int8", algorithm="minmax")
    check_no_saturated_bias(qg5, f"yolov5s-{img} int8")
    cg5 = tt.compile_graph(qg5, tt.Options(quant_mode="fast", batch_size=batch))
    stems = [n for n, k in cg5.kernels.items() if k == "lower_conv_quant_pallas_stem"]
    if len(stems) != 1:
        raise AssertionError(f"expected one stem-kernel node, got {stems}")
    t_in = qg5.tensors[qg5.input_tensors[0]]
    xq5 = qmath.quantize_np(images5, t_in.quant, t_in.dtype)
    x5 = torch.from_numpy(xq5).cuda()
    log(f"  yolov5s set-up (build graph, calibrate, compile): {time.time() - t0:.1f} s")
    per_forward = with_fast(cg5, YOLOV5S_LAUNCHES)
    outs5, batch_ms, launches, _ = drive(torch, cg5, x5, counters, f"yolov5s-{img} int8 b{batch}",
                                      profile)
    want = dict.fromkeys(counters, 0) | {k: WRAPPER_RUNS * n for k, n in per_forward.items()}
    if launches != want:
        raise AssertionError(f"yolov5s launches {launches}, expected {want}")
    entries["stem_qconv"]["launches"] = launches["stem_qconv"]
    entries["qconv_fast"]["launches"] = launches["qconv_fast"]
    check_path_kernels(torch, cg5, x5, f"yolov5s-{img} int8 b{batch}", per_forward)
    cg5 = keep(cg5)
    log(f"phase 3 main path: yolov5s-{img} int8 batch {batch} [{time.time() - t0:.1f} s]")

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
        with_fast(cg3, per_forward)
        outs3, batch_ms, launches, _ = drive(torch, cg3, x3, counters,
                                          f"yolov3-{img3} int8 b{batch} tier {tier}", profile)
        want = dict.fromkeys(counters, 0) | {
            name: WRAPPER_RUNS * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"yolov3 {tier}: launches {launches}, expected {want}")
        check_path_kernels(torch, cg3, x3, f"yolov3 {tier}", per_forward)
        entries["qconv_fast"]["launches"] += launches["qconv_fast"]
        tiers[tier] = (keep(cg3), outs3, opts)
        del cg3
        log(f"phase 3 main path: yolov3-{img3} int8 batch {batch} tier {tier} {extra} "
            f"[{time.time() - t1:.1f} s]")
    entries["qconv_direct"]["launches"] = WRAPPER_RUNS * YOLOV3_TIERS["A"][1]["qconv_direct"]
    entries["qconv1x1"]["launches"] = WRAPPER_RUNS * YOLOV3_TIERS["A"][1]["qconv1x1"]
    entries["qgemm_requant"]["launches"] = WRAPPER_RUNS * YOLOV3_TIERS["B"][1]["qgemm_requant"]

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
            per_forward = with_fast(cgf, dict(per_forward, qconv_fast=FASTEST_FAST[scheme]))
            outsf, batch_ms, launches, _ = drive(
                torch, cgf, xf, counters, f"yolofastest-{imgf} {scheme} b{FASTEST_BATCH} tier "
                f"{tier}", profile and scheme == "int8")
            want = dict.fromkeys(counters, 0) | {
                name: WRAPPER_RUNS * n for name, n in per_forward.items()}
            if launches != want:
                raise AssertionError(f"yolofastest {scheme} {tier}: launches {launches}, expected {want}")
            entries["qconv_fast"]["launches"] += launches["qconv_fast"]
            fastest[scheme, tier] = (keep(cgf), outsf, qgf, xqf, xf)
            del cgf
            log(f"phase 3 main path: yolofastest-{imgf} {scheme} batch {FASTEST_BATCH} tier {tier} "
                f"(TT_DW_PALLAS={gate}) [{time.time() - t1:.1f} s]")
    entries["dw_qconv"]["launches"] = WRAPPER_RUNS * FASTEST_TIERS["D"][1]["dw_qconv"]
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
            # after a subsample), the FC to qgemm_requant, the other k x k
            # convs to qconv_fast
            ks = [(n.params["kernel_h"], int(cgr.graph.tensors[n.inputs[1]].shape[1])) for n in convs]
            derived = {"qconv_direct": sum(k > 1 and c % 128 == 0 for k, c in ks),
                       "qconv1x1": sum(k == 1 for k, _ in ks), "qgemm_requant": 1,
                       "qconv_fast": sum(k > 1 and c % 128 != 0 for k, c in ks)}
            fc = [cgr.kernels[n.name] for n in cgr.graph.nodes if n.op == "FullyConnected"]
            if derived != per_forward or routed != 49 or fc != ["lower_fc_quant_pallas"]:
                raise AssertionError(f"resnet50 H: the IR gives {derived}, {routed} convs took "
                                     f"the kernel's lowering, FC on {fc}")
        elif routed:
            raise AssertionError(f"resnet50 {tier}: a conv left the fast lowering")
        with_fast(cgr, per_forward)
        outsr, batch_ms, launches, _ = drive(torch, cgr, xr, counters,
                                          f"resnet50-{imgr} int8 b{RESNET_BATCH} tier {tier}",
                                          profile)
        want = dict.fromkeys(counters, 0) | {
            name: WRAPPER_RUNS * n for name, n in per_forward.items()}
        if launches != want:
            raise AssertionError(f"resnet50 {tier}: launches {launches}, expected {want}")
        check_path_kernels(torch, cgr, xr, f"resnet50 {tier}", per_forward)
        entries["qconv_fast"]["launches"] += launches["qconv_fast"]
        resnet[tier] = (keep(cgr), outsr, opts)
        del cgr
        log(f"phase 3 main path: resnet50-{imgr} int8 batch {RESNET_BATCH} tier {tier} {extra} "
            f"[{time.time() - t1:.1f} s]")
    entries["qblock_chain"]["launches"] = WRAPPER_RUNS * RESNET_TIERS["F"][1]["qblock_chain"]
    log(f"  resnet50 in all: {time.time() - t0:.1f} s")

    # 3e. main path: bench.py's configs under default Options at batch 128,
    # ResNet-50-224 INT8 (KL) and UINT8 on the native-int8 plan (I, J), the
    # mobilenet-v1-224 UINT8 headline on the default route (K) and on the
    # plan with its depthwise convs on dw_qconv (L)
    t0 = time.time()
    graphs = {"resnet50": gr, "mobilenet-v1": build_mobilenet_v1_graph(ir, img=imgr)}
    images_d = np.random.default_rng(0).standard_normal(
        (DEFAULT_BATCH, 3, imgr, imgr)).astype(np.float32)
    default = run_default_tiers(torch, tt, qmath, counters, graphs, images_d, profile)
    entries["dw_qconv"]["launches"] += WRAPPER_RUNS * DEFAULT_TIERS["L"][6]["dw_qconv"]
    log(f"  default-Options tiers in all: {time.time() - t0:.1f} s")

    # 3f. main path: mobilenet-SSD-300 UINT8 with the NMS on the card, at
    # batch 8 on the fast lowering (SSD-S) and on qconv1x1 / qconv_direct
    # (SSD-T), at batch 32 with dw_qconv too (SSD-U)
    t0 = time.time()
    gs = build_mobilenet_ssd_graph(ir)
    priors = sum(gs.tensors[n.outputs[0]].shape[2] for n in gs.nodes if n.op == "PriorBox") // 4
    if priors != SSD_NUM_PRIORS:
        raise AssertionError(f"mobilenet-ssd-300: {priors} priors, expected {SSD_NUM_PRIORS}")
    images_s = np.random.default_rng(0).standard_normal(
        (SSD_U_BATCH, 3, 300, 300)).astype(np.float32)
    fp32_ssd = eager(torch, tt.compile_graph(gs, tt.Options(precision="fp32",
                                                            batch_size=SSD_U_BATCH)),
                     torch.from_numpy(images_s).cuda())
    check_rows("mobilenet-ssd fp32 (valid rows)", fp32_ssd[0], fp32_ssd[0])  # >= 10 an image
    ssd_launches = run_ssd_tiers(torch, tt, qmath, counters, gs, fp32_ssd, images_s, profile)
    for name, n in ssd_launches.items():
        if n:
            entries[name]["launches"] += n
    log(f"  mobilenet-ssd tiers in all: {time.time() - t0:.1f} s")

    # 3g. main path: the face pipeline, RetinaFace mnet0.25 UINT8 b1 and
    # MobileFaceNet UINT8 b8 on the fast lowering (FACE-S) and on qconv1x1
    # (FACE-T), MobileFaceNet b32 with dw_qconv too (FACE-U)
    t0 = time.time()
    face_launches, face_graphs, face_fps = run_face_pipeline(torch, tt, qmath, counters, ir,
                                                             profile)
    for name, n in face_launches.items():
        entries[name]["launches"] += n
    log(f"  face tiers in all: {time.time() - t0:.1f} s")

    # 3h. main path: shufflenet-v2 1.0x UINT8 b32, its shuffles folded, its
    # 1x1 convs on qconv1x1 (SHUF-T)
    t0 = time.time()
    gsh = build_shufflenet_v2_graph(ir)
    images_sh = np.random.default_rng(0).standard_normal(
        (SHUF_TIERS["SHUF-T"][3], 3, 224, 224)).astype(np.float32)
    qsh = tt.quantize_graph(gsh, [images_sh[:1]], scheme="uint8", algorithm="minmax")
    fp32_sh = eager(torch, tt.compile_graph(gsh, tt.Options(precision="fp32",
                                                            batch_size=len(images_sh))),
                    torch.from_numpy(images_sh).cuda())
    for tier, (extra, gate, per_forward, batch) in SHUF_TIERS.items():
        launches, _, _ = run_quant_tier(
            torch, tt, qmath, counters, f"shufflenet-v2-224 uint8 b{batch} tier {tier}", qsh,
            fp32_sh, images_sh, dict(quant_mode="fast", batch_size=batch, **extra), gate,
            per_forward, batch, SHUF_FOLDS, profile)
        for name, n in launches.items():
            entries[name]["launches"] += n
    log(f"  shufflenet-v2 in all: {time.time() - t0:.1f} s")

    # 3i. main path: the transformers, ViT (DeiT-Ti-224) and SegFormer-512
    # INT8 at batch 1, on the fast lowerings (VIT-S, SEG-S) and with the
    # head on qgemm_requant (VIT-T) or the decoder and the C_in-128 convs on
    # qconv1x1 / qconv_direct (SEG-T)
    t0 = time.time()
    for name, n in run_transformer_tiers(torch, tt, qmath, counters, profile).items():
        entries[name]["launches"] += n
    log(f"  transformer tiers in all: {time.time() - t0:.1f} s")

    # 3j. main path: CRNN INT8 and U-Net-512 UINT8 at batch 1 on the fast
    # lowerings (CRNN-S, UNET-S), with the C_in-128 convs, U-Net's head and
    # CRNN's FC on qconv_direct / qconv1x1 / qgemm_requant (CRNN-T, UNET-T),
    # CRNN-T after DFQ and EQ (CRNN-E); yolov5s-640 with stem_s2d (S2D); the
    # 19 lowerings of ops/lowering_extra.py captured on the card
    t0 = time.time()
    for name, n in run_extra_tiers(torch, tt, qmath, counters, profile).items():
        entries[name]["launches"] += n
    outs_s2d, cg_s2d = run_s2d_tier(torch, tt, counters, qg5, x5, outs5, profile)
    check_extra_lowerings(torch, tt, ir)
    log(f"  crnn / unet / s2d tiers and the extra lowerings in all: {time.time() - t0:.1f} s")

    # 3k. main path: phase 3a's yolov5s-640 INT8 graph behind the
    # continuous-batching server, buckets 1, 2, 4 and 8
    t0 = time.time()
    launches, server_xs, server_answers = run_server(torch, tt, qmath, native, counters, qg5)
    entries["stem_qconv"]["launches"] += launches["stem_qconv"]
    log(f"  server in all: {time.time() - t0:.1f} s")

    # 3l. main path: the face pipeline (FACE-T) on Pipeline, a thread a stage
    t0 = time.time()
    for name, n in run_face_pipeline_threads(torch, tt, qmath, native, counters, face_graphs,
                                             face_fps).items():
        entries[name]["launches"] += n
    log(f"  face pipeline on threads in all: {time.time() - t0:.1f} s")

    # 3m. the detector zoo under default Options, batch 1
    t0 = time.time()
    for name, n in run_zoo(torch, tt, qmath, native, counters, profile).items():
        entries[name]["launches"] += n
    log(f"  zoo in all: {time.time() - t0:.1f} s")

    # 3n. the six front ends: mobilenet-v1-224 written as ONNX, Caffe, ncnn,
    # MXNet, a frozen TF GraphDef and TFLite, imported through the port's
    # convert tool; fp32 against plain torch, the ONNX import UINT8 and the
    # full-int8 TFLite import on dw_qconv (and qconv1x1)
    t0 = time.time()
    for name, n in run_frontends(torch, tt, qmath, ir, counters, default, profile).items():
        entries[name]["launches"] += n
    log(f"  frontends in all: {time.time() - t0:.1f} s")

    # 3o. main path: phase 3a's graph through the C ABI, from a C program
    # that embeds the port and through ctypes here; a C custom kernel as a
    # host node of the captured forward
    t0 = time.time()
    for name, n in run_capi(torch, tt, native, counters, qg5, xq5).items():
        entries[name]["launches"] += n
    log(f"  C ABI in all: {time.time() - t0:.1f} s")

    # 3p. main path on a mesh, in child processes: one rank on NCCL (tier L's
    # mobilenet-v1 captured through shard_compiled, phase 3k's requests behind
    # InferenceServer(mesh=...)), then two ranks on gloo (TP and DP of
    # mobilenet-v1 b32, phase 3k's frames through the multi-host loop)
    t0 = time.time()
    for name, n in run_mesh(torch, tt, counters, default, qg5, server_xs,
                            server_answers).items():
        entries[name]["launches"] += n
    log(f"  mesh in all: {time.time() - t0:.1f} s")

    # 3q. the example and tool CLIs (tengine_tpu_torch/examples, tools) on the
    # card: tm_benchmark on mobilenet-v1-224 b128, tm_yolov5 -q int8 at 640
    # in-process and as a command, the host tool chain (quant_tool ->
    # tm_classification, align_tool), every other example at its default size
    t0 = time.time()
    for name, n in run_clis(torch, tt, qmath, ir, counters, default).items():
        entries[name]["launches"] += n
    log(f"  CLIs in all: {time.time() - t0:.1f} s")

    # 4. correctness: fp32 engine on the card, and the port's CPU run
    t0 = time.time()
    heads5 = [cg5.graph.tensors[t] for t in cg5.output_ids]
    fouts5 = eager(torch, tt.compile_graph(g5, tt.Options(precision="fp32", batch_size=batch)),
                   torch.from_numpy(images5).cuda())
    check_heads(torch, "yolov5s", heads5, outs5, fouts5, 0.95, torch.int8)
    check_heads(torch, "yolov5s S2D", [cg_s2d.graph.tensors[t] for t in cg_s2d.output_ids],
                outs_s2d, fouts5, 0.95, torch.int8)
    couts5 = tt.compile_graph(qg5, tt.Options(quant_mode="fast", batch_size=1), device="cpu").run(xq5[:1])
    check_within_lsb("yolov5s card vs CPU (image 0)", [o[:1] for o in outs5], couts5, heads5)

    cg3a, outs3a, opts_a = tiers["A"]
    heads3 = [cg3a.graph.tensors[t] for t in cg3a.output_ids]
    fouts3 = eager(torch, tt.compile_graph(g3, tt.Options(precision="fp32", batch_size=batch)),
                   torch.from_numpy(images3).cuda())
    check_heads(torch, "yolov3 A", heads3, outs3a, fouts3, 0.99, torch.int8)
    for tier in ("B", "C"):
        check_tiers_agree(torch, f"yolov3-{img3} {tier} vs A", tiers[tier][1], outs3a, heads3)
    check_debug_tools(tt, *check_tiers_exact_small(torch, tt, build_yolov3_graph, qmath))
    for tier, (_, outs3, opts) in tiers.items():
        t1 = time.time()
        couts3 = tt.compile_graph(qg3, tt.Options(**dict(opts, batch_size=1)), device="cpu").run(xq3[:1])
        log(f"  yolov3-{img3} {tier} on the CPU, image 0: {time.time() - t1:.1f} s")
        check_within_lsb(f"yolov3 {tier} card vs CPU (image 0)", [o[:1] for o in outs3], couts3, heads3)

    foutsf = eager(torch, tt.compile_graph(gf, tt.Options(precision="fp32",
                                                          batch_size=FASTEST_BATCH)),
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
    foutsr = eager(torch, tt.compile_graph(gr, tt.Options(precision="fp32",
                                                          batch_size=RESNET_BATCH)),
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
    fp32 = {net: eager(torch, tt.compile_graph(g, tt.Options(precision="fp32",
                                                             batch_size=DEFAULT_BATCH)),
                       images_dev) for net, g in graphs.items()}
    check_default_tiers(torch, tt, default, fp32, resnet["R"])
    log(f"phase 4 check: {time.time() - t0:.1f} s")

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
    """Device time by kernel over one batch of the captured forward, and the
    card's idle share inside the replay, both from one torch.profiler
    trace: the span is the first device operation's start to the last
    one's end, the busy time the union of the device operations' intervals
    (kernels, copies, fills), the idle share 1 - busy / span. The call's
    time by CUDA events, unprofiled, is printed beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cg(x_dev)
    plain_ms = timed_ms(torch, lambda: cg(x_dev))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cg(x_dev)
        torch.cuda.synchronize()

    def self_device_us(r):  # the attribute's name changed across torch versions
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0)

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -float("inf")
    for lo, hi in spans:  # the union of the intervals
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    span_us = spans[-1][1] - spans[0][0] if spans else 0.0
    # device-side rows only: the aten:: rows repeat the time of their kernels
    dev = [(r.key, self_device_us(r) / 1e3, r.count) for r in prof.key_averages()
           if r.device_type == DeviceType.CUDA and self_device_us(r) > 0]
    total = sum(ms for _, ms, _ in dev)
    log(f"profile: one captured batch, {len(spans)} device operations, kernels "
        f"{total:.3f} ms; on the card (one trace) busy {busy / 1e3:.3f} ms of a span of "
        f"{span_us / 1e3:.3f} ms, device idle {100 * (1 - busy / max(span_us, 1e-9)):.1f}%; "
        f"the call unprofiled (CUDA events) {plain_ms:.3f} ms")
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
