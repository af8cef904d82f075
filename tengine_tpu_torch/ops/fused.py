"""Lowering of the FusedResBlockChain node (graph/passes.py:
fuse_resnet_blocks) — PyTorch port of tengine_tpu/ops/fused.py.

A run of whole quantized bottleneck residual blocks goes to the qblock_chain
kernel (ops/cuda/qblock.py), which keeps every intermediate of a block out of
device memory. What carries over from the JAX lowering is the arithmetic:
the QBlock configs read from the graph's scales, the per-channel weight
scales, the memoized build_block_args fold through the ParamStore, and the
stride-2 head fed the even-subsampled input. What does not is the TPU's
layout and memory plan, none of which changes an output value: the packed
flat activation layout (seg_geometry, pack_activations, unpack_activations),
the image packs and streams (pick_streams) with their batch padding, the
lane padding of c_in to 128, and the splitter that cuts a chain to the TPU's
fast-memory budget. The CUDA kernel takes NHWC int8 of any shape.
"""

from __future__ import annotations

import numpy as np

from .cuda.qblock import (
    QBlock, args_per_block, build_block_args, pack_block_args, qblock_chain,
)
from .layout import TArr, as_nhwc, nhwc
from .registry import SCORE_BEST, LowerCtx, register_op


def _scale_of(t) -> float:
    return float(np.asarray(t.quant.scales).reshape(-1)[0])


def chain_configs(ctx: LowerCtx):
    """The QBlock of every block of the node, from the graph's scales. The
    mid tensors no longer flow after the pass; their quant params are read
    by id."""
    g = ctx.graph
    cfgs = []
    for info in ctx.params["blocks"]:
        cfgs.append(QBlock(
            c_in=info["c_in"], c_mid=info["c_mid"], c_out=info["c_out"],
            act1=info["act1"] if info["act1"] is not None else -1,
            act2=info["act2"] if info["act2"] is not None else -1,
            s1=_scale_of(g.tensors[info["mid1"]]),
            s2=_scale_of(g.tensors[info["mid2"]]),
            s_mid=_scale_of(g.tensors[info["mid3"]]),
            s_r=_scale_of(g.tensors[info["r_tid"]]),
            s_out=_scale_of(g.tensors[info["add_out"]]),
            s_relu=_scale_of(g.tensors[info["out_tid"]]) if info["has_relu"] else None,
            proj=info["proj"],
        ))
    return cfgs


@register_op("FusedResBlockChain", score=SCORE_BEST, quant=True)
def lower_resblock_chain(ctx: LowerCtx, x: TArr, *rest):
    """Whole residual-block chains on the qblock_chain kernel. The exact
    tier reproduces the unfused quantized node chain's numerics; with
    Options.quant_relaxed each block rounds once, at its output scale."""
    g = ctx.graph
    infos = ctx.params["blocks"]
    cfgs = chain_configs(ctx)
    relaxed = ctx.options.quant_relaxed

    def wscales(pos):
        t = g.tensors[ctx.node.inputs[pos]]
        s = np.asarray(t.quant.scales, np.float32).reshape(-1)
        if s.size == 1:
            s = np.full((int(t.shape[0]),), s[0], np.float32)
        return s

    # host-side packing, memoized so the 9-12 param-store entries per block
    # share one build_block_args call at prepare time
    memo = {}
    all_args = []
    sp = _scale_of(ctx.in_tensor(0))
    for i, (info, cfg) in enumerate(zip(infos, cfgs)):
        def compute_args(i=i, info=info, cfg=cfg, sp=sp):
            if i not in memo:
                def cd(key):
                    pos = info.get(key)
                    return None if pos is None else ctx.const_data(pos)

                memo[i] = pack_block_args(build_block_args(
                    cfg,
                    ctx.const_data(info["w1_pos"]), cd("b1_pos"),
                    ctx.const_data(info["w2_pos"]), cd("b2_pos"),
                    ctx.const_data(info["w3_pos"]), cd("b3_pos"),
                    sp,
                    wscales(info["w1_pos"]), wscales(info["w2_pos"]),
                    wscales(info["w3_pos"]),
                    w4=cd("w4_pos"), b4_q=cd("b4_pos"),
                    sw4=wscales(info["w4_pos"]) if info["proj"] else None,
                    relaxed=relaxed,
                ))
            return memo[i]

        for j in range(args_per_block(cfg)):
            all_args.append(ctx.get_param(f"qblk{i}a{j}", lambda j=j, f=compute_args: f()[j]))
        sp = cfg.s_relu if cfg.s_relu is not None else cfg.s_out

    xn = as_nhwc(x)
    if infos[0]["stride"] == 2:
        # Caffe-resnet downsample: stride-2 1x1 convs (conv1 + projection)
        # consume only the even-subsampled input
        xn = xn[:, ::2, ::2, :]
    # every activation the pass matches is INT8, the kernel's output dtype
    return nhwc(qblock_chain(xn.contiguous(), all_args, cfgs, relaxed=relaxed))
