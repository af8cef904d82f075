"""Graph quantizer: fp32 IR -> full-integer UINT8/INT8 IR (PyTorch port of
tengine_tpu/quantize/quantizer.py; calibration runs on the engine's device).

The write-side of the reference's quant tools (quant_save_graph.cpp):
activations get calibration-derived quant params, conv/FC weights are
quantized (uint8 asym per-tensor / int8 sym per-channel), biases become int32
with scale s_in * s_w[c]. The result is a graph the quantized execution
kernels (ops/quantized.py) run — and that the TM2 writer can save as a
quantized tmfile.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional

import numpy as np

from ..graph.ir import DType, Graph, QuantParam, TensorType
from ..ops import qmath
from ..utils import trace
from ..utils.config import Options
from ..utils.log import logger
from .calibrate import (
    ActivationStats,
    aciq_int8,
    collect_activation_ranges,
    kl_int8,
    minmax_int8,
    minmax_uint8,
    weight_quant_int8_perchannel,
    weight_quant_uint8,
)

# ops whose float lowering must see float data and whose outputs stay fp32
# (the reference marks these via per-op quant skip lists in the quant tools)
_KEEP_FLOAT_OUTPUT_OPS = {"DetectionOutput", "RPN", "TopKV2", "ArgMax", "ArgMin", "Shape"}

# weight-carrying ops: (weight input index, bias input index or None)
_WEIGHTED = {"Convolution": (1, 2), "FullyConnected": (1, 2), "Deconvolution": (1, 2)}

INT32_MAX = 2**31 - 1
# where a bias does not fit, the weight scale is raised until the bias lands
# here: half the int32 range (fit_bias)
BIAS_TARGET = 2**30


def _s_in(t) -> float:
    return float(np.asarray(t.quant.scales).reshape(-1)[0])


def _bias_scales(wq: QuantParam, n: int, s_in: float) -> np.ndarray:
    """s_in * s_w[c] over the n output channels, in float32 as stored."""
    w_scales = np.asarray(wq.scales, np.float32).reshape(-1)
    if w_scales.size == 1:
        w_scales = np.full((n,), w_scales[0], np.float32)
    return s_in * w_scales


def fit_bias(wq: QuantParam, w: np.ndarray, b: np.ndarray, s_in: float,
             asymmetric: bool) -> QuantParam:
    """The weight grid with each scale raised where the int32 bias
    round(b / (s_in·s_w)) would not fit: that channel's scale (the one
    scale of a per-tensor UINT8 grid, its zero point recomputed as
    weight_quant_uint8 computes it where `asymmetric`) goes to
    |b| / (s_in·2^30), so that the
    bias lands at half the int32 range. Half, not all of it: at 2^31 - 1
    the f32 roundings of s_in·s_w could push it back onto the clip, and an
    int32 accumulator that adds the bias (the reference's C kernels) keeps
    2^30 of room for the products. TFLite's post-training quantizer raises
    a weight scale for the same reason (AdjustWeightsForBiasScale,
    tensorflow/lite/tools/optimize/quantization_utils.cc). The JAX
    quantizer clips the bias at +-(2^31 - 1), which zeroes the seeded
    YOLOX's coarser heads (ROADMAP §3). Where every bias fits, `wq` is
    returned as it is, and the graph is the JAX quantizer's."""
    b = np.asarray(b, np.float64).reshape(-1)
    b_scales = _bias_scales(wq, b.size, s_in)
    safe = np.where(b_scales == 0.0, 1.0, b_scales).astype(np.float64)
    over = (np.abs(qmath.round_away_np(b / safe)) > INT32_MAX) & (b_scales > 0.0)
    if not over.any():
        return wq
    need = np.abs(b) / (s_in * float(BIAS_TARGET))
    if not wq.per_channel:
        scale = max(float(np.asarray(wq.scales).reshape(-1)[0]), float(need[over].max()))
        zp = np.asarray(wq.zero_points).copy()
        if asymmetric:
            zp[...] = int(np.clip(round(-min(float(w.min()), 0.0) / scale), 0, 255))
        return QuantParam(scales=np.full_like(np.asarray(wq.scales, np.float32), scale),
                          zero_points=zp, width=wq.width)
    scales = np.where(over, np.maximum(wq.scales, need), wq.scales).astype(np.float32)
    return QuantParam(scales=scales, zero_points=np.asarray(wq.zero_points).copy(),
                      width=wq.width)


def quantize_bias(bt, wq: QuantParam, s_in: float) -> None:
    """bt becomes the int32 bias at scales s_in * s_w[c]. float64
    throughout: in float32 the clip bound 2^31-1 rounds UP to 2^31 and the
    int32 cast overflows for saturated biases. Zero scales (all-zero weight
    channel) contribute 0 downstream (the requant multiplier is 0 too), so
    the bias is 0 there."""
    b_scales = _bias_scales(wq, bt.data.size, s_in)
    safe = np.where(b_scales == 0.0, 1.0, b_scales).astype(np.float64)
    bq = qmath.round_away_np(bt.data.astype(np.float64) / safe)
    bt.data = (
        np.where(b_scales == 0.0, 0.0, np.clip(bq, float(-INT32_MAX), float(INT32_MAX)))
        .astype(np.int64)
        .astype(np.int32)
    )
    bt.dtype = DType.INT32
    bt.quant = QuantParam(
        scales=b_scales.astype(np.float32),
        zero_points=np.zeros(b_scales.size, np.int32),
        width=32,
    )


def quantize_graph(
    graph: Graph,
    calibration_inputs: Iterable,
    scheme: str = "uint8",
    algorithm: str = "minmax",
    options: Optional[Options] = None,
    device=None,
) -> Graph:
    """PTQ: returns a new quantized Graph.

    scheme: "uint8" (asymmetric per-tensor, quant_tool_uint8 equivalent) or
            "int8" (symmetric, per-channel weights, quant_tool_int8).
    algorithm: "minmax" | "kl" | "aciq" (activations; weights always minmax;
    int8 scheme only for kl/aciq, matching the reference's tool split).
    device: where calibration runs — the card unless the caller names
    another (device="cpu"); raises without a card.
    """
    if scheme not in ("uint8", "int8"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if algorithm not in ("minmax", "kl", "aciq", "eq"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if algorithm == "eq" and scheme != "int8":
        # EQ searches per-channel weight scales, which only the int8 scheme
        # carries (quant_tool splits the same way); silently falling back to
        # minmax would misreport what ran
        raise ValueError("algorithm='eq' requires scheme='int8'")

    # materialize once: calibration_inputs may be a generator, and EQ below
    # iterates it a second time after collect_activation_ranges consumed it
    calibration_inputs = list(calibration_inputs)

    stats = collect_activation_ranges(
        graph, calibration_inputs, options, with_histograms=(algorithm == "kl"),
        device=device,
    )
    with trace.span(trace.QUANTIZE_REWRITE):
        q = _rewrite(graph, stats, scheme, algorithm)

    if algorithm == "eq" and scheme == "int8":
        # search-based per-channel weight-scale equalization on top of the
        # minmax base quantization (quant_eq.cpp QuantTool::quant_search)
        from .eq import eq_adjust_weights

        n = eq_adjust_weights(graph, q, calibration_inputs, options, device=device)
        logger.info("eq search adjusted %d weighted nodes", n)
    return q


def _rewrite(graph: Graph, stats: Dict, scheme: str, algorithm: str) -> Graph:
    """A quantized copy of `graph`: activation grids from the calibration
    `stats`, shared grids pinned, weights and biases quantized."""
    act_dtype = DType.UINT8 if scheme == "uint8" else DType.INT8

    def act_qparam(s: ActivationStats) -> QuantParam:
        if scheme == "uint8":
            return minmax_uint8(s)
        if algorithm == "kl":
            return kl_int8(s)
        if algorithm == "aciq":
            return aciq_int8(s)
        return minmax_int8(s)

    q = copy.deepcopy(graph)
    q.name = f"{graph.name}.{scheme}"

    # which tensors stay float: outputs of keep-float ops
    keep_float = set()
    for n in q.nodes:
        if n.op in _KEEP_FLOAT_OUTPUT_OPS:
            keep_float.update(n.outputs)

    # 1. activations (VAR + INPUT tensors)
    for t in q.tensors:
        if t.tensor_type in (TensorType.VAR, TensorType.INPUT) and t.idx not in keep_float:
            s = stats.get(t.idx)
            if s is None:
                continue  # never produced (dangling) — leave float
            t.quant = act_qparam(s)
            t.dtype = act_dtype

    # 1b. value-preserving permutation ops: the output is the SAME value
    # multiset as the input, so the input's grid is exactly optimal for the
    # output — pin them equal (calibration noise/histogram binning can
    # otherwise produce a gratuitously different scale, forcing a per-element
    # rescale through the f32 wrapper on what should be a pure 1-byte
    # permutation; the quantized ShuffleChannel kernel requires equality).
    # TFLite's converter applies the same scale-sharing rule to its
    # restricted ops; the reference's shufflechannel_ref.c is a memcpy that
    # implicitly assumes it too.
    for n in q.nodes:
        if n.op in ("ShuffleChannel", "Reshape", "Flatten", "Squeeze",
                    "Transpose", "Permute", "Upsample", "Crop"):
            if not n.inputs or not n.outputs:
                continue
            t_in, t_out = q.tensors[n.inputs[0]], q.tensors[n.outputs[0]]
            if (
                t_in.quant is not None
                and t_out.quant is not None
                and not t_in.quant.per_channel
            ):
                t_out.quant = copy.deepcopy(t_in.quant)

    # 1c. restricted-op scale sharing (TFLite's rule): Concat
    # inputs adopt the concat OUTPUT's grid (its calibrated range is the
    # union of the inputs', so it covers each), and Slice/Split outputs
    # adopt the input's. The producers' requant epilogues then retarget
    # the shared grid for free, and the concat/slice itself becomes a raw
    # 1-byte copy (the quantized passthrough kernels engage). This is a
    # quantizer design choice the reference does not make — its concat
    # ref kernel pays a per-element requantize instead (concat_ref.c);
    # accuracy cost is bounded (inputs move to a covering grid, <=1 bit of
    # resolution on narrow branches) and gated by the published top-1
    # harness. Tensors feeding two different concats keep their own grid
    # (first pin wins; the passthrough predicate simply won't fire there).
    pinned: set = set()
    for n in q.nodes:
        if n.op == "Concat" and n.outputs:
            t_out = q.tensors[n.outputs[0]]
            if t_out.quant is None or t_out.quant.per_channel:
                continue
            for tid in n.inputs:
                t = q.tensors[tid]
                if (
                    t.tensor_type == TensorType.VAR
                    and t.quant is not None
                    and not t.quant.per_channel
                    and t.idx not in pinned
                    and t.dtype == t_out.dtype
                ):
                    t.quant = copy.deepcopy(t_out.quant)
                    pinned.add(t.idx)
        elif n.op in ("Slice", "Split") and n.inputs:
            t_in = q.tensors[n.inputs[0]]
            if t_in.quant is None or t_in.quant.per_channel:
                continue
            for tid in n.outputs:
                t = q.tensors[tid]
                if (
                    t.quant is not None
                    and not t.quant.per_channel
                    and t.idx not in pinned
                    and t.dtype == t_in.dtype
                ):
                    t.quant = copy.deepcopy(t_in.quant)
                    pinned.add(t.idx)

    # 2. weights + biases per weighted node
    for n in q.nodes:
        if n.op not in _WEIGHTED:
            continue
        w_idx, b_idx = _WEIGHTED[n.op]
        if len(n.inputs) <= w_idx:
            continue
        wt = q.tensors[n.inputs[w_idx]]
        w = wt.data.astype(np.float32)
        group = n.params.get("group", 1) if n.op == "Deconvolution" else 1
        w_dtype = DType.UINT8 if scheme == "uint8" else DType.INT8
        if scheme == "uint8":
            wq = weight_quant_uint8(w)
        else:
            wq = weight_quant_int8_perchannel(w, n.op, group)
        bt = xin = None
        if b_idx is not None and len(n.inputs) > b_idx:
            bt, xin = q.tensors[n.inputs[b_idx]], q.tensors[n.inputs[0]]
        if bt is not None and xin.quant is not None:
            wq = fit_bias(wq, w, bt.data, _s_in(xin), asymmetric=scheme == "uint8")
        wt.data = qmath.quantize_weight_np(w, wq, w_dtype, n.op, group)
        wt.dtype = w_dtype
        wt.quant = wq
        if bt is not None and xin.quant is not None:
            quantize_bias(bt, wq, _s_in(xin))

    q._is_quantized = True
    return q
