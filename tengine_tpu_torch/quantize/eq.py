"""EQ — search-based per-channel weight-scale equalization.

Reference: tools/quantize/algorithm/quant_eq.cpp (QuantTool::quant_search).
For every Convolution/FC node the reference scans a "zoom" grid over the
per-output-channel weight scale — snum = 0,20,...,180 giving
zoom = 1.3*(snum+1)/200 ∈ (0, ~1.18] — fake-quantizes the weights at each
zoomed scale, runs the layer over <=50 calibration images, and keeps, per
output channel, the zoom maximizing the cosine similarity between the fp32
layer output and the fake-quant layer output (quant_eq.cpp:1050-1140,
cosin_similarity per-channel variant at :932). The final weight scale is
best_zoom[c] * base_scale[c].

PyTorch port of tengine_tpu/quantize/eq.py. Implementation notes:
  * the layer sweep is one torch conv/matmul per zoom candidate with all
    calibration images batched, on the calibration device with TF32 off
    (the reference loops images one at a time through the interpreter);
  * inputs to each layer are the fp32 activations (the reference feeds each
    node from its own graph pair; the cascading fake-quant input is a
    second-order effect on the arg-max over zoom and is deliberately not
    reproduced — the search stays layer-local and embarrassingly parallel);
  * bias is added to both sides (as in the reference, which re-quantizes
    bias per candidate) — it shifts both outputs identically and keeps the
    cosine honest for bias-dominated channels.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..executor.engine import resolve_device
from ..graph.ir import DType, Graph, QuantParam
from ..ops import qmath
from ..utils.config import Options
from ..utils.log import logger
from .calibrate import tensors_by_batch
from .quantizer import fit_bias, quantize_bias

# the reference's zoom grid: snum = 0,20,...,180 -> 1.3*(snum+1)/200
ZOOMS = tuple(1.3 * (snum + 1) / 200.0 for snum in range(0, 200, 20))

_WEIGHTED_EQ = {"Convolution": (1, 2), "FullyConnected": (1, 2)}


def _collect_layer_inputs(
    graph: Graph,
    batches: List[np.ndarray],
    need: set,
    options: Options,
    device: torch.device,
) -> Dict[int, torch.Tensor]:
    """fp32 activations (semantic NCHW layout) for the tensor ids in `need`,
    concatenated over calibration batches, on `device`."""
    acc: Dict[int, List[torch.Tensor]] = {tid: [] for tid in need}
    for env in tensors_by_batch(graph, batches, options, device):
        for tid in need:
            if tid in env:
                acc[tid].append(env[tid].to(torch.float32))
    return {tid: torch.cat(v, dim=0) for tid, v in acc.items() if v}


def _fake_quant_weight(w: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Symmetric int8 per-channel fake quant (weight_requant_search)."""
    s = scales.reshape((-1,) + (1,) * (w.ndim - 1))
    safe = np.where(s == 0, 1.0, s)
    q = np.clip(qmath.round_away_np(w / safe), -127, 127)
    return np.where(s == 0, 0.0, q * s).astype(np.float32)


def _layer_out(x: torch.Tensor, w: torch.Tensor, b, node) -> np.ndarray:
    """fp32 layer output, channels-first [N, C_out, ...], as numpy."""
    with torch.inference_mode():
        if node.op == "Convolution":
            p = node.params
            xp = F.pad(x, (p["pad_w0"], p["pad_w1"], p["pad_h0"], p["pad_h1"]))
            out = F.conv2d(xp, w, stride=(p["stride_h"], p["stride_w"]),
                           dilation=(p["dilation_h"], p["dilation_w"]),
                           groups=p.get("group", 1))
            if b is not None:
                out = out + b.reshape(1, -1, 1, 1)
        else:  # FullyConnected: [N, K] @ [O, K]^T
            out = x.reshape(x.shape[0], -1) @ w.reshape(w.shape[0], -1).T
            if b is not None:
                out = out + b.reshape(1, -1)
        return out.cpu().numpy()


def _per_channel_cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cosine over all (image, spatial) elements, per output channel
    (quant_eq.cpp:932 cosin_similarity perchannel)."""
    a2 = np.moveaxis(a, 1, 0).reshape(a.shape[1], -1).astype(np.float64)
    b2 = np.moveaxis(b, 1, 0).reshape(b.shape[1], -1).astype(np.float64)
    num = (a2 * b2).sum(axis=1)
    den = np.sqrt((a2 * a2).sum(axis=1)) * np.sqrt((b2 * b2).sum(axis=1))
    cos = np.where(den > 0, num / np.maximum(den, 1e-30), np.float64(1.0))
    return np.where(np.abs(cos) > 999999, 0.0, cos)


def eq_adjust_weights(
    fp32_graph: Graph,
    qgraph: Graph,
    calibration_inputs: Iterable,
    options: Optional[Options] = None,
    max_imgs: int = 50,
    zooms=ZOOMS,
    device=None,
) -> int:
    """Search per-channel weight-scale zooms on `fp32_graph` and write the
    winning scales (and re-quantized weights/biases) into `qgraph` in place.
    The graph and the sweep run on `device` (the card unless the caller
    names another). Returns the number of adjusted nodes."""
    device = resolve_device(device)
    options = options or Options(quant_mode="float")
    batches = []
    total = 0
    for b in calibration_inputs:
        b = b if isinstance(b, (tuple, list)) else (b,)
        arr = tuple(np.asarray(x, np.float32) for x in b)
        batches.append(arr)
        total += arr[0].shape[0]
        if total >= max_imgs:
            break
    if not batches:
        raise ValueError("no calibration inputs")

    nodes = [
        n
        for n in qgraph.nodes
        if n.op in _WEIGHTED_EQ and len(n.inputs) > _WEIGHTED_EQ[n.op][0]
    ]
    need = {n.inputs[0] for n in nodes}
    # also need the graph inputs themselves (first layer)
    acts = _collect_layer_inputs(fp32_graph, batches, need, options, device)
    # graph input tensors are in env too; if missing, synthesize from batches
    for n in nodes:
        tid = n.inputs[0]
        if tid not in acts and tid in fp32_graph.input_tensors:
            acts[tid] = torch.from_numpy(np.concatenate([b[0] for b in batches], axis=0)).to(device)

    adjusted = 0
    for n in nodes:
        w_idx, b_idx = _WEIGHTED_EQ[n.op]
        fn = fp32_graph.nodes[n.idx]
        wt_q = qgraph.tensors[n.inputs[w_idx]]
        wt_f = fp32_graph.tensors[fn.inputs[w_idx]]
        if wt_q.quant is None or not wt_q.quant.per_channel:
            continue
        x = acts.get(n.inputs[0])
        if x is None:
            continue
        w = wt_f.data.astype(np.float32)
        out_c = w.shape[0]
        b = None
        if b_idx is not None and len(fn.inputs) > b_idx:
            b = fp32_graph.tensors[fn.inputs[b_idx]].data.astype(np.float32)

        amax = np.max(np.abs(w.reshape(out_c, -1)), axis=1)
        # zero-scale guard, same floor as weight_quant_int8_perchannel: an
        # all-zero (pruned/dead) output channel must not yield scale 0 and a
        # 0/0 -> NaN -> int8 cast downstream
        base = np.where(amax > 0, amax / 127.0, 1e-4).astype(np.float32)
        b_dev = None if b is None else torch.from_numpy(b).to(device)
        ref_out = _layer_out(x, torch.from_numpy(w).to(device), b_dev, n)
        best_cos = np.full(out_c, -1.0)
        best_zoom = np.ones(out_c, np.float32)
        for z in zooms:
            wq = torch.from_numpy(_fake_quant_weight(w, base * z)).to(device)
            cos = _per_channel_cosine(ref_out, _layer_out(x, wq, b_dev, n))
            better = cos > best_cos
            best_cos = np.where(better, cos, best_cos)
            best_zoom = np.where(better, np.float32(z), best_zoom)

        new_scales = (base * best_zoom).astype(np.float32)
        wq = QuantParam(scales=new_scales, zero_points=np.zeros(out_c, np.int32), width=8)

        # bias rescale: b_q = round(b / (s_in * s_w[c])), the scales raised
        # where a bias would not fit (quantizer.fit_bias)
        bt = xin = None
        if b is not None and len(n.inputs) > b_idx:
            bt, xin = qgraph.tensors[n.inputs[b_idx]], qgraph.tensors[n.inputs[0]]
            if xin.quant is None or bt.dtype != DType.INT32:
                bt = None
        if bt is not None:
            s_in = float(np.asarray(xin.quant.scales).reshape(-1)[0])
            wq = fit_bias(wq, w, b, s_in, asymmetric=False)
            bt.data = b.copy()
            quantize_bias(bt, wq, s_in)
        wt_q.quant.scales = wq.scales
        wt_q.quant.zero_points = wq.zero_points
        wt_q.data = qmath.quantize_weight_np(w, wt_q.quant, DType.INT8, n.op)
        adjusted += 1
        logger.debug(
            "eq: %s mean zoom %.3f mean cos %.5f", n.name, float(best_zoom.mean()),
            float(best_cos.mean()),
        )
    return adjusted
