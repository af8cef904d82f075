"""Data-free quantization: cross-layer weight equalization.

Reference: tools/quantize/algorithm/quant_dfq.cpp (the -a 3 "dfq" mode of
quant_tool_int8). Per Nagel et al. ("Data-Free Quantization Through Weight
Equalization and Bias Correction"): for a Conv1 -> [ReLU] -> Conv2 pair,
per-channel ranges can be balanced without changing the float function by
rescaling channel c of Conv1's output and the matching input channel of
Conv2:

    s[c]        = sqrt(r1[c] / r2[c])      r1 = max|W1[c,...]|, r2 = max|W2[:,c,...]|
    W1[c] /= s[c],  b1[c] /= s[c],  W2[:, c] *= s[c]

ReLU (and identity) are positively homogeneous, so the composition is
unchanged in fp32 but the per-channel dynamic ranges meet in the middle —
exactly what per-tensor (uint8) weight quantization needs. Run before
`quantize_graph` on the fp32 graph; iterate a few times for chains.

PyTorch port of tengine_tpu/quantize/dfq.py: the equalization is the same
numpy; bias_correction runs both graphs on the port's engine, on the card
unless the caller names another device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph.ir import Graph, Node

_HOMOGENEOUS_ACTS = (-1, 0)  # none, relu — positively homogeneous only


def _conv_pair(g: Graph, conv1: Node) -> Optional[Node]:
    """conv1 -> conv2 with conv1's output consumed only by conv2, both float,
    activation of conv1 positively homogeneous, conv2 group==1."""
    if conv1.op != "Convolution":
        return None
    if conv1.params.get("activation", -1) not in _HOMOGENEOUS_ACTS:
        return None
    out = g.tensors[conv1.outputs[0]]
    consumers = [c for c in out.consumers if g.nodes[c].inputs[:1] == [out.idx]]
    if len(out.consumers) != 1 or not consumers:
        return None
    conv2 = g.nodes[consumers[0]]
    if conv2.op != "Convolution" or conv2.params.get("group", 1) != 1:
        return None
    if conv1.idx in g.outputs:
        return None
    return conv2


def equalize_pair(g: Graph, conv1: Node, conv2: Node, eps: float = 1e-8) -> float:
    """Equalize one pair in place; returns max |log s| applied (0 = no-op)."""
    w1 = g.tensors[conv1.inputs[1]]
    w2 = g.tensors[conv2.inputs[1]]
    a1 = w1.data.astype(np.float64)
    a2 = w2.data.astype(np.float64)
    C = a1.shape[0]
    if a2.shape[1] != C:
        return 0.0
    r1 = np.abs(a1.reshape(C, -1)).max(axis=1)
    r2 = np.abs(a2.transpose(1, 0, 2, 3).reshape(C, -1)).max(axis=1)
    s = np.sqrt(np.maximum(r1, eps) / np.maximum(r2, eps))
    s = np.clip(s, 1e-4, 1e4)
    w1.data = (a1 / s.reshape(-1, 1, 1, 1)).astype(np.float32)
    if len(conv1.inputs) > 2:
        b1 = g.tensors[conv1.inputs[2]]
        b1.data = (b1.data.astype(np.float64) / s).astype(np.float32)
    w2.data = (a2 * s.reshape(1, -1, 1, 1)).astype(np.float32)
    return float(np.abs(np.log(s)).max())


def bias_correction(
    fp32_graph: Graph,
    quant_graph: Graph,
    calibration_inputs,
    options=None,
    device=None,
) -> int:
    """Empirical bias correction (DFQ paper §4.2 / the reference's
    quant_eq.cpp bias-search intent): quantization shifts each conv's
    expected per-channel output; measure E[y_fp32 - y_quant] per channel on
    the calibration set and fold it into the quantized bias. First-order,
    one pass over all weighted nodes. Both graphs run on `device` (the card
    unless the caller names another). Returns #corrected nodes.
    """
    from ..executor.engine import resolve_device
    from ..ops import qmath
    from ..utils.config import Options
    from .calibrate import tensors_by_batch

    device = resolve_device(device)
    opts_f = Options(quant_mode="float")
    opts_q = options or Options(quant_mode="fast")

    def run_all(graph, opts, batches):
        return [{tid: a.cpu().numpy() for tid, a in env.items()}
                for env in tensors_by_batch(graph, batches, opts, device)]

    batches_f = []
    for b in calibration_inputs:
        b = b if isinstance(b, (tuple, list)) else (b,)
        batches_f.append(tuple(np.asarray(a, np.float32) for a in b))
    t_in = quant_graph.tensors[quant_graph.input_tensors[0]]
    batches_q = [
        tuple(qmath.quantize_np(a, t_in.quant, t_in.dtype) for a in b)
        for b in batches_f
    ]

    envs_f = run_all(fp32_graph, opts_f, batches_f)
    envs_q = run_all(quant_graph, opts_q, batches_q)

    corrected = 0
    for n_f, n_q in zip(fp32_graph.nodes, quant_graph.nodes):
        if n_q.op not in ("Convolution", "Deconvolution") or len(n_q.inputs) < 3:
            continue
        tid = n_q.outputs[0]
        t_out = quant_graph.tensors[tid]
        if t_out.quant is None:
            continue
        # relu keeps the correction first-order valid for mostly-active
        # channels (DFQ paper applies it pre-activation); skip clipped acts
        if n_q.params.get("activation", -1) not in (-1, 0):
            continue
        diffs = []
        for ef, eq in zip(envs_f, envs_q):
            yf = np.asarray(ef[n_f.outputs[0]], np.float32)
            yq = qmath.dequantize_np(np.asarray(eq[tid]), t_out.quant)
            d = yf - yq
            diffs.append(d.mean(axis=(0, 2, 3)) if d.ndim == 4 else d.mean(axis=0))
        delta = np.mean(diffs, axis=0)

        t_b = quant_graph.tensors[n_q.inputs[2]]
        t_w = quant_graph.tensors[n_q.inputs[1]]
        t_x = quant_graph.tensors[n_q.inputs[0]]
        s_in = float(np.asarray(t_x.quant.scales).reshape(-1)[0])
        w_s = np.asarray(t_w.quant.scales, np.float32).reshape(-1)
        if w_s.size == 1:
            w_s = np.full(delta.shape, w_s[0], np.float32)
        # quantized bias lives in scale s_in * s_w[c]
        t_b.data = (
            t_b.data.astype(np.int64)
            + np.round(delta / (s_in * w_s)).astype(np.int64)
        ).astype(t_b.data.dtype)
        corrected += 1
    return corrected


def equalize_graph(g: Graph, iterations: int = 3, tol: float = 1e-3) -> int:
    """Sweep all eligible pairs `iterations` times (chains re-balance each
    sweep, like the reference's iterative dfq loop). Returns pair count."""
    pairs = []
    for n in g.nodes:
        c2 = _conv_pair(g, n)
        if c2 is not None:
            pairs.append((n, c2))
    for _ in range(iterations):
        moved = 0.0
        for c1, c2 in pairs:
            moved = max(moved, equalize_pair(g, c1, c2))
        if moved < tol:
            break
    return len(pairs)
