"""Post-training calibration: activation range collection + scale algorithms
(PyTorch port of tengine_tpu/quantize/calibrate.py).

Reference: tools/quantize/quant_tool_int8.cpp — pass 1 records per-activation
|min,max| over calibration inputs (lines 68-220), pass 2 turns ranges into
scales via MinMax / KL-divergence / ACIQ (lines 223-434). Ranges are
collected by running the fp32 graph once per batch on the engine's device
with every intermediate tensor as an output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..executor.engine import ParamStore, build_forward, resolve_device
from ..graph.ir import Graph, QuantParam, TensorType
from ..ops import qmath
from ..utils import trace
from ..utils.config import Options


@dataclass
class ActivationStats:
    min: float
    max: float
    # histogram of |x| for KL (2048 bins like the reference, quant_tool_int8.cpp:261)
    hist: Optional[np.ndarray] = None
    hist_max: float = 0.0
    count: int = 0  # total elements observed (for the ACIQ sigma estimate)


def tensors_by_batch(graph: Graph, batches, options: Options, device: torch.device):
    """Every tensor of the graph's forward on `device`, by id, in semantic
    layout, for each batch (a tuple of numpy arrays, at the dtypes the
    graph takes): one dict a batch, yielded in turn. The prepare pass runs
    once, at the first batch's shapes."""
    with trace.span(trace.QUANTIZE_PREPARE):
        store = ParamStore()
        forward_all, _, _ = build_forward(graph, options, store, return_all=True)
        with torch.inference_mode():
            forward_all({}, *[torch.from_numpy(b).to("meta") for b in batches[0]])
        params = store.upload(device)
    for batch in batches:
        with trace.span(trace.QUANTIZE_FORWARD), torch.inference_mode():
            env = forward_all(params, *[torch.from_numpy(b).to(device) for b in batch])
        yield env


def collect_activation_ranges(
    graph: Graph,
    inputs: Iterable[Tuple[np.ndarray, ...]],
    options: Optional[Options] = None,
    with_histograms: bool = False,
    bins: int = 2048,
    device=None,
) -> Dict[int, ActivationStats]:
    """Run the fp32 graph over calibration batches on `device` (the card
    unless the caller names another); per-tensor min/max (and |x|
    histograms for KL)."""
    device = resolve_device(device)
    options = options or Options(quant_mode="float")
    batches = []
    for batch in inputs:
        batch = batch if isinstance(batch, (tuple, list)) else (batch,)
        batches.append(tuple(np.asarray(b, np.float32) for b in batch))
    if not batches:
        raise ValueError("no calibration inputs")

    stats: Dict[int, ActivationStats] = {}
    with trace.span(trace.QUANTIZE_COLLECT):
        for env in tensors_by_batch(graph, batches, options, device):
            with trace.span(trace.QUANTIZE_OBSERVE):
                _observe(graph, env, stats, with_histograms, bins)
    return stats


def _observe(graph: Graph, env, stats: Dict[int, ActivationStats], with_histograms: bool,
             bins: int) -> None:
    """Folds one batch's tensors `env` into `stats`: each non-const
    tensor's range, and with_histograms its |x| histogram."""
    for tid, arr in env.items():
        t = graph.tensors[tid]
        if t.tensor_type == TensorType.CONST:
            continue
        mn, mx = (float(v) for v in torch.aminmax(arr.float()))
        s = stats.get(tid)
        if s is None:
            s = stats[tid] = ActivationStats(min=mn, max=mx)
        else:
            s.min = min(s.min, mn)
            s.max = max(s.max, mx)
        s.count += arr.numel()
        if with_histograms:
            a = arr.float().cpu().numpy()
            amax = max(abs(s.min), abs(s.max), 1e-9)
            # exact zeros are EXCLUDED from the KL histogram, matching
            # the reference (quant_utils.cpp:histCount `if (data[i]!=0)`).
            # Post-ReLU activations can be >90% zeros; counting them
            # makes every small clip threshold look KL-optimal (the zero
            # bin is always represented) and collapses the scale — seen
            # as a 0.10 top-1 on the depthwise digit net before the fix.
            nz = a[a != 0]
            h, _ = np.histogram(np.abs(nz), bins=bins, range=(0, amax))
            if s.hist is None or s.hist_max < amax:
                # rebin existing histogram into the new range
                if s.hist is not None and s.hist_max > 0:
                    scale_f = s.hist_max / amax
                    idx = np.minimum((np.arange(bins) * scale_f).astype(int), bins - 1)
                    rebinned = np.zeros(bins)
                    np.add.at(rebinned, idx, s.hist)
                    s.hist = rebinned
                else:
                    s.hist = np.zeros(bins)
                s.hist_max = amax
                s.hist += h
            else:
                idx_scale = amax / s.hist_max
                idx = np.minimum((np.arange(bins) * idx_scale).astype(int), bins - 1)
                add = np.zeros(bins)
                np.add.at(add, idx, h)
                s.hist += add


# ---------------------------------------------------------------------------
# scale algorithms
# ---------------------------------------------------------------------------


def minmax_uint8(stats: ActivationStats) -> QuantParam:
    """Asymmetric per-tensor uint8 (quant_tool_uint8.cpp MinMax):
    scale = (max-min)/255, zp = round(-min/scale)."""
    mn = min(stats.min, 0.0)
    mx = max(stats.max, 0.0)
    scale = (mx - mn) / 255.0
    if scale == 0.0:
        scale = 1e-4
    zp = int(np.clip(round(-mn / scale), 0, 255))
    return QuantParam.per_tensor(scale, zp, width=8)


def minmax_int8(stats: ActivationStats) -> QuantParam:
    """Symmetric per-tensor int8 (quant_tool_int8.cpp MinMax):
    scale = max(|min|,|max|)/127."""
    amax = max(abs(stats.min), abs(stats.max))
    scale = amax / 127.0 if amax > 0 else 1e-4
    return QuantParam.per_tensor(scale, 0, width=8)


def kl_int8(stats: ActivationStats, bins: int = 2048, target_bins: int = 128) -> QuantParam:
    """KL-divergence threshold search (quant_tool_int8.cpp:223-360 /
    NVIDIA-style): pick the |x| clip threshold minimizing KL(P||Q) between
    the fp32 histogram and its int8-quantized projection."""
    if stats.hist is None or stats.hist.sum() == 0:
        return minmax_int8(stats)
    hist = stats.hist.astype(np.float64)
    best_kl, best_t = np.inf, bins
    for t in range(target_bins, bins + 1, 16):
        p = hist[:t].copy()
        p[t - 1] += hist[t:].sum()  # clip outliers into the last bin
        if p.sum() == 0:
            continue
        # quantize t bins down to target_bins
        chunk = t / target_bins
        q = np.zeros(t)
        for i in range(target_bins):
            lo = int(np.floor(i * chunk))
            hi = int(np.ceil((i + 1) * chunk))
            hi = min(hi, t)
            seg = hist[lo:hi]
            nonzero = (seg > 0).sum()
            if nonzero:
                q[lo:hi] = np.where(seg > 0, seg.sum() / nonzero, 0)
        pn = p / p.sum()
        qs = q.sum()
        if qs == 0:
            continue
        qn = q / qs
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(pn[mask] / np.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_t = kl, t
    amax = max(abs(stats.min), abs(stats.max), 1e-9)
    threshold = (best_t + 0.5) * amax / bins
    return QuantParam.per_tensor(threshold / 127.0, 0, width=8)


# ACIQ (Banner et al., "Post training 4-bit quantization of convolutional
# networks for rapid-deployment") optimal Gaussian clipping ratios alpha*/sigma
# per bit-width — the table the reference's ACIQ mode uses
# (tools/quantize/quant_tool_int8.cpp, -a 2 path).
_ACIQ_GAUSS_ALPHA = {2: 1.71, 3: 2.15, 4: 2.55, 5: 2.93, 6: 3.28, 7: 3.61, 8: 3.92}


def aciq_int8(stats: ActivationStats, width: int = 8) -> QuantParam:
    """ACIQ analytical clipping: estimate sigma from the observed max of N
    Gaussian samples (E[max] = sigma*sqrt(2 ln N)*c), clip at alpha*(b)*sigma,
    symmetric int8 scale = alpha/127."""
    amax = max(abs(stats.min), abs(stats.max))
    if amax <= 0:
        return minmax_int8(stats)
    n = max(int(stats.count), 2)
    # Gaussian-max correction constant (quant_tool ACIQ uses the same form)
    gauss_c = 0.5 * 0.35 * (1.0 + (np.pi * np.log(4.0)) ** 0.5)
    sigma = amax * 2.0 * gauss_c / np.sqrt(2.0 * np.log(n))
    alpha = _ACIQ_GAUSS_ALPHA.get(width, 3.92) * sigma
    alpha = min(alpha, amax)  # never clip wider than the observed range
    qmax = (1 << (width - 1)) - 1
    return QuantParam.per_tensor(alpha / qmax if alpha > 0 else 1e-4, 0, width=8)


def weight_quant_int8_perchannel(w: np.ndarray, op: str = "Convolution",
                                 group: int = 1) -> QuantParam:
    """Per-output-channel symmetric int8 weights (quant_tool_int8.cpp weight
    pass): scale[c] = max|w[c]|/127, over the output channels of an `op`
    weight (qmath.weight_absmax: a Deconvolution's lie along axis 1)."""
    amax = qmath.weight_absmax(w, op, group)
    scales = np.where(amax > 0, amax / 127.0, 1e-4).astype(np.float32)
    return QuantParam(scales=scales, zero_points=np.zeros(scales.size, np.int32), width=8)


def weight_quant_uint8(w: np.ndarray) -> QuantParam:
    """Per-tensor asymmetric uint8 weights (quant_tool_uint8.cpp)."""
    mn = min(float(w.min()), 0.0)
    mx = max(float(w.max()), 0.0)
    scale = (mx - mn) / 255.0
    if scale == 0.0:
        scale = 1e-4
    zp = int(np.clip(round(-mn / scale), 0, 255))
    return QuantParam.per_tensor(scale, zp, width=8)
