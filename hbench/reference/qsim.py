"""Plain post-training quantization of a conv net, worked out from its fp32
weights and inputs alone.

A network is written once as a function `forward(ctx, params, x)` that
calls the ops of a `Ctx`. The same function then runs in three modes:

  calib  - fp32 semantics in float64, recording each op output's min and
           max (MinMax) and, for KL calibration, the histogram of its |x|;
  quant  - the integer network: every op output on its own calibrated
           grid, convolutions as exact integer sums (float64 holds them
           exactly), requantized with C's round half away from zero;
  count  - on meta tensors, counting the operations and bytes of the
           quantized network's own semantics (hbench/counts.py).

The grids are those of Tengine's quant tools: "uint8" asymmetric per
tensor (scale (max - min) / 255, zero point round(-min / scale)) for
activations and weights; "int8" symmetric, activations per tensor
(max |x| / 127) and weights per output channel, both clipped to +-127.
With KL calibration (int8 only) every activation grid, the input's and the
outputs' included, takes the threshold of Tengine's KL search instead of
max |x| (kl_search below).
Biases are int32 at the scale s_in * s_w; where one would not fit, the
weight scale of its channel is raised until the bias lands at 2^30, as
TFLite's quantizer does. `bits` below 8 gives the same scheme on a
narrower grid (the control that runs in lower precision); a KL threshold is
kept there and spread over the narrower grid.

KL calibration, from the spec of Tengine's quant_tool_int8.cpp:223-360
(pass 2's KL mode) as the repository's documents state it:

  * a histogram of |x| over [0, max |x|] on 2,048 bins, exact zeros left
    out (quant_utils.cpp's histCount);
  * candidate thresholds of t = 128, 144, ..., 2,048 bins (a step of 16);
  * for each, P is the first t bins with every bin from t on folded into
    bin t - 1; Q projects the first t bins (outliers not folded) onto 128
    levels: level i spans bins [floor(i t / 128), ceil((i + 1) t / 128)),
    neighbouring levels overlapping where t / 128 is not whole, a bin
    taking the last level that covers it; each non-empty bin gets its
    level's mean over the level's non-empty bins, an empty one 0;
  * KL(P || Q) over the bins where P > 0, Q clamped at 1e-12; the least
    wins, the first on a tie; a candidate whose Q is all empty is skipped;
  * threshold = (t + 0.5) max|x| / 2048, scale = threshold / 127.

Departures: the histogram is of one batch (the harness hands the
calibration images over as one, and calibration refuses several), so no
histogram is ever rebinned to a wider range; it is taken of the float64
forward, and binned in float64, where the C tool bins its float32 forward
in float32, so a value within rounding of a bin's edge may fall on the
other side; a tensor with no nonzero value takes its MinMax grid.

Imports nothing of the program under test.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

INT32_MAX = 2**31 - 1
BIAS_TARGET = 2**30
# the KL search: histogram bins, the levels of the int8 grid, the step
# between candidate thresholds, in bins
KL_BINS, KL_LEVELS, KL_STEP = 2048, 128, 16


def round_away(x: torch.Tensor) -> torch.Tensor:
    """C round(): half away from zero, exact on ties."""
    t = torch.trunc(x)
    return t + torch.sign(x) * (torch.abs(x - t) >= 0.5).to(x.dtype)


def f32(v) -> float:
    """A scale as the model file stores it: float32."""
    return float(np.float32(v))


class Grid:
    """One tensor's grid: float32 scale(s), integer zero point(s), clip."""

    def __init__(self, scale, zero, lo: int, hi: int, kl: Optional["KLSearch"] = None):
        self.scale = scale  # float, or a float64 tensor of per-channel scales
        self.zero = zero
        self.lo, self.hi = lo, hi
        self.kl = kl  # the KL search a KL grid came from


def act_grid(lo_v: float, hi_v: float, scheme: str, bits: int) -> Grid:
    """MinMax grid of an activation from its observed range."""
    if scheme == "uint8":
        levels = 2**bits - 1
        mn, mx = min(lo_v, 0.0), max(hi_v, 0.0)
        scale = (mx - mn) / levels or 1e-4
        zero = int(np.clip(round(-mn / scale), 0, levels))
        return Grid(f32(scale), zero, 0, levels)
    qmax = 2 ** (bits - 1) - 1
    amax = max(abs(lo_v), abs(hi_v))
    return Grid(f32(amax / qmax if amax > 0 else 1e-4), 0, -qmax, qmax)


def kl_grid(search: "KLSearch", bits: int) -> Grid:
    """Symmetric grid of a KL search's threshold, spread over `bits`."""
    qmax = 2 ** (bits - 1) - 1
    return Grid(f32(search.threshold / qmax), 0, -qmax, qmax, search)


def abs_histogram(x: torch.Tensor, bins: int = KL_BINS):
    """(the histogram of |x|'s nonzero values over [0, max |x|] on `bins`
    bins, as float64 on the host; max |x|, at least 1e-9): |x| falls in bin
    floor(|x| / max * bins), the last bin closed."""
    a = x.double().abs().flatten()
    amax = max(float(a.max()) if a.numel() else 0.0, 1e-9)
    a = a[a != 0]
    idx = torch.clamp(torch.floor(a / amax * bins).long(), 0, bins - 1)
    return torch.bincount(idx, minlength=bins).double().cpu(), amax


@functools.lru_cache(maxsize=4)
def _kl_levels(bins: int, levels: int, step: int):
    """For every candidate t (rows) and bin j (columns): the candidates,
    whether j < t, and the bins [lo, hi) of the last level that covers j."""
    ts = torch.arange(levels, bins + 1, step)
    t, j = ts[:, None], torch.arange(bins)[None, :]
    lvl = torch.clamp(((j + 1) * levels + t - 1) // t - 1, max=levels - 1)
    lo = (lvl * t) // levels
    hi = torch.minimum(((lvl + 1) * t + levels - 1) // levels, t)
    return ts, j < t, lo, hi


def kl_divergences(hist: torch.Tensor, levels: int = KL_LEVELS, step: int = KL_STEP):
    """(the candidates t, in bins; KL(P || Q) of each, infinite where Q is
    empty), every candidate at once (the module's docstring says how P and
    Q are made)."""
    h = hist.double().cpu()
    bins = h.numel()
    total = float(h.sum())
    c = torch.cat([h.new_zeros(1), h.cumsum(0)])  # exact: whole counts
    nz = torch.cat([torch.zeros(1, dtype=torch.long), (h > 0).long().cumsum(0)])
    ts, inside, lo, hi = _kl_levels(bins, levels, step)
    p = torch.where(inside, h[None, :], h.new_zeros(()))
    p[torch.arange(len(ts)), ts - 1] = total - c[ts - 1]
    q = torch.where(inside & (h[None, :] > 0),
                    (c[hi] - c[lo]) / (nz[hi] - nz[lo]).clamp(min=1), h.new_zeros(()))
    qs = q.sum(1, keepdim=True)
    pn = p / p.sum(1, keepdim=True)
    qn = q / torch.where(qs == 0, torch.ones_like(qs), qs)
    terms = torch.where(pn > 0, pn * torch.log(pn / torch.clamp(qn, min=1e-12)),
                        h.new_zeros(()))
    return ts, torch.where(qs[:, 0] == 0, torch.full_like(qs[:, 0], float("inf")), terms.sum(1))


class KLSearch:
    """One tensor's KL search: max |x|, the candidates t (in bins) and the
    divergence of each; the least wins, the first on a tie."""

    def __init__(self, amax: float, candidates: torch.Tensor, divergence: torch.Tensor,
                 bins: int = KL_BINS):
        self.amax, self.candidates, self.divergence, self.bins = amax, candidates, divergence, bins
        self.best = int(candidates[int(torch.argmin(divergence))])
        self.threshold = (self.best + 0.5) * amax / bins

    def excess(self, threshold: float) -> float:
        """How far the divergence at `threshold`'s candidate lies above the
        least, in nats (0 at the search's own threshold); infinite where
        `threshold` lies more than a bin from every candidate."""
        t = threshold / self.amax * self.bins - 0.5
        k = round((t - int(self.candidates[0])) / KL_STEP)
        if not 0 <= k < len(self.candidates) or abs(t - int(self.candidates[k])) > 1.0:
            return float("inf")
        return float(self.divergence[k] - self.divergence.min())


def kl_search(hist: torch.Tensor, amax: float) -> Optional[KLSearch]:
    """The KL search over an |x| histogram whose range is [0, amax]; None
    where the histogram is empty (the tensor then takes its MinMax grid)."""
    if float(hist.sum()) == 0:
        return None
    return KLSearch(amax, *kl_divergences(hist), bins=hist.numel())


def weight_grid(w: torch.Tensor, scheme: str, bits: int) -> Grid:
    """Weight grid: per tensor for uint8, per output channel for int8."""
    if scheme == "uint8":
        return act_grid(float(w.min()), float(w.max()), scheme, bits)
    qmax = 2 ** (bits - 1) - 1
    amax = w.reshape(w.shape[0], -1).abs().amax(dim=1).double()
    scale = torch.where(amax > 0, amax / qmax, torch.full_like(amax, 1e-4))
    scale = scale.float().double()  # stored as float32
    return Grid(scale, 0, -qmax, qmax)


class QT:
    """A quantized tensor: integer values held in float64, and its grid."""

    def __init__(self, q: torch.Tensor, grid: Grid):
        self.q, self.grid = q, grid

    def real(self) -> torch.Tensor:
        return (self.q - self.grid.zero) * self.grid.scale


def _chan(v, ndim: int):
    """A per-channel vector shaped to broadcast over dim 1 of an NCHW tensor,
    or a scalar as it is."""
    if isinstance(v, torch.Tensor) and v.ndim == 1:
        return v.reshape((1, -1) + (1,) * (ndim - 2))
    return v


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "silu":
        return y * torch.sigmoid(y)
    raise ValueError(f"unknown activation {act!r}")


class Ctx:
    """The ops a network is written with, in one of the three modes."""

    def __init__(self, mode: str, scheme: str = "uint8", bits: int = 8,
                 ranges: Optional[Dict[str, List[float]]] = None,
                 searches: Optional[Dict[str, KLSearch]] = None, histograms: bool = False):
        if mode not in ("calib", "quant", "count"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode, self.scheme, self.bits = mode, scheme, bits
        self.ranges: Dict[str, List[float]] = {} if ranges is None else ranges
        # KL: the search of each KL grid by name in quant mode; in calib
        # mode with `histograms`, each op output's (|x| histogram, max |x|)
        self.searches: Dict[str, KLSearch] = searches or {}
        self.hists: Optional[Dict[str, tuple]] = {} if histograms else None
        self.grids: Dict[str, Grid] = {}
        self._wcache: Dict[str, tuple] = {}
        # count mode
        self.ops = 0
        self.act_bytes = 0
        self.param_bytes = 0

    # -- grids ----------------------------------------------------------------

    def grid(self, name: str) -> Grid:
        g = self.grids.get(name)
        if g is None:
            if name in self.searches:
                g = self.grids[name] = kl_grid(self.searches[name], self.bits)
                return g
            if name not in self.ranges:
                raise KeyError(f"no calibrated range for {name!r}")
            lo, hi = self.ranges[name]
            g = self.grids[name] = act_grid(lo, hi, self.scheme, self.bits)
        return g

    def _out(self, name: str, real: torch.Tensor):
        """The op's output in this mode, from its real-valued result."""
        if self.mode == "calib":
            lo, hi = float(real.min()), float(real.max())
            r = self.ranges.get(name)
            self.ranges[name] = [lo, hi] if r is None else [min(r[0], lo), max(r[1], hi)]
            if self.hists is not None:
                if name in self.hists:
                    raise ValueError(f"{name!r}: KL calibration takes its images as one batch")
                self.hists[name] = abs_histogram(real)
            return real
        if self.mode == "count":
            self.act_bytes += 2 * real.numel()  # written once, read once
            return real
        g = self.grid(name)
        q = torch.clamp(round_away(real / g.scale) + g.zero, g.lo, g.hi)
        return QT(q, g)

    def _real(self, x):
        return x.real() if isinstance(x, QT) else x

    # -- ops ------------------------------------------------------------------

    def input(self, name: str, x):
        """The network input: fp32 in calib and count mode; in quant mode a QT,
        the integers the caller quantized on the 8-bit input grid (at
        every `bits`: the images are data, handed alike to every side)."""
        if self.mode == "quant":
            if not isinstance(x, QT):
                raise TypeError("quant mode takes the input as a QT")
            return x
        if self.mode == "calib":
            self._out(name, x)
        if self.mode == "count":
            self.act_bytes += x.numel()  # read once
        return x

    @staticmethod
    def _bias_scales(s_in: float, wg: Grid, bd: torch.Tensor) -> torch.Tensor:
        """s_in * s_w for each output channel, rounded to float32 as stored."""
        sw = torch.as_tensor(wg.scale, dtype=torch.float64, device=bd.device)
        return (s_in * sw).float().double().expand(bd.shape)

    def _weights(self, name: str, w: torch.Tensor, b: Optional[torch.Tensor], x: QT):
        """Integer weights, their grid and the int32 bias at s_in * s_w."""
        hit = self._wcache.get(name)
        if hit is not None:
            return hit
        wd = w.double()
        wg = weight_grid(wd, self.scheme, self.bits)
        s_in = x.grid.scale
        if b is not None:
            bd = b.double().reshape(-1)
            bs = self._bias_scales(s_in, wg, bd)
            over = (round_away(bd / torch.where(bs == 0, torch.ones_like(bs), bs)).abs()
                    > INT32_MAX) & (bs > 0)
            if bool(over.any()):
                need = bd.abs() / (s_in * float(BIAS_TARGET))
                if isinstance(wg.scale, torch.Tensor):
                    wg.scale = torch.where(over, torch.maximum(wg.scale, need),
                                           wg.scale).float().double()
                else:
                    sc = max(wg.scale, float(need[over].max()))
                    levels = 2**self.bits - 1
                    zero = int(np.clip(round(-min(float(wd.min()), 0.0) / sc), 0, levels))
                    wg = Grid(f32(sc), zero, 0, levels)
        sc = wg.scale.reshape(-1, 1, 1, 1) if isinstance(wg.scale, torch.Tensor) else wg.scale
        wq = torch.clamp(round_away(wd / sc) + wg.zero, wg.lo, wg.hi)
        bq = None
        if b is not None:
            bs = self._bias_scales(s_in, wg, bd)
            safe = torch.where(bs == 0, torch.ones_like(bs), bs)
            bq = torch.where(bs == 0, torch.zeros_like(bd),
                             torch.clamp(round_away(bd / safe), -INT32_MAX, INT32_MAX))
        hit = self._wcache[name] = (wq - wg.zero, wg, bq)
        return hit

    def conv(self, name: str, x, w: torch.Tensor, b: Optional[torch.Tensor],
             stride: int = 1, pad: int = 0, groups: int = 1, act: Optional[str] = None):
        if self.mode == "count":
            n, _, h, wd = x.shape
            c_out, c_in_g, kh, kw = w.shape
            oh, ow = (h + 2 * pad - kh) // stride + 1, (wd + 2 * pad - kw) // stride + 1
            taps = _taps(h, oh, kh, stride, pad) * _taps(wd, ow, kw, stride, pad)
            self.ops += 2 * n * c_out * c_in_g * taps + (n * c_out * oh * ow if b is not None else 0)
            self.param_bytes += w.numel() + (4 * b.numel() if b is not None else 0)
            return self._out(name, torch.empty((n, c_out, oh, ow), device="meta"))
        if self.mode == "calib":
            y = F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                         stride, pad, 1, groups)
            return self._out(name, _act(y, act))
        wq, wg, bq = self._weights(name, w, b, x)
        acc = F.conv2d(x.q - x.grid.zero, wq, None, stride, pad, 1, groups)
        if bq is not None:
            acc = acc + _chan(bq, 4)
        real = acc * (x.grid.scale * _chan(wg.scale, 4))
        return self._out(name, _act(real, act))

    def fc(self, name: str, x, w: torch.Tensor, b: Optional[torch.Tensor]):
        """A fully connected layer over the flattened input, as a 1x1
        convolution: the output stays [N, C_out, 1, 1]."""
        k = w.shape[1]
        shape4 = (w.shape[0], k, 1, 1)
        if self.mode == "count":
            n = x.shape[0]
            return self.conv(name, torch.empty((n, k, 1, 1), device="meta"),
                             w.reshape(shape4), b)
        if self.mode == "quant":
            x = QT(x.q.reshape(x.q.shape[0], k, 1, 1), x.grid)
        else:
            x = x.reshape(x.shape[0], k, 1, 1)
        return self.conv(name, x, w.reshape(shape4), b)

    def maxpool(self, name: str, x, k: int, stride: int, pad: int):
        if self.mode == "count":
            n, c, h, w = x.shape
            oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
            return self._out(name, torch.empty((n, c, oh, ow), device="meta"))
        return self._out(name, F.max_pool2d(self._real(x), k, stride, pad))

    def global_avgpool(self, name: str, x):
        if self.mode == "count":
            n, c = x.shape[:2]
            return self._out(name, torch.empty((n, c, 1, 1), device="meta"))
        return self._out(name, self._real(x).mean(dim=(2, 3), keepdim=True))

    def relu(self, name: str, x):
        """A ReLU of its own, requantized onto its own grid (Caffe's ReLU
        after an Eltwise sum)."""
        if self.mode == "count":
            return self._out(name, torch.empty(x.shape, device="meta"))
        return self._out(name, torch.relu(self._real(x)))

    def add(self, name: str, a, b, act: Optional[str] = None):
        if self.mode == "count":
            return self._out(name, torch.empty(a.shape, device="meta"))
        return self._out(name, _act(self._real(a) + self._real(b), act))

    def concat(self, name: str, xs):
        """Channel concat: each input requantized onto the concat's grid, as
        Tengine's uint8 concat does; in the count a view (no bytes)."""
        if self.mode == "count":
            n, _, h, w = xs[0].shape
            return torch.empty((n, sum(x.shape[1] for x in xs), h, w), device="meta")
        return self._out(name, torch.cat([self._real(x) for x in xs], 1))

    def upsample2(self, name: str, x):
        """Nearest-neighbour upsampling by 2; in the count a view."""
        if self.mode == "count":
            n, c, h, w = x.shape
            return torch.empty((n, c, 2 * h, 2 * w), device="meta")
        return self._out(name, F.interpolate(self._real(x), scale_factor=2.0, mode="nearest"))

    def space_to_depth(self, name: str, x):
        """YOLOv5's Focus slices: the four stride-2 pixel phases on channels;
        in the count a view."""
        if self.mode == "count":
            n, c, h, w = x.shape
            return torch.empty((n, 4 * c, h // 2, w // 2), device="meta")
        r = self._real(x)
        r = torch.cat((r[..., ::2, ::2], r[..., 1::2, ::2], r[..., ::2, 1::2],
                       r[..., 1::2, 1::2]), 1)
        return self._out(name, r)


def _taps(size: int, out: int, k: int, stride: int, pad: int) -> int:
    """Kernel taps that fall inside an input of `size`, summed over the
    `out` output positions of one axis."""
    return sum(sum(0 <= o * stride - pad + i < size for i in range(k)) for o in range(out))


def quantize_input(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """fp32 images onto the input grid, as integers in float64."""
    return torch.clamp(round_away(x.double() / grid.scale) + grid.zero, grid.lo, grid.hi)


def calibrate(forward, params, images: List[torch.Tensor], scheme: str) -> Dict[str, List[float]]:
    """MinMax ranges of the input and of every op output over the
    calibration images (fp32 semantics, computed in float64)."""
    ctx = Ctx("calib", scheme)
    with torch.no_grad():
        for x in images:
            forward(ctx, params, x.double())
    return ctx.ranges


def calibrate_kl(forward, params, images: torch.Tensor, scheme: str):
    """MinMax ranges and the KL search of the input and of every op output,
    over the calibration images as one batch."""
    if scheme != "int8":
        raise ValueError(f"KL calibration is for the int8 scheme, not {scheme!r}")
    ctx = Ctx("calib", scheme, histograms=True)
    with torch.no_grad():
        forward(ctx, params, images.double())
    found = {name: kl_search(h, amax) for name, (h, amax) in ctx.hists.items()}
    return ctx.ranges, {name: v for name, v in found.items() if v is not None}
