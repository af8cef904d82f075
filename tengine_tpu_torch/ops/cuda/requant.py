"""The elementwise passes around the fast tier's float64 library conv: the
CUDA kernels of csrc/requant.cu, their plain PyTorch versions, and the
wrappers that pick between them by device.

They replace no TPU kernel. The fast lowerings of ops/quantized.py compute an
exact conv (or FC) in float64 through the library, and around it:

  * qwiden: the stored integer activation -> the float64 buffer the library
    conv reads, in the layout the plain version gives it (so the library
    picks the same algorithm): "shift" x - zp_in, "raw" x, "fill" x padded
    with zp_in; with `pads`, the padded buffer (padded with 0 under "shift"
    and "raw", with zp_in under "fill");
  * qrequant: the float64 sums -> the stored integer output, by the f32
    steps of Epilogue in the order _requant_conv_out and
    lower_fc_quant_fast take them (csrc/requant.cu lists them).

On the TPU XLA fused these steps into the conv; as ATen ops they were some
17 launches a conv, each reading and writing the whole tensor. Each kernel
moves its tensor once: 1 byte in and 8 out, 8 in and 1 out (plus a residual
byte). On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor, or a meta tensor during shape inference, it runs the plain version.
qwiden.launches and qrequant.launches count kernel launches; .plain counts
plain runs on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..lowering import ACT_SILU
from ..qmath import round_away

SOURCE = "tengine_tpu_torch/csrc/requant.cu"

VEC = 8  # elements a kernel thread owns
NSTREAM = 3
MODES = ("shift", "raw", "fill")
_MAX_INDEX = 2**31 - 1


class Walk(ctypes.Structure):
    """A dense tensor's storage order and the per-level steps of the
    streams an element needs, field for field as struct Walk in
    csrc/requant.cu."""

    _fields_ = [
        ("sz", ctypes.c_int * 4),
        ("mag", ctypes.c_uint * 4),
        ("shf", ctypes.c_int * 4),
        ("base", ctypes.c_int * NSTREAM),
        ("step", (ctypes.c_int * 4) * NSTREAM),
        ("carry", (ctypes.c_int * 3) * NSTREAM),
    ]


class WidenArgs(ctypes.Structure):
    """Field for field as struct WidenArgs in csrc/requant.cu."""

    _fields_ = (
        [("x", ctypes.c_void_p), ("out", ctypes.c_void_p), ("walk", Walk)]
        + [(f, ctypes.c_int) for f in ("n", "h", "w", "x_u8", "flat", "vec_ok")]
        + [(f, ctypes.c_double) for f in ("sub", "fill")]
    )


class RequantSteps(ctypes.Structure):
    """The f32 steps from the sums to the stored integers, field for field
    as struct RequantSteps in csrc/requant_steps.cuh; qrequant's kernel and
    the fast-epilogue mode of csrc/qconv.cu's take them (steps_args)."""

    _fields_ = (
        [(f, ctypes.c_int) for f in (
            "act", "has_bias", "has_shift", "has_corr", "res_mode", "res_u8", "relu2")]
        + [(f, ctypes.c_float) for f in (
            "zp_shift", "s_out", "a_lo", "a_hi", "zp_out", "lo", "hi",
            "s_r", "zp_r", "inv2", "zp_out2", "lo2", "hi2", "beta")]
    )


class RequantArgs(ctypes.Structure):
    """Field for field as struct RequantArgs in csrc/requant.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("acc", "mult", "bias", "corr", "res", "out")]
        + [("walk", Walk)]
        + [(f, ctypes.c_int) for f in ("n", "corr_first", "vec_ok")]
        + [("steps", RequantSteps)]
    )


@dataclass(frozen=True)
class Epilogue:
    """The f32 steps from the sums to the stored integers. Scalars are the
    values the lowering holds (Python floats of f32 scales); each is rounded
    to f32 where the plain version's ATen op rounds it.

    zp_out, lo, hi, s_out: the grid the first rounding lands on (under an
    exact fused residual, the mid grid); act: -1 none, 0 relu, 1 relu1,
    n > 1 relu-n, ACT_SILU; zp_shift: subtracted where there is no bias
    vector; corr_first: the correction joins before the multiply (FC), else
    after the bias; residual: None, "exact" (s_r, zp_r, inv_s_out2 = f32
    reciprocal of the output scale, zp_out2, lo2, hi2) or "relaxed" (beta);
    relu2: the fused residual's relu."""

    zp_out: int
    lo: int
    hi: int
    out_u8: bool
    s_out: float = 1.0
    act: int = -1
    zp_shift: float = 0.0
    corr_first: bool = False
    residual: Optional[str] = None
    relu2: bool = False
    s_r: float = 0.0
    zp_r: int = 0
    inv_s_out2: float = 0.0
    zp_out2: int = 0
    lo2: int = 0
    hi2: int = 0
    beta: float = 0.0


def _f32(v: float) -> float:
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def qwiden_plain(x, *, zp_in=0, mode="raw", pads=None):
    """x: the stored activation, NHWC (any strides). The float64 buffer of
    `mode`, NHWC, padded by pads ((top, bottom), (left, right)) where given:
    "shift" and "raw" pad the NCHW view with 0 (as conv2d_nhwc does),
    "fill" the NHWC view with zp_in."""
    xf = x.to(torch.float64)
    if mode == "shift":
        xf = xf - float(zp_in)
    if pads is None:
        return xf
    (pt, pb), (pl, pr) = pads
    if mode == "fill":
        return F.pad(xf, (0, 0, pl, pr, pt, pb), value=float(zp_in))
    return F.pad(xf.permute(0, 3, 1, 2), (pl, pr, pt, pb)).permute(0, 2, 3, 1)


def qrequant_plain(acc, mult, bias, corr, residual, ep: Epilogue):
    """acc: float64 sums, NHWC or [N, O]; mult, bias: f32 [C] (bias may be
    None); corr: f32, broadcast against acc, or None; residual: the fused
    residual's stored values (acc's shape) or None. The stored integers, in
    acc's layout."""
    q = acc.to(torch.float32)
    if corr is not None and ep.corr_first:
        q = q + corr
    q = q * mult
    if bias is not None:
        q = q + bias
    elif ep.zp_shift:
        q = q - ep.zp_shift
    if corr is not None and not ep.corr_first:
        q = q + corr
    act, s_out = ep.act, ep.s_out
    if act >= 0:
        # clamp thresholds move into the pre-round domain (x/s_out)
        if act == ACT_SILU:
            # silu(v)/s_out = (v/s_out) * sigmoid(v), v = q*s_out
            q = q * torch.sigmoid(q * s_out)
        elif act == 1:
            q = torch.clamp(q, -1.0 / s_out, 1.0 / s_out)
        else:
            q = torch.clamp_min(q, 0.0)
            if act > 0:
                q = torch.clamp_max(q, float(act) / s_out)
    store = torch.uint8 if ep.out_u8 else torch.int8
    if ep.residual == "relaxed":
        # q is already folded to the final output scale and carries the
        # folded -zp_r*beta constant; add the scaled residual, round once
        y = q + residual.to(torch.float32) * ep.beta
        if ep.relu2:
            y = torch.clamp_min(y, 0.0)
        return torch.clamp(round_away(y) + ep.zp_out, ep.lo, ep.hi).to(store)
    t_pre = round_away(q) + ep.zp_out
    if ep.residual is None:
        return torch.clamp(t_pre, ep.lo, ep.hi).to(store)
    # exact fused residual: t is the quantized mid tensor; dequantize both,
    # add, requantize by the output scale's f32 reciprocal
    t = torch.clamp(t_pre, ep.lo, ep.hi)
    tf = (t - ep.zp_out) * s_out
    rf = (residual.to(torch.float32) - ep.zp_r) * ep.s_r
    y = round_away((tf + rf) * ep.inv_s_out2) + ep.zp_out2
    if ep.relu2:
        y = torch.clamp_min(y, float(ep.zp_out2))
    return torch.clamp(y, ep.lo2, ep.hi2).to(store)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def _divider(d: int) -> Tuple[int, int]:
    """(magic, shift) with (umulhi(n, magic) + n) >> shift == n // d for
    0 <= n < 2^31."""
    shift = max(0, (d - 1).bit_length())
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def storage_order(shape, stride):
    """The logical dims of a dense tensor, outermost first in memory (a dim
    of size 1 goes outermost); raises if the tensor is not dense."""
    dims = sorted(range(len(shape)), key=lambda d: (shape[d] != 1, -stride[d]))
    expect = 1
    for d in reversed(dims):
        if shape[d] != 1 and stride[d] != expect:
            raise ValueError(f"requant: strides {tuple(stride)} of shape {tuple(shape)} are not dense")
        expect *= shape[d]
    return dims


def make_walk(shape, stride, streams) -> Walk:
    """The Walk over a dense 4-D tensor of `shape`/`stride`; streams is a
    list of (base, per-logical-dim step), at most NSTREAM."""
    order = storage_order(shape, stride)
    w = Walk()
    for k, d in enumerate(order):
        w.sz[k] = int(shape[d])
        w.mag[k], w.shf[k] = _divider(int(shape[d])) if k else (1, 0)
    for s, (base, steps) in enumerate(streams):
        w.base[s] = int(base)
        st = [int(steps[d]) for d in order]
        for k in range(4):
            w.step[s][k] = st[k]
        for k in range(3):
            w.carry[s][k] = st[k] - w.sz[k + 1] * st[k + 1]
    return w


def _check(cond, what):
    if not cond:
        raise ValueError(what)


def _span(t) -> int:
    """The largest element offset a view of t reaches."""
    return sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))


# ---------------------------------------------------------------------------
# qwiden
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def widen_layout(shape, stride, mode, pads):
    """The shape and strides of qwiden_plain's buffer for an input of this
    shape and these strides: the layout the kernel writes."""
    x = torch.empty_strided(shape, stride, dtype=torch.uint8, device="meta")
    y = qwiden_plain(x, zp_in=1, mode=mode, pads=pads)
    return tuple(y.shape), tuple(y.stride())


def _launch_widen(x, zp_in, mode, pads):
    from .build import load

    _check(x.dtype in (torch.int8, torch.uint8) and x.ndim == 4,
           "qwiden: x must be a 4-D int8/uint8 NHWC tensor")
    (pt, pb), (pl, pr) = pads or ((0, 0), (0, 0))
    _check(min(pt, pb, pl, pr) >= 0, f"qwiden: pads {pads} must be >= 0")
    shape, stride = widen_layout(tuple(x.shape), tuple(x.stride()), mode, pads)
    out = torch.empty_strided(shape, stride, dtype=torch.float64, device=x.device)
    n = out.numel()
    _check(n <= _MAX_INDEX and _span(x) <= _MAX_INDEX, "qwiden: more than 2^31 elements")
    _, h, w, _ = map(int, x.shape)
    sx = x.stride()
    flat = pads is None and tuple(x.stride()) == tuple(stride)
    vec_ok = out.data_ptr() % 16 == 0 and (not flat or x.data_ptr() % 2 == 0)
    walk = make_walk(shape, stride, [
        (-pt * sx[1] - pl * sx[2], sx),
        (-pt, (0, 1, 0, 0)),
        (-pl, (0, 0, 1, 0)),
    ])
    sub = float(zp_in) if mode == "shift" else 0.0
    fill = float(zp_in) if mode == "fill" else 0.0
    args = WidenArgs(x=x.data_ptr(), out=out.data_ptr(), walk=walk, n=n, h=h, w=w,
                     x_u8=int(x.dtype == torch.uint8), flat=int(flat), vec_ok=int(vec_ok),
                     sub=sub, fill=fill)
    fn = load("requant").qwiden_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(WidenArgs), ctypes.c_void_p]
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qwiden: kernel launch failed with CUDA error {rc}")
    return out


def qwiden(x, *, zp_in=0, mode="raw", pads=None):
    """The float64 buffer of `mode` (MODES) for the stored activation x
    (NHWC, any strides), padded by `pads` where given: qwiden_plain's values
    in qwiden_plain's layout. A CUDA tensor launches the kernel (or raises)."""
    _check(mode in MODES, f"qwiden: mode {mode!r} not in {MODES}")
    pads = None if pads is None else tuple(map(tuple, pads))
    if x.is_cuda:
        out = _launch_widen(x, zp_in, mode, pads)
        qwiden.launches += 1
        return out
    if x.device.type in ("cpu", "meta"):
        qwiden.plain += x.device.type == "cpu"
        return qwiden_plain(x, zp_in=zp_in, mode=mode, pads=pads)
    raise ValueError(f"qwiden: no version for device {x.device}")


qwiden.launches = 0
qwiden.plain = 0


def qwiden_for_conv(x, *, zp_in=0, mode="raw", pads):
    """The float64 buffer a library conv reads (qwiden), and the pads the
    conv still applies: asymmetric pads are written into the buffer, as
    conv2d_nhwc's F.pad wrote them; symmetric ones stay the conv's."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        return qwiden(x, zp_in=zp_in, mode=mode), pads
    return qwiden(x, zp_in=zp_in, mode=mode, pads=pads), ((0, 0), (0, 0))


# ---------------------------------------------------------------------------
# qrequant
# ---------------------------------------------------------------------------


def act_bounds(act: int, s_out: float) -> Tuple[float, float]:
    """The activation clamp's thresholds as the plain version's clamp takes
    them: computed in double, then rounded to f32."""
    if act == 1:
        return _f32(-1.0 / s_out), _f32(1.0 / s_out)
    if act > 1 and act != ACT_SILU:
        return 0.0, _f32(float(act) / s_out)
    return 0.0, 0.0


def _as4(t):
    """A 2-D [N, O] tensor as [N, 1, 1, O]."""
    return t[:, None, None, :] if t.ndim == 2 else t


def steps_args(ep: Epilogue, *, has_bias: bool, has_corr: bool = False,
               res_u8: bool = False) -> RequantSteps:
    """Epilogue ep as the kernels' RequantSteps: has_bias, a bias vector
    (else the zp_shift, where there is one); has_corr, a correction added
    after the bias; res_u8, the fused residual's dtype."""
    a_lo, a_hi = act_bounds(ep.act, ep.s_out)
    return RequantSteps(
        act=int(ep.act), has_bias=int(has_bias), has_shift=int(not has_bias and bool(ep.zp_shift)),
        has_corr=int(has_corr), res_mode={None: 0, "exact": 1, "relaxed": 2}[ep.residual],
        res_u8=int(res_u8), relu2=int(ep.relu2),
        zp_shift=_f32(ep.zp_shift), s_out=_f32(ep.s_out), a_lo=a_lo, a_hi=a_hi,
        zp_out=float(ep.zp_out), lo=float(ep.lo), hi=float(ep.hi),
        s_r=_f32(ep.s_r), zp_r=float(ep.zp_r), inv2=_f32(ep.inv_s_out2),
        zp_out2=float(ep.zp_out2), lo2=float(ep.lo2), hi2=float(ep.hi2), beta=_f32(ep.beta),
    )


def _launch_requant(acc, mult, bias, corr, residual, ep: Epilogue):
    from .build import load

    _check(acc.dtype == torch.float64 and acc.ndim in (2, 4),
           "qrequant: acc must be float64, NHWC or [N, O]")
    a4 = _as4(acc)
    shape, C = tuple(a4.shape), int(a4.shape[3])
    _check(mult is not None, "qrequant: mult is required")
    for nm, v in (("mult", mult), ("bias", bias)):
        _check(v is None or (v.dtype == torch.float32 and tuple(v.shape) == (C,)
                             and v.is_contiguous() and v.device == acc.device),
               f"qrequant: {nm} must be a contiguous f32 [{C}] on acc's device")
    _check(ep.residual is None or (residual is not None and tuple(residual.shape) == tuple(acc.shape)
                                   and residual.dtype in (torch.int8, torch.uint8)),
           "qrequant: the fused residual must be int8/uint8 of acc's shape")
    out = torch.empty_like(acc, dtype=torch.uint8 if ep.out_u8 else torch.int8)
    n = acc.numel()
    _check(n <= _MAX_INDEX, "qrequant: more than 2^31 elements")
    chan = (0, 0, 0, 1)
    streams = [(0, chan), (0, chan), (0, (0, 0, 0, 0))]
    if corr is not None:
        _check(corr.dtype == torch.float32 and corr.device == acc.device,
               "qrequant: corr must be f32 on acc's device")
        streams[1] = (0, _as4(corr.expand(acc.shape)).stride())
    if residual is not None and ep.residual is not None:
        _check(_span(residual) <= _MAX_INDEX, "qrequant: residual spans more than 2^31 elements")
        streams[2] = (0, _as4(residual).stride())
    walk = make_walk(shape, a4.stride(), streams)
    corr_first = ep.corr_first and corr is not None
    args = RequantArgs(
        acc=acc.data_ptr(), mult=mult.data_ptr(), bias=0 if bias is None else bias.data_ptr(),
        corr=0 if corr is None else corr.data_ptr(),
        res=0 if ep.residual is None else residual.data_ptr(), out=out.data_ptr(), walk=walk,
        n=n, corr_first=int(corr_first),
        vec_ok=int(acc.data_ptr() % 16 == 0 and out.data_ptr() % 8 == 0),
        steps=steps_args(ep, has_bias=bias is not None,
                         has_corr=corr is not None and not corr_first,
                         res_u8=residual is not None and residual.dtype == torch.uint8),
    )
    fn = load("requant").qrequant_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(RequantArgs), ctypes.c_void_p]
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qrequant: kernel launch failed with CUDA error {rc}")
    return out


def qrequant(acc, mult, bias, corr, residual, ep: Epilogue):
    """The stored integer output of the float64 sums acc (NHWC or [N, O]),
    by Epilogue ep: qrequant_plain's values in acc's layout. A CUDA tensor
    launches the kernel (or raises)."""
    if acc.is_cuda:
        out = _launch_requant(acc, mult, bias, corr, residual, ep)
        qrequant.launches += 1
        return out
    if acc.device.type in ("cpu", "meta"):
        qrequant.plain += acc.device.type == "cpu"
        return qrequant_plain(acc, mult, bias, corr, residual, ep)
    raise ValueError(f"qrequant: no version for device {acc.device}")


qrequant.launches = 0
qrequant.plain = 0
