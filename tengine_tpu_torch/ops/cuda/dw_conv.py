"""Quantized depthwise k×k convolution with fused requantization: the CUDA
kernel csrc/dw_conv.cu, its plain PyTorch version, and the wrapper that picks
between them by device.

Replaces the Pallas TPU kernel dw_qconv_hwcn of
tengine_tpu/ops/pallas/dw_conv.py (k in {3, 5}, stride 1/2):

    acc = sum_taps x[.., c] * w[tap, c]     exact; border taps read zp_in
    q   = acc * M[c] + B[c]                 two f32 roundings
    q   = activation clamp around 0         -1 none, 0 relu, 1 clip ±1/s_out,
                                            n > 1 relu-n (requant domain)
    out = clip(round_half_away(q) + zp_out, lo, hi)

x holds the raw stored values, int8 or uint8; w the true tap values
w_q - zp_w (pack_dw_taps); M and B are the host folds of ops/quantized.py
(dwp_m / dwp_b), B carrying the bias and the -zp_in·colsum(w)·M term but not
zp_out, which is added after the round.

On the card the work is bound by bytes (each activation byte read once and
written once for k² multiply-adds). The TPU kernel's [H, W, C, N]
batch-in-lanes layout, its transposes, halo DMA and row bands do not carry
over: the kernel reads and writes NHWC bytes, takes any N and C, and pads
with zp_in wherever a tap leaves the image (design note in csrc/dw_conv.cu).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..qmath import round_away

SOURCE = "tengine_tpu_torch/csrc/dw_conv.cu"
REPLACES = "tengine_tpu/ops/pallas/dw_conv.py:243"

CV = 4  # channels per kernel thread: tap rows pad to a multiple


class DwArgs(ctypes.Structure):
    """The kernel's argument block, field for field as struct DwArgs in
    csrc/dw_conv.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("x", "w", "mult", "bias", "out")]
        + [(f, ctypes.c_int) for f in (
            "n", "h", "w_in", "c", "oh", "ow", "cp", "k", "stride", "pad_t", "pad_l",
            "zp_in", "act", "x_u8")]
        + [(f, ctypes.c_float) for f in ("act_lo", "act_hi", "zp_out", "lo", "hi")]
    )


def pack_dw_taps(w_true: np.ndarray) -> np.ndarray:
    """Host-side repack: [C, 1, k, k] true tap values (stored weight minus
    its zero point, integers within ±255) -> [k*k, Cp] int16, tap order
    (ky, kx), channels zero-padded to Cp = C rounded up to a multiple of 4."""
    w = np.asarray(w_true)
    C, one, k, k2 = w.shape
    if one != 1 or k != k2:
        raise ValueError(f"pack_dw_taps: expected [C, 1, k, k], got {w.shape}")
    taps = np.rint(w[:, 0].astype(np.float64)).astype(np.int64)
    if np.abs(taps).max(initial=0) > 255 or not np.array_equal(taps, w[:, 0]):
        raise ValueError("pack_dw_taps: taps must be integers within ±255")
    out = np.zeros((k * k, (C + CV - 1) // CV * CV), np.int16)
    out[:, :C] = taps.transpose(1, 2, 0).reshape(k * k, C)
    return out


def act_bounds(act: Optional[int], s_out: float) -> Tuple[float, float]:
    """The activation clamp's thresholds in the requant domain, around 0
    (zp_out joins after the round): computed in double, then rounded to f32,
    as the Pallas kernel's static arguments are."""
    if act is None or act < 0:
        return 0.0, 0.0
    if act == 1:
        return float(np.float32(-1.0 / s_out)), float(np.float32(1.0 / s_out))
    return 0.0, float(np.float32(float(act) / s_out))


def _out_hw(H, W, k, stride, pad_t, pad_b, pad_l, pad_r):
    return (H + pad_t + pad_b - k) // stride + 1, (W + pad_l + pad_r - k) // stride + 1


def dw_qconv_plain(x, w, mult, bias, *, k, stride=1, pad_t=0, pad_b=0, pad_l=0, pad_r=0,
                   zp_in=0, zp_out=0, act=-1, s_out=1.0, lo=-128.0, hi=127.0, out_u8=False):
    """The plain PyTorch version of dw_qconv: same inputs, same result. The
    input is padded with zp_in, a float64 grouped conv sums exactly, and the
    f32 epilogue runs op for op as the kernel's does."""
    N, H, W, C = map(int, x.shape)
    xs = F.pad(x.to(torch.float64).permute(0, 3, 1, 2), (pad_l, pad_r, pad_t, pad_b),
               value=float(zp_in))
    wt = w[:, :C].to(torch.float64).t().reshape(C, 1, k, k)
    acc = F.conv2d(xs, wt, stride=stride, groups=C).permute(0, 2, 3, 1).to(torch.float32)
    q = acc * mult + bias
    if act is not None and act >= 0:
        a_lo, a_hi = act_bounds(act, s_out)
        if act == 1:
            q = torch.clamp(q, a_lo, a_hi)
        else:
            q = torch.clamp_min(q, 0.0)
            if act > 0:
                q = torch.clamp_max(q, a_hi)
    y = torch.clamp(round_away(q) + float(zp_out), float(lo), float(hi))
    return y.to(torch.uint8 if out_u8 else torch.int8)


def _check(cond, what):
    if not cond:
        raise ValueError(f"dw_qconv: {what}")


def _launch(x, w, mult, bias, *, k, stride, pad_t, pad_b, pad_l, pad_r, zp_in, zp_out, act,
            s_out, lo, hi, out_u8):
    """Check the operands and launch csrc/dw_conv.cu's kernel on the current
    stream. Raises on what the kernel does not take, and if the launch
    returns a CUDA error."""
    from .build import load

    N, H, W, C = map(int, x.shape)
    OH, OW = _out_hw(H, W, k, stride, pad_t, pad_b, pad_l, pad_r)
    cp = (C + CV - 1) // CV * CV
    _check(k in (3, 5) and stride in (1, 2), f"k={k} stride={stride}: k in {{3, 5}}, stride 1 or 2")
    _check(x.dtype in (torch.int8, torch.uint8) and x.is_contiguous(),
           "x must be a contiguous int8/uint8 NHWC tensor")
    _check(w.dtype == torch.int16 and tuple(w.shape) == (k * k, cp) and w.is_contiguous()
           and w.data_ptr() % 8 == 0, f"w must be contiguous 8-byte-aligned int16 [{k * k}, {cp}]")
    for nm, v in (("mult", mult), ("bias", bias)):
        _check(v.dtype == torch.float32 and tuple(v.shape) == (C,) and v.is_contiguous(),
               f"{nm} must be contiguous f32 [{C}]")
    _check(all(t.device == x.device for t in (w, mult, bias)), "all operands must be on one device")
    _check(min(pad_t, pad_b, pad_l, pad_r) >= 0 and OH >= 1 and OW >= 1,
           f"pads {(pad_t, pad_b, pad_l, pad_r)} give an empty output {OH}x{OW}")

    out = torch.empty((N, OH, OW, C), dtype=torch.uint8 if out_u8 else torch.int8, device=x.device)
    a_lo, a_hi = act_bounds(act, s_out)
    args = DwArgs(
        x=x.data_ptr(), w=w.data_ptr(), mult=mult.data_ptr(), bias=bias.data_ptr(),
        out=out.data_ptr(), n=N, h=H, w_in=W, c=C, oh=OH, ow=OW, cp=cp, k=k, stride=stride,
        pad_t=pad_t, pad_l=pad_l, zp_in=int(zp_in), act=-1 if act is None else int(act),
        x_u8=int(x.dtype == torch.uint8), act_lo=a_lo, act_hi=a_hi, zp_out=float(zp_out),
        lo=float(lo), hi=float(hi),
    )
    vec = int(C % CV == 0 and x.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0)

    fn = load("dw_conv").dw_qconv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(DwArgs), ctypes.c_int, ctypes.c_void_p]
    rc = fn(ctypes.byref(args), vec, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dw_qconv: kernel launch failed with CUDA error {rc}")
    return out


def dw_qconv(x, w, mult, bias, *, k, stride=1, pad_t=0, pad_b=0, pad_l=0, pad_r=0,
             zp_in=0, zp_out=0, act=-1, s_out=1.0, lo=-128.0, hi=127.0, out_u8=False):
    """Depthwise conv + requant: x [N, H, W, C] int8/uint8 raw quantized
    activations, w [k*k, Cp] int16 from pack_dw_taps, mult/bias f32 [C].
    Returns [N, OH, OW, C] int8 (uint8 with out_u8).

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor,
    or a meta tensor during shape inference, it runs dw_qconv_plain.
    dw_qconv.launches counts kernel launches."""
    kw = dict(k=k, stride=stride, pad_t=pad_t, pad_b=pad_b, pad_l=pad_l, pad_r=pad_r,
              zp_in=zp_in, zp_out=zp_out, act=act, s_out=s_out, lo=lo, hi=hi, out_u8=out_u8)
    if x.is_cuda:
        out = _launch(x, w, mult, bias, **kw)
        dw_qconv.launches += 1
        return out
    if x.device.type in ("cpu", "meta"):
        return dw_qconv_plain(x, w, mult, bias, **kw)
    raise ValueError(f"dw_qconv: no version for device {x.device}")


dw_qconv.launches = 0
