"""Fused quantized stem convolution: the CUDA kernel csrc/stem_conv.cu, its
plain PyTorch version, and the wrapper that picks between them by device.

Replaces the Pallas TPU kernel tengine_tpu/ops/pallas/stem_conv.py:
stem_qconv_packed — the first layer of a quantized conv net (stride 2,
k <= 7, C_in <= 4, k <= 2*pad + 2), NCHW s8/u8 input, NHWC output:

    out = clip(round_half_away(act(acc * M[c] + B[c])) + zp_out, lo, hi)
    acc = sum (x - c0) * (w - zp_w)        exact int32, padding = zp_in

with c0 = 128 re-centring unsigned input (0 for signed) and the constant
(c0 - zp_in) * rowsum(w) * M folded into B on the host, exactly as
pack_stem_weights folds it for the Pallas kernel — so the f32 epilogue sees
the same operands and both give the same integers.

On the card this is bound by bytes: the yolov5s-640 batch-8 stem moves
9.8 MB of input and 26.2 MB of output for 5.7 G integer operations. The
kernel's design (source note in csrc/stem_conv.cu) keeps the output — most
of those bytes — in coalesced 16-byte stores; its int32 multiply-adds are
the limit of this first version. None of the TPU layout tricks (int16 lane
pair-packs, byte-split deinterleave, patch scratch, ones column for uint8
weights) carry over: the kernel reads the input band straight into shared
memory and keeps weights as int16 true values.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..qmath import round_away

SOURCE = "tengine_tpu_torch/csrc/stem_conv.cu"
REPLACES = "tengine_tpu/ops/pallas/stem_conv.py:166"

_OUT_KIND = {torch.int8: 0, torch.uint8: 1, torch.float32: 2}
# stem_qconv_launch(x, w, m, b, out, B, C, H, W, Cout, k, pad, act, s_out,
#   act_lo, act_hi, zp_in, zp_out, lo, hi, out_kind, signed_in, stream)
_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)


def pack_stem_weights(w_q, mult, bias, *, k, zp_in, zp_w, signed_in):
    """Host-side packing: [Cout, C, k, k] stored weights -> true-valued int16
    [Cout, C*k*k] (tap order (c, u, v)), and the requant multiplier and
    fully folded bias rows, f32 [Cout].

    All constant corrections fold into the bias as in the Pallas packing:
      acc_true = acc_stored + (c0 - zp_in) * rowsum(W_true)."""
    Cout = int(w_q.shape[0])
    c0 = 0 if signed_in else 128
    w_np = np.asarray(w_q, np.float32) - float(zp_w)  # true weight values
    assert w_np.min() >= -255 and w_np.max() <= 255, "weights must be 8-bit"
    kk = w_np.shape[1] * k * k
    wmat = np.ascontiguousarray(w_np.reshape(Cout, kk).astype(np.int16))

    mult = np.asarray(mult, np.float32)
    rowsum = w_np.reshape(Cout, -1).sum(axis=1)
    b_fold = np.asarray(bias, np.float32) + (c0 - zp_in) * rowsum * mult
    return wmat, mult.copy(), np.asarray(b_fold, np.float32)


def _out_dtype(lo: float, out_f32: bool) -> torch.dtype:
    if out_f32:
        return torch.float32
    return torch.int8 if lo < 0 else torch.uint8


def stem_qconv_plain(
    x: torch.Tensor,  # [B, C, H, W] int8/uint8 (raw quantized values)
    w: torch.Tensor,  # [Cout, C*k*k] int16 from pack_stem_weights
    m: torch.Tensor,  # [Cout] f32
    b: torch.Tensor,  # [Cout] f32
    *,
    k: int,
    pad: int,
    act: int = -1,
    s_out: float = 1.0,
    zp_in: int = 0,
    zp_out: int = 0,
    lo: float = -128.0,
    hi: float = 127.0,
    out_f32: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same inputs, same result.
    float64 holds every product and sum exactly, so the conv is the exact
    integer accumulation. Returns NHWC [B, H/2, W/2, Cout]."""
    B, C, H, W = map(int, x.shape)
    Cout = int(w.shape[0])
    c0 = 0 if x.dtype == torch.int8 else 128
    xs = F.pad(x.to(torch.float64) - c0, (pad, pad, pad, pad), value=float(zp_in - c0))
    wt = w.to(torch.float64).reshape(Cout, C, k, k)
    acc = F.conv2d(xs, wt, stride=2)[:, :, : H // 2, : W // 2]
    acc = acc.to(torch.float32).permute(0, 2, 3, 1)
    q = acc * m + b
    if act is not None and act >= 0:
        if act == 100:  # fused SiLU
            q = q * torch.sigmoid(q * s_out)
        elif act == 1:
            q = torch.clamp(q, -1.0 / s_out, 1.0 / s_out)
        else:
            q = torch.clamp_min(q, 0.0)
            if act > 0:
                q = torch.clamp_max(q, float(act) / s_out)
    q = torch.clamp(round_away(q) + zp_out, lo, hi)
    return q.to(_out_dtype(lo, out_f32)).contiguous()


def _launch(x, w, m, b, *, k, pad, act, s_out, zp_in, zp_out, lo, hi, out_f32):
    from .build import load

    B, C, H, W = map(int, x.shape)
    Cout = int(w.shape[0])
    if x.dtype not in (torch.int8, torch.uint8) or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("stem_qconv: x must be a contiguous NCHW int8/uint8 tensor")
    if not (C <= 4 and k <= 7 and k <= 2 * pad + 2 and H % 2 == 0 and W % 2 == 0):
        raise ValueError(f"stem_qconv: unsupported geometry C={C} k={k} pad={pad} H={H} W={W}")
    if w.dtype != torch.int16 or tuple(w.shape) != (Cout, C * k * k) or not w.is_contiguous():
        raise ValueError("stem_qconv: w must be contiguous int16 [Cout, C*k*k]")
    for name, v in (("m", m), ("b", b)):
        if v.dtype != torch.float32 or tuple(v.shape) != (Cout,) or not v.is_contiguous():
            raise ValueError(f"stem_qconv: {name} must be contiguous f32 [Cout]")
    if any(t.device != x.device for t in (w, m, b)):
        raise ValueError("stem_qconv: all operands must be on one device")

    act = -1 if act is None else int(act)
    act_lo, act_hi = (-1.0 / s_out, 1.0 / s_out) if act == 1 else (0.0, float(act) / s_out)
    dtype = _out_dtype(lo, out_f32)
    out = torch.empty((B, H // 2, W // 2, Cout), dtype=dtype, device=x.device)

    fn = load("stem_conv").stem_qconv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(
        x.data_ptr(), w.data_ptr(), m.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, C, H, W, Cout, k, pad, act,
        s_out, act_lo, act_hi,
        int(zp_in), int(zp_out),
        float(lo), float(hi),
        _OUT_KIND[dtype], int(x.dtype == torch.int8),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"stem_qconv: kernel launch failed with CUDA error {rc}")
    stem_qconv.launches += 1
    return out


def stem_qconv(
    x: torch.Tensor,
    w: torch.Tensor,
    m: torch.Tensor,
    b: torch.Tensor,
    *,
    k: int,
    pad: int,
    act: int = -1,
    s_out: float = 1.0,
    zp_in: int = 0,
    zp_out: int = 0,
    lo: float = -128.0,
    hi: float = 127.0,
    out_f32: bool = False,
) -> torch.Tensor:
    """Whole quantized stem: conv(k×k, stride 2, pad) + requant epilogue.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor,
    or a meta tensor during shape inference, it runs stem_qconv_plain.
    stem_qconv.launches counts kernel launches."""
    kw = dict(k=k, pad=pad, act=act, s_out=s_out, zp_in=zp_in, zp_out=zp_out,
              lo=lo, hi=hi, out_f32=out_f32)
    if x.is_cuda:
        return _launch(x, w, m, b, **kw)
    if x.device.type in ("cpu", "meta"):
        return stem_qconv_plain(x, w, m, b, **kw)
    raise ValueError(f"stem_qconv: no version for device {x.device}")


stem_qconv.launches = 0
