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

On the card this is bound by bytes on paper: the yolov5s-640 batch-8 stem
moves 9.8 MB of input and 26.2 MB of output for 2.83 G multiply-adds. The
kernel (source note in csrc/stem_conv.cu) is an implicit GEMM on the int8
tensor cores (mma.sync): persistent blocks gather the patch rows from an
input band staged twice in shared memory (as is and shifted by two bytes, so
that every 4 taps are one aligned word), and the weights are the Pallas
packing's own int8 matrix, with its ones column for uint8 weights, so that
acc = acc_stored + (128 - zp_w) * patchsum.
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
THREADS = 256
NCH = 32  # output channels a block computes: four n-tiles, then the ones column
MAX_TC = 320  # output columns of a block tile


class StemArgs(ctypes.Structure):
    """The kernel's argument block, field for field as struct StemArgs in
    csrc/stem_conv.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("x", "w", "mult", "bias", "out")]
        + [(f, ctypes.c_int) for f in (
            "n", "c", "h", "w_in", "cout", "k", "pad", "kp", "ce", "w_corr", "act", "zp_in",
            "zp_out", "out_kind", "signed_in", "tr", "tc")]
        + [(f, ctypes.c_float) for f in ("s_out", "act_lo", "act_hi", "lo", "hi")]
    )


def pack_stem_weights(w_q, mult, bias, *, k, zp_in, zp_w, signed_in):
    """Host-side packing, the Pallas kernel's own: [Cout, C, k, k] stored
    weights -> the int8 K-matrix [Kp, Ce] (row (c*k + u)*k + v, Kp = C*k*k
    rounded up to 8, Ce = Cout (+1 for the ones column) rounded up to 8 below
    128), the requant multiplier and the fully folded bias, f32 [Cout], and
    w_corr.

    zp_w == 0: the matrix holds the true weights (they must fit int8).
    zp_w != 0 (uint8 weights): it holds the stored weights re-centred, w_q -
    128, and a ones column at Cout gives each pixel's patch sum, so that
      acc_true = acc_stored + w_corr * patchsum,  w_corr = 128 - zp_w.
    All constant corrections fold into the bias (exact):
      acc_true = acc + (c0 - zp_in) * rowsum(W_true)   (c0 = 128 for uint8 input)"""
    Cout, C = int(w_q.shape[0]), int(w_q.shape[1])
    c0 = 0 if signed_in else 128
    kk = C * k * k
    kp = (kk + 7) // 8 * 8
    w_np = np.asarray(w_q, np.float32) - float(zp_w)  # true weight values
    n_slots = Cout + (1 if zp_w else 0)
    ce = n_slots if n_slots >= 128 else (n_slots + 7) // 8 * 8
    wmat = np.zeros((kp, ce), np.float32)
    src = w_np
    w_corr = 0
    if zp_w:
        src = np.asarray(w_q, np.float32) - 128.0
        wmat[:kk, Cout] = 1.0
        w_corr = 128 - int(zp_w)
    wmat[:kk, :Cout] = src.reshape(Cout, kk).T
    if wmat.min() < -128 or wmat.max() > 127 or not np.array_equal(wmat, np.rint(wmat)):
        raise ValueError("pack_stem_weights: the stored weights must fit int8")

    mult = np.asarray(mult, np.float32)
    rowsum = w_np.reshape(Cout, -1).sum(axis=1)
    b_fold = np.asarray(bias, np.float32) + (c0 - zp_in) * rowsum * mult
    return wmat.astype(np.int8), mult.copy(), np.asarray(b_fold, np.float32), w_corr


def stem_true_weights(w: torch.Tensor, cout: int, c: int, k: int, w_corr: int) -> torch.Tensor:
    """The true weights [Cout, C, k, k] (float64) back from the packed
    matrix: stored + w_corr where a ones column is present."""
    kk = c * k * k
    return (w[:kk, :cout].to(torch.float64).t() + float(w_corr)).reshape(cout, c, k, k)


def pick_stem_tile(oh: int, ow: int) -> tuple:
    """The kernel's block tile (output rows, output columns): two rows of at
    most MAX_TC columns, the columns split evenly. A pure function of the
    output shape."""
    tc = -(-ow // -(-ow // MAX_TC))
    return min(2, oh), tc


def stem_smem_bytes(c: int, k: int, tr: int, tc: int, f32: bool) -> int:
    """Shared memory of one block, as struct Layout in csrc/stem_conv.cu
    computes it: a tile's raw input rows, the band twice (rows padded to 8
    mod 32 words, each copy to 16 mod 32), the reordered weights, M and B,
    the warps' output buffers."""
    qk = (k + 3) // 4
    nks = -(-(c * k * qk) // 8)
    rows_in = 2 * (tr - 1) + k
    wwp = (tc - 1) // 2 + qk + 1
    wwp += (8 - wwp % 32) % 32
    raw = (c * rows_in * (wwp + 1) + 3) // 4 * 4
    copy = c * rows_in * wwp
    copy += (16 - copy % 32) % 32
    wmat = (NCH // 8 + 1) * 8 * (nks * 8 + 4)
    obuf = THREADS // 32 * 16 * (36 if f32 else 12)
    return 4 * (raw + 2 * copy + wmat + 2 * NCH + obuf)


def _out_dtype(lo: float, out_f32: bool) -> torch.dtype:
    if out_f32:
        return torch.float32
    return torch.int8 if lo < 0 else torch.uint8


def stem_qconv_plain(
    x: torch.Tensor,  # [B, C, H, W] int8/uint8 (raw quantized values)
    w: torch.Tensor,  # [Kp, Ce] int8 from pack_stem_weights
    m: torch.Tensor,  # [Cout] f32
    b: torch.Tensor,  # [Cout] f32
    *,
    k: int,
    pad: int,
    w_corr: int = 0,
    act: int = -1,
    s_out: float = 1.0,
    zp_in: int = 0,
    zp_out: int = 0,
    lo: float = -128.0,
    hi: float = 127.0,
    out_f32: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same inputs, same result.
    float64 holds every product and sum exactly, so the conv with the true
    weights (stem_true_weights) is the exact integer accumulation. Returns
    NHWC [B, H/2, W/2, Cout]."""
    B, C, H, W = map(int, x.shape)
    Cout = int(m.shape[0])
    c0 = 0 if x.dtype == torch.int8 else 128
    xs = F.pad(x.to(torch.float64) - c0, (pad, pad, pad, pad), value=float(zp_in - c0))
    wt = stem_true_weights(w, Cout, C, k, w_corr)
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


def _launch(x, w, m, b, *, k, pad, w_corr, act, s_out, zp_in, zp_out, lo, hi, out_f32):
    """Check the operands and launch csrc/stem_conv.cu's kernel on the
    current stream. Raises on what the kernel does not take, and if the
    launch returns a CUDA error."""
    from .build import load

    B, C, H, W = map(int, x.shape)
    Cout = int(m.shape[0])
    kp, ce = (C * k * k + 7) // 8 * 8, int(w.shape[-1])
    if x.dtype not in (torch.int8, torch.uint8) or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("stem_qconv: x must be a contiguous NCHW int8/uint8 tensor")
    if not (1 <= C <= 4 and 1 <= k <= 7 and k <= 2 * pad + 2 and H >= 2 and W >= 2
            and H % 2 == 0 and W % 2 == 0):
        raise ValueError(f"stem_qconv: unsupported geometry C={C} k={k} pad={pad} H={H} W={W}")
    if (w.dtype != torch.int8 or w.ndim != 2 or int(w.shape[0]) != kp
            or ce < Cout + (1 if w_corr else 0) or not w.is_contiguous()):
        raise ValueError(f"stem_qconv: w must be pack_stem_weights' contiguous int8 [{kp}, Ce]")
    for name, v in (("m", m), ("b", b)):
        if v.dtype != torch.float32 or tuple(v.shape) != (Cout,) or not v.is_contiguous():
            raise ValueError(f"stem_qconv: {name} must be contiguous f32 [Cout]")
    if any(t.device != x.device for t in (w, m, b)):
        raise ValueError("stem_qconv: all operands must be on one device")

    act = -1 if act is None else int(act)
    act_lo, act_hi = (-1.0 / s_out, 1.0 / s_out) if act == 1 else (0.0, float(act) / s_out)
    dtype = _out_dtype(lo, out_f32)
    out = torch.empty((B, H // 2, W // 2, Cout), dtype=dtype, device=x.device)
    tr, tc = pick_stem_tile(H // 2, W // 2)
    args = StemArgs(
        x=x.data_ptr(), w=w.data_ptr(), mult=m.data_ptr(), bias=b.data_ptr(), out=out.data_ptr(),
        n=B, c=C, h=H, w_in=W, cout=Cout, k=k, pad=pad, kp=kp, ce=ce, w_corr=int(w_corr),
        act=act, zp_in=int(zp_in), zp_out=int(zp_out), out_kind=_OUT_KIND[dtype],
        signed_in=int(x.dtype == torch.int8), tr=tr, tc=tc, s_out=s_out, act_lo=act_lo,
        act_hi=act_hi, lo=float(lo), hi=float(hi),
    )

    fn = load("stem_conv").stem_qconv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(StemArgs), ctypes.c_void_p]
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream)
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
    w_corr: int = 0,
    act: int = -1,
    s_out: float = 1.0,
    zp_in: int = 0,
    zp_out: int = 0,
    lo: float = -128.0,
    hi: float = 127.0,
    out_f32: bool = False,
) -> torch.Tensor:
    """Whole quantized stem: conv(k×k, stride 2, pad) + requant epilogue,
    with the weights, multiplier, bias and w_corr of pack_stem_weights.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor,
    or a meta tensor during shape inference, it runs stem_qconv_plain.
    stem_qconv.launches counts kernel launches."""
    kw = dict(k=k, pad=pad, w_corr=w_corr, act=act, s_out=s_out, zp_in=zp_in, zp_out=zp_out,
              lo=lo, hi=hi, out_f32=out_f32)
    if x.is_cuda:
        return _launch(x, w, m, b, **kw)
    if x.device.type in ("cpu", "meta"):
        return stem_qconv_plain(x, w, m, b, **kw)
    raise ValueError(f"stem_qconv: no version for device {x.device}")


stem_qconv.launches = 0
