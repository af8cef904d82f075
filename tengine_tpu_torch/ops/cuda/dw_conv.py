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
with zp_in wherever a tap leaves the image. A block stages an output tile's
input window in shared memory, its threads walk down their columns with the
last k input rows in registers and multiply with packed dots (dp2a: two
int16 taps against two input bytes of one channel); pick_dw_tile chooses the
tile from the shape (design note in csrc/dw_conv.cu).
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
# per (k, stride): output columns a kernel thread owns, and the output rows
# it may walk (Geo in csrc/dw_conv.cu)
THREAD_TILE = {(3, 1): (4, (8, 2)), (3, 2): (2, (8, 2)), (5, 1): (1, (4,)), (5, 2): (1, (4,))}
MAX_THREADS = 256
NUM_SMS = 132  # H100 SXM
SMEM_CAP = 100 * 1024  # a tile's shared memory: two blocks an SM
MIN_WARPS = 16  # below this many warps an SM with the longest walk, the shortest


class DwArgs(ctypes.Structure):
    """The kernel's argument block, field for field as struct DwArgs in
    csrc/dw_conv.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("x", "w", "mult", "bias", "out")]
        + [(f, ctypes.c_int) for f in (
            "n", "h", "w_in", "c", "oh", "ow", "cp", "k", "stride", "pad_t", "pad_l",
            "zp_in", "act", "x_u8", "cgw", "ncs", "nrs", "rpt", "mode")]
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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def dw_smem_bytes(k: int, stride: int, cgw: int, ncs: int, nrs: int, rpt: int) -> int:
    """Shared memory of one block of the tile (cgw channel words, ncs column
    slots, nrs row strips of rpt rows), as struct Layout in csrc/dw_conv.cu
    computes it: two input windows, their columns padded by one word every
    PIN columns, then M, B and the int16 taps."""
    tw = THREAD_TILE[(k, stride)][0]
    pos = 2 * ((tw - 1) * stride // 2 + (k + 1) // 2)
    pin = tw * stride if tw * stride >= 2 else 4
    bh = nrs * rpt
    cols_in, rows_in = (ncs - 1) * tw * stride + pos, (bh - 1) * stride + k
    pcols_in = (cols_in - 1) + (cols_in - 1) // pin + 1

    def r4(words):
        return _ceil(words, 4) * 4

    return 4 * (2 * r4(rows_in * pcols_in * cgw) + 8 * cgw + r4(k * k * cgw * 2))


def pick_dw_tile(n: int, oh: int, ow: int, c: int, k: int,
                 stride: int) -> Tuple[int, int, int, int]:
    """The kernel's block tile for one shape: (cgw, ncs, nrs, rpt) = channel
    words (4 channels each), column slots (of THREAD_TILE's columns each), row
    strips, and the rows a thread walks; the block has cgw*ncs*nrs threads. A
    pure function of the shape, fitted to a sweep of every tile at
    YOLO-Fastest-320's and mobilenet-v1-224's depthwise shapes (chip_smoke.py
    --tiles times every tile at six of them; tests/test_torch_dwconv.py pins
    the choice):
      - the longest walk where it still leaves MIN_WARPS warps an SM (at
        stride 1), else the shortest, so that a small image has threads
        enough;
      - a channel group of up to 32 words, whole 16-byte chunks;
      - column slots and row strips, powers of two within MAX_THREADS, that
        compute the fewest outputs past the image's edge, then the most
        threads, then the squarest tile;
      - the channel group halves while the launch has fewer tiles than SMs,
        and the row strips while a block's shared memory exceeds SMEM_CAP."""
    tw, rpts = THREAD_TILE[(k, stride)]
    cwords = _ceil(c, CV)
    rpt = rpts[-1]
    if stride == 1 and n * _ceil(oh, rpts[0]) * _ceil(ow, tw) * cwords >= 32 * MIN_WARPS * NUM_SMS:
        rpt = rpts[0]
    cgw = min(cwords, 32)
    if cgw >= 4:
        cgw -= cgw % 4
    best = None
    for ncs in (1, 2, 4, 8, 16):
        for nrs in (1, 2, 4, 8):
            if cgw * ncs * nrs > MAX_THREADS:
                continue
            bw, bh = ncs * tw, nrs * rpt
            key = (_ceil(oh, bh) * bh * _ceil(ow, bw) * bw, -ncs * nrs, abs(bw - bh))
            if best is None or key < best[0]:
                best = (key, ncs, nrs)
    _, ncs, nrs = best

    def tiles(g):
        return n * _ceil(oh, nrs * rpt) * _ceil(ow, ncs * tw) * _ceil(cwords, g)

    while cgw % 8 == 0 and tiles(cgw) < NUM_SMS:
        cgw //= 2
    while nrs > 1 and dw_smem_bytes(k, stride, cgw, ncs, nrs, rpt) > SMEM_CAP:
        nrs //= 2
    return cgw, ncs, nrs, rpt


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
            s_out, lo, hi, out_u8, tile=None):
    """Check the operands and launch csrc/dw_conv.cu's kernel on the current
    stream, with the block tile pick_dw_tile chooses or `tile` forces. Raises
    on what the kernel does not take, and if the launch returns a CUDA
    error."""
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

    cgw, ncs, nrs, rpt = pick_dw_tile(N, OH, OW, C, k, stride) if tile is None else map(int, tile)
    _check(min(cgw, ncs, nrs) >= 1 and cgw * ncs * nrs <= MAX_THREADS
           and rpt in THREAD_TILE[(k, stride)][1]
           and dw_smem_bytes(k, stride, cgw, ncs, nrs, rpt) <= 227 * 1024,
           f"tile {(cgw, ncs, nrs, rpt)}: at most {MAX_THREADS} threads and 227 KB, rows a "
           f"thread walks in {THREAD_TILE[(k, stride)][1]}")

    out = torch.empty((N, OH, OW, C), dtype=torch.uint8 if out_u8 else torch.int8, device=x.device)
    align = x.data_ptr() | out.data_ptr()
    if C % 16 == 0 and cgw % 4 == 0 and align % 16 == 0:
        mode = 16
    elif C % 4 == 0 and align % 4 == 0:
        mode = 4
    else:
        mode = 1
    a_lo, a_hi = act_bounds(act, s_out)
    args = DwArgs(
        x=x.data_ptr(), w=w.data_ptr(), mult=mult.data_ptr(), bias=bias.data_ptr(),
        out=out.data_ptr(), n=N, h=H, w_in=W, c=C, oh=OH, ow=OW, cp=cp, k=k, stride=stride,
        pad_t=pad_t, pad_l=pad_l, zp_in=int(zp_in), act=-1 if act is None else int(act),
        x_u8=int(x.dtype == torch.uint8), cgw=cgw, ncs=ncs, nrs=nrs, rpt=rpt, mode=mode,
        act_lo=a_lo, act_hi=a_hi, zp_out=float(zp_out), lo=float(lo), hi=float(hi),
    )

    fn = load("dw_conv").dw_qconv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(DwArgs), ctypes.c_void_p]
    rc = fn(ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dw_qconv: kernel launch failed with CUDA error {rc}")
    return out


def dw_qconv(x, w, mult, bias, *, k, stride=1, pad_t=0, pad_b=0, pad_l=0, pad_r=0,
             zp_in=0, zp_out=0, act=-1, s_out=1.0, lo=-128.0, hi=127.0, out_u8=False,
             tile=None):
    """Depthwise conv + requant: x [N, H, W, C] int8/uint8 raw quantized
    activations, w [k*k, Cp] int16 from pack_dw_taps, mult/bias f32 [C].
    Returns [N, OH, OW, C] int8 (uint8 with out_u8).

    On a CUDA tensor this launches the kernel (or raises), with the block
    tile (cgw, ncs, nrs, rpt) that pick_dw_tile chooses, or `tile`; on a CPU
    tensor, or a meta tensor during shape inference, it runs dw_qconv_plain
    (which has no tile). dw_qconv.launches counts kernel launches."""
    kw = dict(k=k, stride=stride, pad_t=pad_t, pad_b=pad_b, pad_l=pad_l, pad_r=pad_r,
              zp_in=zp_in, zp_out=zp_out, act=act, s_out=s_out, lo=lo, hi=hi, out_u8=out_u8)
    if x.is_cuda:
        out = _launch(x, w, mult, bias, tile=tile, **kw)
        dw_qconv.launches += 1
        return out
    if x.device.type in ("cpu", "meta"):
        return dw_qconv_plain(x, w, mult, bias, **kw)
    raise ValueError(f"dw_qconv: no version for device {x.device}")


dw_qconv.launches = 0
