"""Int8 direct and pointwise convolutions with fused requantization: the
CUDA kernel csrc/qconv.cu, its plain PyTorch versions, and the wrappers that
pick between them by device.

Replaces two Pallas TPU kernels of tengine_tpu/ops/pallas/qconv.py:

  qconv_direct  k×k conv (k² <= 49, stride 1/2, any pads), NHWC s8/u8 in
                and out, per-channel requant, optional fused residual + relu
  qconv1x1      the 1×1 conv as a flat [N·H·W, C] × [C, C2] GEMM, same
                epilogue and residual

    acc  = sum (x - c0) * w                 exact int32, padding = zp_in
    accf = float(acc) + cw * float(rowsum)  (uint8 zero-point term)
    out  = clip(round_half_away(act(accf * M[c] + B[c])), lo, hi)

with c0 = 128 re-centring uint8 input (0 for int8) and the rowsum taken
over the re-centred receptive field, padded taps included. M and B are the
host folds of ops/quantized.py (qconv_m / qconv_b), as the JAX lowering
folds them. With a fused residual r the unfused eltwise-sum numerics follow:
y = round(((t - zp_mid)·s_mid + (r - zp_r)·s_r) · f32(1/s_out2)) + zp_out2
(XLA compiles the JAX kernel's division by the constant s_out2 to that
multiply), then the optional relu max(y, zp_out2) and the clip.

On the card the k×k convs are bound by operations (yolov3-416 batch 8 gives
them 204 GMAC over 236 MB: int8 tensor cores at 1,979 TOP/s against 3.35
TB/s of HBM) and the narrow 1×1 convs by bytes. The kernel is one persistent
implicit GEMM on the int8 tensor cores (wgmma m64n128k32 for int8 input on
the 128-channel tiles, mma.sync m16n8k32 otherwise, both fed by cp.async
through a shared-memory ring; design note in csrc/qconv.cu) with the block's
tile picked per shape by pick_tile; qgemm_requant (ops/cuda/qgemm.py)
launches the same kernel. None of the TPU layout tricks carry over — int16
hops, the stride-2 column phase split, the OWp garbage columns, the halo
DMA: the kernel gathers NHWC bytes directly and masks ragged edges. The MXU
ones-column does: the rowsum is one more MMA against a fragment of ones.

qconv_fast runs the same kernel for the fast tier's INT8 convs
(ops/quantized.py:lower_conv_quant_fast), in its fast-epilogue mode: the
exact int32 sums, then the f32 steps of qrequant (csrc/requant_steps.cuh,
shared with csrc/requant.cu) on the accumulators, in one launch, where the
plain version widens the input to float64 (qwiden), sums in a float64 library
conv and requantizes the sums (qrequant). The outputs are the same bytes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..lowering import conv2d_nhwc
from ..qmath import round_away
from .requant import Epilogue, RequantSteps, qrequant, qwiden_for_conv, steps_args

SOURCE = "tengine_tpu_torch/csrc/qconv.cu"
REPLACES_DIRECT = "tengine_tpu/ops/pallas/qconv.py:232"
REPLACES_1X1 = "tengine_tpu/ops/pallas/qconv.py:413"

CHUNK = 32  # one MMA step's K: weight channels per tap pad to a multiple
# the block tiles the kernel is built for, (BM pixels, BN channels), in the
# order pick_tile prefers them
TILES = ((128, 128), (64, 128), (128, 64), (64, 64), (128, 32), (64, 32))
# the tiles whose product can also run as warpgroup MMA (wgmma), given int8
# input and no rowsum term; a third tile element "mma" or "wgmma" forces one
WGMMA_TILES = ((128, 128), (64, 128))
SM_COUNT = 132  # H100 SXM

_DTYPES = {"int8": torch.int8, "uint8": torch.uint8}


class QconvArgs(ctypes.Structure):
    """The kernel's argument block, field for field as struct QconvArgs in
    csrc/qconv.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("x", "w", "mult", "bias", "res", "out")]
        + [(f, ctypes.c_int) for f in (
            "n", "h", "w_in", "c", "oh", "ow", "c2", "kh", "kw", "stride",
            "pad_t", "pad_l", "cstride", "zp_in", "cw", "act")]
        + [(f, ctypes.c_float) for f in ("act_lo", "act_hi", "zp_out", "lo", "hi")]
        + [(f, ctypes.c_int) for f in ("x_u8", "res_u8", "out_u8", "has_res", "relu2")]
        + [(f, ctypes.c_float) for f in ("s_mid", "zp_mid", "s_r", "zp_r", "inv_s_out2", "zp_out2")]
        + [(f, ctypes.c_int) for f in ("bm", "bn", "wgmma", "fast")]
        + [("steps", RequantSteps)]
    )


def _ru(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def pack_qconv_weights(w_oihw: np.ndarray, is_u8: bool) -> np.ndarray:
    """Host-side repack: [O, C, kh, kw] stored weights -> [O, kh*kw, Cp] int8,
    re-centred by -128 when the source is uint8, each tap's channels
    zero-padded to Cp = C rounded up to a multiple of 32 (the kernel's K
    chunk). Tap order is (ky, kx), as pack_qconv_weights orders the taps
    for the Pallas kernel; no ones-column: the kernel sums the rowsum."""
    O, C, kh, kw = w_oihw.shape
    t = np.asarray(w_oihw).transpose(0, 2, 3, 1).reshape(O, kh * kw, C)
    t = (t.astype(np.int16) - 128).astype(np.int8) if is_u8 else t.astype(np.int8)
    out = np.zeros((O, kh * kw, _ru(C, CHUNK)), np.int8)
    out[:, :, :C] = t
    return out


@functools.lru_cache(maxsize=None)
def act_bounds(act: Optional[int], inv_s_out: float, zp_out: int) -> Tuple[float, float]:
    """The activation clamp's thresholds in the requant domain, computed in
    double on the host and then rounded to f32, as the Pallas kernels'
    static arguments are (qconv.py:_requant_store, qgemm.py:_qgemm_kernel)."""
    if act is None or act < 0:
        return 0.0, 0.0
    if act == 1:
        return float(np.float32(zp_out - inv_s_out)), float(np.float32(zp_out + inv_s_out))
    return float(zp_out), float(np.float32(act * inv_s_out + zp_out))


@functools.lru_cache(maxsize=None)
def _inv_f32(s: float) -> float:
    """f32(1 / f32(s)): the multiplier that stands for a division by s."""
    return float(np.float32(1.0) / np.float32(s))


def epilogue_plain(acc, rsum, mult, bias, residual=None, res=None, *, cw, act,
                   inv_s_out, zp_out, lo, hi, out_dtype):
    """The kernels' f32 epilogue in plain torch ops, each op rounding once:
    acc [M', C2] float32 (exact integers where |acc| <= 2^24, else rounded
    to nearest like the kernel's int -> float conversion), rsum [M', 1]."""
    accf = acc
    if cw:
        accf = accf + rsum * float(cw)
    q = accf * mult + bias
    if act is not None and act >= 0:
        a_lo, a_hi = act_bounds(act, inv_s_out, zp_out)
        if act == 1:
            q = torch.clamp(q, a_lo, a_hi)
        else:
            q = torch.clamp_min(q, float(zp_out))
            if act > 0:
                q = torch.clamp_max(q, a_hi)
    t = torch.clamp(round_away(q), float(lo), float(hi))
    if res is not None:
        s_mid, zp_mid, s_r, zp_r, s_out2, zp_out2, relu2 = res
        tf = (t - float(zp_mid)) * float(np.float32(s_mid))
        rf = (residual.to(torch.float32) - float(zp_r)) * float(np.float32(s_r))
        y = round_away((tf + rf) * _inv_f32(s_out2)) + float(zp_out2)
        if relu2:
            y = torch.clamp_min(y, float(zp_out2))
        t = torch.clamp(y, float(lo), float(hi))
    return t.to(_DTYPES[out_dtype])


def _conv_plain(x, w, kh, kw, stride, pads, zp_in, with_rowsum):
    """Exact int accumulation in float64 (every partial sum stays far below
    2^53): acc [N, OH, OW, C2] and the rowsum [N, OH, OW, 1] as float32."""
    N, H, W, C = map(int, x.shape)
    C2 = int(w.shape[0])
    c0 = 128.0 if x.dtype == torch.uint8 else 0.0
    pt, pb, pl, pr = pads
    xs = F.pad((x.to(torch.float64) - c0).permute(0, 3, 1, 2), (pl, pr, pt, pb),
               value=float(zp_in) - c0)
    wt = w[:, :, :C].to(torch.float64).reshape(C2, kh, kw, C).permute(0, 3, 1, 2)
    acc = F.conv2d(xs, wt, stride=stride).permute(0, 2, 3, 1).to(torch.float32)
    rsum = None
    if with_rowsum:
        ones = torch.ones((1, C, kh, kw), dtype=torch.float64, device=x.device)
        rsum = F.conv2d(xs, ones, stride=stride).permute(0, 2, 3, 1).to(torch.float32)
    return acc, rsum


def qconv_direct_plain(x, w, mult, bias, residual=None, res=None, *, kh, kw, stride=1,
                       pad_t=0, pad_b=0, pad_l=0, pad_r=0, zp_in=0, cw=0, act=-1,
                       inv_s_out=1.0, zp_out=0, lo=-127, hi=127, out_dtype="int8"):
    """The plain PyTorch version of qconv_direct: same inputs, same result.
    x [N, H, W, C] s8/u8, w [C2, kh*kw, Cp] from pack_qconv_weights.
    Returns [N, OH, OW, C2]."""
    acc, rsum = _conv_plain(x, w, kh, kw, stride, (pad_t, pad_b, pad_l, pad_r), zp_in, bool(cw))
    return epilogue_plain(acc, rsum, mult, bias, residual, res, cw=cw, act=act,
                          inv_s_out=inv_s_out, zp_out=zp_out, lo=lo, hi=hi,
                          out_dtype=out_dtype)


def qconv1x1_plain(x, w, mult, bias, residual=None, res=None, *, cw=0, act=-1,
                   inv_s_out=1.0, zp_out=0, lo=-127, hi=127, out_dtype="int8"):
    """The plain PyTorch version of qconv1x1: x [M, C], w [C2, 1, Cp]."""
    M, C = map(int, x.shape)
    acc, rsum = _conv_plain(x.reshape(1, 1, M, C), w, 1, 1, 1, (0, 0, 0, 0), 0, bool(cw))
    C2 = int(w.shape[0])
    r = residual.reshape(1, 1, M, C2) if residual is not None else None
    out = epilogue_plain(acc, rsum, mult, bias, r, res, cw=cw, act=act,
                         inv_s_out=inv_s_out, zp_out=zp_out, lo=lo, hi=hi,
                         out_dtype=out_dtype)
    return out.reshape(M, C2)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """csrc/qconv.cu's one entry, built and bound at the first launch."""
    from .build import load

    fn = load("qconv").qconv_igemm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(QconvArgs), ctypes.c_int, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def pick_tile(m: int, c2: int) -> Tuple[int, int]:
    """The block's (BM, BN) for an [m, K] × [K, c2] product. BN: the widths
    that leave the fewest masked channels (c2 = 32 takes 32, not 128); BM = 64
    when there are no more rows than that. Then the first tile, largest
    first, with a tile for at least three quarters of the card's SMs (the
    kernel is persistent: a block walks its tiles and loads the next one's
    operands during a tile's epilogue, so few large tiles beat many small
    ones; measured by chip_smoke.py --tiles); failing that the one with the
    most tiles."""
    padded = {bn: _ru(c2, bn) for bn in (128, 64, 32)}
    tiles = [t for t in TILES if padded[t[1]] == min(padded.values()) and (m > 64 or t[0] == 64)]

    def blocks(t):
        return -(-m // t[0]) * -(-c2 // t[1])

    for t in tiles:
        if blocks(t) >= 3 * SM_COUNT // 4:
            return t
    return max(tiles, key=blocks)  # the first (largest) of equals


def launch_igemm(name, x, w, mult, bias, residual, res, *, n, h, w_in, c, oh, ow,
                 kh, kw, stride, pad_t, pad_l, zp_in, cw, act, inv_s_out, zp_out,
                 lo, hi, out_dtype, out_shape, tile=None, steps=None):
    """Check the operands and launch csrc/qconv.cu's kernel on the current
    stream. x is NHWC [n, h, w_in, c] (a flat [M, K] is n=1, h=1, w_in=M);
    w is [C2, kh*kw, Cp]. tile forces one of TILES, and with a third element
    "mma" or "wgmma" the route (the card tests cover each); by default
    pick_tile chooses, and wgmma runs where it can. steps (RequantSteps)
    selects the fast-epilogue mode: those steps in place of the epilogue
    arguments, bias optional, the residual read where steps.res_mode says
    (res is then None). Raises on what the kernel does not take, and if the
    launch returns a CUDA error. The checks build their messages only when
    they fail: this runs once per conv per forward."""
    def refuse(what):
        raise ValueError(f"{name}: {what}")

    fast = steps is not None
    if fast and not (x.dtype == torch.int8 and zp_in == 0 and not cw and res is None):
        refuse("the fast epilogue takes int8 input with zero point 0, and its own residual")

    C2 = int(w.shape[0])
    cp = _ru(c, CHUNK)
    if not (x.dtype in (torch.int8, torch.uint8) and x.is_contiguous()):
        refuse("x must be a contiguous int8/uint8 tensor")
    if x.numel() != n * h * w_in * c or x.numel() >= 2 ** 31:
        refuse(f"x has {x.numel()} elements, not {n}x{h}x{w_in}x{c} (and fewer than 2^31)")
    if not (w.dtype == torch.int8 and tuple(w.shape) == (C2, kh * kw, cp)
            and w.is_contiguous() and w.data_ptr() % 16 == 0):
        refuse(f"w must be contiguous 16-byte-aligned int8 [C2, {kh * kw}, {cp}]")
    for nm, v in (("mult", mult), ("bias", bias)):
        if (v is not None or not fast) and not (
                v.dtype == torch.float32 and tuple(v.shape) == (C2,) and v.is_contiguous()):
            refuse(f"{nm} must be contiguous f32 [{C2}]")
    if out_dtype not in _DTYPES:
        refuse(f"out_dtype {out_dtype!r}")
    if oh < 1 or ow < 1 or not (1 <= kh <= 16 and 1 <= kw <= 16):
        refuse(f"output {oh}x{ow}, window {kh}x{kw}: the kernel takes windows up to 16x16")
    operands = [t for t in (w, mult, bias) if t is not None]
    has_residual = res is not None or (fast and steps.res_mode != 0)
    if has_residual:
        if not (residual is not None and residual.dtype in (torch.int8, torch.uint8)
                and residual.is_contiguous() and residual.numel() == n * oh * ow * C2):
            refuse("residual must be a contiguous int8/uint8 tensor shaped like the output")
        operands.append(residual)
    if any(t.device != x.device for t in operands):
        refuse("all operands must be on one device")
    tile = tuple(tile) if tile is not None else pick_tile(n * oh * ow, C2)
    tile, route = tile[:2], tile[2] if len(tile) == 3 else None
    if tile not in TILES:
        refuse(f"tile {tile} is not one of {TILES}")
    can_wgmma = tile in WGMMA_TILES and x.dtype == torch.int8 and not cw
    if route not in (None, "mma", "wgmma") or (route == "wgmma" and not can_wgmma):
        refuse(f"route {route!r} with tile {tile}, {x.dtype} input, cw={cw}")
    wgmma = can_wgmma if route is None else route == "wgmma"

    out = torch.empty(out_shape, dtype=_DTYPES[out_dtype], device=x.device)
    a_lo, a_hi = act_bounds(act, inv_s_out, zp_out)
    args = QconvArgs(
        x=x.data_ptr(), w=w.data_ptr(), mult=mult.data_ptr(),
        bias=bias.data_ptr() if bias is not None else None,
        res=residual.data_ptr() if has_residual else None, out=out.data_ptr(),
        n=n, h=h, w_in=w_in, c=c, oh=oh, ow=ow, c2=C2, kh=kh, kw=kw, stride=stride,
        pad_t=pad_t, pad_l=pad_l, cstride=cp, zp_in=int(zp_in), cw=int(cw),
        act=-1 if act is None else int(act), act_lo=a_lo, act_hi=a_hi,
        zp_out=float(zp_out), lo=float(lo), hi=float(hi),
        x_u8=int(x.dtype == torch.uint8),
        res_u8=int(res is not None and residual.dtype == torch.uint8),
        out_u8=int(out_dtype == "uint8"), has_res=int(res is not None),
        relu2=int(bool(res[6])) if res is not None else 0,
        bm=tile[0], bn=tile[1], wgmma=int(wgmma), fast=int(fast),
    )
    if fast:
        args.steps = steps
    if res is not None:
        s_mid, zp_mid, s_r, zp_r, s_out2, zp_out2, _ = res
        args.s_mid, args.zp_mid, args.s_r = float(s_mid), float(zp_mid), float(s_r)
        args.zp_r, args.inv_s_out2, args.zp_out2 = float(zp_r), _inv_f32(s_out2), float(zp_out2)
    # the widest piece (16, 8 or 4 bytes) that divides C and the input's address
    vec = next((v for v in (16, 8, 4) if c % v == 0 and x.data_ptr() % v == 0), 0)

    rc = _launch_fn()(ctypes.byref(args), vec, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    return out


def _dispatch(name, x, kernel, plain):
    if x.is_cuda:
        return kernel()
    if x.device.type in ("cpu", "meta"):
        return plain()
    raise ValueError(f"{name}: no version for device {x.device}")


def qconv_direct(x, w, mult, bias, residual=None, res=None, *, kh, kw, stride=1,
                 pad_t=0, pad_b=0, pad_l=0, pad_r=0, zp_in=0, cw=0, act=-1,
                 inv_s_out=1.0, zp_out=0, lo=-127, hi=127, out_dtype="int8", tile=None):
    """Direct k×k conv + requant (+ fused residual): x [N, H, W, C] s8/u8
    raw quantized activations, w [C2, kh*kw, Cp] from pack_qconv_weights,
    mult/bias f32 [C2], residual [N, OH, OW, C2] with res = (s_mid, zp_mid,
    s_r, zp_r, s_out2, zp_out2, relu2). Returns [N, OH, OW, C2].

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor,
    or a meta tensor during shape inference, it runs qconv_direct_plain.
    qconv_direct.launches counts kernel launches; tile forces one of TILES."""
    N, H, W, C = map(int, x.shape)
    OH = (H + pad_t + pad_b - kh) // stride + 1
    OW = (W + pad_l + pad_r - kw) // stride + 1
    ep = dict(cw=cw, act=act, inv_s_out=inv_s_out, zp_out=zp_out, lo=lo, hi=hi,
              out_dtype=out_dtype)

    def kernel():
        out = launch_igemm(
            "qconv_direct", x, w, mult, bias, residual, res, n=N, h=H, w_in=W, c=C,
            oh=OH, ow=OW, kh=kh, kw=kw, stride=stride, pad_t=pad_t, pad_l=pad_l,
            zp_in=zp_in, out_shape=(N, OH, OW, int(w.shape[0])), tile=tile, **ep,
        )
        qconv_direct.launches += 1
        return out

    return _dispatch("qconv_direct", x, kernel, lambda: qconv_direct_plain(
        x, w, mult, bias, residual, res, kh=kh, kw=kw, stride=stride, pad_t=pad_t,
        pad_b=pad_b, pad_l=pad_l, pad_r=pad_r, zp_in=zp_in, **ep))


def qconv1x1(x, w, mult, bias, residual=None, res=None, *, cw=0, act=-1,
             inv_s_out=1.0, zp_out=0, lo=-127, hi=127, out_dtype="int8", tile=None):
    """1×1 conv as a flat GEMM + requant (+ fused residual): x [M, C] s8/u8,
    w [C2, 1, Cp] from pack_qconv_weights, residual [M, C2]. Returns
    [M, C2]. Kernel on a CUDA tensor, qconv1x1_plain on a CPU or meta
    tensor; qconv1x1.launches counts kernel launches; tile forces one of
    TILES."""
    M, C = map(int, x.shape)
    ep = dict(cw=cw, act=act, inv_s_out=inv_s_out, zp_out=zp_out, lo=lo, hi=hi,
              out_dtype=out_dtype)

    def kernel():
        out = launch_igemm(
            "qconv1x1", x, w, mult, bias, residual, res, n=1, h=1, w_in=M, c=C,
            oh=1, ow=M, kh=1, kw=1, stride=1, pad_t=0, pad_l=0, zp_in=0,
            out_shape=(M, int(w.shape[0])), tile=tile, **ep,
        )
        qconv1x1.launches += 1
        return out

    return _dispatch("qconv1x1", x, kernel,
                     lambda: qconv1x1_plain(x, w, mult, bias, residual, res, **ep))


qconv_direct.launches = 0
qconv1x1.launches = 0


def qconv_fast_plain(x, w, mult, bias, residual, ep: Epilogue, *, stride, pads):
    """The plain version of qconv_fast: the fast tier's float64 chain, the
    raw input widened (qwiden), summed by a float64 library conv (exact:
    every partial sum stays far below 2^53) and requantized (qrequant).
    The float64 OIHW weight is rebuilt from the packed int8 one on every
    call, not cached: O·K elements, against the conv's N·OH·OW·O·K
    products, so at most 1/(N·OH·OW) of the conv's own work."""
    C = int(x.shape[3])
    wf = w[..., :C].to(torch.float64).permute(0, 3, 1, 2)  # OIHW
    xs, conv_pads = qwiden_for_conv(x, mode="raw", pads=pads)
    acc = conv2d_nhwc(xs, wf, conv_pads, (stride, stride), (1, 1), 1)
    return qrequant(acc, mult, bias, None, residual, ep)


def qconv_fast(x, w, mult, bias, residual, ep: Epilogue, *, stride, pads, tile=None):
    """The fast tier's INT8 conv in one launch: x [N, H, W, C] int8 with zero
    point 0 (NHWC; the kernel takes it contiguous), w [C2, kh, kw, Cp] from
    pack_qconv_weights (int8, zero point 0), stride 1 or 2 both ways, pads
    ((top, bottom), (left, right)), taps outside the image 0; mult, bias
    (or None) f32 [C2] and ep the requant of
    ops/quantized.py:_requant_conv_out, residual (NHWC, the output's shape)
    where ep has a fused residual. Returns [N, OH, OW, C2] of ep's dtype.

    On a CUDA tensor this launches csrc/qconv.cu's kernel in its
    fast-epilogue mode (or raises), and writes NHWC contiguous; on a CPU
    tensor, or a meta tensor during shape inference, it runs
    qconv_fast_plain, in the plain chain's layout. The values are the same
    bytes. qconv_fast.launches counts kernel launches, .plain plain runs on
    a CPU tensor; tile forces one of TILES."""
    if x.is_cuda:
        N, H, W, C = map(int, x.shape)
        C2, kh, kw, cp = map(int, w.shape)
        (pt, pb), (pl, pr) = pads
        OH, OW = (H + pt + pb - kh) // stride + 1, (W + pl + pr - kw) // stride + 1
        if ep.residual is not None:
            residual = residual.contiguous()
        out = launch_igemm(
            "qconv_fast", x.contiguous(), w.reshape(C2, kh * kw, cp), mult, bias, residual, None,
            n=N, h=H, w_in=W, c=C, oh=OH, ow=OW, kh=kh, kw=kw, stride=stride,
            pad_t=int(pt), pad_l=int(pl), zp_in=0, cw=0, act=-1, inv_s_out=1.0, zp_out=0,
            lo=ep.lo, hi=ep.hi, out_dtype="uint8" if ep.out_u8 else "int8",
            out_shape=(N, OH, OW, C2), tile=tile,
            steps=steps_args(ep, has_bias=bias is not None,
                             res_u8=ep.residual is not None and residual.dtype == torch.uint8),
        )
        qconv_fast.launches += 1
        return out
    if x.device.type in ("cpu", "meta"):
        qconv_fast.plain += x.device.type == "cpu"
        return qconv_fast_plain(x, w, mult, bias, residual, ep, stride=stride, pads=pads)
    raise ValueError(f"qconv_fast: no version for device {x.device}")


qconv_fast.launches = 0
qconv_fast.plain = 0
