"""Quantization math helpers (PyTorch port of tengine_tpu/ops/qmath.py).

Semantics follow the reference ref kernels exactly:
  * UINT8 asymmetric per-tensor: real = (q - zero_point) * scale
    (conv_kernel_ref_uint8.c:76-84), requant = round(x/scale) + zp clipped to
    [0, 255] (conv_kernel_ref_uint8.c:168-173).
  * INT8 symmetric, per-channel weights: real = q * scale[c]; requant =
    round(x/scale) clipped to [-127, 127] (conv_kernel_ref_int8.c:162-166).
  * round() is C round — half away from zero — NOT torch's half-to-even
    torch.round.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..graph.ir import DType, QuantParam, Tensor

QRANGE = {
    DType.UINT8: (0, 255),
    DType.INT8: (-127, 127),
    DType.INT32: (-(2**31) + 1, 2**31 - 1),
}

TORCH_DTYPES = {
    DType.FP32: torch.float32,
    DType.FP16: torch.float16,
    DType.INT8: torch.int8,
    DType.UINT8: torch.uint8,
    DType.INT32: torch.int32,
    DType.INT16: torch.int16,
}


def qrange(dtype: DType, quant: Optional[QuantParam] = None) -> Tuple[int, int]:
    """Clip range for a quantized tensor. INT8 tensors holding a shifted
    UINT8 grid (native-int8 storage, QuantParam.full_range) span the full
    [-128, 127]; the reference's symmetric int8 scheme clips to +-127."""
    if quant is not None and quant.full_range and dtype == DType.INT8:
        return (-128, 127)
    return QRANGE[dtype]


def round_away(x: torch.Tensor) -> torch.Tensor:
    """C round(): half away from zero.

    trunc(x) + sign(x)·(|x − trunc(x)| >= 0.5). The fraction x − trunc(x) is
    exact in floating point, so ties are decided exactly; the common
    floor(|x| + 0.5) form is not (0.49999997 + 0.5 rounds up to 1.0)."""
    t = torch.trunc(x)
    return t + torch.sign(x) * (torch.abs(x - t) >= 0.5).to(x.dtype)


def round_away_np(x):
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _chan_shape(ndim: int, axis: int, n: int):
    s = [1] * ndim
    s[axis] = n
    return s


def _chan_vecs(quant: QuantParam, ndim: int, axis: int, device):
    shape = _chan_shape(ndim, axis, quant.scales.shape[0])
    scales = torch.as_tensor(np.asarray(quant.scales, np.float32), device=device)
    zps = torch.as_tensor(np.asarray(quant.zero_points, np.float32), device=device)
    return scales.reshape(shape), zps.reshape(shape)


def dequantize(x: torch.Tensor, quant: QuantParam, channel_axis: Optional[int] = None):
    """Quantized tensor -> fp32. Per-channel scales broadcast on channel_axis."""
    xf = x.to(torch.float32)
    if quant.per_channel:
        assert channel_axis is not None, "per-channel dequant needs a channel axis"
        scales, zps = _chan_vecs(quant, x.ndim, channel_axis, x.device)
        return (xf - zps) * scales
    # f32 scalars: a Python float holding an f32 value multiplies exactly
    return (xf - float(np.float32(quant.zero_points))) * float(np.float32(quant.scales))


def requantize(
    x: torch.Tensor,
    quant: QuantParam,
    dtype: DType,
    channel_axis: Optional[int] = None,
    reciprocal: bool = False,
):
    """fp32 -> quantized integer dtype with reference rounding/clipping.

    reciprocal=True (per-tensor quant only) multiplies by the scale's f32
    reciprocal instead of dividing by the scale. That is what the JAX engine
    computes: it runs requantize inside jit, where XLA rewrites a division
    by a constant as a multiplication by the constant's reciprocal, rounded
    to f32. The two
    differ where x / s lands on a .5 tie, which a leaky ReLU on a shared
    grid hits often (0.1 * q). The engine's generic wrapper passes it so
    that both engines round the same values; the default is the IEEE
    quotient of the reference C code and of the JAX function called
    eagerly."""
    lo, hi = qrange(dtype, quant)
    if quant.per_channel:
        assert channel_axis is not None and not reciprocal
        scales, zps = _chan_vecs(quant, x.ndim, channel_axis, x.device)
    elif reciprocal:
        inv = float(np.float32(1.0) / np.float32(quant.scales))
        q = round_away(x * inv) + float(np.float32(quant.zero_points))
        return clip_cast(q, lo, hi, TORCH_DTYPES[dtype])
    else:
        # a 0-dim tensor on x's device, not a Python scalar: CUDA divides by
        # a host scalar as a multiply by its reciprocal, which is not the
        # IEEE quotient the reference rounds
        scales = torch.full((), float(np.float32(quant.scales)), device=x.device)
        zps = float(np.float32(quant.zero_points))
    q = round_away(x / scales) + zps
    return clip_cast(q, lo, hi, TORCH_DTYPES[dtype])


def clip_cast(q: torch.Tensor, lo, hi, store: torch.dtype) -> torch.Tensor:
    """clip + cast. A torch float->int cast does not saturate, so the clip
    is what keeps out-of-range values from wrapping."""
    return torch.clamp(q, lo, hi).to(store)


def dequantize_np(x: np.ndarray, quant: QuantParam, channel_axis: Optional[int] = None):
    xf = x.astype(np.float32)
    if quant.per_channel:
        shape = _chan_shape(x.ndim, channel_axis, quant.scales.shape[0])
        return (xf - quant.zero_points.reshape(shape)) * quant.scales.reshape(shape)
    return (xf - float(quant.zero_points)) * float(quant.scales)


def quantize_np(x: np.ndarray, quant: QuantParam, dtype: DType, channel_axis: Optional[int] = None):
    lo, hi = qrange(dtype, quant)
    if quant.per_channel:
        shape = _chan_shape(x.ndim, channel_axis, quant.scales.shape[0])
        q = round_away_np(x / quant.scales.reshape(shape)) + quant.zero_points.reshape(shape)
    else:
        q = round_away_np(x / float(quant.scales)) + float(quant.zero_points)
    return np.clip(q, lo, hi).astype(dtype.np)


# --- a weight's output channels ------------------------------------------------
#
# Per-channel weight grids run over a node's output channels. A Convolution
# or FullyConnected weight holds them on axis 0 ([C_out, C_in/g, kh, kw],
# [C_out, K]). A Deconvolution weight is [C_in, C_out/g, kh, kw]: element
# [i, j] feeds output channel (i // (C_in/g))·(C_out/g) + j, so for g > 1
# its C_out channels lie along no one axis. The JAX package takes axis 0 for
# a Deconvolution too, and so gives it C_in scales against C_out biases
# (ROADMAP §3). Every per-channel quantize and dequantize of a weight goes
# through these helpers.


def weight_channels(op: str, shape, group: int = 1) -> np.ndarray:
    """The output channel each element of an `op` weight of `shape` feeds,
    as an integer array that broadcasts against the weight. A 1-D const (a
    bias) and every op but Deconvolution: axis 0."""
    shape = tuple(int(d) for d in shape)
    if op == "Deconvolution" and len(shape) == 4:
        c_in, ocg = shape[:2]
        ch = (np.arange(c_in) // (c_in // group))[:, None] * ocg + np.arange(ocg)
        return ch.reshape(c_in, ocg, 1, 1)
    return np.arange(shape[0]).reshape((shape[0],) + (1,) * (len(shape) - 1))


def weight_absmax(w: np.ndarray, op: str, group: int = 1) -> np.ndarray:
    """max |w| over each output channel, in output-channel order: a
    Deconvolution's [C_in, C_out/g, kh, kw] as [g, C_in/g, C_out/g, kh·kw],
    the max over axes 1 and 3."""
    if op == "Deconvolution" and w.ndim == 4:
        c_in, ocg = w.shape[:2]
        return np.abs(w.reshape(group, c_in // group, ocg, -1)).max(axis=(1, 3)).reshape(-1)
    return np.abs(w.reshape(w.shape[0], -1)).max(axis=1)


def dequantize_weight_np(w: np.ndarray, quant: QuantParam, op: str, group: int = 1):
    """dequantize_np of an `op` weight, per-channel grids by output channel."""
    if not quant.per_channel:
        return dequantize_np(w, quant)
    ch = weight_channels(op, w.shape, group)
    return (w.astype(np.float32) - np.asarray(quant.zero_points)[ch]) * np.asarray(
        quant.scales)[ch]


def quantize_weight_np(w: np.ndarray, quant: QuantParam, dtype: DType, op: str, group: int = 1):
    """quantize_np of an `op` weight, per-channel grids by output channel."""
    if not quant.per_channel:
        return quantize_np(w, quant, dtype)
    lo, hi = qrange(dtype, quant)
    ch = weight_channels(op, w.shape, group)
    q = round_away_np(w / np.asarray(quant.scales)[ch]) + np.asarray(quant.zero_points)[ch]
    return np.clip(q, lo, hi).astype(dtype.np)


def is_quantized_tensor(t: Tensor) -> bool:
    return t.quant is not None and t.dtype in (DType.UINT8, DType.INT8)


def node_is_quant(ctx) -> bool:
    """Node executes in the quantized domain: first input and first output
    are quantized tensors and quantization isn't globally disabled."""
    if ctx.options.quant_mode == "float":
        return False
    if not ctx.node.inputs or not ctx.node.outputs:
        return False
    return is_quantized_tensor(ctx.in_tensor(0)) and is_quantized_tensor(ctx.out_tensor(0))


def node_is_float(ctx) -> bool:
    return not node_is_quant(ctx)
