"""Chains of int8 ResNet bottlenecks, each block fused: the CUDA kernel
csrc/qblock.cu, its plain PyTorch version, and the wrapper that picks between
them by device.

Replaces the Pallas TPU kernel qblock_chain of
tengine_tpu/ops/pallas/qblock.py. Per block, on symmetric int8 activations
(zero point 0, every clip ±127):

    q1 = requant(x·w1, M1, B1, act1)                 1×1, K = c_in
    q2 = requant(conv3×3(q1, w2), M2, B2, act2)      stride 1, pad 1; q1 is 0
                                                     outside the image
  exact tier
    t  = requant(q2·w3, M3, B3)                      1×1, to the mid grid
    r  = requant(x·w4, M4, B4)  or  x                projection or identity
    y  = clip(round((t·s_mid + r·s_r) · f32(1/s_out)))
    y  = max(y, 0)                                   ReLu on the same grid
         clip(round(max(y, 0) · f32(s_out·f32(1/s_relu))))   on its own grid
  relaxed tier (M3, M4 folded to the block's final scale on the host)
    y  = f32(q2·w3)·M3 + B3
    y  = y + f32(x·w4)·M4 + B4  or  y + x·beta       beta = s_r / s_fin
    y  = clip(round(max?(y, 0)))                     one rounding per block

with requant(acc, M, B, act) = clip(round(act(f32(acc)·M + B))), round half
away from zero, act -1 none, 0 relu, 1 clip to ±1/s, n > 1 relu-n, and every
f32 product and sum rounded on its own (the kernels are built without
contraction).

QBlock and build_block_args are this package's copy of the JAX module's (that
module imports JAX): the same fields and the same host folds, term for term,
so both engines hand their kernels the same numbers. pack_block_args then
lays the weights out for the CUDA kernel (output channel major, K contiguous
and zero-padded to a multiple of 32). The TPU kernel's packed flat
activation layout, image packs, lane padding and VMEM chain splitter do not
carry over: the kernel takes NHWC int8 in and out, any N, H, W and channel
counts.

On the card a chain is one persistent cooperative launch whose thread
blocks meet at a grid-wide barrier between bottlenecks, each bottleneck's
output passing to the next through a device buffer. Within a block q1, q2, t
and r stay in shared memory and registers, and every product runs on the
int8 tensor cores (mma.sync m16n8k32, int32 sums). At ResNet-50's widths a
bottleneck does 1,100 to 2,300 multiply-adds for each activation byte it
reads or writes, so the operations do not bound it: the shared-memory loads
that feed the products, one barrier per 64 bytes of K, and the weights'
re-reads from L2 by every spatial tile do (design note in csrc/qblock.cu).
pick_tile trades the halo's recompute against those re-reads and the card's
fill.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..qmath import round_away

SOURCE = "tengine_tpu_torch/csrc/qblock.cu"
REPLACES = "tengine_tpu/ops/pallas/qblock.py:411"

CHUNK = 32  # the kernel's K chunk: weight rows pad to a multiple

# spatial tiles (tile_h, tile_w) the kernel is built for
TILES = ((8, 8), (7, 7), (4, 4))
# the kernel's shared-memory layout (csrc/qblock.cu): a ring of STAGES
# chunks, rows RING_ROW_WORDS words apart; at most SMEM_LIMIT bytes a block
STAGES = 4
RING_ROW_WORDS = 20
SMEM_LIMIT = 227 * 1024
SM_FILL = 128  # 64-pixel tiles below which pick_tile takes 4×4


def gemm_tile(tile, c_mid: int) -> Tuple[int, int]:
    """The (BM, BN) GEMM tile the kernel runs a spatial tile with
    (qblock_chain_launch in csrc/qblock.cu)."""
    if tile[0] * tile[1] <= 16:
        return 16, 256
    return (64, 64) if c_mid <= 64 else (64, 128)


def _pad8(v: int) -> int:
    """The smallest row stride >= v that is 8 mod 16 words (pad8 in the .cu)."""
    return v + (24 - v % 16) % 16


def smem_bytes(tile, c_mid: int, c_out: int) -> int:
    """Dynamic shared memory of one thread block (smem_words in the .cu): q2
    [kwm][pad8(BM)] words, the ring, q1 [kwm][pad8(halo pixels)] words, the
    staged output tile [BM][BN / 4 + 4] words, then M and B of the
    bottleneck, m1 b1 m2 b2 at stride kp_mid and m3 b3 m4 b4 at stride c_out
    rounded up to 8."""
    bm, bn = gemm_tile(tile, c_mid)
    kp_mid = _ru(c_mid, CHUNK)
    kwm = kp_mid // 4
    halo = (tile[0] + 2) * (tile[1] + 2)
    return 4 * (kwm * _pad8(bm) + STAGES * (bm + bn) * RING_ROW_WORDS + kwm * _pad8(halo)
                + bm * (bn // 4 + 4) + 4 * kp_mid + 4 * _ru(c_out, 8))


@dataclass(frozen=True)
class QBlock:
    """Static config of one bottleneck block in a chain (scales are compile-
    time constants; all activation tensors int8 symmetric, zp = 0)."""

    c_in: int
    c_mid: int
    c_out: int
    act1: int = 0       # conv1 fused activation (-1 none, 0 relu, >0 clamp)
    act2: int = 0       # conv2 fused activation
    s_mid: float = 1.0  # conv3 output (pre-add intermediate) scale
    s_r: float = 1.0    # residual tensor scale
    s_out: float = 1.0  # eltwise-sum output scale
    # trailing ReLu node's output scale, or None when the block ends at the
    # sum. The separate-node numerics (dequant, max 0, requant — a second
    # rounding) are reproduced exactly; s_relu == s_out degenerates to the
    # in-domain max without changing a bit (x*1.0 is exact).
    s_relu: Optional[float] = None
    proj: bool = False  # residual = requant(conv4(x)) instead of x
    s1: float = 1.0     # conv1 output scale (for act>0 clamp thresholds)
    s2: float = 1.0     # conv2 output scale


def build_block_args(blk: QBlock, w1, b1_q, w2, b2_q, w3, b3_q,
                     s_in, sw1, sw2, sw3, w4=None, b4_q=None, sw4=None,
                     s4_in=None, relaxed: bool = False):
    """Host-side packing of one block's kernel arguments.

    w* are OIHW int8 weights; b*_q int32 biases (or None); sw* per-channel
    weight scales; s_in the block input scale. Requant vectors follow the
    engine's fold (ops/quantized.py): M = s_in*s_w/s_out, B = bias*M.
    Returns the flat list of arrays in kernel order.

    relaxed: fold conv3/proj multipliers directly to the block-output scale
    (the trailing ReLu's when present) — the single-rounding tier; the
    kernel then skips the mid-tensor/sum/relu requant grids entirely.
    """

    def mk(w_oihw, s_prev, sw, s_out, b_q):
        o = w_oihw.shape[0]
        k = w_oihw.shape[2]
        t = w_oihw.transpose(2, 3, 1, 0).reshape(k * k, w_oihw.shape[1], o)
        wk = np.ascontiguousarray(t.astype(np.int8))
        m = (s_prev * np.asarray(sw, np.float32).reshape(-1) / s_out).astype(
            np.float32
        )
        b0 = np.zeros(o, np.int64) if b_q is None else b_q.astype(np.int64)
        bv = (b0.astype(np.float64) * m).astype(np.float32)
        return wk, m.reshape(1, -1), bv.reshape(1, -1)

    s_fin = blk.s_relu if blk.s_relu is not None else blk.s_out
    w1k, m1, b1 = mk(w1, s_in, sw1, blk.s1, b1_q)
    w2k, m2, b2 = mk(w2, blk.s1, sw2, blk.s2, b2_q)
    w3k, m3, b3 = mk(w3, blk.s2, sw3, s_fin if relaxed else blk.s_mid, b3_q)
    args = [w1k[0], m1, b1, w2k, m2, b2, w3k[0], m3, b3]
    if blk.proj:
        w4k, m4, b4 = mk(w4, s4_in if s4_in is not None else s_in, sw4,
                         s_fin if relaxed else blk.s_r, b4_q)
        args += [w4k[0], m4, b4]
    return args


def _ru(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def args_per_block(blk: QBlock) -> int:
    return 12 if blk.proj else 9


def pack_block_args(args: Sequence[np.ndarray]) -> List[np.ndarray]:
    """build_block_args' arrays of one block in the CUDA kernel's layout:
    1×1 weights [K, N] -> [N, Kp], the 3×3's [9, K, N] -> [N, 9, Kp], int8
    with K zero-padded to Kp, a multiple of 32; M and B [1, N] -> [N]."""
    out = []
    for a in args:
        a = np.asarray(a)
        if a.dtype != np.int8:
            out.append(np.ascontiguousarray(a.reshape(-1), np.float32))
            continue
        t = a.T if a.ndim == 2 else a.transpose(2, 0, 1)  # N first, K last
        packed = np.zeros(t.shape[:-1] + (_ru(t.shape[-1], CHUNK),), np.int8)
        packed[..., : t.shape[-1]] = t
        out.append(packed)
    return out


def _f32(v: float) -> float:
    """A Python float holding the f32 nearest to v: what a weak-typed JAX
    constant becomes beside an f32 array."""
    return float(np.float32(v))


def act_bounds(act: int, s: float) -> Tuple[float, float]:
    """The activation clamp's thresholds in the requant domain, computed in
    double and rounded to f32 (the Pallas kernel's static constants)."""
    if act is None or act < 0:
        return 0.0, 0.0
    if act == 1:
        return _f32(-1.0 / s), _f32(1.0 / s)
    return 0.0, _f32(float(act) / s)


def _requant_plain(acc, m, b, act, s):
    q = acc * m + b
    if act is not None and act >= 0:
        lo, hi = act_bounds(act, s)
        if act == 1:
            q = torch.clamp(q, lo, hi)
        else:
            q = torch.clamp_min(q, 0.0)
            if act > 0:
                q = torch.clamp_max(q, hi)
    return torch.clamp(round_away(q), -127.0, 127.0)


def _conv_exact(x_f32, w_packed, k: int):
    """NHWC conv of integer-valued tensors in float64 (every partial sum far
    below 2^53), zero padding k//2, stride 1; returns f32 [N, H, W, O]."""
    c = int(x_f32.shape[-1])
    o = int(w_packed.shape[0])
    w = w_packed.reshape(o, k, k, -1)[..., :c].permute(0, 3, 1, 2).to(torch.float64)
    acc = F.conv2d(x_f32.permute(0, 3, 1, 2).to(torch.float64), w, padding=k // 2)
    return acc.permute(0, 2, 3, 1).to(torch.float32)


def inv_s_out(blk: "QBlock") -> float:
    """f32(1 / s_out): the exact tier requantizes the sum by multiplying by
    the scale's f32 reciprocal, which is what XLA compiles the JAX kernel's
    division by the constant s_out to."""
    return float(np.float32(1.0) / np.float32(blk.s_out))


def relu_k(blk: "QBlock") -> float:
    """f32(s_out * f32(1 / s_relu)): a trailing ReLu on its own grid is one
    multiply by this constant, XLA's fold of the JAX kernel's
    max(y, 0) * s_out / s_relu. 1.0 when the block has no such ReLu."""
    if blk.s_relu is None:
        return 1.0
    return float(np.float32(blk.s_out) * (np.float32(1.0) / np.float32(blk.s_relu)))


def qblock_plain(cur, a, blk: QBlock, relaxed: bool):
    """One block of the plain version: cur [N, H, W, c_in] f32 holding int8
    values, a the block's packed arguments. Returns f32 [N, H, W, c_out]."""
    w1, m1, b1, w2, m2, b2, w3, m3, b3 = a[:9]
    q1 = _requant_plain(_conv_exact(cur, w1, 1), m1, b1, blk.act1, blk.s1)
    q2 = _requant_plain(_conv_exact(q1, w2, 3), m2, b2, blk.act2, blk.s2)
    acc3 = _conv_exact(q2, w3, 1)
    if relaxed:
        s_fin = blk.s_relu if blk.s_relu is not None else blk.s_out
        y = acc3 * m3 + b3
        if blk.proj:
            y = y + _conv_exact(cur, a[9], 1) * a[10] + a[11]
        else:
            y = y + cur * _f32(blk.s_r / s_fin)
        if blk.s_relu is not None:
            y = torch.clamp_min(y, 0.0)
        return torch.clamp(round_away(y), -127.0, 127.0)
    t = _requant_plain(acc3, m3, b3, -1, 1.0)
    if blk.proj:
        r = _requant_plain(_conv_exact(cur, a[9], 1), a[10], a[11], -1, 1.0)
    else:
        r = cur
    y = round_away((t * _f32(blk.s_mid) + r * _f32(blk.s_r)) * inv_s_out(blk))
    y = torch.clamp(y, -127.0, 127.0)
    if blk.s_relu is not None:
        y = torch.clamp_min(y, 0.0)
        if blk.s_relu != blk.s_out:
            y = round_away(y * relu_k(blk))
            y = torch.clamp(y, -127.0, 127.0)
    return y


def _split_args(block_args, blocks):
    per, off = [], 0
    for blk in blocks:
        n = args_per_block(blk)
        per.append(list(block_args[off:off + n]))
        off += n
    if off != len(block_args):
        raise ValueError(f"qblock_chain: {len(block_args)} arguments for blocks that take {off}")
    return per


def qblock_chain_plain(x, block_args, blocks: Sequence[QBlock], relaxed: bool = False):
    """The plain PyTorch version of qblock_chain: same inputs, same result.
    x [N, H, W, c_in] int8, block_args the flat list of pack_block_args'
    tensors for every block. Exact float64 convs and the kernel's f32
    epilogue, op for op. Returns int8 [N, H, W, c_out]."""
    cur = x.to(torch.float32)
    for blk, a in zip(blocks, _split_args(block_args, blocks)):
        cur = qblock_plain(cur, a, blk, relaxed)
    return cur.to(torch.int8)


class QblockArgs(ctypes.Structure):
    """One block's arguments, field for field as struct QblockArgs in
    csrc/qblock.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "x", "out", "w1", "m1", "b1", "w2", "m2", "b2", "w3", "m3", "b3",
            "w4", "m4", "b4")]
        + [(f, ctypes.c_int) for f in (
            "n", "h", "w", "c_in", "c_mid", "c_out", "kp_in", "kp_mid",
            "tile_h", "tile_w", "act1", "act2", "proj", "relaxed", "relu")]
        + [(f, ctypes.c_float) for f in (
            "act1_lo", "act1_hi", "act2_lo", "act2_hi", "s_mid", "s_r",
            "inv_s_out", "relu_k", "beta")]
    )


MAX_CHAIN = 8  # blocks of one launch (MAX_CHAIN in csrc/qblock.cu)


class ChainArgs(ctypes.Structure):
    """The kernel's argument block, as struct ChainArgs in csrc/qblock.cu."""

    _fields_ = [("nblocks", ctypes.c_int), ("blk", QblockArgs * MAX_CHAIN)]


def pick_tile(n: int, h: int, w: int) -> Tuple[int, int]:
    """The spatial tile of one thread block: a 64-pixel tile (8×8, or 7×7
    where that wastes fewer pixels) while it gives at least SM_FILL tiles,
    about one for each SM; else 4×4, which recomputes more of conv1's halo
    and re-reads the weights for fewer pixels but fills the card. Measured at
    ResNet-50-224 b32 (PERF.md §6): 7×7 beats 4×4 at 128 tiles (stage 3) and
    loses at 32 (stage 4)."""
    def count(t):
        return n * (-(-h // t)) * (-(-w // t))

    big = min((8, 7), key=lambda t: (count(t) * t * t, -t))
    if count(big) >= SM_FILL:
        return big, big
    return 4, 4


def _check(cond, what):
    if not cond:
        raise ValueError(f"qblock_chain: {what}")


def _block_args(x, out, a, blk: QBlock, relaxed: bool, tile) -> QblockArgs:
    """Check one block's operands and fill its QblockArgs. Raises on what the
    kernel does not take."""
    n, h, w, c_in = map(int, x.shape)
    _check(x.dtype == torch.int8 and x.is_contiguous() and x.data_ptr() % 16 == 0,
           "x must be a contiguous 16-byte-aligned int8 NHWC tensor")
    _check(c_in == blk.c_in, f"x has {c_in} channels, the block takes {blk.c_in}")
    _check(blk.proj or blk.c_in == blk.c_out, "an identity residual needs c_in == c_out")
    _check(tile in TILES, f"tile {tile} is not one of {sorted(TILES)}")
    _check(smem_bytes(tile, blk.c_mid, blk.c_out) <= SMEM_LIMIT,
           f"tile {tile} at c_mid {blk.c_mid} needs more than {SMEM_LIMIT} bytes of shared memory")
    kp_in, kp_mid = _ru(blk.c_in, CHUNK), _ru(blk.c_mid, CHUNK)
    shapes = [(blk.c_mid, kp_in), (blk.c_mid,), (blk.c_mid,),
              (blk.c_mid, 9, kp_mid), (blk.c_mid,), (blk.c_mid,),
              (blk.c_out, kp_mid), (blk.c_out,), (blk.c_out,)]
    if blk.proj:
        shapes += [(blk.c_out, kp_in), (blk.c_out,), (blk.c_out,)]
    _check(len(a) == len(shapes), f"a block with proj={blk.proj} takes {len(shapes)} arguments")
    for i, (t, shape) in enumerate(zip(a, shapes)):
        want = torch.int8 if len(shape) > 1 else torch.float32
        _check(t.dtype == want and tuple(t.shape) == shape and t.is_contiguous()
               and t.device == x.device and t.data_ptr() % 16 == 0,
               f"argument {i} must be a contiguous 16-byte-aligned {want} {shape} on {x.device}")
    _check(n * h * w * max(blk.c_in, blk.c_out) < 2 ** 31, "tensor too large for 32-bit offsets")

    s_fin = blk.s_relu if blk.s_relu is not None else blk.s_out
    lo1, hi1 = act_bounds(blk.act1, blk.s1)
    lo2, hi2 = act_bounds(blk.act2, blk.s2)
    ptr = [t.data_ptr() for t in a] + [None] * (12 - len(a))
    return QblockArgs(
        x.data_ptr(), out.data_ptr(), *ptr,
        n, h, w, blk.c_in, blk.c_mid, blk.c_out, kp_in, kp_mid, tile[0], tile[1],
        -1 if blk.act1 is None else int(blk.act1), -1 if blk.act2 is None else int(blk.act2),
        int(blk.proj), int(relaxed),
        0 if blk.s_relu is None else (1 if blk.s_relu == blk.s_out else 2),
        lo1, hi1, lo2, hi2, _f32(blk.s_mid), _f32(blk.s_r), inv_s_out(blk),
        relu_k(blk), _f32(blk.s_r / s_fin),
    )


def _launch_chain(x, per, blocks, relaxed: bool, tile):
    """One launch of csrc/qblock.cu on the current stream: at most MAX_CHAIN
    blocks of one geometry, each writing a buffer of its own that the next
    reads after the kernel's grid-wide barrier. Raises if the launch returns
    a CUDA error."""
    from .build import load

    _check(len({b.c_mid for b in blocks}) == 1, "the blocks of a chain share one c_mid")
    chain = ChainArgs(nblocks=len(blocks))
    cur = x
    for i, (blk, a) in enumerate(zip(blocks, per)):
        out = torch.empty(tuple(cur.shape[:3]) + (blk.c_out,), dtype=torch.int8, device=x.device)
        chain.blk[i] = _block_args(cur, out, a, blk, relaxed, tile)
        cur = out
    fn = load("qblock").qblock_chain_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ChainArgs), ctypes.c_void_p]
    rc = fn(ctypes.byref(chain), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qblock_chain: kernel launch failed with CUDA error {rc}")
    return cur


def qblock_chain(x, block_args, blocks: Sequence[QBlock], relaxed: bool = False, tile=None):
    """A chain of fused int8 bottlenecks: x [N, H, W, c_in] int8 (already
    subsampled where the head block has stride 2), block_args the flat list
    of pack_block_args' tensors for every block, blocks their QBlock
    configs. Returns int8 [N, H, W, c_out] of the last block.

    On a CUDA tensor this launches the kernel, once for every MAX_CHAIN
    blocks (or raises); on a CPU tensor, or a meta tensor during shape
    inference, it runs qblock_chain_plain. qblock_chain.launches counts
    kernel launches. tile forces one of TILES (the card tests cover each);
    None picks by shape."""
    blocks = tuple(blocks)
    per = _split_args(block_args, blocks)
    if x.is_cuda:
        n, h, w, _ = map(int, x.shape)
        tile = tuple(tile) if tile is not None else pick_tile(n, h, w)
        cur = x
        for lo in range(0, len(blocks), MAX_CHAIN):
            cur = _launch_chain(cur, per[lo:lo + MAX_CHAIN], blocks[lo:lo + MAX_CHAIN], relaxed, tile)
            qblock_chain.launches += 1
        return cur
    if x.device.type in ("cpu", "meta"):
        return qblock_chain_plain(x, block_args, blocks, relaxed)
    raise ValueError(f"qblock_chain: no version for device {x.device}")


qblock_chain.launches = 0
