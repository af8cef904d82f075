"""Tests that need an NVIDIA card: each hand-written CUDA kernel of the port
against its plain PyTorch version, on the card. They skip where
torch.cuda.is_available() is false. The seeded input grids live here and
tests/test_torch_stem.py, tests/test_torch_qconv.py and
tests/test_torch_dwconv.py hold the plain versions to the Pallas kernels
with them on the CPU (tests/test_torch_qblock.py does so for the chain
kernel, on the JAX test's own cases). This file imports
neither JAX nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tengine_tpu_torch.ops.cuda.stem_conv import (  # noqa: E402
    pack_stem_weights,
    stem_qconv,
    stem_qconv_plain,
)

# the grid of tests/test_qconv_pallas.py (TestStemConv), plus the yolov5s
# stem geometry at 64x64
STEM_CASES = [
    # k, pad, act, mode, zp_w, B, H
    (6, 2, 100, "s8", 0, 2, 32),
    (3, 1, 0, "u8", 0, 2, 32),
    (7, 3, -1, "s8", 0, 2, 32),
    (6, 2, 6, "u8", 113, 2, 32),
    (6, 2, 100, "s8", 0, 1, 64),
]


def stem_inputs(k, mode, zp_w, B, H, seed, C=3, Cout=32, W=None):
    """Seeded numpy stem inputs: raw x, float weights holding stored
    integers, requant multiplier and bias, and the quant scalars."""
    rng = np.random.default_rng(seed)
    W = H if W is None else W
    if mode == "s8":
        x = rng.integers(-127, 128, (B, C, H, W)).astype(np.int8)
        zp_in = zp_out = 0
        lo, hi = -127, 127
        w = rng.integers(-127, 128, (Cout, C, k, k)).astype(np.float32)
    else:
        x = rng.integers(0, 256, (B, C, H, W)).astype(np.uint8)
        zp_in, zp_out, lo, hi = 117, 121, 0, 255
        w = rng.integers(0 if zp_w else -127, 128 + (128 if zp_w else 0),
                         (Cout, C, k, k)).astype(np.float32)
    mult = rng.random(Cout).astype(np.float32) * 1e-3 + 1e-4
    bias = rng.standard_normal(Cout).astype(np.float32)
    return x, w, mult, bias, dict(zp_in=zp_in, zp_out=zp_out, lo=lo, hi=hi, s_out=0.05)


def stem_port_args(x, w, mult, bias, q, k, zp_w):
    """The wrapper's tensors (raw x and pack_stem_weights' matrix, M and B)
    and pack_stem_weights' w_corr."""
    wm, m, b, w_corr = pack_stem_weights(
        w, mult, bias, k=k, zp_in=q["zp_in"], zp_w=zp_w, signed_in=x.dtype == np.int8
    )
    return [torch.from_numpy(a) for a in (x, wm, m, b)], w_corr


# the stem kernel's edges: Cout 16/24/48/64 (partial n-tiles, two channel
# chunks, stores narrower than 16 bytes), C_in 1, 2 and 4, uint8 weights with
# zp_w 1, 128 (a ones column with w_corr 0) and 255, k 3/5/6/7, OH odd (no
# multiple of the 2-row tile), OW above 320 (two column tiles), W % 4 == 2
# (the band's byte path)
#   k, pad, act, mode, zp_w, B, H, W, C, Cout
STEM_EDGE_CASES = [
    (3, 1, 0, "u8", 1, 2, 34, 34, 1, 16),
    (6, 2, 100, "s8", 0, 1, 30, 30, 2, 24),
    (7, 3, 6, "u8", 128, 1, 32, 32, 4, 48),
    (6, 2, -1, "u8", 255, 2, 20, 24, 3, 64),
    (3, 1, 1, "s8", 0, 1, 16, 660, 3, 32),
    (5, 2, 0, "u8", 0, 2, 18, 22, 3, 32),
    (7, 3, 100, "u8", 200, 1, 14, 18, 4, 16),
]


def stem_edge_inputs(case, seed):
    """stem_inputs of one STEM_EDGE_CASES case and its wrapper keywords."""
    k, pad, act, mode, zp_w, B, H, W, C, Cout = case
    x, w, mult, bias, q = stem_inputs(k, mode, zp_w, B, H, seed, C=C, Cout=Cout, W=W)
    return x, w, mult, bias, q, dict(k=k, pad=pad, act=act, **q)


# the grid of tests/test_qconv_pallas.py:102-114:
#   N, H, C, O, k, s, pad, u8, per_channel, act, ones_col
QCONV_CASES = [
    (2, 12, 128, 32, 3, 1, 1, True, False, 0, True),
    (2, 12, 128, 32, 3, 1, 1, True, False, 0, False),
    (2, 12, 128, 32, 3, 2, 1, True, False, -1, True),
    (2, 12, 128, 32, 1, 1, 0, True, False, 0, False),
    (2, 12, 128, 32, 3, 1, 1, False, True, 0, False),
    (2, 12, 128, 32, 3, 2, 1, False, True, -1, False),
    (2, 14, 128, 24, 5, 1, 2, False, True, 0, False),
    (1, 12, 256, 32, 1, 1, 0, False, True, -1, False),
    (4, 12, 128, 130, 3, 1, 1, True, False, 0, True),
    (2, 12, 64, 48, 1, 1, 0, True, False, 0, False),
]
# fused residual (+ relu) cases: N, H, C, O, k, s, pad, u8, per_channel, act, relu2
QCONV_RES_CASES = [
    (2, 12, 128, 32, 3, 1, 1, True, False, 0, True),
    (2, 12, 128, 32, 3, 1, 1, False, True, -1, False),
    (2, 12, 128, 40, 3, 2, 1, False, True, 0, True),
    (2, 12, 128, 32, 1, 1, 0, True, False, -1, True),
    (2, 12, 64, 48, 1, 1, 0, False, True, -1, False),
    (1, 12, 256, 130, 1, 1, 0, False, True, 0, True),
]
# qgemm_requant: M, K, N, u8, act
QGEMM_CASES = [
    (64, 128, 128, False, -1),
    (77, 200, 45, False, 0),
    (96, 256, 130, False, 6),
    (50, 96, 33, False, 1),
    (64, 128, 128, True, -1),
    (77, 200, 45, True, 0),
    (33, 160, 130, True, 6),
    (50, 96, 61, True, 1),
]


def qconv_inputs(case, seed, with_res=False):
    """Seeded numpy inputs of one qconv case, as tests/test_qconv_pallas.py
    run_case makes them: raw x, stored [O, C, k, k] weights, the host folds
    M and B (float64 on the host, then f32), the epilogue keywords, and with
    with_res a residual of the output's dtype with its res tuple."""
    N, H, C, O, kh, s, pad, u8, per_channel, act, flag = case
    rng = np.random.default_rng(seed)
    if u8:
        x = rng.integers(0, 256, (N, H, H, C)).astype(np.uint8)
        w = rng.integers(0, 256, (O, C, kh, kh)).astype(np.uint8)
        zp_in, zp_w, s_w = 7, 131, 0.01
    else:
        x = rng.integers(-127, 128, (N, H, H, C)).astype(np.int8)
        w = rng.integers(-127, 128, (O, C, kh, kh)).astype(np.int8)
        zp_in, zp_w = 0, 0
        s_w = rng.uniform(0.005, 0.02, O).astype(np.float32) if per_channel else 0.01
    s_in, s_out = 0.02, 0.05
    bias = rng.integers(-1000, 1000, O).astype(np.int32)
    zp_out = 9 if u8 else 0
    sw = s_w if np.ndim(s_w) else np.full(O, s_w, np.float32)
    M = (s_in * sw / s_out).astype(np.float32)
    if u8:
        cx, cw = 128 - zp_in, 128 - zp_w
        colsum = (w.astype(np.int32) - 128).sum(axis=(1, 2, 3))
        b0 = cx * colsum + C * kh * kh * cx * cw + bias
    else:
        cw, b0 = 0, bias
    B = (b0.astype(np.float64) * M + zp_out).astype(np.float32)
    kw_args = dict(
        cw=cw, act=act, inv_s_out=1 / s_out, zp_out=zp_out,
        lo=0 if u8 else -127, hi=255 if u8 else 127,
        out_dtype="uint8" if u8 else "int8",
    )
    geo = dict(kh=kh, kw=kh, stride=s, pad_t=pad, pad_b=pad, pad_l=pad, pad_r=pad, zp_in=zp_in)
    OH = (H + 2 * pad - kh) // s + 1
    residual = res = None
    if with_res:
        lo, hi = kw_args["lo"], kw_args["hi"]
        residual = rng.integers(lo, hi + 1, (N, OH, OH, O)).astype(x.dtype)
        res = (s_out, zp_out, 0.03, 5 if u8 else 0, 0.07, 11 if u8 else 0, bool(flag))
    return dict(x=x, w=w, u8=u8, M=M, B=B, kw_args=kw_args, geo=geo,
                residual=residual, res=res, pointwise=kh == 1 and s == 1 and pad == 0)


# Aimed at the tensor-core kernel's seams: M that no block tile divides, C2
# and C around and between the tile and K-chunk widths (8- and 4-byte copies
# and the scalar loader for C % 16 != 0, byte stores for C2 % 4 != 0), K long
# enough that |acc| passes 2^24 and the int -> f32 conversion rounds ("max"
# fill: operands of magnitude 120..127), 49 and 25 taps, stride 2 on odd sizes with asymmetric
# pads, uint8 with zp_in far from 128 on padded borders and cw != 0, with
# and without a residual (+ relu).
#   N, H, W, C, O, k, s, (pad_t, pad_b, pad_l, pad_r), u8, act, res (None,
#   "sum", "relu"), fill ("rand", "max"), zp_in (uint8 only)
QCONV_EDGE_CASES = [
    (1, 13, 13, 128, 64, 3, 1, (1, 1, 1, 1), False, 0, None, "rand", 0),
    (1, 7, 11, 96, 24, 1, 1, (0, 0, 0, 0), False, -1, None, "rand", 0),
    (2, 5, 7, 8, 8, 1, 1, (0, 0, 0, 0), False, 0, None, "rand", 0),
    (2, 5, 7, 24, 24, 1, 1, (0, 0, 0, 0), True, -1, "relu", "rand", 200),
    (2, 5, 7, 48, 40, 1, 1, (0, 0, 0, 0), False, 6, "sum", "rand", 0),
    (2, 5, 7, 96, 64, 1, 1, (0, 0, 0, 0), True, 0, None, "rand", 3),
    (2, 5, 7, 384, 130, 1, 1, (0, 0, 0, 0), False, 1, "relu", "rand", 0),
    (1, 9, 9, 1024, 256, 1, 1, (0, 0, 0, 0), False, -1, None, "rand", 0),
    (1, 6, 6, 512, 32, 3, 1, (1, 1, 1, 1), False, -1, None, "max", 0),
    (1, 6, 6, 512, 32, 3, 1, (1, 1, 1, 1), True, -1, None, "max", 126),
    (1, 6, 5, 2048, 16, 1, 1, (0, 0, 0, 0), False, 0, "sum", "max", 0),
    (2, 15, 13, 128, 40, 7, 2, (3, 3, 3, 3), False, 0, None, "rand", 0),
    (1, 11, 11, 128, 32, 5, 1, (2, 2, 2, 2), True, -1, "sum", "rand", 251),
    (2, 15, 15, 128, 32, 3, 2, (0, 1, 0, 1), False, -1, None, "rand", 0),
    (2, 15, 13, 128, 32, 3, 2, (1, 0, 2, 1), True, 0, "relu", "rand", 77),
    (1, 9, 9, 24, 8, 3, 1, (1, 1, 1, 1), True, 0, None, "rand", 19),
    (3, 10, 10, 384, 130, 3, 1, (1, 1, 1, 1), True, 6, "relu", "rand", 240),
    (4, 12, 12, 256, 256, 3, 2, (1, 1, 1, 1), False, 0, "sum", "rand", 0),
    # C a multiple of 4 only (4-byte copies), and of nothing (the scalar loader)
    (2, 9, 7, 12, 16, 3, 1, (1, 1, 1, 1), False, 0, None, "rand", 0),
    (2, 9, 7, 20, 24, 3, 2, (1, 1, 1, 1), True, -1, "relu", "rand", 33),
    (2, 6, 5, 7, 8, 1, 1, (0, 0, 0, 0), False, -1, None, "rand", 0),
    (1, 10, 10, 3, 32, 3, 1, (1, 1, 1, 1), True, 0, None, "rand", 140),
    (1, 8, 8, 70, 33, 3, 1, (1, 1, 1, 1), False, 6, "sum", "rand", 0),
]
# qgemm_requant: M, K, N, u8, act, fill
QGEMM_EDGE_CASES = [
    (169, 384, 128, False, 0, "rand"),
    (77, 24, 8, True, -1, "rand"),
    (1, 2048, 1000, False, -1, "rand"),
    (32, 2048, 1000, False, -1, "max"),
    (300, 48, 40, True, 1, "rand"),
    (130, 1024, 256, True, 6, "max"),
    (65, 8, 24, False, 0, "rand"),
    (50, 12, 24, True, -1, "rand"),
    (33, 7, 8, False, 0, "rand"),
]
# the block tiles csrc/qconv.cu is built for (ops/cuda/qconv.py:TILES), the
# 128-channel ones under both of their routes (WGMMA_TILES)
IGEMM_TILES = [(128, 128, "mma"), (128, 128, "wgmma"), (64, 128, "mma"), (64, 128, "wgmma"),
               (128, 64), (64, 64), (128, 32), (64, 32)]


def wgmma_refused(inp, tile):
    """Whether forcing `tile` on this case must raise: the warpgroup route
    takes int8 input without a rowsum term only."""
    return tile is not None and tile[2:] == ("wgmma",) and (inp["u8"] or inp["kw_args"]["cw"] != 0)


def _fill(rng, fill, shape, u8, signed_rows=False):
    """Stored operand values: uniform over the dtype's range, or ("max") of
    magnitude 120..127 above the dtype's centre, so that every product is
    near 127^2 and a sum over K of them passes 2^24; with signed_rows each
    leading index (an output channel's weights) takes one random sign."""
    if fill == "rand":
        return (rng.integers(0, 256, shape).astype(np.uint8) if u8
                else rng.integers(-127, 128, shape).astype(np.int8))
    v = rng.integers(120, 128, shape)
    if signed_rows:
        v = v * rng.choice([-1, 1], (shape[0],) + (1,) * (len(shape) - 1))
    return (v + 128).astype(np.uint8) if u8 else v.astype(np.int8)


def qconv_edge_inputs(case, seed):
    """Seeded numpy inputs of one QCONV_EDGE_CASES entry, in the form of
    qconv_inputs. The multiplier puts outputs around +-50 whatever K is, so
    neither the clip nor the relu hides the arithmetic."""
    N, H, W, C, O, k, s, pads, u8, act, res_kind, fill, zp_in = case
    rng = np.random.default_rng(seed)
    x = _fill(rng, fill, (N, H, W, C), u8)
    w = _fill(rng, fill, (O, C, k, k), u8, signed_rows=True)
    K = C * k * k
    spread = K * 124.0 * 124.0 if fill == "max" else np.sqrt(K) * 73.0 * 73.0
    M = (rng.uniform(0.5, 1.5, O) * 50.0 / spread).astype(np.float32)
    bias = rng.integers(-1000, 1000, O).astype(np.int64)
    zp_out = 9 if u8 else 0
    if u8:
        zp_w = 131
        cx, cw = 128 - zp_in, 128 - zp_w
        b0 = cx * (w.astype(np.int64) - 128).sum(axis=(1, 2, 3)) + K * cx * cw + bias
    else:
        zp_in, cw, b0 = 0, 0, bias
    B = (b0.astype(np.float64) * M + zp_out).astype(np.float32)
    s_out = 0.05
    lo, hi = (0, 255) if u8 else (-127, 127)
    kw_args = dict(cw=cw, act=act, inv_s_out=1 / s_out, zp_out=zp_out, lo=lo, hi=hi,
                   out_dtype="uint8" if u8 else "int8")
    pt, pb, pl, pr = pads
    geo = dict(kh=k, kw=k, stride=s, pad_t=pt, pad_b=pb, pad_l=pl, pad_r=pr, zp_in=zp_in)
    OH, OW = (H + pt + pb - k) // s + 1, (W + pl + pr - k) // s + 1
    residual = res = None
    if res_kind is not None:
        residual = rng.integers(lo, hi + 1, (N, OH, OW, O)).astype(x.dtype)
        res = (s_out, zp_out, 0.03, 5 if u8 else 0, 0.07, 11 if u8 else 0, res_kind == "relu")
    return dict(x=x, w=w, u8=u8, M=M, B=B, kw_args=kw_args, geo=geo, residual=residual,
                res=res, pointwise=k == 1 and s == 1 and not any(pads))


def qgemm_edge_inputs(case, seed):
    """Seeded numpy inputs of one QGEMM_EDGE_CASES entry, in the form of
    qgemm_inputs."""
    Mr, K, N, u8, act, fill = case
    inp = qconv_edge_inputs((1, 1, Mr, K, N, 1, 1, (0, 0, 0, 0), u8, act, None, fill, 121), seed)
    return dict(x=inp["x"].reshape(Mr, K), w=inp["w"].reshape(N, K), u8=u8, M=inp["M"],
                B=inp["B"], kw_args=inp["kw_args"])


def _round_away_np(q):
    """C round() on f32 values: the fraction q - trunc(q) is exact, so ties
    are decided exactly (floor(|q| + 0.5) is not: 0.49999997 + 0.5 is 1.0)."""
    t = np.trunc(q)
    return t + np.sign(q) * (np.abs(q - t) >= np.float32(0.5))


def qconv_oracle(inp):
    """qconv_direct / qconv1x1 in numpy alone: int64 sums over the
    zp_in-padded, re-centred input, wrapped to int32 as the kernel's
    accumulators wrap, then the f32 epilogue op by op (numpy rounds each f32
    op once; int -> f32 rounds to nearest even like __int2float_rn)."""
    a, g = inp["kw_args"], inp["geo"]
    k, s = g["kh"], g["stride"]
    c0 = 128 if inp["u8"] else 0
    x = np.pad(inp["x"].astype(np.int64),
               ((0, 0), (g["pad_t"], g["pad_b"]), (g["pad_l"], g["pad_r"]), (0, 0)),
               constant_values=g["zp_in"]) - c0
    w = inp["w"].astype(np.int64) - c0  # [O, C, k, k]
    OH, OW = (x.shape[1] - k) // s + 1, (x.shape[2] - k) // s + 1
    acc = np.zeros((x.shape[0], OH, OW, w.shape[0]), np.int64)
    rsum = np.zeros((x.shape[0], OH, OW, 1), np.int64)
    for ky in range(k):
        for kx in range(k):
            patch = x[:, ky:ky + (OH - 1) * s + 1:s, kx:kx + (OW - 1) * s + 1:s, :]
            acc += patch @ w[:, :, ky, kx].T
            rsum += patch.sum(axis=-1, keepdims=True)
    accf = acc.astype(np.int32).astype(np.float32)
    if a["cw"]:
        accf = accf + np.float32(a["cw"]) * rsum.astype(np.int32).astype(np.float32)
    q = accf * inp["M"] + inp["B"]
    act, zp_out = a["act"], np.float32(a["zp_out"])
    if act == 1:
        q = np.clip(q, np.float32(a["zp_out"] - a["inv_s_out"]), np.float32(a["zp_out"] + a["inv_s_out"]))
    elif act >= 0:
        q = np.maximum(q, zp_out)
        if act > 0:
            q = np.minimum(q, np.float32(act * a["inv_s_out"] + a["zp_out"]))
    t = np.clip(_round_away_np(q), np.float32(a["lo"]), np.float32(a["hi"]))
    if inp["res"] is not None:
        s_mid, zp_mid, s_r, zp_r, s_out2, zp_out2, relu2 = inp["res"]
        tf = (t - np.float32(zp_mid)) * np.float32(s_mid)
        rf = (inp["residual"].astype(np.float32) - np.float32(zp_r)) * np.float32(s_r)
        y = _round_away_np((tf + rf) * (np.float32(1.0) / np.float32(s_out2))) + np.float32(zp_out2)
        if relu2:
            y = np.maximum(y, np.float32(zp_out2))
        t = np.clip(y, np.float32(a["lo"]), np.float32(a["hi"]))
    return t.astype(np.uint8 if inp["u8"] else np.int8)


def qgemm_oracle(inp):
    """qgemm_requant through qconv_oracle: a 1x1 conv over one row of M pixels."""
    Mr, K = inp["x"].shape
    N = inp["w"].shape[0]
    conv = dict(inp, x=inp["x"].reshape(1, 1, Mr, K), w=inp["w"].reshape(N, K, 1, 1),
                geo=dict(kh=1, kw=1, stride=1, pad_t=0, pad_b=0, pad_l=0, pad_r=0, zp_in=0),
                residual=None, res=None)
    return qconv_oracle(conv).reshape(Mr, N)


def port_qconv(inp, device, kernel=True, tile=None):
    """Run one qconv case through the port on `device`: the kernel's wrapper
    (kernel=True; tile forces the kernel's block tile) or the plain version.
    Returns a numpy NHWC result."""
    from tengine_tpu_torch.ops.cuda import qconv as pq

    x = torch.from_numpy(inp["x"]).to(device)
    wk = torch.from_numpy(pq.pack_qconv_weights(inp["w"], inp["u8"])).to(device)
    M, B = (torch.from_numpy(inp[k]).to(device) for k in ("M", "B"))
    r = torch.from_numpy(inp["residual"]).to(device) if inp["res"] is not None else None
    N, H, W, C = x.shape
    O = wk.shape[0]
    tile_kw = dict(tile=tile) if kernel else {}
    if inp["pointwise"]:
        fn = pq.qconv1x1 if kernel else pq.qconv1x1_plain
        out = fn(x.reshape(-1, C), wk, M, B,
                 residual=None if r is None else r.reshape(-1, O), res=inp["res"],
                 **inp["kw_args"], **tile_kw)
        out = out.reshape(N, H, W, O)
    else:
        fn = pq.qconv_direct if kernel else pq.qconv_direct_plain
        out = fn(x, wk, M, B, residual=r, res=inp["res"], **inp["geo"], **inp["kw_args"],
                 **tile_kw)
    return out.cpu().numpy()


def qgemm_inputs(case, seed):
    """Seeded numpy inputs of one qgemm_requant case: x [M, K], stored
    weights [N, K], the host folds and the epilogue keywords."""
    Mr, K, N, u8, act = case
    rng = np.random.default_rng(seed)
    if u8:
        x = rng.integers(0, 256, (Mr, K)).astype(np.uint8)
        w = rng.integers(0, 256, (N, K)).astype(np.uint8)
        zp_in, zp_w, s_w = 121, 117, np.full(N, 0.01, np.float32)
    else:
        x = rng.integers(-127, 128, (Mr, K)).astype(np.int8)
        w = rng.integers(-127, 128, (N, K)).astype(np.int8)
        zp_in, zp_w = 0, 0
        s_w = rng.uniform(0.002, 0.01, N).astype(np.float32)
    s_in, s_out = 0.03, 0.04
    bias = rng.integers(-2000, 2000, N).astype(np.int64)
    zp_out = 131 if u8 else 0
    mult = (s_in * s_w / s_out).astype(np.float32)
    if u8:
        cx, cw = 128 - zp_in, 128 - zp_w
        b0 = cx * (w.astype(np.int32) - 128).sum(axis=1) + K * cx * cw + bias
    else:
        cw, b0 = 0, bias
    B = (b0.astype(np.float64) * (s_in * s_w / s_out) + zp_out).astype(np.float32)
    kw_args = dict(cw=cw, act=act, inv_s_out=1.0 / s_out, zp_out=zp_out,
                   lo=0 if u8 else -127, hi=255 if u8 else 127,
                   out_dtype="uint8" if u8 else "int8")
    return dict(x=x, w=w, u8=u8, M=mult, B=B, kw_args=kw_args)


def port_qgemm(inp, device, kernel=True, tile=None):
    from tengine_tpu_torch.ops.cuda import qgemm as pg

    x = torch.from_numpy(inp["x"]).to(device)
    wk = torch.from_numpy(pg.pack_qgemm_weights(inp["w"], inp["u8"])).to(device)
    M, B = (torch.from_numpy(inp[k]).to(device) for k in ("M", "B"))
    fn = pg.qgemm_requant if kernel else pg.qgemm_requant_plain
    tile_kw = dict(tile=tile) if kernel else {}
    return fn(x, wk, M, B, **inp["kw_args"], **tile_kw).cpu().numpy()


# dw_qconv: the grid of tests/test_dw_conv_pallas.py:57-69 with symmetric
# pads, then its TF-style pads case (:105), then what that grid lacks: C not
# a multiple of 32 (nor of 4), N = 1, odd H at stride 2 with the bottom pad
# consumed, uint8 with taps beyond int8, k = 5 on a ragged C, and the clip
# activation.
#   N, H, C, k, stride, (pad_t, pad_b, pad_l, pad_r), zp_in, zp_out, act, u8
DW_CASES = [
    (4, 16, 32, 3, 1, (1, 1, 1, 1), 0, 0, -1, False),
    (4, 16, 32, 3, 2, (1, 1, 1, 1), 0, 0, -1, False),
    (4, 16, 256, 3, 1, (1, 1, 1, 1), 0, 3, 0, False),
    (4, 16, 256, 3, 2, (1, 1, 1, 1), -7, 5, -1, False),
    (4, 16, 32, 3, 1, (1, 1, 1, 1), -12, -3, 6, False),
    (4, 16, 32, 5, 1, (2, 2, 2, 2), 0, 0, -1, False),
    (4, 16, 32, 5, 2, (2, 2, 2, 2), -4, 2, -1, False),
    (4, 16, 32, 3, 1, (1, 1, 1, 1), 128, 128, 0, True),
    (4, 14, 64, 3, 1, (1, 1, 1, 1), 0, 0, -1, False),
    (4, 14, 64, 3, 2, (1, 1, 1, 1), 0, 0, -1, False),
    (4, 16, 32, 3, 2, (0, 1, 0, 1), 0, 0, -1, False),
]
DW_EXTRA_CASES = [
    (2, 12, 24, 3, 1, (1, 1, 1, 1), 0, 0, -1, False),
    (1, 16, 32, 3, 2, (1, 1, 1, 1), 0, 0, 0, False),
    (2, 15, 32, 3, 2, (1, 1, 1, 1), -5, 4, -1, False),
    (2, 15, 32, 3, 2, (0, 1, 0, 1), 9, -2, -1, False),
    (2, 12, 24, 3, 2, (1, 1, 1, 1), 119, 131, 6, True),
    (3, 11, 30, 5, 2, (2, 2, 2, 2), 77, 90, -1, True),
    (2, 9, 7, 5, 1, (2, 2, 2, 2), -3, 0, 1, False),
]


# the redesigned dw kernel's edges, each with the tile pick_dw_tile chooses
# (None) and forced tiles (cgw, ncs, nrs, rpt): partial tiles in rows and
# columns, several channel groups (and tiles of several groups in one
# persistent block), both row walks, C = 1024 at 7x7, C = 24 (4-byte copies),
# 30 and 1 (byte copies), N = 1, odd H at stride 2 with the bottom pad
# consumed, uint8 taps at +-255, every activation code (-1, 0, 1, 6), k = 5.
#   (case as DW_CASES, tiles)
DW_EDGE_CASES = [
    ((1, 7, 1024, 3, 1, (1, 1, 1, 1), 0, 0, 0, False), [None, (8, 2, 1, 8), (16, 2, 2, 2)]),
    ((2, 17, 64, 3, 1, (1, 1, 1, 1), 3, -2, -1, False), [None, (4, 2, 1, 8), (16, 4, 2, 2)]),
    ((1, 33, 32, 3, 2, (1, 1, 1, 1), -5, 4, 6, False), [None, (4, 4, 2, 8), (8, 1, 1, 2)]),
    ((2, 13, 48, 3, 2, (0, 1, 0, 1), 0, 0, -1, False), [None, (12, 2, 1, 8), (4, 4, 2, 2)]),
    ((2, 15, 24, 3, 1, (1, 1, 1, 1), 119, 131, 1, True), [None, (3, 4, 2, 2)]),
    ((1, 11, 30, 5, 1, (2, 2, 2, 2), 77, 90, 6, True), [None, (2, 2, 2, 4)]),
    ((3, 12, 32, 5, 2, (2, 2, 2, 2), 0, 0, 0, False), [None, (8, 1, 1, 4)]),
    ((2, 9, 1, 3, 1, (1, 1, 1, 1), -9, 7, -1, False), [None]),
    ((4, 20, 96, 3, 1, (1, 1, 1, 1), 128, 120, 6, True), [None, (8, 8, 2, 8), (4, 2, 1, 2)]),
]


# mobilenet-v1-224's nine depthwise shapes on the native-int8 plan's grids:
# a UINT8 grid shifted to INT8 (zp - 128, full range [-128, 127]), so the
# pad bytes carry a negative zp_in down to -128 (0x80), the ReLU clamps at
# 0 and zp_out sits near -128.
#   case as DW_CASES
DW_SHIFTED_CASES = [
    (1, 112, 32, 3, 1, (1, 1, 1, 1), -128, -128, 0, False),
    (1, 112, 64, 3, 2, (1, 1, 1, 1), -97, -120, 0, False),
    (1, 56, 128, 3, 1, (1, 1, 1, 1), -110, -128, 0, False),
    (1, 56, 128, 3, 2, (1, 1, 1, 1), -75, -101, 0, False),
    (1, 28, 256, 3, 1, (1, 1, 1, 1), -128, -90, 0, False),
    (1, 28, 256, 3, 2, (1, 1, 1, 1), -64, -127, 0, False),
    (2, 14, 512, 3, 1, (1, 1, 1, 1), -119, -128, 0, False),
    (2, 14, 512, 3, 2, (1, 1, 1, 1), 3, -128, -1, False),
    (2, 7, 1024, 3, 1, (1, 1, 1, 1), -128, -77, 0, False),
]


def dw_inputs(case, seed, extremes=False):
    """Seeded numpy inputs of one dw_qconv case, as
    tests/test_dw_conv_pallas.py makes them: raw x NHWC, true tap values
    [C, 1, k, k] (beyond int8 on a uint8 case, as w_q - zp_w is), M, the
    folded B = (bias - zp_in·colsum)·M without zp_out, and the keywords.
    With extremes, the first channel's first two taps are set to the widest
    values (+-255 on a uint8 case, +-100 on an int8 one)."""
    N, H, C, k, s, pads, zp_in, zp_out, act, u8 = case
    rng = np.random.default_rng(seed)
    if u8:
        x = rng.integers(0, 256, (N, H, H, C)).astype(np.uint8)
        w = rng.integers(-255, 256, (C, 1, k, k)).astype(np.int32)
    else:
        x = rng.integers(-128, 128, (N, H, H, C)).astype(np.int8)
        w = rng.integers(-100, 101, (C, 1, k, k)).astype(np.int32)
    if extremes:
        w[0, 0, 0, :2] = (255, -255) if u8 else (100, -100)
    M = rng.uniform(0.001, 0.01, C).astype(np.float32)
    if u8:
        M = M * np.float32(0.25)
    colsum = w.reshape(C, -1).sum(axis=1)
    bias = rng.integers(-1000, 1000, C).astype(np.float64)
    B = ((bias - zp_in * colsum) * M.astype(np.float64)).astype(np.float32)
    lo, hi = (0, 255) if u8 else (-128, 127)
    pt, pb, pl, pr = pads
    kw_args = dict(k=k, stride=s, pad_t=pt, pad_b=pb, pad_l=pl, pad_r=pr, zp_in=zp_in,
                   zp_out=zp_out, act=act, s_out=0.05, lo=float(lo), hi=float(hi), out_u8=u8)
    return dict(x=x, w=w, M=M, B=B, kw_args=kw_args)


def port_dw(inp, device, kernel=True, tile=None):
    """Run one dw_qconv case through the port on `device`: the kernel's
    wrapper (kernel=True; `tile` forces its block tile) or the plain version.
    Returns a numpy NHWC result."""
    from tengine_tpu_torch.ops.cuda import dw_conv as pd

    x = torch.from_numpy(inp["x"]).to(device)
    w = torch.from_numpy(pd.pack_dw_taps(inp["w"])).to(device)
    M, B = (torch.from_numpy(inp[k]).to(device) for k in ("M", "B"))
    if kernel:
        return pd.dw_qconv(x, w, M, B, tile=tile, **inp["kw_args"]).cpu().numpy()
    return pd.dw_qconv_plain(x, w, M, B, **inp["kw_args"]).cpu().numpy()


def dw_oracle(inp):
    """dw_qconv in numpy alone: int64 window sums of the zp_in-padded input,
    then the f32 epilogue op by op (numpy rounds each f32 op once)."""
    a = inp["kw_args"]
    k, s = a["k"], a["stride"]
    x = np.pad(inp["x"].astype(np.int64),
               ((0, 0), (a["pad_t"], a["pad_b"]), (a["pad_l"], a["pad_r"]), (0, 0)),
               constant_values=a["zp_in"])
    w = inp["w"][:, 0].astype(np.int64)  # [C, k, k]
    OH = (x.shape[1] - k) // s + 1
    OW = (x.shape[2] - k) // s + 1
    acc = np.zeros((x.shape[0], OH, OW, x.shape[3]), np.int64)
    for ky in range(k):
        for kx in range(k):
            acc += x[:, ky:ky + (OH - 1) * s + 1:s, kx:kx + (OW - 1) * s + 1:s, :] * w[:, ky, kx]
    q = acc.astype(np.float32) * inp["M"] + inp["B"]
    act = a["act"]
    if act == 1:
        q = np.clip(q, np.float32(-1.0 / a["s_out"]), np.float32(1.0 / a["s_out"]))
    elif act >= 0:
        q = np.maximum(q, np.float32(0))
        if act > 0:
            q = np.minimum(q, np.float32(act / a["s_out"]))
    r = np.sign(q) * np.floor(np.abs(q) + np.float32(0.5))
    y = np.clip(r + np.float32(a["zp_out"]), a["lo"], a["hi"])
    return y.astype(np.uint8 if a["out_u8"] else np.int8)


# qblock_chain: the six cases of tests/test_qblock_pallas.py:179-210, then what
# that grid lacks: c_mid above 64 (the kernel's wider GEMM tile), channel
# counts that are no multiple of 16 or 4, the clip and relu-n activations, a
# block that ends at the sum, H, W that no tile divides, and a chain of more
# blocks than one launch takes.
#   N, H, W, c0, c_mid, c_out, nblocks, first_proj, bias, relu ("same" grid,
#   "own" grid, None), (act1, act2)
QBLOCK_CASES = [
    (2, 6, 6, 16, 8, 16, 1, False, True, "same", (0, 0)),
    (2, 5, 7, 16, 8, 16, 3, False, True, "same", (0, 0)),
    (4, 6, 14, 8, 8, 16, 2, True, True, "same", (0, 0)),
    (2, 6, 6, 8, 8, 8, 1, False, False, "same", (0, 0)),
    (8, 7, 7, 8, 8, 8, 2, False, True, "same", (0, 0)),
    (2, 6, 6, 16, 8, 16, 2, False, True, "own", (0, 0)),
]
QBLOCK_EXTRA_CASES = [
    (2, 9, 10, 40, 72, 160, 2, True, True, "same", (0, 0)),
    (1, 8, 8, 64, 96, 64, 2, False, True, "own", (6, 1)),
    (3, 5, 5, 6, 7, 10, 2, True, True, None, (-1, 0)),
    (2, 14, 14, 128, 32, 128, 1, False, False, None, (0, 6)),
    (1, 4, 4, 8, 8, 8, 9, False, True, "same", (0, 0)),  # longer than one launch holds
    # where the tensor-core fragments' bounds bite: c_mid and c_out no
    # multiple of 8 (a part-filled n8 fragment), of 16 or of 32, a second
    # column pass holding one fragment (c_mid 136), c_out no multiple of 4
    # (byte stores), c_in no multiple of 16 (the x rows' scalar loader), odd H
    # and W at every tile, projection then identity heads, both ReLu grids
    (2, 9, 11, 20, 100, 36, 2, True, True, "own", (0, 0)),
    (3, 13, 5, 48, 44, 48, 2, False, True, "own", (1, 0)),
    (2, 7, 9, 64, 136, 250, 1, True, True, "same", (0, 0)),
    (1, 15, 15, 32, 64, 32, 2, False, True, None, (0, 0)),
    (2, 11, 3, 16, 12, 24, 3, True, False, "same", (0, 2)),
]
QBLOCK_TILES = [(8, 8), (7, 7), (4, 4)]


def qblock_inputs(case, seed, relaxed=False):
    """Seeded numpy inputs of one qblock_chain case, in the recipe of
    tests/test_qblock_pallas.py make_block: x [N, H, W, c0] int8, the QBlock
    of every block, and the flat list of the wrapper's arrays
    (build_block_args then pack_block_args)."""
    from tengine_tpu_torch.ops.cuda import qblock as pqb

    N, H, W, c0, c_mid, c_out, nblocks, first_proj, bias, relu, (act1, act2) = case
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (N, H, W, c0)).astype(np.int8)

    def scale():
        return float(rng.uniform(0.01, 0.03))

    blocks, arrays = [], []
    s_prev, cin = 0.02, c0
    for i in range(nblocks):
        proj = first_proj and i == 0
        s_out = scale()
        blk = pqb.QBlock(
            c_in=cin, c_mid=c_mid, c_out=c_out, act1=act1, act2=act2, s1=scale(), s2=scale(),
            s_mid=scale(), s_r=scale() if proj else s_prev, s_out=s_out,
            s_relu={"same": s_out, "own": scale(), None: None}[relu], proj=proj)

        def w(o, c, k):
            return rng.integers(-127, 128, (o, c, k, k)).astype(np.int8)

        def b(o):
            return rng.integers(-8000, 8000, o).astype(np.int32) if bias else None

        def sw(o, k, s_from, s_to):
            # weight scales that put int8 outputs around +-40 at fan-in k
            # (|acc| ~ sqrt(k)*73^2 for uniform int8 operands), so that
            # neither the clip at +-127 nor the relu hides the arithmetic
            m = rng.uniform(0.5, 1.5, o) * 40.0 / (np.sqrt(k) * 73.0 * 73.0)
            return (m * s_to / s_from).astype(np.float32)

        args = pqb.build_block_args(
            blk, w(c_mid, cin, 1), b(c_mid), w(c_mid, c_mid, 3), b(c_mid), w(c_out, c_mid, 1),
            b(c_out), s_prev, sw(c_mid, cin, s_prev, blk.s1), sw(c_mid, 9 * c_mid, blk.s1, blk.s2),
            sw(c_out, c_mid, blk.s2, blk.s_mid),
            w4=w(c_out, cin, 1) if proj else None, b4_q=b(c_out) if proj else None,
            sw4=sw(c_out, cin, s_prev, blk.s_r) if proj else None, relaxed=relaxed)
        arrays += pqb.pack_block_args(args)
        blocks.append(blk)
        s_prev = blk.s_relu if blk.s_relu is not None else blk.s_out
        cin = c_out
    return dict(x=x, blocks=blocks, arrays=arrays, relaxed=relaxed)


def port_qblock(inp, device, kernel=True, tile=None):
    """Run one qblock_chain case through the port on `device`: the kernel's
    wrapper (kernel=True) or the plain version. Returns a numpy NHWC result."""
    from tengine_tpu_torch.ops.cuda import qblock as pqb

    x = torch.from_numpy(inp["x"]).to(device)
    arrays = [torch.from_numpy(a).to(device) for a in inp["arrays"]]
    if kernel:
        out = pqb.qblock_chain(x, arrays, inp["blocks"], relaxed=inp["relaxed"], tile=tile)
    else:
        out = pqb.qblock_chain_plain(x, arrays, inp["blocks"], relaxed=inp["relaxed"])
    return out.cpu().numpy()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("with_res,case", [(False, c) for c in QCONV_CASES]
                         + [(True, c) for c in QCONV_RES_CASES])
def test_qconv_kernel_matches_plain_on_card(with_res, case):
    """qconv_direct / qconv1x1: the kernel equals its plain version bit for
    bit (both accumulate exactly and round the same f32 epilogue)."""
    _need_card()
    from tengine_tpu_torch.ops.cuda import qconv as pq

    inp = qconv_inputs(case, seed=sum(case[:5]), with_res=with_res)
    counter = pq.qconv1x1 if inp["pointwise"] else pq.qconv_direct
    before = counter.launches
    got = port_qconv(inp, "cuda", kernel=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = port_qconv(inp, "cuda", kernel=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None] + IGEMM_TILES, ids=str)
@pytest.mark.parametrize("case", QCONV_EDGE_CASES, ids=str)
def test_qconv_kernel_edge_cases_on_card(case, tile):
    """The tensor-core kernel's seams, under the tile pick_tile chooses and
    under every tile and route forced: bit-equal to the plain version and to
    the numpy oracle; the warpgroup route refuses uint8 input."""
    _need_card()
    from tengine_tpu_torch.ops.cuda import qconv as pq

    inp = qconv_edge_inputs(case, seed=sum(case[:7]))
    counter = pq.qconv1x1 if inp["pointwise"] else pq.qconv_direct
    before = counter.launches
    if wgmma_refused(inp, tile):
        with pytest.raises(ValueError, match="route"):
            port_qconv(inp, "cuda", kernel=True, tile=tile)
        assert counter.launches == before
        return
    got = port_qconv(inp, "cuda", kernel=True, tile=tile)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = port_qconv(inp, "cuda", kernel=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, qconv_oracle(inp))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None] + IGEMM_TILES, ids=str)
@pytest.mark.parametrize("case", QGEMM_EDGE_CASES, ids=str)
def test_qgemm_kernel_edge_cases_on_card(case, tile):
    _need_card()
    from tengine_tpu_torch.ops.cuda import qgemm as pg

    inp = qgemm_edge_inputs(case, seed=sum(case[:3]))
    before = pg.qgemm_requant.launches
    if wgmma_refused(inp, tile):
        with pytest.raises(ValueError, match="route"):
            port_qgemm(inp, "cuda", kernel=True, tile=tile)
        return
    got = port_qgemm(inp, "cuda", kernel=True, tile=tile)
    torch.cuda.synchronize()
    assert pg.qgemm_requant.launches == before + 1
    want = port_qgemm(inp, "cuda", kernel=False)
    assert got.dtype == want.dtype and got.shape == want.shape == (case[0], case[2])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, qgemm_oracle(inp))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", IGEMM_TILES, ids=str)
@pytest.mark.parametrize("with_res,case", [(False, c) for c in QCONV_CASES]
                         + [(True, c) for c in QCONV_RES_CASES])
def test_qconv_kernel_every_tile_on_card(with_res, case, tile):
    """The grid again with each block tile forced."""
    _need_card()
    inp = qconv_inputs(case, seed=sum(case[:5]), with_res=with_res)
    if wgmma_refused(inp, tile):
        with pytest.raises(ValueError, match="route"):
            port_qconv(inp, "cuda", kernel=True, tile=tile)
        return
    np.testing.assert_array_equal(port_qconv(inp, "cuda", kernel=True, tile=tile),
                                  port_qconv(inp, "cuda", kernel=False))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", IGEMM_TILES, ids=str)
@pytest.mark.parametrize("case", QGEMM_CASES, ids=str)
def test_qgemm_kernel_every_tile_on_card(case, tile):
    _need_card()
    inp = qgemm_inputs(case, seed=sum(case[:3]))
    if wgmma_refused(inp, tile):
        with pytest.raises(ValueError, match="route"):
            port_qgemm(inp, "cuda", kernel=True, tile=tile)
        return
    np.testing.assert_array_equal(port_qgemm(inp, "cuda", kernel=True, tile=tile),
                                  port_qgemm(inp, "cuda", kernel=False))


@pytest.mark.cuda
def test_igemm_refuses_unknown_tile_on_card():
    """A tile the kernel is not built for raises; nothing falls back."""
    _need_card()
    inp = qgemm_inputs(QGEMM_CASES[0], seed=1)
    with pytest.raises(ValueError, match="tile"):
        port_qgemm(inp, "cuda", kernel=True, tile=(32, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES + DW_EXTRA_CASES,
                         ids=[str(c) for c in DW_CASES + DW_EXTRA_CASES])
def test_dw_kernel_matches_plain_on_card(case):
    """dw_qconv: the kernel equals its plain version bit for bit (both sum
    exactly and round the same f32 epilogue)."""
    _need_card()
    from tengine_tpu_torch.ops.cuda.dw_conv import dw_qconv

    inp = dw_inputs(case, seed=sum(case[:5]))
    before = dw_qconv.launches
    got = port_dw(inp, "cuda", kernel=True)
    torch.cuda.synchronize()
    assert dw_qconv.launches == before + 1
    want = port_dw(inp, "cuda", kernel=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", QBLOCK_TILES + [None], ids=str)
@pytest.mark.parametrize("relaxed", [False, True], ids=["exact", "relaxed"])
@pytest.mark.parametrize("case", QBLOCK_CASES + QBLOCK_EXTRA_CASES, ids=str)
def test_qblock_kernel_matches_plain_on_card(case, relaxed, tile):
    """qblock_chain: the kernel equals its plain version bit for bit, exact
    and relaxed, with every spatial tile the kernel is built for (both sum
    exactly and round the same f32 epilogue, product by product); one launch
    per chain of up to MAX_CHAIN blocks."""
    _need_card()
    from tengine_tpu_torch.ops.cuda.qblock import MAX_CHAIN, qblock_chain

    inp = qblock_inputs(case, seed=sum(case[:7]), relaxed=relaxed)
    before = qblock_chain.launches
    got = port_qblock(inp, "cuda", kernel=True, tile=tile)
    torch.cuda.synchronize()
    assert qblock_chain.launches == before + -(-len(inp["blocks"]) // MAX_CHAIN)
    want = port_qblock(inp, "cuda", kernel=False)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == want.shape == case[:3] + (case[5],)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QGEMM_CASES)
def test_qgemm_kernel_matches_plain_on_card(case):
    _need_card()
    from tengine_tpu_torch.ops.cuda import qgemm as pg

    inp = qgemm_inputs(case, seed=sum(case[:3]))
    before = pg.qgemm_requant.launches
    got = port_qgemm(inp, "cuda", kernel=True)
    torch.cuda.synchronize()
    assert pg.qgemm_requant.launches == before + 1
    want = port_qgemm(inp, "cuda", kernel=False)
    assert got.dtype == want.dtype and got.shape == want.shape == (case[0], case[2])
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("k,pad,act,mode,zp_w,B,H", STEM_CASES)
def test_stem_kernel_matches_plain_on_card(k, pad, act, mode, zp_w, B, H, out_f32):
    """Bit-equal, except that SiLU may differ by one step (expf in the
    kernel, torch's sigmoid in the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stem kernel has no CPU mode")
    x, w, mult, bias, q = stem_inputs(k, mode, zp_w, B, H, seed=k * 100 + H + zp_w)
    tensors, w_corr = stem_port_args(x, w, mult, bias, q, k, zp_w)
    args = [t.cuda() for t in tensors]
    before = stem_qconv.launches
    got = stem_qconv(*args, k=k, pad=pad, act=act, w_corr=w_corr, out_f32=out_f32, **q)
    torch.cuda.synchronize()
    assert stem_qconv.launches == before + 1
    want = stem_qconv_plain(*args, k=k, pad=pad, act=act, w_corr=w_corr, out_f32=out_f32, **q)
    assert got.dtype == want.dtype and got.shape == want.shape == (B, H // 2, H // 2, 32)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= (1 if act == 100 else 0), diff


@pytest.mark.cuda
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("case", STEM_EDGE_CASES, ids=str)
def test_stem_kernel_edge_cases_on_card(case, out_f32):
    """The stem kernel at its design's edges (STEM_EDGE_CASES), bit-equal to
    its plain version (SiLU within one step)."""
    _need_card()
    x, w, mult, bias, q, run = stem_edge_inputs(case, seed=sum(case[5:]))
    tensors, w_corr = stem_port_args(x, w, mult, bias, q, case[0], case[4])
    args = [t.cuda() for t in tensors]
    before = stem_qconv.launches
    got = stem_qconv(*args, w_corr=w_corr, out_f32=out_f32, **run)
    torch.cuda.synchronize()
    assert stem_qconv.launches == before + 1
    want = stem_qconv_plain(*args, w_corr=w_corr, out_f32=out_f32, **run)
    B, H, W, Cout = case[5], case[6], case[7], case[9]
    assert got.dtype == want.dtype and got.shape == want.shape == (B, H // 2, W // 2, Cout)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= (1 if case[2] == 100 else 0), diff


@pytest.mark.cuda
@pytest.mark.parametrize("case,tile", [(c, t) for c, tiles in DW_EDGE_CASES for t in tiles],
                         ids=str)
def test_dw_kernel_edge_cases_on_card(case, tile):
    """dw_qconv at the redesigned kernel's edges (DW_EDGE_CASES), under the
    tile it picks and under forced tiles, bit-equal to its plain version."""
    _need_card()
    from tengine_tpu_torch.ops.cuda.dw_conv import dw_qconv

    inp = dw_inputs(case, seed=sum(case[:5]), extremes=True)
    before = dw_qconv.launches
    got = port_dw(inp, "cuda", kernel=True, tile=tile)
    torch.cuda.synchronize()
    assert dw_qconv.launches == before + 1
    want = port_dw(inp, "cuda", kernel=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_SHIFTED_CASES, ids=str)
def test_dw_kernel_shifted_int8_on_card(case):
    """dw_qconv on the native-int8 plan's shifted INT8 grids (a negative
    zp_in in the pad bytes, the full [-128, 127] range) at mobilenet-v1's
    depthwise shapes: the kernel equals its plain version bit for bit."""
    _need_card()
    from tengine_tpu_torch.ops.cuda.dw_conv import dw_qconv

    inp = dw_inputs(case, seed=sum(case[:5]) + 9)
    before = dw_qconv.launches
    got = port_dw(inp, "cuda", kernel=True)
    torch.cuda.synchronize()
    assert dw_qconv.launches == before + 1
    want = port_dw(inp, "cuda", kernel=False)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
