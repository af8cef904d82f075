"""The dw_qconv plain PyTorch version (ops/cuda/dw_conv.py) against the
Pallas depthwise kernel of the JAX package, run in interpret mode on the
CPU through its NHWC wrapper, on the grid of tests/test_dw_conv_pallas.py
and its TF-style pads case. Both sides sum exactly and run the same f32
epilogue, so they agree to the bit except where XLA's CPU compiler, which
runs the Pallas kernel in interpret mode, contracts `acc * M + B` into one
fused multiply-add: it rounds once where the kernel's contract and the port
round twice, and a value within half an f32 step of a .5 tie then rounds to
the other integer. So the bound is 1 LSB, on at most one element in a
thousand. Cases the reference's grid lacks (ragged C, N = 1, odd H at
stride 2, wide uint8 taps) are held to a numpy oracle alone, bit for bit:
at odd H with stride 2 and a consumed bottom pad the Pallas kernel reads
past its input. The CUDA kernel itself is held to the plain version on the
card in tests/test_torch_cuda.py; here a numpy emulation of its packed
integer dots (dp2a: two int16 taps against two bytes of one channel, uint8
re-centred by XOR 0x80) and of its folded epilogue is held to the plain
version bit for bit, and the tile choice is pinned at the main path's
shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tengine_tpu.ops.pallas.dw_conv import dw_qconv as jax_dw_qconv  # noqa: E402

from tengine_tpu_torch.ops.cuda.dw_conv import (  # noqa: E402
    MAX_THREADS,
    SMEM_CAP,
    THREAD_TILE,
    act_bounds,
    dw_smem_bytes,
    pick_dw_tile,
)

from test_torch_cuda import (  # noqa: E402
    DW_CASES,
    DW_EDGE_CASES,
    DW_EXTRA_CASES,
    DW_SHIFTED_CASES,
    dw_inputs,
    dw_oracle,
    port_dw,
)
from test_torch_qconv import assert_within_one_fma_lsb  # noqa: E402


def jax_dw(inp):
    a = inp["kw_args"]
    fn = jax.jit(lambda xx: jax_dw_qconv(
        xx, inp["w"], jnp.asarray(inp["M"]), jnp.asarray(inp["B"]),
        stride=a["stride"], pad=a["pad_t"], pad_l=a["pad_l"], pad_b=a["pad_b"],
        pad_r=a["pad_r"], zp_in=a["zp_in"], zp_out=a["zp_out"], act=a["act"],
        s_out=a["s_out"], lo=a["lo"], hi=a["hi"], out_u8=a["out_u8"],
    ))
    return np.asarray(fn(inp["x"]))


@pytest.mark.parametrize("case", DW_CASES, ids=[str(c) for c in DW_CASES])
def test_dw_plain_matches_pallas(case):
    inp = dw_inputs(case, seed=sum(case[:5]))
    want = jax_dw(inp)
    got = port_dw(inp, "cpu")  # the wrapper takes the plain version on the CPU
    assert_within_one_fma_lsb(got, want)
    np.testing.assert_array_equal(got, dw_oracle(inp))


@pytest.mark.parametrize("case", DW_EXTRA_CASES, ids=[str(c) for c in DW_EXTRA_CASES])
def test_dw_plain_matches_oracle(case):
    inp = dw_inputs(case, seed=sum(case[:5]))
    got = port_dw(inp, "cpu", kernel=False)
    N, H, C = case[:3]
    assert got.shape[0] == N and got.shape[3] == C
    np.testing.assert_array_equal(got, dw_oracle(inp))


def test_pack_dw_taps_layout_and_range():
    from tengine_tpu_torch.ops.cuda.dw_conv import pack_dw_taps

    w = np.arange(6 * 9, dtype=np.float32).reshape(6, 1, 3, 3) - 20
    packed = pack_dw_taps(w)
    assert packed.dtype == np.int16 and packed.shape == (9, 8)
    np.testing.assert_array_equal(packed[:, :6], w[:, 0].transpose(1, 2, 0).reshape(9, 6))
    assert not packed[:, 6:].any()
    with pytest.raises(ValueError):
        pack_dw_taps(np.full((4, 1, 3, 3), 256.0))
    with pytest.raises(ValueError):
        pack_dw_taps(np.full((4, 1, 3, 3), 0.5))


# mobilenet-v1-224's depthwise widths at a small batch (Caffe pads 1, int8)
#   N, H, C, k, stride, pads, zp_in, zp_out, act, u8
MOBILENET_DW_SMALL = [
    (2, 28, 256, 3, 2, (1, 1, 1, 1), 0, 0, 0, False),
    (2, 14, 512, 3, 1, (1, 1, 1, 1), 0, 0, 0, False),
    (2, 14, 512, 3, 2, (1, 1, 1, 1), 0, 0, -1, False),
    (2, 7, 1024, 3, 1, (1, 1, 1, 1), 0, 0, 0, False),
]


@pytest.mark.parametrize("case", MOBILENET_DW_SMALL, ids=str)
def test_dw_plain_matches_pallas_mobilenet_widths(case):
    """mobilenet-v1's widest depthwise convs (C = 512 at 14x14, 1024 at 7x7)
    through dw_qconv_plain, against the Pallas kernel in interpret mode and
    the numpy oracle."""
    inp = dw_inputs(case, seed=sum(case[:5]))
    got = port_dw(inp, "cpu", kernel=False)
    assert_within_one_fma_lsb(got, jax_dw(inp))
    np.testing.assert_array_equal(got, dw_oracle(inp))


@pytest.mark.parametrize("case", [c for c in DW_SHIFTED_CASES if c[1] <= 28], ids=str)
def test_dw_plain_matches_pallas_on_shifted_int8(case):
    """The native-int8 plan's shifted INT8 grids (negative zp_in in the pad,
    full range) at mobilenet-v1's shapes from 28x28 down: dw_qconv_plain
    against the Pallas kernel in interpret mode (within the FMA LSB) and the
    numpy oracle (bit for bit)."""
    inp = dw_inputs(case, seed=sum(case[:5]) + 9)
    got = port_dw(inp, "cpu", kernel=False)
    assert_within_one_fma_lsb(got, jax_dw(inp))
    np.testing.assert_array_equal(got, dw_oracle(inp))


def emulate_dw_kernel(inp):
    """csrc/dw_conv.cu's arithmetic in numpy: per output column o = ox % TW
    of its thread, the tap pairs (2j - ph, 2j + 1 - ph) of each row (ph the
    column phase at stride 1, zero taps outside the row) against the input
    byte pairs at the thread's columns, as __dp2a_lo/hi compute them (int16
    taps, int8 bytes; uint8 input XOR 0x80 plus 128 * sum(taps)), then the
    epilogue with the activation clamp and the output clip folded into one
    clamp, rounded half away as trunc(q + copysign(0.49999997, q)), every
    f32 operation rounded once."""
    a = inp["kw_args"]
    k, s = a["k"], a["stride"]
    tw = THREAD_TILE[(k, s)][0]
    nvar = 2 if (s == 1 and tw > 1) else 1
    x = inp["x"]
    u8 = x.dtype == np.uint8
    N, H, W, C = x.shape
    OH = (H + a["pad_t"] + a["pad_b"] - k) // s + 1
    OW = (W + a["pad_l"] + a["pad_r"] - k) // s + 1
    byte = x.view(np.uint8).astype(np.int64) ^ (0x80 if u8 else 0)
    byte = np.where(byte >= 128, byte - 256, byte)
    zp = ((a["zp_in"] & 0xFF) ^ (0x80 if u8 else 0))
    zp = zp - 256 if zp >= 128 else zp
    taps = inp["w"][:, 0].astype(np.int64)  # [C, k, k]
    acc = np.zeros((N, OH, OW, C), np.int64)
    if u8:
        acc += 128 * taps.sum(axis=(1, 2))
    for ox in range(OW):
        o = ox % tw
        ph = (o * s) & 1 if nvar == 2 else 0
        col0 = ox * s - a["pad_l"] - ph  # the column of tap 2j - ph at j = 0
        for ky in range(k):
            rows = np.arange(OH) * s - a["pad_t"] + ky
            for j in range((k + 1) // 2):
                for kx, col in ((2 * j - ph, col0 + 2 * j), (2 * j + 1 - ph, col0 + 2 * j + 1)):
                    if not 0 <= kx < k:
                        continue  # a zero tap: its byte, whatever it is, adds nothing
                    if 0 <= col < W:
                        v = np.full((N, OH, C), zp, np.int64)
                        ok = (rows >= 0) & (rows < H)
                        v[:, ok] = byte[:, rows[ok], col]
                    else:
                        v = np.full((N, OH, C), zp, np.int64)
                    acc[:, :, ox] += v * taps[:, ky, kx]
    f32 = np.float32
    q = acc.astype(f32) * inp["M"] + inp["B"]
    lo_, hi_ = f32(a["lo"]) - f32(a["zp_out"]), f32(a["hi"]) - f32(a["zp_out"])
    act = a["act"]
    q_lo, q_hi = lo_, hi_
    if act == 1:
        alo, ahi = act_bounds(act, a["s_out"])
        q_lo, q_hi = np.clip(f32(alo), lo_, hi_), np.clip(f32(ahi), lo_, hi_)
    elif act >= 0:
        q_lo = np.clip(f32(0), lo_, hi_)
        if act > 0:
            q_hi = np.clip(f32(act_bounds(act, a["s_out"])[1]), lo_, hi_)
    q = np.minimum(np.maximum(q, q_lo), q_hi)
    r = np.trunc(q + np.copysign(f32(0.49999997), q)).astype(np.int64) + int(a["zp_out"])
    return r.astype(np.uint8 if a["out_u8"] else np.int8)


DW_EMULATED = ([(c, False, 0) for c in DW_CASES + DW_EXTRA_CASES]
               + [(c, True, 0) for c, _ in DW_EDGE_CASES]
               + [(c, False, 9) for c in DW_SHIFTED_CASES])


@pytest.mark.parametrize("case,extremes,reseed", DW_EMULATED, ids=str)
def test_dw_kernel_arithmetic_emulation_equals_plain(case, extremes, reseed):
    inp = dw_inputs(case, seed=sum(case[:5]) + reseed, extremes=extremes)
    np.testing.assert_array_equal(emulate_dw_kernel(inp), port_dw(inp, "cpu", kernel=False))


# (N, OH, OW, C, k, stride) -> (cgw, ncs, nrs, rpt): YOLO-Fastest-320 b32's
# ten depthwise shapes and mobilenet-v1-224 b32's nine
DW_TILE_PINS = {
    (32, 160, 160, 32, 3, 1): (8, 8, 4, 8),
    (32, 80, 80, 32, 3, 2): (8, 4, 8, 2),
    (32, 80, 80, 64, 3, 1): (16, 4, 2, 8),
    (32, 40, 40, 64, 3, 2): (16, 4, 4, 2),
    (32, 40, 40, 128, 3, 1): (32, 2, 4, 2),
    (32, 20, 20, 128, 3, 2): (32, 2, 2, 2),
    (32, 20, 20, 192, 3, 1): (32, 1, 2, 2),
    (32, 10, 10, 288, 3, 2): (32, 1, 1, 2),
    (32, 10, 10, 576, 3, 1): (32, 1, 1, 2),
    (32, 10, 10, 192, 3, 1): (32, 1, 1, 2),
    (32, 112, 112, 32, 3, 1): (8, 4, 2, 8),
    (32, 56, 56, 64, 3, 2): (16, 4, 4, 2),
    (32, 56, 56, 128, 3, 1): (32, 2, 1, 8),
    (32, 28, 28, 128, 3, 2): (32, 2, 2, 2),
    (32, 28, 28, 256, 3, 1): (32, 1, 2, 2),
    (32, 14, 14, 256, 3, 2): (32, 1, 1, 2),
    (32, 14, 14, 512, 3, 1): (32, 4, 1, 2),
    (32, 7, 7, 512, 3, 2): (32, 2, 4, 2),
    (32, 7, 7, 1024, 3, 1): (32, 2, 4, 2),
}


@pytest.mark.parametrize("shape", sorted(DW_TILE_PINS), ids=str)
def test_pick_dw_tile_pinned(shape):
    """The tile is a pure function of the shape: pinned here, with its
    limits (threads, shared memory, a tile for every SM where the channels
    allow)."""
    n, oh, ow, c, k, s = shape
    tile = pick_dw_tile(*shape)
    assert tile == DW_TILE_PINS[shape]
    cgw, ncs, nrs, rpt = tile
    tw = THREAD_TILE[(k, s)][0]
    assert cgw * ncs * nrs <= MAX_THREADS and dw_smem_bytes(k, s, *tile) <= SMEM_CAP
    blocks = n * -(-oh // (nrs * rpt)) * -(-ow // (ncs * tw)) * -(-(c // 4) // cgw)
    assert blocks >= 132 or cgw % 8
    if c % 16 == 0:
        assert cgw % 4 == 0  # 16-byte copies


def test_dw_smem_bytes_layout():
    """The wrapper's copy of the kernel's shared-memory layout at the
    160x160x32 tile: two windows of 34 input rows of 34 columns padded to 42,
    M and B, 9 taps."""
    assert dw_smem_bytes(3, 1, 8, 8, 4, 8) == 4 * (2 * 34 * 42 * 8 + 64 + 9 * 8 * 2)
