"""The int8 implicit-GEMM kernel's seams, as far as the CPU reaches them: the
edge cases of tests/test_torch_cuda.py (QCONV_EDGE_CASES, QGEMM_EDGE_CASES)
through the plain PyTorch versions, against an independent numpy oracle (int64
sums, the f32 epilogue op by op: bit-equal) and against the JAX package's
Pallas kernels in interpret mode (at most 1 LSB on at most 0.1% of the
elements: XLA's CPU compiler contracts acc*M + B into one fused multiply-add,
tests/test_torch_qconv.py). Then what the CUDA kernel relies on and Python
can state: the uint8 re-centring identities in wrapping int32 arithmetic,
pick_tile's choices, the args block's layout against the struct in
csrc/qconv.cu, and the K-major weight packing. The kernel itself is held to
the plain versions and to the oracle on the card (tests/test_torch_cuda.py)."""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import jax.numpy as jnp  # noqa: E402

from tengine_tpu.ops.pallas.qgemm import qgemm_requant as jax_qgemm  # noqa: E402

from tengine_tpu_torch.ops.cuda import build  # noqa: E402
from tengine_tpu_torch.ops.cuda import qconv as pq  # noqa: E402
from tengine_tpu_torch.ops.cuda import qgemm as pg  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    IGEMM_TILES,
    QCONV_CASES,
    QCONV_EDGE_CASES,
    QCONV_RES_CASES,
    QGEMM_CASES,
    QGEMM_EDGE_CASES,
    port_qconv,
    port_qgemm,
    qconv_edge_inputs,
    qconv_inputs,
    qconv_oracle,
    qgemm_edge_inputs,
    qgemm_inputs,
    qgemm_oracle,
)
from test_torch_qconv import assert_within_one_fma_lsb, jax_qconv  # noqa: E402


@pytest.mark.parametrize("case", QCONV_EDGE_CASES, ids=str)
def test_qconv_edge_plain_equals_numpy_oracle(case):
    inp = qconv_edge_inputs(case, seed=sum(case[:7]))
    got = port_qconv(inp, "cpu")  # the wrapper takes the plain version on the CPU
    want = qconv_oracle(inp)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    lo, hi = inp["kw_args"]["lo"], inp["kw_args"]["hi"]
    assert ((got > lo) & (got < hi)).mean() > 0.3  # the clip does not hide the arithmetic


@pytest.mark.parametrize("case", QGEMM_EDGE_CASES, ids=str)
def test_qgemm_edge_plain_equals_numpy_oracle(case):
    inp = qgemm_edge_inputs(case, seed=sum(case[:3]))
    got = port_qgemm(inp, "cpu")
    assert got.shape == (case[0], case[2])
    np.testing.assert_array_equal(got, qgemm_oracle(inp))


@pytest.mark.parametrize("with_res,case", [(False, c) for c in QCONV_CASES]
                         + [(True, c) for c in QCONV_RES_CASES], ids=str)
def test_qconv_grid_plain_equals_numpy_oracle(with_res, case):
    """The older grid through the same oracle."""
    inp = qconv_inputs(case, seed=sum(case[:5]), with_res=with_res)
    np.testing.assert_array_equal(port_qconv(inp, "cpu"), qconv_oracle(inp))


@pytest.mark.parametrize("case", QGEMM_CASES, ids=str)
def test_qgemm_grid_plain_equals_numpy_oracle(case):
    inp = qgemm_inputs(case, seed=sum(case[:3]))
    np.testing.assert_array_equal(port_qgemm(inp, "cpu"), qgemm_oracle(inp))


@pytest.mark.parametrize("case", QCONV_EDGE_CASES, ids=str)
def test_qconv_edge_plain_matches_pallas(case):
    """The Pallas kernels take every edge shape (asymmetric pads, 49 taps,
    C of 8 and 2048, the sums beyond 2^24) in interpret mode."""
    inp = qconv_edge_inputs(case, seed=sum(case[:7]))
    assert_within_one_fma_lsb(port_qconv(inp, "cpu"), jax_qconv(inp, ones_col=False))


@pytest.mark.parametrize("case", QGEMM_EDGE_CASES, ids=str)
def test_qgemm_edge_plain_matches_pallas(case):
    inp = qgemm_edge_inputs(case, seed=sum(case[:3]))
    w_kn = inp["w"].T.astype(np.int16) - (128 if inp["u8"] else 0)
    want = np.asarray(jax_qgemm(
        jnp.asarray(inp["x"]), jnp.asarray(np.ascontiguousarray(w_kn.astype(np.int8))),
        jnp.asarray(inp["M"]), jnp.asarray(inp["B"]), **inp["kw_args"]))
    assert_within_one_fma_lsb(port_qgemm(inp, "cpu"), want)


def test_long_k_sums_pass_2_pow_24():
    """The "max" cases do what they are for: at an inner pixel their exact
    sums leave f32's integer range, so the int -> f32 conversion rounds."""
    n_cases = 0
    for case in QCONV_EDGE_CASES:
        N, H, W, C, O, k, s, pads, u8, act, res_kind, fill, zp_in = case
        if fill != "max":
            continue
        inp = qconv_edge_inputs(case, seed=sum(case[:7]))
        c0 = 128 if u8 else 0
        y0, x0 = 2 * s - pads[0], 2 * s - pads[2]  # output pixel (2, 2): every tap inside
        window = inp["x"][0, y0:y0 + k, x0:x0 + k, :].astype(np.int64) - c0
        acc = np.einsum("yxc,ocyx->o", window, inp["w"].astype(np.int64) - c0)
        assert np.abs(acc).max() > 2 ** 24
        assert (acc.astype(np.float32).astype(np.int64) != acc).any()
        n_cases += 1
    assert n_cases >= 3


@pytest.mark.parametrize("seed", range(4))
def test_uint8_recentring_identities_hold_in_wrapping_int32(seed):
    """What lets the kernel keep uint8 input raw in shared memory: with
    x' = x - 128 over a receptive field whose pad taps hold the raw zp_in,
      sum(x' * w) == sum(x * w) - 128 * sum(w)      (mod 2^32)
      sum(x')     == sum(x) - 128 * K
    and the byte XOR 0x80 is x - 128 read as int8. K is made long enough that
    the raw sums leave int32 and wrap."""
    rng = np.random.default_rng(seed)
    K, n = 49 * 4096, 8
    x = rng.integers(200, 256, K).astype(np.uint8)
    x[rng.random(K) < 0.1] = 7  # pad taps: the raw zero point
    w = rng.integers(100, 128, (n, K)).astype(np.int8)
    xs = x.astype(np.int64) - 128
    assert ((x ^ 0x80).view(np.int8) == xs).all()

    def wrap(v):
        return (np.asarray(v, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)

    raw = w.astype(np.int64) @ x.astype(np.int64)
    assert (np.abs(raw) > 2 ** 31).any()  # the raw sum does wrap
    exact = w.astype(np.int64) @ xs
    np.testing.assert_array_equal(
        wrap(wrap(raw).astype(np.int64) - 128 * wrap(w.astype(np.int64).sum(axis=1)).astype(np.int64)),
        wrap(exact))
    assert int(wrap(x.astype(np.int64).sum()) - 128 * K) == int(xs.sum())


def test_the_kernels_rounding_equals_round_half_away_on_every_float():
    """csrc/qconv.cu rounds a clamped q (|q| <= 255) as trunc(q + copysign(p, q))
    with p the float just below 0.5. Walked here over every float32 of both
    signs in [2^-3, 2^9) against the exact form (the fraction q - trunc(q) is
    exact); below 2^-3 the sum stays under 0.75 and both give 0."""
    p = np.nextafter(np.float32(0.5), np.float32(0))
    assert p == np.float32(0.49999997)
    for e in range(-3, 9):
        first = np.float32(2.0 ** e).view(np.uint32)
        q = np.arange(first, first + (1 << 23), dtype=np.uint32).view(np.float32)
        t = np.trunc(q)
        want = t + (np.abs(q - t) >= np.float32(0.5))
        assert np.array_equal(np.trunc(q + p), want), e  # the f32 sum rounds to nearest even
        assert np.array_equal(np.trunc(-q - p), -want), e
    assert np.trunc(np.float32(0.125) + p) == 0 and np.trunc(np.float32(0.49999997) + p) == 0
    assert np.trunc(np.float32(0.5) + p) == 1


def test_pick_tile_fits_the_shape():
    assert sorted(pq.TILES) == sorted({t[:2] for t in IGEMM_TILES})
    assert sorted(pq.WGMMA_TILES) == sorted(t[:2] for t in IGEMM_TILES if t[2:] == ("wgmma",))
    for m in (1, 32, 77, 169, 1568, 21632, 346112):
        for c2 in (8, 24, 32, 40, 64, 96, 128, 130, 256, 512, 1000, 2048):
            bm, bn = pq.pick_tile(m, c2)
            assert (bm, bn) in pq.TILES
            # no other width would multiply fewer masked channels
            assert -(-c2 // bn) * bn == min(-(-c2 // b) * b for b in (32, 64, 128))
            if m <= 64:
                assert bm == 64
    assert pq.pick_tile(8 * 208 * 208, 32)[1] == 32  # yolov3's widest pointwise launch
    assert pq.pick_tile(8 * 52 * 52, 256)[1] == 128
    # few rows, many channels: the smaller tiles fill the card
    small, large = pq.pick_tile(1568, 512), pq.pick_tile(100000, 512)
    assert small[0] * small[1] < large[0] * large[1]


def test_args_block_mirrors_the_cuda_struct():
    """QconvArgs (ctypes) field for field against struct QconvArgs in
    csrc/qconv.cu: names, order and C types; the fast epilogue's steps are
    the RequantSteps block of csrc/requant_steps.cuh (mirrored in
    tests/test_torch_requant.py)."""
    from tengine_tpu_torch.ops.cuda import requant as rq

    src = (build.CSRC_DIR / "qconv.cu").read_text()
    body = re.search(r"struct QconvArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        m = re.match(r"(const void\*|void\*|const float\*|int|float|RequantSteps)\s+(.*)", line)
        assert m, line
        kind = {"int": ctypes.c_int, "float": ctypes.c_float,
                "RequantSteps": rq.RequantSteps}.get(m.group(1), ctypes.c_void_p)
        fields += [(name.strip(), kind) for name in m.group(2).split(",")]
    assert fields == [(n, t) for n, t in pq.QconvArgs._fields_]
    assert [n for n, _ in fields[-5:]] == ["bm", "bn", "wgmma", "fast", "steps"]


def test_the_source_has_no_dp4a_and_names_the_tensor_core_instruction():
    src = (build.CSRC_DIR / "qconv.cu").read_text() + (build.CSRC_DIR / "mma_s8.cuh").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "__dp4a" not in code
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in code
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in code
    assert "satfinite" not in code  # int32 sums must wrap
    assert "cp.async.cg.shared.global" in code and "ldmatrix" in code
    for bm, bn in pq.TILES:
        assert f"launch_tile<{bm}, {bn}," in code


@pytest.mark.parametrize("C", [8, 24, 64, 100, 128])
def test_weight_packing_is_k_major_and_zero_padded(C):
    rng = np.random.default_rng(C)
    w = rng.integers(0, 256, (5, C, 3, 3)).astype(np.uint8)
    packed = pq.pack_qconv_weights(w, True)
    cp = -(-C // pq.CHUNK) * pq.CHUNK
    assert packed.shape == (5, 9, cp) and packed.dtype == np.int8 and packed.flags.c_contiguous
    np.testing.assert_array_equal(packed[:, :, :C].reshape(5, 3, 3, C),
                                  (w.astype(np.int16) - 128).transpose(0, 2, 3, 1))
    assert not packed[:, :, C:].any()
    flat = pg.pack_qgemm_weights(w.reshape(5, -1).view(np.int8), False)
    assert flat.shape == (5, 1, -(-9 * C // pq.CHUNK) * pq.CHUNK) and not flat[:, :, 9 * C:].any()


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """launch_igemm's checks run before anything is built, so a CPU test
    reaches them: a bad tile, a weight tensor of the wrong padding."""
    inp = qgemm_inputs(QGEMM_CASES[0], seed=0)
    x = torch.from_numpy(inp["x"])
    w = torch.from_numpy(pg.pack_qgemm_weights(inp["w"], False))
    m, b = torch.from_numpy(inp["M"]), torch.from_numpy(inp["B"])
    shape = dict(n=1, h=1, w_in=x.shape[0], c=x.shape[1], oh=1, ow=x.shape[0], kh=1, kw=1,
                 stride=1, pad_t=0, pad_l=0, zp_in=0, out_shape=(x.shape[0], w.shape[0]),
                 **inp["kw_args"])
    with pytest.raises(ValueError, match="tile"):
        pq.launch_igemm("t", x, w, m, b, None, None, tile=(32, 32), **shape)
    with pytest.raises(ValueError, match="route"):  # the warpgroup route has no 64-wide tile
        pq.launch_igemm("t", x, w, m, b, None, None, tile=(64, 64, "wgmma"), **shape)
    with pytest.raises(ValueError, match="route"):
        pq.launch_igemm("t", x.view(torch.uint8), w, m, b, None, None, tile=(128, 128, "wgmma"),
                        **dict(shape, out_dtype="uint8"))
    with pytest.raises(ValueError, match="w must be"):
        pq.launch_igemm("t", x, w[:, :, :-1].contiguous(), m, b, None, None, **shape)
    with pytest.raises(ValueError, match="mult"):
        pq.launch_igemm("t", x, w, m[:-1], b, None, None, **shape)
