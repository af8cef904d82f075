"""The port's bottleneck-chain kernel module (ops/cuda/qblock.py) against the
JAX package's Pallas kernel qblock_chain, on the CPU: the host folds
(build_block_args) array for array, and the plain PyTorch version against
the Pallas kernel in interpret mode and against the numpy oracle of
tests/test_qblock_pallas.py, on that file's six cases, exact and relaxed.

Tolerances, and why:
  * plain vs Pallas in interpret mode: at most 1 LSB on fewer than 1% of the
    elements (the JAX package's own bound against its oracle). XLA's CPU
    compiler contracts acc·M + B, and t·s_mid + r·s_r, into fused
    multiply-adds; the port's kernels round every product and sum on their
    own. The built cases below show that parting on purpose.
  * exact plain vs the numpy oracle: bit-equal on these cases. Both round
    every op once. The oracle divides by s_out and by s_relu where the port
    multiplies by the f32 reciprocal (by f32(s_out·f32(1/s_relu)) for the
    ReLu's grid), which is what XLA makes of the JAX kernel's divisions by
    constants; the two forms part only on .5 ties that these cases do not
    meet, and the built division cases hold the port to the compiled kernel.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from tengine_tpu.ops.pallas import qblock as jqb  # noqa: E402

from tengine_tpu_torch.ops.cuda import qblock as pqb  # noqa: E402

import test_qblock_pallas as T  # noqa: E402

# tests/test_qblock_pallas.py:179-210
CASES = {
    "identity": dict(H=6, W=6, c0=16, c_mid=8, c_out=16, nblocks=1, first_proj=False),
    "chain_of_three": dict(H=5, W=7, c0=16, c_mid=8, c_out=16, nblocks=3, first_proj=False),
    "proj_head": dict(H=6, W=14, c0=8, c_mid=8, c_out=16, nblocks=2, first_proj=True),
    "no_bias": dict(H=6, W=6, c0=8, c_mid=8, c_out=8, nblocks=1, first_proj=False, bias=False),
    "w7": dict(H=7, W=7, c0=8, c_mid=8, c_out=8, nblocks=2, first_proj=False),
    "relu_own_scale": dict(H=6, W=6, c0=16, c_mid=8, c_out=16, nblocks=2, first_proj=False,
                           relu_rescale=True),
}
GRID = [(name, relaxed) for name in CASES for relaxed in (False, True)]


def port_block(blk) -> pqb.QBlock:
    return pqb.QBlock(**dataclasses.asdict(blk))


def port_tensors(pargs, pblocks, device="cpu"):
    """build_block_args' flat list -> the wrapper's tensors (pack_block_args
    per block)."""
    out, off = [], 0
    for blk in pblocks:
        n = pqb.args_per_block(blk)
        out += [torch.from_numpy(a).to(device) for a in pqb.pack_block_args(pargs[off:off + n])]
        off += n
    return out


def chain_inputs(name, relaxed, seed=7):
    """One case of the grid as seeded numpy data (the recipe of
    tests/test_qblock_pallas.py run_chain_case: two image packs): x, the JAX
    QBlocks with their weights, and build_block_args' output of both
    packages."""
    c = dict(CASES[name])
    H, W, c0, c_mid, c_out = c["H"], c["W"], c["c0"], c["c_mid"], c["c_out"]
    rng = np.random.default_rng(seed)
    _, g = jqb.seg_geometry(W)
    s_in = 0.02
    x = rng.integers(-127, 128, (2 * g, H, W, c0)).astype(np.int8)
    blocks, weights, jargs, pargs = [], [], [], []
    s_prev, cin = s_in, c0
    for i in range(c["nblocks"]):
        blk, ws = T.make_block(rng, cin, c_mid, c_out, c["first_proj"] and i == 0, s_prev,
                               bias=c.get("bias", True),
                               relu_rescale=c.get("relu_rescale", False))
        pos = (ws["w1"], ws["b1"], ws["w2"], ws["b2"], ws["w3"], ws["b3"], s_prev,
               ws["sw1"], ws["sw2"], ws["sw3"])
        kw = dict(w4=ws.get("w4"), b4_q=ws.get("b4"), sw4=ws.get("sw4"), relaxed=relaxed)
        jargs += jqb.build_block_args(blk, *pos, **kw)
        pargs += pqb.build_block_args(port_block(blk), *pos, **kw)
        blocks.append(blk)
        weights.append(ws)
        s_prev, cin = blk.s_relu, c_out
    return x, blocks, weights, jargs, pargs, s_in


def pallas_chain(x, blocks, jargs, relaxed):
    N, H, W, _ = x.shape
    y = jqb.qblock_chain(jqb.pack_activations(x, H, W), *jargs, blocks=tuple(blocks), H=H, W=W,
                         relaxed=relaxed)
    return np.asarray(jqb.unpack_activations(y, N, H, W))


def plain_chain(x, blocks, pargs, relaxed):
    pblocks = [port_block(b) for b in blocks]
    return pqb.qblock_chain_plain(
        torch.from_numpy(x), port_tensors(pargs, pblocks), pblocks, relaxed).numpy()


@functools.lru_cache(maxsize=None)
def case_results(name, relaxed):
    x, blocks, weights, jargs, pargs, s_in = chain_inputs(name, relaxed)
    return (x, blocks, weights, jargs, pargs, s_in,
            pallas_chain(x, blocks, jargs, relaxed), plain_chain(x, blocks, pargs, relaxed))


@pytest.mark.parametrize("name,relaxed", GRID)
def test_build_block_args_equals_jax(name, relaxed):
    """The port's copy of the host fold gives the JAX module's arrays, dtype
    and bit for bit (M in f32 from weak Python floats, B through float64)."""
    _, blocks, _, jargs, pargs, _ = chain_inputs(name, relaxed)
    assert len(jargs) == len(pargs) == sum(12 if b.proj else 9 for b in blocks)
    for a, b in zip(jargs, pargs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,relaxed", GRID)
def test_plain_matches_pallas_interpret(name, relaxed):
    x, blocks, *_, want, got = case_results(name, relaxed)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == want.shape == x.shape[:3] + (blocks[-1].c_out,)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{name} relaxed={relaxed}: max |d| {d.max()}, {(d > 0).sum()} of {d.size} differ")
    assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("name", list(CASES))
def test_exact_plain_equals_numpy_oracle(name):
    x, blocks, weights, _, _, s_in, _, got = case_results(name, False)
    ref, s_prev = x, s_in
    for blk, ws in zip(blocks, weights):
        ref = T.ref_block(ref, blk, ws["w1"], ws["b1"], ws["sw1"], ws["w2"], ws["b2"], ws["sw2"],
                          ws["w3"], ws["b3"], ws["sw3"], s_prev,
                          w4=ws.get("w4"), b4=ws.get("b4"), sw4=ws.get("sw4"))
        s_prev = blk.s_relu
    np.testing.assert_array_equal(got, ref)


def test_pack_block_args_layout():
    """[K, N] -> [N, Kp] and [9, K, N] -> [N, 9, Kp] with K zero-padded to a
    multiple of 32; M and B flat f32."""
    _, blocks, _, _, pargs, _ = chain_inputs("proj_head", False)
    packed = pqb.pack_block_args(pargs[:12])
    w1, w2, w4 = pargs[0], pargs[3], pargs[9]
    assert packed[0].shape == (8, 32) and packed[3].shape == (8, 9, 32)
    assert packed[9].shape == (16, 32)
    np.testing.assert_array_equal(packed[0][:, :8], w1.T)
    np.testing.assert_array_equal(packed[3][:, :, :8], w2.transpose(2, 0, 1))
    np.testing.assert_array_equal(packed[9][:, :8], w4.T)
    assert not packed[0][:, 8:].any() and not packed[3][:, :, 8:].any()
    for i in (1, 2, 4, 5, 7, 8, 10, 11):
        assert packed[i].dtype == np.float32 and packed[i].ndim == 1


# ---------------------------------------------------------------------------
# Built cases. One projection block whose convs are identities (M = 1, B = 0,
# no activation): t = x and r = w4s·x, so the residual epilogue sees chosen
# integers, one row per int8 value.
# ---------------------------------------------------------------------------

C = 8
VALS = np.arange(-127, 128)
f32 = np.float32


def rnd(q):
    q = np.asarray(q, np.float32)
    t = np.trunc(q)
    return np.clip(t + np.sign(q) * (np.abs(q - t) >= 0.5), -127, 127).astype(np.int32)


def identity_block(s_mid, s_r, s_out, s_relu=None, w4s=-1):
    """Returns (Pallas in interpret mode, the port's plain version) as int32
    [255]: the block's output at x = -127..127."""
    x = np.zeros((2, 8, 16, C), np.int8)
    x.reshape(-1, C)[:255, :] = VALS[:, None]
    eye = np.eye(C, dtype=np.int8)
    w1 = eye.reshape(C, C, 1, 1)
    w2 = np.zeros((C, C, 3, 3), np.int8)
    w2[:, :, 1, 1] = eye
    w4 = (w4s * eye).astype(np.int8).reshape(C, C, 1, 1)
    cfg = dict(c_in=C, c_mid=C, c_out=C, act1=-1, act2=-1, s1=1.0, s2=1.0, s_mid=s_mid,
               s_r=s_r, s_out=s_out, s_relu=s_relu, proj=True)
    one = np.ones(C, np.float32)
    pos = (w1, None, w2, None, w1, None, 1.0, one, one, one * f32(s_mid))  # M3 = 1
    kw = dict(w4=w4, b4_q=None, sw4=one * f32(s_r))  # M4 = 1
    jb, pb = jqb.QBlock(**cfg), pqb.QBlock(**cfg)
    want = pallas_chain(x, [jb], jqb.build_block_args(jb, *pos, **kw), False)
    got = pqb.qblock_chain_plain(
        torch.from_numpy(x), port_tensors(pqb.build_block_args(pb, *pos, **kw), [pb]), [pb],
        False).numpy()
    return (want.reshape(-1, C)[:255, 0].astype(np.int32),
            got.reshape(-1, C)[:255, 0].astype(np.int32))


def test_built_residual_tie_parts_fused_from_two_roundings():
    """t·s_mid + r·s_r with t = x, r = -x, s_mid = 0.7, s_r = 0.64, s_out = 1:
    at x = ±125, fl(125·f32(0.7)) = 87.5 and fl(125·f32(0.64)) = 80 exactly,
    so two roundings give the tie 7.5 -> 8, while the exact product
    87.4999985 keeps its deficit through one fused multiply-add -> 7. XLA's
    CPU compiler emits fma(t, s_mid, fl(r·s_r)) for the Pallas kernel in
    interpret mode; the port's plain version (and its CUDA kernel, built
    without contraction) rounds twice. They part by exactly 1 LSB at the
    built ties and nowhere else."""
    s_mid, s_r = 0.7, 0.64
    want, got = identity_block(s_mid, s_r, 1.0)
    t = VALS.astype(np.float32)
    two = rnd(t * f32(s_mid) + (-t) * f32(s_r))
    fused = rnd((t.astype(np.float64) * np.float64(f32(s_mid))
                 + np.float64((-t) * f32(s_r))).astype(np.float32))
    differ = two != fused
    assert differ[VALS == 125] and differ[VALS == -125] and 2 <= differ.sum() <= 12
    np.testing.assert_array_equal(got, two)
    np.testing.assert_array_equal(want, fused)
    assert np.abs(got - want).max() == 1


def test_division_by_the_sum_scale_is_a_reciprocal_multiply():
    """sum / s_out in the JAX kernel is a division by a compile-time constant,
    which XLA compiles to a multiply by f32(1/s_out). With t = x (s_mid = 1),
    r = -x, s_r = 0.5 the sum x/2 is exact, and at s_out = 0.61538464 the
    IEEE quotient and the reciprocal product round 12 of the 255 values
    apart. The port multiplies by the reciprocal: equal to the compiled
    kernel bit for bit."""
    s_out = 0.6153846383094788
    want, got = identity_block(1.0, 0.5, s_out)
    half = VALS.astype(np.float32) * f32(0.5)
    quotient, product = rnd(half / f32(s_out)), rnd(half * (f32(1) / f32(s_out)))
    assert (quotient != product).sum() == 12
    np.testing.assert_array_equal(want, product)
    np.testing.assert_array_equal(got, product)


def test_relu_on_its_own_grid_is_one_folded_multiply():
    """max(y, 0)·s_out / s_relu compiles to y·f32(s_out·f32(1/s_relu)): with
    r = 0 and s_mid = s_out the sum's grid holds y = x, and at these scales
    the folded product parts from both the quotient and the two-multiply
    form at one value. The port computes the folded form: equal to the
    compiled kernel bit for bit."""
    s, s_relu = 0.5529380440711975, 0.40163660049438477
    want, got = identity_block(s, 0.5, s, s_relu=s_relu, w4s=0)
    y = np.maximum(VALS, 0).astype(np.float32)
    folded = rnd(y * f32(f32(s) * (f32(1) / f32(s_relu))))
    assert (rnd((y * f32(s)) / f32(s_relu)) != folded).sum() == 1
    np.testing.assert_array_equal(want, folded)
    np.testing.assert_array_equal(got, folded)


def test_wrapper_takes_the_plain_version_on_cpu_and_meta():
    x, blocks, _, _, pargs, _ = chain_inputs("proj_head", False)
    pblocks = [port_block(b) for b in blocks]
    tensors = port_tensors(pargs, pblocks)
    before = pqb.qblock_chain.launches
    got = pqb.qblock_chain(torch.from_numpy(x), tensors, pblocks)
    assert pqb.qblock_chain.launches == before
    np.testing.assert_array_equal(got.numpy(), plain_chain(x, blocks, pargs, False))
    meta = pqb.qblock_chain(torch.from_numpy(x).to("meta"), [t.to("meta") for t in tensors],
                            pblocks)
    assert meta.device.type == "meta" and meta.shape == got.shape and meta.dtype == torch.int8
    with pytest.raises(ValueError, match="arguments"):
        pqb.qblock_chain(torch.from_numpy(x), tensors[:-1], pblocks)


# ResNet-50-224's four chains at batch 32, (n, h, w, c_mid), and the tile the
# kernel's wrapper picks for each: the fastest built tile at each on the card
# (PERF.md §6, chip_smoke.py --tiles)
RESNET50_B32_PICKS = [
    ((32, 56, 56, 64), (8, 8)),
    ((32, 28, 28, 128), (7, 7)),
    ((32, 14, 14, 256), (7, 7)),
    ((32, 7, 7, 512), (4, 4)),
]


def test_pick_tile_at_resnet50_chains_and_every_tile_fits():
    """The pick at ResNet-50-224 b32's four chains, and every built tile's
    shared memory within the limit at ResNet's widths (c_out = 4·c_mid) and
    at the test grid's."""
    for (n, h, w, c_mid), want in RESNET50_B32_PICKS:
        assert pqb.pick_tile(n, h, w) == want
        assert pqb.smem_bytes(want, c_mid, 4 * c_mid) <= pqb.SMEM_LIMIT
    for tile in pqb.TILES:
        for c_mid in (8, 44, 64, 100, 128, 136, 256, 512):
            assert pqb.smem_bytes(tile, c_mid, max(4 * c_mid, 250)) <= pqb.SMEM_LIMIT, (tile, c_mid)


def test_layout_constants_mirror_the_kernel():
    """The wrapper's copy of the kernel's shared-memory layout (ring depth,
    ring row stride, row padding, GEMM tile per spatial tile) against
    csrc/qblock.cu."""
    import re
    from pathlib import Path

    src = (Path(pqb.__file__).resolve().parents[2] / "csrc" / "qblock.cu").read_text()
    stages = int(re.search(r"constexpr int STAGES = (\d+);", src).group(1))
    ksteps = int(re.search(r"constexpr int KSTEPS = (\d+);", src).group(1))
    assert re.search(r"constexpr int RW = BKW \+ 4;", src)
    assert (pqb.STAGES, pqb.RING_ROW_WORDS) == (stages, 8 * ksteps + 4)
    for v in range(1, 400):
        p = pqb._pad8(v)
        assert p >= v and p % 16 == 8 and p - v < 16
    launches = re.findall(r"launch<Cfg<(\d+), (\d+), \d+, \d+, \d+>>", src)
    assert launches[0] == ("16", "256") and ("64", "64") in launches and ("64", "128") in launches
    assert pqb.gemm_tile((4, 4), 512) == (16, 256)
    assert pqb.gemm_tile((8, 8), 64) == (64, 64) and pqb.gemm_tile((7, 7), 256) == (64, 128)
