"""The stem kernel's plain PyTorch version (ops/cuda/stem_conv.py) against
the Pallas stem_qconv of the JAX package, run in interpret mode on the CPU;
the port's pack_stem_weights against the JAX package's; and a numpy
emulation of the CUDA kernel's data path (its band copies, K order and ones
column) against the plain version. The CUDA kernel itself is held to the
plain version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import jax.numpy as jnp  # noqa: E402

from tengine_tpu.ops.pallas.stem_conv import pack_stem_weights as jax_pack_stem_weights  # noqa: E402
from tengine_tpu.ops.pallas.stem_conv import stem_qconv as jax_stem_qconv  # noqa: E402
from tengine_tpu_torch.ops.qmath import round_away  # noqa: E402
from tengine_tpu_torch.ops.cuda.stem_conv import (  # noqa: E402
    MAX_TC,
    pack_stem_weights,
    pick_stem_tile,
    stem_qconv,
    stem_qconv_plain,
    stem_smem_bytes,
)

from test_torch_cuda import (  # noqa: E402
    STEM_CASES,
    STEM_EDGE_CASES,
    stem_edge_inputs,
    stem_inputs,
    stem_port_args,
)


@pytest.mark.parametrize("k,pad,act,mode,zp_w,B,H", STEM_CASES)
def test_stem_plain_matches_pallas(k, pad, act, mode, zp_w, B, H):
    x, w, mult, bias, q = stem_inputs(k, mode, zp_w, B, H, seed=k * 100 + H + zp_w)
    want = np.asarray(jax_stem_qconv(
        jnp.asarray(x), w, mult, bias, k=k, pad=pad, act=act, zp_w=zp_w,
        out_f32=True, **q,
    ))
    (xt, wm, m, b), w_corr = stem_port_args(x, w, mult, bias, q, k, zp_w)
    got = stem_qconv_plain(xt, wm, m, b, k=k, pad=pad, act=act, w_corr=w_corr, out_f32=True,
                           **q).numpy()
    assert got.shape == want.shape == (B, H // 2, H // 2, 32)
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for a CPU tensor, in the storage dtype
    stored = stem_qconv(xt, wm, m, b, k=k, pad=pad, act=act, w_corr=w_corr, **q)
    assert stored.dtype == (torch.int8 if q["lo"] < 0 else torch.uint8)
    np.testing.assert_array_equal(stored.numpy().astype(np.float32), want)


def _all_stem_cases():
    """(id, k, pad, act, zp_w, x, w, mult, bias, q) of every STEM_CASES and
    STEM_EDGE_CASES case."""
    out = []
    for k, pad, act, mode, zp_w, B, H in STEM_CASES:
        x, w, mult, bias, q = stem_inputs(k, mode, zp_w, B, H, seed=k * 100 + H + zp_w)
        out.append((f"grid-{k}-{mode}-{zp_w}-{H}", k, pad, act, zp_w, x, w, mult, bias, q))
    for case in STEM_EDGE_CASES:
        x, w, mult, bias, q, _ = stem_edge_inputs(case, seed=sum(case[5:]))
        out.append((f"edge-{case}", case[0], case[1], case[2], case[4], x, w, mult, bias, q))
    return out


STEM_ALL = _all_stem_cases()


@pytest.mark.parametrize("case", STEM_ALL, ids=[c[0] for c in STEM_ALL])
def test_pack_stem_weights_equals_jax(case):
    """The port's matrix is the Pallas packing's byte for byte: the int8
    weights, the ones column at Cout for uint8 weights, the padding; M and B
    are its rows' first Cout entries, w_corr its correction."""
    _, k, _, _, zp_w, x, w, mult, bias, q = case
    signed = x.dtype == np.int8
    wm, m, b, w_corr = pack_stem_weights(w, mult, bias, k=k, zp_in=q["zp_in"], zp_w=zp_w,
                                         signed_in=signed)
    jw, jm, jb, jcorr = jax_pack_stem_weights(w, mult, bias, k=k, zp_in=q["zp_in"], zp_w=zp_w,
                                              signed_in=signed)
    cout = w.shape[0]
    assert wm.dtype == jw.dtype == np.int8 and wm.shape == jw.shape
    np.testing.assert_array_equal(wm, jw)
    if zp_w:
        kk = w.shape[1] * k * k
        assert (wm[:kk, cout] == 1).all() and not wm[kk:, cout].any()
    np.testing.assert_array_equal(m, jm[0, :cout])
    np.testing.assert_array_equal(b, jb[0, :cout])
    assert float(w_corr) == jcorr


def emulate_stem_kernel_acc(x, wmat, w_corr, k, pad, cout, zp_in, tr=None, tc=None):
    """csrc/stem_conv.cu's integer path in numpy int64: the band of each
    block tile (re-centred by XOR 0x80 for uint8, zp_in outside the image)
    as 32-bit words, its copy shifted by two bytes, each A word gathered from
    copy (lx & 1) at word lx/2 + q of patch row (c, u), the weights in the
    kernel's K order (c, u, q, v % 4) with zero beyond v = k, and the ones
    column's patch sum times w_corr. Returns acc [B, OH, OW, Cout]."""
    B, C, H, W = x.shape
    OH, OW = H // 2, W // 2
    ptr, ptc = pick_stem_tile(OH, OW)
    tr, tc = tr or ptr, tc or ptc
    qk = (k + 3) // 4
    raw = x.view(np.uint8).astype(np.int64)
    flip = 0 if x.dtype == np.int8 else 0x80

    def s8(v):
        v = (v ^ flip) & 0xFF
        return np.where(v >= 128, v - 256, v)

    # K order (c, u, q, j): the weight of K index (c, u, q, j) is tap v = 4q + j
    kw = np.zeros((C, k, qk * 4, wmat.shape[1]), np.int64)
    wk = wmat[: C * k * k].astype(np.int64).reshape(C, k, k, -1)
    kw[:, :, :k] = wk
    ones = w_corr != 0
    acc = np.zeros((B, OH, OW, cout), np.int64)
    for oy0 in range(0, OH, tr):
        for ox0 in range(0, OW, tc):
            rows_in = 2 * (tr - 1) + k
            ww = (tc - 1) // 2 + qk
            ih = 2 * oy0 - pad + np.arange(rows_in)
            iw = 2 * ox0 - pad + np.arange(4 * (ww + 1))
            inside = ((ih >= 0) & (ih < H))[:, None] & ((iw >= 0) & (iw < W))[None, :]
            band = np.full((B, C, rows_in, 4 * (ww + 1)), zp_in & 0xFF, np.int64)
            ihc, iwc = np.clip(ih, 0, H - 1), np.clip(iw, 0, W - 1)
            vals = raw[:, :, ihc][:, :, :, iwc]
            band = np.where(inside[None, None], vals, band)
            band = s8(band)
            copies = (band, band[..., 2:])  # the shifted copy: band bytes 2.. on
            for r in range(min(tr, OH - oy0)):
                for lx in range(min(tc, OW - ox0)):
                    cp = copies[lx & 1]
                    start = 4 * (lx >> 1)
                    # the pixel's A row: (c, u, q, j) -> copy bytes at 2r + u, start + 4q + j
                    a_row = cp[:, :, 2 * r: 2 * r + k, start: start + 4 * qk]  # [B, C, k, 4qk]
                    prod = np.einsum("bcuv,cuvn->bn", a_row, kw)
                    got = prod[:, :cout]
                    if ones:
                        got = got + w_corr * prod[:, cout: cout + 1]
                    acc[:, oy0 + r, ox0 + lx] = got
    return acc


def _stem_emulated(x, w, mult, bias, q, k, pad, act, zp_w, tr=None, tc=None):
    (xt, wm, m, b), w_corr = stem_port_args(x, w, mult, bias, q, k, zp_w)
    acc = emulate_stem_kernel_acc(x, wm.numpy(), w_corr, k, pad, w.shape[0], q["zp_in"], tr, tc)
    # the same f32 epilogue as the plain version, op for op
    accf = torch.from_numpy(acc.astype(np.float32))
    qv = accf * m + b
    if act == 100:
        qv = qv * torch.sigmoid(qv * q["s_out"])
    elif act == 1:
        qv = torch.clamp(qv, -1.0 / q["s_out"], 1.0 / q["s_out"])
    elif act >= 0:
        qv = torch.clamp_min(qv, 0.0)
        if act > 0:
            qv = torch.clamp_max(qv, float(act) / q["s_out"])
    qv = torch.clamp(round_away(qv) + q["zp_out"], q["lo"], q["hi"])
    want = stem_qconv_plain(xt, wm, m, b, k=k, pad=pad, act=act, w_corr=w_corr, out_f32=True,
                            **q)
    return qv.numpy(), want.numpy()


@pytest.mark.parametrize("case", STEM_ALL, ids=[c[0] for c in STEM_ALL])
def test_stem_kernel_layout_emulation_equals_plain(case):
    """The kernel's K order, band copies and ones-column correction, emulated
    in int64, give the plain version's integers at 0 LSB."""
    _, k, pad, act, zp_w, x, w, mult, bias, q = case
    got, want = _stem_emulated(x, w, mult, bias, q, k, pad, act, zp_w)
    np.testing.assert_array_equal(got, want)


def test_stem_kernel_layout_emulation_small_tiles():
    """The same at tiles smaller than the shape (odd rows left over, several
    column tiles with odd starts): the band offsets of every tile."""
    case = STEM_EDGE_CASES[0]
    x, w, mult, bias, q, _ = stem_edge_inputs(case, seed=sum(case[5:]))
    got, want = _stem_emulated(x, w, mult, bias, q, case[0], case[1], case[2], case[4],
                               tr=3, tc=5)
    np.testing.assert_array_equal(got, want)


def test_pick_stem_tile_and_smem():
    """The block tile: two output rows, columns in even splits of at most
    MAX_TC; shared memory inside the card's 227 KB at every shape the
    wrapper takes, and three blocks an SM at yolov5s-640's."""
    assert pick_stem_tile(320, 320) == (2, 320)  # yolov5s-640
    assert pick_stem_tile(17, 17) == (2, 17)
    assert pick_stem_tile(8, 330) == (2, 165)
    assert pick_stem_tile(1, 641) == (1, 214)
    for oh, ow in [(320, 320), (208, 208), (112, 112), (8, 330), (540, 960)]:
        tr, tc = pick_stem_tile(oh, ow)
        assert tc <= MAX_TC and tr * tc >= min(ow, MAX_TC)
        for c in (1, 3, 4):
            for k in (3, 6, 7):
                assert stem_smem_bytes(c, k, tr, tc, f32=True) <= 227 * 1024
    # yolov5s-640: the raw rows (3 x 8 rows of 169 words), the band twice
    # (2 x 4,048 words), the weights, M and B, the buffers: three blocks an SM
    assert stem_smem_bytes(3, 6, 2, 320, f32=False) == 4 * (
        4056 + 2 * 4048 + 40 * 44 + 64 + 8 * 16 * 12) <= 227 * 1024 // 3
