"""Tests that need an NVIDIA card: each hand-written CUDA kernel of the port
against its plain PyTorch version, on the card. They skip where
torch.cuda.is_available() is false. This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

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


def stem_inputs(k, mode, zp_w, B, H, seed, C=3, Cout=32):
    """Seeded numpy stem inputs: raw x, float weights holding stored
    integers, requant multiplier and bias, and the quant scalars."""
    rng = np.random.default_rng(seed)
    if mode == "s8":
        x = rng.integers(-127, 128, (B, C, H, H)).astype(np.int8)
        zp_in = zp_out = 0
        lo, hi = -127, 127
        w = rng.integers(-127, 128, (Cout, C, k, k)).astype(np.float32)
    else:
        x = rng.integers(0, 256, (B, C, H, H)).astype(np.uint8)
        zp_in, zp_out, lo, hi = 117, 121, 0, 255
        w = rng.integers(0 if zp_w else -127, 128 + (128 if zp_w else 0),
                         (Cout, C, k, k)).astype(np.float32)
    mult = rng.random(Cout).astype(np.float32) * 1e-3 + 1e-4
    bias = rng.standard_normal(Cout).astype(np.float32)
    return x, w, mult, bias, dict(zp_in=zp_in, zp_out=zp_out, lo=lo, hi=hi, s_out=0.05)


def stem_port_args(x, w, mult, bias, q, k, zp_w):
    """The wrapper's tensors: raw x and pack_stem_weights' output."""
    wm, m, b = pack_stem_weights(
        w, mult, bias, k=k, zp_in=q["zp_in"], zp_w=zp_w, signed_in=x.dtype == np.int8
    )
    return torch.from_numpy(x), torch.from_numpy(wm), torch.from_numpy(m), torch.from_numpy(b)


@pytest.mark.cuda
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("k,pad,act,mode,zp_w,B,H", STEM_CASES)
def test_stem_kernel_matches_plain_on_card(k, pad, act, mode, zp_w, B, H, out_f32):
    """Bit-equal, except that SiLU may differ by one step (expf in the
    kernel, torch's sigmoid in the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stem kernel has no CPU mode")
    x, w, mult, bias, q = stem_inputs(k, mode, zp_w, B, H, seed=k * 100 + H + zp_w)
    args = [t.cuda() for t in stem_port_args(x, w, mult, bias, q, k, zp_w)]
    before = stem_qconv.launches
    got = stem_qconv(*args, k=k, pad=pad, act=act, out_f32=out_f32, **q)
    torch.cuda.synchronize()
    assert stem_qconv.launches == before + 1
    want = stem_qconv_plain(*args, k=k, pad=pad, act=act, out_f32=out_f32, **q)
    assert got.dtype == want.dtype and got.shape == want.shape == (B, H // 2, H // 2, 32)
    diff = (got.float() - want.float()).abs().max().item()
    assert diff <= (1 if act == 100 else 0), diff
