"""The stem kernel's plain PyTorch version (ops/cuda/stem_conv.py) against
the Pallas stem_qconv of the JAX package, run in interpret mode on the CPU.
The CUDA kernel itself is held to the plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tengine_tpu.ops.pallas.stem_conv import stem_qconv as jax_stem_qconv  # noqa: E402
from tengine_tpu_torch.ops.cuda.stem_conv import stem_qconv, stem_qconv_plain  # noqa: E402

from test_torch_cuda import STEM_CASES, stem_inputs, stem_port_args  # noqa: E402


@pytest.mark.parametrize("k,pad,act,mode,zp_w,B,H", STEM_CASES)
def test_stem_plain_matches_pallas(k, pad, act, mode, zp_w, B, H):
    x, w, mult, bias, q = stem_inputs(k, mode, zp_w, B, H, seed=k * 100 + H + zp_w)
    want = np.asarray(jax_stem_qconv(
        jnp.asarray(x), w, mult, bias, k=k, pad=pad, act=act, zp_w=zp_w,
        out_f32=True, **q,
    ))
    xt, wm, m, b = stem_port_args(x, w, mult, bias, q, k, zp_w)
    got = stem_qconv_plain(xt, wm, m, b, k=k, pad=pad, act=act, out_f32=True, **q).numpy()
    assert got.shape == want.shape == (B, H // 2, H // 2, 32)
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for a CPU tensor, in the storage dtype
    stored = stem_qconv(xt, wm, m, b, k=k, pad=pad, act=act, **q)
    assert stored.dtype == (torch.int8 if q["lo"] < 0 else torch.uint8)
    np.testing.assert_array_equal(stored.numpy().astype(np.float32), want)
