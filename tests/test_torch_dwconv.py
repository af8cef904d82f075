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
card in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tengine_tpu.ops.pallas.dw_conv import dw_qconv as jax_dw_qconv  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    DW_CASES,
    DW_EXTRA_CASES,
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
