"""The qconv_direct / qconv1x1 / qgemm_requant plain PyTorch versions
(ops/cuda/qconv.py, ops/cuda/qgemm.py) against the Pallas kernels of the JAX
package, run in interpret mode on the CPU, on the grid of
tests/test_qconv_pallas.py plus fused-residual and qgemm cases. Both sides
accumulate exactly and run the same f32 epilogue, so they agree to the bit
except where XLA's CPU compiler, which runs the Pallas kernels in interpret
mode, contracts `accf * M + B` (and the residual's multiply-adds) into one
fused multiply-add: it rounds once where the kernel's contract and the port
round twice, and a value that lands within half an f32 step of a .5 tie
then rounds to the other integer. So the bound is 1 LSB, on at most one
element in a thousand. The CUDA kernel itself is held to the plain version
on the card in tests/test_torch_cuda.py, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import jax.numpy as jnp  # noqa: E402

from tengine_tpu.ops.pallas import qconv as jq  # noqa: E402
from tengine_tpu.ops.pallas.qgemm import qgemm_requant as jax_qgemm  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    QCONV_CASES,
    QCONV_RES_CASES,
    QGEMM_CASES,
    port_qconv,
    port_qgemm,
    qconv_inputs,
    qgemm_inputs,
)


def assert_within_one_fma_lsb(got, want):
    """Same dtype and shape; at most 1 LSB apart, on at most 0.1% of the
    elements (the interpret-mode FMA contraction, module docstring)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).sum()


def jax_qconv(inp, ones_col):
    """The case through the Pallas kernel with the JAX package's own weight
    packing (ones-column included where the case asks for it)."""
    wk = jnp.asarray(jq.pack_qconv_weights(inp["w"], inp["u8"], ones_col and inp["u8"]))
    M, B = jnp.asarray(inp["M"]), jnp.asarray(inp["B"])
    x = jnp.asarray(inp["x"])
    r = jnp.asarray(inp["residual"]) if inp["res"] is not None else None
    N, H, W, C = inp["x"].shape
    if inp["pointwise"]:
        out = jq.qconv1x1(
            x.reshape(N * H * W, C), wk, M, B,
            residual=None if r is None else r.reshape(N * H * W, -1),
            res=inp["res"], **inp["kw_args"],
        )
        return np.asarray(out).reshape(N, H, W, -1)
    return np.asarray(jq.qconv_direct(x, wk, M, B, residual=r, res=inp["res"],
                                      **inp["geo"], **inp["kw_args"]))


@pytest.mark.parametrize("case", QCONV_CASES, ids=[str(c) for c in QCONV_CASES])
def test_qconv_plain_matches_pallas(case):
    inp = qconv_inputs(case, seed=sum(case[:5]))
    want = jax_qconv(inp, ones_col=case[-1])
    got = port_qconv(inp, "cpu")  # the wrapper takes the plain version on the CPU
    assert_within_one_fma_lsb(got, want)


@pytest.mark.parametrize("case", QCONV_RES_CASES, ids=[str(c) for c in QCONV_RES_CASES])
def test_qconv_residual_plain_matches_pallas(case):
    """The fused residual (+ relu) epilogue: the exact double rounding."""
    inp = qconv_inputs(case, seed=sum(case[:5]), with_res=True)
    want = jax_qconv(inp, ones_col=False)
    got = port_qconv(inp, "cpu", kernel=False)
    assert_within_one_fma_lsb(got, want)


@pytest.mark.parametrize("case", QGEMM_CASES, ids=[str(c) for c in QGEMM_CASES])
def test_qgemm_plain_matches_pallas(case):
    inp = qgemm_inputs(case, seed=sum(case[:3]))
    w_kn = inp["w"].T
    if inp["u8"]:
        w_kn = (w_kn.astype(np.int16) - 128).astype(np.int8)
    want = np.asarray(jax_qgemm(
        jnp.asarray(inp["x"]), jnp.asarray(np.ascontiguousarray(w_kn.astype(np.int8))),
        jnp.asarray(inp["M"]), jnp.asarray(inp["B"]), **inp["kw_args"],
    ))
    got = port_qgemm(inp, "cpu")
    assert got.shape == (case[0], case[2])
    assert_within_one_fma_lsb(got, want)
