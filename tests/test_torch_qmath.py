"""ops/qmath.py of the PyTorch port against the JAX package's: rounding ties,
requantization, clip ranges and the numpy helpers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from tengine_tpu.graph.ir import DType as JDType  # noqa: E402
from tengine_tpu.graph.ir import QuantParam as JQuantParam  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu_torch.graph.ir import DType, QuantParam  # noqa: E402
from tengine_tpu_torch.ops import qmath as pq  # noqa: E402

TIES = np.array(
    [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 127.5, -127.5, 0.49999997, -0.49999997,
     0.0, -0.0, 126.49999, 1e9, -1e9],
    np.float32,
)


def test_round_away_ties():
    got = pq.round_away(torch.from_numpy(TIES)).numpy()
    want = np.asarray(jq.round_away(TIES))
    np.testing.assert_array_equal(got, want)
    assert got[TIES == np.float32(0.49999997)][0] == 0.0


@pytest.mark.parametrize("dtype", ["INT8", "UINT8"])
@pytest.mark.parametrize("scale,zp", [(1.0, 0), (0.5, 3), (0.0173, 128)])
def test_requantize_dequantize(dtype, scale, zp):
    if dtype == "INT8":
        zp = 0
    rng = np.random.default_rng(0)
    x = np.concatenate([TIES * scale, rng.standard_normal(256).astype(np.float32) * 300 * scale])
    x = x.astype(np.float32)
    jqp = JQuantParam.per_tensor(scale, zp, 8)
    pqp = QuantParam.per_tensor(scale, zp, 8)
    want = np.asarray(jq.requantize(x, jqp, JDType[dtype]))
    got = pq.requantize(torch.from_numpy(x), pqp, DType[dtype]).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pq.dequantize(torch.from_numpy(got), pqp).numpy(),
        np.asarray(jq.dequantize(want, jqp)),
    )
    np.testing.assert_array_equal(
        pq.quantize_np(x, pqp, DType[dtype]), jq.quantize_np(x, jqp, JDType[dtype])
    )
    np.testing.assert_array_equal(
        pq.dequantize_np(got, pqp), jq.dequantize_np(want, jqp)
    )


def test_qrange_full_range_and_clip_cast():
    for name in ("INT8", "UINT8", "INT32"):
        assert pq.qrange(DType[name]) == jq.qrange(JDType[name])
    full = QuantParam.per_tensor(0.1, -128, 8)
    full.full_range = True
    jfull = JQuantParam.per_tensor(0.1, -128, 8)
    jfull.full_range = True
    assert pq.qrange(DType.INT8, full) == jq.qrange(JDType.INT8, jfull) == (-128, 127)
    # torch casts do not saturate: clip_cast must clip first
    v = torch.tensor([300.0, -300.0, 127.4, -128.0])
    np.testing.assert_array_equal(
        pq.clip_cast(v, -127, 127, torch.int8).numpy(),
        np.asarray(jq.clip_cast(v.numpy(), -127, 127, np.int8)),
    )


def test_per_channel_requantize():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 3)).astype(np.float32) * 40
    scales = np.array([0.1, 0.2, 0.3, 0.05, 1.0], np.float32)
    zps = np.zeros(5, np.int32)
    jqp = JQuantParam(scales=scales, zero_points=zps, width=8)
    pqp = QuantParam(scales=scales, zero_points=zps, width=8)
    want = np.asarray(jq.requantize(x, jqp, JDType.INT8, channel_axis=1))
    got = pq.requantize(torch.from_numpy(x), pqp, DType.INT8, channel_axis=1).numpy()
    np.testing.assert_array_equal(got, want)
