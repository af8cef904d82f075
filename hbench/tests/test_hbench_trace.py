"""The per-forward reading of a device trace, on made-up events: kernels
that run side by side count once."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from hbench import trace


def _ev(name: str, start: float, end: float):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end))


def test_side_by_side_kernels_count_once():
    conv = "void implicit_convolve_dgemm<128, 5, 7, 3, 3, 5, 1, false, true, true>"
    dev = [_ev("qwiden_kernel(WidenArgs)", 0.0, 100.0),
           _ev(conv, 100.0, 1100.0), _ev(conv, 150.0, 1050.0), _ev(conv, 200.0, 1200.0),
           _ev("qrequant_kernel(RequantArgs)", 1200.0, 1300.0),
           _ev("void at::native::vectorized_elementwise_kernel<4, add>", 1400.0, 1450.0)]
    got = trace.forward_ms(dev, 2)
    assert got["launches"] == 3.0
    assert got["lib_conv_ms"] == pytest.approx(1100.0 / 1e3 / 2)
    assert got["own_kernel_ms"] == pytest.approx(200.0 / 1e3 / 2)
    assert got["elementwise_ms"] == pytest.approx(50.0 / 1e3 / 2)
    assert got["busy_ms"] == pytest.approx(1350.0 / 1e3 / 2)


def test_one_stream_reads_the_sum():
    dev = [_ev(f"sm90_xmma_gemm_f64f64_{i}", 10.0 * i, 10.0 * i + 7.5) for i in range(8)]
    got = trace.forward_ms(dev, 1)
    assert got["lib_conv_ms"] == sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
