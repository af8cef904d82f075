"""One quantized INT8 convolution through both tiers of the PyTorch port and
of the JAX package: the fast tier bit-equal, the ref tier within 1 LSB."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402

from test_quantize import make_quant_conv_graph  # noqa: E402


@pytest.mark.parametrize("tier", ["fast", "ref"])
@pytest.mark.parametrize("act", [-1, 0, 100])
def test_int8_conv_tiers_match_jax(tier, act, rng):
    _, qg, calib = make_quant_conv_graph("int8", rng, act=act)
    blob = graph_to_tm_bytes(qg)
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = np.concatenate([jq.quantize_np(c, t_in.quant, t_in.dtype) for c in calib])
    (want,) = jt.compile_graph(
        jt.load_tm_bytes(blob), jt.Options(quant_mode=tier, batch_size=4)
    ).run(xq)
    cg = pt.compile_graph(
        pt.load_tm_bytes(blob), pt.Options(quant_mode=tier, batch_size=4), device="cpu"
    )
    assert set(cg.kernels.values()) >= {
        "lower_conv_quant_fast" if tier == "fast" else "lower_conv_quant_ref"
    }
    (got,) = cg.run(xq)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= (0 if tier == "fast" else 1), diff.max()
