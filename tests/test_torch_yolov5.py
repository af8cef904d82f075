"""The PyTorch port's yolov5s slice against the JAX package, on the CPU at
img=64: the front end, the tmfile reader, the quantizer, the fp32 engine and
the INT8 fast path through the port's stem lowering."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.models.yolov5 import build_yolov5s_graph as jax_build  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph as port_build  # noqa: E402

IMG = 64


def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _quant_key(q):
    if q is None:
        return None
    return (np.asarray(q.scales).tolist(), np.asarray(q.zero_points).tolist(),
            q.width, q.full_range)


def assert_ir_equal(jg, pg):
    """Node for node and tensor for tensor: op, params, shape, dtype,
    QuantParam, data."""
    assert (jg.name, jg.inputs, jg.outputs) == (pg.name, pg.inputs, pg.outputs)
    assert (jg.layout.value, jg.model_layout.value) == (pg.layout.value, pg.model_layout.value)
    assert len(jg.nodes) == len(pg.nodes) and len(jg.tensors) == len(pg.tensors)
    for a, b in zip(jg.nodes, pg.nodes):
        assert (a.idx, a.op, a.name, a.inputs, a.outputs) == (b.idx, b.op, b.name, b.inputs, b.outputs)
        assert a.params.keys() == b.params.keys(), a.name
        for key in a.params:
            assert _same_value(a.params[key], b.params[key]), (a.name, key)
    for a, b in zip(jg.tensors, pg.tensors):
        assert (a.idx, a.name, list(a.shape)) == (b.idx, b.name, list(b.shape))
        assert (a.dtype.name, a.tensor_type.name) == (b.dtype.name, b.tensor_type.name), a.name
        assert _quant_key(a.quant) == _quant_key(b.quant), a.name
        assert (a.data is None) == (b.data is None), a.name
        if a.data is not None:
            assert a.data.dtype == b.data.dtype and np.array_equal(a.data, b.data), a.name


@pytest.fixture(scope="module")
def graphs():
    _, jg = jax_build(num_classes=80, img=IMG)
    _, pg = port_build(num_classes=80, img=IMG)
    rng = np.random.default_rng(1)
    calib = [rng.standard_normal((1, 3, IMG, IMG)).astype(np.float32) for _ in range(2)]
    jqg = jax_quantize(jg, calib, scheme="int8", algorithm="minmax")
    return jg, pg, jqg, calib


def test_front_end_builds_the_same_ir(graphs):
    jg, pg, _, _ = graphs
    assert_ir_equal(jg, pg)


@pytest.mark.parametrize("which", ["float", "int8"])
def test_tm2_reader_matches_jax_reader(graphs, which):
    jg, _, jqg, _ = graphs
    blob = graph_to_tm_bytes(jg if which == "float" else jqg)
    assert_ir_equal(jt.load_tm_bytes(blob), pt.load_tm_bytes(blob))


@pytest.mark.parametrize("algorithm", ["minmax", "kl", "aciq"])
def test_quantizer_matches_jax(graphs, algorithm):
    """Same calibration, same QuantParams: weights exact, activation scales
    within rtol 1e-5 (the fp32 engines sum in different orders)."""
    jg, pg, jqg, calib = graphs
    if algorithm != "minmax":
        jqg = jax_quantize(jg, calib, scheme="int8", algorithm=algorithm)
    pqg = pt.quantize_graph(pg, calib, scheme="int8", algorithm=algorithm, device="cpu")
    assert len(pqg.tensors) == len(jqg.tensors)
    n_act = 0
    for a, b in zip(jqg.tensors, pqg.tensors):
        assert a.dtype.name == b.dtype.name, a.name
        assert (a.quant is None) == (b.quant is None), a.name
        if a.quant is None:
            continue
        if a.tensor_type.name == "CONST" and a.dtype.name == "INT8":
            assert _quant_key(a.quant) == _quant_key(b.quant), a.name
            np.testing.assert_array_equal(a.data, b.data)
        elif a.tensor_type.name in ("VAR", "INPUT"):
            n_act += 1
            assert int(a.quant.zero_points) == int(b.quant.zero_points) == 0
            np.testing.assert_allclose(
                float(b.quant.scales), float(a.quant.scales), rtol=1e-5, err_msg=a.name
            )
    assert n_act > 100


def test_fp32_engines_agree(graphs):
    """rtol/atol 1e-3: float32 sums over ~60 convs in another order."""
    jg, pg, _, calib = graphs
    want = jt.compile_graph(jg, jt.Options(precision="fp32")).run(calib[0])
    got = pt.compile_graph(pg, pt.Options(precision="fp32"), device="cpu").run(calib[0])
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("relaxed", [True, False])
def test_int8_fast_path_matches_jax(graphs, monkeypatch, relaxed):
    """The JAX-quantized graph, carried over as tmfile bytes, through both
    engines' fast tier with the stem kernel forced on at 64x64: every head
    within 1 LSB, through the port's stem lowering. relaxed=False takes the
    exact double-rounding residual epilogue everywhere."""
    _, _, jqg, calib = graphs
    monkeypatch.setenv("TT_STEM_ALL", "1")
    blob = graph_to_tm_bytes(jqg)
    jg2, pg2 = jt.load_tm_bytes(blob), pt.load_tm_bytes(blob)
    rng = np.random.default_rng(7)
    x = np.concatenate([calib[0], rng.standard_normal((1, 3, IMG, IMG)).astype(np.float32)])
    t_in = jqg.tensors[jqg.input_tensors[0]]
    xq = jq.quantize_np(x, t_in.quant, t_in.dtype)

    opts = dict(quant_mode="fast", batch_size=2, quant_relaxed=relaxed)
    want = jt.compile_graph(jg2, jt.Options(**opts)).run(xq)
    cg = pt.compile_graph(pg2, pt.Options(**opts), device="cpu")
    chosen = set(cg.kernels.values())
    assert "lower_conv_quant_pallas_stem" in chosen and "lower_conv_quant_fast" in chosen
    assert sum(k == "lower_conv_quant_pallas_stem" for k in cg.kernels.values()) == 1
    got = cg.run(xq)
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert a.shape == b.shape and b.dtype == np.int8
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        print(f"head {a.shape}: equal fraction {(diff == 0).mean():.6f}, max |d| {diff.max()}")
        assert diff.max() <= 1
