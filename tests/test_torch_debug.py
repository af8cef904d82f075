"""The PyTorch port's debug tools (tengine_tpu_torch/executor/debug.py)
against the JAX package's, on the CPU, on the same tmfile:

  * dump_graph_tensors writes the same files (names, headers, line counts);
    the values agree within the node-by-node bounds of the other port tests:
    1 LSB on quantized tensors (XLA:CPU fuses acc·M + B into one multiply-add
    where the port rounds twice, ROADMAP §3), rtol 1e-5 / atol 1e-6 on
    float ones;
  * profile_graph lists every node in topological order with the JAX
    package's FLOP counts (_node_flops), and its report() has one row a node.

Graphs: the narrow ResNet-50 of tests/test_torch_compiled.py (img 32,
widths/8) quantized INT8 by the port, and in float, batch 2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.executor import debug as jdebug  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.executor import debug as pdebug  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.ops import qmath  # noqa: E402

from test_torch_compiled import RESNET_SMALL, build_resnet50_graph, quantized  # noqa: E402

BATCH = 2


def _graphs(kind):
    """(port graph, JAX graph read from the port's bytes, input)."""
    if kind == "int8":
        g, x = quantized("resnet50", "int8")
        g = g.clone()  # the input shape is set below; the cached graph stays as it is
        t_in = g.tensors[g.input_tensors[0]]
        x = qmath.quantize_np(x[:BATCH], t_in.quant, t_in.dtype)
    else:
        g = build_resnet50_graph(pir, **RESNET_SMALL)
        x = np.random.default_rng(2).standard_normal(
            (BATCH, 3, RESNET_SMALL["img"], RESNET_SMALL["img"])).astype(np.float32)
    for tid in g.input_tensors:
        g.tensors[tid].shape = [BATCH] + list(g.tensors[tid].shape[1:])
    return g, jt.load_tm_bytes(pt.graph_to_tm_bytes(g), name=g.name), x


def _read(path):
    with open(path) as f:
        header = f.readline()
        values = np.loadtxt(f, ndmin=1)
    return header, values


@pytest.mark.parametrize("kind", ["int8", "fp32"])
def test_dump_graph_tensors_writes_what_the_jax_package_writes(kind, tmp_path):
    g, jg, x = _graphs(kind)
    opts = dict(quant_mode="fast", batch_size=BATCH)
    mine = pdebug.dump_graph_tensors(g, [x], str(tmp_path / "port"), pt.Options(**opts),
                                     device="cpu")
    theirs = jdebug.dump_graph_tensors(jg, [x], str(tmp_path / "jax"), jt.Options(**opts))
    names = sorted(p.split("/")[-1] for p in mine)
    assert names == sorted(p.split("/")[-1] for p in theirs) and len(names) > 40
    quant = 0
    for name in names:
        (h1, a), (h2, b) = _read(tmp_path / "port" / name), _read(tmp_path / "jax" / name)
        assert h1 == h2 and a.shape == b.shape, name
        if "int8" in h1:
            quant += 1
            assert np.abs(a - b).max() <= 1, name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    assert (quant > 40) == (kind == "int8")


def test_profile_graph_lists_every_node_with_the_jax_flops():
    g, jg, x = _graphs("int8")
    opts = dict(quant_mode="fast", batch_size=BATCH)
    mine = pdebug.profile_graph(g, [x], pt.Options(**opts), repeats=1, device="cpu")
    theirs = jdebug.profile_graph(jg, [x], jt.Options(**opts), repeats=1)
    assert [n.name for n in g.toposorted()] == [t.node for t in mine.timings]
    assert ([(t.node, t.op, t.flops) for t in mine.timings]
            == [(t.node, t.op, t.flops) for t in theirs.timings])
    assert sum(t.flops for t in mine.timings) > 0 and all(t.ms > 0 for t in mine.timings)
    rows = mine.report().splitlines()
    assert len(rows) == len(mine.timings) + 2 and rows[-1].startswith("total")
    assert mine.total_ms == pytest.approx(sum(t.ms for t in mine.timings))
    conv = next(t for t in mine.timings if t.flops)
    assert conv.gflops_rate == pytest.approx(conv.flops / (conv.ms * 1e6))
