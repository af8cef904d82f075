"""Inputs of another image size than the compiled one, in both engines, on
the CPU. The JAX engine's __call__ is jax.jit, which retraces at a new
shape; the port's CompiledGraph runs the prepare pass again for the new
size, into a ParamStore of its own, and keeps the kernels it selected.

Where the JAX engine computes a size-bound value inside its trace (the
nearest-resize indices, the average pool's divisor), both run at the new
size. Where it keeps a prepare-time param of the compiled size (PriorBox's
priors, a zero-point correction), the JAX engine fails at the new size; the
port prepares that param for it (ROADMAP §3, faults in the reference).

Tolerances: the float yolov3 heads of the two engines within rtol 1e-4,
atol 1e-4 (75 fp32 convs summed in different orders); the port at the new
size equal, bit for bit, to the port compiled at that size.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.models.darknet_zoo import build_yolov3_graph  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402

from test_torch_compiled import run_without_host_transfer  # noqa: E402
from test_torch_ssd import TIERS, net  # noqa: E402


def _at_size(blob, img, batch):
    """The tmfile's graph in the port with its input at img x img."""
    g = pt.load_tm_bytes(blob)
    g.tensors[g.input_tensors[0]].shape = [batch, 3, img, img]
    return g


def test_float_yolov3_at_a_second_size_in_both_engines():
    """Compiled at 64, called at 96 (and at 64 again): the JAX engine
    retraces, the port prepares the Upsample's indices for 96; the heads
    agree, and the port's equal those of the port compiled at 96."""
    blob = graph_to_tm_bytes(build_yolov3_graph(img=64))
    rng = np.random.default_rng(5)
    x64 = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    x96 = rng.standard_normal((2, 3, 96, 96)).astype(np.float32)
    cgj = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(precision="fp32"))
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(precision="fp32"), device="cpu")
    first = cg.run(x64)
    got = cg.run(x96)
    want = cgj.run(x96)
    assert [o.shape for o in got] == [(2, 255, 3, 3), (2, 255, 6, 6), (2, 255, 12, 12)]
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
    at96 = pt.compile_graph(_at_size(blob, 96, 2), pt.Options(precision="fp32"), device="cpu")
    for a, b in zip(got, at96.run(x96), strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(cg.run(x64), first, strict=True):
        np.testing.assert_array_equal(a, b)


def test_ssd_priors_at_a_second_size():
    """mobilenet-SSD UINT8 under tier S, compiled at 64 and called at 96:
    the port's priors (and everything else) prepared for 96, its outputs
    equal to those of the port compiled at 96, with no host transfer in the
    forward; the JAX engine keeps the priors of 64 and fails."""
    *_, jqg, _, xq = net()
    blob = graph_to_tm_bytes(jqg)
    x96 = np.random.default_rng(6).integers(0, 256, (2, 3, 96, 96)).astype(np.uint8)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**TIERS["S"]), device="cpu")
    got = cg.run(x96)
    assert got[0].shape == (2, 100, 6) and got[1].shape[1] == 204 * 4
    at96 = pt.compile_graph(_at_size(blob, 96, 2), pt.Options(**TIERS["S"]), device="cpu")
    for a, b in zip(got, at96.run(x96), strict=True):
        np.testing.assert_array_equal(a, b)
    fn, params = cg._for_size([torch.from_numpy(x96)])
    assert fn is not cg.forward_fn and params["n%d/priors" % next(
        n.idx for n in cg.graph.nodes if n.op == "PriorBox")].shape[1] == 36 * 3 * 4
    sized = types.SimpleNamespace(forward_fn=fn, params=params)
    for a, b in zip(run_without_host_transfer(sized, x96), got, strict=True):
        np.testing.assert_array_equal(a, b)
    cgj = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**TIERS["S"]))
    with pytest.raises(TypeError, match="reshape"):
        cgj.run(x96)
