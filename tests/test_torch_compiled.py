"""The compiled forward of the PyTorch port: a CUDA graph captured per input
signature on the card (executor/engine.py:CompiledGraph.__call__, the
counterpart of the JAX engine's jax.jit).

On the CPU: the proof that the forward can be captured. With torch's host
upload and sync entry points patched to raise after compile_graph, the eager
forward (CompiledGraph.forward_fn) runs yolov5s, yolov3 tiers A and B,
YOLO-Fastest tier D, the narrow ResNet-50 under tier F and under the
native-int8 plan, mobilenet-v1 under tiers K and L, mobilenet-SSD under
SSD-U (its NMS on the device), RetinaFace and shufflenet-v2 (its shuffles
folded) on the integer-storage tier and MobileFaceNet under FACE-U, each
through the
routes that reach the hand-written kernels' wrappers (on the CPU their plain
versions), and the four nets in fp32. A capture
fails on an upload from pageable host memory or a sync with the host, so a
forward that makes neither is one the card can capture. A call may change
the batch or the image size (a new size is prepared at its first call).

On the card (the cuda marker; they skip here): the captured forward equals
the eager one at 0 LSB on the same nets at the same small sizes; a second
call does not overwrite the first call's outputs; a new batch size captures
a second graph; a lowering that syncs with the host or uploads host data
makes the call raise, naming its node, with no fallback; a donated input becomes the graph's input buffer, an input
that is not donated is never written. This file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -q tests/test_torch_compiled.py
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.ops import qmath  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    build_mobilefacenet_graph, build_mobilenet_ssd_graph, build_mobilenet_v1_graph,
    build_resnet50_graph, build_retinaface_mnet_graph, build_shufflenet_v2_graph,
)

RESNET_SMALL = dict(img=32, classes=16, widths=(8, 16, 32, 64), depths=(2, 2, 2, 2))
MOBILENET_SMALL = dict(img=32, classes=16,
                       widths=(32, 32, 64, 64, 64, 64, 96, 96, 96, 96, 96, 96, 128, 128))
SSD_SMALL = dict(img=64, widths=MOBILENET_SMALL["widths"],
                 extras=((128, 64), (128, 64), (32, 64), (32, 32)), conf_gain=16.0)
RETINAFACE_SMALL = dict(h=64, w=48, widths=(8, 16, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 64, 64),
                        fpn=32)
MOBILEFACENET_SMALL = dict(img=56, stem=32, bottlenecks=((2, 32, 2, 2), (2, 64, 1, 2),
                                                         (2, 64, 2, 1), (2, 64, 1, 2),
                                                         (2, 64, 1, 1)),
                           conv5=128, embedding=32)
SHUFFLENET_SMALL = dict(img=64, classes=16, stem=8, widths=(16, 32, 64), conv5=64)

# net and tier: (net, scheme, batch, Options beyond quant_mode="fast", the
# environment while compile_graph runs, the lowerings that must be taken)
CASES = {
    "yolov5s": ("yolov5s", "int8", 2, {}, {"TT_STEM_ALL": "1"},
                {"lower_conv_quant_pallas_stem"}),
    "yolov3-A": ("yolov3", "int8", 2, dict(quant_bf16_storage=False), {},
                 {"lower_conv_quant_pallas_direct"}),
    "yolov3-B": ("yolov3", "int8", 2,
                 dict(quant_bf16_storage=False, pallas_qconv=False, pallas_qgemm=True), {},
                 {"lower_conv1x1_quant_pallas"}),
    "yolofastest-D": ("yolofastest", "int8", 32, dict(quant_bf16_storage=False),
                      {"TT_DW_PALLAS": "1"}, {"lower_conv_quant_pallas_dw"}),
    "resnet50-F": ("resnet50", "int8", 2, dict(fuse_resblock=True, quant_relaxed=False), {},
                   {"lower_resblock_chain"}),
    "resnet50-plan": ("resnet50", "uint8", 2, dict(quant_native="on"), {},
                      {"lower_conv_quant_fast"}),
    "mobilenet-K": ("mobilenet", "uint8", 32, {}, {"TT_DW_PALLAS": "0"},
                    {"lower_conv_quant_fast"}),
    "mobilenet-L": ("mobilenet", "uint8", 32, dict(quant_native="on"), {"TT_DW_PALLAS": "1"},
                    {"lower_conv_quant_pallas_dw"}),
    # mobilenet-SSD's tier SSD-U: the NMS, the priors and the shape ops
    # beside qconv1x1, qconv_direct and dw_qconv
    "ssd-U": ("ssd", "uint8", 32, dict(quant_bf16_storage=False), {"TT_DW_PALLAS": "1"},
              {"lower_conv_quant_pallas_dw", "lower_conv_quant_pallas_direct",
               "lower_detection_output", "lower_priorbox"}),
    # the face pipeline's nets and shufflenet-v2 on the integer-storage tier:
    # PReLU, BatchNormalization, L2Normalization, Softmax and Crop through
    # the generic wrapper, the folded shuffles' ChannelGather passthroughs
    "retinaface-T": ("retinaface", "uint8", 2, dict(quant_bf16_storage=False), {},
                     {"lower_conv_quant_pallas_direct", "lower_crop", "lower_softmax"}),
    "mobilefacenet-U": ("mobilefacenet", "uint8", 32, dict(quant_bf16_storage=False),
                        {"TT_DW_PALLAS": "1"},
                        {"lower_conv_quant_pallas_dw", "lower_prelu", "lower_batchnorm",
                         "lower_l2norm"}),
    "shufflenet-T": ("shufflenet", "uint8", 2, dict(quant_bf16_storage=False), {},
                     {"lower_conv_quant_pallas_direct", "_lower"}),
    # the fp32 engine, which chip_smoke.py holds the quantized heads against
    "yolov5s-fp32": ("yolov5s", "fp32", 2, {}, {}, {"lower_conv"}),
    "yolov3-fp32": ("yolov3", "fp32", 2, {}, {}, {"lower_upsample"}),
    "resnet50-fp32": ("resnet50", "fp32", 2, {}, {}, {"lower_pooling", "lower_fc"}),
    "mobilenet-fp32": ("mobilenet", "fp32", 2, {}, {}, {"lower_pooling"}),
}


@functools.lru_cache(maxsize=None)
def quantized(net, scheme):
    """(quantized graph, float images) for a net at its small size, calibrated
    on the CPU from the first image (scheme "fp32": the float graph)."""
    from tengine_tpu_torch.models.darknet_zoo import build_yolofastest_graph, build_yolov3_graph
    from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph

    if net == "yolov5s":
        g, img = build_yolov5s_graph(num_classes=80, img=64)[1], 64
    elif net == "yolov3":
        g, img = build_yolov3_graph(img=64), 64
    elif net == "yolofastest":
        g, img = build_yolofastest_graph(img=64), 64
    elif net == "resnet50":
        g, img = build_resnet50_graph(pir, **RESNET_SMALL), RESNET_SMALL["img"]
    elif net == "ssd":
        g, img = build_mobilenet_ssd_graph(pir, **SSD_SMALL), SSD_SMALL["img"]
    elif net == "retinaface":
        g, img = build_retinaface_mnet_graph(pir, **RETINAFACE_SMALL), None
    elif net == "mobilefacenet":
        g, img = build_mobilefacenet_graph(pir, **MOBILEFACENET_SMALL), MOBILEFACENET_SMALL["img"]
    elif net == "shufflenet":
        g, img = build_shufflenet_v2_graph(pir, **SHUFFLENET_SMALL), SHUFFLENET_SMALL["img"]
    else:
        g, img = build_mobilenet_v1_graph(pir, **MOBILENET_SMALL), MOBILENET_SMALL["img"]
    shape = (3, img, img) if img else tuple(g.tensors[g.input_tensors[0]].shape[1:])
    x = np.random.default_rng(1).standard_normal((32, *shape)).astype(np.float32)
    if scheme == "fp32":
        return g, x
    return pt.quantize_graph(g, [x[:1]], scheme=scheme, algorithm="minmax", device="cpu"), x


def compiled(case, monkeypatch, device, batch=None):
    """The case's CompiledGraph on `device` and its quantized input (numpy)."""
    net, scheme, case_batch, extra, env, routes = CASES[case]
    batch = batch or case_batch
    qg, x = quantized(net, scheme)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cg = pt.compile_graph(qg, pt.Options(quant_mode="fast", batch_size=batch, **extra),
                          device=device)
    for k in env:
        monkeypatch.delenv(k)
    assert routes <= set(cg.kernels.values()), (case, sorted(set(cg.kernels.values())))
    t_in = qg.tensors[qg.input_tensors[0]]
    if t_in.quant is None:
        return cg, x[:batch]
    return cg, qmath.quantize_np(x[:batch], t_in.quant, t_in.dtype)


def _refuse(what):
    def refuse(*args, **kwargs):
        raise AssertionError(f"the forward called {what}")

    return refuse


def run_without_host_transfer(cg, *xs):
    """The eager forward cg.forward_fn(cg.params, ...) (what the card
    captures) on numpy inputs, with torch's upload and sync entry points
    patched to raise: the CPU's proof that the forward can be captured.
    Returns numpy outputs."""
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]
    mp = pytest.MonkeyPatch()
    try:
        for name in ("as_tensor", "from_numpy", "tensor"):
            mp.setattr(torch, name, _refuse(f"torch.{name}"))
        for name in ("item", "tolist", "numpy", "__bool__"):
            mp.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
        with torch.inference_mode():
            outs = cg.forward_fn(cg.params, *args)
    finally:
        mp.undo()
    return [o.numpy() for o in outs]


@pytest.mark.parametrize("case", list(CASES))
def test_forward_makes_no_host_transfer(case, monkeypatch):
    cg, xq = compiled(case, monkeypatch, "cpu")
    want = cg.run(xq)
    got = run_without_host_transfer(cg, xq)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_only_the_batch_dimension_may_change(monkeypatch):
    """Another batch runs on the compiled params; another image size runs
    too, on params prepared for it at its first call (here yolov3's resize
    indices, at 32 where the graph was compiled at 64): its outputs equal
    those of the graph compiled at that size, and the compiled size still
    runs after it."""
    cg, xq = compiled("yolov3-fp32", monkeypatch, "cpu")
    want = compiled("yolov3-fp32", monkeypatch, "cpu", batch=1)[0].run(xq[:1])
    got = cg.run(xq[:1])
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    small = np.ascontiguousarray(xq[:2, :, :32, :32])
    g = quantized("yolov3", "fp32")[0].clone()
    g.tensors[g.input_tensors[0]].shape = [2, 3, 32, 32]
    want = pt.compile_graph(g, pt.Options(quant_mode="fast", batch_size=2), device="cpu").run(small)
    outs = cg.run(small)
    assert outs[0].shape[2] * 2 == got[0].shape[2]
    for a, b in zip(outs, want, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(cg.run(xq[:1]), got, strict=True):
        np.testing.assert_array_equal(a, b)


def test_many_threads_prepare_a_new_size_once(monkeypatch):
    """Eight threads call one CompiledGraph at once with batches of the
    compiled image size and of a new one, the interpreter switching threads
    every few microseconds: each output equals the sequential call's, and
    the new size is prepared once (CompiledGraph's lock)."""
    import sys
    import threading
    import time

    cg, xq = compiled("yolov3-fp32", monkeypatch, "cpu")
    inputs = [xq[:1], np.ascontiguousarray(xq[:1, :, :32, :32])]
    want = [pt.compile_graph(cg.graph, cg.options, device="cpu").run(x) for x in inputs]
    import tengine_tpu_torch.executor.engine as engine

    prepared = []
    meta_pass = engine.meta_pass

    def slow_meta_pass(*args, **kwargs):  # a wide window for a second prepare
        prepared.append(1)
        time.sleep(0.2)
        return meta_pass(*args, **kwargs)

    monkeypatch.setattr(engine, "meta_pass", slow_meta_pass)
    results, errors = {}, []

    def call(i):
        try:
            results[i] = cg.run(inputs[i % 2])
        except BaseException as e:  # re-raised below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(prepared) == 1 and len(cg._sized) == 2
    for i, outs in results.items():
        for a, b in zip(outs, want[i % 2], strict=True):
            np.testing.assert_array_equal(a, b)


def test_a_failing_node_is_named():
    """An error in the forward carries the node it came from, as a note on
    the exception (its type unchanged); a failed capture reports the note
    and the first error, which the end of the capture chains as context."""
    from tengine_tpu_torch.executor.engine import _capture_failure

    def lower_broken(ctx, x):
        raise ValueError("broken lowering")

    g = pir.Graph(name="broken")
    t = g.add_tensor("x", pir.DType.FP32, [1, 4], pir.TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [t.idx])
    y = g.add_tensor("y", pir.DType.FP32, [1, 4])
    g.add_node("BrokenOp", "the_broken_node", [t.idx], [y.idx])
    g.inputs, g.outputs = [inp.idx], [g.nodes[-1].idx]
    unregister = pt.register_custom_op("BrokenOp", lower_broken)
    try:
        with pytest.raises(ValueError, match="broken lowering") as err:
            pt.compile_graph(g, pt.Options(), device="cpu")  # the prepare pass runs it
    finally:
        unregister()
    (note,) = err.value.__notes__
    assert "'the_broken_node'" in note and "BrokenOp" in note and "lower_broken" in note
    try:
        try:
            raise err.value
        except ValueError:
            raise RuntimeError("operation failed due to a previous error during capture")
    except RuntimeError as e:
        msg = _capture_failure(e)
    assert "'the_broken_node'" in msg and "ValueError: broken lowering" in msg


# --- on the card ----------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the forward is captured into a CUDA graph there only")


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), int((a.int() - b.int()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["yolov3-A", "yolov3-B", "yolofastest-D", "resnet50-F",
                                  "mobilenet-K", "mobilenet-L", "ssd-U", "retinaface-T",
                                  "mobilefacenet-U", "shufflenet-T"])
def test_captured_forward_equals_eager_on_card(case, monkeypatch):
    _need_card()
    cg, xq = compiled(case, monkeypatch, "cuda")
    x = torch.from_numpy(xq).cuda()
    with torch.inference_mode():
        eager = cg.forward_fn(cg.params, x)
    captured = cg(x)
    assert len(cg._graphs) == 1
    _equal(captured, eager)
    _equal(cg(x), eager)  # a replay


@pytest.mark.cuda
def test_outputs_are_not_overwritten_and_a_new_batch_captures_again(monkeypatch):
    _need_card()
    cg, xq = compiled("yolov3-A", monkeypatch, "cuda")
    x1 = torch.from_numpy(xq).cuda()
    x2 = torch.from_numpy(np.ascontiguousarray(xq[::-1])).cuda()
    first = cg(x1)
    kept = [o.clone() for o in first]
    second = cg(x2)
    _equal(first, kept)
    with torch.inference_mode():
        _equal(second, cg.forward_fn(cg.params, x2))
    one = cg(x1[:1])
    assert len(cg._graphs) == 2
    with torch.inference_mode():
        _equal(one, cg.forward_fn(cg.params, x1[:1]))
    _equal(cg(x1), kept)


def _syncing(ctx, x):
    """A lowering that syncs with the host on the run's device (.item(); the
    prepare pass runs on meta tensors, which have no value to read)."""
    from tengine_tpu_torch.ops.layout import like

    if x.x.device.type == "meta":
        return like(x, x.x * 1.0)
    return like(x, x.x * float(x.x.abs().max().item() > -1))


def _uploading(ctx, x):
    """A lowering that uploads host data at run time (torch.as_tensor of a
    numpy array on the device), as the pool divisor and the resize indices
    did before they became compile-time params."""
    from tengine_tpu_torch.ops.layout import like

    return like(x, x.x * torch.as_tensor(np.ones(4, np.float32), device=x.x.device))


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [_syncing, _uploading], ids=["item", "upload"])
def test_a_lowering_that_syncs_or_uploads_makes_the_call_raise(lower):
    _need_card()
    g = pir.Graph(name="sync")
    t = g.add_tensor("x", pir.DType.FP32, [2, 4], pir.TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [t.idx])
    y = g.add_tensor("y", pir.DType.FP32, [2, 4])
    g.add_node("SyncingOp", "the_syncing_node", [t.idx], [y.idx])
    g.inputs, g.outputs = [inp.idx], [g.nodes[-1].idx]
    unregister = pt.register_custom_op("SyncingOp", lower)
    try:
        cg = pt.compile_graph(g, pt.Options(), device="cuda")
        x = torch.ones(2, 4, device="cuda")
        with torch.inference_mode():
            assert torch.equal(cg.forward_fn(cg.params, x)[0], x)  # eager: fine
        with pytest.raises(RuntimeError, match="the_syncing_node") as err:
            cg(x)
        print(err.value)
        assert not cg._graphs
        torch.cuda.synchronize()  # the card is usable after the failed capture
        with torch.inference_mode():
            assert torch.equal(cg.forward_fn(cg.params, x)[0], x)
    finally:
        unregister()


@pytest.mark.cuda
def test_donated_input_is_the_graph_buffer_and_others_are_untouched(monkeypatch):
    _need_card()
    qg, _ = quantized(*CASES["yolov3-A"][:2])
    for donate in (False, True):
        cg, xq = compiled("yolov3-A", monkeypatch, "cuda")
        cg = pt.compile_graph(qg, dataclasses.replace(cg.options, donate_input=donate),
                              device="cuda")
        x1 = torch.from_numpy(xq).cuda()
        x2 = torch.from_numpy(np.ascontiguousarray(xq[::-1])).cuda()
        before = x1.clone()
        cg(x1)
        (cap,) = cg._graphs.values()
        assert (cap.inputs[0] is x1) == donate
        out2 = cg(x2)
        with torch.inference_mode():
            _equal(out2, cg.forward_fn(cg.params, x2))
        if donate:
            assert torch.equal(x1, x2)  # the buffer took the second input
        else:
            assert torch.equal(x1, before)


@pytest.mark.cuda
def test_cost_analysis_counts_launches_on_card(monkeypatch):
    _need_card()
    cg, _ = compiled("yolov3-A", monkeypatch, "cuda")
    ca = cg.cost_analysis()
    cpu = compiled("yolov3-A", monkeypatch, "cpu")[0].cost_analysis()
    assert ca["launches"] > 69 and cpu["launches"] is None
    assert ca["flops"] == cpu["flops"] > 0


@pytest.mark.cuda
def test_c_custom_kernel_runs_as_a_host_node_of_the_captured_forward(tmp_path):
    """A conv -> C custom kernel (y = 2x) -> conv graph built through the C
    API (chip_smoke.py:ck_graph_spec, 1x8x16x16 fp32), on the card with no
    device request, run on three inputs: captured once (the host node
    launched by the warm-up forward and the capture), its run() called by
    the warm-up and by each replay, each output within 1e-4 of the CPU
    run's scale (the devices sum each conv in other orders, TF32 off)."""
    import ctypes
    import shutil

    from chip_smoke import build_c_example, capi_attach, ck_graph_spec, run_ck_graph
    from tengine_tpu_torch import capi_bridge, native
    from tengine_tpu_torch.ops.cuda.host_node import custom_kernel, staging

    _need_card()
    if shutil.which("gcc") is None:
        pytest.skip("needs gcc to build the C ABI and the custom kernel")
    shim = native.build_capi()
    lib = capi_attach(shim)
    example = ctypes.CDLL(str(build_c_example(shim, tmp_path / "libcapi_example.so",
                                              shared=True)))
    example.example_double_ops.restype = ctypes.c_void_p
    ops = example.example_double_ops()
    rng = np.random.default_rng(7)
    shape = (1, 8, 16, 16)
    spec = ck_graph_spec(rng, shape=shape)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    custom_kernel.launches = 0
    g, card = run_ck_graph(lib, None, ops, spec, xs)
    graph = capi_bridge._graphs[g]
    assert len(graph._compiled._graphs) == 1
    key = next(n.params["_custom_kernel"] for n in graph.ir.nodes if n.name == "double")
    (st,) = staging(key)
    assert custom_kernel.launches == 2 and st.node.calls == 1 + len(xs) and st.node.rc == 0
    ctx = lib.create_context(b"cpu", 1)
    assert lib.set_context_device(ctx, b"CPU", None, 0) == 0
    _, cpu = run_ck_graph(lib, ctx, ops, spec, xs)
    for a, b in zip(card, cpu, strict=True):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    assert not np.array_equal(card[0], card[1])
