"""The PyTorch port stands alone: importing every one of its modules pulls in
neither JAX nor the JAX package (nor tensorflow, flatbuffers or protobuf:
the front ends decode their formats themselves), and its entry points run
on the card unless the caller names the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "tengine_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax():
    mods = _port_modules()
    assert {"tengine_tpu_torch.ops.cuda.stem_conv", "tengine_tpu_torch.ops.cuda.qconv",
            "tengine_tpu_torch.ops.cuda.qgemm", "tengine_tpu_torch.ops.cuda.dw_conv",
            "tengine_tpu_torch.ops.cuda.qblock", "tengine_tpu_torch.ops.fused",
            "tengine_tpu_torch.convert.darknet_frontend",
            "tengine_tpu_torch.models.darknet_zoo", "tengine_tpu_torch.api",
            "tengine_tpu_torch.executor.debug", "tengine_tpu_torch.ops.detection",
            "tengine_tpu_torch.serializer.tm2.writer", "tengine_tpu_torch.native",
            "tengine_tpu_torch.utils.data", "tengine_tpu_torch.utils.pipeline",
            "tengine_tpu_torch.parallel.serving", "tengine_tpu_torch.models.detect_zoo",
            "tengine_tpu_torch.models.detect_zoo2", "tengine_tpu_torch.models.detect_zoo3",
            "tengine_tpu_torch.models.zoo", "tengine_tpu_torch.capi_bridge",
            "tengine_tpu_torch.ops.cuda.host_node", "tengine_tpu_torch.parallel.mesh",
            "tengine_tpu_torch.parallel.sharding",
            "tengine_tpu_torch.parallel.distributed"} | set(FRONTEND_MODULES) | set(CLI_MODULES) <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'tengine_tpu', 'tensorflow', 'flatbuffers')\n"
        "             or k.startswith('google.protobuf'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr


# the example and tool CLIs: the 25 examples with _runner, and the tools
CLI_MODULES = [f"tengine_tpu_torch.examples.{p.stem}"
               for p in sorted((PACKAGE / "examples").glob("*.py")) if p.stem != "__init__"] + [
    f"tengine_tpu_torch.tools.{m}" for m in ("quant_tool", "align_tool", "benchmark",
                                             "accuracy_eval")]
assert len(CLI_MODULES) == 30

# the front ends and the convert tool: none may import jax, the JAX package,
# tensorflow, flatbuffers or protobuf
FRONTEND_MODULES = [f"tengine_tpu_torch.convert.{m}" for m in (
    "onnx_frontend", "caffe_frontend", "ncnn_frontend", "mxnet_frontend", "tf_frontend",
    "tflite_frontend", "darknet_frontend", "torch_frontend", "_flatbuf")] + [
    "tengine_tpu_torch.tools.convert_tool"]
BLOCKED = ("jax", "tengine_tpu", "tensorflow", "flatbuffers", "google.protobuf")


def test_frontends_import_and_parse_with_those_packages_blocked():
    """In a fresh interpreter where importing jax, tengine_tpu, tensorflow,
    flatbuffers or google.protobuf fails (sys.modules entries set to None),
    every front end and the convert tool import, and from_tf_graphdef and
    from_tflite parse chip_smoke.py's encodings of a small mobilenet-v1."""
    code = (
        "import importlib, sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        f"for m in {FRONTEND_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from tengine_tpu_torch.graph import ir\n"
        "from tengine_tpu_torch.convert.tf_frontend import from_tf_graphdef\n"
        "from tengine_tpu_torch.convert.tflite_frontend import from_tflite\n"
        "g = chip_smoke.build_mobilenet_v1_graph(ir, img=32, classes=10,\n"
        "    widths=(8, 16, 32, 32, 64, 64, 128, 128, 128, 128, 128, 128, 256, 256))\n"
        "layers, shape = chip_smoke.mobilenet_layers(g)\n"
        "(pb,) = chip_smoke.encode_tf_graphdef(layers, shape)[0].values()\n"
        "(fb,) = chip_smoke.encode_tflite(layers, shape)[0].values()\n"
        "for imported in (from_tf_graphdef(pb), from_tflite(fb)):\n"
        "    assert sum(n.op == 'Convolution' for n in imported.nodes) == 27\n"
        "print('parsed')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0 and "parsed" in r.stdout, r.stderr


def test_c_abi_builds_and_attaches_with_jax_blocked():
    """The C ABI with jax and the JAX package blocked (sys.modules entries set
    to None) in a fresh interpreter: capi_bridge and host_node import,
    native.build_capi builds the library with gcc, and, loaded into the
    process, its init_tengine imports tengine_tpu_torch.capi_bridge and
    set_default_device takes "CPU"."""
    import shutil

    if shutil.which("gcc") is None:
        pytest.skip("needs gcc")
    code = (
        "import sys\n"
        "for m in ('jax', 'tengine_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import tengine_tpu_torch.capi_bridge, tengine_tpu_torch.ops.cuda.host_node\n"
        "from tengine_tpu_torch import native\n"
        "import chip_smoke\n"
        "lib = chip_smoke.capi_attach(native.build_capi())\n"
        "assert lib.set_default_device(b'CPU') == 0\n"
        "assert lib.get_tengine_version() == tengine_tpu_torch.__version__.encode()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'tengine_tpu')\n"
        "             and sys.modules[k] is not None)\n"
        "assert not bad, bad\n"
        "print('attached')\n"
    )
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0 and "attached" in r.stdout, r.stderr


def _tiny_float_graph():
    from tengine_tpu_torch.graph.ir import DType, Graph, TensorType

    g = Graph(name="tiny")
    x = g.add_tensor("x", DType.FP32, [1, 3, 8, 8], TensorType.INPUT)
    w = g.add_tensor(
        "w", DType.FP32, [4, 3, 1, 1], TensorType.CONST,
        data=np.ones((4, 3, 1, 1), np.float32),
    )
    y = g.add_tensor("y", DType.FP32, [1, 4, 8, 8])
    g.add_node("InputOp", "in", [], [x.idx])
    params = dict(
        kernel_h=1, kernel_w=1, stride_h=1, stride_w=1, pad_h0=0, pad_h1=0,
        pad_w0=0, pad_w1=0, dilation_h=1, dilation_w=1, group=1,
        output_channel=4, input_channel=3, activation=-1,
    )
    g.add_node("Convolution", "conv", [x.idx, w.idx], [y.idx], params=params)
    g.inputs = [0]
    g.outputs = [1]
    return g


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    import tengine_tpu_torch as tt

    g = _tiny_float_graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.compile_graph(g)
    x = np.ones((1, 3, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.quantize_graph(g, [x], scheme="int8")
    from tengine_tpu_torch.parallel.serving import InferenceServer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(g)
    # the same calls run when the caller names the CPU
    server = InferenceServer(g, device="cpu")
    server.start()
    try:
        (served,) = server(x)
    finally:
        server.stop()
    np.testing.assert_array_equal(served, np.full((1, 4, 8, 8), 3.0, np.float32))
    (out,) = tt.compile_graph(g, device="cpu").run(x)
    np.testing.assert_array_equal(out, np.full((1, 4, 8, 8), 3.0, np.float32))
    assert tt.quantize_graph(g, [x], scheme="int8", device="cpu") is not None


def tiny_dw_graph(c=32, k=3, ir=None):
    """input -> one depthwise k×k conv (c channels, stride 1, pad k//2),
    built with the IR module `ir` (the port's by default)."""
    if ir is None:
        from tengine_tpu_torch.graph import ir
    DType, Graph, TensorType = ir.DType, ir.Graph, ir.TensorType

    rng = np.random.default_rng(3)
    g = Graph(name="dw")
    x = g.add_tensor("x", DType.FP32, [1, c, 8, 8], TensorType.INPUT)
    w = g.add_tensor("w", DType.FP32, [c, 1, k, k], TensorType.CONST,
                     data=(rng.standard_normal((c, 1, k, k)) * 0.3).astype(np.float32))
    b = g.add_tensor("b", DType.FP32, [c], TensorType.CONST,
                     data=(rng.standard_normal(c) * 0.1).astype(np.float32))
    y = g.add_tensor("y", DType.FP32, [1, c, 8, 8])
    g.add_node("InputOp", "in", [], [x.idx])
    params = dict(
        kernel_h=k, kernel_w=k, stride_h=1, stride_w=1, pad_h0=k // 2, pad_h1=k // 2,
        pad_w0=k // 2, pad_w1=k // 2, dilation_h=1, dilation_w=1, group=c,
        output_channel=c, input_channel=c, activation=-1,
    )
    g.add_node("Convolution", "dw", [x.idx, w.idx, b.idx], [y.idx], params=params)
    g.inputs = [0]
    g.outputs = [1]
    return g


def two_block_chain_graph(c=16, c_mid=8, hw=8):
    """input -> two identity bottlenecks 1x1(relu) -> 3x3 p1(relu) -> 1x1 ->
    Eltwise SUM -> ReLu, built with the port's IR."""
    from tengine_tpu_torch.graph.ir import DType, Graph, TensorType

    rng = np.random.default_rng(5)
    g = Graph(name="chain")
    t = g.add_tensor("data", DType.FP32, [2, c, hw, hw], TensorType.INPUT)
    inp = g.add_node("InputOp", "input", [], [t.idx])

    def conv(name, x, c_out, k, act):
        c_in = x.shape[1]
        w = g.add_tensor(f"{name}.w", DType.FP32, [c_out, c_in, k, k], TensorType.CONST,
                         data=(rng.standard_normal((c_out, c_in, k, k)) * 0.3).astype(np.float32))
        y = g.add_tensor(f"{name}.out", DType.FP32, [2, c_out, hw, hw])
        g.add_node("Convolution", name, [x.idx, w.idx], [y.idx], params=dict(
            kernel_h=k, kernel_w=k, stride_h=1, stride_w=1, pad_h0=k // 2, pad_h1=k // 2,
            pad_w0=k // 2, pad_w1=k // 2, dilation_h=1, dilation_w=1, group=1,
            output_channel=c_out, input_channel=c_in, activation=act))
        return y

    for i in range(2):
        m = conv(f"b{i}.c3", conv(f"b{i}.c2", conv(f"b{i}.c1", t, c_mid, 1, 0), c_mid, 3, 0), c, 1, -1)
        s = g.add_tensor(f"b{i}.sum", DType.FP32, [2, c, hw, hw])
        g.add_node("Eltwise", f"b{i}.add", [m.idx, t.idx], [s.idx], params=dict(type=2))
        t = g.add_tensor(f"b{i}.relu", DType.FP32, [2, c, hw, hw])
        g.add_node("ReLu", f"b{i}.r", [s.idx], [t.idx], params=dict(negative_slope=0.0))
    g.inputs = [inp.idx]
    g.outputs = [g.tensors[t.idx].producer]
    return g


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for a CPU (or meta) tensor; the
    dw and chain wrappers check what their kernels take before they would
    launch."""
    from tengine_tpu_torch.ops.cuda import dw_conv as pd

    w = np.zeros((8, 1, 3, 3), np.float32)
    w[:, 0, 1, 1] = 1
    x = torch.arange(2 * 4 * 4 * 8, dtype=torch.int32).reshape(2, 4, 4, 8).to(torch.int8)
    args = (torch.from_numpy(pd.pack_dw_taps(w)), torch.ones(8), torch.zeros(8))
    out = pd.dw_qconv(x, *args, k=3, pad_t=1, pad_b=1, pad_l=1, pad_r=1)
    assert pd.dw_qconv.launches == 0 and torch.equal(out, x)  # identity taps, M = 1
    meta = pd.dw_qconv(x.to("meta"), *(a.to("meta") for a in args), k=3, stride=2, pad_t=1,
                       pad_b=1, pad_l=1, pad_r=1)
    assert meta.shape == (2, 2, 2, 8) and meta.dtype == torch.int8
    with pytest.raises(ValueError, match="k in"):
        pd._launch(x, *args, k=7, stride=1, pad_t=3, pad_b=3, pad_l=3, pad_r=3, zp_in=0,
                   zp_out=0, act=-1, s_out=1.0, lo=-128.0, hi=127.0, out_u8=False)

    from tengine_tpu_torch.ops.cuda import qblock as pqb

    blk = pqb.QBlock(c_in=8, c_mid=8, c_out=8, act1=-1, act2=-1)
    eye = np.eye(8, dtype=np.int8).reshape(8, 8, 1, 1)
    w2 = np.zeros((8, 8, 3, 3), np.int8)
    w2[:, :, 1, 1] = np.eye(8, dtype=np.int8)
    one = np.ones(8, np.float32)
    a = [torch.from_numpy(t) for t in pqb.pack_block_args(
        pqb.build_block_args(blk, eye, None, w2, None, eye, None, 1.0, one, one, one))]
    out = pqb.qblock_chain(x, a, [blk])
    # identity convs, every scale 1: y = t + r = 2x, clipped
    assert pqb.qblock_chain.launches == 0 and torch.equal(out, torch.clamp(2 * x.int(), -127, 127).to(torch.int8))
    meta = pqb.qblock_chain(x.to("meta"), [t.to("meta") for t in a], [blk])
    assert meta.shape == x.shape and meta.dtype == torch.int8
    with pytest.raises(ValueError, match="channels"):
        pqb._block_args(x[..., :4].contiguous(), x, a, blk, False, (4, 4))
    with pytest.raises(ValueError, match="tile"):
        pqb._block_args(x, x, a, blk, False, (5, 5))


def _stem_graph(img=320):
    """input -> a 6x6 s2 p2 stem conv (3 -> 8): the shape stem_conv_s2d
    rewrites at its compile-time gate."""
    from tengine_tpu_torch.graph.ir import DType, Graph, TensorType

    rng = np.random.default_rng(6)
    g = Graph(name="stem")
    x = g.add_tensor("x", DType.FP32, [1, 3, img, img], TensorType.INPUT)
    w = g.add_tensor("w", DType.FP32, [8, 3, 6, 6], TensorType.CONST,
                     data=(rng.standard_normal((8, 3, 6, 6)) * 0.2).astype(np.float32))
    y = g.add_tensor("y", DType.FP32, [1, 8, img // 2, img // 2])
    g.add_node("InputOp", "in", [], [x.idx])
    params = dict(
        kernel_h=6, kernel_w=6, stride_h=2, stride_w=2, pad_h0=2, pad_h1=2,
        pad_w0=2, pad_w1=2, dilation_h=1, dilation_w=1, group=1,
        output_channel=8, input_channel=3, activation=-1,
    )
    g.add_node("Convolution", "stem", [x.idx, w.idx], [y.idx], params=params)
    g.inputs = [0]
    g.outputs = [1]
    return g


def test_unported_settings_raise(monkeypatch):
    """The settings that raised NotImplementedError while their modules
    were not ported now run, each held to the JAX package: stem_s2d, EQ,
    the native-int8 plan, the dw route and the chain kernel. The server's
    mesh (ported since): InferenceServer(mesh=make_mesh(...)) on a world of
    one answers as the server without a mesh."""
    import tengine_tpu as jt
    from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize

    import tengine_tpu_torch as tt
    from tengine_tpu_torch.ops import qmath
    from tengine_tpu_torch.serializer.tm2.writer import graph_to_tm_bytes

    from tengine_tpu_torch.parallel.distributed import init_distributed, shutdown_distributed
    from tengine_tpu_torch.parallel.mesh import make_mesh
    from tengine_tpu_torch.parallel.serving import InferenceServer
    from test_torch_multiprocess import free_port

    xs = np.random.default_rng(1).integers(-4, 5, (3, 3, 8, 8)).astype(np.float32)
    answers = {}
    assert init_distributed(f"localhost:{free_port()}", 1, 0, device="cpu")
    try:
        for mesh in (None, make_mesh(device="cpu")):
            server = InferenceServer(_tiny_float_graph(), tt.Options(precision="fp32"), mesh=mesh,
                                     max_batch=4, max_wait_ms=20.0, device="cpu")
            server.start()
            try:
                answers[mesh is None] = [f.result(timeout=60)[0]
                                         for f in [server.submit(x) for x in xs]]
            finally:
                server.stop()
    finally:
        shutdown_distributed()
    for a, b in zip(answers[True], answers[False]):
        assert np.array_equal(a, b) and a.shape == (1, 4, 8, 8)

    monkeypatch.setenv("TT_DW_PALLAS", "1")
    calib = [np.random.default_rng(0).standard_normal((1, 3, 8, 8)).astype(np.float32)]
    qg = tt.quantize_graph(_tiny_float_graph(), calib, scheme="int8", device="cpu")
    # stem_s2d: ported, so the stem compiles rewritten and equals the JAX
    # engine's output under the same Options
    images = np.random.default_rng(1).standard_normal((1, 3, 320, 320)).astype(np.float32)
    qs = tt.quantize_graph(_stem_graph(), [images], scheme="int8", device="cpu")
    t_in = qs.tensors[qs.input_tensors[0]]
    xq = qmath.quantize_np(images, t_in.quant, t_in.dtype)
    opts = dict(quant_mode="fast", stem_s2d=True)
    cg = tt.compile_graph(qs, tt.Options(**opts), device="cpu")
    assert [n.op for n in cg.graph.nodes] == ["InputOp", "Convolution", "SpaceToDepth"]
    (want,) = jt.compile_graph(jt.load_tm_bytes(graph_to_tm_bytes(qs)), jt.Options(**opts)).run(xq)
    d = np.abs(cg.run(xq)[0].astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    # the native-int8 plan: ported, so it compiles and marks the storage plan
    cg = tt.compile_graph(qg, tt.Options(quant_mode="fast", quant_native="on"), device="cpu")
    assert cg.graph._bf16_tids == set()
    # TT_DW_PALLAS at batch >= 32 on the integer-storage tier routes a
    # depthwise conv to the dw kernel: ported, so it compiles and names it
    calib_dw = [np.random.default_rng(0).standard_normal((1, 32, 8, 8)).astype(np.float32)]
    qdw = tt.quantize_graph(tiny_dw_graph(), calib_dw, scheme="int8", device="cpu")
    cg = tt.compile_graph(
        qdw, tt.Options(quant_mode="fast", quant_bf16_storage=False, batch_size=32), device="cpu")
    assert cg.kernels["dw"] == "lower_conv_quant_pallas_dw"
    # algorithm="eq": ported, so it quantizes, to the JAX quantizer's scales
    # (on random weights: the tiny graph's all-ones weights make every zoom
    # a tie, tests/test_torch_dfq_eq.py)
    calib_s = [images[..., :16, :16].copy()]
    q_eq = tt.quantize_graph(_stem_graph(16), calib_s, scheme="int8", algorithm="eq",
                             device="cpu")
    j_eq = jax_quantize(jt.load_tm_bytes(graph_to_tm_bytes(_stem_graph(16))), calib_s,
                        scheme="int8", algorithm="eq")
    for a, b in zip(q_eq.tensors, j_eq.tensors, strict=True):
        assert (a.quant is None) == (b.quant is None)
        if a.data is not None:
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.quant.scales, b.quant.scales)
    # fuse_resblock routes bottleneck chains to the chain kernel: ported, so a
    # two-block chain compiles under the exact chain tier and names it
    chain = two_block_chain_graph()
    calib_c = [np.random.default_rng(0).standard_normal((2, 16, 8, 8)).astype(np.float32)]
    qc = tt.quantize_graph(chain, calib_c, scheme="int8", device="cpu")
    cg = tt.compile_graph(
        qc, tt.Options(quant_mode="fast", fuse_resblock=True, quant_relaxed=False), device="cpu")
    (node,) = [n for n in cg.graph.nodes if n.op == "FusedResBlockChain"]
    assert len(node.params["blocks"]) == 2 and cg.kernels[node.name] == "lower_resblock_chain"
    assert not any(n.op == "Convolution" for n in cg.graph.nodes)


def test_library_digest_follows_sources_headers_and_flags(tmp_path, monkeypatch):
    """A kernel's library is named by a digest of its source, of every header
    under csrc/ and of the nvcc flags, so that editing a header rebuilds the
    sources that include it. Checked on copies, without nvcc."""
    from tengine_tpu_torch.ops.cuda import build

    headers = sorted(build.CSRC_DIR.glob("*.cuh"))
    assert [h.name for h in headers] == ["mma_s8.cuh", "requant_steps.cuh"]
    qconv_src = (build.CSRC_DIR / "qconv.cu").read_text()
    assert '#include "mma_s8.cuh"' in qconv_src and '#include "requant_steps.cuh"' in qconv_src
    assert '#include "requant_steps.cuh"' in (build.CSRC_DIR / "requant.cu").read_text()
    for f in list(build.CSRC_DIR.glob("*.cu")) + headers:
        (tmp_path / f.name).write_bytes(f.read_bytes())
    before = build.library_path("qconv")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.library_path("qconv") == before  # the digest reads bytes, not paths
    names = {"start": build.library_path("qconv")}
    with open(tmp_path / "mma_s8.cuh", "ab") as f:
        f.write(b"// edited\n")
    names["header edited"] = build.library_path("qconv")
    requant = build.library_path("requant")
    with open(tmp_path / "requant_steps.cuh", "ab") as f:
        f.write(b"// edited\n")
    names["shared steps edited"] = build.library_path("qconv")
    assert build.library_path("requant") != requant
    (tmp_path / "new.cuh").write_bytes(b"")
    names["header added"] = build.library_path("qconv")
    with open(tmp_path / "qconv.cu", "ab") as f:
        f.write(b"// edited\n")
    names["source edited"] = build.library_path("qconv")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    names["flag added"] = build.library_path("qconv")
    assert len(set(names.values())) == len(names), names
    assert all(p.parent == build.BUILD_DIR and p.name.startswith("libqconv-") for p in names.values())
    assert build.library_path("dw_conv") != build.library_path("qconv")
