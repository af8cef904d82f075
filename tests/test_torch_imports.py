"""The PyTorch port stands alone: importing every one of its modules pulls in
neither JAX nor the JAX package, and its entry points run on the card unless
the caller names the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
            "tengine_tpu_torch.models.darknet_zoo"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'tengine_tpu' or k.startswith('tengine_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr


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
    # the same calls run when the caller names the CPU
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


def test_unported_settings_raise(monkeypatch):
    import tengine_tpu_torch as tt

    monkeypatch.setenv("TT_DW_PALLAS", "1")
    calib = [np.random.default_rng(0).standard_normal((1, 3, 8, 8)).astype(np.float32)]
    qg = tt.quantize_graph(_tiny_float_graph(), calib, scheme="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="stem_s2d"):
        tt.compile_graph(qg, tt.Options(quant_mode="fast", stem_s2d=True), device="cpu")
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
    with pytest.raises(NotImplementedError, match="eq"):
        tt.quantize_graph(_tiny_float_graph(), calib, scheme="int8", algorithm="eq",
                          device="cpu")
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
    assert [h.name for h in headers] == ["mma_s8.cuh"]
    assert '#include "mma_s8.cuh"' in (build.CSRC_DIR / "qconv.cu").read_text()
    for f in list(build.CSRC_DIR.glob("*.cu")) + headers:
        (tmp_path / f.name).write_bytes(f.read_bytes())
    before = build.library_path("qconv")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.library_path("qconv") == before  # the digest reads bytes, not paths
    names = {"start": build.library_path("qconv")}
    with open(tmp_path / "mma_s8.cuh", "ab") as f:
        f.write(b"// edited\n")
    names["header edited"] = build.library_path("qconv")
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
