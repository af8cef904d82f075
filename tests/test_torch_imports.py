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
    assert "tengine_tpu_torch.ops.cuda.stem_conv" in mods
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


def test_unported_settings_raise():
    import tengine_tpu_torch as tt

    g = _tiny_float_graph()
    qg = tt.quantize_graph(g, [np.ones((1, 3, 8, 8), np.float32)], scheme="int8", device="cpu")
    for opts, what in (
        (tt.Options(quant_mode="fast", fuse_resblock=True), "qblock_chain"),
        (tt.Options(quant_mode="fast", quant_bf16_storage=False), "qconv"),
        (tt.Options(quant_mode="fast", quant_native="on"), "native-int8"),
    ):
        with pytest.raises(NotImplementedError, match=what):
            tt.compile_graph(qg, opts, device="cpu")
    with pytest.raises(NotImplementedError, match="eq"):
        tt.quantize_graph(g, [np.ones((1, 3, 8, 8), np.float32)], scheme="int8",
                          algorithm="eq", device="cpu")
