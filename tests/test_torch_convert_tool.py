"""The port's convert tool (python -m tengine_tpu_torch.tools.convert_tool)
and the TM2 Eltwise activation it writes, on the CPU.

  * The tool runs as a module, in subprocesses started together, on a small
    fixture of each format (chip_smoke.py's encoders of mobilenet-v1 at img
    32, width multiplier 0.25, for ONNX, Caffe, ncnn, MXNet, TF and
    TFLite; tests/test_darknet_frontend.py's cfg; a torch module file; a
    tmfile), with --optimize: each exits 0, and its tmfile reads back to
    outputs equal, bit for bit, to the direct import's put through the same
    optimize.
  * split_concat_conv1x1 (in optimize) moves a conv's activation onto its
    split's final sum; the TM2 Eltwise record has no field for it. The
    port's writer records it in the node's attribute list
    (writer.py:_w_attrs), which the JAX reader skips: yolov5s at img 64
    written by the tool with --optimize and read back (by the native parser
    and the Python one) gives outputs equal to the in-memory optimized
    graph, and the JAX reader reads the same bytes into the JAX writer's
    graph without the activation.
  * A TFLite full-int8 import's activations carry QuantParam.full_range
    (their grids span [-128, 127]), which TM2_QuantParam has no field for;
    the writer records it in the producer node's attribute list. Through
    the tool (in process) and read back by either parser, every activation
    keeps the flag and the outputs equal the in-memory import's; the JAX
    reader skips the attribute and reads the JAX writer's graph without
    the flags.
"""

import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.serializer.tm2.reader import load_tm_bytes_py  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes as jax_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.convert.darknet_frontend import from_darknet  # noqa: E402
from tengine_tpu_torch.graph import ir as pir  # noqa: E402
from tengine_tpu_torch.graph.passes import optimize  # noqa: E402
from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph  # noqa: E402
from tengine_tpu_torch.tools import convert_tool  # noqa: E402

from test_darknet_frontend import CFG, _weights_blob  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SMALL = dict(img=32, classes=10, widths=tuple(max(8, w // 4) for w in chip_smoke.MOBILENET_WIDTHS))
FORMATS = ["onnx", "caffe", "ncnn", "mxnet", "tf", "tflite", "darknet", "torch", "tengine"]
TORCH_MODEL = '''import torch.nn as nn


def build_model():
    import torch

    torch.manual_seed(0)
    return nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8).eval(), nn.ReLU(),
                         nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(8, 4)).eval()
'''


def _mobilenet():
    return chip_smoke.mobilenet_layers(chip_smoke.build_mobilenet_v1_graph(pir, **SMALL))


def _darknet_blob():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(n).astype(np.float32) for n in (8, 8, 8)]
    arrays.append(np.abs(rng.standard_normal(8)).astype(np.float32) + 0.5)
    arrays += [rng.standard_normal(n).astype(np.float32) for n in (8 * 4 * 9, 8, 64, 4, 16)]
    return _weights_blob(*arrays)


def _yolov5s_raw():
    """yolov5s at img 64 as the torch front end imports it, before any pass."""
    torch.manual_seed(0)
    return build_yolov5s_graph(num_classes=80, img=64, fold_bn=False)[1]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Each format's fixture through the tool, all subprocesses at once:
    {format: (exit code, output, tmfile, the direct import)}."""
    tmp = tmp_path_factory.mktemp("convert")
    layers, shape = _mobilenet()
    jobs = {}
    for fmt in FORMATS[:6]:
        files, args = chip_smoke.FRONTEND_ENCODERS[fmt](layers, shape)
        d = tmp / fmt
        d.mkdir()
        for name, data in files.items():
            (d / name).write_bytes(data.encode() if isinstance(data, str) else data)
        jobs[fmt] = ([str(d / a) if a in files else a for a in args], shape)
    (tmp / "net.cfg").write_text(CFG)
    (tmp / "net.weights").write_bytes(_darknet_blob())
    jobs["darknet"] = (["-m", str(tmp / "net.cfg"), "-w", str(tmp / "net.weights")], [1, 4, 8, 8])
    (tmp / "model.py").write_text(TORCH_MODEL)
    jobs["torch"] = (["-m", f"{tmp / 'model.py'}:build_model"], [1, 3, 16, 16])
    pt.save_tmfile(_yolov5s_raw(), str(tmp / "yolov5s-raw.tmfile"))
    jobs["tengine"] = (["-m", str(tmp / "yolov5s-raw.tmfile")], [1, 3, 64, 64])
    procs = {}
    for fmt, (args, shape) in jobs.items():
        out = tmp / f"{fmt}.tmfile"
        cmd = [sys.executable, "-m", "tengine_tpu_torch.tools.convert_tool", "-f", fmt, *args,
               "--input-shape", ",".join(map(str, shape)), "--optimize", "-o", str(out)]
        procs[fmt] = (subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), out, args, shape)
    result = {}
    for fmt, (proc, out, args, shape) in procs.items():
        text, _ = proc.communicate(timeout=600)
        result[fmt] = (proc.returncode, text, out, args, shape)
    return result


def direct_import(fmt, args, shape):
    """The port's front end called in process on the tool's files, then
    optimize, as the tool does."""
    files = [a for a in args if a not in ("-m", "-w")]
    if fmt == "onnx":
        from tengine_tpu_torch.convert.onnx_frontend import from_onnx

        g = from_onnx(files[0], input_shape=shape)
    elif fmt == "caffe":
        from tengine_tpu_torch.convert.caffe_frontend import from_caffe

        g = from_caffe(*files, input_shape=shape)
    elif fmt == "ncnn":
        from tengine_tpu_torch.convert.ncnn_frontend import from_ncnn

        g = from_ncnn(*files, input_shape=shape)
    elif fmt == "mxnet":
        from tengine_tpu_torch.convert.mxnet_frontend import from_mxnet

        g = from_mxnet(*files, input_shape=shape)
    elif fmt == "tf":
        from tengine_tpu_torch.convert.tf_frontend import from_tf_graphdef

        g = from_tf_graphdef(files[0], input_shape=shape)
    elif fmt == "tflite":
        from tengine_tpu_torch.convert.tflite_frontend import from_tflite

        g = from_tflite(files[0])
    elif fmt == "darknet":
        g = from_darknet(*files)
    elif fmt == "torch":
        model = convert_tool.load_torch_model(files[0])
        from tengine_tpu_torch.convert.torch_frontend import from_torch

        g = from_torch(model, torch.zeros(*shape))
    else:
        g = pt.load_model(files[0])
    return optimize(g)


@pytest.mark.parametrize("fmt", FORMATS)
def test_tool_output_reads_back_to_the_direct_import(fmt, converted):
    rc, text, out, args, shape = converted[fmt]
    assert rc == 0, text
    assert f"wrote {out}" in text and "optimize:" in text
    g = pt.load_model(str(out))
    want_g = direct_import(fmt, args, shape)
    assert pt.graph_to_tm_bytes(g) == pt.graph_to_tm_bytes(want_g)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = pt.compile_graph(g, device="cpu").run(x)
    want = pt.compile_graph(want_g, device="cpu").run(x)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_tool_flags_are_the_reference_tools():
    """The same frameworks and flags as tools/convert_tool.py."""
    with pytest.raises(SystemExit):
        convert_tool.main(["-h"])
    with pytest.raises(SystemExit):
        convert_tool.main(["-f", "keras", "-m", "x", "-o", "y"])
    src = (REPO / "tools" / "convert_tool.py").read_text()
    for flag in ('"-f", "--framework"', '"-w", "--weights"', '"-m", "--model"',
                 '"-o", "--output"', '"--input-shape"', '"--optimize"'):
        assert flag in src and flag in Path(convert_tool.__file__).read_text()
    for fmt in FORMATS:
        assert f'"{fmt}"' in Path(convert_tool.__file__).read_text()


@functools.lru_cache(maxsize=None)
def yolov5s_optimized():
    return optimize(_yolov5s_raw())


@pytest.mark.parametrize("parser", ["native", "python"])
def test_eltwise_activation_survives_the_tool(parser, converted, monkeypatch):
    """yolov5s at img 64 through the tool with --optimize: the split sums'
    activations read back (SiLU on the C3 sums), and the outputs equal the
    in-memory optimized graph's bit for bit."""
    rc, text, out, _, shape = converted["tengine"]
    assert rc == 0, text
    monkeypatch.setenv("TT_NATIVE_PARSER", "1" if parser == "native" else "0")
    g = pt.load_model(str(out))
    ref = yolov5s_optimized()
    acts = {n.name: n.params["activation"] for n in ref.nodes
            if n.op == "Eltwise" and n.params.get("activation", -1) >= 0}
    assert len(acts) >= 8
    assert {n.name: n.params.get("activation") for n in g.nodes if n.name in acts} == acts
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = pt.compile_graph(g, device="cpu").run(x)
    want = pt.compile_graph(ref, device="cpu").run(x)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def test_jax_reader_skips_the_activation_attribute(converted):
    """The same bytes read by the JAX package (Python and native parsers):
    the graph its writer would write for the optimized net with the sums'
    activations dropped, as every tmfile before the port's attribute."""
    _, _, out, _, _ = converted["tengine"]
    data = out.read_bytes()
    stripped = pt.load_tm_bytes(data)
    for n in stripped.nodes:
        if n.op == "Eltwise":
            n.params.pop("activation", None)
    want = pt.graph_to_tm_bytes(stripped)
    assert want != data
    for native in (True, False):
        jg = jt.load_tm_bytes(data) if native else load_tm_bytes_py(data)
        assert not any("activation" in n.params for n in jg.nodes if n.op == "Eltwise")
        assert jax_bytes(jg) == want


@functools.lru_cache(maxsize=None)
def int8_tflite():
    """chip_smoke's narrow mobilenet as encode_tflite's full-int8 file, on
    the UINT8 MinMax grids of its fp32 import, and its input shape."""
    from tengine_tpu_torch.convert.tflite_frontend import from_tflite

    layers, shape = _mobilenet()
    (blob,) = chip_smoke.encode_tflite(layers, shape)[0].values()
    x = np.random.default_rng(11).standard_normal((1, *shape[1:])).astype(np.float32)
    qg = pt.quantize_graph(from_tflite(blob), [x], scheme="uint8", algorithm="minmax",
                           device="cpu")
    (blob8,) = chip_smoke.encode_tflite(layers, shape, chip_smoke.tflite_grids(qg))[0].values()
    return blob8, shape


def full_range_flags(g):
    return {t.name: t.quant.full_range for t in g.tensors if t.quant is not None}


@pytest.mark.parametrize("parser", ["native", "python"])
def test_full_range_survives_the_tool(parser, tmp_path, monkeypatch):
    from tengine_tpu_torch.convert.tflite_frontend import from_tflite

    blob, shape = int8_tflite()
    (tmp_path / "m.tflite").write_bytes(blob)
    out = tmp_path / "m.tmfile"
    convert_tool.main(["-f", "tflite", "-m", str(tmp_path / "m.tflite"), "--input-shape",
                       ",".join(map(str, shape)), "--optimize", "-o", str(out)])
    monkeypatch.setenv("TT_NATIVE_PARSER", "1" if parser == "native" else "0")
    g, want = pt.load_model(str(out)), optimize(from_tflite(blob))
    flags = full_range_flags(g)
    assert flags == full_range_flags(want)
    acts = [t for t in g.tensors if t.data is None and t.dtype == pir.DType.INT8]
    assert len(acts) == 30 and all(flags[t.name] for t in acts)
    assert not any(flags[t.name] for t in g.tensors if t.data is not None and t.quant is not None)
    x = np.random.default_rng(3).integers(-128, 128, [1, *shape[1:]]).astype(np.int8)
    got = pt.compile_graph(g, pt.Options(quant_mode="fast"), device="cpu").run(x)
    ref = pt.compile_graph(want, pt.Options(quant_mode="fast"), device="cpu").run(x)
    for a, b in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a, b)


def test_jax_reader_skips_the_full_range_attribute():
    """The port's bytes of the full-int8 import, read by the JAX package
    (native and Python parsers): the JAX writer's graph of the same import
    with every flag unset, which is also the port's writer's bytes of it."""
    from tengine_tpu.convert.tflite_frontend import from_tflite as jax_from_tflite
    from tengine_tpu_torch.convert.tflite_frontend import from_tflite

    blob, _ = int8_tflite()
    g = from_tflite(blob)
    data = pt.graph_to_tm_bytes(g)
    bare = g.clone()
    for t in bare.tensors:
        if t.quant is not None:
            t.quant.full_range = False
    want = pt.graph_to_tm_bytes(bare)
    assert want != data and want == jax_bytes(jax_from_tflite(blob))
    for jg in (jt.load_tm_bytes(data), load_tm_bytes_py(data)):
        assert not any(t.quant.full_range for t in jg.tensors if t.quant is not None)
        assert jax_bytes(jg) == want
