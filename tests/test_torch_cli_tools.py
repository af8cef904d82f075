"""The port's tools (tengine_tpu_torch/tools/: quant_tool, align_tool,
benchmark, accuracy_eval) against the JAX package's (tools/), on the CPU at
small sizes, and the device rule of every new CLI: with no --device it
wants the card and raises here."""

import contextlib
import importlib
import importlib.util
import io
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from test_torch_examples import (  # noqa: E402
    MOBILENET_SMALL, assert_same_printout, jax_example, port_example, write_tmfile)

import chip_smoke  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(p.stem for p in (REPO / "tengine_tpu_torch" / "examples").glob("tm_*.py"))


def jax_tool(name, args):
    """tools/<name>.py's main() with sys.argv patched; returns what it
    printed."""
    path = REPO / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf, argv = io.StringIO(), sys.argv
    sys.argv = [str(path)] + list(args)
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = argv
    return buf.getvalue()


def port_tool(name, args):
    mod = importlib.import_module(f"tengine_tpu_torch.tools.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = mod.main(list(args) + ["--device", "cpu"])
    return buf.getvalue(), result


@pytest.fixture(scope="module")
def fp32_tmfile(tmp_path_factory):
    """The seeded narrow mobilenet-v1 (depthwise convs) at 32x32, written by
    the JAX writer."""
    from tengine_tpu.graph import ir as jir

    path = tmp_path_factory.mktemp("fp32") / "mobilenet.tmfile"
    return write_tmfile(path, chip_smoke.build_mobilenet_v1_graph(jir, **MOBILENET_SMALL))


def _assert_same_quantized(jax_path, port_path):
    """Both tools' tmfiles read back (the port's reader) to the same graph:
    ops, params and dtypes equal; the weights' QuantParams and int8 values
    equal; the activations' zero points equal and scales within rtol 1e-5,
    as tests/test_torch_yolov5.py::test_quantizer_matches_jax holds the
    quantizers (the fp32 engines sum in different orders: here they part
    by an ULP); int32 biases within 1 (ROADMAP §3, "fp32 sums")."""
    import tengine_tpu_torch as pt
    from test_torch_yolov5 import _quant_key

    jg, pg = pt.load_tmfile(jax_path), pt.load_tmfile(port_path)
    assert [(n.op, n.name, n.inputs, n.outputs) for n in jg.nodes] == \
        [(n.op, n.name, n.inputs, n.outputs) for n in pg.nodes]
    for a, b in zip(jg.nodes, pg.nodes):
        assert a.params.keys() == b.params.keys(), a.name
    n_bias = 0
    for a, b in zip(jg.tensors, pg.tensors, strict=True):
        assert (a.name, a.dtype, list(a.shape)) == (b.name, b.dtype, list(b.shape))
        assert (a.quant is None) == (b.quant is None), a.name
        if a.quant is not None and a.data is not None and a.data.dtype != np.int32:
            assert _quant_key(a.quant) == _quant_key(b.quant), a.name
        elif a.quant is not None:
            np.testing.assert_array_equal(a.quant.zero_points, b.quant.zero_points, a.name)
            np.testing.assert_allclose(np.asarray(b.quant.scales, np.float64),
                                       np.asarray(a.quant.scales, np.float64), rtol=1e-5,
                                       err_msg=a.name)
        if a.data is None:
            assert b.data is None
        elif a.data.dtype == np.int32:
            n_bias += 1
            assert np.abs(a.data.astype(np.int64) - b.data).max() <= 1, a.name
        else:
            np.testing.assert_array_equal(a.data, b.data, err_msg=a.name)
    assert n_bias > 20
    return pg


REPORT_LINE = re.compile(r"^(\S+)\s+(-?\d+\.\d{4})$")


def _report(text):
    return {m.group(1): float(m.group(2)) for m in map(REPORT_LINE.match, text.splitlines()) if m}


@pytest.mark.parametrize("extra", [[], ["-t", "int8", "-a", "kl"], ["--dfq"],
                                   ["--bias-correction", "--evaluate"]],
                         ids=["uint8", "int8-kl", "dfq", "bias-correction"])
def test_quant_tool_writes_the_jax_tools_graph(fp32_tmfile, tmp_path, extra):
    """The same fp32 tmfile and seeded calibration through both quant tools:
    the tmfiles read back to the same quantized graph; with --evaluate each
    layer's cosine within 1e-3 of the JAX report's, top-1 agreement equal.
    The uint8 case then runs each tool's tmfile through its tm_classification:
    the same top-5."""
    args = ["-m", fp32_tmfile, "-n", "2"] + extra
    jax_text = jax_tool("quant_tool", args + ["-o", str(tmp_path / "jax.tmfile")])
    port_text, result = port_tool("quant_tool", args + ["-o", str(tmp_path / "port.tmfile")])
    _assert_same_quantized(tmp_path / "jax.tmfile", tmp_path / "port.tmfile")
    assert [line for line in port_text.splitlines() if "tmfile" not in line and
            not REPORT_LINE.match(line)] == \
        [line for line in jax_text.splitlines() if "tmfile" not in line and
         not REPORT_LINE.match(line)]
    if "--evaluate" in extra:
        want, got = _report(jax_text), _report(port_text)
        assert want.keys() == got.keys() and len(want) == 30
        assert all(abs(want[k] - got[k]) <= 1e-3 for k in want), (want, got)
        assert got == {k: pytest.approx(v, abs=5e-5) for k, v in result["cosines"].items()}
        assert result["top1"] == 100.0
    if not extra:
        g_args = ["-g", "32,32"]
        assert_same_printout(jax_example("tm_classification", ["-m", str(tmp_path / "jax.tmfile")] + g_args),
                             port_example("tm_classification", ["-m", str(tmp_path / "port.tmfile")] + g_args)[0])


def test_jax_report_dequantizes_every_activation_of_a_depthwise_graph(fp32_tmfile, tmp_path,
                                                                      monkeypatch):
    """The JAX report dequantizes only uint8/int8 arrays and runs build_forward
    outside compile_graph's storage plan, where the JAX engine stores
    quantized activations as bf16. Its return_all boundary casts them back
    to their integer dtype, so on the depthwise mobilenet every quantized
    tensor it prints was dequantized: no cosine on undequantized values (no
    fault). The port's report raises if a quantized tensor ever came back
    in another dtype."""
    from tengine_tpu.ops import qmath as jq

    seen = []
    dequantize = jq.dequantize_np

    def counting(x, quant, *a, **k):
        seen.append(np.asarray(x).dtype)
        return dequantize(x, quant, *a, **k)

    monkeypatch.setattr(jq, "dequantize_np", counting)
    text = jax_tool("quant_tool", ["-m", fp32_tmfile, "-n", "1", "--evaluate",
                                   "-o", str(tmp_path / "q.tmfile")])
    printed = _report(text)
    assert len(printed) == 30 and len(seen) == 30
    assert set(seen) == {np.dtype(np.uint8)}


def test_align_tool_prints_the_jax_tools_lines(fp32_tmfile, tmp_path):
    """A small UINT8 tmfile (the JAX quantizer's, written by the JAX writer):
    fast vs ref tier, then the C engine's line (not built here)."""
    import tengine_tpu as jt
    from tengine_tpu.quantize.quantizer import quantize_graph

    g = jt.load_tmfile(fp32_tmfile)
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32)).astype(np.float32)
    path = write_tmfile(tmp_path / "u8.tmfile", quantize_graph(g, [x], scheme="uint8"))
    jax_text = jax_tool("align_tool", ["-m", path])
    port_text, result = port_tool("align_tool", ["-m", path])
    assert len(port_text.splitlines()) == 2 and "not built" in port_text
    assert_same_printout(jax_text, port_text)
    assert result["max_abs"] <= 1 and result["cosine"] > 0.999


def _bench_rows(text):
    return re.findall(r"^(\S+)\s+(\d+\.\d{3})\s+(\d+\.\d{3})\s+(\d+)$", text, re.M)


def test_benchmark_reads_the_zoo_directory(fp32_tmfile, tmp_path, monkeypatch):
    """benchmark/models under the working directory: the -m and --uint8 rows
    parse (name, min ms, avg ms, img/s); a missing net prints FAILED and the
    process exits 1."""
    models = tmp_path / "benchmark" / "models"
    models.mkdir(parents=True)
    (models / "mobilenet_benchmark.tmfile").write_bytes(Path(fp32_tmfile).read_bytes())
    monkeypatch.chdir(tmp_path)
    for extra in ([], ["--uint8", "-b", "2"]):
        text, result = port_tool("benchmark", ["-m", "mobilenetv1", "-r", "3"] + extra)
        header, columns = text.splitlines()[:2]
        assert header.startswith("tengine-tpu benchmark  batch=") and header.endswith("device=cpu")
        assert columns.split() == ["model", "min(ms)", "avg(ms)", "img/s"]
        ((name, mn, avg, ips),) = _bench_rows(text)
        assert name == "mobilenetv1" and 0 < float(mn) <= float(avg) and int(ips) > 0
        assert not result["failed"] and result["rows"][0]["name"] == "mobilenetv1"
        assert ("mode=uint8" in header) == bool(extra)
    r = subprocess.run([sys.executable, "-m", "tengine_tpu_torch.tools.benchmark", "-m",
                        "resnet50", "-r", "1", "--device", "cpu"], cwd=tmp_path,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "resnet50" in r.stderr and "FAILED" in r.stderr, r.stderr
    assert not _bench_rows(r.stdout)


def test_accuracy_eval_digit_cnn_quant_top1():
    """tests/test_accuracy_eval.py's case on the port's tool: a digit CNN
    trained 3 epochs, converted, quantized UINT8 on 16 real images; the
    port's fp32 top-1 within 2 points of torch's, UINT8 within 3 of fp32."""
    pytest.importorskip("sklearn")
    from tengine_tpu_torch.convert.torch_frontend import from_torch
    from tengine_tpu_torch.quantize.quantizer import quantize_graph
    from tengine_tpu_torch.tools import accuracy_eval as ae

    xtr, ytr, xte, yte = ae.load_digits_32()
    model = ae.build_models()["digit_cnn"]
    torch_acc = ae.train(model, xtr, ytr, xte, yte, epochs=3)
    assert torch_acc > 0.9

    g = from_torch(model, torch.zeros(1, 1, 32, 32))
    fp32 = ae.top1_ours(g, xte, yte, quantized=False, device="cpu")
    assert abs(fp32 - torch_acc) < 0.02

    rng = np.random.default_rng(0)
    calib = [xtr[i : i + 1] for i in rng.choice(len(xtr), 16, replace=False)]
    qg = quantize_graph(g, calib, scheme="uint8", algorithm="minmax", device="cpu")
    q1 = ae.top1_ours(qg, xte, yte, quantized=True, device="cpu")
    assert q1 >= fp32 - 0.03, (q1, fp32)


def test_accuracy_eval_publishes_what_the_jax_tool_prints(tmp_path, monkeypatch):
    """One epoch of digit_cnn through both tools: the port's row equals the
    JAX tool's within 2 test images on every top-1 (the same torch training;
    the quantizers' grids part by an ULP). --publish writes the published
    block to --out (the JAX tool writes BASELINE.json, the JAX package's
    record, and runs here without it); without sklearn the dataset loader
    says what is missing."""
    pytest.importorskip("sklearn")
    import json

    args = ["--epochs", "1", "--calib", "8", "--models", "digit_cnn"]
    torch.manual_seed(0)  # the models' initial weights come from torch's global generator
    jax_text = jax_tool("accuracy_eval", args)
    out = tmp_path / "published.json"
    torch.manual_seed(0)
    port_text, results = port_tool("accuracy_eval", args + ["--publish", "--out", str(out)])
    rows = [json.loads(text.splitlines()[0].split(":", 1)[1]) for text in (jax_text, port_text)]
    assert rows[0].keys() == rows[1].keys() and len(rows[0]) >= 12
    for key, want in rows[0].items():
        assert abs(rows[1][key] - want) <= 2 / 360 + 1e-4, (key, rows[1][key], want)
    assert rows[1]["ours_fp32_top1"] > 0.3  # trained: chance is 0.1
    published = json.loads(out.read_text())["published"]
    assert published["models"] == results and set(results) == {"digit_cnn"}

    from tengine_tpu_torch.tools import accuracy_eval as ae

    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(RuntimeError, match="scikit-learn"):
        ae.load_digits_32()


# the least arguments each CLI takes
CLI_ARGS = {name: [] for name in EXAMPLES} | {
    "tm_classification": ["-m", "x.tmfile"], "tm_detection": ["-m", "x.tmfile"],
    "tm_yolo": ["-m", "x.tmfile"]}
TOOLS = {"quant_tool": ["-m", "x.tmfile", "-o", "y.tmfile"], "align_tool": ["-m", "x.tmfile"],
         "benchmark": [], "accuracy_eval": []}


@pytest.mark.parametrize("module,args",
                         [(f"examples.{k}", v) for k, v in CLI_ARGS.items()]
                         + [(f"tools.{k}", v) for k, v in TOOLS.items()],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_every_cli_wants_the_card_without_a_device(module, args):
    """No --device: the CLI resolves the card (executor/engine.py:
    resolve_device) before it reads or builds anything, and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    mod = importlib.import_module(f"tengine_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)


def test_the_cli_modules_are_all_here():
    assert len(EXAMPLES) == 25 and set(EXAMPLES) == {
        p.stem for p in (REPO / "examples").glob("tm_*.py")}
    assert {"quant_tool", "align_tool", "benchmark", "accuracy_eval", "convert_tool"} == {
        p.stem for p in (REPO / "tengine_tpu_torch" / "tools").glob("*.py")} - {"__init__"}
