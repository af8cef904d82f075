"""The example CLIs of the port (tengine_tpu_torch/examples/) against the JAX
package's (examples/), on the CPU at small sizes: the same arguments, the
JAX example's main() in-process (sys.argv patched, stdout captured) beside
the port's main([..., "--device", "cpu"]). With the timing dropped, the
printed lines agree: the same count, the same words, each number within one
unit of its last printed digit. The examples that read a tmfile (-m) read
one the JAX writer wrote from chip_smoke.py's builders (or the darknet
zoo's yolov4-tiny for tm_yolo): that is how the weights cross between the
packages. This file: the eight _runner examples and the four -m examples;
tests/test_torch_examples2.py the other thirteen and the quantized cases."""

import contextlib
import importlib
import importlib.util
import io
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

REPO = Path(__file__).resolve().parents[1]
JAX_EXAMPLES = REPO / "examples"

# the JAX examples import their neighbours by bare name (_runner, tm_yolo), as
# when run as a script
if str(JAX_EXAMPLES) not in sys.path:
    sys.path.insert(0, str(JAX_EXAMPLES))

import chip_smoke  # noqa: E402


def jax_example(name, args, record=None):
    """Run examples/<name>.py's main() with sys.argv = [path] + args; returns
    what it printed. With `record` (a list), every CompiledGraph.run of the
    JAX engine appends its outputs to it."""
    from tengine_tpu.executor import engine as jax_engine

    path = JAX_EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    run = jax_engine.CompiledGraph.run

    def recording_run(self, *inputs):
        outs = run(self, *inputs)
        record.append([np.asarray(o) for o in outs])
        return outs

    buf, argv = io.StringIO(), sys.argv
    sys.argv = [str(path)] + list(args)
    try:
        if record is not None:
            jax_engine.CompiledGraph.run = recording_run
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = argv
        jax_engine.CompiledGraph.run = run
    return buf.getvalue()


def port_example(name, args):
    """The port's tengine_tpu_torch.examples.<name>.main(args + --device
    cpu): (what it printed, what it returned)."""
    mod = importlib.import_module(f"tengine_tpu_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = mod.main(list(args) + ["--device", "cpu"])
    return buf.getvalue(), result


def assert_same_printout(jax_text, port_text, any_order=False):
    """The timing dropped: the same number of lines, the same words, each
    number within one unit of its last printed digit
    (chip_smoke.printout_mismatch)."""
    differs = chip_smoke.printout_mismatch(jax_text, port_text, any_order)
    assert differs is None, differs


def compare(name, args, any_order=False):
    port_text, result = port_example(name, args)
    assert_same_printout(jax_example(name, args), port_text, any_order)
    return result


# --- tmfiles written by the JAX writer from chip_smoke.py's builders --------

MOBILENET_SMALL = dict(img=32, classes=16,
                       widths=(32, 32, 64, 64, 64, 64, 96, 96, 96, 96, 96, 96, 128, 128))
SSD_SMALL = dict(img=64, widths=MOBILENET_SMALL["widths"],
                 extras=((128, 64), (128, 64), (32, 64), (32, 32)), conf_gain=16.0)
RETINAFACE_SMALL = dict(h=64, w=48, widths=(8, 16, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32, 64, 64),
                        fpn=32)
# the face pipeline crops faces to 112x112: the embedder keeps its input size
MOBILEFACENET_SMALL = dict(img=112, stem=32, bottlenecks=((2, 32, 2, 2), (2, 64, 1, 2),
                                                          (2, 64, 2, 1), (2, 64, 1, 2),
                                                          (2, 64, 1, 1)),
                           conv5=128, embedding=32)


def write_tmfile(path, graph):
    from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes

    path.write_bytes(graph_to_tm_bytes(graph))
    return str(path)


@pytest.fixture(scope="module")
def tmfiles(tmp_path_factory):
    from tengine_tpu.graph import ir as jir
    from tengine_tpu.models.darknet_zoo import build_yolov4_tiny_graph

    d = tmp_path_factory.mktemp("tmfiles")
    return {
        "mobilenet": write_tmfile(d / "mobilenet.tmfile",
                                  chip_smoke.build_mobilenet_v1_graph(jir, **MOBILENET_SMALL)),
        "ssd": write_tmfile(d / "ssd.tmfile", chip_smoke.build_mobilenet_ssd_graph(jir, **SSD_SMALL)),
        "retinaface": write_tmfile(d / "retinaface.tmfile",
                                   chip_smoke.build_retinaface_mnet_graph(jir, **RETINAFACE_SMALL)),
        "mobilefacenet": write_tmfile(d / "mobilefacenet.tmfile",
                                      chip_smoke.build_mobilefacenet_graph(jir, **MOBILEFACENET_SMALL)),
        "yolov4_tiny": write_tmfile(d / "yolov4_tiny.tmfile", build_yolov4_tiny_graph(img=416)),
    }


# the eight examples on _runner, at small sizes
RUNNER_CASES = {
    "tm_efficientdet": ["-s", "64"],
    "tm_hrnet": ["-s", "64"],
    "tm_landmark": ["-s", "64"],
    "tm_nanodet_plus": ["-s", "64"],
    "tm_openpose": ["-s", "64"],
    "tm_picodet": ["-s", "64"],
    "tm_yolact": ["-s", "64"],
    "tm_yolofastest": ["-s", "64"],
}


@pytest.mark.parametrize("name", sorted(RUNNER_CASES))
def test_runner_example_prints_what_jax_prints(name):
    result = compare(name, RUNNER_CASES[name])
    assert result["graph"] is not None and all(np.isfinite(o).all() for o in result["outs"])


def test_classification_reads_the_jax_writers_tmfile(tmfiles):
    result = compare("tm_classification", ["-m", tmfiles["mobilenet"], "-g", "32,32"])
    assert len(result["top5"]) == 5 and result["outs"][0].shape == (16,)


def test_detection_reads_the_jax_writers_tmfile(tmfiles):
    # the narrow SSD's conf gain 16 gives it detections over 0.5
    result = compare("tm_detection", ["-m", tmfiles["ssd"], "-g", "64,64", "-r", "2"])
    assert len(result["dets"]) > 0 and len(result["ms"]) == 2


def test_yolo_reads_the_jax_writers_tmfile(tmfiles):
    # the seeded net's scores come in near-equal pairs (e.g. two boxes of one
    # row at 48.5%) that the two fp32 engines order differently
    result = compare("tm_yolo", ["-m", tmfiles["yolov4_tiny"], "-s", "416"], any_order=True)
    assert [o.shape for o in result["outs"]] == [(1, 255, 13, 13), (1, 255, 26, 26)]
    assert len(result["dets"]) > 0


def test_face_pipeline_reads_the_jax_writers_tmfiles(tmfiles):
    result = compare("tm_face_pipeline", ["--detector", tmfiles["retinaface"],
                                          "--embedder", tmfiles["mobilefacenet"]])
    assert result["embeddings"].shape == (len(result["faces"]), 32)


def test_face_pipeline_defaults_name_the_zoo_directory():
    """The detector and embedder default to the benchmark zoo's tmfiles under
    benchmark/models relative to the working directory (the JAX example
    names an absolute path of its own checkout)."""
    from tengine_tpu_torch.examples import tm_face_pipeline

    with pytest.raises(FileNotFoundError, match=r"benchmark/models/retinaface_benchmark\.tmfile"):
        tm_face_pipeline.main(["--device", "cpu"])


def test_an_image_file_is_read(tmp_path):
    """-i: a PNG written with PIL goes through both examples' loaders."""
    Image = pytest.importorskip("PIL.Image")
    rgb = np.random.default_rng(3).integers(0, 255, (80, 96, 3)).astype(np.uint8)
    path = tmp_path / "frame.png"
    Image.fromarray(rgb).save(path)
    result = compare("tm_yolofastest", ["-s", "64", "-i", str(path)])
    assert result["outs"][0].shape[0] == 1


def test_detection_without_pil_names_it(tmp_path, monkeypatch):
    """Without PIL, -i raises SystemExit naming PIL (the JAX example calls a
    native.decode_resize that neither package defines; ROADMAP §3)."""
    from tengine_tpu_torch.examples import tm_detection

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="PIL"):
        tm_detection.load_image(str(tmp_path / "x.jpg"), 8, 8)
    import tengine_tpu_torch.native as native

    assert not hasattr(native, "decode_resize")
