"""Benchmark model zoo: the reference's tm_benchmark net list
(Tengine's `benchmark/tm_benchmark.cc:246-290`) with its input shapes
(benchmark_graph(name, file, height, width, channel, batch)). These are
weight-stripped tmfiles; the importer zero- or random-fills the weights
(tm2_serializer.c:241-246 behavior).

PyTorch port: a copy of tengine_tpu/models/zoo.py on the port's reader.
The default model directory is the benchmark tmfiles' place in a Tengine
checkout, relative to the working directory; pass model_dir for another."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..graph.ir import Graph
from ..serializer.tm2.reader import load_tmfile

DEFAULT_MODEL_DIR = os.path.join("benchmark", "models")

# name -> (file, (n, c, h, w))  [tm_benchmark.cc:246-290]
BENCHMARK_MODELS: Dict[str, Tuple[str, Tuple[int, int, int, int]]] = {
    "squeezenet_v1.1": ("squeezenet_v1.1_benchmark.tmfile", (1, 3, 227, 227)),
    "mobilenetv1": ("mobilenet_benchmark.tmfile", (1, 3, 224, 224)),
    "mobilenetv2": ("mobilenet_v2_benchmark.tmfile", (1, 3, 224, 224)),
    "mobilenetv3": ("mobilenet_v3_benchmark.tmfile", (1, 3, 224, 224)),
    "shufflenetv2": ("shufflenet_v2_benchmark.tmfile", (1, 3, 224, 224)),
    "resnet18": ("resnet18_benchmark.tmfile", (1, 3, 224, 224)),
    "resnet50": ("resnet50_benchmark.tmfile", (1, 3, 224, 224)),
    "googlenet": ("googlenet_benchmark.tmfile", (1, 3, 224, 224)),
    "inceptionv3": ("inception_v3_benchmark.tmfile", (1, 3, 395, 395)),
    "vgg16": ("vgg16_benchmark.tmfile", (1, 3, 224, 224)),
    "mssd": ("mssd_benchmark.tmfile", (1, 3, 300, 300)),
    "retinaface": ("retinaface_benchmark.tmfile", (1, 3, 320, 240)),
    "yolov3_tiny": ("yolov3_tiny_benchmark.tmfile", (1, 3, 416, 416)),
    "mobilefacenets": ("mobilefacenets_benchmark.tmfile", (1, 3, 112, 112)),
}


def load_benchmark_model(
    name: str,
    model_dir: str = DEFAULT_MODEL_DIR,
    fill_missing_weights: str = "random",
    batch: Optional[int] = None,
) -> Graph:
    """Load a benchmark net and set its input shape like tm_benchmark does
    (set_tensor_shape, tm_benchmark.cc:89)."""
    fname, shape = BENCHMARK_MODELS[name]
    g = load_tmfile(os.path.join(model_dir, fname), fill_missing_weights=fill_missing_weights)
    shape = list(shape)
    if batch:
        shape[0] = batch
    for tid in g.input_tensors:
        if not g.tensors[tid].shape:
            g.tensors[tid].shape = list(shape)
    return g


def benchmark_model_names() -> List[str]:
    return list(BENCHMARK_MODELS)
