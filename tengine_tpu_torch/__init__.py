"""tengine_tpu_torch: the PyTorch/CUDA port of tengine_tpu, for NVIDIA Hopper.

The same IR, passes, options and quantized numerics as the JAX package
(tengine_tpu, the reference it is tested against), run with torch on one
device: on a CUDA card as one captured CUDA graph per input signature (the
counterpart of jax.jit), on the CPU eagerly; the TPU's Pallas kernels become
hand-written CUDA kernels (ops/cuda/, csrc/). Entry points run on the card
unless the caller asks for the CPU with device="cpu":

    import tengine_tpu_torch as tt
    g = tt.load_model("model.tmfile")
    session = tt.compile_graph(g)          # CUDA; raises without a card
    outputs = session.run(input_array)
"""

from .graph.ir import DType, Graph, Layout, Node, QuantParam, Tensor, TensorType
from .serializer.tm2.reader import load_tm_bytes, load_tmfile
from .serializer.tm2.writer import graph_to_tm_bytes, save_tmfile
from .executor.engine import CompiledGraph, compile_graph, infer_shapes
from .quantize.quantizer import quantize_graph
from .utils.config import Options
from .utils.log import set_log_level, set_log_output
from .api import register_custom_op

__version__ = "0.1.0"


def load_model(path: str, format: str = "tengine", **kwargs) -> Graph:
    """create_graph analog (c_api.c:368): load a model file into IR."""
    if format != "tengine":
        raise ValueError(f"unknown model format {format!r} (supported: 'tengine')")
    return load_tmfile(path, **kwargs)
