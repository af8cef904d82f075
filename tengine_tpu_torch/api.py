"""pytengine-compatible object API (PyTorch port of tengine_tpu/api.py).

Mirrors the reference Python binding's surface (pytengine/tengine/graph.py,
tensor.py) so reference users can switch with minimal edits:

    from tengine_tpu_torch.api import Graph
    graph = Graph(None, "tengine", "model.tmfile")
    t = graph.getInputTensor(0, 0)
    t.shape = [1, 3, 224, 224]
    graph.preRun()                       # prerun_graph (compile)
    t.buf = image                        # set_tensor_buffer
    graph.run(1)                         # run_graph (blocking)
    out = graph.getOutputTensor(0, 0).buf

Graph runs on the card unless it is given device="cpu", as compile_graph.

Also exposes register_custom_op — the analog of the reference's
custom_kernel_ops / register_custom_op extension point (c_api.h:183-309,
cpu_module.c:187-216): plug a torch lowering for a new or existing op name
into the scored kernel registry.
"""

from __future__ import annotations

import importlib.util
from typing import Callable, List, Optional, Sequence

import numpy as np

from .executor.engine import CompiledGraph, compile_graph
from .graph.ir import Graph as IRGraph
from .ops.registry import _REGISTRY, SCORE_BEST, register_op
from .serializer.tm2.reader import load_tmfile
from .utils.config import Options


def register_custom_op(
    op_name: str,
    lower_fn: Callable,
    score: int = SCORE_BEST,
    predicate: Optional[Callable] = None,
    quant: bool = False,
):
    """Register a lowering for `op_name` (new ops or overriding builtins).

    lower_fn(ctx, *inputs) receives the LowerCtx and TArr inputs and returns
    TArr output(s) — see ops/lowering.py for examples. Higher score wins
    selection (SCORE_* constants in ops/registry.py), mirroring the
    reference's score-based kernel dispatch (cpu_module.c:135-170). On a
    CUDA device the forward is captured into a CUDA graph, so a lowering
    must do device work only: a host sync (.item()) or an upload of host
    data makes the call raise (compile-time values go through
    ctx.get_param).

    Returns an unregister callable (remove_custom_kernel analog,
    cpu_module.c:187-216) — call it to drop the kernel again.
    """
    register_op(op_name, score=score, predicate=predicate, quant=quant)(lower_fn)

    def unregister():
        kernels = _REGISTRY.get(op_name, [])
        _REGISTRY[op_name] = [k for k in kernels if k.fn is not lower_fn]

    return unregister


_LOADED_PLUGINS = {}


def load_tengine_plugin(plugin_name: str, fname: str, init_func_name: str = "init"):
    """Load an out-of-tree extension module — load_tengine_plugin analog
    (api/plugin.c:25-120). The reference dlopens a .so and calls its init;
    here the plugin is a Python file whose init() registers ops via
    register_custom_op. Idempotent per plugin_name; returns 0 on success
    like the C API."""
    if plugin_name in _LOADED_PLUGINS:
        return 0
    spec = importlib.util.spec_from_file_location(f"tt_plugin_{plugin_name}", fname)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    init = getattr(mod, init_func_name, None)
    if init is None:
        raise AttributeError(f"plugin {fname!r} has no {init_func_name}()")
    init()
    _LOADED_PLUGINS[plugin_name] = mod
    return 0


class Tensor:
    """Tensor handle bound to a Graph (pytengine Tensor parity)."""

    def __init__(self, graph: "Graph", tensor_idx: int):
        self._graph = graph
        self._idx = tensor_idx

    @property
    def _ir(self):
        return self._graph.ir.tensors[self._idx]

    @property
    def name(self) -> str:
        return self._ir.name

    @property
    def shape(self) -> List[int]:
        """An output's shape is that of its last run's value: compile_graph
        may rewrite a clone of the graph (the quantized passes), whose
        inferred shapes this graph's IR never sees, so after a batch change
        the IR's would be stale."""
        out = self._graph._outputs_cache.get(self._idx)
        return list(out.shape) if out is not None else list(self._ir.shape)

    @shape.setter
    def shape(self, dims: Sequence[int]):
        self._ir.shape = [int(d) for d in dims]
        self._graph._compiled = None  # shape change invalidates the build

    @property
    def dtype(self):
        return self._ir.dtype

    @property
    def quant_param(self):
        """get_tensor_quant_param analog (c_api.h:924-936)."""
        q = self._ir.quant
        if q is None:
            return None
        return (
            np.asarray(q.scales).reshape(-1).tolist(),
            np.asarray(q.zero_points).reshape(-1).tolist(),
        )

    @property
    def buf(self) -> Optional[np.ndarray]:
        if self._idx in self._graph._outputs_cache:
            return self._graph._outputs_cache[self._idx]
        return self._graph._inputs_cache.get(self._idx)

    @buf.setter
    def buf(self, value):
        self._graph._inputs_cache[self._idx] = np.asarray(value)


class Graph:
    """Graph handle (pytengine Graph parity over the engine)."""

    def __init__(self, context=None, model_format: str = "tengine", path: Optional[str] = None,
                 options: Optional[Options] = None, ir: Optional[IRGraph] = None, device=None):
        if ir is not None:
            self.ir = ir
        else:
            if model_format != "tengine":
                raise ValueError(f"unsupported format {model_format!r}")
            self.ir = load_tmfile(path)
        self.options = options or Options.from_env()
        self.device = device
        self._compiled: Optional[CompiledGraph] = None
        self._inputs_cache = {}
        self._outputs_cache = {}

    # -- tensor access (get_graph_input_tensor / get_graph_output_tensor) --

    def getInputTensor(self, node_idx: int, tensor_idx: int) -> Tensor:
        node = self.ir.nodes[self.ir.inputs[node_idx]]
        return Tensor(self, node.outputs[tensor_idx])

    def getOutputTensor(self, node_idx: int, tensor_idx: int) -> Tensor:
        node = self.ir.nodes[self.ir.outputs[node_idx]]
        return Tensor(self, node.outputs[tensor_idx])

    @property
    def input_num(self) -> int:
        return len(self.ir.inputs)

    @property
    def output_num(self) -> int:
        return len(self.ir.outputs)

    # -- lifecycle (prerun_graph / run_graph / postrun_graph) --

    def preRun(self, options: Optional[Options] = None):
        if options is not None:
            self.options = options
        self._compiled = compile_graph(self.ir, self.options, device=self.device)
        return 0

    def run(self, block: int = 1):
        if self._compiled is None:
            self.preRun()
        inputs = [self._inputs_cache[tid] for tid in self._compiled.input_ids]
        outs = self._compiled.run(*inputs)
        self._outputs_cache = dict(zip(self._compiled.output_ids, outs))
        return 0

    def wait(self):
        return 0  # run() is synchronous, like the reference's sync scheduler

    def postRun(self):
        self._compiled = None
        self._outputs_cache = {}
        return 0

    def dump(self) -> str:
        """dump_graph analog (c_api.h:1246)."""
        return self.ir.dump()
