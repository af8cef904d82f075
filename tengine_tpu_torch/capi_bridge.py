"""Python side of the C ABI shim (native/c_api_shim.c; PyTorch port of
tengine_tpu/capi_bridge.py).

Tengine's embedders drive graphs from C through c_api.h. The port's engine
is Python and torch, so the C ABI is a thin libtengine_tpu_torch_capi.so
that embeds (or attaches to) CPython and forwards each call here. This module
keeps the handle tables and does all object management, so the C layer stays
a marshaller. The chain is: C call -> this bridge -> api.Graph ->
compile_graph -> the captured forward on the card.

Handles are small ints; tensors are addressed as (graph_handle, tensor_idx).
Buffers: set_tensor_buffer copies from the caller's memory into the input
tensor; get_tensor_buffer returns the address of an output array kept alive
(and stable) until the graph is destroyed, refreshed in place by every run —
the reference's lifetime contract (tensor buffers live until
postrun/destroy).

Devices. A graph runs on the card unless the CPU is asked for:
set_context_device(ctx, "CPU") makes the graphs created with that context
run on the CPU ("CUDA" on the card), set_default_device("CPU" | "CUDA")
sets the same choice for the process; a context's request comes first. Any
other device name returns -1 and changes nothing. With no request the
graph takes the engine's default (executor/engine.py:resolve_device): the
card, or, where there is none, a prerun_graph that prints why and returns
-1.

Reference: c_api.h:318 (init), :363 (create_graph), :1006-1046 (pre/run/
postrun), :777-851 (tensor accessors), :1078 and :1120-1186 (devices).
"""

from __future__ import annotations

import itertools
import sys
from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np

_graphs: Dict[int, object] = {}
_pinned: Dict[Tuple[int, int], np.ndarray] = {}  # stable output buffers
_next = itertools.count(1)

_DTYPE_CODE = {  # c_api.h:55-63 TENGINE_DT_*
    "float32": 0, "float16": 1, "int8": 2, "uint8": 3, "int32": 4, "int16": 5,
}
# the device names set_context_device and set_default_device take, and the
# engine's device each names
_DEVICES = {"CPU": "cpu", "CUDA": "cuda"}
_default_device: Optional[str] = None


def version() -> str:
    from . import __version__

    return __version__


def _add_graph(g, context: int) -> int:
    g._context = context
    h = next(_next)
    _graphs[h] = g
    return h


def create_graph(context: int, model_format: str, file_name: str) -> int:
    from .api import Graph

    return _add_graph(Graph(None, model_format, file_name), context)


def destroy_graph(h: int) -> int:
    g = _graphs.pop(h, None)
    for k in [k for k in _pinned if k[0] == h]:
        _pinned.pop(k, None)
    if g is not None:
        g._compiled = None  # its CUDA graphs go before the staging they recorded
        for n in g.ir.nodes:
            key = n.params.get("_custom_kernel")
            if key is not None:
                _release_custom_kernel(key)
    return 0


def _graph(h: int):
    g = _graphs.get(h)
    if g is None:
        raise KeyError(f"invalid graph handle {h}")
    return g


def _requested_device(g) -> Optional[str]:
    """The graph's device request: its context's, else the process's."""
    ctx = _contexts.get(getattr(g, "_context", 0))
    if ctx is not None and ctx["device"] is not None:
        return ctx["device"]
    return _default_device


def prerun_graph(h: int, num_thread: int = 0, precision: int = -1) -> int:
    from .executor.engine import resolve_device

    g = _graph(h)
    if getattr(g, "_constructed", False):
        finalize_constructed(h)
    g.device = _requested_device(g)
    try:
        resolve_device(g.device)
    except RuntimeError as e:  # no card, and no request for the CPU
        print(f"prerun_graph: {e}. From C, ask for the CPU with set_default_device(\"CPU\") "
              f"or set_context_device(ctx, \"CPU\")", file=sys.stderr, flush=True)
        return -1
    opts = None
    if precision == 1:  # TENGINE_MODE_FP16 (c_api.h precision constants)
        # keep the options already recorded on the graph (set_graph_layout
        # et al.): a fresh Options() would wipe them
        opts = replace(g.options, precision="fp16")
    g.preRun(opts)
    return 0


def _tensor(h: int, tidx: int):
    from .api import Tensor

    return Tensor(_graph(h), tidx)


def run_graph(h: int, block: int = 1) -> int:
    from .ops.cuda import host_node

    g = _graph(h)
    if g._compiled is None:  # never prepared, or a shape, buffer or kernel changed since
        rc = prerun_graph(h)
        if rc != 0:
            return rc
    g.run(block)
    for n in g.ir.nodes:  # a C custom kernel's run() reports on the card's host thread
        key = n.params.get("_custom_kernel")
        for st in host_node.staging(key) if key is not None else ():
            if st.node.rc != 0:
                print(f"run_graph: custom kernel {key} run() returned {st.node.rc}",
                      file=sys.stderr, flush=True)
                return -1
    # refresh the pinned output buffers in place where shapes match, so that
    # pointers handed out by get_tensor_buffer stay valid across runs
    for (gh, tidx), arr in list(_pinned.items()):
        if gh != h:
            continue
        new = _tensor(gh, tidx).buf
        if new is not None and new.shape == arr.shape and new.dtype == arr.dtype:
            arr[...] = new
        else:
            _pinned[(gh, tidx)] = np.ascontiguousarray(new)
    return 0


def postrun_graph(h: int) -> int:
    return 0  # buffers are released with the graph


def input_tensor_idx(h: int, node_idx: int, tensor_idx: int) -> int:
    return _graph(h).getInputTensor(node_idx, tensor_idx)._idx


def output_tensor_idx(h: int, node_idx: int, tensor_idx: int) -> int:
    return _graph(h).getOutputTensor(node_idx, tensor_idx)._idx


def tensor_idx_by_name(h: int, name: str) -> int:
    for t in _graph(h).ir.tensors:
        if t.name == name:
            return t.idx
    return -1


def input_count(h: int) -> int:
    return len(_graph(h).ir.inputs)


def output_count(h: int) -> int:
    return len(_graph(h).ir.outputs)


def tensor_shape(h: int, tidx: int) -> list:
    return [int(d) for d in _tensor(h, tidx).shape]


def set_tensor_shape(h: int, tidx: int, dims: list) -> int:
    _tensor(h, tidx).shape = list(dims)
    return 0


def tensor_dtype(h: int, tidx: int) -> int:
    t = _graph(h).ir.tensors[tidx]
    return _DTYPE_CODE.get(np.dtype(t.dtype.np).name, 0)


def tensor_buffer_size(h: int, tidx: int) -> int:
    t = _graph(h).ir.tensors[tidx]
    return int(np.prod(tensor_shape(h, tidx), dtype=np.int64)) * np.dtype(t.dtype.np).itemsize


def set_tensor_buffer(h: int, tidx: int, mem) -> int:
    from .graph.ir import TensorType

    t = _graph(h).ir.tensors[tidx]
    arr = np.frombuffer(mem, dtype=t.dtype.np).reshape(tensor_shape(h, tidx)).copy()
    if t.tensor_type == TensorType.CONST:
        # constructed-graph weight/bias upload (c_api.h:810 on a CONST
        # tensor): the data lives in the IR like a loaded tmfile's
        t.data = arr
        _graph(h)._compiled = None
        return 0
    _tensor(h, tidx).buf = arr
    return 0


def get_tensor_buffer(h: int, tidx: int) -> int:
    """Address of a stable, process-lifetime buffer holding the tensor's
    current data (0 if no data yet)."""
    key = (h, tidx)
    if key not in _pinned:
        buf = _tensor(h, tidx).buf
        if buf is None:
            return 0
        _pinned[key] = np.ascontiguousarray(buf)
    return int(_pinned[key].ctypes.data)


def set_log_level(level: int) -> int:
    import logging

    from .utils.log import logger

    # UNIX syslog levels (c_api.h:104-114) -> python logging
    table = {0: logging.CRITICAL, 1: logging.CRITICAL, 2: logging.CRITICAL,
             3: logging.ERROR, 4: logging.WARNING, 5: logging.INFO,
             6: logging.INFO, 7: logging.DEBUG}
    logger.setLevel(table.get(level, logging.INFO))
    return 0


def dump_graph(h: int) -> int:
    print(_graph(h).dump())
    return 0


# ---- load from memory, quant params (c_api.c:400-421, c_api.h:918-936) ----


def create_graph_mem(context: int, model_format: str, data: bytes) -> int:
    """create_graph(ctx, "tengine:m", addr, size): load a tmfile image
    straight from caller memory (c_api.c:400-421; tm2 load_mem)."""
    from .api import Graph
    from .serializer.tm2.reader import load_tm_bytes

    if model_format.split(":")[0] not in ("tengine", ""):
        raise ValueError(f"unsupported in-memory format {model_format!r}")
    return _add_graph(Graph(None, ir=load_tm_bytes(bytes(data), name="<memory>")), context)


def get_tensor_quant_param(h: int, tidx: int, number: int):
    """get_tensor_quant_param (c_api.h:933-936)."""
    q = _graph(h).ir.tensors[tidx].quant
    if q is None:
        return [], []
    s = np.asarray(q.scales, np.float64).reshape(-1)[:number]
    z = np.asarray(q.zero_points, np.int64).reshape(-1)[:number]
    n = max(s.size, z.size)
    s = np.resize(s, n) if s.size else np.zeros(n)
    z = np.resize(z, n) if z.size else np.zeros(n, np.int64)
    return [float(v) for v in s], [int(v) for v in z]


def set_tensor_quant_param(h: int, tidx: int, scales, zero_points) -> int:
    """set_tensor_quant_param (c_api.h:918-924)."""
    from .graph.ir import QuantParam

    g = _graph(h)
    s = np.asarray(scales, np.float32)
    z = np.asarray(zero_points, np.int32)
    if len(scales) == 1:  # per-tensor: scalar shape, like the tmfile loader
        s, z = s.reshape(()), z.reshape(())
    g.ir.tensors[tidx].quant = QuantParam(scales=s, zero_points=z)
    g._compiled = None  # a quant change invalidates the build
    g.ir._is_quantized = None
    return 0


# ---- node accessors (c_api.h:487-602) ----


def node_num(h: int) -> int:
    return len(_graph(h).ir.nodes)


def node_check(h: int, idx: int) -> int:
    return idx if 0 <= idx < len(_graph(h).ir.nodes) else -1


def node_idx_by_name(h: int, name: str) -> int:
    for n in _graph(h).ir.nodes:
        if n.name == name:
            return n.idx
    return -1


def node_name(h: int, nidx: int) -> str:
    return _graph(h).ir.nodes[nidx].name


def node_op(h: int, nidx: int) -> str:
    return _graph(h).ir.nodes[nidx].op


def node_input_count(h: int, nidx: int) -> int:
    return len(_graph(h).ir.nodes[nidx].inputs)


def node_output_count(h: int, nidx: int) -> int:
    return len(_graph(h).ir.nodes[nidx].outputs)


def node_input_tensor_idx(h: int, nidx: int, i: int) -> int:
    ins = _graph(h).ir.nodes[nidx].inputs
    return ins[i] if 0 <= i < len(ins) else -1


def node_output_tensor_idx(h: int, nidx: int, i: int) -> int:
    outs = _graph(h).ir.nodes[nidx].outputs
    return outs[i] if 0 <= i < len(outs) else -1


# ---- graph construction from C (c_api.h:477-520, 560-602, 766) ----
#
# The reference's own op unit tests build graphs through the public C API
# (tests/op/test_onnx_op.h): create an empty graph, add InputOp / Const / op
# nodes, wire tensors, set shapes, buffers and attrs, then prerun and run.
# Const nodes exist only during construction: their output tensors become
# data-carrying CONST tensors and the node drops at finalize, the engine's
# const-tensor model.

_contexts: Dict[int, dict] = {}

_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}


def _dtype_from_code(code: int):
    """TENGINE_DT_* code -> DType, through the one _DTYPE_CODE table."""
    from .graph.ir import DType

    name = _CODE_DTYPE.get(code, "float32")
    return next(d for d in DType if np.dtype(d.np).name == name)


def create_graph_empty(context: int) -> int:
    """create_graph(ctx, NULL, NULL): an empty graph for construction from C."""
    from .api import Graph
    from .graph.ir import Graph as IRGraph

    g = Graph(ir=IRGraph(name="c_constructed"))
    g._constructed = True
    return _add_graph(g, context)


def create_graph_node(h: int, name: str, op: str) -> int:
    return _graph(h).ir.add_node(op, name, [], [], params={}).idx


def create_graph_tensor(h: int, name: str, dtype_code: int) -> int:
    from .graph.ir import TensorType

    return _graph(h).ir.add_tensor(name, _dtype_from_code(dtype_code), [], TensorType.VAR).idx


def set_node_input_tensor(h: int, nidx: int, input_idx: int, tidx: int) -> int:
    g = _graph(h)
    n = g.ir.nodes[nidx]
    while len(n.inputs) <= input_idx:
        n.inputs.append(-1)
    n.inputs[input_idx] = tidx
    t = g.ir.tensors[tidx]
    if nidx not in t.consumers:
        t.consumers.append(nidx)
    return 0


def set_node_output_tensor(h: int, nidx: int, output_idx: int, tidx: int,
                           tensor_type: int) -> int:
    from .graph.ir import TensorType

    g = _graph(h)
    n = g.ir.nodes[nidx]
    while len(n.outputs) <= output_idx:
        n.outputs.append(-1)
    n.outputs[output_idx] = tidx
    t = g.ir.tensors[tidx]
    t.producer = nidx
    t.tensor_type = TensorType(tensor_type)
    return 0


def set_node_attr(h: int, nidx: int, name: str, value, is_int: int) -> int:
    """set_node_attr_int/float (c_api.h:686-700): op params by name."""
    _graph(h).ir.nodes[nidx].params[name] = int(value) if is_int else float(value)
    return 0


def get_node_attr(h: int, nidx: int, name: str):
    return _graph(h).ir.nodes[nidx].params.get(name)


def set_graph_io_nodes(h: int, input_names, output_names) -> int:
    """set_graph_input_node / set_graph_output_node (c_api.h:385-396)."""
    g = _graph(h)
    for names, attr in ((input_names, "inputs"), (output_names, "outputs")):
        if names:
            idxs = [node_idx_by_name(h, s) for s in names]
            if any(i < 0 for i in idxs):
                return -1
            setattr(g.ir, attr, idxs)
    return 0


def finalize_constructed(h: int) -> int:
    """Normalisation of a graph constructed from C, before it compiles
    (called from prerun): Const nodes drop (their tensors carry the data),
    the graph's inputs default to its InputOp nodes and its outputs to the
    nodes with an output no node consumes."""
    ir = _graph(h).ir
    for n in ir.nodes:
        if n.op != "Noop" and (-1 in n.inputs or -1 in n.outputs):
            # the reference C API errors on unset node slots; a -1 left by
            # out-of-order set_node_input_tensor would index the tensor table
            # from its end and wire the wrong operand
            raise ValueError(f"node {n.name!r} has unset input/output slots")
    for n in ir.nodes:
        if n.op == "Const":
            for tid in n.outputs:
                ir.tensors[tid].producer = None
            n.op = "Noop"
            n.inputs = []
            n.outputs = []
    if not ir.inputs:
        ir.inputs = [n.idx for n in ir.nodes if n.op == "InputOp"]
    if not ir.outputs:
        ir.outputs = [n.idx for n in ir.nodes if n.op not in ("Noop", "InputOp", "Const")
                      and any(not ir.tensors[t].consumers for t in n.outputs)]
    return 0


def wait_graph(h: int, try_wait: int = 1) -> int:
    """wait_graph (c_api.h:1038): run() is synchronous (the reference's sync
    scheduler cannot run non-blocking either, scheduler.c:76-79)."""
    _graph(h)
    return 0


# ---- contexts and devices (c_api.h:1078, 1120-1186) ----


def create_context(name: str, empty: int) -> int:
    """create_context (c_api.h:1120): lists the card unless empty. The
    context asks for no device until set_context_device does."""
    h = next(_next)
    _contexts[h] = {"name": name or "", "devices": [] if empty else ["CUDA"], "device": None}
    return h


def destroy_context(h: int) -> int:
    _contexts.pop(h, None)
    return 0


def set_context_device(h: int, dev_name: str) -> int:
    """set_context_device (c_api.h:1160): "CPU" or "CUDA" for every graph
    of the context; -1 for any other name, or an unknown context."""
    c = _contexts.get(h)
    if c is None or dev_name not in _DEVICES:
        return -1
    if dev_name not in c["devices"]:
        c["devices"].append(dev_name)
    c["device"] = _DEVICES[dev_name]
    return 0


def get_context_device_number(h: int) -> int:
    c = _contexts.get(h)
    return len(c["devices"]) if c else 0


def set_default_device(dev_name: str) -> int:
    """set_default_device (c_api.h:1078): "CPU" or "CUDA" for the graphs of
    the process whose context asks for none; -1 for any other name."""
    global _default_device
    if dev_name not in _DEVICES:
        return -1
    _default_device = _DEVICES[dev_name]
    return 0


# ---- C custom kernels (c_api.h:183-309, set_custom_kernel :742) ----
#
# The embedder hands over a struct custom_kernel_ops*. A lowering registered
# for the node's op, scoped to the node by a params marker that survives
# graph clones, runs its run(): on the CPU called directly over the
# tensors' memory, on the card as a host node of the captured forward
# (ops/cuda/host_node.py, csrc/host_node.cu) — the counterpart of the
# reference's custom CPU node (cpu_module.c:187-216).

_custom_kernels: Dict[str, int] = {}  # marker key -> ops struct address
_out_shapes: Dict[tuple, tuple] = {}  # (key, input shapes) -> infer_shape's answer


def _lower_custom_kernel(ctx, *args):
    """Lowering of a node that carries a _custom_kernel marker: the
    embedder's C run() over its NCHW inputs. infer_shape runs once for each
    input shape, in the prepare pass (meta tensors)."""
    from .ops import qmath
    from .ops.cuda.host_node import custom_kernel, infer_out_shape
    from .ops.layout import as_nchw, nchw

    key = ctx.node.params["_custom_kernel"]
    addr = _custom_kernels[key]
    xs = [as_nchw(a) for a in args]
    shapes = (key, tuple(tuple(int(d) for d in x.shape) for x in xs))
    if shapes not in _out_shapes:
        _out_shapes[shapes] = infer_out_shape(addr, shapes[1])
    out_dtype = qmath.TORCH_DTYPES[ctx.out_tensor(0).dtype]
    return nchw(custom_kernel(key, addr, xs, _out_shapes[shapes], out_dtype))


_CK_REGISTERED = set()


def set_custom_kernel(h: int, nidx: int, dev_name: str, ops_addr: int) -> int:
    from .ops.registry import SCORE_STATIC, register_op

    g = _graph(h)
    node = g.ir.nodes[nidx]
    key = f"ck/{h}/{nidx}/{dev_name}"
    node.params["_custom_kernel"] = key
    _custom_kernels[key] = int(ops_addr)
    if node.op not in _CK_REGISTERED:
        _CK_REGISTERED.add(node.op)
        register_op(
            node.op,
            score=SCORE_STATIC + 100,  # "force": outranks every builtin tier
            predicate=lambda c: c.node.params.get("_custom_kernel") in _custom_kernels,
        )(_lower_custom_kernel)
    g._compiled = None
    return 0


def _release_custom_kernel(key: str) -> None:
    from .ops.cuda import host_node

    _custom_kernels.pop(key, None)
    for k in [k for k in _out_shapes if k[0] == key]:
        del _out_shapes[k]
    host_node.release(key)


def remove_custom_kernel(h: int, nidx: int, dev_name: str) -> int:
    g = _graph(h)
    key = g.ir.nodes[nidx].params.pop("_custom_kernel", None)
    g._compiled = None  # its CUDA graphs go before the staging they recorded
    if key is not None:
        _release_custom_kernel(key)
    return 0


# ---- plugins and layout from C (c_api.h:374, 1259-1270) ----


def load_plugin(plugin_name: str, file_name: str, init_func: str) -> int:
    """load_tengine_plugin from C (c_api.h:1259): the reference dlopens a
    .so; the port's plugins are Python modules whose init() registers ops,
    the same extension contract at the engine's own layer."""
    from .api import load_tengine_plugin

    try:
        return int(load_tengine_plugin(plugin_name, file_name, init_func or "init"))
    except Exception:
        return -1


def unload_plugin(plugin_name: str, rel_func: str) -> int:
    from . import api

    mod = api._LOADED_PLUGINS.get(plugin_name)
    if mod is None:
        return -1
    rel = getattr(mod, rel_func or "release", None)
    if rel is not None:
        try:
            rel()
        except Exception:
            return -1  # release failed: the plugin stays loaded (retryable)
    api._LOADED_PLUGINS.pop(plugin_name, None)
    return 0


def set_graph_layout(h: int, layout_type: int) -> int:
    """set_graph_layout (c_api.h:374): 0 = NCHW (the IR's default), 1 = NHWC
    (the engine's input-layout option for this graph)."""
    g = _graph(h)
    g.options = replace(g.options, input_layout="NHWC" if layout_type == 1 else "NCHW")
    g._compiled = None
    return 0
