"""Graph executor: IR -> an eager torch forward on one device (PyTorch port
of tengine_tpu/executor/engine.py).

  * prepare pass — a walk of the graph on `meta` tensors (shapes only, no
    data). Op lowerings register host-computed compile-time params
    (repacked weights, folded requant scales) in the ParamStore; this is the
    analog of node_ops->prerun weight repacking (cpu_graph.c:143). Shapes
    inferred during this pass are written back into the IR
    (infer_ir_graph_shape analog, graph/graph.c:213).
  * run — the same forward on the engine's device, with the params as
    device tensors. Kernels are selected once per node at build time.

The engine runs on the card unless the caller asks for the CPU: with
device=None it takes torch.device("cuda") and raises if there is none.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph.ir import Graph, Tensor
from ..graph.passes import fold_shuffle_gathers, fuse_conv_add, fuse_resnet_blocks
from ..ops import fused as _fused  # noqa: F401 — populate registry
from ..ops import lowering as _lowering  # noqa: F401
from ..ops import qmath
from ..ops import quantized as _quantized  # noqa: F401
from ..ops.layout import TArr, as_semantic, nchw, nhwc
from ..ops.registry import LowerCtx, select_kernel
from ..utils.config import Options

META = torch.device("meta")


def resolve_device(device=None) -> torch.device:
    """The engine's device: the card unless the caller names another. No
    silent fallback: without a card, the default raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tengine_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        # calibration and the ref tier are fp32 end to end (the JAX engine
        # runs Precision.HIGHEST); cuDNN convs default to TF32 otherwise
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


class ParamStore:
    """Named compile-time parameters: numpy values computed on the host in
    the prepare pass, then held as tensors on the engine's device."""

    def __init__(self):
        self.phase = "prepare"
        self.values: Dict[str, np.ndarray] = {}
        self.tensors: Dict[str, torch.Tensor] = {}

    def get(self, key: str, compute: Callable[[], np.ndarray]) -> torch.Tensor:
        if self.phase == "prepare":
            if key not in self.values:
                self.values[key] = np.ascontiguousarray(compute())
            return torch.as_tensor(self.values[key], device=META)
        return self.tensors[key]

    def upload(self, device: torch.device) -> Dict[str, torch.Tensor]:
        # consts parsed from tmfile bytes are read-only views; torch wants
        # writable memory to wrap
        self.tensors = {
            k: torch.from_numpy(v if v.flags.writeable else v.copy()).to(device)
            for k, v in self.values.items()
        }
        self.phase = "run"
        return self.tensors


class ConstIn:
    """Lazy const-tensor input: materializes into the params only if a
    lowering actually reads it as data (conv weights, e.g., are consumed via
    ctx.weight() with a repacking transform instead)."""

    layout = None

    def __init__(self, tensor: Tensor, store: ParamStore):
        self._t = tensor
        self._store = store

    @property
    def x(self):
        t = self._t
        return self._store.get(f"t{t.idx}/raw", lambda: t.data)

    @property
    def shape(self):
        return tuple(self._t.shape)


class DequantConstIn(ConstIn):
    """Const input materialized pre-dequantized on the host — used when a
    float kernel consumes a quantized const under the generic fallback.
    Per-channel scales assume axis 0 (tmfile weight convention)."""

    @property
    def x(self):
        t = self._t
        return self._store.get(
            f"t{t.idx}/dequant",
            lambda: qmath.dequantize_np(t.data, t.quant, channel_axis=0).astype(np.float32),
        )


class CompiledGraph:
    """The runnable artifact: the forward, its device params, its device."""

    def __init__(
        self,
        graph: Graph,
        options: Options,
        fn: Callable,
        params: Dict[str, torch.Tensor],
        input_ids: List[int],
        output_ids: List[int],
        device: torch.device,
    ):
        self.graph = graph
        self.options = options
        self._fn = fn
        self.params = params
        self.input_ids = input_ids
        self.output_ids = output_ids
        self.device = device

    def __call__(self, *inputs) -> Tuple[torch.Tensor, ...]:
        """Run on device tensors (numpy arrays are copied over first); the
        outputs stay on the device."""
        xs = [
            x.to(self.device) if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.ascontiguousarray(x)).to(self.device)
            for x in inputs
        ]
        with torch.inference_mode():
            return self._fn(self.params, *xs)

    @property
    def forward_fn(self) -> Callable:
        """fn(params, *inputs) -> outputs."""
        return self._fn

    @property
    def kernels(self) -> Dict[str, str]:
        """Node name -> name of the lowering selected for it."""
        return self._fn.kernels

    def run(self, *inputs) -> List[np.ndarray]:
        return [o.cpu().numpy() for o in self(*inputs)]


def _input_spec(graph: Graph, options: Options) -> List[Tuple[int, Tuple[int, ...], torch.dtype]]:
    spec = []
    for tid in graph.input_tensors:
        t = graph.tensors[tid]
        shape = list(t.shape)
        if not shape:
            raise ValueError(f"input tensor {t.name!r} has no shape; set one before compile")
        if options.batch_size:
            shape[0] = options.batch_size
        if options.input_layout == "NHWC" and len(shape) == 4:
            shape = [shape[0], shape[2], shape[3], shape[1]]
        # quantized graphs take quantized inputs, like the reference C API
        spec.append((tid, tuple(shape), qmath.TORCH_DTYPES[t.dtype]))
    return spec


def _meta_inputs(graph: Graph, options: Options) -> List[torch.Tensor]:
    return [torch.empty(s, dtype=dt, device=META) for _, s, dt in _input_spec(graph, options)]


def build_forward(graph: Graph, options: Options, store: ParamStore, return_all: bool = False):
    """The whole-graph forward fn(params, *inputs). Runs on meta tensors in
    the prepare pass and on device tensors after it. return_all=True returns
    every tensor (for shape inference / calibration)."""
    topo = graph.toposorted()
    input_ids = graph.input_tensors
    output_ids = graph.output_tensors
    quantized = _graph_quantized(graph)
    plan = []
    for node in topo:
        ctx = LowerCtx(graph=graph, node=node, options=options, store=store)
        kernel = select_kernel(node.op, ctx)
        plan.append((node, ctx, kernel, quantized and not kernel.quant_aware))

    def forward(params, *inputs):
        env: Dict[int, TArr] = {}
        for tid, arr in zip(input_ids, inputs):
            if options.input_layout == "NHWC" and arr.ndim == 4:
                env[tid] = nhwc(arr)
            else:
                env[tid] = nchw(arr)

        for node, ctx, kernel, wrap_quant in plan:
            args = []
            for tid in node.inputs:
                t = graph.tensors[tid]
                if tid in env:
                    a = env[tid]
                    if wrap_quant and qmath.is_quantized_tensor(t):
                        a = TArr(qmath.dequantize(a.x, t.quant), a.layout)
                    args.append(a)
                elif t.is_const:
                    if wrap_quant and qmath.is_quantized_tensor(t):
                        args.append(DequantConstIn(t, store))
                    else:
                        args.append(ConstIn(t, store))
                else:
                    raise RuntimeError(
                        f"tensor {t.name!r} consumed by {node.name!r} before production"
                    )
            out = kernel.fn(ctx, *args)
            outs = out if isinstance(out, tuple) else (out,)
            if wrap_quant:
                # re-quantize float results into the node's quantized output
                # tensors — the reference stores every activation quantized,
                # so per-node requantization is part of its numerics. The
                # scale's reciprocal multiplies, as in the JAX engine's
                # compiled forward (qmath.requantize)
                outs = tuple(
                    TArr(
                        qmath.requantize(
                            o.x, graph.tensors[tid].quant, graph.tensors[tid].dtype,
                            reciprocal=True,
                        ),
                        o.layout,
                    )
                    if qmath.is_quantized_tensor(graph.tensors[tid]) and o.x.is_floating_point()
                    else o
                    for tid, o in zip(node.outputs, outs)
                )
            if options.debug_nans:
                for o in outs:
                    if o.x.is_floating_point() and o.x.device != META and not torch.isfinite(o.x).all():
                        raise FloatingPointError(f"non-finite value produced by node {node.name!r}")
            for tid, o in zip(node.outputs, outs):
                env[tid] = o

        def finalize(tid):
            # quantized activations are stored in their integer dtype all
            # along, so the JAX engine's bf16 -> int boundary cast has no
            # counterpart here
            return as_semantic(env[tid]).contiguous()

        if return_all:
            return {tid: finalize(tid) for tid in env}
        return tuple(finalize(tid) for tid in output_ids)

    # which lowering each node took (kernel selection happens once, above)
    forward.kernels = {node.name: kernel.name for node, _, kernel, _ in plan}
    return forward, input_ids, output_ids


def _native_profitable(graph: Graph) -> bool:
    """Per-graph gate of the JAX engine's native-int8 plan, ported as-is so
    the port makes the same decision (it does not run the plan: compile_graph
    raises where the gate says yes). The statistic is the fraction of conv
    output elements produced by small-channel convs (min(c_in, c_out) < 64,
    stems with c_in <= 4 excluded); depthwise graphs never qualify. Needs
    shapes: returns False (never wrongly native) when shape inference is
    unavailable."""
    convs = [n for n in graph.nodes if n.op == "Convolution"]
    if any(n.params.get("group", 1) > 1 for n in convs):
        return False  # depthwise family
    if any(
        not graph.tensors[n.outputs[0]].shape
        or len(graph.tensors[n.outputs[0]].shape) < 4
        for n in convs
    ):
        try:  # one meta pass fills the IR shapes
            infer_shapes(graph)
        except Exception:  # the JAX gate's contract: cannot judge -> legacy
            return False
    small = tot = 0
    for n in convs:
        if len(n.inputs) < 2:
            continue
        tw = graph.tensors[n.inputs[1]]
        t_out = graph.tensors[n.outputs[0]]
        if not t_out.shape or len(t_out.shape) < 4:
            return False
        out_c, in_c = int(tw.shape[0]), int(tw.shape[1])
        if in_c <= 4:
            continue
        elts = 1
        for d in t_out.shape[1:]:
            elts *= int(d)
        tot += elts
        if min(in_c, out_c) < 64:
            small += elts
    return tot > 0 and small / tot < 0.2


def _graph_quantized(graph: Graph) -> bool:
    cached = getattr(graph, "_is_quantized", None)
    if cached is None:
        cached = any(qmath.is_quantized_tensor(t) for t in graph.tensors)
        graph._is_quantized = cached
    return cached


def compile_graph(
    graph: Graph, options: Optional[Options] = None, device=None
) -> CompiledGraph:
    """prerun_graph_multithread analog: passes, prepare, device params.

    The pass pipeline is the JAX engine's, in its order. Passes and kernels
    the port does not have yet raise NotImplementedError where the JAX
    engine would use them."""
    device = resolve_device(device)
    options = options or Options.from_env()
    fast_quant = (
        _graph_quantized(graph)
        and options.quant_mode in ("auto", "fast")
        and not options.force_ref_kernels
    )
    if options.stem_s2d and not options.force_ref_kernels:
        raise NotImplementedError("stem_s2d (tengine_tpu/graph/passes.py:stem_conv_s2d) is not ported yet")
    native_int8 = (
        fast_quant
        and options.quant_native != "off"
        and (options.quant_native == "on" or options.quant_relaxed)
        and os.environ.get("TT_NATIVE_INT", "1") not in ("0", "off")
        and (options.quant_native == "on" or _native_profitable(graph))
    )
    if native_int8:
        raise NotImplementedError(
            "native-int8 plan (tengine_tpu/graph/passes.py:to_native_int8) not ported yet"
        )
    if fast_quant and (
        options.fuse_resblock or (options.quant_relaxed and not native_int8)
    ):
        # whole bottleneck-block chains -> the qblock_chain kernel (runs
        # before fuse_conv_add, which would otherwise absorb the residual
        # Eltwise into the conv epilogue). quant_relaxed also enables the
        # pass, from chain_min_cmid up; fuse_resblock forces it at any width.
        graph = graph.clone()
        fuse_resnet_blocks(
            graph, min_cmid=0 if options.fuse_resblock else options.chain_min_cmid
        )
    if fast_quant and os.environ.get("TT_FOLD_SHUFFLE", "1") not in ("0", "off"):
        fold_shuffle_gathers(graph)  # a guard: raises where the JAX pass would fold
    if fast_quant:
        # residual eltwise-sums fold into the conv requant epilogue
        graph = graph.clone()
        geometry = "pallas" if (
            options.pallas_qconv and not options.quant_bf16_storage
        ) else "any"
        fuse_conv_add(graph, geometry=geometry, relaxed_relu=options.quant_relaxed)

    store = ParamStore()
    forward, input_ids, output_ids = build_forward(graph, options, store)

    # --- prepare pass: collect params, infer shapes ---
    with torch.inference_mode():
        outs = forward({}, *_meta_inputs(graph, options))
    for tid, o in zip(output_ids, outs):
        graph.tensors[tid].shape = list(o.shape)

    params = store.upload(device)
    return CompiledGraph(graph, options, forward, params, input_ids, output_ids, device)


def infer_shapes(graph: Graph, options: Optional[Options] = None) -> Graph:
    """Standalone shape inference via a meta pass — records every tensor's
    shape into the IR (infer_ir_graph_shape analog)."""
    options = options or Options.from_env()
    store = ParamStore()
    forward_all, _, _ = build_forward(graph, options, store, return_all=True)
    with torch.inference_mode():
        shapes = forward_all({}, *_meta_inputs(graph, options))
    for tid, arr in shapes.items():
        graph.tensors[tid].shape = list(arr.shape)
    return graph
