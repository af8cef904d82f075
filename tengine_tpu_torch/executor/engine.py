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
  * compiled forward — on a CUDA device, CompiledGraph.__call__ captures the
    forward into a CUDA graph at the first call of each input signature and
    replays it after (the counterpart of the JAX engine's jax.jit): one
    launch of the whole graph a call instead of one Python call and launch
    per torch op. The forward therefore does only device work: every host
    value it needs (weights, folded scales, index and divisor tables,
    priors) is a compile-time param uploaded once. An input of another
    image size gets its own prepare pass and params (the JAX engine
    retraces).

The engine runs on the card unless the caller asks for the CPU: with
device=None it takes torch.device("cuda") and raises if there is none.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graph.ir import Graph, Tensor
from ..graph.passes import (
    fold_shuffle_gathers, fuse_conv_add, fuse_resnet_blocks, stem_conv_s2d, to_native_int8,
)
from ..ops import detection as _detection  # noqa: F401 — populate registry
from ..ops import fused as _fused  # noqa: F401
from ..ops import lowering as _lowering  # noqa: F401
from ..ops import lowering_extra as _lowering_extra  # noqa: F401
from ..ops import qmath
from ..ops import quantized as _quantized  # noqa: F401
from ..ops.layout import TArr, as_semantic, nchw, nhwc
from ..ops.registry import LowerCtx, select_kernel
from ..utils import trace
from ..utils.config import Options

META = torch.device("meta")

# At most one CUDA-graph capture is underway in the process at a time
# (CompiledGraph._capture says why).
_CAPTURE_LOCK = threading.Lock()


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
        if device.index is None:  # "cuda" names the current card: tensors say cuda:N
            device = torch.device("cuda", torch.cuda.current_device())
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

    def upload(self, device: torch.device,
               share: Optional["ParamStore"] = None) -> Dict[str, torch.Tensor]:
        """The values as device tensors. A value equal to `share`'s under
        the same key (a weight, where both stores prepared one graph at two
        input sizes) takes share's device tensor instead of a second copy."""
        def same(k, v):
            o = share.values.get(k) if share is not None else None
            return (o is not None and o.dtype == v.dtype and o.shape == v.shape
                    and np.array_equal(o, v))

        # consts parsed from tmfile bytes are read-only views; torch wants
        # writable memory to wrap
        self.tensors = {
            k: share.tensors[k] if same(k, v)
            else torch.from_numpy(v if v.flags.writeable else v.copy()).to(device)
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
    Per-channel grids run over the consumer's output channels
    (qmath.weight_channels: axis 0, but a Deconvolution weight's along
    axis 1 by group)."""

    def __init__(self, tensor: Tensor, store: ParamStore, node):
        super().__init__(tensor, store)
        self._op, self._group = node.op, node.params.get("group", 1)

    @property
    def x(self):
        t = self._t
        return self._store.get(
            f"t{t.idx}/dequant",
            lambda: qmath.dequantize_weight_np(t.data, t.quant, self._op,
                                               self._group).astype(np.float32),
        )


class _Captured(NamedTuple):
    """One input signature's CUDA graph: the static input buffers it reads,
    the graph, and the static outputs each replay writes."""

    inputs: List[torch.Tensor]
    graph: Any  # torch.cuda.CUDAGraph
    outputs: Tuple[torch.Tensor, ...]


def _capture_failure(e: BaseException) -> str:
    """A failed capture's message: the node the forward was at (the note
    build_forward adds) and that node's own error. When an operation that
    capture forbids (a host sync, an upload from pageable memory) fails,
    the end of the capture fails too, with the first error as its
    context."""
    cause = e
    while cause is not None and not getattr(cause, "__notes__", None):
        cause = cause.__context__
    if cause is None:
        return f"capturing the forward into a CUDA graph failed: {e}"
    return (f"capturing the forward into a CUDA graph failed {cause.__notes__[-1]}: "
            f"{type(cause).__name__}: {cause}")


class CompiledGraph:
    """The runnable artifact: the forward, its device params, its device,
    and on a CUDA device one captured CUDA graph per input signature."""

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
        # the forward and its params by the inputs' shapes past the batch
        # dimension: the compiled sizes', and one more per size a call brings
        self._sized: Dict[tuple, Tuple[Callable, Dict[str, torch.Tensor]]] = {
            tuple(shape[1:] for _, shape, _ in _input_spec(graph, options)): (fn, params)}
        self._graphs: Dict[tuple, _Captured] = {}
        self._cost: Optional[Dict[str, Any]] = None
        # __call__ from any number of threads: the lock covers the size and
        # signature lookups, a capture, the copy into the static inputs, the
        # replay and the output clones; _done marks on the card the end of
        # the last call's clones, which the next call's stream waits for
        # (two callers may run on two streams)
        self._lock = threading.Lock()
        self._done: Optional[Any] = None  # torch.cuda.Event
        self._stream: Optional[Any] = None  # torch.cuda.Stream: warm-up and capture

    def __call__(self, *inputs) -> Tuple[torch.Tensor, ...]:
        """Run on the engine's device (numpy arrays and tensors elsewhere
        are copied over); the outputs stay on the device.

        On a CUDA device the forward runs as a CUDA graph: captured at the
        first call of each input signature (shapes and dtypes; a new batch
        size captures another graph, as jax.jit retraces), then replayed
        with the inputs copied into the graph's static buffers. The outputs
        are fresh tensors that no later call overwrites. A forward that
        cannot be captured raises, naming its node; nothing falls back to
        eager. On the CPU, and with Options.debug_nans (a host check after
        every node), the forward runs eagerly, as forward_fn does.

        Inputs of another image size than the compiled one run too, as the
        JAX engine retraces for them: the compile-time params that depend on
        the size (a pooling divisor, resize indices, a zero-point
        correction, priors) are prepared for it at its first call, by the
        prepare pass into a ParamStore of its own (the weights are shared),
        with the kernels selected at compile time.

        Any number of threads may call one CompiledGraph, or several, at
        once: calls of one CompiledGraph take its lock in turn, and a
        capture runs beside other threads' replays and eager forwards."""
        with trace.span(trace.ENGINE_CALL):
            with trace.span(trace.ENGINE_COPY_IN):
                xs = [x if isinstance(x, torch.Tensor)
                      else torch.as_tensor(np.ascontiguousarray(x)) for x in inputs]
            with self._lock:
                fn, params = self._for_size(xs)
            if not self._captures():
                with trace.span(trace.ENGINE_FORWARD), torch.inference_mode():
                    return fn(params, *(x.to(self.device) for x in xs))
            sig = tuple((tuple(x.shape), x.dtype) for x in xs)
            with self._lock:
                stream = torch.cuda.current_stream(self.device)
                if self._done is not None:
                    stream.wait_event(self._done)
                cap = self._graphs.get(sig)
                if cap is None:
                    cap = self._graphs[sig] = self._capture(fn, params, xs)
                else:
                    with trace.span(trace.ENGINE_COPY_IN):
                        for buf, x in zip(cap.inputs, xs):
                            if buf is not x:  # a donated buffer passed again needs no copy
                                buf.copy_(x)
                with trace.span(trace.ENGINE_REPLAY):
                    cap.graph.replay()
                with trace.span(trace.ENGINE_CLONE):
                    outs = tuple(o.clone() for o in cap.outputs)
                self._done = torch.cuda.Event()
                self._done.record(stream)
                return outs

    def _captures(self) -> bool:
        """Whether __call__ runs the forward as a CUDA graph."""
        return self.device.type == "cuda" and not self.options.debug_nans

    def _for_size(self, xs: List[torch.Tensor]) -> Tuple[Callable, Dict[str, torch.Tensor]]:
        """The forward and params for the inputs' sizes past the batch
        dimension, prepared at the first call of a new size."""
        size = tuple(tuple(x.shape[1:]) for x in xs)
        if size not in self._sized:
            store = ParamStore()
            meta_pass(self.graph, self.options, store, inputs=xs, plan=self._fn.plan)
            store.upload(self.device, share=self._fn.store)
            fn, _, _ = build_forward(self.graph, self.options, store, plan=self._fn.plan)
            self._sized[size] = (fn, store.tensors)
        return self._sized[size]

    def _capture(self, fn: Callable, params, xs: List[torch.Tensor]) -> _Captured:
        """Warm the forward up once on this CompiledGraph's own side stream
        (the kernels' build, cuDNN's set-up and the allocator's first
        allocations stay outside the graph), then capture it on that stream.
        The static inputs are copies, or with Options.donate_input the
        caller's own device tensors.

        Other threads keep running while a capture is underway, so the
        capture is thread-local on a private stream rather than under a
        lock that every call would take: in CUDA's default (global) capture
        mode, another thread's allocation, synchronisation or upload fails
        the capture or its own call, and a lock around every replay and
        eager forward would serialise all device work of the process. In
        thread-local mode only the capturing thread is held to capture's
        rules; the private stream (torch hands out non-blocking streams)
        takes no implicit dependency on other threads' work, and the
        allocator routes only this stream's allocations to the graph's
        pool. Captures themselves still run one at a time
        (_CAPTURE_LOCK): torch.cuda.graph synchronises the device and
        empties the allocator's cache as it begins, which must not happen
        while another capture is underway."""
        dev = self.device
        donate = self.options.donate_input
        static = [x if donate and x.device == dev else x.to(dev, copy=True) for x in xs]
        with trace.span(trace.ENGINE_CAPTURE), _CAPTURE_LOCK:
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            side = self._stream
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), torch.inference_mode():
                fn(params, *static)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.inference_mode(), torch.cuda.graph(
                        graph, stream=side, capture_error_mode="thread_local"):
                    outs = fn(params, *static)
            except Exception as e:
                raise RuntimeError(_capture_failure(e)) from e
        return _Captured(static, graph, outs)

    @property
    def forward_fn(self) -> Callable:
        """The eager forward fn(params, *inputs) -> outputs: the function
        the CUDA graphs capture, run op by op (the JAX engine's forward_fn
        is likewise the un-jitted function)."""
        return self._fn

    @property
    def kernels(self) -> Dict[str, str]:
        """Node name -> name of the lowering selected for it."""
        return self._fn.kernels

    def run(self, *inputs) -> List[np.ndarray]:
        with trace.span(trace.ENGINE_RUN):
            outs = self(*inputs)
            with trace.span(trace.ENGINE_DOWNLOAD):
                return [o.cpu().numpy() for o in outs]

    def cost_analysis(self) -> Dict[str, Any]:
        """The forward's cost at the compiled input shapes, computed once
        (the JAX engine returns XLA's cost model; the keys "flops" and
        "bytes accessed" are its):

          flops           2 per multiply-add of the convolutions (fused
                          chains' included) and fully connected layers,
                          over the taps that fall inside the input, plus
                          one per output element of a bias: what XLA
                          counts for them. Other elementwise work is not
                          counted.
          bytes accessed  every node's activation inputs read once and its
                          outputs written once, at the dtypes the forward
                          stores them, plus every compile-time param once.
          launches        device operations (kernels, copies, fills) of
                          one forward, counted by torch.profiler over one
                          eager forward on zeros (after a warm-up forward
                          unless a capture has run one); None on the CPU.
        """
        if self._cost is None:
            env, param_bytes = _meta_env(self.graph, self.options, self._fn.store, self._fn.plan)
            flops = moved = 0
            for node in self.graph.nodes:
                if not node.outputs or node.outputs[0] not in env:
                    continue
                flops += _node_flops(self.graph, node, env)
                moved += sum(env[t].numel() * env[t].element_size()
                             for t in list(node.inputs) + list(node.outputs) if t in env)
            self._cost = {
                "flops": float(flops),
                "bytes accessed": float(moved + param_bytes),
                "launches": self._count_launches() if self.device.type == "cuda" else None,
            }
        return dict(self._cost)

    def _count_launches(self) -> int:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        xs = [torch.zeros(s, dtype=dt, device=self.device)
              for _, s, dt in _input_spec(self.graph, self.options)]
        with torch.inference_mode():
            if not self._graphs:  # else a capture's warm-up has built and set up
                self._fn(self.params, *xs)  # builds and set-up outside the count
            torch.cuda.synchronize(self.device)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                self._fn(self.params, *xs)
                torch.cuda.synchronize(self.device)
        return sum(r.count for r in prof.key_averages() if r.device_type == DeviceType.CUDA)


def _taps(size: int, out: int, k: int, stride: int, pad: int, dil: int) -> int:
    """Kernel taps that fall inside an input of `size`, summed over the
    `out` output positions of one axis."""
    return sum(
        sum(0 <= o * stride - pad + i * dil < size for i in range(k)) for o in range(out)
    )


def _node_flops(graph: Graph, node, env: Dict[int, torch.Tensor]) -> int:
    """flops of one node as cost_analysis counts them (env: semantic
    shapes by tensor id from _meta_env)."""
    p = node.params
    out = env[node.outputs[0]]
    if node.op == "Convolution" and node.inputs[0] in env:
        n, c_out, oh, ow = out.shape
        _, _, h, w = env[node.inputs[0]].shape
        kh, kw = p["kernel_h"], p["kernel_w"]
        c_in = int(graph.tensors[node.inputs[1]].shape[1])  # per group
        taps = (_taps(h, oh, kh, p["stride_h"], p["pad_h0"], p.get("dilation_h", 1))
                * _taps(w, ow, kw, p["stride_w"], p["pad_w0"], p.get("dilation_w", 1)))
        return 2 * n * c_out * c_in * taps + (out.numel() if len(node.inputs) > 2 else 0)
    if node.op == "FullyConnected":
        k = int(np.prod(graph.tensors[node.inputs[1]].shape[1:]))
        return 2 * out.numel() * k + (out.numel() if len(node.inputs) > 2 else 0)
    if node.op == "FusedResBlockChain":
        n, _, h, w = out.shape
        total = 0
        for b in p["blocks"]:  # the convs run at the chain's output size
            ci, cm, co = b["c_in"], b["c_mid"], b["c_out"]
            macs = h * w * (ci * cm + cm * co + (ci * co if b["proj"] else 0))
            macs += _taps(h, h, 3, 1, 1, 1) * _taps(w, w, 3, 1, 1, 1) * cm * cm
            biases = sum(c for key, c in (("b1_pos", cm), ("b2_pos", cm), ("b3_pos", co),
                                          ("b4_pos", co)) if key in b)
            total += 2 * n * macs + n * h * w * biases
        return total
    return 0


def _meta_env(graph: Graph, options: Options, store: "ParamStore",
              plan: Optional[List["_Step"]] = None):
    """Every tensor of the forward at the compiled input shapes, as meta
    tensors in semantic layout and the dtypes the forward stores, and the
    bytes of the compile-time params: one meta pass over the compiled
    graph with the kernels of `plan` (the forward's), the params read from
    `store` (none is computed again)."""
    meta = ParamStore()
    meta.values = store.values
    return (meta_pass(graph, options, meta, plan=plan),
            sum(v.nbytes for v in store.values.values()))


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


class _Step(NamedTuple):
    """One node of the forward: its lowering context, the kernel selected
    for it once at build time, and whether the engine wraps the kernel in
    dequantize / requantize (a float kernel on a quantized graph)."""

    node: Any
    ctx: LowerCtx
    kernel: Any
    wrap_quant: bool

    def args(self, env: Dict[int, TArr]) -> list:
        """The lowering's arguments: activations from env (dequantized for a
        wrapped kernel), consts as lazy params."""
        graph, store = self.ctx.graph, self.ctx.store
        args = []
        for tid in self.node.inputs:
            t = graph.tensors[tid]
            quant = self.wrap_quant and qmath.is_quantized_tensor(t)
            if tid in env:
                a = env[tid]
                args.append(TArr(qmath.dequantize(a.x, t.quant), a.layout) if quant else a)
            elif t.is_const:
                args.append(DequantConstIn(t, store, self.node) if quant else ConstIn(t, store))
            else:
                raise RuntimeError(
                    f"tensor {t.name!r} consumed by {self.node.name!r} before production")
        return args

    def apply(self, args: list) -> Tuple[TArr, ...]:
        """The lowering on `args`: one output per node output."""
        out = self.kernel.fn(self.ctx, *args)
        outs = out if isinstance(out, tuple) else (out,)
        if not self.wrap_quant:
            return outs
        # re-quantize float results into the node's quantized output tensors
        # — the reference stores every activation quantized, so per-node
        # requantization is part of its numerics. The scale's reciprocal
        # multiplies, as in the JAX engine's compiled forward
        # (qmath.requantize)
        tensors = self.ctx.graph.tensors
        return tuple(
            TArr(qmath.requantize(o.x, tensors[tid].quant, tensors[tid].dtype, reciprocal=True),
                 o.layout)
            if qmath.is_quantized_tensor(tensors[tid]) and o.x.is_floating_point() else o
            for tid, o in zip(self.node.outputs, outs)
        )


def plan_nodes(graph: Graph, options: Options, store: ParamStore,
               plan: Optional[List[_Step]] = None) -> List[_Step]:
    """The forward's nodes in topological order, each with its kernel
    (selected once, here), reading its params from `store`. Given another
    store's `plan`, the same nodes and kernels on this store."""
    if plan is not None:
        return [s._replace(ctx=dataclasses.replace(s.ctx, store=store)) for s in plan]
    quantized = _graph_quantized(graph)
    steps = []
    for node in graph.toposorted():
        ctx = LowerCtx(graph=graph, node=node, options=options, store=store)
        kernel = select_kernel(node.op, ctx)
        steps.append(_Step(node, ctx, kernel, quantized and not kernel.quant_aware))
    return steps


def bind_inputs(graph: Graph, options: Options, inputs) -> Dict[int, TArr]:
    """The graph's input tensors by id, in the layout the caller gives."""
    return {tid: nhwc(a) if options.input_layout == "NHWC" and a.ndim == 4 else nchw(a)
            for tid, a in zip(graph.input_tensors, inputs)}


def build_forward(graph: Graph, options: Options, store: ParamStore, return_all: bool = False,
                  plan: Optional[List[_Step]] = None):
    """The whole-graph forward fn(params, *inputs). Runs on meta tensors in
    the prepare pass and on device tensors after it. return_all=True returns
    every tensor (for shape inference / calibration). `plan`: the kernels
    another forward selected (plan_nodes)."""
    input_ids = graph.input_tensors
    output_ids = graph.output_tensors
    plan = plan_nodes(graph, options, store, plan)

    def forward(params, *inputs):
        env = bind_inputs(graph, options, inputs)
        step = None
        try:
            for step in plan:
                outs = step.apply(step.args(env))
                if options.debug_nans:
                    for o in outs:
                        if (o.x.is_floating_point() and o.x.device != META
                                and not torch.isfinite(o.x).all()):
                            raise FloatingPointError(
                                f"non-finite value produced by node {step.node.name!r}")
                for tid, o in zip(step.node.outputs, outs):
                    env[tid] = o
        except Exception as e:
            if step is not None:  # which node failed, e.g. under capture
                e.add_note(f"at node {step.node.name!r} (op {step.node.op}, "
                           f"lowering {step.kernel.name})")
            raise

        def finalize(tid):
            # quantized activations are stored in their integer dtype all
            # along, so the JAX engine's bf16 -> int boundary cast has no
            # counterpart here
            return as_semantic(env[tid]).contiguous()

        if return_all:
            return {tid: finalize(tid) for tid in env}
        return tuple(finalize(tid) for tid in output_ids)

    # which lowering each node took (kernel selection happens once, above)
    forward.kernels = {step.node.name: step.kernel.name for step in plan}
    forward.plan = plan
    forward.store = store
    return forward, input_ids, output_ids


def meta_pass(graph: Graph, options: Options, store: ParamStore,
              inputs=None, plan: Optional[List[_Step]] = None) -> Dict[int, torch.Tensor]:
    """The prepare pass: the forward on meta tensors (shapes only) at the
    compiled input shapes, or at those of `inputs`. It computes into `store`
    (in its prepare phase) every compile-time param the store lacks, and
    returns every tensor of the forward by id, in semantic layout, at the
    dtype the forward stores it. `plan`: the kernels to run (plan_nodes)."""
    forward_all, _, _ = build_forward(graph, options, store, return_all=True, plan=plan)
    metas = (_meta_inputs(graph, options) if inputs is None
             else [torch.empty(x.shape, dtype=x.dtype, device=META) for x in inputs])
    with torch.inference_mode():
        return forward_all({}, *metas)


def _native_profitable(graph: Graph) -> bool:
    """Per-graph gate of the JAX engine's native-int8 plan, ported as-is so
    the port makes the same decision. The statistic is the fraction of conv
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
    graph: Graph, options: Optional[Options] = None, device=None,
    share: Optional[CompiledGraph] = None,
) -> CompiledGraph:
    """prerun_graph_multithread analog: passes, prepare, device params.

    The pass pipeline is the JAX engine's, in its order. `share`: a
    CompiledGraph on the same device (of the same graph under other
    Options, e.g. another batch size) whose device params are taken
    wherever a param here is equal to its, instead of a second copy."""
    device = resolve_device(device)
    options = options or Options.from_env()
    with trace.span(trace.COMPILE_PASSES):
        graph = _compile_passes(graph, options)
    store = ParamStore()
    with trace.span(trace.COMPILE_PREPARE):
        forward, input_ids, output_ids = build_forward(graph, options, store)

        # --- prepare pass: collect params, infer shapes ---
        env = meta_pass(graph, options, store)
        for tid in output_ids:
            graph.tensors[tid].shape = list(env[tid].shape)

    if share is not None and share.device != device:
        raise ValueError(f"share= is on {share.device}, this graph compiles for {device}")
    with trace.span(trace.COMPILE_UPLOAD):
        params = store.upload(device, share=share.forward_fn.store if share is not None else None)
    return CompiledGraph(graph, options, forward, params, input_ids, output_ids, device)


def _compile_passes(graph: Graph, options: Options) -> Graph:
    """compile_graph's passes under `options`: the graph itself where none
    applies, else a rewritten clone."""
    fast_quant = (
        _graph_quantized(graph)
        and options.quant_mode in ("auto", "fast")
        and not options.force_ref_kernels
    )
    if options.stem_s2d and not options.force_ref_kernels:
        # small-channel stride-2 stems -> SpaceToDepth + a stride-1 conv
        g2 = graph.clone()
        if stem_conv_s2d(g2):
            graph = g2
    native_int8 = (
        fast_quant
        and options.quant_native != "off"
        and (options.quant_native == "on" or options.quant_relaxed)
        and os.environ.get("TT_NATIVE_INT", "1") not in ("0", "off")
        and (options.quant_native == "on" or _native_profitable(graph))
    )
    if fast_quant and (
        options.fuse_resblock or (options.quant_relaxed and not native_int8)
    ):
        # whole bottleneck-block chains -> the qblock_chain kernel (runs
        # before fuse_conv_add, which would otherwise absorb the residual
        # Eltwise into the conv epilogue). quant_relaxed also enables the
        # pass, from chain_min_cmid up, off the native-int8 plan;
        # fuse_resblock forces it at any width, under the plan too.
        graph = graph.clone()
        fuse_resnet_blocks(
            graph, min_cmid=0 if options.fuse_resblock else options.chain_min_cmid
        )
    if fast_quant and os.environ.get("TT_FOLD_SHUFFLE", "1") not in ("0", "off"):
        # shuffle+slice chains fold into consumer conv weights / one
        # ChannelGather (exact on the shared grid the quantizer pins); the
        # folded clone replaces the graph only where something folded
        g2 = graph.clone()
        if fold_shuffle_gathers(g2):
            graph = g2
    if fast_quant:
        # residual eltwise-sums fold into the conv requant epilogue
        graph = graph.clone()
        geometry = "pallas" if (
            options.pallas_qconv and not options.quant_bf16_storage
        ) else "any"
        fuse_conv_add(graph, geometry=geometry, relaxed_relu=options.quant_relaxed)
    if native_int8:
        # native-int8 plan: every activation stored as its 1-byte dtype, UINT8
        # graphs shift-rewritten (after fuse_conv_add, so fused_add_mid
        # tensors shift too); an empty _bf16_tids marks the plan for the
        # storage predicate ops/quantized.py:_int_stored
        graph = graph.clone()
        to_native_int8(graph)
        graph._bf16_tids = set()
    return graph


def infer_shapes(graph: Graph, options: Optional[Options] = None) -> Graph:
    """Standalone shape inference via a meta pass — records every tensor's
    shape into the IR (infer_ir_graph_shape analog)."""
    options = options or Options.from_env()
    for tid, arr in meta_pass(graph, options, ParamStore()).items():
        graph.tensors[tid].shape = list(arr.shape)
    return graph
