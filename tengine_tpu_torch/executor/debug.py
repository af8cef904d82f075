"""Debug/observability tools: per-node profiling and layer dump (PyTorch
port of tengine_tpu/executor/debug.py).

Reference equivalents:
  * TG_DEBUG_TIME — per-node timing with min/avg and per-layer %
    (cpu_device.c:79-156, report format in doc/docs_en/user_guides/debug.md).
    The compiled forward is one CUDA graph with no per-node boundary, so
    profiling runs the graph node by node eagerly: each node's lowering is
    timed with CUDA events on the card and with the host's perf_counter on
    the CPU, the best of `repeats` runs after one warm run.
  * TG_DEBUG_DATA — dump every node's output tensors to text files
    (cpu_device.c:157-199, cpu_dump.c extract_feature_from_tensor), with the
    JAX package's file names and text format.

Both run on the card unless the caller passes device="cpu", as
compile_graph does.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..graph.ir import Graph, TensorType
from ..ops.layout import as_semantic
from ..utils.config import Options
from .engine import (
    ParamStore, bind_inputs, build_forward, meta_pass, plan_nodes, resolve_device,
)


@dataclass
class NodeTiming:
    node: str
    op: str
    ms: float
    flops: int = 0

    @property
    def gflops_rate(self) -> float:
        return self.flops / (self.ms * 1e6) if self.ms > 0 else 0.0


@dataclass
class ProfileResult:
    timings: List[NodeTiming] = field(default_factory=list)

    @property
    def total_ms(self) -> float:
        return sum(t.ms for t in self.timings)

    def report(self) -> str:
        """Per-node table like the reference's TG_DEBUG_TIME dump."""
        lines = [f"{'#':>3} {'ms':>9} {'%':>6} {'MFLOPS':>9}  {'op':20} node"]
        total = self.total_ms or 1.0
        for i, t in enumerate(self.timings):
            lines.append(
                f"{i:3d} {t.ms:9.3f} {100*t.ms/total:5.1f}% {t.gflops_rate*1e3:9.1f}"
                f"  {t.op:20} {t.node}"
            )
        lines.append(f"total {total:.3f} ms")
        return "\n".join(lines)


def _node_flops(node, shapes) -> int:
    """Rough FLOP count for conv/fc (the reference reports MFLOPS for these)."""
    if node.op in ("Convolution", "Deconvolution"):
        p = node.params
        out_shape = shapes.get(node.outputs[0])
        if out_shape is None or len(out_shape) != 4:
            return 0
        n, c, h, w = out_shape
        kin = p.get("input_channel", 0) // max(p.get("group", 1), 1)
        return 2 * n * c * h * w * p["kernel_h"] * p["kernel_w"] * kin
    if node.op == "FullyConnected":
        out_shape = shapes.get(node.outputs[0])
        in_shape = shapes.get(node.inputs[0])
        if out_shape is None or in_shape is None:
            return 0
        return 2 * int(np.prod(in_shape)) * int(out_shape[1])
    return 0


def _device_inputs(inputs, device) -> List[torch.Tensor]:
    return [x.to(device) if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.ascontiguousarray(x)).to(device) for x in inputs]


def _prepared_store(graph: Graph, options: Options, xs) -> ParamStore:
    """Every compile-time param of `graph` at the inputs' shapes, on their
    device: the engine's prepare pass, then the upload."""
    store = ParamStore()
    meta_pass(graph, options, store, xs)
    store.upload(xs[0].device)
    return store


def profile_graph(
    graph: Graph, inputs, options: Optional[Options] = None, repeats: int = 3, device=None
) -> ProfileResult:
    """Execute node by node with per-node timing (TG_DEBUG_TIME analog):
    the engine's own node steps (executor/engine.py:plan_nodes), each run
    once warm, then the best of `repeats` runs of its lowering."""
    options = options or Options.from_env()
    device = resolve_device(device)
    xs = _device_inputs(inputs, device)
    store = _prepared_store(graph, options, xs)
    on_card = device.type == "cuda"

    def timed_ms(step, args):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = step.apply(args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end), outs
        t0 = time.perf_counter()
        outs = step.apply(args)
        return (time.perf_counter() - t0) * 1e3, outs

    env = bind_inputs(graph, options, xs)
    result = ProfileResult()
    shapes = {}
    with torch.inference_mode():
        for step in plan_nodes(graph, options, store):
            args = step.args(env)
            outs = step.apply(args)  # warm: the kernels' build, cuDNN's set-up
            if on_card:
                torch.cuda.synchronize(device)
            best = float("inf")
            for _ in range(repeats):
                ms, outs = timed_ms(step, args)
                best = min(best, ms)
            for tid, o in zip(step.node.outputs, outs):
                env[tid] = o
                shapes[tid] = tuple(as_semantic(o).shape)
            result.timings.append(NodeTiming(node=step.node.name, op=step.node.op, ms=best,
                                             flops=_node_flops(step.node, shapes)))
    return result


def _safe_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def dump_graph_tensors(
    graph: Graph, inputs, dump_dir: str, options: Optional[Options] = None, device=None
) -> List[str]:
    """Run the graph (eagerly) and dump every tensor to text files
    (TG_DEBUG_DATA analog; naming mirrors extract_feature_from_tensor in
    cpu_dump.c)."""
    options = options or Options.from_env()
    device = resolve_device(device)
    xs = _device_inputs(inputs, device)
    store = _prepared_store(graph, options, xs)
    forward_all, _, _ = build_forward(graph, options, store, return_all=True)
    with torch.inference_mode():
        env = forward_all(store.tensors, *xs)

    os.makedirs(dump_dir, exist_ok=True)
    written = []
    for tid, arr in env.items():
        t = graph.tensors[tid]
        if t.tensor_type == TensorType.CONST:
            continue
        a = arr.cpu()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.to(torch.float32)
        a = a.numpy()
        path = os.path.join(dump_dir, f"{_safe_name(t.name)}_{tid}.txt")
        with open(path, "w") as f:
            f.write(f"# {t.name} shape={list(a.shape)} dtype={a.dtype}\n")
            np.savetxt(f, a.reshape(-1)[:100000], fmt="%.6f")
        written.append(path)
    return written
