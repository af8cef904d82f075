"""Sharding rules: run a compiled graph on a (data, model) mesh (PyTorch
port of tengine_tpu/parallel/sharding.py).

The JAX package annotates shardings and lets GSPMD insert the collectives.
Here the rank-local program is built by hand, in place of the reference's
graph partitioner (optimizer/split.c). Rules, as in the JAX package:

  * activations: the batch dim over "data" (DP serving): each data group
    runs its rows through the plan compiled for the global batch;
  * conv weights: the output channels over "model" where divisible and at
    least 2·tp, so each rank computes a channel slice and the slices are
    all-gathered right after the node;
  * FC weights: the output features over "model" likewise;
  * a 2-D raw const: dim 0 likewise;
  * everything else replicated. The weights of the hand-written kernels'
    routes (the stem's, the depthwise kernel's, the int8 kernels' packs)
    match no rule, as in the JAX package, so those kernels see their
    unsharded shapes: under TP only the fast tier's convs (float64 or, for
    INT8 at zero point 0, qconv_fast's [O, kh, kw, Cp] int8 weights), the
    ref and float convs and the FCs are sliced.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..executor.engine import (
    CompiledGraph, ParamStore, _Step, _meta_env, build_forward, meta_pass,
)
from ..graph.ir import Graph, Node, QuantParam, TensorType
from ..ops.layout import TArr
from ..ops.lowering import _conv_pads
from ..ops.registry import Kernel, LowerCtx

# the port's tags of conv weights (output channels on dim 0) and of FC
# weights ([K, N]: output features on dim 1); the JAX package's are its
# HWIO and [K, N] layouts of the same lowerings
CONV_TAGS = ("oihw", "oihw_f64", "oihw_zshift_f64", "oihw_deq", "ohwi_i8")
FC_TAGS = ("kt_f64", "kt_zshift_f64", "kt_deq")
TP_GATHER, TP_SLICE = "TPChannelGather", "TPChannelSlice"  # port-internal, not TM2 ops


def _splits(n: int, tp: int) -> bool:
    return n % tp == 0 and n >= 2 * tp


def param_spec(key: str, arr, tp: int):
    """The placement over "model" of the compile-time param `key` (a
    ParamStore key, `t<idx>/<tag>` for a weight) of shape arr.shape:
    Shard(dim) or Replicate()."""
    shape = tuple(arr.shape)
    if tp <= 1:
        return Replicate()
    tag = key.rsplit("/", 1)[-1]
    if tag in CONV_TAGS and len(shape) == 4 and _splits(shape[0], tp):
        return Shard(0)
    if tag in FC_TAGS and len(shape) == 2 and _splits(shape[1], tp):
        return Shard(1)
    if tag == "raw" and len(shape) == 2 and _splits(shape[0], tp):
        return Shard(0)
    return Replicate()


def _weight_tensor(key: str) -> Optional[int]:
    head = key.split("/", 1)[0]
    return int(head[1:]) if head.startswith("t") and head[1:].isdigit() else None


def _jax_width_folds(cg: CompiledGraph, node: Node, shapes) -> bool:
    """Whether the JAX package's fast lowering width-folds this conv
    (tengine_tpu/ops/quantized.py:_conv_quant_common: a small-channel
    stride-2 stem, its W pairs folded into channels). Its weight then
    carries a tag (hwio_i8_wfold*, hwio_zshift_bf16_wf*) that no rule
    matches, so it stays replicated there and here too. The port has no
    width fold: the condition is the JAX lowering's, and the branch it
    takes is the one cg's lowering took, the integer branch (which folds
    only at zp_in 0) where the weight is held as oihw_f64 or, on
    qconv_fast's route, as ohwi_i8."""
    if cg.kernels[node.name] != "lower_conv_quant_fast":
        return False
    p = node.params
    _, _, in_h, in_w = shapes[node.inputs[0]]
    dil_w = p.get("dilation_w", 1)
    kh_eff = (p["kernel_h"] - 1) * p.get("dilation_h", 1) + 1
    kw_eff = (p["kernel_w"] - 1) * dil_w + 1
    (_, _), (pl, pr) = _conv_pads(in_h, in_w, p, kh_eff, kw_eff)
    zp_in = int(np.asarray(cg.graph.tensors[node.inputs[0]].quant.zero_points).reshape(-1)[0])
    integer = any(f"t{node.inputs[1]}/{tag}" in cg.params for tag in ("oihw_f64", "ohwi_i8"))
    return (p["stride_w"] == 2 and p["kernel_w"] >= 3
            and int(cg.graph.tensors[node.inputs[1]].shape[1]) <= 4
            and p.get("group", 1) == 1 and dil_w == 1 and in_w % 8 == 0
            and pl >= 0 and pr >= 0 and (not integer or zp_in == 0))


def _shapes(cg: CompiledGraph) -> Dict[int, Tuple[int, ...]]:
    """Every tensor's semantic shape at cg's compiled input shapes."""
    env, _ = _meta_env(cg.graph, cg.options, cg.forward_fn.store, cg.forward_fn.plan)
    return {tid: tuple(t.shape) for tid, t in env.items()}


def sharded_nodes(cg: CompiledGraph, tp: int, shapes=None) -> List[Node]:
    """The Convolution and FullyConnected nodes of cg.graph that run on a
    channel slice at TP degree tp: those whose weight has a param that
    param_spec shards, less a stem the JAX lowering width-folds and a
    grouped conv whose groups tp does not divide (which stays replicated)."""
    if tp <= 1:
        return []
    sharded: Set[int] = {
        _weight_tensor(k) for k, v in cg.params.items()
        if not isinstance(param_spec(k, v, tp), Replicate)}
    shapes = shapes or _shapes(cg)
    out = []
    for node in cg.graph.nodes:
        if (node.op not in ("Convolution", "FullyConnected") or len(node.inputs) < 2
                or node.inputs[1] not in sharded or node.name not in cg.kernels):
            continue
        if node.op == "Convolution":
            group = node.params.get("group", 1)
            if (group > 1 and group % tp) or _jax_width_folds(cg, node, shapes):
                continue
        out.append(node)
    return out


def sharded_weights(cg: CompiledGraph, tp: int) -> Set[int]:
    """The weight tensors (ids) the port splits over "model" at degree tp."""
    return {n.inputs[1] for n in sharded_nodes(cg, tp)}


def _staged(x: torch.Tensor, group) -> bool:
    """gloo collectives take host tensors: a card's tensor goes through
    host memory (a property of the backend, not a fallback)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, rank order, in x's
    dtype and memory layout. NCCL gathers on the card (capturable into a
    CUDA graph); gloo through host memory."""
    if size == 1:
        return x
    staged = _staged(x, group)
    src = (x.cpu() if staged else x).contiguous()
    out = torch.empty((size * src.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)  # the ranks' tensors along dim 0
    shape = list(src.shape)
    shape[dim] *= size
    out = out.view(size, *src.shape).movedim(0, dim).reshape(shape)
    return out.to(x.device) if staged else out


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank `src`'s x (a global rank) on every rank of the group; x is a
    buffer of the right shape and dtype on the others."""
    if dist.get_world_size(group) == 1:
        return x
    staged = _staged(x, group)
    buf = (x.cpu() if staged else x).contiguous()
    dist.broadcast(buf, src=src, group=group)
    return buf.to(x.device) if staged else buf


def _channel_axis(x: TArr) -> int:
    return 3 if x.layout == "NHWC" and x.x.ndim == 4 else 1


def _physical(x: torch.Tensor):
    """x as a contiguous tensor in its memory order (dims by stride,
    outermost first) and the permutation that gives it. The slices and
    gathers keep the memory order of what they are given: a library's
    kernel (a oneDNN or cuDNN conv) picks its algorithm, and with it the
    order of its sums, by the memory format of its input."""
    perm = sorted(range(x.ndim), key=lambda d: (-x.stride(d), d))
    xp = x.permute(perm)
    return (xp if xp.is_contiguous() else xp.contiguous()), perm


def _logical(xp: torch.Tensor, perm) -> torch.Tensor:
    inv = [0] * len(perm)
    for i, d in enumerate(perm):
        inv[d] = i
    return xp.permute(inv)


def _gather_kernel(group, tp: int) -> Kernel:
    def lower(ctx: LowerCtx, x: TArr) -> TArr:
        xp, perm = _physical(x.x)
        axis = perm.index(_channel_axis(x))
        if xp.device.type == "meta":  # the prepare pass: shapes only
            return TArr(_logical(torch.cat([xp] * tp, axis), perm), x.layout)
        return TArr(_logical(all_gather_dim(xp, axis, group, tp), perm), x.layout)

    return Kernel(name="tp_all_gather", score=0, fn=lower, quant_aware=True)


def _lower_slice(ctx: LowerCtx, x: TArr) -> TArr:
    xp, perm = _physical(x.x)
    part = xp.narrow(perm.index(_channel_axis(x)), ctx.params["lo"], ctx.params["channels"])
    return TArr(_logical(part.contiguous(), perm), x.layout)


_SLICE_KERNEL = Kernel(name="tp_channel_slice", score=0, fn=_lower_slice, quant_aware=True)


def _sliced_quant(q: Optional[QuantParam], sl: slice, n: int) -> Optional[QuantParam]:
    if q is None or not q.per_channel or np.asarray(q.scales).size != n:
        return q
    return QuantParam(np.asarray(q.scales)[sl].copy(), np.asarray(q.zero_points)[sl].copy(),
                      q.width, q.full_range)


def _local_graph(cg: CompiledGraph, nodes: Sequence[Node], tp: int, r: int,
                 shapes: Dict[int, Tuple[int, ...]]) -> Graph:
    """cg.graph for model rank r: each node of `nodes` reads its weight,
    bias and per-channel weight grid sliced to output channels
    [r·O/tp, (r+1)·O/tp), its input (a grouped conv's) and fused residual
    sliced alike, and writes its slice to a tensor of its own, which a
    TPChannelGather node all-gathers into the node's own output tensor."""
    g = cg.graph.clone()
    if hasattr(cg.graph, "_bf16_tids"):  # the native-int8 plan's marker
        g._bf16_tids = set(cg.graph._bf16_tids)

    def rewire(node, i, tid):
        old = g.tensors[node.inputs[i]]
        old.consumers = [c for c in old.consumers if c != node.idx]
        node.inputs[i] = tid
        g.tensors[tid].consumers.append(node.idx)

    def slice_const(node, i, sl, n):
        t = g.tensors[node.inputs[i]]
        data = np.ascontiguousarray(t.data[sl])
        nt = g.add_tensor(f"{t.name}/tp{r}", t.dtype, data.shape, TensorType.CONST, data=data,
                          quant=_sliced_quant(t.quant, sl, n))
        nt.layout = t.layout
        rewire(node, i, nt.idx)

    def local_tensor(tid, channels, suffix):
        t = g.tensors[tid]
        shape = list(shapes[tid])
        shape[1] = channels
        return g.add_tensor(f"{t.name}/{suffix}", t.dtype, shape, TensorType.VAR, quant=t.quant)

    def slice_input(node, i, channels):
        src = node.inputs[i]
        t = local_tensor(src, channels, f"tp{r}_in{node.idx}")
        g.add_node(TP_SLICE, f"{node.name}/tp_slice{i}", [src], [t.idx],
                   params=dict(lo=r * channels, channels=channels))
        rewire(node, i, t.idx)

    for n0 in nodes:
        node = g.nodes[n0.idx]
        p = node.params
        out_c = int(np.shape(g.tensors[node.inputs[1]].data)[0])
        c = out_c // tp
        sl = slice(r * c, (r + 1) * c)
        fused = p.get("fused_add_pos")
        has_bias = fused == 3 if fused is not None else len(node.inputs) > 2
        slice_const(node, 1, sl, out_c)
        if has_bias:
            slice_const(node, 2, sl, out_c)
        if node.op == "Convolution":
            p["output_channel"] = c
            if p.get("group", 1) > 1:
                p["group"] //= tp
                in_c = shapes[node.inputs[0]][1] // tp
                if "input_channel" in p:
                    p["input_channel"] = in_c
                slice_input(node, 0, in_c)
            if fused is not None:
                slice_input(node, fused, c)
        else:
            p["num_output"] = c
        out = node.outputs[0]
        loc = local_tensor(out, c, f"tp{r}")
        node.outputs[0] = loc.idx
        loc.producer = node.idx
        gather = g.add_node(TP_GATHER, f"{node.name}/tp_gather", [loc.idx], [out])
        g.outputs = [gather.idx if ni == node.idx else ni for ni in g.outputs]
    return g


class ShardedGraph(CompiledGraph):
    """A CompiledGraph's rank-local program on a (data, model) mesh.

    `run(x_global)` / `__call__(x_global)`, called on every rank with the
    global batch, returns the full outputs: this data group's rows
    [d·B/dp, (d+1)·B/dp) run through the forward compiled for the global
    batch (the kernel routes it selected stay pinned), the TP slices are
    all-gathered over "model" after each sharded node, and the rows over
    "data" at the end. A DTensor input (host_local_batch_to_global) holds
    this data group's rows already; the outputs then come back as DTensors
    of the same placements, their local tensors this group's rows.

    With NCCL on the card the local forward is captured as a CUDA graph, as
    CompiledGraph.__call__ does, the channel all-gathers inside it; with
    gloo it runs eagerly, the gathers staged through host memory."""

    def __init__(self, cg: CompiledGraph, graph: Graph, fn, params, mesh):
        super().__init__(graph, cg.options, fn, params, cg.input_ids, cg.output_ids, cg.device)
        self.mesh = mesh
        self.dp, self.tp = mesh.size(0), mesh.size(1)
        self.data_rank = mesh.get_local_rank(0)
        self._data_group = mesh.get_group(0)

    def _captures(self) -> bool:
        """gloo's collectives run on the host: a forward with them runs
        eagerly."""
        return super()._captures() and dist.get_backend() == "nccl"

    def __call__(self, *inputs) -> tuple:
        if any(isinstance(x, DTensor) for x in inputs):
            outs = super().__call__(*(x.to_local() for x in inputs))
            return tuple(DTensor.from_local(o, self.mesh, (Shard(0), Replicate()),
                                            run_check=False) for o in outs)
        xs = [x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
              for x in inputs]
        batch = int(xs[0].shape[0])
        if batch % self.dp:
            raise ValueError(f"global batch {batch} is not divisible by the data axis "
                             f"({self.dp})")
        rows = batch // self.dp
        lo = self.data_rank * rows
        outs = super().__call__(*(x[lo:lo + rows] for x in xs))
        return tuple(all_gather_dim(o, 0, self._data_group, self.dp) for o in outs)


def shard_compiled(cg: CompiledGraph, mesh, share: Optional[CompiledGraph] = None) -> ShardedGraph:
    """cg on the mesh, as this rank runs it (every rank of the mesh builds
    its own). Each
    sharded node (sharded_nodes) keeps the lowering cg selected; every
    derived param (requant multipliers and biases, zero-point folds)
    follows from its sliced consts. `share`: a CompiledGraph whose device
    params are taken wherever a param here equals its (default cg)."""
    tp = mesh.size(1)
    r = mesh.get_local_rank(1)
    if tp > 1:
        shapes = _shapes(cg)
        g = _local_graph(cg, sharded_nodes(cg, tp, shapes), tp, r, shapes)
    else:
        g = cg.graph
    base = {s.node.name: s for s in cg.forward_fn.plan}
    gather = _gather_kernel(mesh.get_group(1), tp)
    store = ParamStore()
    plan = []
    for node in g.toposorted():
        ctx = LowerCtx(graph=g, node=node, options=cg.options, store=store)
        if node.op in (TP_GATHER, TP_SLICE):
            plan.append(_Step(node, ctx, gather if node.op == TP_GATHER else _SLICE_KERNEL, False))
        else:
            step = base[node.name]
            plan.append(_Step(node, ctx, step.kernel, step.wrap_quant))
    meta_pass(g, cg.options, store, plan=plan)
    params = store.upload(cg.device, share=(share or cg).forward_fn.store)
    fn, _, _ = build_forward(g, cg.options, store, plan=plan)
    return ShardedGraph(cg, g, fn, params, mesh)

