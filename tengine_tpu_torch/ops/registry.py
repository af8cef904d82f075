"""Op lowering registry with scored kernel selection (PyTorch port of
tengine_tpu/ops/registry.py: the same score tiers, the same selection rule).

The reference picks CPU kernels per node by score — every op may have several
registered `node_ops`, highest `score()` wins, and `TG_DEBUG_REF` forces the
reference kernel (`cpu_module.c:135-170`, score constants `cpu_define.h:29-33`).
We keep the same shape: per op name, a list of (score, predicate, lower_fn)
candidates. The "reference kernel" is the plain torch lowering; optimized
candidates (hand-written CUDA kernels, integer paths) register with higher
scores and capability predicates. `Options.force_ref_kernels` picks the
lowest-score candidate, giving the same known-good-slow-path oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..graph.ir import Graph, Node, Tensor
from ..utils.config import Options

# Score tiers, mirroring cpu_define.h:29-33
SCORE_STATIC = 10000
SCORE_BEST = 8000
SCORE_PREFER = 6000
SCORE_CANDO = 4000
SCORE_REF = 1000


@dataclass
class LowerCtx:
    """Compile-time context handed to each op lowering."""

    graph: Graph
    node: Node
    options: Options
    store: Any = None  # executor.engine.ParamStore

    def in_tensor(self, i: int) -> Tensor:
        return self.graph.tensors[self.node.inputs[i]]

    def out_tensor(self, i: int = 0) -> Tensor:
        return self.graph.tensors[self.node.outputs[i]]

    def const_data(self, i: int):
        """Static numpy data of the i-th input (None if not const)."""
        return self.in_tensor(i).data

    def get_param(self, key: str, compute):
        """A named compile-time-computed parameter (weight repack, folded
        scales, precomputed priors...). `compute()` returns a numpy array;
        it runs once on the host at prepare time, and the forward receives
        the result as a tensor on the engine's device — the analog of the
        reference's node_ops->prerun weight repacking (cpu_graph.c:143)."""
        return self.store.get(f"n{self.node.idx}/{key}", compute)

    def weight(self, i: int, transform=None, tag: str = "w"):
        """The i-th const input, optionally host-transformed, as a device
        tensor. Shared const tensors are cached per (tensor, transform tag)."""
        t = self.in_tensor(i)
        if t.data is None:
            raise ValueError(f"input {i} of node {self.node.name!r} is not const")
        key = f"t{t.idx}/{tag}"
        if transform is None:
            return self.store.get(key, lambda: t.data)
        return self.store.get(key, lambda: transform(t.data))

    @property
    def params(self) -> Dict[str, Any]:
        return self.node.params

    @property
    def num_inputs(self) -> int:
        return len(self.node.inputs)


@dataclass
class Kernel:
    name: str
    score: int
    fn: Callable  # fn(ctx: LowerCtx, *inputs) -> array | tuple of arrays
    predicate: Optional[Callable[[LowerCtx], bool]] = None
    # quant_aware kernels consume/produce quantized arrays themselves; for the
    # rest, the engine wraps with generic dequant->fp32->requant (the
    # reference's per-node requantization semantics)
    quant_aware: bool = False

    def applicable(self, ctx: LowerCtx) -> bool:
        return self.predicate is None or self.predicate(ctx)


_REGISTRY: Dict[str, List[Kernel]] = {}


def register_op(
    op: str,
    score: int = SCORE_REF,
    predicate: Optional[Callable[[LowerCtx], bool]] = None,
    name: Optional[str] = None,
    quant: bool = False,
):
    """Decorator registering a lowering candidate for `op`."""

    def deco(fn):
        _REGISTRY.setdefault(op, []).append(
            Kernel(
                name=name or fn.__name__,
                score=score,
                fn=fn,
                predicate=predicate,
                quant_aware=quant,
            )
        )
        _REGISTRY[op].sort(key=lambda k: -k.score)
        return fn

    return deco


def select_kernel(op: str, ctx: LowerCtx) -> Kernel:
    """Highest-score applicable kernel (cpu_module.c:135-170 analog)."""
    cands = _REGISTRY.get(op)
    if not cands:
        raise NotImplementedError(f"no lowering registered for op {op!r}")
    applicable = [k for k in cands if k.applicable(ctx)]
    if not applicable:
        raise NotImplementedError(f"no applicable kernel for {op!r} on node {ctx.node.name!r}")
    if ctx.options.force_ref_kernels:
        return applicable[-1]  # lowest score = reference path
    return applicable[0]
