"""Graph IR ("NNIR" equivalent).

The reference keeps a C struct graph of flat tensor/node arrays
(Tengine's `source/graph/graph.h:44-71`, `node.h:46-62`, `tensor.h:43-102`).
We keep the same *information* — dtype, layout, tensor_type, producer/consumer
edges, per-tensor or per-channel quant params — in plain Python dataclasses.

PyTorch port: a copy of tengine_tpu/graph/ir.py (the port imports nothing of
the JAX package). The IR is lowered node by node into eager torch calls on a
device (see tengine_tpu_torch/executor/engine.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class DType(enum.IntEnum):
    """Tensor element types; values match TENGINE_DT_* (c_api.h:58-63)."""

    FP32 = 0
    FP16 = 1
    INT8 = 2
    UINT8 = 3
    INT32 = 4
    INT16 = 5

    @property
    def np(self) -> np.dtype:
        return _NP_DTYPES[self]

    @property
    def size(self) -> int:
        return _NP_DTYPES[self].itemsize


_NP_DTYPES = {
    DType.FP32: np.dtype(np.float32),
    DType.FP16: np.dtype(np.float16),
    DType.INT8: np.dtype(np.int8),
    DType.UINT8: np.dtype(np.uint8),
    DType.INT32: np.dtype(np.int32),
    DType.INT16: np.dtype(np.int16),
}


class Layout(enum.IntEnum):
    """Graph/tensor data layout; values match TENGINE_LAYOUT_* (c_api.h:66-67)."""

    NCHW = 0
    NHWC = 1


class TensorType(enum.IntEnum):
    """Role of a tensor in the graph; values match TENSOR_TYPE_* (c_api.h:70-74)."""

    UNKNOWN = 0
    VAR = 1
    CONST = 2
    INPUT = 3
    DEP = 4


@dataclass
class QuantParam:
    """Per-tensor or per-channel quantization parameters.

    Mirrors the union in the reference tensor IR (`graph/tensor.h:80-98`):
    a single (scale, zero_point) for per-tensor quant, or parallel arrays for
    per-channel. `width` is the bit width recorded in TM2_QuantParam
    (`tm2_format.h:335-340`).
    """

    scales: np.ndarray  # shape () for per-tensor, (C,) for per-channel
    zero_points: np.ndarray  # int32, same shape as scales
    width: int = 8
    # INT8 tensors that hold a zero-point-shifted UINT8 grid (the native-int8
    # storage pass, graph/passes.py:to_native_int8) span the full [-128, 127]
    # range; the reference's symmetric int8 scheme clips to [-127, 127]
    # (conv_kernel_ref_int8.c). Kernels consult qmath.qrange(dtype, quant).
    full_range: bool = False

    @property
    def per_channel(self) -> bool:
        return self.scales.ndim > 0 and self.scales.size > 1

    @classmethod
    def per_tensor(cls, scale: float, zero_point: int = 0, width: int = 8) -> "QuantParam":
        return cls(
            scales=np.asarray(scale, np.float32),
            zero_points=np.asarray(zero_point, np.int32),
            width=width,
        )


@dataclass
class Tensor:
    """IR tensor. `data` is set only for CONST tensors (numpy, possibly a
    zero-copy view into the model file blob, like `tm2_serializer.c:251`)."""

    idx: int
    name: str
    dtype: DType = DType.FP32
    shape: List[int] = field(default_factory=list)
    tensor_type: TensorType = TensorType.VAR
    layout: Layout = Layout.NCHW
    quant: Optional[QuantParam] = None
    data: Optional[np.ndarray] = None
    producer: Optional[int] = None  # node idx
    consumers: List[int] = field(default_factory=list)

    @property
    def is_const(self) -> bool:
        return self.tensor_type == TensorType.CONST

    @property
    def elem_num(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def __repr__(self) -> str:  # keep graph dumps short
        q = " quant" if self.quant is not None else ""
        return f"Tensor({self.idx}:{self.name} {self.dtype.name}{list(self.shape)}{q})"


@dataclass
class Node:
    """IR node: op type, parsed params, tensor indices."""

    idx: int
    name: str
    op: str  # canonical op name, e.g. "Convolution" (see serializer/tm2/format.py)
    params: Dict[str, Any] = field(default_factory=dict)
    inputs: List[int] = field(default_factory=list)  # tensor indices
    outputs: List[int] = field(default_factory=list)  # tensor indices

    def __repr__(self) -> str:
        return f"Node({self.idx}:{self.op}:{self.name} in={self.inputs} out={self.outputs})"


@dataclass
class Graph:
    """Whole-model IR: flat tensor/node arrays indexed by int, like
    `ir_graph_t` (`graph/graph.h:44-71`), plus graph-level layout and I/O."""

    tensors: List[Tensor] = field(default_factory=list)
    nodes: List[Node] = field(default_factory=list)
    inputs: List[int] = field(default_factory=list)  # node indices of input nodes
    outputs: List[int] = field(default_factory=list)  # node indices of output nodes
    layout: Layout = Layout.NCHW
    model_layout: Layout = Layout.NCHW
    name: str = ""
    source_format: str = ""

    # ---- construction helpers -------------------------------------------------

    def add_tensor(
        self,
        name: str,
        dtype: DType = DType.FP32,
        shape: Sequence[int] = (),
        tensor_type: TensorType = TensorType.VAR,
        data: Optional[np.ndarray] = None,
        quant: Optional[QuantParam] = None,
    ) -> Tensor:
        t = Tensor(
            idx=len(self.tensors),
            name=name,
            dtype=dtype,
            shape=list(shape),
            tensor_type=tensor_type,
            data=data,
            quant=quant,
        )
        self.tensors.append(t)
        return t

    def add_node(
        self,
        op: str,
        name: str,
        inputs: Sequence[int],
        outputs: Sequence[int],
        params: Optional[Dict[str, Any]] = None,
    ) -> Node:
        n = Node(
            idx=len(self.nodes),
            name=name,
            op=op,
            params=dict(params or {}),
            inputs=list(inputs),
            outputs=list(outputs),
        )
        self.nodes.append(n)
        for ti in n.inputs:
            self.tensors[ti].consumers.append(n.idx)
        for ti in n.outputs:
            self.tensors[ti].producer = n.idx
        return n

    # ---- queries --------------------------------------------------------------

    @property
    def input_tensors(self) -> List[int]:
        """Tensor indices fed from outside (outputs of input nodes)."""
        out = []
        for ni in self.inputs:
            out.extend(self.nodes[ni].outputs)
        return out

    @property
    def output_tensors(self) -> List[int]:
        out = []
        for ni in self.outputs:
            out.extend(self.nodes[ni].outputs)
        return out

    def tensor(self, idx: int) -> Tensor:
        return self.tensors[idx]

    def node(self, idx: int) -> Node:
        return self.nodes[idx]

    def find_tensor(self, name: str) -> Optional[Tensor]:
        for t in self.tensors:
            if t.name == name:
                return t
        return None

    def toposorted(self) -> List[Node]:
        """Nodes in executable order.

        tmfile nodes are already stored in sequential order
        (`offset_vo_seq_nodes`, `tm2_format.h:292`), but imports from other
        front-ends may not be, so do a proper Kahn sort keyed on tensor
        availability.
        """
        ready = set()
        for t in self.tensors:
            if t.tensor_type in (TensorType.CONST, TensorType.INPUT) or t.producer is None:
                ready.add(t.idx)
        for ni in self.inputs:
            ready.update(self.nodes[ni].outputs)

        order: List[Node] = []
        # dead Noop shells (left by fusion passes) have no outputs — skip
        pending = [
            n for n in self.nodes if n.op not in ("Const", "InputOp") and n.outputs
        ]
        emitted = set()
        progress = True
        while pending and progress:
            progress = False
            rest = []
            for n in pending:
                if all(ti in ready for ti in n.inputs):
                    order.append(n)
                    emitted.add(n.idx)
                    ready.update(n.outputs)
                    progress = True
                else:
                    rest.append(n)
            pending = rest
        if pending:
            missing = [(n.name, [ti for ti in n.inputs if ti not in ready]) for n in pending]
            raise ValueError(f"graph has unsatisfiable nodes (cycle or dangling input): {missing}")
        return order

    def clone(self) -> "Graph":
        """Structural copy for compile-time graph rewrites: nodes/tensors and
        their param dicts/lists are fresh objects, but CONST `data` arrays
        (the model weights, possibly mmap views) are shared, so a clone is
        cheap even for large models."""
        import copy as _copy

        g = Graph(
            layout=self.layout,
            model_layout=self.model_layout,
            name=self.name,
            source_format=self.source_format,
        )
        g.inputs = list(self.inputs)
        g.outputs = list(self.outputs)
        for t in self.tensors:
            q = None
            if t.quant is not None:
                q = QuantParam(
                    t.quant.scales, t.quant.zero_points, t.quant.width,
                    t.quant.full_range,
                )
            g.tensors.append(
                Tensor(
                    idx=t.idx, name=t.name, dtype=t.dtype, shape=list(t.shape),
                    tensor_type=t.tensor_type, layout=t.layout, quant=q,
                    data=t.data, producer=t.producer, consumers=list(t.consumers),
                )
            )
        for n in self.nodes:
            g.nodes.append(
                Node(
                    idx=n.idx, name=n.name, op=n.op,
                    inputs=list(n.inputs), outputs=list(n.outputs),
                    params=_copy.deepcopy(n.params),
                )
            )
        return g

    def dump(self) -> str:
        """Readable graph listing (dump_ir_graph analog, graph/graph.c)."""
        lines = [
            f"graph {self.name!r} layout={self.layout.name} "
            f"nodes={len(self.nodes)} tensors={len(self.tensors)}"
        ]
        for n in self.nodes:
            ins = ", ".join(repr(self.tensors[i]) for i in n.inputs)
            outs = ", ".join(repr(self.tensors[i]) for i in n.outputs)
            lines.append(f"  [{n.idx:3d}] {n.op:20s} {n.name}  ({ins}) -> ({outs})")
        return "\n".join(lines)
