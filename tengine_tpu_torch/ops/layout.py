"""Activation-layout tracking for lowering (PyTorch port of
tengine_tpu/ops/layout.py).

The IR is NCHW (tmfile semantics, `graph/graph.h:57`). The engine tracks a
layout tag per activation: conv-family ops pull their inputs into NHWC and
emit NHWC; layout-sensitive ops pull back to NCHW. The port keeps the JAX
package's physical layouts so the two engines compare like with like. In
torch a layout change is a permuted view (no copy); a kernel that needs
contiguous memory makes it so itself.
"""

from __future__ import annotations

from typing import Optional

import torch


class TArr:
    """A tensor plus its current physical layout tag.

    layout is "NCHW"/"NHWC" for 4-D activations, None for everything else
    (meaning: physical == IR semantic order). Deliberately not a tuple:
    multi-output lowerings return plain tuples of TArr and the engine must be
    able to tell the two apart.
    """

    __slots__ = ("x", "layout")

    def __init__(self, x, layout: Optional[str] = None):
        self.x = x
        self.layout = layout

    @property
    def shape(self):
        return self.x.shape

    @property
    def dtype(self):
        return self.x.dtype

    def __repr__(self):
        return f"TArr({tuple(getattr(self.x, 'shape', ()))}, {self.layout})"


def wrap(x) -> TArr:
    return x if isinstance(x, TArr) else TArr(x, None)


def as_nhwc(t: TArr) -> torch.Tensor:
    if t.x.ndim != 4:
        raise ValueError(f"as_nhwc on rank-{t.x.ndim} tensor")
    if t.layout == "NHWC":
        return t.x
    return t.x.permute(0, 2, 3, 1)


def as_nchw(t: TArr) -> torch.Tensor:
    if t.layout == "NHWC":
        return t.x.permute(0, 3, 1, 2)
    return t.x


def as_semantic(t: TArr) -> torch.Tensor:
    """Tensor in IR semantic order (NCHW for 4-D)."""
    return as_nchw(t) if t.layout == "NHWC" else t.x


def nhwc(x) -> TArr:
    return TArr(x, "NHWC")


def nchw(x) -> TArr:
    return TArr(x, "NCHW" if hasattr(x, "ndim") and x.ndim == 4 else None)


def like(t: TArr, x) -> TArr:
    """Result of an elementwise op: same layout as its input."""
    return TArr(x, t.layout if x.ndim == t.x.ndim else None)
