"""Typed actor-pipeline mini-framework.

Reference: examples/pipeline/ — `pipeline::Node<Param<In...>, Param<Out...>>`
actors connected by `InstantEdge` queues, each node on its own thread
(examples/pipeline/graph/node.h:40+, actor/). Used there to pipeline
applications (camera -> detect -> landmark -> render) across threads while
each stage's model runs on its own device.

Here: `Node` wraps a callable (typically a CompiledGraph or pre/post-process
fn), `Edge` is a bounded queue, `Pipeline` wires nodes and runs each on a
thread. Stages overlap host preprocessing with device execution, as the
reference overlaps CPU stages with NPU inference; a CompiledGraph may be
called from any stage's thread (PyTorch port of
tengine_tpu/utils/pipeline.py, the same code).

    p = Pipeline()
    src = p.source(frames)                      # iterable -> edge
    det = p.node(detector_fn, src)              # each on its own thread
    emb = p.node(embedder_fn, det)
    results = p.run_to_list(emb)                # drives and drains
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, List, Optional

_STOP = object()


class Edge:
    """Bounded SPSC queue between two nodes (InstantEdge analog)."""

    def __init__(self, capacity: int = 8):
        self.q: "queue.Queue[Any]" = queue.Queue(maxsize=capacity)

    def put(self, item):
        self.q.put(item)

    def get(self):
        return self.q.get()


class Node:
    """One pipeline stage: pulls from `inputs`, applies `fn`, pushes to
    `output`. fn receives one positional arg per input edge. Returning
    `None` drops the item (filter); returning a `list` fans out items."""

    def __init__(self, fn: Callable, inputs: List[Edge], output: Edge, name: str = ""):
        self.fn = fn
        self.inputs = inputs
        self.output = output
        self.name = name or getattr(fn, "__name__", "node")
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True, name=self.name)

    def _loop(self):
        try:
            while True:
                args = [e.get() for e in self.inputs]
                if any(a is _STOP for a in args):
                    break
                out = self.fn(*args)
                if out is None:
                    continue
                if isinstance(out, list):
                    for item in out:
                        self.output.put(item)
                else:
                    self.output.put(out)
        except BaseException as e:  # surface in Pipeline.join
            self.error = e
        finally:
            self.output.put(_STOP)

    def start(self):
        self._thread.start()

    def join(self, timeout=None):
        self._thread.join(timeout)


class Pipeline:
    """Actor graph builder + runner."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self.nodes: List[Node] = []
        self._sources: List[tuple] = []

    def edge(self) -> Edge:
        return Edge(self.capacity)

    def source(self, items: Iterable) -> Edge:
        """Feed an iterable into the pipeline from its own thread."""
        e = self.edge()
        self._sources.append((items, e))
        return e

    def node(self, fn: Callable, *inputs: Edge, name: str = "") -> Edge:
        out = self.edge()
        n = Node(fn, list(inputs), out, name=name)
        self.nodes.append(n)
        return out

    def start(self):
        for n in self.nodes:
            n.start()
        for items, e in self._sources:
            def feed(items=items, e=e):
                for it in items:
                    e.put(it)
                e.put(_STOP)

            threading.Thread(target=feed, daemon=True).start()

    def run_to_list(self, out_edge: Edge, timeout: Optional[float] = 60.0) -> List[Any]:
        """Start the pipeline and drain `out_edge` until stop. Re-raises the
        first node error (graph status ERROR analog)."""
        self.start()
        results = []
        while True:
            item = out_edge.get()
            if item is _STOP:
                break
            results.append(item)
        for n in self.nodes:
            n.join(timeout)
            if n.error is not None:
                raise n.error
        return results
