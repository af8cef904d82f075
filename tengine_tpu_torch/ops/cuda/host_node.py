"""An embedder's C custom kernel (set_custom_kernel, c_api.h:742) inside the
forward: on the card a host node of the captured CUDA graph (csrc/host_node.cu),
on the CPU a direct call, and the wrapper that picks between them by device.

Replaces no TPU kernel: the JAX package runs the embedder's ops->run() as a
jax.pure_callback (tengine_tpu/capi_bridge.py:_lower_custom_kernel). Here
run() sees struct custom_kernel_tensor views (c_api.h:183-216) over
contiguous host memory in NCHW order, as there:

  * CPU tensors: run() is called on the inputs' own memory and writes the
    output tensor's (custom_kernel_plain);
  * CUDA tensors: csrc/host_node.cu records on the current stream an async
    copy of each input into a page-locked staging buffer, run() as a host
    function (cudaLaunchHostFunc) over views of those buffers, and an async
    copy of the output back. Under capture the three become nodes of the CUDA
    graph, and a replay calls run() from CUDA's own thread with no Python.

The staging buffers and views of a node and input signature are allocated
when the forward first runs outside a capture (the warm-up forward that
precedes each capture, or an eager forward) and kept until release(); a
capture only looks them up, since page-locked allocation is no stream work
and a capture must not depend on it.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Sequence, Tuple

import torch

SOURCE = "tengine_tpu_torch/csrc/host_node.cu"

MAX_DIM = 8  # MAX_SHAPE_DIM_NUM (c_api.h:55)
# TENGINE_DT_* (c_api.h:58-63)
_DT_CODE = {torch.float32: 0, torch.float16: 1, torch.int8: 2, torch.uint8: 3,
            torch.int32: 4, torch.int16: 5}


class CKTensor(ctypes.Structure):
    """struct custom_kernel_tensor (c_api.h:183-216)."""

    _fields_ = [
        ("dim", ctypes.c_int * MAX_DIM),
        ("dim_num", ctypes.c_int),
        ("element_num", ctypes.c_int),
        ("element_size", ctypes.c_int),
        ("data_type", ctypes.c_int),
        ("dev_type", ctypes.c_int),
        ("layout_type", ctypes.c_int),
        ("quant_type", ctypes.c_int),
        ("scale", ctypes.POINTER(ctypes.c_float)),
        ("zero_point", ctypes.POINTER(ctypes.c_int)),
        ("quant_number", ctypes.POINTER(ctypes.c_int)),
        ("data", ctypes.c_void_p),
        ("dev_mem", ctypes.c_void_p),
        ("mapped_mem", ctypes.c_void_p),
    ]


RUN_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(CKTensor)), ctypes.c_int,
    ctypes.POINTER(ctypes.POINTER(CKTensor)), ctypes.c_int)
INFER_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_int)), ctypes.c_int,
    ctypes.POINTER(ctypes.POINTER(ctypes.c_int)), ctypes.c_int, ctypes.c_int)


class CKOps(ctypes.Structure):
    """struct custom_kernel_ops (c_api.h:218-309)."""

    _fields_ = [
        ("kernel_name", ctypes.c_char_p),
        ("op", ctypes.c_char_p),
        ("force", ctypes.c_int),
        ("kernel_param", ctypes.c_void_p),
        ("kernel_param_size", ctypes.c_int),
        ("infer_shape", INFER_FN),
        ("inplace_info", ctypes.c_void_p),
        ("bind", ctypes.c_void_p),
        ("prerun", ctypes.c_void_p),
        ("reshape", ctypes.c_void_p),
        ("run", RUN_FN),
        ("postrun", ctypes.c_void_p),
        ("release", ctypes.c_void_p),
    ]


class HostNode(ctypes.Structure):
    """struct HostNode of csrc/host_node.cu, field for field."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in
         ("ops", "run", "ins", "outs", "h_in", "h_out", "in_bytes", "out_bytes")]
        + [(f, ctypes.c_int) for f in ("n_in", "n_out", "rc", "calls")]
    )


def ck_view(t: torch.Tensor) -> CKTensor:
    """A custom_kernel_tensor over a contiguous host tensor (NCHW order)."""
    if t.ndim > MAX_DIM:
        raise ValueError(f"custom kernel tensors have at most {MAX_DIM} dims, got {t.ndim}")
    v = CKTensor()
    for i, d in enumerate(t.shape):
        v.dim[i] = int(d)
    v.dim_num = t.ndim
    v.element_num = t.numel()
    v.element_size = t.element_size()
    v.data_type = _DT_CODE.get(t.dtype, 0)
    v.layout_type = 0  # NCHW semantic order
    v.data = t.data_ptr()
    return v


def _pointers(views: Sequence[CKTensor]):
    return (ctypes.POINTER(CKTensor) * len(views))(*[ctypes.pointer(v) for v in views])


def infer_out_shape(ops_addr: int, in_shapes: Sequence[Tuple[int, ...]]) -> Tuple[int, ...]:
    """The output shape by ops->infer_shape, or the first input's shape
    where the embedder gives none (tengine_tpu/capi_bridge.py:
    _ck_infer_out_shape)."""
    ops = CKOps.from_address(ops_addr)
    if not ops.infer_shape:
        return tuple(in_shapes[0])
    ibufs = [(ctypes.c_int * MAX_DIM)(*list(s) + [0] * (MAX_DIM - len(s))) for s in in_shapes]
    iptr = (ctypes.POINTER(ctypes.c_int) * len(ibufs))(
        *[ctypes.cast(b, ctypes.POINTER(ctypes.c_int)) for b in ibufs])
    obuf = (ctypes.c_int * MAX_DIM)()
    optr = (ctypes.POINTER(ctypes.c_int) * 1)(ctypes.cast(obuf, ctypes.POINTER(ctypes.c_int)))
    if ops.infer_shape(ops_addr, iptr, len(ibufs), optr, 1, 0) != 0:
        raise RuntimeError("custom kernel infer_shape failed")
    out = tuple(int(d) for d in obuf if d != 0)
    return out or tuple(in_shapes[0])


def custom_kernel_plain(ops_addr: int, xs: Sequence[torch.Tensor], out_shape, out_dtype):
    """The plain version: ops->run() called directly over the CPU tensors'
    own memory. Raises if run() returns non-zero."""
    ins = [x.contiguous() for x in xs]
    out = torch.zeros(out_shape, dtype=out_dtype)
    ick, ock = [ck_view(t) for t in ins], [ck_view(out)]
    rc = CKOps.from_address(ops_addr).run(ops_addr, _pointers(ick), len(ick), _pointers(ock), 1)
    if rc != 0:
        raise RuntimeError(f"custom kernel run() returned {rc}")
    return out


class Staging:
    """A node's page-locked staging buffers for one input signature, the
    custom_kernel_tensor views over them and the HostNode that
    csrc/host_node.cu reads: all kept alive together, since a captured graph
    holds their addresses."""

    def __init__(self, ops_addr: int, xs: Sequence[torch.Tensor], out_shape, out_dtype):
        self.h_in = [torch.empty(tuple(x.shape), dtype=x.dtype, pin_memory=True) for x in xs]
        self.h_out = [torch.empty(out_shape, dtype=out_dtype, pin_memory=True)]
        self.views_in = [ck_view(t) for t in self.h_in]
        self.views_out = [ck_view(t) for t in self.h_out]
        self.ins, self.outs = _pointers(self.views_in), _pointers(self.views_out)
        n_in, n_out = len(self.h_in), len(self.h_out)
        self.h_in_ptrs = (ctypes.c_void_p * max(n_in, 1))(*[t.data_ptr() for t in self.h_in])
        self.h_out_ptrs = (ctypes.c_void_p * n_out)(*[t.data_ptr() for t in self.h_out])
        self.in_bytes = (ctypes.c_longlong * max(n_in, 1))(
            *[t.numel() * t.element_size() for t in self.h_in])
        self.out_bytes = (ctypes.c_longlong * n_out)(
            *[t.numel() * t.element_size() for t in self.h_out])
        run = ctypes.c_void_p.from_address(ops_addr + CKOps.run.offset).value
        self.node = HostNode(
            ops=ops_addr, run=run, ins=ctypes.addressof(self.ins),
            outs=ctypes.addressof(self.outs), h_in=ctypes.addressof(self.h_in_ptrs),
            h_out=ctypes.addressof(self.h_out_ptrs), in_bytes=ctypes.addressof(self.in_bytes),
            out_bytes=ctypes.addressof(self.out_bytes), n_in=n_in, n_out=n_out, rc=0, calls=0)


_LOCK = threading.Lock()
_STAGING: Dict[tuple, Staging] = {}


def staging(key: tuple) -> List[Staging]:
    """The staging of every signature allocated under `key` (a node's)."""
    with _LOCK:
        return [s for k, s in _STAGING.items() if k[0] == key]


def release(key: tuple) -> None:
    """Free the staging allocated under `key`. The CUDA graphs that recorded
    it must be gone first."""
    with _LOCK:
        for k in [k for k in _STAGING if k[0] == key]:
            del _STAGING[k]


def _staging_for(key, ops_addr, xs, out_shape, out_dtype) -> Staging:
    sig = (key, ops_addr, tuple((tuple(x.shape), x.dtype) for x in xs), tuple(out_shape),
           out_dtype)
    capturing = torch.cuda.is_current_stream_capturing()
    with _LOCK:
        st = _STAGING.get(sig)
        if st is None:
            if capturing:
                raise RuntimeError(
                    f"custom kernel {key}: no staging buffers for {sig[2]}; the forward that "
                    "precedes a capture allocates them")
            st = _STAGING[sig] = Staging(ops_addr, xs, out_shape, out_dtype)
    return st


@functools.lru_cache(maxsize=None)
def _launcher():
    """csrc/host_node.cu's launch function, built at first use; its HostNode
    must be the mirror's size."""
    from .build import load

    lib = load("host_node")
    if lib.tt_host_node_size() != ctypes.sizeof(HostNode):
        raise RuntimeError("host_node: the HostNode mirror disagrees with csrc/host_node.cu")
    fn = lib.tt_host_node_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4
    return fn


def _launch(key, ops_addr, xs, out_shape, out_dtype) -> torch.Tensor:
    """Record the staging copies and run() as a host function on the current
    stream (csrc/host_node.cu). Raises if a launch returns a CUDA error."""
    xs = [x.contiguous() for x in xs]
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("custom kernel: all inputs must be on one device")
    st = _staging_for(key, ops_addr, xs, out_shape, out_dtype)
    out = torch.empty(out_shape, dtype=out_dtype, device=dev)
    d_in = (ctypes.c_void_p * max(len(xs), 1))(*[x.data_ptr() for x in xs])
    d_out = (ctypes.c_void_p * 1)(out.data_ptr())
    rc = _launcher()(ctypes.addressof(st.node), d_in, d_out,
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"custom kernel {key}: host node launch failed with CUDA error {rc}")
    custom_kernel.launches += 1
    return out


def custom_kernel(key, ops_addr: int, xs: Sequence[torch.Tensor], out_shape, out_dtype):
    """The embedder's ops->run() on xs (NCHW), one output of out_shape and
    out_dtype. On CUDA tensors the staged host node on the current stream
    (or a raise), on CPU tensors custom_kernel_plain, on meta tensors an
    empty output. key names the node (its staging); custom_kernel.launches
    counts host-node launches."""
    if all(x.device.type == "meta" for x in xs):
        return torch.empty(out_shape, dtype=out_dtype, device="meta")
    if all(x.is_cuda for x in xs):
        return _launch(key, ops_addr, xs, out_shape, out_dtype)
    if all(x.device.type == "cpu" for x in xs):
        return custom_kernel_plain(ops_addr, xs, out_shape, out_dtype)
    raise ValueError(f"custom kernel: no version for devices {[str(x.device) for x in xs]}")


custom_kernel.launches = 0
