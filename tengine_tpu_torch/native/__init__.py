"""Native (C++) host-side components and the C ABI, built at first use
(PyTorch port of tengine_tpu/native/__init__.py).

The device path is torch and the port's CUDA kernels; the native layer
covers the host-side hot paths the reference also keeps native: image
preprocessing (examples/common/tengine_operations.c analog), detection NMS
and tmfile parsing. improc.cc, postproc.cc and tm2_parser.cc are the JAX
package's sources, built with its g++ flags, so both packages compute the
same bytes. The library goes to build/native/ at the repository root, named
by a digest of the sources and the flags (as ops/cuda/build.py names the
kernels' libraries): an edited source rebuilds, an unchanged one is reused.

Every function has a numpy branch, the plain version, so that the package
works without a toolchain; taking it logs a warning. chip_smoke.py requires
the native library on the card's machine.

build_capi builds the C ABI (c_api_shim.c, Tengine's c_api.h over
capi_bridge.py) with gcc into the same directory: the library a C program
links to embed the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.log import logger

NATIVE_DIR = Path(__file__).resolve().parent
SOURCES = tuple(NATIVE_DIR / f for f in ("improc.cc", "tm2_parser.cc", "postproc.cc"))
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_WARNED = set()

_u8p = _f32p = _i32p = _vp = ctypes.c_void_p
# name -> (restype, argtypes) of every entry point (the signatures in the .cc files)
_SIGNATURES = {
    "tt_resize_bilinear_u8": (None, [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
                                     ctypes.c_int, ctypes.c_int]),
    "tt_normalize_chw_f32": (None, [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _f32p,
                                    _f32p, _f32p]),
    "tt_quantize_u8": (None, [_f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int, _u8p]),
    "tt_letterbox_u8": (None, [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_uint8]),
    "tt_preprocess_batch": (None, [_vp, _i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, _f32p, _f32p, ctypes.c_int, ctypes.c_float,
                                   ctypes.c_int, _vp, ctypes.c_int]),
    "tt_tm2_scan_buffers": (ctypes.c_long, [_u8p, ctypes.c_long, _vp, ctypes.c_long]),
    "tt_tm2_parse": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_long,
                                    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                    ctypes.POINTER(ctypes.c_long)]),
    "tt_buffer_free": (None, [ctypes.POINTER(ctypes.c_uint8)]),
    "tt_last_error": (ctypes.c_char_p, []),
    "tt_nms": (ctypes.c_long, [_f32p, _f32p, ctypes.c_long, ctypes.c_float, _i32p,
                               ctypes.c_long]),
}


def library_path() -> Path:
    """Where the library goes: named by a digest of every source (name and
    bytes) and of the compiler flags."""
    h = hashlib.sha1()
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtengine_native-{h.hexdigest()[:12]}.so"


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            path = library_path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            logger.warning("native library unavailable (%s %s); using the numpy versions",
                           e, detail.decode("utf-8", "replace")[-500:])
            _LIB = None
        return _LIB


def available() -> bool:
    return _build_and_load() is not None


def _plain(name: str) -> None:
    """Warn, once a function, that its numpy version runs."""
    if name not in _WARNED:
        _WARNED.add(name)
        logger.warning("native library unavailable: %s runs its numpy version", name)


def _cptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _resize_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel bilinear resize in numpy (the JAX package's fallback)."""
    h, w, c = img.shape
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    v = (
        img[y0][:, x0] * (1 - wy) * (1 - wx)
        + img[y0][:, x1] * (1 - wy) * wx
        + img[y1][:, x0] * wy * (1 - wx)
        + img[y1][:, x1] * wy * wx
    )
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """HWC uint8 bilinear resize (tengine_operations.c resize_image)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    lib = _build_and_load()
    if lib is None:
        _plain("resize_bilinear")
        return _resize_np(img, out_h, out_w)
    out = np.empty((out_h, out_w, c), np.uint8)
    lib.tt_resize_bilinear_u8(_cptr(img), h, w, c, _cptr(out), out_h, out_w)
    return out


def normalize_chw(img: np.ndarray, mean, scale) -> np.ndarray:
    """HWC uint8 -> CHW fp32, (x - mean[c]) * scale[c]."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    mean = np.ascontiguousarray(mean, np.float32)
    scale = np.ascontiguousarray(scale, np.float32)
    lib = _build_and_load()
    if lib is None:
        _plain("normalize_chw")
        return ((img.astype(np.float32) - mean) * scale).transpose(2, 0, 1)
    out = np.empty((c, h, w), np.float32)
    lib.tt_normalize_chw_f32(_cptr(img), h, w, c, _cptr(mean), _cptr(scale), _cptr(out))
    return out


def quantize_u8(x: np.ndarray, scale: float, zero_point: int) -> np.ndarray:
    """fp32 -> uint8 input quantization (tm_classification_uint8.c)."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _build_and_load()
    if lib is None:
        _plain("quantize_u8")
        return np.clip(np.rint(x / scale) + zero_point, 0, 255).astype(np.uint8)
    out = np.empty(x.shape, np.uint8)
    lib.tt_quantize_u8(_cptr(x), x.size, float(scale), int(zero_point), _cptr(out))
    return out


def letterbox(img: np.ndarray, out_h: int, out_w: int, pad_value: int = 114) -> np.ndarray:
    """Resize keeping the aspect ratio, centred, padded with pad_value."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    lib = _build_and_load()
    if lib is not None:
        out = np.empty((out_h, out_w, c), np.uint8)
        lib.tt_letterbox_u8(_cptr(img), h, w, c, _cptr(out), out_h, out_w, int(pad_value))
        return out
    _plain("letterbox")
    r = min(out_h / h, out_w / w)
    nh, nw = round(h * r), round(w * r)
    resized = _resize_np(img, nh, nw)
    out = np.full((out_h, out_w, c), pad_value, np.uint8)
    oy, ox = (out_h - nh) // 2, (out_w - nw) // 2
    out[oy : oy + nh, ox : ox + nw] = resized
    return out


def preprocess_batch(
    images,
    out_h: int,
    out_w: int,
    mean,
    scale,
    quant: Optional[tuple] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Threaded batch preprocessing (resize -> normalize -> optional input
    quantization) into one [N,C,H,W] array, the data-loader hot path
    (improc.cc:tt_preprocess_batch). `quant` = (scale, zero_point) for uint8
    model inputs; None for fp32. n_threads 0 takes one thread a core."""
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    n = len(images)
    c = images[0].shape[2] if n else 3
    mean = np.ascontiguousarray(mean, np.float32)
    scale = np.ascontiguousarray(scale, np.float32)
    lib = _build_and_load()
    if lib is not None and n:
        ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
        dims = np.asarray([[im.shape[0], im.shape[1]] for im in images], np.int32)
        if quant is None:
            out = np.empty((n, c, out_h, out_w), np.float32)
            qflag, qs, qzp = 0, 1.0, 0
        else:
            out = np.empty((n, c, out_h, out_w), np.uint8)
            qflag, (qs, qzp) = 1, quant
        lib.tt_preprocess_batch(
            ctypes.cast(ptrs, ctypes.c_void_p), _cptr(dims), n, c, out_h, out_w, _cptr(mean),
            _cptr(scale), qflag, float(qs), int(qzp), _cptr(out), int(n_threads),
        )
        return out
    if lib is None:
        _plain("preprocess_batch")
    outs = []
    for im in images:
        r = _resize_np(im, out_h, out_w)
        v = ((r.astype(np.float32) - mean) * scale).transpose(2, 0, 1)
        if quant is not None:
            qs, qzp = quant
            v = np.clip(np.rint(v / qs) + qzp, 0, 255).astype(np.uint8)
        outs.append(v)
    dtype = np.uint8 if quant is not None else np.float32
    return np.stack(outs).astype(dtype) if outs else np.empty((0, c, out_h, out_w), dtype)


def tm2_parse(data: bytes) -> Optional[bytes]:
    """Full native TM2 parse -> wire buffer (see tm2_parser.cc), or None when
    the native library is unavailable. Raises ValueError on malformed files."""
    lib = _build_and_load()
    if lib is None:
        _plain("tm2_parse")
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_long()
    with _LOCK:  # tt_last_error reads one buffer that every parse writes
        rc = lib.tt_tm2_parse(data, len(data), ctypes.byref(out), ctypes.byref(out_len))
        if rc != 0:
            raise ValueError("native tm2 parse: " + lib.tt_last_error().decode("utf-8", "replace"))
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.tt_buffer_free(out)


def _nms_np(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
            max_out: int) -> np.ndarray:
    """Hard NMS in numpy (the JAX package's fallback). It parts from
    postproc.cc on boxes whose union is at most 1e-9: numpy divides by
    max(union, 1e-9), the C++ takes the IoU as 0 (ROADMAP §3)."""
    n = len(scores)
    order = np.argsort(-scores, kind="stable")
    keep_list = []
    suppressed = np.zeros(n, bool)
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    for i in order:
        if suppressed[i]:
            continue
        keep_list.append(i)
        if len(keep_list) >= max_out:
            break
        xx1 = np.maximum(boxes[i, 0], boxes[order, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[order, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[order, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[order, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[order] - inter, 1e-9)
        suppressed[order[iou > iou_threshold]] = True
    return np.asarray(keep_list, np.int32)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
        max_out: int = 0) -> np.ndarray:
    """Hard NMS on [N,4] x1y1x2y2 boxes; returns kept indices sorted by score
    (examples/common NMS loop)."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(scores)
    if max_out <= 0:
        max_out = n
    lib = _build_and_load()
    if lib is None:
        _plain("nms")
        return _nms_np(boxes, scores, iou_threshold, max_out)
    keep = np.empty(min(n, max_out), np.int32)
    m = lib.tt_nms(_cptr(boxes), _cptr(scores), n, float(iou_threshold), _cptr(keep), len(keep))
    return keep[:m]


def tm2_scan_buffers(data: bytes) -> Optional[np.ndarray]:
    """Const-buffer table [(tensor_id, offset, size)] via the native scanner;
    None when the native library is unavailable."""
    lib = _build_and_load()
    if lib is None:
        _plain("tm2_scan_buffers")
        return None
    buf = np.frombuffer(data, np.uint8)
    table = np.zeros((65536, 3), np.uint64)
    n = lib.tt_tm2_scan_buffers(_cptr(buf), len(data), _cptr(table), 65536)
    if n < 0:
        raise ValueError("native tm2 scan: malformed tmfile")
    return table[:n]


CAPI_SOURCE = NATIVE_DIR / "c_api_shim.c"
_CAPI_LOCK = threading.Lock()


def shared_libpython() -> Optional[Path]:
    """The running interpreter's shared libpython, or None where it has none
    (a statically linked python: the C ABI then works in attach mode only,
    loaded into a Python process, whose executable provides the symbols)."""
    import sysconfig

    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        return None
    lib = Path(sysconfig.get_config_var("LIBDIR") or "/") / (
        sysconfig.get_config_var("LDLIBRARY") or "")
    return lib if lib.is_file() else None


def capi_flags() -> list:
    """gcc's flags for the C ABI: linked with the shared libpython where
    this python has one (embed mode: a C program links the library and it
    starts the interpreter), without it otherwise (attach mode only)."""
    import sysconfig

    flags = ["-O2", "-fPIC", "-shared", f"-I{sysconfig.get_paths()['include']}"]
    lib = shared_libpython()
    if lib is not None:
        flags += [str(lib), f"-Wl,-rpath,{lib.parent}"]
    return flags


def capi_library_path() -> Path:
    """Where the C ABI goes: named by a digest of the shim's source and the
    flags."""
    h = hashlib.sha1(CAPI_SOURCE.read_bytes())
    h.update(" ".join(capi_flags()).encode())
    return BUILD_DIR / f"libtengine_tpu_torch_capi-{h.hexdigest()[:12]}.so"


def build_capi() -> Path:
    """Build libtengine_tpu_torch_capi-<digest>.so, the C ABI embedding
    surface (c_api_shim.c, a drop-in subset of the reference's c_api.h), and
    return its path. The library is written to a temporary file and
    renamed, so that concurrent builds race safely. Raises with the
    compiler's output if gcc fails."""
    with _CAPI_LOCK:
        path = capi_library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run(["gcc", str(CAPI_SOURCE), *capi_flags(), "-o", str(tmp)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"build_capi: gcc failed (exit {r.returncode}):\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, path)
        return path
