"""Build and load the port's hand-written CUDA kernels.

Each source under tengine_tpu_torch/csrc/ has a plain C interface and is
compiled by nvcc for sm_90a (Hopper) into its own shared library, loaded
with ctypes. Libraries go to build/kernels/ at the repository root, named
by a hash of the source, every header under csrc/ and the flags, so an
edited source or header rebuilds and an unchanged one is reused. Nothing here runs at import time: a kernel is
built at its first launch, or ahead of time through build_all().
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # the requant epilogues must round a*b and +c separately, as the
    # reference's f32 epilogues do
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library goes: named by a digest of the source,
    of every csrc/*.cuh (name and bytes: any source may include any header)
    and of the flags."""
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, library_path(name))


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile the given kernel sources (default: every csrc/*.cu), one nvcc
    process per source, all started together."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with _LOCK:
        procs = [(n, _start_build(n)) for n in names]
        for n, proc in procs:
            _finish_build(n, proc)


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish_build(name, _start_build(name))
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
