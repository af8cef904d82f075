"""Numeric alignment checker — align_with_onnx.py equivalent
(tools/align_tool/align_with_onnx.py in the reference, which diffs tmfile
execution against onnxruntime); the port of tools/align_tool.py.

Here the oracles are layered: fast-tier kernels vs the bit-faithful ref tier
(the TG_DEBUG_REF analog), both on the card unless --device names another,
and — when the reference C engine has been built (tools/build_reference.sh)
— the ref tier vs the reference's own output on the same tmfile.

    python -m tengine_tpu_torch.tools.align_tool -m model.tmfile [--input-shape 1,3,224,224]
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

REF_BUILD = "/tmp/tengine-build"


def pytengine_dir():
    """The reference's Python binding (pytengine/ of the Tengine checkout
    named by TENGINE_SOURCE)."""
    src = os.environ.get("TENGINE_SOURCE")
    if not src:
        raise RuntimeError("TENGINE_SOURCE (the Tengine checkout that holds pytengine/) is not set")
    return os.path.join(src, "pytengine")


def cosine(a, b):
    a = a.reshape(-1).astype(np.float64)
    b = b.reshape(-1).astype(np.float64)
    n = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / n) if n else 1.0


def run_reference_engine(model, x):
    """Run the tmfile in the reference C engine via pytengine in a
    subprocess (its ctypes wrapper has destructor issues in-process)."""
    script = r"""
import sys, numpy as np
sys.path.insert(0, sys.argv[4])
from tengine import tg
model, inp, out = sys.argv[1], sys.argv[2], sys.argv[3]
x = np.load(inp)
graph = tg.Graph(None, "tengine", model)
t = graph.getInputTensor(0, 0)
t.shape = list(x.shape)
graph.preRun()
t.buf = np.ascontiguousarray(x)
graph.run(1)
np.save(out, graph.getOutputTensor(0, 0).getNumpyData())
"""
    env = dict(os.environ, LD_LIBRARY_PATH=f"{REF_BUILD}/source")
    binding = pytengine_dir()
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "align_in.npy"), os.path.join(tmp, "align_out.npy")
        np.save(inp, x)
        r = subprocess.run(
            [sys.executable, "-c", script, model, inp, out, binding],
            env=env, capture_output=True, text=True, timeout=600,
        )
        if r.returncode != 0:
            raise RuntimeError(f"reference engine failed:\n{r.stderr[-2000:]}")
        return np.load(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True, help="tmfile to check")
    ap.add_argument("--input-shape", default=None, help="n,c,h,w")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    from .. import compile_graph, load_model
    from ..executor.engine import resolve_device
    from ..ops import qmath
    from ..utils.config import Options

    device = resolve_device(args.device)
    g = load_model(args.model)
    for tid in g.input_tensors:
        t = g.tensors[tid]
        if args.input_shape:
            t.shape = [int(v) for v in args.input_shape.split(",")]
        if not t.shape:
            ap.error("model has no input shape; pass --input-shape")
    t_in = g.tensors[g.input_tensors[0]]

    rng = np.random.default_rng(args.seed)
    xf = rng.standard_normal(t_in.shape).astype(np.float32)
    x = (
        qmath.quantize_np(xf, t_in.quant, t_in.dtype)
        if qmath.is_quantized_tensor(t_in)
        else xf
    )

    (y_fast,) = compile_graph(g, Options(quant_mode="fast"), device=device).run(x)
    (y_ref,) = compile_graph(g, Options(quant_mode="ref"), device=device).run(x)
    d = np.abs(y_fast.astype(np.float64) - y_ref.astype(np.float64))
    result = {"fast": y_fast, "ref": y_ref, "max_abs": float(d.max()),
              "cosine": cosine(y_fast, y_ref)}
    print(f"fast vs ref tier : max|d|={d.max():.6g}  cosine={result['cosine']:.6f}")

    if os.path.isdir(REF_BUILD):
        try:
            y_c = run_reference_engine(args.model, x)
            d = np.abs(y_ref.astype(np.float64) - y_c.reshape(y_ref.shape).astype(np.float64))
            print(
                f"ref tier vs C engine: max|d|={d.max():.6g}  "
                f"cosine={cosine(y_ref, y_c):.6f}"
            )
            result["c_engine"] = y_c
        except Exception as e:
            print(f"reference C engine comparison skipped: {e}")
    else:
        print(f"reference C engine not built ({REF_BUILD}); run tools/build_reference.sh")
    return result


if __name__ == "__main__":
    main()
