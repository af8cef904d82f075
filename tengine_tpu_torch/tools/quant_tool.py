"""PTQ quantization tool — quant_tool_int8/uint8 equivalent
(tools/quantize/quant_tool_int8.cpp); the port of tools/quant_tool.py.

Loads an fp32 tmfile, calibrates on images (or random data), quantizes, and
writes a quantized tmfile. Also reports per-layer cosine similarity vs the
fp32 graph — the reference's "Step Evaluate" quality gate
(tools/quantize/README.md). Calibration and the report run on the card
unless --device names another.

    python -m tengine_tpu_torch.tools.quant_tool -m fp32.tmfile -o int8.tmfile -t int8 -a kl \\
        -i calib_dir/ --input-shape 1,3,224,224
"""

import argparse
import os
import sys

import numpy as np


def load_calibration(args, shape):
    """Calibration batches: image dir (decoded via PIL if available) or
    synthetic random data."""
    if args.images and os.path.isdir(args.images):
        try:
            from ..utils.data import ImageBatchLoader, list_images

            files = list_images(args.images)[: args.num_images]
            loader = ImageBatchLoader(
                files, (shape[2], shape[3]), batch_size=1,
                mean=args.mean, scale=args.scale,
            )
            batches = [batch for batch, _ in loader]
            if batches:
                return batches
        except ImportError:
            print("PIL unavailable; falling back to random calibration", file=sys.stderr)
    rng = np.random.default_rng(0)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(args.num_images)]


def run_all(graph, x, device):
    """Every tensor of the graph's forward on x ({tensor id: numpy array}),
    run eagerly on `device` under default Options: the engine's forward
    with return_all, outside compile_graph's passes, as the JAX report
    runs it. Every quantized activation comes back in its 1-byte dtype."""
    import torch

    from ..executor.engine import ParamStore, build_forward
    from ..utils.config import Options

    store = ParamStore()
    forward_all, _, _ = build_forward(graph, Options(), store, return_all=True)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    with torch.inference_mode():
        forward_all({}, xt.to("meta"))  # the prepare pass fills the store
        env = forward_all(store.upload(device), xt.to(device))
    return {tid: v.cpu().numpy() for tid, v in env.items()}


def cosine_report(g, qg, x, device):
    """Per-layer cosine similarity fp32-vs-quantized (quant tool 'Step
    Evaluate' analog). Returns {tensor name: cosine}."""
    from ..ops import qmath

    env_f = run_all(g, x, device)
    t_in = qg.tensors[qg.input_tensors[0]]
    env_q = run_all(qg, qmath.quantize_np(x, t_in.quant, t_in.dtype), device)

    print(f"{'tensor':40} {'cosine':>8}")
    cosines = {}
    for tid, arr in env_f.items():
        if tid not in env_q:
            continue
        t = qg.tensors[tid]
        a = np.asarray(arr, np.float32).reshape(-1)
        b = env_q[tid]
        if t.quant is not None:
            if b.dtype not in (np.uint8, np.int8):
                raise TypeError(f"quantized tensor {t.name!r} came back as {b.dtype}")
            b = qmath.dequantize_np(b, t.quant)
        b = b.reshape(-1).astype(np.float32)
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        cos = float(a @ b / denom) if denom > 0 else 1.0
        cosines[t.name] = cos
        print(f"{t.name[:40]:40} {cos:8.4f}")
    return cosines


def top1_agreement(g, qg, inputs, device):
    """Top-1 agreement fp32 vs quantized over the calibration set — the
    measurable stand-in for 'top-1 Δ vs FP32 at the same bit-width' when no
    labeled dataset is wired in: a quantization whose argmax matches fp32 on
    every input has Δtop-1 = 0 on that set."""
    from ..executor.engine import compile_graph
    from ..ops import qmath
    from ..utils.config import Options

    cg_f = compile_graph(g, Options(precision="fp32"), device=device)
    cg_q = compile_graph(qg, Options(quant_mode="fast"), device=device)
    t_in = qg.tensors[qg.input_tensors[0]]
    match = total = 0
    for x in inputs:
        (yf,) = cg_f.run(x)
        (yq,) = cg_q.run(qmath.quantize_np(x, t_in.quant, t_in.dtype))
        af = yf.reshape(yf.shape[0], -1).argmax(axis=1)
        aq = np.asarray(yq, np.float32).reshape(yq.shape[0], -1).argmax(axis=1)
        match += int((af == aq).sum())
        total += len(af)
    pct = 100.0 * match / max(total, 1)
    print(f"top-1 agreement fp32 vs quantized: {match}/{total} = {pct:.1f}%")
    return pct


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True, help="input fp32 tmfile")
    ap.add_argument("-o", "--output", required=True, help="output quantized tmfile")
    ap.add_argument("-t", "--type", default="uint8", choices=["uint8", "int8"])
    ap.add_argument("-a", "--algorithm", default="minmax",
                    choices=["minmax", "kl", "aciq"])
    ap.add_argument("-i", "--images", default=None, help="calibration image dir")
    ap.add_argument("-n", "--num-images", type=int, default=8)
    ap.add_argument("--input-shape", default=None, help="n,c,h,w if absent from model")
    ap.add_argument("--mean", type=float, nargs=3, default=[104.0, 117.0, 123.0])
    ap.add_argument("--scale", type=float, nargs=3, default=[1.0, 1.0, 1.0])
    ap.add_argument("--evaluate", action="store_true", help="per-layer cosine report")
    ap.add_argument("--dfq", action="store_true",
                    help="cross-layer weight equalization before quantizing "
                         "(quant_dfq.cpp analog)")
    ap.add_argument("--bias-correction", action="store_true",
                    help="empirical per-channel bias correction after "
                         "quantizing (quant_eq.cpp analog)")
    ap.add_argument("--device", default=None,
                    help="torch device for calibration and the report "
                         "(default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    from .. import load_model
    from ..executor.engine import resolve_device
    from ..quantize.quantizer import quantize_graph
    from ..serializer.tm2.writer import save_tmfile

    device = resolve_device(args.device)
    g = load_model(args.model)
    tid = g.input_tensors[0]
    if args.input_shape:
        g.tensors[tid].shape = [int(v) for v in args.input_shape.split(",")]
    shape = [int(d) for d in g.tensors[tid].shape]
    if not shape:
        ap.error("model has no input shape; pass --input-shape")

    calib = load_calibration(args, shape)
    print(f"calibrating on {len(calib)} batches, scheme={args.type}, "
          f"algorithm={args.algorithm}")
    if args.dfq:
        from ..quantize.dfq import equalize_graph

        n = equalize_graph(g)
        print(f"dfq: equalized {n} conv pairs")
    qg = quantize_graph(g, calib, scheme=args.type, algorithm=args.algorithm, device=device)
    if args.bias_correction:
        from ..quantize.dfq import bias_correction

        n = bias_correction(g, qg, calib, device=device)
        print(f"bias-correction: adjusted {n} nodes")
    save_tmfile(qg, args.output)
    print(f"wrote {args.output}")

    result = {"graph": qg, "calibration": calib}
    if args.evaluate:
        result["cosines"] = cosine_report(g, qg, calib[0], device)
        if len(g.output_tensors) == 1:
            result["top1"] = top1_agreement(g, qg, calib, device)
    return result


if __name__ == "__main__":
    main()
