"""tm_benchmark equivalent (benchmark/tm_benchmark.cc): run the reference's
benchmark tmfiles on the card and print a min/avg latency table; the port of
tools/benchmark.py.

The tmfiles are read from the zoo's directory, benchmark/models relative to
the working directory (models/zoo.py). Each net is timed through its
captured forward (CompiledGraph.__call__) after one untimed call that
captures it: CUDA events around each call on the card, the host clock on
the CPU. A net that fails prints a FAILED line; the process then exits 1.

    python -m tengine_tpu_torch.tools.benchmark                 # all nets, fp32
    python -m tengine_tpu_torch.tools.benchmark -m mobilenetv1 -b 8 -p bf16
    python -m tengine_tpu_torch.tools.benchmark --uint8        # full-integer quantized run
"""

import argparse
import sys
import time

import numpy as np


def measure(cg, x, n):
    """(min, mean) ms of n calls of cg(x) after one untimed call (the
    capture on the card)."""
    import torch

    cg(x)
    cuda = x.device.type == "cuda"
    ms = []
    for _ in range(n):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            cg(x)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            cg(x)
            ms.append((time.perf_counter() - t0) * 1e3)
    return min(ms), float(np.mean(ms))


def main(argv=None, keep=False):
    """Returns {"rows": [{name, min_ms, avg_ms, img_s}], "failed": {name:
    error}}; with keep, each row also holds its CompiledGraph ("cg") and
    device input ("x")."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", default=None, help="single net name (default: all)")
    ap.add_argument("-b", "--batch", type=int, default=1)
    ap.add_argument("-p", "--precision", default="fp32_fast",
                    choices=["fp32", "fp32_fast", "bf16"])
    ap.add_argument("--uint8", action="store_true", help="quantize (MinMax) and run UINT8")
    ap.add_argument("-r", "--repeat", type=int, default=21)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from ..executor.engine import compile_graph, resolve_device
    from ..models.zoo import BENCHMARK_MODELS, load_benchmark_model
    from ..ops import qmath
    from ..quantize.quantizer import quantize_graph
    from ..utils.config import Options

    device = resolve_device(args.device)
    names = [args.model] if args.model else list(BENCHMARK_MODELS)
    rng = np.random.default_rng(0)
    mode = "uint8" if args.uint8 else args.precision
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"tengine-tpu benchmark  batch={args.batch} mode={mode} device={card}")
    print(f"{'model':20} {'min(ms)':>10} {'avg(ms)':>10} {'img/s':>10}")

    rows, failed = [], {}
    for name in names:
        try:
            g = load_benchmark_model(name, fill_missing_weights="random")
            shape = [int(d) for d in g.tensors[g.input_tensors[0]].shape]
            if args.uint8:
                calib = [rng.standard_normal(shape).astype(np.float32)]
                g = quantize_graph(g, calib, scheme="uint8", device=device)
                cg = compile_graph(g, Options(quant_mode="fast", batch_size=args.batch),
                                   device=device)
                t_in = g.tensors[g.input_tensors[0]]
                shape[0] = args.batch
                x = qmath.quantize_np(
                    rng.standard_normal(shape).astype(np.float32), t_in.quant, t_in.dtype)
            else:
                cg = compile_graph(
                    g, Options(precision=args.precision, batch_size=args.batch), device=device
                )
                shape[0] = args.batch
                x = rng.standard_normal(shape).astype(np.float32)
            x = torch.from_numpy(x).to(device)
            mn, avg = measure(cg, x, args.repeat)
            print(f"{name:20} {mn:10.3f} {avg:10.3f} {args.batch/mn*1e3:10.0f}")
            row = {"name": name, "min_ms": mn, "avg_ms": avg, "img_s": args.batch / mn * 1e3}
            if keep:
                row.update(cg=cg, x=x)
            rows.append(row)
        except Exception as e:
            failed[name] = f"{type(e).__name__}: {e}"
            print(f"{name:20} FAILED: {failed[name]}", file=sys.stderr)
    return {"rows": rows, "failed": failed}


if __name__ == "__main__":
    sys.exit(1 if main()["failed"] else 0)
