"""Classification demo — tm_classification / tm_classification_uint8
equivalent (examples/tm_classification.c, tm_classification_uint8.c).

Loads a tmfile (fp32 or quantized), preprocesses an image through the native
improc layer (resize + mean/scale normalize, tengine_operations.c parity),
runs on the card, prints top-5.

    python -m tengine_tpu_torch.examples.tm_classification -m model.tmfile -i cat.jpg \\
        -g 224,224 --mean 104.007,116.669,122.679 --scale 0.017,0.017,0.017
"""

import argparse
import sys
import time

import numpy as np

from ._runner import add_device, device_of


def load_image(path, h, w):
    from .. import native

    if path is None:
        rng = np.random.default_rng(0)
        return rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    except ImportError:
        raise SystemExit("PIL not available; pass no -i for a synthetic input")
    return native.resize_bilinear(img, h, w)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-g", "--size", default="224,224", help="h,w")
    ap.add_argument("--mean", default="104.007,116.669,122.679")
    ap.add_argument("--scale", default="0.017,0.017,0.017")
    ap.add_argument("-r", "--repeat", type=int, default=1)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import compile_graph, load_model, native
    from ..graph.ir import DType
    from ..ops import qmath

    h, w = (int(v) for v in args.size.split(","))
    mean = np.array([float(v) for v in args.mean.split(",")], np.float32)
    scale = np.array([float(v) for v in args.scale.split(",")], np.float32)

    g = load_model(args.model)
    tid = g.input_tensors[0]
    if not g.tensors[tid].shape:
        g.tensors[tid].shape = [1, 3, h, w]

    img = load_image(args.image, h, w)
    x = native.normalize_chw(img, mean, scale)[None]  # [1, 3, h, w]

    t_in = g.tensors[tid]
    if t_in.dtype == DType.UINT8 and t_in.quant is not None:
        x = native.quantize_u8(
            x, float(np.asarray(t_in.quant.scales).reshape(-1)[0]),
            int(np.asarray(t_in.quant.zero_points).reshape(-1)[0]),
        )

    t0 = time.perf_counter()
    cg = compile_graph(g, device=device)
    print(f"compile: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    ms = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        outs = cg.run(x)
        ms.append((time.perf_counter() - t0) * 1e3)
        print(f"run: {ms[-1]:.2f} ms", file=sys.stderr)

    out = outs[0].reshape(-1).astype(np.float32)
    t_out = g.tensors[g.output_tensors[0]]
    if t_out.quant is not None and outs[0].dtype in (np.uint8, np.int8):
        out = qmath.dequantize_np(outs[0], t_out.quant).reshape(-1)

    top5 = np.argsort(out)[::-1][:5]
    for i in top5:
        print(f"{out[i]:.4f}, {i}")
    return {"outs": [out], "raw": outs, "top5": [(float(out[i]), int(i)) for i in top5],
            "ms": ms, "session": cg, "input": x}


if __name__ == "__main__":
    main()
