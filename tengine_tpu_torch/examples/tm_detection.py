"""SSD detection demo — tm_mobilenet_ssd / tm_mobilenet_ssd_uint8 equivalent
(examples/tm_mobilenet_ssd.c, tm_mobilenet_ssd_uint8.c).

Loads an SSD-style tmfile (fp32 or quantized) whose graph ends in
DetectionOutput (priorbox decode + per-class NMS run on the card as padded
fixed-shape kernels — ops/detection.py), preprocesses an image, prints
detections over a score threshold.

    python -m tengine_tpu_torch.examples.tm_detection -m mssd.tmfile -i dog.jpg -g 300,300 \\
        --mean 127.5,127.5,127.5 --scale 0.0078,0.0078,0.0078 -t 0.5
"""

import argparse
import time

import numpy as np

from ._runner import add_device, device_of

VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_image(path, h, w):
    if path is None:
        rng = np.random.default_rng(0)
        return rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        # the JAX example falls back to a native.decode_resize that neither
        # package defines (ROADMAP §3); the port names what is missing
        raise SystemExit("PIL not available; pass no -i for a synthetic input")
    return np.asarray(Image.open(path).convert("RGB").resize((w, h)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-i", "--image", default=None, help="random input if absent")
    ap.add_argument("-g", "--geometry", default="300,300", help="h,w")
    ap.add_argument("--mean", default="127.5,127.5,127.5")
    ap.add_argument("--scale", default="0.007843,0.007843,0.007843")
    ap.add_argument("-t", "--threshold", type=float, default=0.5)
    ap.add_argument("-r", "--repeats", type=int, default=1)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import compile_graph, load_model
    from ..ops import qmath
    from ..utils.config import Options

    h, w = (int(v) for v in args.geometry.split(","))
    mean = np.array([float(v) for v in args.mean.split(",")], np.float32)
    scale = np.array([float(v) for v in args.scale.split(",")], np.float32)

    img = load_image(args.image, h, w).astype(np.float32)
    chw = ((img - mean) * scale).transpose(2, 0, 1)[None]  # NCHW

    g = load_model(args.model)
    for tid in g.input_tensors:
        if not g.tensors[tid].shape:
            g.tensors[tid].shape = [1, 3, h, w]
    session = compile_graph(g, Options(), device=device)

    t_in = g.tensors[g.input_tensors[0]]
    x = (
        qmath.quantize_np(chw, t_in.quant, t_in.dtype)
        if qmath.is_quantized_tensor(t_in)
        else chw
    )

    ms = []
    t0 = time.time()
    outs = session.run(x)
    ms.append((time.time() - t0) * 1e3)
    print(f"inference: {ms[-1]:.1f} ms (first call compiles)")
    for _ in range(args.repeats - 1):
        t0 = time.time()
        outs = session.run(x)
        ms.append((time.time() - t0) * 1e3)
        print(f"inference: {ms[-1]:.1f} ms")

    det = outs[0]
    t_out = g.tensors[g.output_tensors[0]]
    if qmath.is_quantized_tensor(t_out):
        det = qmath.dequantize_np(det, t_out.quant)
    det = det.reshape(-1, 6)  # [class, score, x0, y0, x1, y1] per row
    found = []
    for row in det:
        cls, score, x0, y0, x1, y1 = row.tolist()
        if score < args.threshold or cls < 0:
            continue
        name = (
            VOC_CLASSES[int(cls)]
            if 0 <= int(cls) < len(VOC_CLASSES)
            else f"class{int(cls)}"
        )
        print(
            f"{name:12s} {score*100:5.1f}%  "
            f"[{x0 * w:6.1f}, {y0 * h:6.1f}, {x1 * w:6.1f}, {y1 * h:6.1f}]"
        )
        found.append((name, score, x0 * w, y0 * h, x1 * w, y1 * h))
    print(f"{len(found)} detections >= {args.threshold}")
    return {"outs": [det], "raw": outs, "dets": found, "ms": ms, "session": session, "input": x}


if __name__ == "__main__":
    main()
