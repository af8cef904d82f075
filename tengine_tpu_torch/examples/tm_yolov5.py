"""YOLOv5s detection demo — tm_yolov5s equivalent (examples/tm_yolov5s.cpp).

The reference needs offline ONNX surgery (tools/optimize/yolov5s-opt.py) to
strip the Focus slices before converting; here the full graph — Focus
slices, SiLU, SPP, PANet upsample/concat, three heads — runs on the card,
and only the anchor decode + NMS run host-side (matching the reference
app's post-processing, tm_yolov5s.cpp). At -q int8 -s 640 the stem conv
runs on the stem kernel (csrc/stem_conv.cu).

    python -m tengine_tpu_torch.examples.tm_yolov5 [-i img.jpg] [-q int8] [-s 640] [-t 0.25]

With no image an uint8-noise frame is used (smoke/demo mode). The model is
the clean-room YOLOv5s with seeded random weights (the reference benchmarks
weight-stripped nets the same way); pass -m model.tmfile to run converted
real weights instead.
"""

import argparse

import numpy as np

from ._runner import add_device, dequantize_outputs, device_of, quantize, timed
from .tm_yolo import nms, print_detections, sigmoid


def decode_v5_head(out, anchors, stride, conf_th):
    """[1, 3*(5+nc), g, g] raw map -> [N,6] (x0,y0,x1,y1,score,cls).
    yolov5 box decode: xy = (2*sig(t)-0.5+grid)*stride, wh = (2*sig(t))^2*anchor."""
    _, ch, gh, gw = out.shape
    nc = ch // 3 - 5
    out = out.reshape(3, 5 + nc, gh, gw)
    p = sigmoid(out)
    boxes = []
    for a, (aw, ah) in enumerate(anchors):
        obj = p[a, 4]
        ys, xs = np.where(obj > conf_th)
        for y, x in zip(ys, xs):
            scores = obj[y, x] * p[a, 5:, y, x]
            c = int(np.argmax(scores))
            score = float(scores[c])
            if score < conf_th:
                continue
            bx = (2 * p[a, 0, y, x] - 0.5 + x) * stride
            by = (2 * p[a, 1, y, x] - 0.5 + y) * stride
            bw = (2 * p[a, 2, y, x]) ** 2 * aw
            bh = (2 * p[a, 3, y, x]) ** 2 * ah
            boxes.append([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2, score, c])
    return np.asarray(boxes, np.float32).reshape(-1, 6)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", default=None, help="tmfile (default: built-in yolov5s)")
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-s", "--size", type=int, default=640)
    ap.add_argument("-t", "--threshold", type=float, default=0.25)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import compile_graph, load_model
    from ..models.yolov5 import YOLOV5_ANCHORS, YOLOV5_STRIDES
    from ..utils.config import Options

    if args.image:
        from PIL import Image

        from .. import native

        img = np.asarray(Image.open(args.image).convert("RGB"))
        img = native.letterbox(img, args.size, args.size)  # native improc.cc
        x = (img.astype(np.float32) / 255.0).transpose(2, 0, 1)[None]
    else:
        x = (
            np.random.default_rng(0)
            .integers(0, 255, (1, 3, args.size, args.size))
            .astype(np.float32)
            / 255.0
        )
    x = x.astype(np.float32)

    if args.model:
        g = load_model(args.model)
        for tid in g.input_tensors:
            if not g.tensors[tid].shape:
                g.tensors[tid].shape = [1, 3, args.size, args.size]
    else:
        from ..models.yolov5 import build_yolov5s_graph

        _, g = build_yolov5s_graph(num_classes=80, img=args.size)

    qg, xin = None, x
    if args.quant != "fp32":
        qg, xin = quantize(g, x, args.quant, device)
        session = compile_graph(qg, Options(quant_mode="fast"), device=device)
        raw, ms = timed(session, xin)
        outs = dequantize_outputs(qg, raw)
    else:
        session = compile_graph(g, Options(), device=device)
        raw, ms = timed(session, xin)
        outs = raw
    print(f"inference: {ms:.2f} ms ({args.quant})")

    heads = sorted((o for o in outs if o.ndim == 4), key=lambda o: -o.shape[2])
    all_boxes = np.concatenate(
        [
            decode_v5_head(o, YOLOV5_ANCHORS[i], YOLOV5_STRIDES[i], args.threshold)
            for i, o in enumerate(heads)
        ],
        axis=0,
    )
    dets = nms(all_boxes)
    print_detections(dets, args.threshold)
    return {"outs": outs, "raw": raw, "dets": dets, "ms": ms, "graph": qg or g,
            "session": session, "input": xin}


if __name__ == "__main__":
    main()
