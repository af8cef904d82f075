"""SCRFD face-detection demo — tm_scrfd equivalent (examples/tm_scrfd.cpp).

Residual backbone + FPN + shared heads; decodes distance-to-center boxes
and 5-point landmarks at strides 8/16/32, native C++ NMS.

    python -m tengine_tpu_torch.examples.tm_scrfd [-q uint8] [-s 320] [-i img.jpg]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("-s", "--size", type=int, default=320)
    ap.add_argument("-t", "--threshold", type=float, default=0.5)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    import torch

    from .. import native
    from ..models.detect_zoo2 import build_scrfd_graph, decode_scrfd

    torch.manual_seed(0)
    _, g = build_scrfd_graph(img=args.size)

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.size, args.size))
        ).astype(np.float32)
        x = ((img - 127.5) / 128.0).transpose(2, 0, 1)[None]
    else:
        x = np.random.default_rng(0).standard_normal(
            (1, 3, args.size, args.size)
        ).astype(np.float32)

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    boxes, kps = decode_scrfd(
        [np.asarray(o) for o in outs], args.size, score_threshold=args.threshold
    )
    if len(boxes):
        keep = native.nms(boxes[:, :4], boxes[:, 4], iou_threshold=0.45)
        boxes, kps = boxes[keep], kps[keep]
    print(f"inference {ms:.2f} ms ({args.quant}); {len(boxes)} faces")
    for (x0, y0, x1, y1, s), k in zip(boxes[:10], kps[:10]):
        pts = " ".join(f"({px:.0f},{py:.0f})" for px, py in k)
        print(f"  score {s:.3f}  box ({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})  kps {pts}")
    return {**ran._asdict(), "dets": boxes, "keypoints": kps}


if __name__ == "__main__":
    main()
