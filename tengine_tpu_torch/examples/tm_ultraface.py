"""UltraFace demo — tm_ultraface equivalent (tests/models/test_model_ultraface.cpp).

Slim depthwise-separable SSD face detector: 4 scales of cls/reg heads,
prior-box decode + NMS on the host (native C++ NMS).

    python -m tengine_tpu_torch.examples.tm_ultraface [-q uint8] [-i img.jpg]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("-t", "--threshold", type=float, default=0.7)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    import torch

    from .. import native
    from ..models.detect_zoo import (
        build_ultraface_graph,
        decode_ultraface,
        flatten_ultraface,
        ultraface_priors,
    )

    torch.manual_seed(0)
    _, g = build_ultraface_graph(img_h=args.height, img_w=args.width)

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.width, args.height))
        ).astype(np.float32)
        x = ((img - 127.0) / 128.0).transpose(2, 0, 1)[None]
    else:
        x = np.random.default_rng(0).standard_normal(
            (1, 3, args.height, args.width)
        ).astype(np.float32)

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    scores, boxes = flatten_ultraface(outs)
    priors = ultraface_priors(args.height, args.width)
    dets = decode_ultraface(scores, boxes, priors, score_threshold=args.threshold)
    if len(dets):
        px = dets[:, :4] * [args.width, args.height, args.width, args.height]
        keep = native.nms(px, dets[:, 4], iou_threshold=0.5)
        dets = np.concatenate([px[keep], dets[keep, 4:5]], axis=1)
    print(f"inference {ms:.2f} ms ({args.quant}); {len(dets)} faces")
    for x0, y0, x1, y1, s in dets[:20]:
        print(f"  score {s:.3f}  box ({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})")
    return {**ran._asdict(), "dets": dets}


if __name__ == "__main__":
    main()
