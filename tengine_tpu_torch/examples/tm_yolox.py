"""YOLOX demo — tm_yolox equivalent (examples/tm_yolox.cpp).

Anchor-free detection with a decoupled head: CSP backbone + PAFPN (SiLU),
grid decode of [reg4|obj1|clsC] maps at strides 8/16/32, native C++ NMS.

    python -m tengine_tpu_torch.examples.tm_yolox [-q int8] [-s 416] [-i img.jpg]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("-s", "--size", type=int, default=416)
    ap.add_argument("-t", "--threshold", type=float, default=0.3)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    import torch

    from .. import native
    from ..models.detect_zoo2 import build_yolox_graph, decode_yolox

    torch.manual_seed(0)
    _, g = build_yolox_graph(img=args.size)

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.size, args.size))
        ).astype(np.float32)
        x = img.transpose(2, 0, 1)[None]  # yolox takes raw 0-255 input
    else:
        x = np.random.default_rng(0).standard_normal(
            (1, 3, args.size, args.size)
        ).astype(np.float32)

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    dets = decode_yolox([np.asarray(o) for o in outs], score_threshold=args.threshold)
    if len(dets):
        keep = native.nms(dets[:, :4], dets[:, 4], iou_threshold=0.45)
        dets = dets[keep]
    print(f"inference {ms:.2f} ms ({args.quant}); {len(dets)} detections")
    for x0, y0, x1, y1, s, c in dets[:20]:
        print(f"  cls {int(c):3d}  score {s:.3f}  box ({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})")
    return {**ran._asdict(), "dets": dets}


if __name__ == "__main__":
    main()
