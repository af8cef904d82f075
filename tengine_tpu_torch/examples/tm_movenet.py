"""MoveNet single-person pose demo — tm_movenet equivalent
(examples/tm_movenet.cpp).

Depthwise-separable backbone + stride-4 neck, four heads
(center/heatmaps/regression/offsets), center-based keypoint decode.

    python -m tengine_tpu_torch.examples.tm_movenet [-q int8] [-s 192] [-i img.jpg]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph

COCO_JOINTS = [
    "nose", "l_eye", "r_eye", "l_ear", "r_ear", "l_shoulder", "r_shoulder",
    "l_elbow", "r_elbow", "l_wrist", "r_wrist", "l_hip", "r_hip",
    "l_knee", "r_knee", "l_ankle", "r_ankle",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("-s", "--size", type=int, default=192)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    import torch

    from ..models.detect_zoo2 import build_movenet_graph, decode_movenet

    torch.manual_seed(0)
    _, g = build_movenet_graph(img=args.size)

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.size, args.size))
        ).astype(np.float32)
        x = (img / 127.5 - 1.0).transpose(2, 0, 1)[None]
    else:
        x = np.random.default_rng(0).standard_normal(
            (1, 3, args.size, args.size)
        ).astype(np.float32)

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    kps, scores = decode_movenet(*[np.asarray(o) for o in outs], img=args.size)
    print(f"inference {ms:.2f} ms ({args.quant})")
    for name, (px, py), s in zip(COCO_JOINTS, kps, scores):
        print(f"  {name:11s} ({px:6.1f},{py:6.1f})  score {s:.3f}")
    return {**ran._asdict(), "keypoints": kps, "scores": scores}


if __name__ == "__main__":
    main()
