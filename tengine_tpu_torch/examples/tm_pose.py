"""Human-pose demo — tm_alphapose equivalent (tests/models/test_model_alphapose.cpp).

Runs the built-in seeded FastPose-style network (resnet bottlenecks +
DUC pixel-shuffle upsampling -> 17 COCO keypoint heatmaps), fp32 or
quantized, and prints the argmax-decoded keypoints the way the reference
test prints its pose vector.

    python -m tengine_tpu_torch.examples.tm_pose [-q int8] [-i img.jpg]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph
from .tm_movenet import COCO_JOINTS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=192)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    import torch

    from ..models.detect_zoo import build_fastpose_graph, decode_pose_heatmaps

    torch.manual_seed(0)
    _, g = build_fastpose_graph(img_h=args.height, img_w=args.width)

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.width, args.height))
        ).astype(np.float32)
        x = ((img / 255.0 - 0.48) / 0.23).transpose(2, 0, 1)[None]
    else:
        x = np.random.default_rng(0).standard_normal(
            (1, 3, args.height, args.width)
        ).astype(np.float32)

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    hm = outs[0]
    kps, scores = decode_pose_heatmaps(hm.reshape(1, 17, args.height // 4, args.width // 4))
    print(f"inference {ms:.2f} ms ({args.quant})")
    for name, (px, py), s in zip(COCO_JOINTS, kps[0], scores[0]):
        print(f"  {name:11s} ({px:6.1f}, {py:6.1f})  score {s:+.3f}")
    return {**ran._asdict(), "keypoints": kps, "scores": scores}


if __name__ == "__main__":
    main()
