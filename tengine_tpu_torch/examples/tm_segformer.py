"""SegFormer semantic-segmentation demo — tm_segformer equivalent
(examples/tm_segformer.cpp).

Mix-Transformer encoder (efficient self-attention with spatial reduction,
MixFFN) + all-MLP decode head; prints the stride-4 class map histogram.

    python -m tengine_tpu_torch.examples.tm_segformer [-q int8] [-s 256] [-i img.jpg]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("-s", "--size", type=int, default=256)
    ap.add_argument("-c", "--classes", type=int, default=19)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    import torch

    from ..models.transformer_zoo import build_segformer_graph, segformer_classmap

    torch.manual_seed(0)
    _, g = build_segformer_graph(num_classes=args.classes, img=args.size)

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.size, args.size))
        ).astype(np.float32)
        mean = np.array([123.675, 116.28, 103.53], np.float32)
        std = np.array([58.395, 57.12, 57.375], np.float32)
        x = ((img - mean) / std).transpose(2, 0, 1)[None]
    else:
        x = np.random.default_rng(0).standard_normal(
            (1, 3, args.size, args.size)
        ).astype(np.float32)

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    cmap = segformer_classmap(np.asarray(outs[0]).reshape(1, args.classes, -1, args.size // 4))
    classes, counts = np.unique(cmap, return_counts=True)
    print(f"inference {ms:.2f} ms ({args.quant}); class map {cmap.shape}")
    for c, n in sorted(zip(classes, counts), key=lambda t: -t[1])[:8]:
        print(f"  class {c:3d}: {n:6d} px ({100.0 * n / cmap.size:.1f}%)")
    return {**ran._asdict(), "outs": outs[:1], "raw": ran.raw[:1], "classmap": cmap}


if __name__ == "__main__":
    main()
