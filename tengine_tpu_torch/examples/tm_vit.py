"""ViT classification demo — transformer analog of tm_classification
(examples/tm_classification.c).

Plain ViT: conv patch embed + positional embedding + pre-norm attention
blocks + token mean-pool head, captured on the card as one CUDA graph
(attention = batched matmuls).

    python -m tengine_tpu_torch.examples.tm_vit [-q int8] [-s 224] [-i img.jpg]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("-s", "--size", type=int, default=224)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    import torch

    from ..models.transformer_zoo import build_vit_graph

    torch.manual_seed(0)
    _, g = build_vit_graph(num_classes=1000, img=args.size)

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.size, args.size))
        ).astype(np.float32)
        x = ((img / 255.0 - 0.5) / 0.5).transpose(2, 0, 1)[None]
    else:
        x = np.random.default_rng(0).standard_normal(
            (1, 3, args.size, args.size)
        ).astype(np.float32)

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    logits = np.asarray(outs[0]).ravel()
    top5 = logits.argsort()[-5:][::-1]
    print(f"inference {ms:.2f} ms ({args.quant})")
    for i in top5:
        print(f"  class {i:4d}: {logits[i]:.4f}")
    return {**ran._asdict(), "outs": outs[:1], "raw": ran.raw[:1],
            "top5": [(int(i), float(logits[i])) for i in top5]}


if __name__ == "__main__":
    main()
