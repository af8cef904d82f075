"""U-Net segmentation demo — tm_unet equivalent (examples/tm_unet.cpp).

Runs the built-in seeded U-Net (or a converted tmfile via -m) fp32 or
quantized, prints per-class pixel counts and the fp32/quantized mask
agreement — the reference app prints the argmax mask the same way.

    python -m tengine_tpu_torch.examples.tm_unet [-s 256] [-q uint8]
"""

import argparse

import numpy as np

from ._runner import add_device, dequantize_outputs, device_of, quantize, timed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", default=None)
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-s", "--size", type=int, default=256)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("-c", "--classes", type=int, default=2)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import compile_graph, load_model
    from ..utils.config import Options

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.size, args.size))
        ).astype(np.float32)
        x = (img / 255.0).transpose(2, 0, 1)[None]
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
        from ..models.extra import build_unet_graph

        _, g = build_unet_graph(num_classes=args.classes, img=args.size)

    fp_session = compile_graph(g, Options(precision="fp32"), device=device)
    (fp_out,), ms = timed(fp_session, x)
    print(f"fp32 inference: {ms:.2f} ms")
    mask = fp_out.reshape(1, args.classes, args.size, args.size).argmax(1)
    result = {"outs": [fp_out], "ms": ms, "graph": g}

    if args.quant != "fp32":
        qg, xq = quantize(g, x, args.quant, device)
        qs = compile_graph(qg, Options(quant_mode="fast"), device=device)
        raw, q_ms = timed(qs, xq)
        print(f"{args.quant} inference: {q_ms:.2f} ms")
        (deq,) = dequantize_outputs(qg, raw)
        qmask = deq.reshape(1, args.classes, args.size, args.size).argmax(1)
        agree = (qmask == mask).mean()
        print(f"quantized mask agreement vs fp32: {agree*100:.2f}%")
        mask = qmask
        result.update(outs=[deq], raw=raw, fp32=[fp_out], agreement=float(agree), ms=q_ms,
                      graph=qg, session=qs, input=xq)

    for c in range(args.classes):
        print(f"class {c}: {(mask == c).sum()} px")
    result["mask"] = mask
    return result


if __name__ == "__main__":
    main()
