"""CRNN OCR demo — tm_crnn equivalent (examples/tm_crnn.cpp).

Conv backbone + stacked LSTMs on the card; greedy best-path CTC decode on
the host (the reference app decodes the same way against its charset file).

    python -m tengine_tpu_torch.examples.tm_crnn [-i word.png] [-w 100]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, timed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", default=None)
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-w", "--width", type=int, default=100)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import compile_graph, load_model
    from ..models.extra import CRNN_CHARSET, build_crnn_graph, ctc_greedy_decode
    from ..utils.config import Options

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("L").resize((args.width, 32))
        ).astype(np.float32)
        x = ((img - 127.5) / 127.5)[None, None]
    else:
        x = np.random.default_rng(0).standard_normal((1, 1, 32, args.width)).astype(
            np.float32
        )

    if args.model:
        g = load_model(args.model)
        for tid in g.input_tensors:
            if not g.tensors[tid].shape:
                g.tensors[tid].shape = [1, 1, 32, args.width]
    else:
        g, _ = build_crnn_graph(img_w=args.width)

    session = compile_graph(g, Options(precision="fp32"), device=device)
    (logits,), ms = timed(session, x)
    print(f"inference: {ms:.2f} ms")
    seq = logits.reshape(-1, len(CRNN_CHARSET))
    text = ctc_greedy_decode(seq)
    print(f"decoded ({seq.shape[0]} steps): {text!r}")
    return {"outs": [logits], "text": text, "ms": ms, "session": session, "input": x}


if __name__ == "__main__":
    main()
