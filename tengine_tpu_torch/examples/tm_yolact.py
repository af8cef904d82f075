"""YOLACT instance-segmentation demo — tm_yolact / tm_yolact_uint8
equivalent (examples/tm_yolact.cpp). FPN backbone + protonet mask
prototypes; masks assemble on the host as sigmoid(proto @ coefficients).

    python -m tengine_tpu_torch.examples.tm_yolact [-q uint8] [-i img.jpg]
"""
import numpy as np

from ._runner import device_of, load_input, run_graph, std_parser


def main(argv=None):
    args = std_parser(size=256).parse_args(argv)
    device = device_of(args)
    import torch

    from ..models.detect_zoo import assemble_yolact_masks, build_yolact_graph

    torch.manual_seed(0)
    _, g = build_yolact_graph(img=args.size)
    x = load_input(args, mean=(123.68, 116.78, 103.94),
                   scale=(1 / 58.40, 1 / 57.12, 1 / 57.38))
    ran = run_graph(g, x, args.quant, args.repeat, device)
    outs, ms = ran.outs, ran.ms
    # outputs: [proto, then per level (cls, box, coef)]; coef channels are
    # anchors * n_proto
    proto = outs[0][0]                      # [P, H/4, W/4]
    P = proto.shape[0]
    best = (-1.0, None, None)
    for lvl in range((len(outs) - 1) // 3):
        cls, box, coef = outs[1 + 3 * lvl : 4 + 3 * lvl]
        h, w = cls.shape[2], cls.shape[3]
        A = coef.shape[1] // P
        nc = cls.shape[1] // A
        p = 1.0 / (1.0 + np.exp(-cls[0].reshape(A, nc, h, w)))
        a, c, y, xx = np.unravel_index(np.argmax(p[:, 1:]), p[:, 1:].shape)
        score = p[a, c + 1, y, xx]
        if score > best[0]:
            cf = coef[0].reshape(A, P, h, w)[a, :, y, xx]
            best = (float(score), int(c), cf)
    masks = assemble_yolact_masks(proto, best[2][None, :])
    print(f"inference {ms:.2f} ms ({args.quant}); top instance: "
          f"cls {best[1]} score {best[0]:.3f}; mask {masks.shape[1:]} "
          f"area {(masks[0] > 0.5).mean():.3f}")
    return {**ran._asdict(), "best": best[:2], "masks": masks}


if __name__ == "__main__":
    main()
