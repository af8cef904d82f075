"""OpenPose demo — tm_openpose equivalent (examples/tm_openpose.cpp):
multi-stage CPM producing part heatmaps + PAF fields; host-side peak
extraction.

    python -m tengine_tpu_torch.examples.tm_openpose [-q uint8] [-i person.jpg]
"""
import numpy as np

from ._runner import device_of, load_input, run_graph, std_parser


def main(argv=None):
    args = std_parser(size=368).parse_args(argv)
    device = device_of(args)
    import torch

    from ..models.detect_zoo import build_openpose_graph

    torch.manual_seed(0)
    _, g = build_openpose_graph(img=args.size)
    x = load_input(args, mean=(128.0, 128.0, 128.0),
                   scale=(1 / 256.0, 1 / 256.0, 1 / 256.0))
    ran = run_graph(g, x, args.quant, args.repeat, device)
    outs, ms = ran.outs, ran.ms
    heat = outs[-2] if len(outs) > 1 else outs[0]  # final-stage heatmaps
    parts = []
    for c in range(heat.shape[1]):
        hm = heat[0, c]
        yx = np.unravel_index(np.argmax(hm), hm.shape)
        parts.append((c, yx[1], yx[0], float(hm[yx])))
    print(f"inference {ms:.2f} ms ({args.quant}); {len(parts)} part peaks")
    for c, px, py, s in parts[:10]:
        print(f"  part {c:2d}  ({px},{py})  conf {s:.3f}")
    return {**ran._asdict(), "parts": parts}


if __name__ == "__main__":
    main()
