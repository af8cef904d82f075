"""Face landmark demo — tm_landmark / tm_landmark_uint8 / tm_landmark_timvx
equivalent (examples/tm_landmark.cpp): 106-point regression head on a
mobile backbone.

    python -m tengine_tpu_torch.examples.tm_landmark [-q uint8] [-i face.jpg]
"""
from ._runner import device_of, load_input, run_graph, std_parser


def main(argv=None):
    args = std_parser(size=160).parse_args(argv)
    device = device_of(args)
    import torch

    from ..models.detect_zoo import build_landmark_graph

    torch.manual_seed(0)
    _, g = build_landmark_graph(img=args.size)
    x = load_input(args, mean=(128.0, 128.0, 128.0),
                   scale=(1 / 128.0, 1 / 128.0, 1 / 128.0))
    ran = run_graph(g, x, args.quant, args.repeat, device)
    outs, ms = ran.outs, ran.ms
    pts = outs[0].reshape(-1, 2) * args.size
    print(f"inference {ms:.2f} ms ({args.quant}); {len(pts)} landmark points")
    for i in range(0, min(len(pts), 10)):
        print(f"  p{i:3d}  ({pts[i,0]:.1f},{pts[i,1]:.1f})")
    return {**ran._asdict(), "points": pts}


if __name__ == "__main__":
    main()
