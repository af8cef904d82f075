"""HRNet single-person pose demo — tm_hrnet / tm_hrnet_timvx equivalent
(examples/tm_hrnet.cpp). High-resolution parallel-branch backbone ->
per-joint heatmaps; argmax-decoded keypoints.

    python -m tengine_tpu_torch.examples.tm_hrnet [-q uint8] [-i person.jpg]
"""
from ._runner import device_of, load_input, run_graph, std_parser


def main(argv=None):
    args = std_parser(size=256).parse_args(argv)
    device = device_of(args)
    import torch

    from ..models.detect_zoo import build_hrnet_graph, decode_pose_heatmaps

    torch.manual_seed(0)
    _, g = build_hrnet_graph(img=args.size)
    x = load_input(args, mean=(123.675, 116.28, 103.53),
                   scale=(1 / 58.395, 1 / 57.12, 1 / 57.375))
    ran = run_graph(g, x, args.quant, args.repeat, device)
    outs, ms = ran.outs, ran.ms
    kps, scores = decode_pose_heatmaps(outs[0])
    print(f"inference {ms:.2f} ms ({args.quant}); {kps.shape[1]} joints")
    for j in range(kps.shape[1]):
        print(f"  joint {j:2d}  ({kps[0,j,0]:.1f},{kps[0,j,1]:.1f})  "
              f"conf {scores[0,j]:.3f}")
    return {**ran._asdict(), "keypoints": kps, "scores": scores}


if __name__ == "__main__":
    main()
