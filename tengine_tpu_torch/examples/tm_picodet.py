"""PicoDet demo — tm_picodet equivalent (examples/tm_picodet.cpp): ESNet
backbone (SE shuffle blocks), CSP-PAN neck, per-level cls/dis heads at
strides 8/16/32/64, softmax-DFL decode + native NMS.

    python -m tengine_tpu_torch.examples.tm_picodet [-q uint8] [-i img.jpg]
"""
from ._runner import device_of, load_input, run_graph, std_parser


def main(argv=None):
    args = std_parser(size=320).parse_args(argv)
    device = device_of(args)
    import torch

    from .. import native
    from ..models.detect_zoo3 import build_picodet_graph, decode_picodet

    torch.manual_seed(0)
    _, g = build_picodet_graph(img=args.size)
    x = load_input(args, mean=(103.53, 116.28, 123.675),
                   scale=(1 / 57.375, 1 / 57.12, 1 / 58.395))
    ran = run_graph(g, x, args.quant, args.repeat, device)
    outs, ms = ran.outs, ran.ms
    dets = decode_picodet(outs, args.size, score_threshold=0.35)
    if len(dets):
        keep = native.nms(dets[:, :4], dets[:, 4], iou_threshold=0.5)
        dets = dets[keep]
    print(f"inference {ms:.2f} ms ({args.quant}); {len(dets)} detections")
    for x0, y0, x1, y1, s, c in dets[:15]:
        print(f"  cls {int(c):3d}  score {s:.3f}  "
              f"box ({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})")
    return {**ran._asdict(), "dets": dets}


if __name__ == "__main__":
    main()
