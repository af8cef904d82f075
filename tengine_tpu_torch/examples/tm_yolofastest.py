"""YOLO-Fastest demo — tm_yolofastest equivalent
(examples/tm_yolofastest.cpp): darknet cfg import with load-time BN fold,
region-head decode + native NMS.

    python -m tengine_tpu_torch.examples.tm_yolofastest [-q uint8] [-i img.jpg]
"""
from ._runner import device_of, load_input, run_graph, std_parser


def main(argv=None):
    args = std_parser(size=320).parse_args(argv)
    device = device_of(args)
    from .. import native
    from ..models.darknet_zoo import build_yolofastest_graph, decode_darknet_yolo

    g = build_yolofastest_graph(img=args.size)
    yolo_params = [n.params for n in g.nodes
                   if n.op == "Dropout" and "classes" in n.params]
    x = load_input(args, mean=(0.0, 0.0, 0.0),
                   scale=(1 / 255.0, 1 / 255.0, 1 / 255.0))
    ran = run_graph(g, x, args.quant, args.repeat, device)
    outs, ms = ran.outs, ran.ms
    dets = decode_darknet_yolo(outs, yolo_params, args.size, 0.25)
    if len(dets):
        keep = native.nms(dets[:, :4], dets[:, 4], iou_threshold=0.45)
        dets = dets[keep]
    print(f"inference {ms:.2f} ms ({args.quant}); {len(dets)} detections")
    for x0, y0, x1, y1, s, c in dets[:15]:
        print(f"  cls {int(c):3d}  score {s:.3f}  "
              f"box ({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})")
    return {**ran._asdict(), "dets": dets}


if __name__ == "__main__":
    main()
