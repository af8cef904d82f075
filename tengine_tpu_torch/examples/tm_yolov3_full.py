"""Full YOLOv3 / YOLO-Fastest demo — tm_yolov3 / tm_yolofastest equivalent
(examples/tm_yolov3.cpp, tm_yolofastest.cpp).

Darknet-53 + 3-scale heads (or the ultra-light dw-separable yolo-fastest
with 2 heads), built from generated darknet cfg through the darknet
front-end; anchor decode + native C++ NMS on the host.

    python -m tengine_tpu_torch.examples.tm_yolov3_full [--fastest] [-q int8] [-i img.jpg]
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("-s", "--size", type=int, default=0)
    ap.add_argument("-t", "--threshold", type=float, default=0.25)
    ap.add_argument("--fastest", action="store_true", help="YOLO-Fastest instead")
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import native
    from ..models.darknet_zoo import (
        build_yolofastest_graph,
        build_yolov3_graph,
        decode_darknet_yolo,
    )

    size = args.size or (320 if args.fastest else 416)
    g = (build_yolofastest_graph if args.fastest else build_yolov3_graph)(img=size)
    yolo_params = [n.params for n in g.nodes if n.op == "Dropout" and "classes" in n.params]

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((size, size))
        ).astype(np.float32)
        x = (img / 255.0).transpose(2, 0, 1)[None]
    else:
        x = np.random.default_rng(0).standard_normal((1, 3, size, size)).astype(
            np.float32
        )

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    dets = decode_darknet_yolo(
        [np.asarray(o) for o in outs], yolo_params, size, args.threshold
    )
    if len(dets):
        keep = native.nms(dets[:, :4], dets[:, 4], iou_threshold=0.45)
        dets = dets[keep]
    net = "yolo-fastest" if args.fastest else "yolov3"
    print(f"{net} inference {ms:.2f} ms ({args.quant}); {len(dets)} detections")
    for x0, y0, x1, y1, s, c in dets[:20]:
        print(f"  cls {int(c):3d}  score {s:.3f}  box ({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})")
    return {**ran._asdict(), "dets": dets}


if __name__ == "__main__":
    main()
