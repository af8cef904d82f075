"""yolov4-tiny demo — tm_yolov4_tiny equivalent (tests/models/test_model_yolov4_tiny.cpp).

Builds the net from its darknet cfg through the darknet front-end (CSP
grouped routes, leaky-relu, two yolo heads), runs fp32 or quantized, and
decodes + NMS on the host.

    python -m tengine_tpu_torch.examples.tm_yolov4 [-q int8] [-s 416] [-i img.jpg]
    python -m tengine_tpu_torch.examples.tm_yolov4 --cfg x.cfg --weights x.weights -i img.jpg
"""

import argparse

import numpy as np

from ._runner import add_device, device_of, run_graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-q", "--quant", choices=["fp32", "int8", "uint8"], default="fp32")
    ap.add_argument("-s", "--size", type=int, default=416)
    ap.add_argument("-t", "--threshold", type=float, default=0.25)
    ap.add_argument("--cfg", default=None, help="real darknet cfg (optional)")
    ap.add_argument("--weights", default=None, help="real darknet weights (optional)")
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import native
    from ..models.darknet_zoo import build_yolov4_tiny_graph, decode_darknet_yolo

    if args.cfg:
        from ..convert.darknet_frontend import from_darknet

        g = from_darknet(args.cfg, args.weights)
    else:
        g = build_yolov4_tiny_graph(img=args.size)
    yolo_params = [n.params for n in g.nodes if n.op == "Dropout" and "classes" in n.params]

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.size, args.size))
        ).astype(np.float32)
        x = (img / 255.0).transpose(2, 0, 1)[None]
    else:
        x = np.random.default_rng(0).standard_normal(
            (1, 3, args.size, args.size)
        ).astype(np.float32)

    ran = run_graph(g, x.astype(np.float32), args.quant, device=device)
    outs, ms = ran.outs, ran.ms
    dets = decode_darknet_yolo(outs, yolo_params, args.size, args.threshold)
    if len(dets):
        keep = native.nms(dets[:, :4], dets[:, 4], iou_threshold=0.45)
        dets = dets[keep]
    print(f"inference {ms:.2f} ms ({args.quant}); {len(dets)} detections")
    for x0, y0, x1, y1, s, c in dets[:20]:
        print(f"  cls {int(c):3d}  score {s:.3f}  box ({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})")
    return {**ran._asdict(), "dets": dets}


if __name__ == "__main__":
    main()
