"""EfficientDet-lite demo — tm_efficientdet / tm_efficientdet_uint8
equivalent (examples/tm_efficientdet.c). BiFPN-style fusion + shared
class/box heads over 5 levels; host-side decode + NMS.

    python -m tengine_tpu_torch.examples.tm_efficientdet [-q uint8] [-i img.jpg]
"""
import numpy as np

from ._runner import device_of, load_input, run_graph, std_parser


def main(argv=None):
    args = std_parser(size=320).parse_args(argv)
    device = device_of(args)
    import torch

    from .. import native
    from ..models.detect_zoo import build_efficientdet_graph

    torch.manual_seed(0)
    _, g = build_efficientdet_graph(img=args.size)
    x = load_input(args, mean=(127.0, 127.0, 127.0),
                   scale=(1 / 128.0, 1 / 128.0, 1 / 128.0))
    ran = run_graph(g, x, args.quant, args.repeat, device)
    outs, ms = ran.outs, ran.ms
    # outputs per level, interleaved: [cls3, box3, cls4, box4, cls5, box5];
    # cls channels = anchors*num_classes, box channels = anchors*4
    A, NC = 9, 90
    dets = []
    for lvl in range(len(outs) // 2):
        cls, box = outs[2 * lvl], outs[2 * lvl + 1]
        h, w = cls.shape[2], cls.shape[3]
        stride = args.size / h
        p = 1.0 / (1.0 + np.exp(-cls[0].reshape(A, NC, h, w)))
        b = box[0].reshape(A, 4, h, w)
        ai, ci, yi, xi = np.unravel_index(np.argsort(-p, axis=None)[:10], p.shape)
        for a, c, y, xx in zip(ai, ci, yi, xi):
            dy, dx, dh, dw = b[a, :, y, xx]
            cyc, cxc = (y + 0.5 + dy) * stride, (xx + 0.5 + dx) * stride
            bh, bw = np.exp(np.clip(dh, -4, 4)) * stride * 4, np.exp(np.clip(dw, -4, 4)) * stride * 4
            dets.append([cxc - bw / 2, cyc - bh / 2, cxc + bw / 2,
                         cyc + bh / 2, p[a, c, y, xx], c])
    dets = np.asarray(dets, np.float32)
    keep = native.nms(dets[:, :4], dets[:, 4], iou_threshold=0.5)
    dets = dets[keep][:10]
    print(f"inference {ms:.2f} ms ({args.quant}); {len(dets)} detections")
    for x0, y0, x1, y1, s, c in dets:
        print(f"  cls {int(c):3d}  score {s:.3f}  "
              f"box ({x0:.0f},{y0:.0f})-({x1:.0f},{y1:.0f})")
    return {**ran._asdict(), "dets": dets}


if __name__ == "__main__":
    main()
