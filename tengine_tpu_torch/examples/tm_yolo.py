"""YOLOv3-tiny detection demo — tm_yolov3_tiny equivalent
(examples/tm_yolov3_tiny.c). The tmfile graph ends at the two raw head
convs; decoding (anchors, sigmoid, NMS) runs host-side exactly like the
reference's app-level post-processing.

    python -m tengine_tpu_torch.examples.tm_yolo -m yolov3_tiny.tmfile -i dog.jpg -t 0.4
"""

import argparse
import time

import numpy as np

from ._runner import add_device, device_of

# yolov3-tiny anchors (darknet cfg): two heads, 3 anchors each
ANCHORS = {
    13: [(81, 82), (135, 169), (344, 319)],   # stride 32 head
    26: [(10, 14), (23, 27), (37, 58)],       # stride 16 head
}

COCO80 = (
    "person bicycle car motorbike aeroplane bus train truck boat traffic-light "
    "fire-hydrant stop-sign parking-meter bench bird cat dog horse sheep cow "
    "elephant bear zebra giraffe backpack umbrella handbag tie suitcase frisbee "
    "skis snowboard sports-ball kite baseball-bat baseball-glove skateboard "
    "surfboard tennis-racket bottle wine-glass cup fork knife spoon bowl banana "
    "apple sandwich orange broccoli carrot hot-dog pizza donut cake chair sofa "
    "pottedplant bed diningtable toilet tvmonitor laptop mouse remote keyboard "
    "cell-phone microwave oven toaster sink refrigerator book clock vase "
    "scissors teddy-bear hair-drier toothbrush"
).split()


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def decode_head(out, img_size, conf_th):
    """[1, 255, g, g] raw head -> [N, 6] (x0,y0,x1,y1,score,cls)."""
    g = out.shape[2]
    anchors = ANCHORS.get(g)
    if anchors is None:
        return np.zeros((0, 6), np.float32)
    stride = img_size / g
    out = out.reshape(1, 3, 85, g, g)
    boxes = []
    xy = sigmoid(out[0, :, 0:2])
    wh = out[0, :, 2:4]
    obj = sigmoid(out[0, :, 4])
    cls = sigmoid(out[0, :, 5:])
    for a in range(3):
        ys, xs = np.where(obj[a] > conf_th)
        for y, x in zip(ys, xs):
            scores = obj[a, y, x] * cls[a, :, y, x]
            c = int(np.argmax(scores))
            score = float(scores[c])
            if score < conf_th:
                continue
            bx = (x + xy[a, 0, y, x]) * stride
            by = (y + xy[a, 1, y, x]) * stride
            bw = anchors[a][0] * np.exp(wh[a, 0, y, x])
            bh = anchors[a][1] * np.exp(wh[a, 1, y, x])
            boxes.append([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2, score, c])
    return np.asarray(boxes, np.float32).reshape(-1, 6)


def nms(boxes, iou_th=0.45):
    """Class-aware hard NMS via the native kernel (native/postproc.cc):
    boxes of different classes never overlap after a per-class coordinate
    offset, so one class-agnostic pass suppresses exactly per class."""
    if not len(boxes):
        return boxes
    from .. import native

    span = float(boxes[:, :4].max()) + 1.0
    shifted = boxes[:, :4] + boxes[:, 5:6] * span
    keep = native.nms(shifted, boxes[:, 4], iou_th)
    return boxes[keep]


def print_detections(dets, threshold):
    for x0, y0, x1, y1, score, c in dets:
        name = COCO80[int(c)] if int(c) < len(COCO80) else f"class{int(c)}"
        print(f"{name:14s} {score*100:5.1f}%  [{x0:6.1f}, {y0:6.1f}, {x1:6.1f}, {y1:6.1f}]")
    print(f"{len(dets)} detections >= {threshold}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument("-s", "--size", type=int, default=416)
    ap.add_argument("-t", "--threshold", type=float, default=0.4)
    args = add_device(ap).parse_args(argv)
    device = device_of(args)

    from .. import compile_graph, load_model
    from ..utils.config import Options

    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((args.size, args.size))
        ).astype(np.float32)
    else:
        img = np.random.default_rng(0).integers(
            0, 255, (args.size, args.size, 3)
        ).astype(np.float32)
    x = (img / 255.0).transpose(2, 0, 1)[None].astype(np.float32)

    g = load_model(args.model)
    for tid in g.input_tensors:
        if not g.tensors[tid].shape:
            g.tensors[tid].shape = [1, 3, args.size, args.size]
    session = compile_graph(g, Options(), device=device)
    t0 = time.time()
    outs = session.run(x)
    ms = (time.time() - t0) * 1e3
    print(f"inference: {ms:.1f} ms (first call compiles)")

    all_boxes = np.concatenate(
        [decode_head(o, args.size, args.threshold) for o in outs if o.ndim == 4], axis=0
    ) if outs else np.zeros((0, 6))
    dets = nms(all_boxes)
    print_detections(dets, args.threshold)
    return {"outs": outs, "dets": dets, "ms": ms, "session": session, "input": x}


if __name__ == "__main__":
    main()
