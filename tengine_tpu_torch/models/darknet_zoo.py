"""Darknet-family models built from .cfg architecture descriptions through
the darknet front-end — the reference's yolov3/v4-tiny/yolofastest test
models arrive the same way (tests/models/test_model_yolov4_tiny.cpp via
convert_tool -f darknet).

The cfg texts below describe the published architectures (layer/filter
facts); weights are seeded random like the reference's weight-stripped
benchmark tmfiles.

PyTorch port: a copy of tengine_tpu/models/darknet_zoo.py, through the
port's darknet front-end, so that both packages build the same IR from the
same seed.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "YOLOV4_TINY_CFG",
    "build_yolov4_tiny_graph",
    "build_yolov3_graph",
    "build_yolofastest_graph",
    "yolov3_cfg",
    "yolofastest_cfg",
    "decode_darknet_yolo",
]

# yolov4-tiny: CSP blocks with grouped routes, leaky-relu, two YOLO heads
# (strides 32 and 16). Layer indices in [route] sections follow darknet's
# counting (every section after [net] is one layer).
YOLOV4_TINY_CFG = """
[net]
width=416
height=416
channels=3

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1,-2

[convolutional]
batch_normalize=1
filters=64
size=1
stride=1
pad=1
activation=leaky

[route]
layers=-6,-1

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1,-2

[convolutional]
batch_normalize=1
filters=128
size=1
stride=1
pad=1
activation=leaky

[route]
layers=-6,-1

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[route]
layers=-1,-2

[convolutional]
batch_normalize=1
filters=256
size=1
stride=1
pad=1
activation=leaky

[route]
layers=-6,-1

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=256
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=255
activation=linear

[yolo]
mask=3,4,5
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=80
num=6

[route]
layers=-4

[convolutional]
batch_normalize=1
filters=128
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1,23

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=255
activation=linear

[yolo]
mask=1,2,3
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=80
num=6
"""


def _seed_weights(g, seed: int = 0):
    """Fill CONST tensors with fan-in-scaled random weights (the reference
    benchmarks weight-stripped tmfiles the same way, tm2_serializer.c:241-246)."""
    rng = np.random.default_rng(seed)
    for t in g.tensors:
        if t.data is not None and t.data.size:
            fan = max(int(np.prod(t.data.shape[1:])), 1)
            t.data = (rng.standard_normal(t.data.shape) / np.sqrt(fan)).astype(
                t.data.dtype if t.data.dtype.kind == "f" else np.float32
            )
    return g


def build_yolov4_tiny_graph(img: int = 416, seed: int = 0):
    """yolov4-tiny IR via the darknet front-end, seeded random weights."""
    from ..convert.darknet_frontend import from_darknet

    cfg = YOLOV4_TINY_CFG.replace("width=416", f"width={img}").replace(
        f"height=416", f"height={img}"
    )
    return _seed_weights(from_darknet(cfg, None, name="yolov4-tiny"), seed)


# ---------------------------------------------------------------------------
# Full YOLOv3 (Darknet-53 backbone + 3-scale FPN heads) — the reference's
# tm_yolov3 example / tests/models/test_model_yolov3.cpp model, built from a
# programmatically generated cfg with the published layer structure
# (106 darknet layers; route taps at layers 36 and 61).
# ---------------------------------------------------------------------------

_YOLOV3_ANCHORS = "10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326"


def _cfg_conv(filters, size=3, stride=1, act="leaky", bn=True):
    s = "[convolutional]\n"
    if bn:
        s += "batch_normalize=1\n"
    return s + (
        f"filters={filters}\nsize={size}\nstride={stride}\npad=1\n"
        f"activation={act}\n\n"
    )


def _cfg_yolo(mask, anchors=_YOLOV3_ANCHORS, classes=80, num=9):
    return f"[yolo]\nmask={mask}\nanchors={anchors}\nclasses={classes}\nnum={num}\n\n"


def yolov3_cfg(img: int = 416, classes: int = 80) -> str:
    """Generate the full YOLOv3 architecture as darknet cfg text."""
    c = f"[net]\nwidth={img}\nheight={img}\nchannels=3\n\n"
    c += _cfg_conv(32)

    def res_stage(ch, blocks):
        s = _cfg_conv(ch, 3, 2)  # downsample
        for _ in range(blocks):
            s += _cfg_conv(ch // 2, 1) + _cfg_conv(ch) + "[shortcut]\nfrom=-3\nactivation=linear\n\n"
        return s

    # darknet-53: stages end at layers 4 / 11 / 36 / 61 / 74
    c += res_stage(64, 1) + res_stage(128, 2) + res_stage(256, 8)
    c += res_stage(512, 8) + res_stage(1024, 4)
    out_f = 3 * (5 + classes)

    def head(ch):
        s = ""
        for _ in range(2):
            s += _cfg_conv(ch // 2, 1) + _cfg_conv(ch)
        s += _cfg_conv(ch // 2, 1) + _cfg_conv(ch)
        s += _cfg_conv(out_f, 1, act="linear", bn=False)
        return s

    c += head(1024) + _cfg_yolo("6,7,8", classes=classes)
    c += "[route]\nlayers=-4\n\n" + _cfg_conv(256, 1) + "[upsample]\nstride=2\n\n"
    c += "[route]\nlayers=-1,61\n\n"
    c += head(512) + _cfg_yolo("3,4,5", classes=classes)
    c += "[route]\nlayers=-4\n\n" + _cfg_conv(128, 1) + "[upsample]\nstride=2\n\n"
    c += "[route]\nlayers=-1,36\n\n"
    c += head(256) + _cfg_yolo("0,1,2", classes=classes)
    return c


def build_yolov3_graph(img: int = 416, classes: int = 80, seed: int = 0):
    """Full YOLOv3 IR (darknet-53 + 3 yolo heads) with seeded weights."""
    from ..convert.darknet_frontend import from_darknet

    return _seed_weights(
        from_darknet(yolov3_cfg(img, classes), None, name="yolov3"), seed
    )


# ---------------------------------------------------------------------------
# YOLO-Fastest 1.1 family (tm_yolofastest.cpp / test_model_yolofastest.cpp):
# ultra-light detector — inverted-residual depthwise bottlenecks ("EP"
# blocks: 1x1 expand -> 3x3 depthwise -> 1x1 linear project, shortcut at
# stride 1) with a 2-level light FPN and two anchor heads (strides 32/16).
# ---------------------------------------------------------------------------

_YOLOFASTEST_ANCHORS = "12,18, 37,49, 52,132, 115,73, 119,199, 242,238"


def yolofastest_cfg(img: int = 320, classes: int = 80) -> str:
    """Generate a YOLO-Fastest-1.1-shaped cfg (published stage widths
    8/16/32/48/96, expansion ~4-6, dw-separable throughout)."""

    def ep(cin, cout, stride, expand):
        mid = cin * expand
        s = _cfg_conv(mid, 1)  # expand
        # depthwise: darknet expresses it as groups == filters
        s += (
            f"[convolutional]\nbatch_normalize=1\nfilters={mid}\nsize=3\n"
            f"stride={stride}\npad=1\ngroups={mid}\nactivation=leaky\n\n"
        )
        s += _cfg_conv(cout, 1, act="linear")  # linear project
        if stride == 1 and cin == cout:
            s += "[shortcut]\nfrom=-4\nactivation=linear\n\n"
        return s

    c = f"[net]\nwidth={img}\nheight={img}\nchannels=3\n\n"
    c += _cfg_conv(8, 3, 2)  # stem /2
    c += ep(8, 8, 1, 4)
    c += ep(8, 16, 2, 4) + ep(16, 16, 1, 4)            # /4
    c += ep(16, 32, 2, 4) + ep(32, 32, 1, 4)           # /8
    c += ep(32, 48, 2, 4) + ep(48, 48, 1, 4) + ep(48, 48, 1, 4)   # /16
    # tap for the stride-16 head is the last /16 layer
    c += ep(48, 96, 2, 6) + ep(96, 96, 1, 6) + ep(96, 96, 1, 6)   # /32
    out_f = 3 * (5 + classes)
    # head 1 (stride 32): dw-separable conv stack + 1x1 predictor
    c += ep(96, 96, 1, 2)
    c += _cfg_conv(out_f, 1, act="linear", bn=False)
    c += _cfg_yolo("3,4,5", anchors=_YOLOFASTEST_ANCHORS, classes=classes, num=6)
    # route back to the end of the /32 body (layer 40: stem=0, ep blocks are
    # 3 sections at stride 2 / 4 at stride 1 -> body ends at 40, head stack
    # 41-44, predictor 45, yolo 46, this route is 47), upsample, concat with
    # the /16 tap (layer 29, end of the last 48-channel block)
    c += "[route]\nlayers=-7\n\n" + _cfg_conv(48, 1) + "[upsample]\nstride=2\n\n"
    c += "[route]\nlayers=-1,29\n\n"
    c += ep(96, 96, 1, 2)
    c += _cfg_conv(out_f, 1, act="linear", bn=False)
    c += _cfg_yolo("0,1,2", anchors=_YOLOFASTEST_ANCHORS, classes=classes, num=6)
    return c


def build_yolofastest_graph(img: int = 320, classes: int = 80, seed: int = 0):
    """YOLO-Fastest IR via the darknet front-end, seeded random weights."""
    from ..convert.darknet_frontend import from_darknet

    return _seed_weights(
        from_darknet(yolofastest_cfg(img, classes), None, name="yolofastest"), seed
    )


def decode_darknet_yolo(outputs, yolo_params, img: int, score_threshold=0.25):
    """Decode darknet yolo head maps [N, A*(5+C), h, w] -> [M, 6]
    (x0,y0,x1,y1,score,cls) — the host-side decode the reference's
    tm_yolov4_tiny example performs after run_graph."""
    dets = []
    for out, p in zip(outputs, yolo_params):
        anchors = p["anchors"]
        mask = p["mask"]
        classes = p["classes"]
        n, c, h, w = out.shape
        a = len(mask)
        o = out.reshape(a, 5 + classes, h, w)
        xy = 1 / (1 + np.exp(-o[:, 0:2]))
        wh = np.exp(np.clip(o[:, 2:4], -10, 10))
        obj = 1 / (1 + np.exp(-o[:, 4]))
        cls = 1 / (1 + np.exp(-o[:, 5:]))
        stride = img // w
        for ai, m in enumerate(mask):
            aw, ah = anchors[2 * m], anchors[2 * m + 1]
            for y in range(h):
                for x in range(w):
                    score = float(obj[ai, y, x] * cls[ai, :, y, x].max())
                    if score < score_threshold:
                        continue
                    cx = (x + xy[ai, 0, y, x]) * stride
                    cy = (y + xy[ai, 1, y, x]) * stride
                    bw = wh[ai, 0, y, x] * aw
                    bh = wh[ai, 1, y, x] * ah
                    dets.append([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                                 cy + bh / 2, score,
                                 int(cls[ai, :, y, x].argmax())])
    return np.asarray(dets, np.float32).reshape(-1, 6)
