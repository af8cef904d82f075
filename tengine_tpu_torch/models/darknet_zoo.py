"""Darknet-family models built from .cfg architecture descriptions through
the darknet front-end — the reference's yolov3 test model arrives the same
way (tests/models/test_model_yolov3.cpp via convert_tool -f darknet).

The cfg text describes the published architecture (layer/filter facts);
weights are seeded random like the reference's weight-stripped benchmark
tmfiles.

PyTorch port: the YOLOv3 and YOLO-Fastest graphs of
tengine_tpu/models/darknet_zoo.py, copied so that both packages build the
same IR from the same seed. yolov4-tiny and decode_darknet_yolo are not
ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "build_yolofastest_graph",
    "build_yolov3_graph",
    "yolofastest_cfg",
    "yolov3_cfg",
]


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
