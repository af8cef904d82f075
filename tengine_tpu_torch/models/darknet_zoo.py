"""Darknet-family models built from .cfg architecture descriptions through
the darknet front-end — the reference's yolov3 test model arrives the same
way (tests/models/test_model_yolov3.cpp via convert_tool -f darknet).

The cfg text describes the published architecture (layer/filter facts);
weights are seeded random like the reference's weight-stripped benchmark
tmfiles.

PyTorch port: the YOLOv3 subset of tengine_tpu/models/darknet_zoo.py, copied
so that both packages build the same IR from the same seed. yolov4-tiny,
yolo-fastest and decode_darknet_yolo are not ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_yolov3_graph", "yolov3_cfg"]


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
