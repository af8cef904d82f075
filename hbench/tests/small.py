"""Each cell at a size a CPU test holds: the same configuration and mix,
with the image, the batch, the pools and the mesh cut (widths as
published, but ResNet-50's)."""

from __future__ import annotations

import time

SMALL = {
    "mnv1-u8-b128": ({"img": 64}, {"batch": 4, "ring": 2, "warm_s": 0.05}),
    "yolov5s-i8-b8": ({"img": 64}, {"batch": 2, "ring": 2, "warm_s": 0.05}),
    "mnv1-u8-b1": ({"img": 64}, {"pool": 4, "warm_s": 0.05}),
    "yolov5s-i8-served": ({"img": 64}, {"pool": 4, "rate_rps": 40.0, "sample": 8,
                                         "max_batch": 4, "buckets": [1, 2, 4],
                                         "warm_s": 0.1}),
    # the image and the widths an eighth of the published
    "resnet50-i8kl-b128": ({"img": 32, "stem_width": 8, "widths": [8, 16, 32, 64]},
                           {"batch": 4, "ring": 2, "warm_s": 0.05}),
}
# cells over several cards: one process a place of the mesh, gloo on the CPU
SMALL_RANKS = {
    "mnv1-u8-dp4-b128": ({"img": 64}, {"batch": 4, "ring": 2, "mesh": [2, 1], "warm_s": 0.05}),
}
SEED = 2**40 + 12345


def small_cell(name: str):
    from hbench import spec

    cfg, tr = {**SMALL, **SMALL_RANKS}[name]
    return spec.load_cell(name, config_over=cfg, traffic_over=tr)


def run_small(name: str, seed: int = SEED, seconds: float = 0.4) -> dict:
    """One run of cell `name` on the CPU at its small size, past the
    harness's look for a card."""
    from hbench import harness

    t0 = time.perf_counter()
    return harness.run_cell(small_cell(name), seed, seconds, False, "cpu",
                            lambda: time.perf_counter() - t0)
