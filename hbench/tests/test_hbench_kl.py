"""KL calibration in the plain reference, on the CPU: its search picks the
program's threshold on the same histogram; on the ResNet-50 cell at a small
size every grid is a KL grid, and MinMax calibration in KL's place fails
the limits (test_hbench_correct.py runs the cell sound, with each fault of
the timed path and as the 4-bit control); the MinMax configurations'
reference grids are those the reference derived before KL came in."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from hbench import harness, spec
from hbench.faults import plant
from hbench.reference import Reference
from hbench.reference.qsim import Ctx, abs_histogram, kl_search
from hbench.tests.small import SEED, run_small, small_cell

CELL = "resnet50-i8kl-b128"


def _values(kind: str, rng: np.random.Generator) -> np.ndarray:
    n = 100_000
    if kind == "normal":
        return rng.standard_normal(n)
    if kind == "relu":
        return np.maximum(rng.standard_normal(n), 0.0)
    if kind == "heavy":
        return rng.standard_t(3, n)
    if kind == "levels":  # 256 levels on [-1, 1], as the input images
        return np.round(rng.uniform(-1, 1, n) * 127.5) / 127.5
    return rng.laplace(size=n) * (rng.uniform(size=n) < 0.2)  # sparse


@pytest.mark.parametrize("kind", ["normal", "relu", "heavy", "levels", "sparse"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_picks_the_programs_threshold(kind, seed):
    """The program's kl_int8 on numpy's histogram, and the reference's search
    on its own: the same candidate."""
    from tengine_tpu_torch.quantize.calibrate import ActivationStats, kl_int8

    x = _values(kind, np.random.default_rng(seed)).astype(np.float32)
    amax = max(abs(float(x.min())), abs(float(x.max())))
    h, _ = np.histogram(np.abs(x[x != 0]), bins=2048, range=(0, amax))
    stats = ActivationStats(min=float(x.min()), max=float(x.max()),
                            hist=h.astype(np.float64), hist_max=amax)
    scale = float(np.asarray(kl_int8(stats).scales).reshape(-1)[0])
    t_prog = scale * 127 / amax * 2048 - 0.5
    hist, ref_amax = abs_histogram(torch.from_numpy(x))
    assert ref_amax == amax
    search = kl_search(hist, ref_amax)
    assert abs(search.best - t_prog) < 1e-3
    assert search.excess(scale * 127) == 0.0


def _reference(name: str):
    """The reference of cell `name` at its small size, calibrated on SEED's
    weights and images and called on two of them; its parameters and
    calibration images."""
    cfg = small_cell(name).config
    ref_mod, _ = spec.arch_modules(cfg["arch"])
    s_params, s_cal, _, _ = harness.run_seeds(cfg, SEED)
    dev = torch.device("cpu")
    p_specs = ref_mod.params(cfg)
    params = {k: torch.from_numpy(v) for k, v in
              harness.split_params(p_specs, harness.draw_params(p_specs, dev, s_params)).items()}
    cal = harness.draw_images(int(cfg["calibration"]["images"]), cfg, {}, dev,
                              harness.generator(dev, s_cal))
    ref = Reference(ref_mod, cfg, params, cal)
    g = ref.input_grid
    ref(harness.quantize_images(cal[:2], g.scale, g.zero, cfg["scheme"]))
    return ref, params, cal


def test_every_grid_is_kl():
    ref, params, cal = _reference(CELL)
    assert set(ref.kl_searches()) == set(ref.grids())
    ctx = Ctx("calib", "int8", histograms=True)
    with pytest.raises(ValueError, match="one batch"):
        for x in (cal[:1], cal[1:2]):
            ref.arch.forward(ctx, params, x.double(), ref.cfg)


def test_minmax_in_place_of_kl_is_not_correct():
    with plant("calib_minmax"):
        out = run_small(CELL)
    assert not out["correct"], out["checks"]
    limits = small_cell(CELL).config["limits"]
    assert out["numbers"]["kl_excess"] > 3 * limits["kl_excess"], out["numbers"]


# the MinMax reference grids (input, outputs, inner) of each configuration at
# its small size on SEED, as the reference derived them before KL came in:
# how many, and the sha256 of their sorted (name, scale.hex(), zero point)
PINNED = {
    "mnv1-u8-b128": (30, "f7b41a369e1b87902cb9bf8897c1d41cee424adaed486e1b632ef7a6dbd9e883"),
    "yolov5s-i8-b8": (63, "193b3f22b308e0d402081e45f2e17b824f1c875e514094bfdb27f8b74b80f81b"),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_minmax_grids_are_unchanged(name):
    ref, _, _ = _reference(name)
    items = sorted((k, float(s).hex(), int(z)) for k, (s, z) in ref.grids().items())
    assert ref.kl_searches() == {}
    assert (len(items), hashlib.sha256(json.dumps(items).encode()).hexdigest()) == PINNED[name]
