"""The comparison that decides `correct`, on the CPU at small sizes: the
program agrees with the plain reference within the configurations' limits;
the control (the reference on 4-bit grids in the program's place) fails
them; and a run whose timed path is broken underneath comes out not
correct, once for each fault the cell can have."""

from __future__ import annotations

import pytest
import torch

from hbench.faults import FAULTS, plant
from hbench.tests.small import SEED, SMALL, run_small, small_cell

CELLS = sorted(SMALL)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["compared"] > 0
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["mnv1-u8-b128", "yolov5s-i8-b8", "resnet50-i8kl-b128"])
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_fails_the_limits(name, seed):
    from hbench.control import control_numbers
    from hbench.reference import compare

    cell = small_cell(name)
    numbers = control_numbers(cell, seed, torch.device("cpu"), bits=4)
    ok, checks = compare.judge(numbers, cell.config["limits"])
    assert not ok, checks
    # the answers fail, not only the grids
    assert any(not c["ok"] for c in checks if c["name"].startswith("out_")), checks


# batch-1 cells cannot lose half of a batch or swap rows
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (c == "mnv1-u8-b1" and f in ("half_batch", "rows_swapped"))]


@pytest.mark.parametrize("name,fault", CASES)
def test_broken_timed_path_is_not_correct(name, fault):
    with plant(fault):
        out = run_small(name)
    assert not out["correct"], out["checks"]
