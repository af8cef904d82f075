"""On the card: a short run of each cell comes out correct (on as many cards
as it asks for), and the control and the planted faults fail the limits at
the cell's own size. They skip without a card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["mnv1-u8-b128", "yolov5s-i8-b8", "mnv1-u8-b1", "yolov5s-i8-served", "mnv1-u8-dp4-b128",
         "resnet50-i8kl-b128"]


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(card, name):
    import torch

    from hbench import spec

    chips = spec.load_cell(name).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA cards")
    p = subprocess.run([sys.executable, "hbench/run.py", "--workload", name, "--seed",
                        str(2**33 + 101), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_full_size(card, name):
    from hbench import spec
    from hbench.control import control_numbers
    from hbench.reference import compare

    cell = spec.load_cell(name)
    ok, checks = compare.judge(control_numbers(cell, 2**33 + 7, card, bits=4),
                               cell.config["limits"])
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["yolov5s-i8-b8", "yolov5s-i8-served"])
@pytest.mark.parametrize("fault", ["stale", "rows_swapped"])
def test_fault_fails_at_full_size(card, name, fault):
    """A stale answer, or another request's row, at the cell's own size
    comes out not correct through the harness's own judge."""
    from hbench import harness, spec
    from hbench.faults import plant

    with plant(fault):
        out = harness.run_cell(spec.load_cell(name), 2**33 + 11, 2.0, False, card, lambda: 0.0)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["stale", "rows_swapped", "calib_minmax"])
def test_kl_cell_fault_fails_at_full_size(card, fault):
    """The same on the KL cell, and MinMax calibration in KL's place, planted
    around the whole run."""
    from hbench import harness, spec
    from hbench.faults import plant

    with plant(fault):
        out = harness.run_cell(spec.load_cell("resnet50-i8kl-b128"), 2**33 + 11, 2.0, False,
                               card, lambda: 0.0)
    assert not out["correct"], out["checks"]
