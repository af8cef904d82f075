"""The command line and the result line: no card, no result; the last
line's schema; no module of JAX or the JAX package loaded."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

from hbench import result
from hbench.tests.small import run_small, small_cell

ROOT = Path(__file__).resolve().parents[2]


def test_run_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "hbench/run.py", "--workload", "mnv1-u8-b128",
                        "--seed", str(2**33 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "CUDA card" in p.stderr
    for line in p.stdout.splitlines():
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        assert not d.get("correct"), line


def test_four_card_cell_without_the_cards_exits_2():
    """The launcher looks for the cards before it starts a rank."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "hbench/run.py", "--workload", "mnv1-u8-dp4-b128",
                        "--seed", str(2**33 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2, p.stderr[-2000:]
    assert "needs 4 CUDA card(s)" in p.stderr and "[rank" not in p.stderr
    assert not p.stdout.strip()


def test_result_line_schema():
    cell = small_cell("mnv1-u8-b1")
    out = run_small("mnv1-u8-b1")
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    line = result.assemble(cell, out, device, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {m.name for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert line["attempted"] > 0 and line["failed"] == 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line, allow_nan=False))


def test_no_jax_module_loaded():
    """A small run in a fresh process leaves no module whose top-level name
    is jax, jaxlib, flax or tengine_tpu (names compared whole)."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from hbench.tests.small import run_small;"
            "out = run_small('yolov5s-i8-b8', seconds=0.2);"
            "from hbench.run import forbidden_modules;"
            "assert 'tengine_tpu_torch' in sys.modules;"
            "print('FORBIDDEN', forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FORBIDDEN []" in p.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    from hbench import run

    monkeypatch.setitem(sys.modules, "tengine_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert run.forbidden_modules() == ["jaxlib"]
