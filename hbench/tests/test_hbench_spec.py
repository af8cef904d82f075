"""BENCHMARK.json against the rules the benchmark keeps, and every part of a cell
found by name from its file."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from hbench import ranks, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# cells held out of BENCHMARK.json keep its rules
HELD = json.loads(spec.HELD.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head_dim", "expansion",
               "width", "widths", "experts_per_tok")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "hbench/run.py"]
    assert BENCH["paths"] == ["hbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_sources():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("bench", [BENCH, HELD], ids=["benchmark", "held"])
def test_cells_and_configs(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    assert len(cells) == len(bench["workloads"])
    if bench is HELD:  # found only where BENCHMARK.json has no cell of the name
        assert not set(cells) & {w["name"] for w in BENCH["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    assert set(configs) == {w["config"] for w in bench["workloads"]}
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(cells) // 4)
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (ROOT / "hbench" / "traffic" / f"{w['traffic']}.json").is_file()
        # a cell over several cards runs one rank a card of its mesh
        assert ranks.world_of(spec.load_cell(w["name"])) == w["chips"], w["name"]
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith("hbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and key not in WIDTH_WORDS
            assert key in cfg


@pytest.mark.parametrize("bench", [BENCH, HELD], ids=["benchmark", "held"])
def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = [m.name for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2, (w["name"], e2e)
        assert cell.per_layer, w["name"]
        for m in bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics"])
def test_parts_found_by_name(kind):
    """Every configuration, mix and metric named in BENCHMARK.json has its
    file, and every file there is named in BENCHMARK.json (a held cell's
    configuration in hbench/held.json)."""
    if kind == "configs":
        named = {Path(c["file"]).name for c in BENCH["configs"] + HELD["configs"]}
        on_disk = {p.name for p in (ROOT / "hbench" / "configs").glob("*.json")}
    elif kind == "traffic":
        named = {f"{w['traffic']}.json" for w in BENCH["workloads"]}
        on_disk = {p.name for p in (ROOT / "hbench" / "traffic").glob("*.json")}
    else:
        # a name with a group suffix (mfu_pct.b1) reads its own file where
        # there is one, else the reader of the name without the suffix
        metrics = ROOT / "hbench" / "metrics"
        named = {f"{n}.py" if (metrics / f"{n}.py").is_file() else f"{n.rsplit('.', 1)[0]}.py"
                 for n in (m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])}
        on_disk = {p.name for p in metrics.glob("*.py")}
        for m in BENCH["end_to_end"] + BENCH["per_layer"]:
            assert callable(spec.load_reader(m["name"]))
    assert named == on_disk


def test_missing_parts_fail_loudly(tmp_path):
    with pytest.raises(spec.SpecError, match="missing reader"):
        spec.load_reader("no_such_metric")
    with pytest.raises(spec.SpecError, match="missing reader"):
        spec.load_reader("no_such_metric.b1")
    with pytest.raises(spec.SpecError, match="workload 'no-such-cell'"):
        spec.load_cell("no-such-cell")
    bench = dict(BENCH)
    bench["workloads"] = [dict(BENCH["workloads"][0], traffic="no_such_mix")]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError, match="missing file"):
        spec.load_cell(BENCH["workloads"][0]["name"], bench_path=path)
    with pytest.raises(spec.SpecError, match="missing"):
        spec.arch_modules("no_such_arch")
