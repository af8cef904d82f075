"""Finds every part of a cell by name: BENCHMARK.json's entry, the
configuration's file, the traffic mix's file, the architecture's modules and
each metric's reader. Nothing here names a cell, a configuration, a mix or a
metric: a later change adds one by adding files and entries. A part that is
missing fails loudly, naming the file it looked for."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# cells built and judged but not yet in BENCHMARK.json, in its form: the
# tests and `hbench/run.py --workload <name>` find them here
HELD = HERE / "held.json"


class SpecError(RuntimeError):
    """A part of the benchmark is missing or malformed."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing file: {path}")
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise SpecError(f"{path}: not JSON ({e})") from e


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    hits = [e for e in entries if e.get("name") == name]
    if len(hits) != 1:
        known = ", ".join(sorted(e.get("name", "?") for e in entries))
        raise SpecError(f"{what} {name!r}: {len(hits)} entries in BENCHMARK.json (known: {known})")
    return hits[0]


def load_reader(name: str, base: Path = HERE / "metrics") -> Callable:
    """The `read(run)` function of metric `name`: metrics/<name>.py, or,
    where that is missing, the reader of the name without its last
    `.<group>` (mfu_pct.b1 reads as mfu_pct: one quantity split by the
    end-to-end metric it moves)."""
    path = base / f"{name}.py"
    if not path.is_file() and "." in name:
        path = base / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise SpecError(f"metric {name!r}: missing reader {base / f'{name}.py'}")
    spec = importlib.util.spec_from_file_location(f"hbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    read = getattr(mod, "read", None)
    if not callable(read):
        raise SpecError(f"metric {name!r}: {path} has no read(run)")
    return read


def arch_modules(arch: str):
    """The reference (plain PyTorch) and the program-side model of an
    architecture: reference/<arch>.py and models/<arch>.py."""
    for sub in ("reference", "models"):
        if not (HERE / sub / f"{arch}.py").is_file():
            raise SpecError(f"architecture {arch!r}: missing {HERE / sub / f'{arch}.py'}")
    return (importlib.import_module(f"hbench.reference.{arch}"),
            importlib.import_module(f"hbench.models.{arch}"))


@dataclass
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" | "per_layer"
    read: Callable


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list names the cell,
    or, without one, an end-to-end metric is reported everywhere and a
    per-layer one wherever the metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def _names(bench: dict) -> set:
    return {w.get("name") for w in bench.get("workloads", [])}


def load_cell(name: str, bench_path: Optional[Path] = None,
              config_over: Optional[dict] = None, traffic_over: Optional[dict] = None) -> Cell:
    """The cell `name` with its configuration, its traffic mix and the
    readers of the metrics it reports, from BENCHMARK.json or, for a cell
    held out of it, from HELD. The overrides replace keys of the
    configuration and of the mix (the tests run cells at small sizes)."""
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    if bench_path is None and not _names(bench) & {name} and HELD.is_file():
        held = load_json(HELD)
        bench = held if _names(held) & {name} else bench
    wl = _by_name(bench.get("workloads", []), name, "workload")
    conf = _by_name(bench.get("configs", []), wl["config"], "config")
    cfg = load_json(ROOT / conf["file"])
    cfg.update(config_over or {})
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    traffic.update(traffic_over or {})
    cell = Cell(name=name, config=cfg, traffic=traffic, chips=int(wl["chips"]))
    e2e = [m for m in bench.get("end_to_end", []) if _reports(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    for m in e2e:
        cell.end_to_end.append(Metric(m["name"], m["unit"], "end_to_end", load_reader(m["name"])))
    for m in bench.get("per_layer", []):
        if _reports(m, name, e2e_names):
            cell.per_layer.append(Metric(m["name"], m["unit"], "per_layer", load_reader(m["name"])))
    return cell
