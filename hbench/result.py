"""The result line of a run, from the metric readers."""

from __future__ import annotations

import math

from hbench import spec as specs


def metrics(cell: specs.Cell, run, trace: bool) -> dict:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (trace
    on), each from its reader. A per-layer reader that finds nothing to read
    returns None and its metric is left out; an end-to-end metric is always
    there."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(run)
        if v is None:
            if m.kind == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m.name!r} read nothing")
            continue
        v = float(v)
        if not math.isfinite(v):
            raise RuntimeError(f"metric {m.name!r} read {v}")
        out[m.name] = {"value": v, "unit": m.unit}
    return out


def assemble(cell: specs.Cell, out: dict, device: dict, trace: bool) -> dict:
    run = out["run"]
    w = run.window
    line = {
        "correct": bool(out["correct"]),
        "attempted": int(w.attempted),
        "failed": int(w.failed),
        "metrics": metrics(cell, run, trace),
        "device": dict(device),
    }
    if trace and run.slice is not None:
        line["device"]["busy_s"] = run.slice["busy_s"]
        line["device"]["window_s"] = run.slice["window_s"]
        line["breakdown"] = {"device_ops": run.slice["device_ops"],
                             "idle_gaps": run.slice["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"] if math.isfinite(c["value"]) else None,
                                  "limit": c["limit"]}
                      for c in out["checks"]}
    return line
