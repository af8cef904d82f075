"""The comparison that decides `correct`: the program's outputs and grids
against the plain reference's, worked out again from the same fp32 weights
and inputs. Four numbers, and one more where the calibration is KL; those
the configuration's `limits` name are compared, each with its limit:

  grid_scale_rel  the largest relative gap between a scale the program's
                  calibration derived and the reference's, over the input,
                  the outputs and the inner grids both name alike;
  grid_zero_gap   the largest gap between their zero points;
  kl_excess       over the same grids where KL calibration derived them,
                  the widest excess, in nats, of the divergence that the
                  reference's search gives the candidate at the program's
                  threshold (scale x 127 on the int8 grid) over the least
                  it found; infinite where the program's threshold lies
                  more than a bin from every candidate. KL(P || Q) is flat
                  around its least: the program's float32 histogram and
                  the reference's float64 one can pick candidates steps
                  apart whose divergences all but tie, which reads as next
                  to nothing here, while another calibration's threshold
                  (MinMax's max |x|) lies far above the least;
  out_rel_l2      over every compared answer (one image's output map, each
                  head), ||program - reference|| / ||reference|| of the
                  dequantized values: the widest gap of any answer;
  out_far_share   over the same answers, the share of output values more
                  than the configuration's `far_lsb` steps of the
                  reference's output grid from the reference's: the
                  widest share of any answer. Rounding ties that the two
                  sides break apart spread through a deep net as a jitter
                  of a few steps; another image's answer, or none, lies
                  tens of steps away in most values.

Imports nothing of the program under test: the harness hands the program's
grids and outputs over as numbers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def grid_gaps(prog: Dict[str, Tuple[float, float]], ref: Dict[str, Tuple[float, float]]):
    """(scale gap, zero-point gap, worst name) over the grids both hold."""
    missing = sorted(set(ref) - set(prog))
    if missing:
        raise KeyError(f"the program has no grid for {missing[:5]}")
    worst, s_gap, z_gap = None, 0.0, 0.0
    for name, (rs, rz) in ref.items():
        ps, pz = prog[name]
        g = abs(ps - rs) / abs(rs)
        if g >= s_gap:
            s_gap, worst = g, name
        z_gap = max(z_gap, abs(pz - rz))
    return s_gap, z_gap, worst


def kl_excess(prog: Dict[str, Tuple[float, float]], searches: Dict[str, object],
              qmax: int = 127) -> Tuple[float, str]:
    """kl_excess over the KL grids `searches` names (each the reference's
    KLSearch), the program's threshold read off its scale on the int8
    grid; and the grid of the widest excess, for the log."""
    excess, worst = 0.0, None
    for name, search in searches.items():
        e = search.excess(prog[name][0] * qmax)
        if e >= excess:
            excess, worst = e, name
    return excess, worst


def grid_numbers(prog: Dict[str, Tuple[float, float]], ref: Dict[str, Tuple[float, float]],
                 searches: Dict[str, object]) -> Tuple[Dict[str, float], str]:
    """grid_scale_rel, grid_zero_gap and, where `searches` names KL grids,
    kl_excess; and where the widest gaps lie, for the log."""
    s_gap, z_gap, worst = grid_gaps(prog, ref)
    numbers = {"grid_scale_rel": s_gap, "grid_zero_gap": z_gap}
    where = f"scale gap at {worst!r}"
    if searches:
        numbers["kl_excess"], worst_kl = kl_excess(prog, searches)
        where += f", KL excess at {worst_kl!r}"
    return numbers, where


def rel_l2(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row (dim 0): ||prog - ref|| / ||ref||, in float64."""
    p, r = prog.double().flatten(1), ref.double().flatten(1)
    return (p - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)


def far_share(prog: torch.Tensor, ref: torch.Tensor, lsb: float, far: float) -> torch.Tensor:
    """Per row (dim 0): the share of values more than `far` steps `lsb` of
    the reference's output grid from the reference's."""
    d = (prog.double() - ref.double()).abs().flatten(1)
    return (d > far * lsb).double().mean(dim=1)


class Gap:
    """The widest gaps of the answers, compared block by block: each
    answer's out_rel_l2 and out_far_share, for each head, the widest kept;
    infinite where an answer has another count or shape than the
    reference's."""

    def __init__(self, far_lsb: float):
        self.far_lsb = far_lsb
        self.rel = None
        self.far = None

    def add(self, prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
            lsbs: Sequence[float]) -> None:
        if len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
            self.rel = self.far = float("inf")
            return
        rel = max(float(rel_l2(p, r).max()) for p, r in zip(prog, ref))
        far = max(float(far_share(p, r, s, self.far_lsb).max())
                  for p, r, s in zip(prog, ref, lsbs))
        self.rel = rel if self.rel is None else max(self.rel, rel)
        self.far = far if self.far is None else max(self.far, far)

    def numbers(self) -> Dict[str, float]:
        """out_rel_l2 and out_far_share of the widest answer (infinite where
        none could be compared)."""
        if self.rel is None:
            return {"out_rel_l2": float("inf"), "out_far_share": float("inf")}
        return {"out_rel_l2": self.rel, "out_far_share": self.far}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """correct when every number the configuration sets a limit for is
    finite and within it; the checks as printed, in a fixed order."""
    checks, ok = [], True
    for name in sorted(limits):
        if name not in numbers:
            raise KeyError(f"a limit for {name!r}, which the comparison does not read")
        v, lim = numbers[name], limits[name]
        passed = bool(np.isfinite(v)) and v <= lim
        ok &= passed
        checks.append({"name": name, "value": v, "limit": lim, "ok": passed})
    return ok, checks
