"""The plain reference: calibration and the integer forward worked out again
from the fp32 weights and inputs, in plain PyTorch, importing nothing of the
program under test (qsim.py: the quantization; one module per architecture;
compare.py: the numbers that decide `correct`)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from hbench.reference.qsim import QT, Ctx, Grid, KLSearch, calibrate, calibrate_kl


class Reference:
    """Architecture module `arch` at configuration `cfg`, calibrated on
    `cal_images` (fp32, NCHW, one batch) by the configuration's algorithm
    (MinMax, or KL for the int8 scheme) with its scheme, and run on
    `bits`-bit grids (8: the reference; fewer: the control)."""

    def __init__(self, arch, cfg: dict, params: Dict[str, torch.Tensor],
                 cal_images: torch.Tensor, bits: int = 8):
        self.arch, self.cfg, self.p = arch, cfg, params
        self.scheme = cfg["scheme"]
        fwd = lambda ctx, p, x: arch.forward(ctx, p, x, cfg)  # noqa: E731
        algorithm = cfg["calibration"]["algorithm"]
        if algorithm == "kl":
            self.ranges, searches = calibrate_kl(fwd, params, cal_images, self.scheme)
        elif algorithm == "minmax":
            self.ranges, searches = calibrate(fwd, params, [cal_images], self.scheme), {}
        else:
            raise ValueError(f"unknown calibration algorithm {algorithm!r}")
        self.ctx = Ctx("quant", self.scheme, bits, self.ranges, searches)
        # the images are data handed alike to every side: always on the
        # 8-bit input grid
        self.input_grid = Ctx("quant", self.scheme, 8, self.ranges, searches).grid("data")
        self.out_grids = None

    def __call__(self, xq: torch.Tensor) -> List[torch.Tensor]:
        """The dequantized outputs for integer inputs `xq` (NCHW)."""
        with torch.no_grad():
            outs = self.arch.forward(self.ctx, self.p, QT(xq.double(), self.input_grid), self.cfg)
        self.out_grids = [o.grid for o in outs]
        return [o.real() for o in outs]

    def _named(self) -> Dict[str, Grid]:
        g = {"data": self.input_grid}
        for i, og in enumerate(self.out_grids or []):
            g[f"out{i}"] = og
        for name in self.arch.grid_names(self.cfg):
            g[name] = self.ctx.grid(name)
        return g

    def grids(self) -> Dict[str, Tuple[float, float]]:
        """(scale, zero point) of the input ("data"), the outputs ("out<i>",
        after a call) and the inner grids the architecture compares by name."""
        return {k: (g.scale, g.zero) for k, g in self._named().items()}

    def kl_searches(self) -> Dict[str, KLSearch]:
        """The KL search of each grid of grids() that KL calibration derived
        (none under MinMax)."""
        return {k: g.kl for k, g in self._named().items() if g.kl is not None}
