"""Operations and bytes of one forward, from the quantized network's own
semantics (hbench/reference/qsim.py's count mode over the architecture's
reference), never from what the program stores or which kernel runs:

  ops    2 per multiply-add of each convolution and fully connected layer
         over the taps that fall inside its input, plus 1 per output
         element of a bias (the count of the program's
         CompiledGraph.cost_analysis()["flops"], frozen here);
  bytes  the input read once, every op output written once and read once
         at one byte (concat, upsampling and the Focus slices are views),
         the network's outputs written once; weights 1 byte each and int32
         biases 4, once a forward.

The peaks are NVIDIA's published dense figures for one H100 SXM: 1,979
TOP/s int8 and 3.35 TB/s; a card set below 700 W reaches less (its power
limit is printed beside every result)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hbench.reference.qsim import Ctx

PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


@dataclass(frozen=True)
class Counts:
    ops_per_image: int
    bytes_per_image: int  # activations
    param_bytes: int  # once a forward

    def forward(self, batch: int):
        """(ops, bytes) of one forward at `batch`."""
        return batch * self.ops_per_image, batch * self.bytes_per_image + self.param_bytes

    def least_s(self, batch: int) -> float:
        """The forward's least time on the peaks: compute or bandwidth."""
        ops, nbytes = self.forward(batch)
        return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def count(ref, cfg: dict) -> Counts:
    """The counts of architecture `ref` (a hbench/reference module) at
    configuration `cfg`, for one image."""
    ctx = Ctx("count")
    p = {name: torch.empty(shape, device="meta") for name, shape, *_ in ref.params(cfg)}
    x = torch.empty((1, 3, cfg["img"], cfg["img"]), device="meta")
    outs = ref.forward(ctx, p, x, cfg)
    written_once = sum(o.numel() for o in outs)
    return Counts(int(ctx.ops), int(ctx.act_bytes - written_once), int(ctx.param_bytes))
