"""The control of the comparison that decides `correct`: the plain reference
put in the program's place, computed one precision below the configuration's
(4-bit grids for an 8-bit scheme), on a cell's own inputs at its own sizes.
Its numbers have to fail the configuration's limits; the benchmark's runs do
not run it.

    python3 hbench/control.py --workload <name> --seeds 1,2,3 [--bits 4]

prints one JSON line a seed: the control's numbers beside the limits.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(cell, seed: int, device, bits: int = 4) -> dict:
    """The numbers the comparison reads with the `bits`-bit reference in the
    program's place, on the inputs a run of `cell` with `seed` draws."""
    import torch

    from hbench import harness, spec
    from hbench.reference import Reference, compare

    cfg, tr = cell.config, cell.traffic
    ref_mod, _ = spec.arch_modules(cfg["arch"])
    s_params, s_cal, s_traffic, _ = harness.run_seeds(cfg, seed)
    p_specs = ref_mod.params(cfg)
    flat = harness.draw_params(p_specs, device, s_params)
    params = {k: torch.from_numpy(v).to(device)
              for k, v in harness.split_params(p_specs, flat).items()}
    cal = harness.draw_images(int(cfg["calibration"]["images"]), cfg, {}, device,
                              harness.generator(device, s_cal))
    ref8 = Reference(ref_mod, cfg, params, cal, bits=8)
    low = Reference(ref_mod, cfg, params, cal, bits=bits)
    g = ref8.input_grid
    n = int(tr.get("batch", 1)) * int(tr["ring"]) if "ring" in tr else int(tr["pool"])
    x = harness.quantize_images(
        harness.draw_images(n, cfg, tr, device, harness.generator(device, s_traffic)),
        g.scale, g.zero, cfg["scheme"])
    block, gap = int(cfg["reference_block"]), compare.Gap(float(cfg["far_lsb"]))
    for i in range(0, n, block):
        xb = x[i:i + block]
        want = ref8(xb)
        gap.add(low(xb), want, [g.scale for g in ref8.out_grids])
    grid, _ = compare.grid_numbers(low.grids(), ref8.grids(), ref8.kl_searches())
    return dict(gap.numbers(), **grid)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--bits", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from hbench import spec
    from hbench.reference import compare

    if not torch.cuda.is_available():
        print("hbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(cell, seed, torch.device("cuda"), args.bits)
        ok, checks = compare.judge(numbers, cell.config["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed, "bits": args.bits,
                          "passes_limits": ok, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
