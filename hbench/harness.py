"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the result.

Set-up draws the fp32 weights and every input from the seed on the device
(the weights and calibration images from the configuration's own
`model_seed` where it gives one), builds the configuration's model for the
program, calibrates it (by the configuration's algorithm, on a few seeded
images), compiles the cell's own batch shapes only and warms them up. The
window is the traffic mix's loop. Then the device's peak memory since the
inputs were drawn is read, the program's state is freed, and the reference
works calibration and the integer forward out again from the same weights
and inputs, to judge the program's answers.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hbench import counts as counting
from hbench import faults
from hbench import spec as specs
from hbench import traffic as traffics
from hbench import trace as tracing
from hbench.reference import Reference
from hbench.reference import compare
from hbench.reference.qsim import round_away

# activation dtype of each scheme and its clip range
SCHEMES = {"uint8": (torch.uint8, 0, 255), "int8": (torch.int8, -127, 127)}


@dataclass
class Run:
    """What the metric readers read (hbench/metrics/<name>.py)."""

    cell: str
    batch: int
    counts: counting.Counts
    chips: int = 1  # the cards the window ran on, one rank each
    rows: Optional[int] = None  # of one rank's forward, where not the batch
    setup_s: float = 0.0
    calib_s: float = 0.0
    compile_s: float = 0.0
    window: Optional[traffics.Window] = None
    slice: Optional[dict] = None  # the traced slice of the window
    per_fwd: Optional[dict] = None  # the profiled forwards after the window


def seeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds drawn from the run's seed."""
    st = np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)
    return [int(s) >> 1 for s in st]


def run_seeds(cfg: dict, seed: int) -> List[int]:
    """The seeds of the weights, the calibration images, the traffic's
    images and the loop, drawn from the run's seed; where the configuration
    gives a `model_seed`, the weights and the calibration images are drawn
    from that instead: one model, calibrated once, as a deployment has it,
    under the run's traffic."""
    s = seeds(seed, 4)
    if "model_seed" in cfg:
        s[:2] = seeds(int(cfg["model_seed"]), 4)[:2]
    return s


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def draw_params(param_specs, device, seed: int) -> np.ndarray:
    """Every parameter in one call on the device: mean + std * z (|z| where
    the spec asks), as one float32 host array in spec order."""
    sizes = [int(np.prod(s[1])) for s in param_specs]
    mean = np.repeat(np.array([s[2] for s in param_specs], np.float32), sizes)
    std = np.repeat(np.array([s[3] for s in param_specs], np.float32), sizes)
    absz = np.repeat(np.array([len(s) > 4 and s[4] for s in param_specs]), sizes)
    z = torch.randn(sum(sizes), generator=generator(device, seed), device=device)
    absz_t = torch.from_numpy(absz).to(device)
    v = torch.from_numpy(mean).to(device) + torch.from_numpy(std).to(device) * torch.where(
        absz_t, z.abs(), z)
    return v.cpu().numpy()


def split_params(param_specs, flat: np.ndarray) -> Dict[str, np.ndarray]:
    out, o = {}, 0
    for s in param_specs:
        n = int(np.prod(s[1]))
        out[s[0]] = flat[o:o + n].reshape(s[1])
        o += n
    return out


def draw_images(n: int, cfg: dict, traffic: dict, device, gen: torch.Generator) -> torch.Tensor:
    """n fp32 images [n, 3, img, img] on the device, photo-like: a smooth
    random field (Gaussian noise on a grid of `blob`-pixel cells, upsampled
    bilinearly) at a contrast drawn from `contrast`, over a colour drawn per
    channel from `offset`, with fine noise of std `fine`, on [0, 1]; each
    pixel then one of `levels` evenly spaced values mapped onto [lo, hi].
    With the mix's `letterbox_hw` the rows outside a centred (h, w) picture
    hold level `pad_level`."""
    spec, img = cfg["inputs"], cfg["img"]
    levels = int(spec["levels"])
    cells = max(1, img // int(spec["blob"]))
    field = torch.nn.functional.interpolate(
        torch.randn((n, 3, cells, cells), generator=gen, device=device), size=(img, img),
        mode="bilinear", align_corners=False)
    (c_lo, c_hi), (o_lo, o_hi) = spec["contrast"], spec["offset"]
    contrast = c_lo + (c_hi - c_lo) * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    offset = o_lo + (o_hi - o_lo) * torch.rand((n, 3, 1, 1), generator=gen, device=device)
    fine = float(spec["fine"]) * torch.randn((n, 3, img, img), generator=gen, device=device)
    k = torch.round((offset + contrast * field + fine).clamp(0.0, 1.0) * (levels - 1))
    box = traffic.get("letterbox_hw")
    if box:
        h, w = (min(int(v), img) for v in box)
        top, left = (img - h) // 2, (img - w) // 2
        keep = torch.zeros((img, img), dtype=torch.bool, device=device)
        keep[top:top + h, left:left + w] = True
        k = torch.where(keep, k, torch.full_like(k, float(traffic["pad_level"])))
    lo, hi = float(spec["lo"]), float(spec["hi"])
    return lo + (hi - lo) * k / (levels - 1)


def quantize_images(x: torch.Tensor, scale: float, zero: int, scheme: str) -> torch.Tensor:
    """Images onto the model's input grid: round half away from zero."""
    dt, lo, hi = SCHEMES[scheme]
    q = torch.clamp(round_away(x.double() / scale) + zero, lo, hi)
    return q.to(dt)


def _grid(t):
    q = t.quant
    return float(np.asarray(q.scales).reshape(-1)[0]), float(np.asarray(q.zero_points).reshape(-1)[0])


def program_grids(qg, inner: List[str]) -> Dict[str, tuple]:
    """The grids the program's calibration derived: the input ("data"), the
    outputs ("out<i>", in the order the forward returns them) and the inner
    tensors by name."""
    g = {"data": _grid(qg.tensors[qg.input_tensors[0]])}
    for i, tid in enumerate(qg.output_tensors):
        g[f"out{i}"] = _grid(qg.tensors[tid])
    for name in inner:
        t = qg.find_tensor(name)
        if t is None or t.quant is None:
            raise KeyError(f"the program's graph has no quantized tensor {name!r}")
        g[name] = _grid(t)
    return g


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Prepared:
    """A cell made ready to run: the program's quantized graph, the traffic
    mix's loop (not yet set up), and what the reference needs."""

    ref_mod: object
    p_specs: list
    flat: np.ndarray
    cal: torch.Tensor
    qg: object
    loop: traffics.Loop
    calib_s: float


def prepare(cell: specs.Cell, seed: int, device) -> Prepared:
    """Draws the weights and inputs from `seed`, builds the model for the
    program and calibrates it; the loop's own set-up comes after."""
    cfg, tr = cell.config, cell.traffic
    ref_mod, model_mod = specs.arch_modules(cfg["arch"])
    s_params, s_cal, s_traffic, s_loop = run_seeds(cfg, seed)
    p_specs = ref_mod.params(cfg)
    flat = draw_params(p_specs, device, s_params)
    graph = model_mod.build(cfg, split_params(p_specs, flat))
    cal = draw_images(int(cfg["calibration"]["images"]), cfg, {}, device,
                      generator(device, s_cal))

    from tengine_tpu_torch.quantize.quantizer import quantize_graph

    t = time.perf_counter()
    qg = quantize_graph(graph, [cal.cpu().numpy()], scheme=cfg["scheme"],
                        algorithm=cfg["calibration"]["algorithm"], device=device)
    calib_s = time.perf_counter() - t
    in_scale, in_zero = _grid(qg.tensors[qg.input_tensors[0]])
    g_traffic = generator(device, s_traffic)

    def make(n):
        """n quantized images on the device, drawn in the loop's set-up. The
        device's peak memory is then reset: it counts from here the inputs,
        the compiled forward's warm-up and capture (a captured graph's
        buffers are allocated then, not at replay) and the window, and not
        calibration or the drawing's own temporaries."""
        x = quantize_images(draw_images(n, cfg, tr, device, g_traffic), in_scale, in_zero,
                            cfg["scheme"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        return x

    loop = traffics.loop_for(tr["kind"])(qg, device, tr, make, np.random.default_rng(s_loop))
    return Prepared(ref_mod, p_specs, flat, cal, qg, loop, calib_s)


def run_cell(cell: specs.Cell, seed: int, seconds: float, trace: bool, device,
             setup_clock: Callable[[], float], window_fault: Optional[str] = None) -> Optional[dict]:
    """One run. `setup_clock()` gives the seconds since the run began
    (set-up ends at the first timed call). `window_fault` names a fault of
    hbench/faults.py planted in the timed path for the window only. Returns
    the result's fields; None on a rank of a run over several cards that
    leaves the judging to rank 0."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = cell.config
    t_in = setup_clock()
    pr = prepare(cell, seed, device)
    t_prep = setup_clock()
    loop = pr.loop
    compile_s = loop.setup()
    t_loop = setup_clock()
    if trace and cuda:
        tracing.warm_up(device)
    run = Run(cell=cell.name, batch=loop.batch, counts=counting.count(pr.ref_mod, cfg),
              chips=loop.ranks, rows=loop.rows, calib_s=pr.calib_s, compile_s=compile_s)
    if cuda:
        torch.cuda.synchronize(device)
    sl = loop.slice_at(seconds) if trace and cuda else None
    run.setup_s = setup_clock()
    log(f"hbench: set-up {run.setup_s:.3f} s, by phase: to the harness {t_in:.3f}, weights "
        f"and model {t_prep - t_in - pr.calib_s:.3f}, calibration {pr.calib_s:.3f}, the "
        f"loop's set-up {t_loop - t_prep:.3f} (compile and capture {compile_s:.3f}), then "
        f"{run.setup_s - t_loop:.3f}")
    with faults.plant(window_fault) if window_fault else contextlib.nullcontext():
        run.window = loop.window(seconds, sl)
    if sl is not None:
        run.slice = sl.reduce()
    if trace and cuda:
        run.per_fwd = loop.per_forward()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    # the program's answers and grids, then its state is freed
    answers = loop.answers()
    peak, run.slice, across = loop.across(peak, run.slice)
    prog_grids = program_grids(pr.qg, pr.ref_mod.grid_names(cfg))
    out_grids = [pr.qg.tensors[tid].quant for tid in pr.qg.output_tensors]
    loop.close()
    pr.qg = pr.loop = loop = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if across is None:
        return None

    numbers = judge_answers(pr.ref_mod, cfg, pr.flat, pr.p_specs, pr.cal, answers, prog_grids,
                            out_grids, device)
    # the ranks' own readings agree exactly, or the run is not correct
    numbers.update(across)
    ok, checks = compare.judge(numbers, dict(cfg["limits"], **dict.fromkeys(across, 0)))
    if not answers:
        ok = False
    return {"run": run, "correct": ok, "checks": checks, "numbers": numbers, "peak": peak,
            "compared": len(answers)}


def judge_answers(ref_mod, cfg, flat, p_specs, cal, answers, prog_grids, out_grids, device,
                  bits: int = 8) -> Dict[str, float]:
    """The numbers compared: the program's answers and grids against the
    reference's on the same integer inputs."""
    params = {k: torch.from_numpy(v).to(device)
              for k, v in split_params(p_specs, flat).items()}
    ref = Reference(ref_mod, cfg, params, cal, bits=bits)
    block = int(cfg["reference_block"])
    gap = compare.Gap(float(cfg["far_lsb"]))
    for xq, outs in answers:
        for i in range(0, xq.shape[0], block):
            want = ref(xq[i:i + block].to(device))
            got = []
            for o, g in zip(outs, out_grids):
                s, z = float(np.asarray(g.scales).reshape(-1)[0]), float(
                    np.asarray(g.zero_points).reshape(-1)[0])
                got.append((o[i:i + block].to(device).double() - z) * s)
            gap.add(got, want, [g.scale for g in ref.out_grids])
    grid, where = compare.grid_numbers(prog_grids, ref.grids(), ref.kl_searches())
    numbers = dict(gap.numbers(), **grid)
    log(f"reference: {sum(x.shape[0] for x, _ in answers)} answers compared; widest "
        f"{where}; numbers {numbers}")
    return numbers
