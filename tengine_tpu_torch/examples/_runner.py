"""Shared example-CLI runner: build a zoo graph, optionally quantize it the
way the reference's *_uint8/*_int8 example variants do, compile, run, and
hand back dequantized fp32 outputs + timing.

The reference ships a separate .cpp per precision (tm_yolact.cpp,
tm_yolact_uint8.cpp, ...); here every example CLI takes `-q fp32|uint8|int8`
and shares this path, so one file covers the whole variant row.

Every example takes --device (default: the card, through
executor/engine.py:resolve_device, which raises without one; "cpu" runs on
the CPU) and its main(argv) returns what it printed as data.
"""

import argparse
import time
from typing import Any, List, NamedTuple

import numpy as np


class Ran(NamedTuple):
    """What run_graph ran: the outputs as fp32 (dequantized), the ms a timed
    call, the engine's own outputs, the graph that ran (quantized unless
    fp32), its CompiledGraph and the input it was given."""

    outs: List[np.ndarray]
    ms: float
    raw: List[np.ndarray]
    graph: Any
    session: Any
    input: np.ndarray


def add_device(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return ap


def device_of(args):
    """The device the example runs on: the card unless --device names
    another (raises without a card)."""
    from ..executor.engine import resolve_device

    return resolve_device(args.device)


def std_parser(**defaults):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", default=None)
    ap.add_argument(
        "-q", "--quant", choices=["fp32", "int8", "uint8"],
        default=defaults.get("quant", "fp32"),
    )
    ap.add_argument("-s", "--size", type=int, default=defaults.get("size", 320))
    ap.add_argument("-r", "--repeat", type=int, default=1)
    return add_device(ap)


def load_input(args, mean=0.0, scale=1.0 / 255.0):
    """Image file -> normalized NCHW float input (synthetic if no -i)."""
    size = args.size
    if args.image:
        from PIL import Image

        img = np.asarray(
            Image.open(args.image).convert("RGB").resize((size, size))
        ).astype(np.float32)
        x = ((img - np.asarray(mean, np.float32))
             * np.asarray(scale, np.float32)).transpose(2, 0, 1)[None]
        return np.ascontiguousarray(x, np.float32)
    return np.random.default_rng(0).standard_normal(
        (1, 3, size, size)
    ).astype(np.float32)


def quantize(g, x, scheme, device, algorithm="minmax"):
    """(quantized graph, x on its input grid): MinMax calibration on x."""
    from ..ops import qmath
    from ..quantize.quantizer import quantize_graph

    qg = quantize_graph(g, [x], scheme=scheme, algorithm=algorithm, device=device)
    t_in = qg.tensors[qg.input_tensors[0]]
    return qg, qmath.quantize_np(x, t_in.quant, t_in.dtype)


def dequantize_outputs(qg, outs):
    """The quantized graph's integer outputs on their grids, as fp32 (a
    float output passes through)."""
    from ..ops import qmath

    out_ids = [qg.nodes[i].outputs[0] for i in qg.outputs]
    return [
        np.asarray(o, np.float32)
        if not np.issubdtype(np.asarray(o).dtype, np.integer)
        else qmath.dequantize_np(np.asarray(o, np.float32), qg.tensors[t].quant)
        for o, t in zip(outs, out_ids)
    ]


def timed(cg, x, repeat=1, warm=True):
    """(outputs, ms a call): one untimed call first when `warm` (on the card,
    the call that captures the CUDA graph), then `repeat` timed calls.
    CompiledGraph.run returns numpy, so the wall time waits for the card."""
    if warm:
        cg.run(x)
    t0 = time.time()
    for _ in range(repeat):
        outs = cg.run(x)
    return outs, (time.time() - t0) / repeat * 1e3


def run_graph(g, x, quant="fp32", repeat=1, device=None):
    """Compile (quantizing first unless fp32), run; returns a Ran."""
    from ..executor.engine import compile_graph
    from ..utils.config import Options

    if quant != "fp32":
        qg, xq = quantize(g, x, quant, device)
        cg = compile_graph(qg, Options(quant_mode="fast"), device=device)
        raw, ms = timed(cg, xq, repeat)
        return Ran(dequantize_outputs(qg, raw), ms, raw, qg, cg, xq)
    cg = compile_graph(g, Options(precision="fp32"), device=device)
    raw, ms = timed(cg, x, repeat)
    return Ran([np.asarray(o, np.float32) for o in raw], ms, raw, g, cg, x)
