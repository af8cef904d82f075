#!/usr/bin/env python3
"""Run the PyTorch port (tengine_tpu_torch) on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # the check, on one card
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one batch

Phases, in order; any failure raises and the exit code is not 0:
  1. build     nvcc builds every tengine_tpu_torch/csrc/*.cu for sm_90a, one
               process per source, all started together.
  2. kernels   each kernel against its plain version on the card, on the
               test grid and at the main path's shape; kernel, plain and
               library-call times (CUDA events) and the least time the card
               could take (bound).
  3. main path yolov5s 640x640 INT8 (MinMax), seed-0 weights: quantize_graph
               on the card with one seeded calibration image, compile_graph
               at batch 8, 3 batches; every kernel's launch count is read
               around this run.
  4. check     every head's dequantized cosine against the port's fp32 engine
               > 0.95 (the gate of tests/test_yolov5.py), and within 1 LSB of
               the port's CPU run on the first image.

The last lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}. Nothing here imports JAX or
the JAX package; without a card, or without the package beside it, the
script fails and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stem_case(torch, k, mode, zp_w, B, H, seed, C=3, Cout=32):
    """Seeded stem inputs on the card (the grid of tests/test_torch_stem.py)."""
    from tengine_tpu_torch.ops.cuda.stem_conv import pack_stem_weights

    rng = np.random.default_rng(seed)
    if mode == "s8":
        x = rng.integers(-127, 128, (B, C, H, H)).astype(np.int8)
        q = dict(zp_in=0, zp_out=0, lo=-127.0, hi=127.0)
        w = rng.integers(-127, 128, (Cout, C, k, k)).astype(np.float32)
    else:
        x = rng.integers(0, 256, (B, C, H, H)).astype(np.uint8)
        q = dict(zp_in=117, zp_out=121, lo=0.0, hi=255.0)
        w = rng.integers(0 if zp_w else -127, 128 + (128 if zp_w else 0),
                         (Cout, C, k, k)).astype(np.float32)
    mult = rng.random(Cout).astype(np.float32) * 1e-3 + 1e-4
    bias = rng.standard_normal(Cout).astype(np.float32)
    wm, m, b = pack_stem_weights(w, mult, bias, k=k, zp_in=q["zp_in"], zp_w=zp_w,
                                 signed_in=mode == "s8")
    args = [torch.from_numpy(a).cuda() for a in (x, wm, m, b)]
    return args, dict(q, s_out=0.05)


def check_stem_kernel(torch):
    """Phase 2 for the stem kernel. Returns its kernels-line entry (without
    the main path's launch count) and the largest error seen."""
    import torch.nn.functional as F

    from tengine_tpu_torch.ops.cuda.stem_conv import (
        REPLACES, SOURCE, stem_qconv, stem_qconv_plain,
    )

    grid = [  # k, pad, act, mode, zp_w, B, H
        (6, 2, 100, "s8", 0, 2, 32),
        (3, 1, 0, "u8", 0, 2, 32),
        (7, 3, -1, "s8", 0, 2, 32),
        (6, 2, 6, "u8", 113, 2, 32),
    ]
    for i, (k, pad, act, mode, zp_w, B, H) in enumerate(grid):
        args, q = stem_case(torch, k, mode, zp_w, B, H, seed=i)
        for out_f32 in (False, True):
            got = stem_qconv(*args, k=k, pad=pad, act=act, out_f32=out_f32, **q)
            want = stem_qconv_plain(*args, k=k, pad=pad, act=act, out_f32=out_f32, **q)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            n_diff = int((d > 0).sum())
            log(f"  stem grid k={k} pad={pad} act={act} {mode} zp_w={zp_w} "
                f"out_f32={out_f32}: max|d|={d.max().item():g}, {n_diff} elements differ")
            if d.max().item() > (1 if act == 100 else 0):
                raise AssertionError(f"stem kernel disagrees with its plain version: {d.max().item()}")

    # the main path's shape: yolov5s-640 batch 8, s8 in and out, SiLU
    k, pad, B, H, C, Cout = 6, 2, 8, 640, 3, 32
    args, q = stem_case(torch, k, "s8", 0, B, H, seed=640, C=C, Cout=Cout)
    run = dict(k=k, pad=pad, act=100, **q)
    got = stem_qconv(*args, **run)
    want = stem_qconv_plain(*args, **run)
    torch.cuda.synchronize()
    d = (got.int() - want.int()).abs()
    err = int(d.max().item())
    log(f"  stem yolov5s-640 b8 (SiLU): max|d|={err} LSB, "
        f"{int((d > 0).sum())} of {d.numel()} elements differ")
    if err > 1:
        raise AssertionError(f"stem kernel disagrees with its plain version: {err} LSB")

    ms = cuda_ms(lambda: stem_qconv(*args, **run), iters=50)
    plain_ms = cuda_ms(lambda: stem_qconv_plain(*args, **run), iters=5, warmup=1)
    # library yardstick: one cuDNN conv in bf16 on the re-centred values
    # (exact: |acc| < 2^24 at K = 108); the conv alone, no requant epilogue
    xb = args[0].to(torch.bfloat16)
    wb = args[1].reshape(Cout, C, k, k).to(torch.bfloat16)
    library_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=2, padding=pad), iters=50)
    oh = ow = H // 2
    moved = (args[0].numel() * args[0].element_size() + got.numel() * got.element_size()
             + sum(a.numel() * a.element_size() for a in args[1:]))
    ops = 2 * B * oh * ow * Cout * C * k * k
    t_bytes, t_ops = moved / H100_BYTES_PER_S * 1e3, ops / H100_INT8_OPS_PER_S * 1e3
    entry = {
        "name": "stem_qconv", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    log(f"  stem timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (cuDNN bf16 conv) {library_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
        f"({moved} bytes, {ops} int8 ops)")
    return entry


def dequant(torch, out, t):
    return (out.float() - float(np.asarray(t.quant.zero_points))) * float(np.asarray(t.quant.scales))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import tengine_tpu_torch as tt
    from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph
    from tengine_tpu_torch.ops import qmath
    from tengine_tpu_torch.ops.cuda import build
    from tengine_tpu_torch.ops.cuda.stem_conv import stem_qconv

    t_start = time.time()
    gpu = gpu_name_and_power_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} [{gpu}]")

    # 1. build
    t0 = time.time()
    build.build_all()
    log(f"phase 1 build: {time.time() - t0:.1f} s")

    # 2. kernels against their plain versions
    t0 = time.time()
    entries = {"stem_qconv": check_stem_kernel(torch)}
    counters = {"stem_qconv": stem_qconv}
    log(f"phase 2 kernels: {time.time() - t0:.1f} s")

    # 3. main path: yolov5s-640 INT8 at batch 8
    t0 = time.time()
    batch, img = 8, 640
    _, g = build_yolov5s_graph(num_classes=80, img=img)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((batch, 3, img, img)).astype(np.float32)
    qg = tt.quantize_graph(g, [images[:1]], scheme="int8", algorithm="minmax")
    cg = tt.compile_graph(qg, tt.Options(quant_mode="fast", batch_size=batch))
    stems = [n for n, k in cg.kernels.items() if k == "lower_conv_quant_pallas_stem"]
    if len(stems) != 1:
        raise AssertionError(f"expected one stem-kernel node, got {stems}")
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(images, t_in.quant, t_in.dtype)
    x_dev = torch.from_numpy(xq).cuda()
    log(f"  set-up (build graph, calibrate, compile): {time.time() - t0:.1f} s")

    n_batches = 3
    for c in counters.values():
        c.launches = 0
    batch_ms = []
    for _ in range(n_batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = cg(x_dev)
        end.record()
        torch.cuda.synchronize()
        batch_ms.append(start.elapsed_time(end))
    launches = {name: c.launches for name, c in counters.items()}
    for name, n in launches.items():
        entries[name]["launches"] = n
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if launches["stem_qconv"] != n_batches:
        raise AssertionError(f"stem kernel launched {launches['stem_qconv']} times in {n_batches} forwards")
    med = float(np.median(batch_ms))
    log(f"phase 3 main path: yolov5s-{img} int8 batch {batch}: ms/batch {batch_ms} "
        f"(median {med:.3f}), {batch * 1e3 / med:.1f} img/s, launches {launches} "
        f"[{time.time() - t0:.1f} s]")

    # 4. correctness: fp32 engine on the card, and the port's CPU run
    t0 = time.time()
    heads = [cg.graph.tensors[t] for t in cg.output_ids]
    fcg = tt.compile_graph(g, tt.Options(precision="fp32", batch_size=batch))
    fouts = fcg(torch.from_numpy(images).cuda())
    for t, q, f in zip(heads, outs, fouts):
        if not bool(torch.isfinite(f).all()) or q.shape != f.shape or q.dtype != torch.int8:
            raise AssertionError(f"head {t.name}: bad output {q.shape} {q.dtype} vs fp32 {f.shape}")
        a, b = dequant(torch, q, t).double().ravel(), f.double().ravel()
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        log(f"  head {t.name} {tuple(q.shape)}: cosine vs fp32 engine {cos:.5f}")
        if not cos > 0.95:
            raise AssertionError(f"head {t.name}: cosine {cos:.4f} <= 0.95")
    ccg = tt.compile_graph(qg, tt.Options(quant_mode="fast", batch_size=1), device="cpu")
    couts = ccg.run(xq[:1])
    for t, q, c in zip(heads, outs, couts):
        d = np.abs(q[:1].cpu().numpy().astype(np.int32) - c.astype(np.int32))
        log(f"  head {t.name}: card vs CPU max|d|={d.max()} LSB, equal fraction {(d == 0).mean():.6f}")
        if d.max() > 1:
            raise AssertionError(f"head {t.name}: card and CPU differ by {d.max()} LSB")
    log(f"phase 4 check: {time.time() - t0:.1f} s")

    if "--profile" in argv:
        profile_batch(torch, cg, x_dev)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "tengine_tpu"))
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked[:5]}")
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(gpu_name_and_power_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def profile_batch(torch, cg, x_dev) -> None:
    """Device time by kernel over one batch, and the device's busy share of
    the batch's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cg(x_dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cg(x_dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def self_device_us(r):  # the attribute's name changed across torch versions
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0)

    # device-side rows only: the aten:: rows repeat the time of their kernels
    dev = [(r.key, self_device_us(r) / 1e3, r.count) for r in prof.key_averages()
           if r.device_type == DeviceType.CUDA and self_device_us(r) > 0]
    total = sum(ms for _, ms, _ in dev)
    log(f"profile: one batch, wall {wall_ms:.3f} ms, kernels {total:.3f} ms, "
        f"device idle {100 * (1 - total / wall_ms):.1f}% of the wall time, "
        f"{sum(c for _, _, c in dev)} kernel launches")
    for key, ms, count in sorted(dev, key=lambda r: -r[1])[:15]:
        log(f"  {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  x{count:<4d} {key[:90]}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
