#!/usr/bin/env python3
"""The port's mesh across the cards of one host, on NCCL: the counterpart of
chip_smoke.py's phase 3p (one card) where a mesh spans cards.

    python3 chip_mesh.py             # every card of the host (at least 2)

One process a card (torch.distributed on NCCL, a TCPStore on localhost),
rank r on card r; the graphs are built and calibrated here, as
chip_smoke.py builds them, and pass to the ranks as tmfile bytes. Each rank
runs chip_smoke.py's mesh checks, those of its phase 3p(b):

  1. check_mesh_shapes: mobilenet-v1-224 UINT8 under tier L (the
     native-int8 plan, the 13 depthwise convs on dw_qconv; MinMax from one
     seeded image) at b128 through shard_compiled at meshes (1, N),
     (2, N/2) and (N, 1), each captured as a CUDA graph with its channel
     all-gathers inside: the logits equal the unsharded CompiledGraph's at
     0 LSB on every rank, the dw_qconv launches of one eager forward held
     to the plain version; the captured ms/batch of both (CUDA events
     around each of 3 calls after the one that captures), the nodes on
     channel slices and the bytes a forward's gathers move.
  2. serve_multihost: yolov5s-640 INT8 behind the multi-host loop, hosts of
     two cards, tp 2 (the queue holder of each host broadcasts its bucket
     on NCCL): each host submits its own MESH_REQUESTS seeded frames; every
     answer equals the unsharded batch-1 CompiledGraph's at 0 LSB; an idle
     second dispatches nothing. Latency printed.

Prints each rank's log, `nvidia-smi`'s name and power limit of the cards,
and last {"ok": true, "cards": N, "kind": ...}. Fails (exit code 1, no
result) without two cards; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from chip_smoke import (
    DEFAULT_BATCH, DEFAULT_TIERS, _tier_l, build_mobilenet_v1_graph, check_mesh_shapes,
    gpu_name_and_power_limit, log, run_ranks, serve_multihost, timed_ms,
)

MESH_REQUESTS = 8
CHILD_TIMEOUT_S = 150


def main() -> int:
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2 or cards % 2:
        print(f"chip_mesh: needs an even number of CUDA cards, at least 2; found {cards}",
              file=sys.stderr)
        return 1
    import tengine_tpu_torch as tt
    from tengine_tpu_torch.graph import ir
    from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph
    from tengine_tpu_torch.ops import qmath
    from tengine_tpu_torch.ops.cuda import build
    from tengine_tpu_torch.serializer.tm2.writer import graph_to_tm_bytes

    t0 = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, {cards} cards "
        f"[{gpu_name_and_power_limit()}]")
    build.build_all()
    g = build_mobilenet_v1_graph(ir, img=224)
    images = np.random.default_rng(0).standard_normal((DEFAULT_BATCH, 3, 224, 224)).astype(np.float32)
    qg = tt.quantize_graph(g, [images[:1]], scheme="uint8", algorithm="minmax")
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = qmath.quantize_np(images, t_in.quant, t_in.dtype)
    _, g5 = build_yolov5s_graph(num_classes=80, img=640)
    im5 = np.random.default_rng(0).standard_normal((1, 3, 640, 640)).astype(np.float32)
    qg5 = tt.quantize_graph(g5, [im5], scheme="int8", algorithm="minmax")
    t5 = qg5.tensors[qg5.input_tensors[0]]
    frames = np.random.default_rng(1).random((cards // 2 * MESH_REQUESTS, 1, 3, 640, 640),
                                             dtype=np.float32)
    xs = qmath.quantize_np(frames, t5.quant, t5.dtype)
    log(f"build, graphs and calibration: {time.time() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        (tmp / "mobilenet.tmfile").write_bytes(graph_to_tm_bytes(qg))
        np.save(tmp / "mobilenet_x.npy", xq)
        (tmp / "yolov5s.tmfile").write_bytes(graph_to_tm_bytes(qg5))
        np.save(tmp / "frames.npy", xs)
        run_ranks("chip_mesh.child", cards, (d,), tmp, CHILD_TIMEOUT_S, "chip_mesh")
    log(f"total {time.time() - t0:.1f} s")
    print(gpu_name_and_power_limit())
    print(json.dumps({"ok": True, "cards": cards, "kind": torch.cuda.get_device_name(0)}))
    return 0


def child(argv) -> int:
    """Rank `rank` of `world` (card `rank`): parts 1 and 2 above."""
    rank, world, port, tmp = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    import gc

    import torch
    import torch.distributed as dist

    from tengine_tpu_torch.parallel.distributed import init_distributed, shutdown_distributed

    # NCCL on card `rank`: the two "hosts" share this machine's cards, so the
    # card is named (by default a rank takes card rank % ranks_per_host)
    init_distributed(f"localhost:{port}", world, rank, device=f"cuda:{rank}", ranks_per_host=2)
    sync = dist.new_group(backend="gloo")  # the barrier before the shutdown
    try:
        _parts(rank, world, tmp)
        # the CUDA graphs that captured NCCL collectives go before their
        # communicators: with such graphs still alive, every rank of a run
        # on four cards hung in shutdown_distributed
        gc.collect()
        torch.cuda.synchronize()
        dist.barrier(group=sync)
    finally:
        shutdown_distributed()
    return 0


def _parts(rank, world, tmp) -> None:
    """Parts 1 and 2 above on this rank, through chip_smoke.py's mesh
    checks. What it captured goes when it returns."""
    import torch

    import tengine_tpu_torch as tt
    from tengine_tpu_torch.ops.cuda.dw_conv import dw_qconv
    from tengine_tpu_torch.ops.cuda.stem_conv import stem_qconv
    from tengine_tpu_torch.parallel.distributed import global_mesh

    counters = {"dw_qconv": dw_qconv, "stem_qconv": stem_qconv}
    qg = tt.load_tm_bytes((tmp / "mobilenet.tmfile").read_bytes())
    x = torch.from_numpy(np.load(tmp / "mobilenet_x.npy")).cuda()
    cg = _tier_l(tt, qg, DEFAULT_BATCH)
    (want,) = cg(x)
    base = [timed_ms(torch, lambda: cg(x)) for _ in range(3)]
    what = f"mobilenet-v1-224 uint8 b{DEFAULT_BATCH} tier L"
    log(f"{what} unsharded on card {rank}: captured ms/batch {[round(m, 3) for m in base]} "
        f"[{gpu_name_and_power_limit()}]")
    check_mesh_shapes(torch, cg, x, want, ((1, world), (2, world // 2), (world, 1)), counters,
                      DEFAULT_TIERS["L"][6], what, rank)
    del cg

    qg5 = tt.load_tm_bytes((tmp / "yolov5s.tmfile").read_bytes())
    xs = np.load(tmp / "frames.npy")
    cg1 = tt.compile_graph(qg5, tt.Options(quant_mode="fast", batch_size=1))
    outs = [cg1.run(x1) for x1 in xs]  # the unsharded answers, by frame
    answers = [np.concatenate([o[h] for o in outs]) for h in range(len(outs[0]))]
    del cg1
    host = rank // 2
    mine = list(range(host * MESH_REQUESTS, (host + 1) * MESH_REQUESTS))
    serve_multihost(torch, tt, qg5, global_mesh(tp=2), xs, mine, answers, counters,
                    f"yolov5s-640 int8 multi-host loop, host {host}, tp 2")


if __name__ == "__main__":
    sys.exit(main())
