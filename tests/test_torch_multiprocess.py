"""The port's multi-process paths on the CPU (the counterpart of
tests/test_multiprocess.py): ranks are OS processes joined by
torch.distributed over gloo, one process a card in the port's topology (a
host is a run of `ranks_per_host` ranks; here two hosts of two ranks).

  * init_distributed (a TCPStore rank 0 hosts) and global_mesh(tp=2): the
    "model" axis stays inside a host, "data" spans hosts;
  * host_local_batch_to_global: each host's rows as the global batch;
  * a TP-sharded quantized FC graph on that batch = the single process's;
  * Heartbeat across ranks, and a wedged peer reported missing within one
    timeout;
  * the multi-host serving loop: each host's requests answered at 0 LSB
    equal to the unsharded CompiledGraph, no batch dispatched while idle.

The worker functions below also serve tests/test_torch_parallel.py's
multi-rank cases. A worker runs `python -c` in a fresh interpreter with
this directory on sys.path and one torch thread; every group has a
timeout. Nothing here imports JAX.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parent
GROUP_TIMEOUT_S = 150

sys.path.insert(0, str(HERE.parent))
from chip_smoke import free_port  # noqa: E402


def run_ranks(world: int, worker: str, *args, timeout=GROUP_TIMEOUT_S):
    """`worker(rank, world, port, *args)` of this module in `world` fresh
    processes; each must exit 0. Returns each rank's printed RESULT object."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(HERE), str(HERE.parent), os.environ.get("PYTHONPATH", "")) if p))
    code = (f"import sys, test_torch_multiprocess as m; "
            f"m.{worker}(int(sys.argv[1]), {world}, {port}, *sys.argv[2:])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(rank), *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for rank in range(world)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{worker}: a rank timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{worker} rank {rank} rc={p.returncode}\n{out}\n{err[-3000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(lines[-1][7:]) if lines else None)
    return results


def _start(rank, world, port, ranks_per_host=None):
    torch.set_num_threads(1)  # several ranks share the cores
    from tengine_tpu_torch.parallel.distributed import init_distributed

    assert init_distributed(f"localhost:{port}", world, rank, device="cpu",
                            ranks_per_host=ranks_per_host)


def _result(obj) -> None:
    print("RESULT " + json.dumps(obj), flush=True)


def quantized_graph(kind: str, seed: int = 7):
    """A one-node INT8 graph (per-channel weights, MinMax from two seeded
    images) of the port: "fc", [N, 16] -> FullyConnected 16 -> 8, or
    "conv", [N, 3, 8, 8] -> 3x3 conv 3 -> 8 + ReLU; and the quantized
    inputs of `n` requests from a seeded generator."""
    import tengine_tpu_torch as pt
    from tengine_tpu_torch.graph.ir import DType, Graph, TensorType

    rng = np.random.default_rng(seed)
    g = Graph(name=kind)
    shape = (1, 16) if kind == "fc" else (1, 3, 8, 8)
    x = g.add_tensor("data", DType.FP32, shape, TensorType.INPUT)
    g.add_node("InputOp", "input", [], [x.idx])
    wshape = (8, 16) if kind == "fc" else (8, 3, 3, 3)
    w = g.add_tensor("w", DType.FP32, wshape, TensorType.CONST,
                     data=rng.standard_normal(wshape).astype(np.float32))
    b = g.add_tensor("b", DType.FP32, (8,), TensorType.CONST,
                     data=rng.standard_normal(8).astype(np.float32))
    y = g.add_tensor("y", DType.FP32, [], TensorType.VAR)
    if kind == "fc":
        g.add_node("FullyConnected", "fc", [x.idx, w.idx, b.idx], [y.idx],
                   params=dict(num_output=8))
    else:
        g.add_node("Convolution", "conv", [x.idx, w.idx, b.idx], [y.idx], params=dict(
            kernel_h=3, kernel_w=3, stride_h=1, stride_w=1, dilation_h=1, dilation_w=1,
            input_channel=3, output_channel=8, group=1, activation=0,
            pad_h0=1, pad_w0=1, pad_h1=1, pad_w1=1))
    g.inputs, g.outputs = [0], [1]
    calib = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    return pt.quantize_graph(g, calib, scheme="int8", device="cpu")


def quantized_inputs(qg, n: int, seed: int) -> np.ndarray:
    from tengine_tpu_torch.ops import qmath

    t_in = qg.tensors[qg.input_tensors[0]]
    shape = tuple(t_in.shape[1:])
    x = np.random.default_rng(seed).standard_normal((n, *shape)).astype(np.float32)
    return qmath.quantize_np(x, t_in.quant, t_in.dtype)


# -- workers ----------------------------------------------------------------


def two_hosts_worker(rank, world, port):
    import torch.distributed as dist

    import tengine_tpu_torch as pt
    from tengine_tpu_torch.parallel.distributed import (
        Heartbeat, global_mesh, host_local_batch_to_global, shutdown_distributed)
    from tengine_tpu_torch.parallel.sharding import shard_compiled, sharded_weights

    _start(rank, world, port, ranks_per_host=2)
    mesh = global_mesh(tp=2)  # (data 2, model 2); data spans the two hosts
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 2, "model": 2}
    hosts = [{r // 2 for r in row} for row in mesh.mesh.tolist()]
    assert all(len(h) == 1 for h in hosts), f"TP crossed a host boundary: {mesh.mesh}"
    host = rank // 2

    # each host contributes its own 2-row local batch
    x_local = np.arange(8, dtype=np.float32).reshape(2, 4) + 100.0 * host
    xg = host_local_batch_to_global(x_local, mesh)
    assert tuple(xg.shape) == (4, 4) and tuple(xg.to_local().shape) == (2, 4)
    full = xg.full_tensor()  # a collective over "data"
    want = np.concatenate([np.arange(8, dtype=np.float32).reshape(2, 4) + 100.0 * h
                           for h in (0, 1)])
    assert np.array_equal(full.numpy(), want)

    # a TP-sharded quantized FC on each host's rows = one process's result
    qg = quantized_graph("fc")
    cg = pt.compile_graph(qg, pt.Options(quant_mode="fast", batch_size=4), device="cpu")
    assert sharded_weights(cg, 2) == {qg.nodes[1].inputs[1]}
    sharded = shard_compiled(cg, mesh)
    x_all = quantized_inputs(qg, 4, seed=3)
    (out,) = sharded(host_local_batch_to_global(x_all[2 * host:2 * host + 2], mesh))
    (ref,) = cg.run(x_all)
    got = out.to_local().numpy()
    assert np.array_equal(got, ref[2 * host:2 * host + 2]), np.abs(got - ref[2 * host:]).max()
    assert int((got.astype(np.int32) != 0).sum()) > 0

    hb = Heartbeat(interval_s=0.05, timeout_s=5.0)
    hb.start()
    time.sleep(0.3)
    healthy, missing = hb.check_peers()
    hb.stop()
    assert healthy, missing
    dist.barrier()
    shutdown_distributed()
    _result({"rank": rank, "rows": got.tolist()})


def wedged_peer_worker(rank, world, port):
    from tengine_tpu_torch.parallel.distributed import Heartbeat, shutdown_distributed, state

    _start(rank, world, port)
    store = state().store
    hb = Heartbeat(interval_s=0.1, timeout_s=1.2)
    hb.start()
    time.sleep(0.6)  # both peers publish a few beats
    if rank == 1:
        # wedge: the process stays up but stops publishing heartbeats (the
        # hung-host failure mode only the Heartbeat sees); wait for the
        # survivor's verdict, then leave
        hb.stop()
        store.wait(["/tt/test/done"], __import__("datetime").timedelta(seconds=60))
        _result({"rank": rank})
        return
    healthy, missing = hb.check_peers()
    assert healthy, f"peer should still look alive: {missing}"
    t0 = time.monotonic()
    while hb.check_peers()[0] and time.monotonic() - t0 < 5.0:
        time.sleep(0.1)
    detected_s = time.monotonic() - t0
    healthy, missing = hb.check_peers()
    hb.stop()
    store.set("/tt/test/done", "1")
    assert not healthy and missing == [1], (healthy, missing)
    shutdown_distributed()
    _result({"rank": rank, "detected_s": detected_s})


def serving_worker(rank, world, port):
    import torch.distributed as dist

    import tengine_tpu_torch as pt
    from tengine_tpu_torch.parallel.distributed import global_mesh, shutdown_distributed
    from tengine_tpu_torch.parallel.serving import InferenceServer
    from tengine_tpu_torch.parallel.sharding import ShardedGraph

    _start(rank, world, port, ranks_per_host=2)
    qg = quantized_graph("conv")  # the same on every rank: seeded
    mesh = global_mesh(tp=2)  # (data 2, model 2)
    server = InferenceServer(qg, pt.Options(quant_mode="fast"), mesh=mesh, max_batch=4,
                             max_wait_ms=30.0, device="cpu")
    server.start()
    leads = mesh.get_local_rank(1) == 0
    xs = quantized_inputs(qg, 6, seed=123 + rank)
    answers = []
    if leads:  # each host submits its own requests
        futures = [server.submit(x) for x in xs]
        answers = [f.result(timeout=120) for f in futures]
    else:
        try:
            server.submit(xs[0])
            raise AssertionError("a rank off model coordinate 0 took a request")
        except RuntimeError as e:
            assert f"rank {rank - 1} holds" in str(e), e
    dist.barrier()  # every host's requests are answered
    time.sleep(0.2)  # the last round's bookkeeping ends on every rank
    # idle window: with no queued work on any rank the loop must not
    # dispatch the padded global batch
    batches = server.stats["batches"]
    time.sleep(1.0)
    stats = dict(server.stats)
    server.stop()
    assert stats["batches"] == batches, f"the idle loop dispatched a batch: {stats}"
    assert stats.get("idle_rounds", 0) > 0, stats
    assert isinstance(server._compiled[8], ShardedGraph)
    n_latencies = len(server._latencies)
    server.start()  # a stopped server starts again and answers
    again = server.submit(xs[0]).result(timeout=60) if leads else None
    server.stop()

    cg = pt.compile_graph(qg, pt.Options(quant_mode="fast", batch_size=1), device="cpu")
    for x, answer in zip(xs, answers):
        (want,) = cg.run(x[None])
        assert answer[0].dtype == want.dtype and np.array_equal(answer[0], want)
    if leads:
        assert np.array_equal(again[0], answers[0][0])
    if leads:
        assert stats["requests"] == 6 and n_latencies == 6, stats
    shutdown_distributed()
    _result({"rank": rank, "stats": stats})


def sharded_forward_worker(rank, world, port, dp, tp, blob_path, out_dir):
    """Every graph of `blob_path` (a .npz of tmfile bytes and inputs, keyed
    by name) compiled at its batch, then sharded over a (dp, tp) mesh:
    every output sharded = unsharded at 0 LSB (float: bit-equal), the
    routes pinned; the first sharded output saved by rank 0 into out_dir."""
    import tengine_tpu_torch as pt
    from tengine_tpu_torch.parallel.distributed import shutdown_distributed
    from tengine_tpu_torch.parallel.mesh import make_mesh
    from tengine_tpu_torch.parallel.sharding import shard_compiled, sharded_nodes

    dp, tp = int(dp), int(tp)
    _start(rank, world, port)
    mesh = make_mesh(shape=(dp, tp), device="cpu")
    cases = np.load(blob_path)
    done = {}
    for name in sorted({k.split(":")[0] for k in cases.files}):
        g = pt.load_tm_bytes(cases[f"{name}:blob"].tobytes())
        x = cases[f"{name}:x"]
        opts = json.loads(cases[f"{name}:opts"].tobytes().decode())
        env = opts.pop("_env", {})
        os.environ.update(env)  # read as the kernels are selected
        if name.endswith("pczp"):
            # imported-style per-channel weight zero points (no quantizer
            # makes them; the fast lowering subtracts each channel's own)
            for n in g.nodes:
                if n.op in ("Convolution", "FullyConnected"):
                    q = g.tensors[n.inputs[1]].quant
                    if q is not None and q.per_channel:
                        q.zero_points = (np.arange(q.scales.size) % 5 - 2).astype(np.int32)
        cg = pt.compile_graph(g, pt.Options(**opts), device="cpu")
        sharded = shard_compiled(cg, mesh)
        for node_name, kernel in cg.kernels.items():
            assert sharded.kernels[node_name] == kernel, (name, node_name)
        refs, gots = cg.run(x), sharded.run(x)
        for got, ref in zip(gots, refs, strict=True):
            assert got.dtype == ref.dtype and got.shape == ref.shape, name
            assert np.array_equal(got, ref), (name, np.abs(got.astype(np.float64) - ref).max())
        if dp > 1:
            try:
                sharded.run(x[:dp + 1])
                raise AssertionError("a batch the data axis does not divide ran")
            except ValueError:
                pass
        for k in env:
            os.environ.pop(k)
        done[name] = len(sharded_nodes(cg, tp))
        if rank == 0:
            np.save(Path(out_dir) / f"{name}.npy", gots[0])
    shutdown_distributed()
    _result({"rank": rank, "sharded_nodes": done})


# -- tests ------------------------------------------------------------------


def test_two_hosts_mesh_batch_and_tp_fc():
    """Two hosts x two ranks: global_mesh(tp=2) keeps "model" inside a host,
    host_local_batch_to_global assembles the hosts' rows, a TP-sharded FC
    (its 8 output features over two ranks) = the single process's result,
    the heartbeat healthy across the four ranks."""
    results = run_ranks(4, "two_hosts_worker")
    assert results[0]["rows"] == results[1]["rows"] and results[2]["rows"] == results[3]["rows"]


def test_heartbeat_detects_wedged_peer():
    """Rank 1 stops beating but stays up; rank 0 reports missing == [1]
    within one timeout (1.2 s) of the last beat."""
    survivor, _ = run_ranks(2, "wedged_peer_worker")
    assert survivor["detected_s"] < 2.5, survivor


def test_multihost_continuous_batching():
    """Two hosts x two ranks, tp=2: each host's queue holder submits its own
    six requests; every answer = the unsharded batch-1 CompiledGraph at 0
    LSB; the idle second dispatches no batch, with idle rounds counted; the
    stopped server starts again and answers."""
    results = run_ranks(4, "serving_worker")
    assert all(r["stats"]["idle_rounds"] > 0 for r in results)
    assert len({r["stats"]["batches"] for r in results}) == 1  # lockstep


def test_worker_module_imports_no_jax():
    """The workers run the port alone: this module and the port's parallel
    package import neither JAX nor the JAX package."""
    code = ("import sys; import test_torch_multiprocess, tengine_tpu_torch.parallel.sharding, "
            "tengine_tpu_torch.parallel.serving, tengine_tpu_torch.parallel.distributed; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tengine_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((str(HERE), str(HERE.parent))))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
