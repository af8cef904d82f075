"""The port's mesh, sharding and mesh serving (parallel/mesh.py,
sharding.py, distributed.py, serving.py) on the CPU, against the JAX
package's (the counterpart of tests/test_parallel.py).

Graphs: chip_smoke.py's mobilenet-v1 at img 32, batch 4, narrow widths
(tests/test_torch_mobilenet.py's), fp32 and quantized by the JAX package
(UINT8: per-tensor asymmetric weights; INT8: per-channel symmetric), written
by its TM2 writer and read by each package's reader; tier L (the native-int8
plan, the 13 depthwise convs on the dw kernel's route) at batch 32; the
INT8 graph with imported-style per-channel weight zero points (port only:
the JAX lowerings take them as 0, ROADMAP §3); and two INT8 nets with the
residual sums fuse_conv_add folds into conv epilogues (a sharded conv
reads its residual's channel slice): tests/test_torch_resnet.py's narrow
ResNet-50 (img 32, two blocks a stage, stride-2 1x1 projections) and
yolov5s at img 64 (three heads, SiLU, the 6x6 stem).

  * the weights the port splits over "model" = those JAX's param_spec
    shards over the same graph's params, at tp 2 and 4;
  * sharded = unsharded at 0 LSB (fp32: bit-equal) at meshes (1, 1),
    (1, 2), (2, 1), (2, 2), gloo process groups of up to 4 ranks;
  * the port's (2, 2) against JAX's shard_compiled on the conftest's 8
    virtual devices at (2, 4): quantized logits within 2 LSB with 95% equal
    (tests/test_torch_mobilenet.py's whole-net bound); fp32 within 1e-5 of
    the logits' scale (the two engines' fp32 convs sum in other orders);
  * the server with a mesh on a world of one, latency stats, the
    single-process heartbeat, and the entry points' card default.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from tengine_tpu.parallel.sharding import param_spec as jax_param_spec  # noqa: E402
from tengine_tpu.parallel.sharding import shard_compiled as jax_shard_compiled  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.ops.layout import TArr  # noqa: E402
from tengine_tpu_torch.parallel import sharding  # noqa: E402
from tengine_tpu_torch.parallel.distributed import (  # noqa: E402
    Heartbeat, init_distributed, shutdown_distributed)
from tengine_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated  # noqa: E402
from tengine_tpu_torch.parallel.serving import InferenceServer, _bucket  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from test_torch_multiprocess import free_port, quantized_graph, quantized_inputs, run_ranks  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import build_mobilenet_v1_graph, build_resnet50_graph  # noqa: E402
from tengine_tpu.models.yolov5 import build_yolov5s_graph as jax_build_yolov5s  # noqa: E402

IMG, BATCH, L_BATCH = 32, 4, 32
SMALL = dict(img=IMG, classes=16,
             widths=(32, 32, 64, 64, 64, 64, 96, 96, 96, 96, 96, 96, 128, 128))
L_OPTS = dict(quant_mode="fast", quant_native="on", batch_size=L_BATCH, _env={"TT_DW_PALLAS": "1"})
# a raw 2-D const that JAX's rule shards but the port reads through an op
# other than a conv or FC stays whole in the port: memory only, equal
# values (a standing divergence; mobilenet-v1 has none)
RAW_DIVERGENCE = set()


def _graphs():
    """name -> (tmfile bytes, input, Options as a dict)."""
    jg = build_mobilenet_v1_graph(jir, **SMALL)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((L_BATCH, 3, IMG, IMG)).astype(np.float32)
    out = {"fp32": (graph_to_tm_bytes(jg), x[:BATCH], dict(batch_size=BATCH))}
    for scheme in ("uint8", "int8"):
        jqg = jax_quantize(jg, [x[:1]], scheme=scheme, algorithm="minmax")
        t_in = jqg.tensors[jqg.input_tensors[0]]
        xq = jq.quantize_np(x, t_in.quant, t_in.dtype)
        blob = graph_to_tm_bytes(jqg)
        out[scheme] = (blob, xq[:BATCH], dict(quant_mode="fast", batch_size=BATCH))
        if scheme == "uint8":
            out["uint8L"] = (blob, xq, L_OPTS)
        else:
            out["int8pczp"] = (blob, xq[:BATCH], dict(quant_mode="fast", batch_size=BATCH))
    nets = {"resnet": (build_resnet50_graph(jir, img=32, classes=16, widths=(8, 16, 32, 64),
                                            depths=(2, 2, 2, 2)), 32),
            "yolov5s": (jax_build_yolov5s(num_classes=80, img=64)[1], 64)}
    for name, (jg, img) in nets.items():
        x = rng.standard_normal((BATCH, 3, img, img)).astype(np.float32)
        jqg = jax_quantize(jg, [x[:1]], scheme="int8", algorithm="minmax")
        t_in = jqg.tensors[jqg.input_tensors[0]]
        out[name] = (graph_to_tm_bytes(jqg), jq.quantize_np(x, t_in.quant, t_in.dtype),
                     dict(quant_mode="fast", batch_size=BATCH))
    return out


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


@pytest.fixture(scope="module")
def cases_file(graphs, tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_cases") / "cases.npz"
    arrays = {}
    for name, (blob, x, opts) in graphs.items():
        arrays[f"{name}:blob"] = np.frombuffer(blob, np.uint8)
        arrays[f"{name}:x"] = x
        arrays[f"{name}:opts"] = np.frombuffer(json.dumps(opts).encode(), np.uint8)
    np.savez(path, **arrays)
    return path


@pytest.fixture(scope="module")
def mesh_runs(cases_file, tmp_path_factory):
    """(dp, tp) -> (each rank's result, rank 0's saved outputs), each group
    run once in the module."""
    done = {}

    def run(dp, tp):
        if (dp, tp) not in done:
            out = tmp_path_factory.mktemp(f"mesh_{dp}x{tp}")
            done[dp, tp] = run_ranks(dp * tp, "sharded_forward_worker", dp, tp, cases_file, out), out
        return done[dp, tp]

    return run


@pytest.fixture()
def world_of_one():
    """A gloo process group of one rank on the CPU, destroyed after."""
    assert init_distributed(f"localhost:{free_port()}", 1, 0, device="cpu")
    yield
    shutdown_distributed()


def _env(opts):
    opts = dict(opts)
    return opts, opts.pop("_env", {})


def _compile_both(blob, opts, monkeypatch):
    opts, env = _env(opts)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jcg = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**opts))
    pcg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    return jcg, pcg


# -- rules ------------------------------------------------------------------


@pytest.mark.parametrize("n,max_batch,want", [(1, 32, 1), (3, 32, 4), (32, 32, 32), (60, 32, 32)])
def test_bucket(n, max_batch, want):
    assert _bucket(n, max_batch) == want


@pytest.mark.parametrize("key,shape,tp,want", [
    ("t3/oihw_f64", (128, 64, 3, 3), 4, Shard(0)),
    ("t3/oihw_zshift_f64", (128, 1, 3, 3), 4, Shard(0)),
    ("t3/oihw", (64, 3, 3, 3), 2, Shard(0)),
    ("t3/oihw_deq", (6, 3, 3, 3), 4, Replicate()),  # 6 % 4
    ("t3/oihw_f64", (4, 3, 3, 3), 4, Replicate()),  # < 2·tp
    ("t7/kt_f64", (512, 1000), 4, Shard(1)),
    ("t7/kt_zshift_f64", (512, 1000), 8, Shard(1)),
    ("t7/w", (1000, 512), 4, Replicate()),  # the float FC's weight, as JAX's "w"
    ("t9/raw", (1000, 512), 4, Shard(0)),
    ("t9/raw", (10, 512), 4, Replicate()),
    ("n1/requant_m", (64,), 4, Replicate()),
    ("n1/dwp_w", (9, 128), 2, Replicate()),  # the dw kernel's taps
    ("t3/oihw_f64", (128, 64, 3, 3), 1, Replicate()),
])
def test_param_spec_rules(key, shape, tp, want):
    assert sharding.param_spec(key, np.zeros(shape), tp) == want


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["fp32", "uint8", "int8", "uint8L", "resnet", "yolov5s"])
def test_sharded_weights_equal_jax_param_spec(graphs, name, tp, monkeypatch):
    """The weight tensors the port splits = those JAX's param_spec shards
    over cg.params of the same tmfile bytes: the convs' and the quantized
    FC's (the float FC's "w" stays whole in both); under tier L the 13
    depthwise convs on the kernel's route stay whole in both, and the stem,
    which JAX's fast lowering width-folds, too."""
    blob, _, opts = graphs[name]
    jcg, pcg = _compile_both(blob, opts, monkeypatch)
    jax_set = {int(k.split("/")[0][1:]) for k, v in jcg.params.items()
               if k.startswith("t") and jax_param_spec(k, v, tp) != P()}
    raw = {int(k.split("/")[0][1:]) for k, v in jcg.params.items()
           if k.endswith("/raw") and jax_param_spec(k, v, tp) != P()}
    port = sharding.sharded_weights(pcg, tp)
    assert raw == RAW_DIVERGENCE
    assert port == jax_set - RAW_DIVERGENCE and port
    if name in ("resnet", "yolov5s"):
        fused = [n for n in pcg.graph.nodes if n.params.get("fused_add_pos") is not None]
        assert any(n.inputs[1] in port for n in fused)  # residual convs on channel slices
        return
    convs = [n for n in pcg.graph.nodes if n.op == "Convolution"]
    on_dw = {n.inputs[1] for n in convs if pcg.kernels[n.name] == "lower_conv_quant_pallas_dw"}
    assert len(on_dw) == (13 if name == "uint8L" else 0) and not on_dw & port
    stem = convs[0].inputs[1]
    assert (stem in port) == (name == "fp32")  # width-folded on the quantized fast lowering
    fc = [n.inputs[1] for n in pcg.graph.nodes if n.op == "FullyConnected"]
    assert (fc[0] in port) == (name != "fp32")


def test_make_mesh_shapes_and_errors(world_of_one):
    mesh = make_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert make_mesh(shape=(1, 1), axis_names=("dp", "tp"), device="cpu").mesh_dim_names == ("dp", "tp")
    with pytest.raises(ValueError, match=r"mesh shape \(2, 1\) != 1 devices"):
        make_mesh(shape=(2, 1), device="cpu")
    assert data_sharding(mesh, 4) == (Shard(0), Replicate())
    assert replicated(mesh) == (Replicate(), Replicate())


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(device="cpu")
    assert init_distributed() is False  # no address: single process, a no-op


def test_entry_points_default_to_the_card():
    """Without a card, init_distributed and InferenceServer(mesh=...) raise
    unless the caller names the CPU; nothing switches device by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(f"localhost:{free_port()}", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(quantized_graph("conv"), pt.Options(quant_mode="fast"), mesh=object())


# -- the rank-local program ---------------------------------------------------


def test_slices_and_gathers_keep_memory_order():
    """A channel slice and a one-rank gather of a tensor whose memory order
    is NCHW and logical order NHWC (a conv's output) keep its memory order:
    a library conv picks its algorithm, and the order of its sums, by it."""
    x = torch.arange(2 * 8 * 3 * 3, dtype=torch.float32).reshape(2, 8, 3, 3)
    t = TArr(x.permute(0, 2, 3, 1), "NHWC")
    ctx = type("Ctx", (), {"params": {"lo": 4, "channels": 4}})()
    part = sharding._lower_slice(ctx, t)
    assert part.layout == "NHWC" and tuple(part.x.shape) == (2, 3, 3, 4)
    assert part.x.permute(0, 3, 1, 2).is_contiguous()
    assert torch.equal(part.x, t.x[..., 4:])
    gathered = sharding._gather_kernel(None, 1).fn(None, t)
    assert gathered.x.stride() == t.x.stride() and torch.equal(gathered.x, t.x)
    meta = sharding._gather_kernel(None, 2).fn(None, TArr(t.x.to("meta"), "NHWC"))
    assert tuple(meta.x.shape) == (2, 3, 3, 16)
    assert meta.x.permute(0, 3, 1, 2).is_contiguous()


@pytest.mark.parametrize("mesh", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_sharded_equals_unsharded(mesh_runs, mesh):
    """On every rank, every graph: sharded = unsharded at 0 LSB (fp32
    bit-equal), each node on the lowering the unsharded compile selected;
    at tp 2 the convs and FCs of sharded_weights run on channel slices."""
    results, _ = mesh_runs(*mesh)
    dp, tp = mesh
    assert len(results) == dp * tp
    assert all(r["sharded_nodes"] == results[0]["sharded_nodes"] for r in results)
    counts = dict(results[0]["sharded_nodes"])
    assert set(counts) == {"fp32", "uint8", "int8", "int8pczp", "uint8L", "resnet", "yolov5s"}
    if tp == 1:
        assert set(counts.values()) == {0}
    else:  # fp32: 27 convs; quantized: 26 convs (not the stem) and the FC; L: 13 + 1
        nets = {name: counts.pop(name) for name in ("resnet", "yolov5s")}
        assert counts == {"fp32": 27, "uint8": 27, "int8": 27, "int8pczp": 27, "uint8L": 14}
        assert min(nets.values()) > 20, nets


@pytest.mark.parametrize("name", ["fp32", "uint8", "int8"])
def test_sharded_matches_jax_shard_compiled(graphs, mesh_runs, name):
    """The port's forward on mesh (2, 2) against JAX's shard_compiled on the
    conftest's 8 virtual devices at mesh (2, 4)."""
    blob, x, opts = graphs[name]
    _, out_dir = mesh_runs(2, 2)
    got = np.load(out_dir / f"{name}.npy")
    jcg = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**opts))
    mesh = jax_make_mesh(jax.devices()[:8], shape=(2, 4))
    (want,) = jax_shard_compiled(jcg, mesh).run(jax.device_put(x))
    want = np.asarray(want)
    assert got.shape == want.shape == (BATCH, SMALL["classes"], 1, 1) and got.dtype == want.dtype
    if name == "fp32":
        print(f"fp32 logits: max |d| {np.abs(got - want).max():.3g} of a scale "
              f"{np.abs(want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        return
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{name} logits: max |d| {d.max()} LSB, equal fraction {(d == 0).mean():.4f}")
    assert d.max() <= 2 and (d == 0).mean() >= 0.95, (d.max(), (d == 0).mean())


# -- serving, heartbeat --------------------------------------------------------


def _serve(server, xs):
    server.start()
    try:
        futures = [server.submit(x) for x in xs]
        return [f.result(timeout=120) for f in futures]
    finally:
        server.stop()


def test_serving_with_mesh_world_of_one(world_of_one):
    """InferenceServer(mesh=...) on a world of one: each bucket a
    ShardedGraph on mesh (1, 1), every answer = the server without a mesh
    at 0 LSB; fewer batches than requests."""
    qg = quantized_graph("conv")
    xs = quantized_inputs(qg, 12, seed=5)
    opts = pt.Options(quant_mode="fast")
    plain = _serve(InferenceServer(qg, opts, max_batch=4, max_wait_ms=20.0, device="cpu"), xs)
    server = InferenceServer(qg, opts, mesh=make_mesh(device="cpu"), max_batch=4,
                             max_wait_ms=20.0, device="cpu")
    answers = _serve(server, xs)
    assert all(isinstance(cg, sharding.ShardedGraph) for cg in server._compiled.values())
    for a, b in zip(answers, plain):
        assert a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0])
    assert server.stats["requests"] == 12 and server.stats["batches"] < 12


def test_serving_latency_stats():
    """p50/p99 request-latency percentiles (BASELINE serving metric)."""
    qg = quantized_graph("fc")
    server = InferenceServer(qg, pt.Options(quant_mode="fast"), max_batch=4, max_wait_ms=1.0,
                             device="cpu")
    _serve(server, quantized_inputs(qg, 12, seed=6))
    st = server.latency_stats()
    assert st["count"] == 12
    assert 0 < st["p50_ms"] <= st["p99_ms"]


def test_mesh_server_refuses_a_process_group_it_did_not_set_up():
    """A process group the caller initialized itself (torchrun and
    init_process_group) has neither the gloo control group of the multi-host
    loop nor the store of the heartbeat: the mesh server, the heartbeat and
    global_mesh raise, naming init_distributed, rather than start without
    them."""
    import torch.distributed as dist

    from tengine_tpu_torch.parallel.distributed import global_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="init_distributed"):
            InferenceServer(quantized_graph("fc"), pt.Options(quant_mode="fast"), mesh=mesh,
                            device="cpu")
        with pytest.raises(RuntimeError, match="init_distributed"):
            Heartbeat()
        with pytest.raises(RuntimeError, match="init_distributed"):
            global_mesh()
    finally:
        dist.destroy_process_group()


def test_heartbeat_single_process():
    hb = Heartbeat(interval_s=0.1)
    hb.start()
    time.sleep(0.3)
    healthy, missing = hb.check_peers()
    hb.stop()
    assert healthy and missing == []
    assert not hb._thread.is_alive()
