"""The PyTorch port's yolov3 slice against the JAX package, on the CPU at
img=64: the darknet front end and builder, the quantizer, and the INT8
integer-storage tier (quant_bf16_storage=False) through the port's
qconv_direct / qconv1x1 (A) and qgemm_requant (B) routes, whose CUDA kernels
take their plain versions on the CPU."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

import tengine_tpu as jt  # noqa: E402
from tengine_tpu.convert.darknet_frontend import from_darknet as jax_from_darknet  # noqa: E402
from tengine_tpu.models.darknet_zoo import build_yolov3_graph as jax_build  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as pt  # noqa: E402
from tengine_tpu_torch.convert.darknet_frontend import from_darknet as port_from_darknet  # noqa: E402
from tengine_tpu_torch.models.darknet_zoo import build_yolov3_graph as port_build  # noqa: E402

from test_darknet_frontend import _weights_blob  # noqa: E402
from test_torch_yolov5 import _quant_key, assert_ir_equal  # noqa: E402

IMG = 64

# the integer-storage tier (A) and its qgemm variant (B)
OPTIONS = {
    "A": dict(quant_mode="fast", quant_bf16_storage=False),
    "B": dict(quant_mode="fast", quant_bf16_storage=False, pallas_qconv=False, pallas_qgemm=True),
}
# routes per forward over yolov3's 75 convs: (1×1 on the direct route,
# k×k on the direct route, qgemm_requant, fast lowering)
ROUTES = {"A": (37, 32, 0, 6), "B": (0, 0, 34, 41)}


@pytest.fixture(scope="module")
def graphs():
    jg = jax_build(img=IMG)
    pg = port_build(img=IMG)
    rng = np.random.default_rng(1)
    calib = [rng.standard_normal((1, 3, IMG, IMG)).astype(np.float32)]
    jqg = jax_quantize(jg, calib, scheme="int8", algorithm="minmax")
    return jg, pg, jqg, calib


def test_builder_makes_the_same_ir(graphs):
    jg, pg, _, _ = graphs
    assert_ir_equal(jg, pg)
    assert sum(n.op == "Convolution" for n in pg.nodes) == 75


def test_front_end_sections_match_jax():
    """Every section the front end knows, weights from a .weights blob,
    builds the same IR through both packages (sections whose ops the port
    cannot run yet — Mish, Reorg, Region, Slice, Softmax — build too)."""
    cfg = """
[net]
height=8
width=8
channels=4

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=mish

[route]
layers=-1
groups=2
group_id=1

[convolutional]
filters=8
size=1
stride=1
pad=1
activation=relu

[shortcut]
from=-3
activation=leaky

[maxpool]
size=2
stride=2

[reorg]
stride=2

[region]
classes=2
num=1
anchors=1,1

[avgpool]

[connected]
output=5
activation=leaky

[softmax]

[dropout]
"""
    rng = np.random.default_rng(5)
    blobs = [
        rng.standard_normal(8), rng.random(8) + 0.5, rng.standard_normal(8),
        rng.random(8) + 0.5, rng.standard_normal((8, 4, 3, 3)),
        rng.standard_normal(8), rng.standard_normal((8, 4, 1, 1)),
        rng.standard_normal(5), rng.standard_normal((5, 32)),
    ]
    weights = _weights_blob(*blobs)
    assert_ir_equal(jax_from_darknet(cfg, weights), port_from_darknet(cfg, weights))


def test_quantizer_matches_jax(graphs):
    """Same calibration, same QuantParams: weights exact, activation scales
    within rtol 1e-5 (the fp32 engines sum in different orders)."""
    jg, pg, jqg, calib = graphs
    pqg = pt.quantize_graph(pg, calib, scheme="int8", algorithm="minmax", device="cpu")
    assert len(pqg.tensors) == len(jqg.tensors)
    n_act = 0
    for a, b in zip(jqg.tensors, pqg.tensors):
        assert a.dtype.name == b.dtype.name, a.name
        assert (a.quant is None) == (b.quant is None), a.name
        if a.quant is None:
            continue
        if a.tensor_type.name == "CONST" and a.dtype.name == "INT8":
            assert _quant_key(a.quant) == _quant_key(b.quant), a.name
            np.testing.assert_array_equal(a.data, b.data)
        elif a.tensor_type.name in ("VAR", "INPUT"):
            n_act += 1
            assert int(a.quant.zero_points) == int(b.quant.zero_points) == 0
            np.testing.assert_allclose(
                float(b.quant.scales), float(a.quant.scales), rtol=1e-5, err_msg=a.name
            )
    assert n_act > 150


def _routes(cg):
    count = collections.Counter()
    for node in cg.graph.nodes:
        k = cg.kernels.get(node.name)
        if k == "lower_conv_quant_pallas_direct":
            count["1x1" if node.params["kernel_h"] == 1 else "kxk"] += 1
        elif k in ("lower_conv1x1_quant_pallas", "lower_conv_quant_fast"):
            count[k] += 1
    return (count["1x1"], count["kxk"], count["lower_conv1x1_quant_pallas"],
            count["lower_conv_quant_fast"])


@pytest.mark.parametrize("tier", ["A", "B"])
def test_int8_heads_match_jax(graphs, tier):
    """The JAX-quantized graph, carried as tmfile bytes, through both
    engines' integer-storage tier at batch 2 (JAX's Pallas kernels in
    interpret mode, the port's kernels as their plain versions): every head
    within 1 LSB, on the route counts of each tier."""
    _, _, jqg, calib = graphs
    blob = graph_to_tm_bytes(jqg)
    rng = np.random.default_rng(7)
    x = np.concatenate([calib[0], rng.standard_normal((1, 3, IMG, IMG)).astype(np.float32)])
    t_in = jqg.tensors[jqg.input_tensors[0]]
    xq = jq.quantize_np(x, t_in.quant, t_in.dtype)

    opts = dict(OPTIONS[tier], batch_size=2)
    want = jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**opts)).run(xq)
    cg = pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**opts), device="cpu")
    assert _routes(cg) == ROUTES[tier]
    got = cg.run(xq)
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype == np.int8
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        print(f"{tier} head {a.shape}: equal fraction {(diff == 0).mean():.6f}, max |d| {diff.max()}")
        assert diff.max() <= 1


@pytest.mark.slow
def test_jax_tiers_part_at_160_as_the_ports_do():
    """A record for ROADMAP §3: the JAX package's own tiers A (the direct
    route: qconv_direct / qconv1x1, its Pallas kernels in interpret mode) and
    C (pallas_qconv=False: every conv on the fast lowering) part at yolov3's
    heads once the image holds an element on which the two lowerings' bias
    folds (float64 then f32, against f32 throughout) round apart: 0 LSB at
    img 96 and 128, several LSB at 160, the smallest multiple of 32 that
    shows it (batch 1, MinMax from one seeded image). Measured: 6 LSB in
    both engines. Each of the port's tiers then differs from the JAX
    engine's same tier by up to 7 LSB at the heads, printed and not held:
    the 1-LSB FMA ties of ROADMAP §3 spread through 75 layers, as at
    YOLO-Fastest's heads. About 25 s: marked slow."""
    img = 160
    jg = jax_build(img=img)
    x = np.random.default_rng(1).standard_normal((1, 3, img, img)).astype(np.float32)
    jqg = jax_quantize(jg, [x], scheme="int8", algorithm="minmax")
    t_in = jqg.tensors[jqg.input_tensors[0]]
    xq = jq.quantize_np(x, t_in.quant, t_in.dtype)
    blob = graph_to_tm_bytes(jqg)
    tiers = {"A": OPTIONS["A"], "C": dict(OPTIONS["A"], pallas_qconv=False)}
    jax_out = {t: jt.compile_graph(jt.load_tm_bytes(blob), jt.Options(**o)).run(xq)
               for t, o in tiers.items()}
    port_out = {t: pt.compile_graph(pt.load_tm_bytes(blob), pt.Options(**o), device="cpu").run(xq)
                for t, o in tiers.items()}

    def worst(a, b):
        return max(int(np.abs(u.astype(np.int32) - v.astype(np.int32)).max()) for u, v in zip(a, b))

    parted = {"JAX": worst(jax_out["A"], jax_out["C"]),
              "port": worst(port_out["A"], port_out["C"])}
    same = {t: worst(port_out[t], jax_out[t]) for t in tiers}
    print(f"img {img}: A vs C {parted} LSB; port vs JAX {same} LSB")
    assert parted["JAX"] > 1 and parted["port"] > 1
