"""The passes around the fast tier's float64 library conv
(tengine_tpu_torch/ops/cuda/requant.py, csrc/requant.cu) on the CPU.

  * qwiden_plain and qrequant_plain against an independent numpy statement
    of each branch's arithmetic (float32 steps written out with numpy's
    correctly rounded operations), bit for bit;
  * a CPU tensor takes the plain versions, and the kernels launch nothing;
  * an emulation of the kernels' walk (csrc/requant.cu: the storage order,
    the multiply-high divisions, the odometer over a thread's 8 elements)
    against the plain versions, on NHWC and NCHW tensors, ragged channel
    counts and padded buffers;
  * the argument blocks mirror the CUDA structs;
  * the fast tier's routes of both benchmark models at img 64.

The kernels themselves run in tests/test_torch_cuda.py, on the card.
"""

import collections
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads  # noqa: E402

cap_threads()

from tengine_tpu_torch.ops.cuda import build  # noqa: E402
from tengine_tpu_torch.ops.cuda import requant as rq  # noqa: E402

SILU = 100

# --- cases -----------------------------------------------------------------

# requant: name, C, layout of acc ("nhwc"/"nchw"), act, corr ("none",
# "chan", "pos", "dw", "fc"), residual (None, "exact", "relaxed"), relu2,
# store ("u8", "s8", "s8full"), bias, big (|acc| beyond 2^24)
REQUANT_CASES = [
    ("u8-plain", 32, "nhwc", -1, "none", None, False, "u8", True, False),
    ("u8-relu", 32, "nchw", 0, "none", None, False, "u8", True, False),
    ("s8-relu1", 3, "nhwc", 1, "chan", None, False, "s8", True, False),
    ("s8-relu6", 255, "nhwc", 6, "pos", None, False, "s8", True, False),
    ("s8-silu", 255, "nhwc", SILU, "none", None, False, "s8", True, False),
    ("s8-silu-nchw", 24, "nchw", SILU, "pos", None, False, "s8", False, False),
    ("u8-dw", 64, "nchw", 0, "dw", None, False, "u8", True, False),
    ("full-range", 32, "nhwc", -1, "chan", None, False, "s8full", True, True),
    ("exact", 32, "nhwc", -1, "none", "exact", False, "u8", True, False),
    ("exact-relu", 40, "nchw", 0, "none", "exact", True, "s8", True, False),
    ("relaxed", 32, "nhwc", -1, "none", "relaxed", False, "s8", True, False),
    ("relaxed-relu", 255, "nchw", -1, "none", "relaxed", True, "u8", False, False),
    ("big", 1024, "nhwc", 0, "none", None, False, "s8", True, True),
    ("fc", 1000, "fc", -1, "fc", None, False, "u8", True, True),
    ("fc-nobias", 37, "fc", -1, "none", None, False, "s8", False, False),
]

# widen: mode, layout of x, pads, dtype
WIDEN_CASES = [
    ("shift", "nhwc", None, "u8"),
    ("shift", "nchw", ((0, 1), (0, 1)), "u8"),
    ("raw", "nhwc", ((1, 2), (0, 1)), "s8"),
    ("raw", "nchw", None, "s8"),
    ("fill", "nhwc", ((1, 1), (1, 1)), "u8"),
    ("fill", "nchw", ((0, 1), (1, 0)), "s8"),
]


def _layout(a: np.ndarray, layout: str) -> torch.Tensor:
    """An NHWC array as a tensor with NHWC memory, or as the NHWC view of an
    NCHW tensor."""
    if layout == "nchw":
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    return torch.from_numpy(np.ascontiguousarray(a))


def requant_inputs(case, seed):
    name, C, layout, act, corr_kind, res, relu2, store, has_bias, big = case
    rng = np.random.default_rng(seed)
    shape = (5, C) if layout == "fc" else (2, 5, 7, C)
    span = 2**27 if big else 2**16
    acc = rng.integers(-span, span, shape).astype(np.float64)
    acc.flat[:3] = [0, 2**24 + 1, -(2**25) - 3]
    m_scale = 100.0 / span
    mult = (rng.random(C) * m_scale + m_scale / 4).astype(np.float32)
    bias = (rng.standard_normal(C) * 20).astype(np.float32) if has_bias else None
    corr = {
        "none": None,
        "chan": (rng.standard_normal((1, C)) * 30).astype(np.float32),
        "pos": (rng.standard_normal((1, 5, 7, C)) * 30).astype(np.float32),
        "dw": (rng.standard_normal(C) * 30).astype(np.float32),
        "fc": np.round(rng.standard_normal(C) * 3000).astype(np.float32),
    }[corr_kind]
    if store == "u8":
        zp_out, lo, hi = 117, 0, 255
    else:
        zp_out, lo, hi = (-9, -128, 127) if store == "s8full" else (0, -127, 127)
    ep = dict(zp_out=zp_out, lo=lo, hi=hi, out_u8=store == "u8", s_out=0.0473, act=act,
              corr_first=corr_kind == "fc", relu2=relu2)
    residual = None
    if res is not None:
        r_u8 = seed % 2 == 0
        residual = rng.integers(0 if r_u8 else -127, 256 if r_u8 else 128, shape).astype(
            np.uint8 if r_u8 else np.int8)
        if res == "exact":
            ep.update(residual="exact", s_r=0.061, zp_r=128 if r_u8 else 0,
                      inv_s_out2=float(np.float32(1.0) / np.float32(0.0831)),
                      zp_out2=3 if store == "u8" else 0, lo2=lo, hi2=hi)
        else:
            ep.update(residual="relaxed", beta=float(np.float32(0.061 / 0.0473)))
            if bias is None:
                ep.update(zp_shift=float(np.float32(5 * 0.061 / 0.0473)))
    arrays = dict(acc=acc, mult=mult, bias=bias, corr=corr, residual=residual)
    return arrays, rq.Epilogue(**ep), layout


def requant_tensors(arrays, layout):
    """The plain version's tensors: acc in its layout (FC: [N, O]); the
    residual NHWC in the other layout than acc's, where there is one."""
    acc = arrays["acc"]
    t_acc = torch.from_numpy(acc) if layout == "fc" else _layout(acc, layout)
    res = arrays["residual"]
    t_res = None
    if res is not None:
        t_res = _layout(res, "nhwc" if layout == "nchw" else "nchw") if res.ndim == 4 \
            else torch.from_numpy(res)
    opt = {k: None if arrays[k] is None else torch.from_numpy(arrays[k])
           for k in ("bias", "corr")}
    return t_acc, torch.from_numpy(arrays["mult"]), opt["bias"], opt["corr"], t_res


# --- the numpy statement ---------------------------------------------------

F32 = np.float32


def _round_away_np(x):
    """C round() on float32 values: trunc, then one step away from zero at
    a fraction of at least one half."""
    t = np.trunc(x).astype(F32)
    step = (np.abs(x - t) >= F32(0.5)).astype(F32) * np.sign(x).astype(F32)
    return (t + step).astype(F32)


def requant_np(arrays, ep):
    """Each branch's f32 arithmetic with numpy's correctly rounded float32
    operations; the sigmoid correctly rounded from float64."""
    q = arrays["acc"].astype(F32)
    corr = arrays["corr"]
    if corr is not None and ep.corr_first:
        q = (q + corr).astype(F32)
    q = (q * arrays["mult"]).astype(F32)
    if arrays["bias"] is not None:
        q = (q + arrays["bias"]).astype(F32)
    elif ep.zp_shift:
        q = (q - F32(ep.zp_shift)).astype(F32)
    if corr is not None and not ep.corr_first:
        q = (q + corr).astype(F32)
    if ep.act == SILU:
        z = (q * F32(ep.s_out)).astype(F32)
        with np.errstate(over="ignore"):
            sig = (1.0 / (1.0 + np.exp(-z.astype(np.float64)))).astype(F32)
        q = (q * sig).astype(F32)
    elif ep.act == 1:
        q = np.clip(q, F32(-1.0 / ep.s_out), F32(1.0 / ep.s_out))
    elif ep.act >= 0:
        q = np.maximum(q, F32(0))
        if ep.act > 0:
            q = np.minimum(q, F32(ep.act / ep.s_out))
    res = arrays["residual"]
    if ep.residual == "relaxed":
        y = (q + (res.astype(F32) * F32(ep.beta)).astype(F32)).astype(F32)
        if ep.relu2:
            y = np.maximum(y, F32(0))
        out = np.clip(_round_away_np(y) + F32(ep.zp_out), ep.lo, ep.hi)
    else:
        t = np.clip((_round_away_np(q) + F32(ep.zp_out)).astype(F32), ep.lo, ep.hi)
        out = t
        if ep.residual == "exact":
            tf = ((t - F32(ep.zp_out)).astype(F32) * F32(ep.s_out)).astype(F32)
            rf = ((res.astype(F32) - F32(ep.zp_r)).astype(F32) * F32(ep.s_r)).astype(F32)
            y = (_round_away_np(((tf + rf).astype(F32) * F32(ep.inv_s_out2)).astype(F32))
                 + F32(ep.zp_out2)).astype(F32)
            if ep.relu2:
                y = np.maximum(y, F32(ep.zp_out2))
            out = np.clip(y, ep.lo2, ep.hi2)
    return out.astype(np.uint8 if ep.out_u8 else np.int8)


def widen_inputs(case, seed):
    mode, layout, pads, dtype = case
    rng = np.random.default_rng(seed)
    u8 = dtype == "u8"
    x = rng.integers(0 if u8 else -128, 256 if u8 else 128, (2, 6, 5, 12)).astype(
        np.uint8 if u8 else np.int8)
    return x, _layout(x, layout), dict(zp_in=113 if u8 else -7, mode=mode, pads=pads)


def widen_np(x, zp_in, mode, pads):
    v = x.astype(np.float64) - (zp_in if mode == "shift" else 0)
    if pads is None:
        return v
    (pt, pb), (pl, pr) = pads
    return np.pad(v, ((0, 0), (pt, pb), (pl, pr), (0, 0)),
                  constant_values=zp_in if mode == "fill" else 0)


# --- the plain versions against the numpy statement ------------------------


@pytest.mark.parametrize("case", REQUANT_CASES, ids=lambda c: c[0])
def test_requant_plain_matches_the_numpy_statement(case):
    arrays, ep, layout = requant_inputs(case, seed=len(case[0]) * 7 + case[1])
    got = rq.qrequant_plain(*requant_tensors(arrays, layout), ep)
    assert got.dtype == (torch.uint8 if ep.out_u8 else torch.int8)
    np.testing.assert_array_equal(got.numpy(), requant_np(arrays, ep))


@pytest.mark.parametrize("case", WIDEN_CASES, ids=str)
def test_widen_plain_matches_the_numpy_statement(case):
    x, t, kw = widen_inputs(case, seed=3)
    got = rq.qwiden_plain(t, **kw)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), widen_np(x, **kw))


def test_a_cpu_tensor_takes_the_plain_versions():
    arrays, ep, layout = requant_inputs(REQUANT_CASES[4], seed=1)
    args = requant_tensors(arrays, layout)
    x, t, kw = widen_inputs(WIDEN_CASES[2], seed=1)
    before = (rq.qwiden.launches, rq.qrequant.launches, rq.qwiden.plain, rq.qrequant.plain)
    assert torch.equal(rq.qrequant(*args, ep), rq.qrequant_plain(*args, ep))
    assert torch.equal(rq.qwiden(t, **kw), rq.qwiden_plain(t, **kw))
    after = (rq.qwiden.launches, rq.qrequant.launches, rq.qwiden.plain, rq.qrequant.plain)
    assert after == (before[0], before[1], before[2] + 1, before[3] + 1)
    # a meta tensor (shape inference) takes them too, uncounted
    m = rq.qwiden(t.to("meta"), **kw)
    assert m.device.type == "meta" and rq.qwiden.plain == after[2]


# --- the kernels' walk, emulated -------------------------------------------


def _udiv(n, d):
    mag, shf = rq._divider(d)
    return (((n * mag) >> 32) + n) >> shf


def emulate_walk(walk, n, group):
    """The stream offsets of every storage index as the kernels compute
    them: the first element of each group (a requant thread's VEC, a widen
    lane's pair) decoded by odo_start, the rest by odo_next
    (csrc/requant.cu)."""
    sz, step, carry, base = list(walk.sz), walk.step, walk.carry, list(walk.base)
    offs = np.zeros((rq.NSTREAM, n), np.int64)
    for i0 in range(0, n, group):
        r, idx = i0, [0] * 4
        for k in (3, 2, 1):
            q = _udiv(r, sz[k])
            idx[k], r = r - q * sz[k], q
        idx[0] = r
        off = [base[s] + sum(idx[k] * step[s][k] for k in range(4)) for s in range(rq.NSTREAM)]
        for e in range(group):
            if i0 + e >= n:
                break
            offs[:, i0 + e] = off
            off = [o + step[s][3] for s, o in enumerate(off)]
            idx[3] += 1
            for k in (3, 2, 1):
                if idx[k] < sz[k]:
                    break
                idx[k] = 0
                off = [o + carry[s][k - 1] for s, o in enumerate(off)]
                idx[k - 1] += 1
    return offs


@pytest.mark.parametrize("d", [1, 2, 3, 7, 49, 64, 255, 1000, 12544, 2**20 + 7])
def test_the_multiply_high_division_is_exact(d):
    n = np.array([0, 1, d - 1, d, d + 1, 2 * d - 1, 12345677, 2**31 - 1], np.int64)
    mag, shf = rq._divider(d)
    assert 0 < mag < 2**32
    got = ((((n * mag) >> 32) + n) >> shf)
    np.testing.assert_array_equal(got, n // d)


def _storage(t, like=None):
    """The tensor's elements in the storage order of `like` (default: its
    own)."""
    like = t if like is None else like
    order = rq.storage_order(tuple(like.shape), like.stride())
    return t.permute(*order).contiguous().reshape(-1)


@pytest.mark.parametrize("case", [c for c in REQUANT_CASES if c[3] != SILU], ids=lambda c: c[0])
def test_requant_kernel_emulation_matches_plain(case):
    """The numpy statement over the operands the kernel's walk gathers (its
    channel, correction and residual offsets), against qrequant_plain:
    SiLU's expf is left to the card."""
    arrays, ep, layout = requant_inputs(case, seed=11 + case[1])
    acc, mult, bias, corr, res = requant_tensors(arrays, layout)
    want = rq.qrequant_plain(acc, mult, bias, corr, res, ep)
    a4 = rq._as4(acc)
    shape, C = tuple(a4.shape), a4.shape[3]
    streams = [(0, (0, 0, 0, 1)), (0, (0, 0, 0, 1)), (0, (0, 0, 0, 0))]
    if corr is not None:
        streams[1] = (0, rq._as4(corr.expand(acc.shape)).stride())
    if res is not None:
        streams[2] = (0, rq._as4(res).stride())
    walk = rq.make_walk(shape, a4.stride(), streams)
    offs = emulate_walk(walk, acc.numel(), rq.VEC)
    c = offs[0]
    np.testing.assert_array_equal(c, _storage(torch.arange(C).expand(shape), a4).numpy())
    emu = dict(arrays)
    emu["acc"] = _storage(a4).numpy()
    emu["mult"], emu["bias"] = arrays["mult"][c], None if bias is None else arrays["bias"][c]
    if corr is not None:
        emu["corr"] = corr.reshape(-1).numpy()[offs[1]]
    if res is not None:
        emu["residual"] = np.lib.stride_tricks.as_strided(
            res.numpy(), (res.numel(),), (1,))[offs[2]]
    got = requant_np(emu, ep)
    np.testing.assert_array_equal(got, _storage(rq._as4(want), a4).numpy())


@pytest.mark.parametrize("case", WIDEN_CASES, ids=str)
def test_widen_kernel_emulation_matches_plain(case):
    """The widen kernel over its walk: the input offset, row and column of
    each element of the output's storage, against qwiden_plain's buffer,
    which it also takes the layout of."""
    x, t, kw = widen_inputs(case, seed=5)
    want = rq.qwiden_plain(t, **kw)
    pads = kw["pads"]
    shape, stride = rq.widen_layout(tuple(t.shape), t.stride(), kw["mode"], pads)
    assert (shape, stride) == (tuple(want.shape), want.stride())
    (pt, _), (pl, _) = pads or ((0, 0), (0, 0))
    sx = t.stride()
    walk = rq.make_walk(shape, stride, [(-pt * sx[1] - pl * sx[2], sx), (-pt, (0, 1, 0, 0)),
                                        (-pl, (0, 0, 1, 0))])
    offs = emulate_walk(walk, want.numel(), 2)
    _, h, w, _ = t.shape
    inside = (offs[1] >= 0) & (offs[1] < h) & (offs[2] >= 0) & (offs[2] < w)
    flat = np.lib.stride_tricks.as_strided(t.numpy(), (t.numel(),), (t.element_size(),))
    vals = flat[np.where(inside, offs[0], 0)].astype(np.float64)
    sub = kw["zp_in"] if kw["mode"] == "shift" else 0
    fill = kw["zp_in"] if kw["mode"] == "fill" else 0
    got = np.where(inside, vals - sub, fill)
    storage = np.lib.stride_tricks.as_strided(want.numpy(), (want.numel(),), (8,))
    np.testing.assert_array_equal(got, storage)


def test_the_storage_order_refuses_a_strided_view():
    x = torch.zeros(2, 4, 6, 8)[:, :, ::2]
    with pytest.raises(ValueError, match="not dense"):
        rq.storage_order(tuple(x.shape), x.stride())


# --- the argument blocks ---------------------------------------------------

_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double,
           "unsigned": ctypes.c_uint}


def _struct_fields(src, name):
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        m = re.match(r"(const void\*|void\*|const double\*|double\*|const float\*|int|float|"
                     r"double|unsigned|Walk|RequantSteps)\s+(.*)", line)
        assert m, line
        for decl in m.group(2).split(","):
            nm, *dims = re.findall(r"\w+", decl)
            fields.append((nm, m.group(1), [int(d) if d.isdigit() else d for d in dims]))
    return fields


@pytest.mark.parametrize("name", ["Walk", "WidenArgs", "RequantArgs", "RequantSteps"])
def test_args_blocks_mirror_the_cuda_structs(name):
    """The ctypes blocks against the structs of csrc/requant.cu and (the
    steps it shares with csrc/qconv.cu) csrc/requant_steps.cuh."""
    src = (build.CSRC_DIR / "requant.cu").read_text() + (
        build.CSRC_DIR / "requant_steps.cuh").read_text()
    consts = {"NSTREAM": rq.NSTREAM}
    cls = getattr(rq, name)
    want = []
    for nm, ctype, dims in _struct_fields(src, name):
        if ctype in ("Walk", "RequantSteps"):
            t = getattr(rq, ctype)
        elif "*" in ctype:
            t = ctypes.c_void_p
        else:
            t = _CTYPES[ctype]
        for d in reversed(dims):
            t = t * consts.get(d, d)
        want.append((nm, ctypes.sizeof(t), getattr(t, "_type_", t)))
    got = [(nm, ctypes.sizeof(t), getattr(t, "_type_", t)) for nm, t in cls._fields_]
    assert got == want


def _code(name):
    src = (build.CSRC_DIR / name).read_text()
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def test_kernel_names_stay_out_of_the_benchmarks_library_conv_bucket():
    """The benchmark sorts device time by kernel name: a library conv's name
    holds conv, gemm, xmma or cutlass; these kernels' names hold none. The
    f32 steps they share with csrc/qconv.cu's fast epilogue (the full expf
    and the IEEE division of SiLU) live in csrc/requant_steps.cuh, which
    both include; the fast epilogue is a mode of qconv_mma_kernel, whose
    name the benchmark counts among the program's own kernels."""
    code = _code("requant.cu")
    names = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))? (\w+)\((\w+)", code)
    assert [n for n, _ in names] == ["qwiden_kernel", "qrequant_kernel"]
    for kernel, arg in names:
        for word in ("conv", "gemm", "xmma", "cutlass"):
            assert word not in kernel.lower() and word not in arg.lower()
    steps = _code("requant_steps.cuh")
    assert "__expf" not in code + steps and "expf(-z)" in steps and "__fdiv_rn(1.0f" in steps
    assert '#include "requant_steps.cuh"' in code and "requant_steps::apply(" in code
    qconv = _code("qconv.cu")
    assert '#include "requant_steps.cuh"' in qconv and "requant_steps::apply<SILU, RES>(" in qconv
    kernels = re.findall(r"template <([^>]*)>\s*__global__ void\s+__launch_bounds__\([^)]*\)\s+"
                         r"(\w+)\(", qconv)
    assert [(k, "int EPI" in t) for t, k in kernels] == [("qconv_mma_kernel", True)]
    assert "qconv_mma_kernel<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, ROWSUM, WGMMA, EPI>" in qconv
    for epi in ("EPI_FAST", "EPI_FAST_SILU", "EPI_FAST_NOSILU"):
        assert f"false, WGMMA, {epi}>(a, vec, s)" in qconv


# --- the routes of both benchmark models -----------------------------------


def test_fast_tier_routes_of_both_benchmark_models_at_img_64():
    """Both benchmark configurations at img 64 on the CPU route as before:
    every quantized conv (and mobilenet's FC) on the fast lowerings, which
    widen each conv's input once and requantize each conv and FC once. On
    the CPU yolov5s's INT8 convs run qconv_fast's plain version, which is
    that chain: all 81 at img 64 (the stem kernel takes the first at 640);
    no mobilenet conv (UINT8) takes it."""
    from hbench import harness
    from hbench.tests.small import small_cell

    from tengine_tpu_torch.executor.engine import compile_graph
    from tengine_tpu_torch.ops.cuda import qconv as pq
    from tengine_tpu_torch.utils.config import Options

    want = {
        "mnv1-u8-b128": ({"lower_conv_quant_fast": 27, "lower_global_avgpool_quant": 1,
                          "lower_fc_quant_fast": 1}, torch.uint8, 27, 28, 0),
        "yolov5s-i8-b8": ({"lower_conv_quant_fast": 81, "lower_eltwise": 17,
                           "lower_maxpool_quant": 3, "_lower": 1}, torch.int8, 81, 81, 81),
    }
    for cell, (routes, dtype, widens, requants, fast) in want.items():
        pr = harness.prepare(small_cell(cell), 2**33 + 5, torch.device("cpu"))
        cg = compile_graph(pr.qg, Options(quant_mode="fast", batch_size=1), device="cpu")
        assert dict(collections.Counter(cg.kernels.values())) == routes
        t_in = pr.qg.tensors[pr.qg.input_tensors[0]]
        before = (rq.qwiden.plain, rq.qrequant.plain, pq.qconv_fast.plain)
        cg(torch.zeros([1, *t_in.shape[1:]], dtype=dtype))
        assert (rq.qwiden.plain - before[0], rq.qrequant.plain - before[1]) == (widens, requants)
        assert pq.qconv_fast.plain - before[2] == fast
