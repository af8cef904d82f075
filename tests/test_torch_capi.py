"""The port's C ABI (tengine_tpu_torch/native/c_api_shim.c over
tengine_tpu_torch/capi_bridge.py) against the JAX package's, on the CPU.

tests/test_c_api_shim.py's six cases, each with the same tmfile bytes through
both shims:

  * attach: both libraries loaded into this process with ctypes (they share
    its interpreter through PyGILState);
  * embed: one C program, compiled here with gcc, that dlopens both
    libraries in turn and runs the case through each, in a fresh process
    whose interpreter the first library starts (the port's then attaches to
    it). Three such subprocesses in all, each importing torch and JAX.

The port's graphs run on the CPU because the CPU is asked for through the C
API: set_default_device("CPU") or a context with set_context_device(ctx,
"CPU"); the JAX bridge records both and returns 0. fp32 outputs agree within
rtol 1e-5 and atol 1e-6, or 1e-5 where the JAX test takes that (the two
engines sum the convs in other orders), a narrow mobilenet-v1 UINT8 within 1 LSB, and the
port's C path equals its in-process CompiledGraph at 0 LSB. Beside them:
with no device request and no card, prerun_graph returns -1; a device name
other than CPU or CUDA returns -1; a depthwise conv built through the C API
without dilation keys runs on the port's dw route where the JAX gate raises
KeyError (ROADMAP §3). The host node of the custom kernel on the card is
tests/test_torch_compiled.py's cuda case.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import cap_threads, thread_share  # noqa: E402

cap_threads()

from tengine_tpu.graph import ir as jir  # noqa: E402
from tengine_tpu.native import build_capi as jax_build_capi  # noqa: E402
from tengine_tpu.ops import qmath as jq  # noqa: E402
from tengine_tpu.quantize.quantizer import quantize_graph as jax_quantize  # noqa: E402
from tengine_tpu.serializer.tm2.writer import graph_to_tm_bytes  # noqa: E402

import tengine_tpu_torch as tt  # noqa: E402
from tengine_tpu_torch import capi_bridge, native  # noqa: E402

from test_execute_small import make_conv_graph  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import (  # noqa: E402
    build_mobilenet_v1_graph, capi_attach as attach, capi_build_graph, capi_output as read_output,
)

SHIMS = ("jax", "port")
V, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p


@pytest.fixture(scope="module")
def libs():
    """Both shims' libraries, built here (gcc; the JAX shim links the shared
    libpython, the port's does where there is one)."""
    if shutil.which("gcc") is None or native.shared_libpython() is None:
        pytest.skip("needs gcc and a shared libpython")
    jax_path = jax_build_capi()
    assert jax_path is not None, "the JAX package's build_capi failed"
    return {"jax": jax_path, "port": str(native.build_capi())}


@pytest.fixture
def no_default_device(monkeypatch):
    """The port bridge's process-wide device request, unset for the test and
    restored after it (the attach cases share this process's bridge)."""
    monkeypatch.setattr(capi_bridge, "_default_device", None)


def run_attached(lib, g, x):
    """Feed x to input 0, prerun, run; output 0's bytes."""
    t_in = lib.get_graph_input_tensor(g, 0, 0)
    x = np.ascontiguousarray(x)
    assert lib.get_tensor_buffer_size(t_in) == x.nbytes
    assert lib.set_tensor_buffer(t_in, x.ctypes.data, x.nbytes) == 0
    assert lib.prerun_graph(g) == 0
    assert lib.run_graph(g, 1) == 0
    return read_output(lib, g)


@pytest.fixture(scope="module")
def small_tmfile(tmp_path_factory):
    """tests/test_c_api_shim.py's conv tmfile, its input, and the port's
    in-process output on it."""
    rng = np.random.default_rng(5)
    g, _, _ = make_conv_graph(in_shape=(1, 3, 8, 8), out_c=4, activation=0, rng=rng)
    path = tmp_path_factory.mktemp("capi") / "m.tmfile"
    path.write_bytes(graph_to_tm_bytes(g))
    x = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    golden = tt.compile_graph(tt.load_tmfile(str(path)), device="cpu").run(x)[0]
    return str(path), x, golden


def test_attach_mode(libs, small_tmfile, no_default_device):
    tmfile, x, golden = small_tmfile
    outs = {}
    for name in SHIMS:
        lib = attach(libs[name])
        assert lib.get_tengine_version()
        assert lib.set_default_device(b"CPU") == 0
        g = lib.create_graph(None, b"tengine", tmfile.encode())
        assert g
        dims = (I * 4)()
        assert lib.get_tensor_shape(lib.get_graph_input_tensor(g, 0, 0), dims, 4) == 4
        assert list(dims) == [1, 3, 8, 8]
        outs[name] = np.frombuffer(run_attached(lib, g, x), np.float32).reshape(golden.shape)
        assert lib.destroy_graph(g) == 0
    assert attach(libs["port"]).get_tengine_version() == tt.__version__.encode()
    np.testing.assert_array_equal(outs["port"], golden)  # = the in-process engine
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5, atol=1e-6)


# One C program for the three embed cases: it dlopens each library named on
# its command line and runs the case through it, writing <out>.<i>.bin.
C_PROGRAM = r"""
#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef void* context_t; typedef void* graph_t; typedef void* tensor_t; typedef void* node_t;
#define MAX_SHAPE_DIM_NUM 8
struct custom_kernel_tensor {
    int dim[MAX_SHAPE_DIM_NUM]; int dim_num; int element_num; int element_size;
    int data_type; int dev_type; int layout_type; int quant_type;
    float* scale; int* zero_point; int* quant_number;
    void* data; void* dev_mem; void* mapped_mem;
};
struct custom_kernel_ops {
    const char* kernel_name; const char* op; int force;
    void* kernel_param; int kernel_param_size;
    int (*infer_shape)(struct custom_kernel_ops*, const int*[], int, int*[], int, int);
    int (*inplace_info)(struct custom_kernel_ops*, int);
    int (*bind)(void); int (*prerun)(void); int (*reshape)(void);
    int (*run)(struct custom_kernel_ops*, struct custom_kernel_tensor*[], int,
               struct custom_kernel_tensor*[], int);
    int (*postrun)(void); void (*release)(struct custom_kernel_ops*);
};

#define API(X) \
  X(int, init_tengine, (void)) X(const char*, get_tengine_version, (void)) \
  X(graph_t, create_graph, (context_t, const char*, const char*, ...)) \
  X(int, prerun_graph, (graph_t)) X(int, run_graph, (graph_t, int)) \
  X(int, destroy_graph, (graph_t)) X(int, wait_graph, (graph_t, int)) \
  X(tensor_t, get_graph_input_tensor, (graph_t, int, int)) \
  X(tensor_t, get_graph_output_tensor, (graph_t, int, int)) \
  X(int, get_tensor_buffer_size, (tensor_t)) X(void*, get_tensor_buffer, (tensor_t)) \
  X(int, set_tensor_buffer, (tensor_t, void*, int)) X(int, get_tensor_shape, (tensor_t, int*, int)) \
  X(int, set_tensor_shape, (tensor_t, const int*, int)) \
  X(int, get_graph_node_num, (graph_t)) X(node_t, get_graph_node, (graph_t, const char*)) \
  X(node_t, get_graph_node_by_idx, (graph_t, int)) X(const char*, get_node_name, (node_t)) \
  X(const char*, get_node_op, (node_t)) X(int, get_node_input_number, (node_t)) \
  X(int, get_node_output_number, (node_t)) X(tensor_t, get_node_output_tensor, (node_t, int)) \
  X(int, get_tensor_quant_param, (tensor_t, float*, int*, int)) \
  X(int, set_tensor_quant_param, (tensor_t, const float*, const int*, int)) \
  X(int, set_custom_kernel, (node_t, const char*, struct custom_kernel_ops*)) \
  X(context_t, create_context, (const char*, int)) X(void, destroy_context, (context_t)) \
  X(int, set_context_device, (context_t, const char*, const void*, size_t)) \
  X(int, get_context_device_number, (context_t)) X(int, set_default_device, (const char*)) \
  X(node_t, create_graph_node, (graph_t, const char*, const char*)) \
  X(tensor_t, create_graph_tensor, (graph_t, const char*, int)) \
  X(int, set_node_input_tensor, (node_t, int, tensor_t)) \
  X(int, set_node_output_tensor, (node_t, int, tensor_t, int)) \
  X(int, set_node_attr_int, (node_t, const char*, const int*)) \
  X(int, get_node_attr_int, (node_t, const char*, int*)) \
  X(int, set_graph_input_node, (graph_t, const char*[], int)) \
  X(int, set_graph_output_node, (graph_t, const char*[], int)) \
  X(void, release_graph_tensor, (tensor_t)) X(void, release_graph_node, (node_t))

#define FIELD(ret, name, args) ret(*name) args;
struct api { API(FIELD) };
static struct api A;

static int load(const char* path) {
    /* global, as a linked library's: CPython's extension modules (numpy)
     * resolve the interpreter's symbols there */
    void* h = dlopen(path, RTLD_NOW | RTLD_GLOBAL);
    if (!h) { fprintf(stderr, "dlopen %s: %s\n", path, dlerror()); return -1; }
#define SYM(ret, name, args) if (!(*(void**)&A.name = dlsym(h, #name))) return -1;
    API(SYM)
    return 0;
}

static int write_out(graph_t g, const char* path) {
    tensor_t t = A.get_graph_output_tensor(g, 0, 0);
    int nbytes = A.get_tensor_buffer_size(t);
    void* p = A.get_tensor_buffer(t);
    FILE* f = fopen(path, "wb");
    if (!p || !f || fwrite(p, 1, nbytes, f) != (size_t)nbytes) return -1;
    fclose(f);
    return 0;
}

static float* read_floats(const char* path, int n) {
    float* x = (float*)malloc(n * sizeof(float));
    FILE* f = fopen(path, "rb");
    if (!f || fread(x, sizeof(float), n, f) != (size_t)n) return NULL;
    fclose(f);
    return x;
}

/* tests/test_c_api_shim.py:test_embed_mode's program */
static int basic(const char* tmfile, const char* xin, const char* out) {
    graph_t g = A.create_graph(NULL, "tengine", tmfile);
    if (!g) return 10;
    tensor_t tin = A.get_graph_input_tensor(g, 0, 0);
    int dims[4]; int nd = A.get_tensor_shape(tin, dims, 4);
    int n = 1; for (int i = 0; i < nd; i++) n *= dims[i];
    float* x = read_floats(xin, n);
    if (!x || A.set_tensor_buffer(tin, x, n * sizeof(float)) != 0) return 11;
    if (A.prerun_graph(g) != 0 || A.run_graph(g, 1) != 0) return 12;
    if (write_out(g, out) != 0) return 13;
    A.destroy_graph(g);
    free(x);
    return 0;
}

static int double_run(struct custom_kernel_ops* ops, struct custom_kernel_tensor* in[],
                      int in_num, struct custom_kernel_tensor* out[], int out_num) {
    (void)ops; (void)in_num; (void)out_num;
    const float* x = (const float*)in[0]->data;
    float* y = (float*)out[0]->data;
    for (int i = 0; i < out[0]->element_num; i++) y[i] = 2.0f * x[i];
    return 0;
}

/* tests/test_c_api_shim.py:test_embed_mode_extended's program: memory
 * load, node accessors, quant params, a C custom kernel (y = 2x) in place
 * of the ReLu */
static int extended(const char* tmfile, const char* xin, const char* out) {
    FILE* f = fopen(tmfile, "rb");
    fseek(f, 0, SEEK_END); long sz = ftell(f); fseek(f, 0, SEEK_SET);
    char* blob = (char*)malloc(sz);
    if (fread(blob, 1, sz, f) != (size_t)sz) return 20;
    fclose(f);
    graph_t g = A.create_graph(NULL, "tengine:m", blob, (int)sz);
    if (!g || A.get_graph_node_num(g) < 2) return 21;
    node_t relu = A.get_graph_node(g, "act");
    if (!relu || strcmp(A.get_node_op(relu), "ReLu") || strcmp(A.get_node_name(relu), "act")) return 22;
    if (A.get_node_input_number(relu) != 1 || A.get_node_output_number(relu) != 1) return 23;
    if (!A.get_graph_node_by_idx(g, 0)) return 24;
    tensor_t t_relu = A.get_node_output_tensor(relu, 0);
    float s_in[1] = {0.125f}; int zp_in[1] = {3};
    float s_out[1] = {0}; int zp_out[1] = {-1};
    if (A.set_tensor_quant_param(t_relu, s_in, zp_in, 1) != 0) return 25;
    if (A.get_tensor_quant_param(t_relu, s_out, zp_out, 1) != 0 || s_out[0] != 0.125f || zp_out[0] != 3)
        return 26;
    static struct custom_kernel_ops ops;
    memset(&ops, 0, sizeof(ops));
    ops.kernel_name = "double"; ops.op = "ReLu"; ops.run = double_run;
    if (A.set_custom_kernel(relu, "cpu", &ops) != 0) return 27;
    tensor_t tin = A.get_graph_input_tensor(g, 0, 0);
    int dims[4]; int nd = A.get_tensor_shape(tin, dims, 4);
    int n = 1; for (int i = 0; i < nd; i++) n *= dims[i];
    float* x = read_floats(xin, n);
    if (!x || A.set_tensor_buffer(tin, x, n * sizeof(float)) != 0) return 28;
    if (A.prerun_graph(g) != 0 || A.run_graph(g, 1) != 0) return 29;
    if (write_out(g, out) != 0) return 30;
    A.destroy_graph(g);
    free(x); free(blob);
    return 0;
}

static int seti(node_t n, const char* name, int v) { return A.set_node_attr_int(n, name, &v); }

/* tests/test_c_api_shim.py:test_embed_mode_construction's program: a conv
 * graph built from C, on a context that asks for the CPU */
static int construction(const char* xwb, const char* out) {
    context_t ctx = A.create_context("c_build", 1);
    if (A.set_context_device(ctx, "CPU", NULL, 0) != 0 || A.get_context_device_number(ctx) != 1)
        return 40;
    graph_t g = A.create_graph(ctx, NULL, NULL);
    if (!g) return 41;
    node_t in_node = A.create_graph_node(g, "input", "InputOp");
    tensor_t t_x = A.create_graph_tensor(g, "data", 0);
    if (!in_node || !t_x || A.set_node_output_tensor(in_node, 0, t_x, 3) != 0) return 42;
    int xdims[4] = {1, 3, 8, 8}, wdims[4] = {4, 3, 3, 3}, bdims[1] = {4};
    if (A.set_tensor_shape(t_x, xdims, 4) != 0) return 43;
    node_t w_node = A.create_graph_node(g, "conv/w", "Const");
    tensor_t t_w = A.create_graph_tensor(g, "conv/w", 0);
    A.set_node_output_tensor(w_node, 0, t_w, 2);
    A.set_tensor_shape(t_w, wdims, 4);
    node_t b_node = A.create_graph_node(g, "conv/b", "Const");
    tensor_t t_b = A.create_graph_tensor(g, "conv/b", 0);
    A.set_node_output_tensor(b_node, 0, t_b, 2);
    A.set_tensor_shape(t_b, bdims, 1);
    node_t conv = A.create_graph_node(g, "conv", "Convolution");
    A.set_node_input_tensor(conv, 0, t_x);
    A.set_node_input_tensor(conv, 1, t_w);
    A.set_node_input_tensor(conv, 2, t_b);
    tensor_t t_y = A.create_graph_tensor(g, "y", 0);
    A.set_node_output_tensor(conv, 0, t_y, 1);
    seti(conv, "kernel_h", 3); seti(conv, "kernel_w", 3); seti(conv, "stride_h", 1);
    seti(conv, "stride_w", 1); seti(conv, "dilation_h", 1); seti(conv, "dilation_w", 1);
    seti(conv, "pad_h0", 1); seti(conv, "pad_h1", 1); seti(conv, "pad_w0", 1);
    seti(conv, "pad_w1", 1); seti(conv, "group", 1); seti(conv, "activation", 0);
    seti(conv, "input_channel", 3); seti(conv, "output_channel", 4);
    int back = -1;
    if (A.get_node_attr_int(conv, "kernel_h", &back) != 0 || back != 3) return 44;
    const char* ins[1] = {"input"}; const char* outs[1] = {"conv"};
    if (A.set_graph_input_node(g, ins, 1) != 0 || A.set_graph_output_node(g, outs, 1) != 0) return 45;
    float* buf = read_floats(xwb, 192 + 108 + 4);
    if (!buf || A.set_tensor_buffer(t_w, buf + 192, 108 * 4) != 0 ||
        A.set_tensor_buffer(t_b, buf + 300, 4 * 4) != 0 || A.set_tensor_buffer(t_x, buf, 192 * 4) != 0)
        return 46;
    if (A.prerun_graph(g) != 0 || A.run_graph(g, 1) != 0 || A.wait_graph(g, 1) != 0) return 47;
    if (A.get_tensor_buffer_size(A.get_graph_output_tensor(g, 0, 0)) != 4 * 8 * 8 * 4) return 48;
    if (write_out(g, out) != 0) return 49;
    A.release_graph_tensor(t_y);
    A.release_graph_node(conv);
    A.destroy_graph(g);
    A.destroy_context(ctx);
    free(buf);
    return 0;
}

/* program <case> <out prefix> <arg1> <arg2> <library>... */
int main(int argc, char** argv) {
    for (int i = 5; i < argc; i++) {
        if (load(argv[i]) != 0) return 2;
        if (A.init_tengine() != 0) return 3;
        if (A.set_default_device("CPU") != 0) return 4;
        char out[4096];
        snprintf(out, sizeof(out), "%s.%d.bin", argv[2], i - 5);
        int rc = !strcmp(argv[1], "basic") ? basic(argv[3], argv[4], out)
               : !strcmp(argv[1], "extended") ? extended(argv[3], argv[4], out)
               : construction(argv[3], out);
        if (rc != 0) { fprintf(stderr, "%s through %s: %d\n", argv[1], argv[i], rc); return rc; }
        printf("%s ok through %s %s\n", argv[1], argv[i], A.get_tengine_version());
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def c_program(libs, tmp_path_factory):
    d = tmp_path_factory.mktemp("capi_program")
    (d / "program.c").write_text(C_PROGRAM)
    subprocess.run(["gcc", "-O1", "-Wall", str(d / "program.c"), "-ldl", "-o", str(d / "program")],
                   check=True, capture_output=True)
    return d / "program"


def embed(c_program, libs, case, arg1, arg2, out_shape):
    """Run one case through both libraries in one embedded process; the
    outputs by shim."""
    out = c_program.parent / case
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(thread_share(len(os.sched_getaffinity(0)),
                                                int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))))
    r = subprocess.run([str(c_program), case, str(out), str(arg1), str(arg2),
                        *[libs[name] for name in SHIMS]],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"{case} rc={r.returncode}:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.count(f"{case} ok") == 2, r.stdout
    assert f"{case} ok through {libs['port']} {tt.__version__}" in r.stdout
    return {name: np.fromfile(f"{out}.{i}.bin", np.float32).reshape(out_shape)
            for i, name in enumerate(SHIMS)}


def test_embed_mode(libs, c_program, small_tmfile, tmp_path):
    tmfile, x, golden = small_tmfile
    np.ascontiguousarray(x).tofile(tmp_path / "x.bin")
    outs = embed(c_program, libs, "basic", tmfile, tmp_path / "x.bin", golden.shape)
    np.testing.assert_array_equal(outs["port"], golden)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5, atol=1e-6)


def _conv_relu_graph(ir, rng):
    """tests/test_c_api_shim.py:test_embed_mode_extended's graph: a 3x3 conv
    then a ReLu named "act"."""
    g = ir.Graph(name="ck_test")
    xt = g.add_tensor("data", ir.DType.FP32, (1, 3, 8, 8), ir.TensorType.INPUT)
    wdata = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    wt = g.add_tensor("w", ir.DType.FP32, wdata.shape, ir.TensorType.CONST, data=wdata)
    yt = g.add_tensor("conv_out", ir.DType.FP32, [], ir.TensorType.VAR)
    zt = g.add_tensor("act_out", ir.DType.FP32, [], ir.TensorType.VAR)
    inp = g.add_node("InputOp", "input", [], [xt.idx])
    g.add_node("Convolution", "conv", [xt.idx, wt.idx], [yt.idx],
               params=dict(kernel_h=3, kernel_w=3, stride_h=1, stride_w=1,
                           dilation_h=1, dilation_w=1, input_channel=3,
                           output_channel=4, group=1, activation=-1,
                           pad_h0=1, pad_w0=1, pad_h1=1, pad_w1=1))
    g.add_node("ReLu", "act", [yt.idx], [zt.idx], params=dict(negative_slope=0.0))
    g.inputs = [inp.idx]
    g.outputs = [g.nodes[-1].idx]
    return g


def test_embed_mode_extended(libs, c_program, tmp_path):
    """Memory load, node accessors, quant params and the C custom kernel
    (y = 2x in place of the ReLu) through both shims: the same output, 2x
    the port's conv alone."""
    rng = np.random.default_rng(11)
    g = _conv_relu_graph(jir, rng)
    tmfile = tmp_path / "ck.tmfile"
    tmfile.write_bytes(graph_to_tm_bytes(g))
    x = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    x.tofile(tmp_path / "x.bin")
    conv_only = tt.load_tmfile(str(tmfile))
    conv_only.outputs = [conv_only.nodes[1].idx]
    want = 2.0 * tt.compile_graph(conv_only, device="cpu").run(x)[0]
    outs = embed(c_program, libs, "extended", tmfile, tmp_path / "x.bin", want.shape)
    np.testing.assert_array_equal(outs["port"], want)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5, atol=1e-5)


def test_embed_mode_construction(libs, c_program, tmp_path):
    """A conv graph built from C on a context that asks for the CPU: both
    shims, against the port's in-process run of the same graph built in
    Python."""
    rng = np.random.default_rng(21)
    g, w, b = make_conv_graph(in_shape=(1, 3, 8, 8), out_c=4, activation=0, rng=rng)
    x = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    golden = tt.compile_graph(tt.load_tm_bytes(graph_to_tm_bytes(g)), device="cpu").run(x)[0]
    with open(tmp_path / "xwb.bin", "wb") as f:
        for a in (x, w, b):
            f.write(np.ascontiguousarray(a).tobytes())
    outs = embed(c_program, libs, "construction", tmp_path / "xwb.bin", "-", golden.shape)
    np.testing.assert_array_equal(outs["port"], golden)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5, atol=1e-5)


def test_attach_mode_construction(libs):
    """The construction calls through ctypes: an InputOp, a conv's attr."""
    for name in SHIMS:
        lib = attach(libs[name])
        g = lib.create_graph(None, None, None)
        assert g
        node = lib.create_graph_node(g, b"n0", b"InputOp")
        t = lib.create_graph_tensor(g, b"t0", 0)
        assert node and t
        assert lib.set_node_output_tensor(node, 0, t, 3) == 0
        assert lib.set_tensor_shape(t, (I * 4)(1, 3, 4, 4), 4) == 0
        conv = lib.create_graph_node(g, b"c0", b"Convolution")
        assert lib.set_node_attr_int(conv, b"kernel_h", ctypes.byref(I(3))) == 0
    handle = max(h for h, gr in capi_bridge._graphs.items() if getattr(gr, "_constructed", False))
    ir = capi_bridge._graphs[handle].ir
    assert [n.op for n in ir.nodes] == ["InputOp", "Convolution"]
    assert ir.nodes[1].params == {"kernel_h": 3} and ir.tensors[0].shape == [1, 3, 4, 4]


def test_attach_mode_plugin_and_layout(libs, tmp_path, no_default_device):
    """load_tengine_plugin / unload_tengine_plugin (a Python module's init
    and release), set_graph_layout, and set_default_device: the JAX bridge
    takes any name, the port's CPU and CUDA only."""
    import tengine_tpu.api as japi
    import tengine_tpu_torch.api as papi

    plugin = tmp_path / "my_plugin.py"
    plugin.write_text("CALLS = []\n"
                      "def init():\n    CALLS.append('init')\n    return 0\n"
                      "def release():\n    CALLS.append('release')\n    return 0\n")
    for name, api, bridge_graphs in (("jax", japi, None), ("port", papi, capi_bridge._graphs)):
        lib = attach(libs[name])
        assert lib.load_tengine_plugin(b"p1", str(plugin).encode(), b"init") == 0
        assert lib.load_tengine_plugin(b"p1", str(plugin).encode(), b"init") == 0  # idempotent
        assert api._LOADED_PLUGINS["p1"].CALLS == ["init"]
        assert lib.unload_tengine_plugin(b"p1", b"release") == 0
        assert "p1" not in api._LOADED_PLUGINS
        assert lib.unload_tengine_plugin(b"p1", b"release") == -1  # already gone
        g = lib.create_graph(None, None, None)
        assert lib.set_graph_layout(g, 1) == 0
        if bridge_graphs is not None:
            handle = max(h for h, gr in bridge_graphs.items() if getattr(gr, "_constructed", False))
            assert bridge_graphs[handle].options.input_layout == "NHWC"
            assert lib.set_graph_layout(g, 0) == 0
            assert bridge_graphs[handle].options.input_layout == "NCHW"
    jax_lib, port_lib = attach(libs["jax"]), attach(libs["port"])
    assert jax_lib.set_default_device(b"TPU") == 0
    assert port_lib.set_default_device(b"TPU") == -1 and capi_bridge._default_device is None
    assert port_lib.set_default_device(b"CUDA") == 0 and capi_bridge._default_device == "cuda"
    assert port_lib.set_default_device(b"CPU") == 0 and capi_bridge._default_device == "cpu"
    ctx = port_lib.create_context(b"c", 0)
    assert port_lib.set_context_device(ctx, b"TIMVX", None, 0) == -1
    assert capi_bridge._contexts[ctx]["devices"] == ["CUDA"]


def test_prerun_without_a_device_request_or_a_card(libs, small_tmfile, no_default_device,
                                                   capfd):
    """No request, no card: prerun_graph prints resolve_device's message and
    returns -1; a "CPU" context then runs the same file; "TPU" is refused."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the graph would run there")
    tmfile, x, golden = small_tmfile
    lib = attach(libs["port"])
    g = lib.create_graph(None, b"tengine", tmfile.encode())
    assert lib.prerun_graph(g) == -1
    assert "runs on a CUDA device by default" in capfd.readouterr().err
    ctx = lib.create_context(b"cpu", 1)
    assert lib.set_context_device(ctx, b"TPU", None, 0) == -1
    assert lib.set_context_device(ctx, b"CPU", None, 0) == 0
    g = lib.create_graph(ctx, b"tengine", tmfile.encode())
    np.testing.assert_array_equal(np.frombuffer(run_attached(lib, g, x), np.float32),
                                  golden.ravel())


def test_quantized_mobilenet_through_both_shims(libs, no_default_device):
    """A narrow mobilenet-v1 UINT8 (chip_smoke.py's builder on the JAX IR,
    the JAX quantizer, img 32), its tmfile bytes loaded from memory
    ("tengine:m") by both shims at batch 1: within 1 LSB of each other, the
    port's equal to its in-process CompiledGraph at 0 LSB."""
    small = dict(img=32, classes=16,
                 widths=(32, 32, 64, 64, 64, 64, 96, 96, 96, 96, 96, 96, 128, 128))
    x = np.random.default_rng(1).standard_normal((1, 3, 32, 32)).astype(np.float32)
    qg = jax_quantize(build_mobilenet_v1_graph(jir, **small), [x], scheme="uint8",
                      algorithm="minmax")
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = jq.quantize_np(x, t_in.quant, t_in.dtype)
    blob = graph_to_tm_bytes(qg)
    want = tt.compile_graph(tt.load_tm_bytes(blob), device="cpu").run(xq)[0]
    outs = {}
    for name in SHIMS:
        lib = attach(libs[name])
        lib.create_graph.argtypes = [V, S, S, I]  # "tengine:m": the image's address and size
        assert lib.set_default_device(b"CPU") == 0
        g = lib.create_graph(None, b"tengine:m", blob, len(blob))
        outs[name] = np.frombuffer(run_attached(lib, g, xq), np.uint8)
    np.testing.assert_array_equal(outs["port"], want.ravel())
    assert outs["jax"].shape == outs["port"].shape
    d = np.abs(outs["port"].astype(int) - outs["jax"].astype(int))
    assert d.max() <= 1, d.max()


def test_dw_gate_on_a_conv_without_dilation_keys(libs, no_default_device, monkeypatch, capfd):
    """A depthwise INT8 conv built through the C API without dilation keys,
    batch 32, TT_DW_PALLAS=1, on the integer-storage tier: the JAX gate
    (tengine_tpu/ops/quantized.py:_pallas_dw_ok) raises KeyError and its
    prerun or run returns -1; the port's takes the dw route, with the output
    of the same graph with the keys set (0 LSB) and within 1 LSB of the JAX
    engine's on that graph. Read through get_tensor_buffer, the port's
    output has its full size; the JAX bridge's has one byte, the size of the
    output's unset IR shape (its compile infers the shape on a clone of the
    graph; ROADMAP §3), so its value is read on the Python side."""
    import tengine_tpu.capi_bridge as jbridge

    monkeypatch.setenv("TT_DW_PALLAS", "1")
    rng = np.random.default_rng(3)
    n, c, h = 32, 32, 8
    x = rng.integers(-128, 128, (n, c, h, h), dtype=np.int8)
    w = rng.integers(-127, 128, (c, 1, 3, 3), dtype=np.int8)
    b = rng.integers(-500, 500, (c,), dtype=np.int32)
    tensors = {
        "x": (2, [n, c, h, h], 3, None, (0.05, 0)),
        "w": (2, [c, 1, 3, 3], 2, w, (0.02, 0)),
        "b": (4, [c], 2, b, (0.001, 0)),
        "y": (2, [], 1, None, (0.1, 0)),
    }
    attrs = dict(kernel_h=3, kernel_w=3, stride_h=1, stride_w=1, pad_h0=1, pad_h1=1, pad_w0=1,
                 pad_w1=1, group=c, input_channel=c, output_channel=c, activation=-1)
    nodes = [("input", "InputOp", [], ["x"], {}), ("w", "Const", [], ["w"], {}),
             ("b", "Const", [], ["b"], {}), ("dw", "Convolution", ["x", "w", "b"], ["y"], attrs)]
    with_keys = nodes[:3] + [nodes[3][:4] + (dict(attrs, dilation_h=1, dilation_w=1),)]

    def run(name, graph_nodes):
        """(output through get_tensor_buffer, the bridge's own value, the
        kernels), or None where prerun or run fails."""
        lib = attach(libs[name])
        ctx = lib.create_context(b"cpu", 1)
        assert lib.set_context_device(ctx, b"CPU", None, 0) == 0
        g = capi_build_graph(lib, ctx, graph_nodes, tensors)
        graph = (jbridge if name == "jax" else capi_bridge)._graphs[g]
        graph.options = graph.options.__class__(quant_mode="fast", quant_bf16_storage=False)
        t_in = lib.get_graph_input_tensor(g, 0, 0)
        assert lib.set_tensor_buffer(t_in, x.ctypes.data, x.nbytes) == 0
        if lib.prerun_graph(g) != 0 or lib.run_graph(g, 1) != 0:
            return None
        (value,) = graph._outputs_cache.values()
        return (np.frombuffer(read_output(lib, g), np.int8), np.asarray(value),
                getattr(graph._compiled, "kernels", None))

    got, value, kernels = run("port", nodes)
    assert kernels["dw"] == "lower_conv_quant_pallas_dw"
    assert value.shape == (n, c, h, h)
    np.testing.assert_array_equal(got, value.ravel())
    assert run("jax", nodes) is None
    assert "KeyError: 'dilation_h'" in capfd.readouterr().err
    keyed, _, _ = run("port", with_keys)
    np.testing.assert_array_equal(got, keyed)
    jax_read, jax_value, _ = run("jax", with_keys)
    assert jax_read.size == 1 and jax_value.shape == (n, c, h, h)
    assert np.abs(got.astype(int) - jax_value.ravel().astype(int)).max() <= 1


def test_capi_example_program_and_custom_kernel_graph(libs, tmp_path, no_default_device):
    """chip_smoke.py phase 3o at a small size, on the CPU: capi_example.c
    (the embedding program) built against the port's library runs a
    yolov5s-64 INT8 tmfile two images at batch 1, then one batch of 4, with
    "CPU" asked for; every head equals the in-process CompiledGraph's at 0
    LSB. Then chip_smoke's conv -> C custom kernel -> conv graph at
    1x8x16x16 through the construction calls on a "CPU" context, on two
    inputs: 2x between two float64 torch convs within 1e-5."""
    import torch.nn.functional as F

    from chip_smoke import build_c_example, ck_graph_spec, run_ck_graph
    from tengine_tpu_torch.models.yolov5 import build_yolov5s_graph

    x = np.random.default_rng(1).standard_normal((4, 3, 64, 64)).astype(np.float32)
    qg = tt.quantize_graph(build_yolov5s_graph(num_classes=80, img=64)[1], [x[:1]],
                           scheme="int8", algorithm="minmax", device="cpu")
    t_in = qg.tensors[qg.input_tensors[0]]
    xq = tt.ops.qmath.quantize_np(x, t_in.quant, t_in.dtype)
    tmfile = tmp_path / "yolov5s-64.tmfile"
    tt.save_tmfile(qg, str(tmfile))
    xq.tofile(tmp_path / "images.bin")
    shim = Path(libs["port"])
    exe = build_c_example(shim, tmp_path / "capi_example", shared=False)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([str(exe), str(tmfile), str(tmp_path / "images.bin"), "2", "4", "1",
                        str(tmp_path / "heads"), "CPU"],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "capi_example ok" in r.stdout, f"{r.stdout}\n{r.stderr}"
    assert r.stdout.count("run_graph b1 #") == 2 and r.stdout.count("run_graph b4 #") == 1
    cg = tt.compile_graph(tt.load_tmfile(str(tmfile)), device="cpu")
    for b, run, xs in ((1, 0, xq[:1]), (1, 1, xq[1:2]), (4, 0, xq)):
        for k, want in enumerate(cg.run(xs)):
            got = np.fromfile(tmp_path / f"heads_b{b}_r{run}_{k}.bin", want.dtype)
            np.testing.assert_array_equal(got.reshape(want.shape), want)

    lib = attach(shim)
    example = ctypes.CDLL(str(build_c_example(shim, tmp_path / "libcapi_example.so", shared=True)))
    example.example_double_ops.restype = V
    rng = np.random.default_rng(7)
    spec = ck_graph_spec(rng, shape=(1, 8, 16, 16))
    xs = [rng.standard_normal((1, 8, 16, 16)).astype(np.float32) for _ in range(2)]
    ctx = lib.create_context(b"cpu", 1)
    assert lib.set_context_device(ctx, b"CPU", None, 0) == 0
    _, outs = run_ck_graph(lib, ctx, example.example_double_ops(), spec, xs)
    tensors = spec[1]
    for xi, got in zip(xs, outs, strict=True):
        y = torch.from_numpy(xi).double()
        for i in (1, 2):
            w, b = (torch.from_numpy(tensors[f"{p}{i}"][3]).double() for p in "wb")
            y = F.conv2d(y, w, b, padding=1) * (2.0 if i == 1 else 1.0)
        np.testing.assert_allclose(got.reshape(y.shape), y.numpy(), rtol=1e-5, atol=1e-5)


def test_build_capi_goes_to_build_native_and_raises_on_a_failed_build(libs, tmp_path,
                                                                       monkeypatch):
    """The library is build/native/libtengine_tpu_torch_capi-<digest>.so,
    its name a digest of the shim's source and gcc's flags, which link the
    shared libpython here; a source gcc refuses makes build_capi raise with
    gcc's message and leaves no library."""
    path = Path(libs["port"])
    assert path == native.capi_library_path() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libtengine_tpu_torch_capi-")
    assert str(native.shared_libpython()) in native.capi_flags()
    broken = tmp_path / "c_api_shim.c"
    broken.write_text("int init_tengine(void) { return undeclared; }\n")
    monkeypatch.setattr(native, "CAPI_SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.capi_library_path() != path
    with pytest.raises(RuntimeError, match="undeclared"):
        native.build_capi()
    assert not list((tmp_path / "build").glob("*.so"))
