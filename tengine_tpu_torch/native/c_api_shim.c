/* C ABI for tengine_tpu_torch, the PyTorch/CUDA port of tengine_tpu — a
 * drop-in subset of the reference's public embedding surface (c_api.h).
 *
 * The engine itself is Python and torch (the compute path is the port's
 * captured forward on the card, its CUDA kernels and torch's ops); this
 * library embeds CPython (or attaches to an interpreter already running when
 * it is loaded inside a Python process) and forwards every call to
 * tengine_tpu_torch.capi_bridge, which owns all object management. The C
 * layer is a pure marshaller, so the ABI stays small and stable. It is the
 * JAX package's shim (tengine_tpu/native/c_api_shim.c) call for call, with
 * one difference: create_graph forwards its context, whose device request
 * (set_context_device "CPU" or "CUDA") decides where the graph runs.
 *
 * Covered functions (names, signatures and semantics match c_api.h):
 *   init_tengine / release_tengine / get_tengine_version        (c_api.h:318+)
 *   create_graph / destroy_graph                                (c_api.h:363)
 *   prerun_graph / prerun_graph_multithread / run_graph /
 *     postrun_graph                                             (c_api.h:1006-1046)
 *   get_graph_input_node_number / get_graph_output_node_number
 *   get_graph_input_tensor / get_graph_output_tensor /
 *     get_graph_tensor                                          (c_api.h:689-786)
 *   get_tensor_shape / set_tensor_shape                         (c_api.h:793-817)
 *   get_tensor_buffer_size / get_tensor_buffer /
 *     set_tensor_buffer                                         (c_api.h:828-851)
 *   get_tensor_data_type / set_log_level / dump_graph
 *   set/get_tensor_quant_param                                   (c_api.h:924-936)
 *   get_graph_node_num / get_graph_node / get_graph_node_by_idx /
 *     get_node_name / get_node_op / get_node_input_number /
 *     get_node_output_number / get_node_input_tensor /
 *     get_node_output_tensor                                     (c_api.h:487-602)
 *   create_graph(ctx, "tengine:m", addr, size) load-from-memory  (c_api.c:400-421)
 *   set_custom_kernel / remove_custom_kernel                     (c_api.h:742-752)
 *     (the custom_kernel_ops struct is read on the Python side through
 *      ctypes from the pointer forwarded here; on the card its run() is a
 *      host node of the captured forward, csrc/host_node.cu)
 *   graph construction: create_graph(ctx, NULL, NULL) /
 *     create_graph_node / create_graph_tensor /
 *     set_node_input_tensor / set_node_output_tensor /
 *     set_node_attr_int/float + get_ counterparts /
 *     set_graph_input_node / set_graph_output_node /
 *     release_graph_tensor / release_graph_node / wait_graph     (c_api.h:477-602, 766, 1038)
 *   contexts and devices: create_context / destroy_context /
 *     set_context_device / get_context_device_number /
 *     set_default_device                                         (c_api.h:1078, 1120-1186)
 *
 * Build: tengine_tpu_torch/native/__init__.py:build_capi, gcc -shared -fPIC
 * with -lpython3.x where the interpreter has a shared libpython (embed mode:
 * a C program links the library like libtengine-lite.so and the library
 * starts CPython), without it otherwise (attach mode only: the python
 * executable provides the symbols).
 */

#define PY_SSIZE_T_CLEAN /* required for the "y#" byte-buffer format */
#include <Python.h>

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

typedef void* context_t;
typedef void* graph_t;
typedef void* tensor_t;
typedef void* node_t;

struct options {
    int num_thread;
    int cluster;
    int precision;
    uint64_t affinity;
};

static PyObject* g_bridge = NULL;
static int g_we_initialized = 0;

/* tensor handle = (graph_handle << 20) | (tensor_idx + 1), packed in the
 * pointer value; graph handle = small int from the bridge */
#define T_HANDLE(g, t) ((void*)((((uintptr_t)(g)) << 20) | ((uintptr_t)(t) + 1)))
#define T_GRAPH(h) ((long)(((uintptr_t)(h)) >> 20))
#define T_IDX(h) ((long)((((uintptr_t)(h)) & 0xFFFFF) - 1))

static PyObject* bridge_call(const char* fn, const char* fmt, ...)
{
    if (!g_bridge)
        return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    va_list ap;
    va_start(ap, fmt);
    PyObject* args = fmt && *fmt ? Py_VaBuildValue(fmt, ap) : PyTuple_New(0);
    va_end(ap);
    PyObject* ret = NULL;
    if (args) {
        if (!PyTuple_Check(args)) {
            PyObject* t = PyTuple_Pack(1, args);
            Py_DECREF(args);
            args = t;
        }
        PyObject* f = PyObject_GetAttrString(g_bridge, fn);
        if (f) {
            ret = PyObject_CallObject(f, args);
            Py_DECREF(f);
        }
        Py_DECREF(args);
    }
    if (!ret && PyErr_Occurred()) {
        PyErr_Print();
        PyErr_Clear();
    }
    PyGILState_Release(st);
    return ret; /* caller must hold GIL to DECREF — use ret_long/ret helpers */
}

static long ret_long(PyObject* r, long on_err)
{
    if (!r)
        return on_err;
    PyGILState_STATE st = PyGILState_Ensure();
    long v = PyLong_Check(r) ? PyLong_AsLong(r) : on_err;
    Py_DECREF(r);
    PyGILState_Release(st);
    return v;
}

int init_tengine(void)
{
    if (g_bridge)
        return 0;
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_we_initialized = 1;
        /* release the GIL acquired by Py_Initialize so PyGILState works */
        PyEval_SaveThread();
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* mod = PyImport_ImportModule("tengine_tpu_torch.capi_bridge");
    if (!mod) {
        PyErr_Print();
        PyGILState_Release(st);
        return -1;
    }
    g_bridge = mod;
    PyGILState_Release(st);
    return 0;
}

void release_tengine(void)
{
    if (!g_bridge)
        return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_CLEAR(g_bridge);
    PyGILState_Release(st);
    /* when we own the interpreter, leave it up: releasing and re-initializing
     * CPython in-process is unsupported by many extension modules (numpy) */
}

const char* get_tengine_version(void)
{
    static char buf[64] = "";
    PyObject* r = bridge_call("version", "");
    if (r) {
        PyGILState_STATE st = PyGILState_Ensure();
        const char* s = PyUnicode_Check(r) ? PyUnicode_AsUTF8(r) : NULL;
        if (s)
            snprintf(buf, sizeof(buf), "%s", s);
        Py_DECREF(r);
        PyGILState_Release(st);
    }
    return buf;
}

graph_t create_graph(context_t context, const char* model_format, const char* file_name, ...)
{
    long ctx = (long)(uintptr_t)context; /* its device request picks the graph's device */
    if (model_format == NULL) {
        /* create_graph(ctx, NULL, NULL): empty graph for C-side
         * construction (c_api.c:368, tests/op pattern) */
        long h = ret_long(bridge_call("create_graph_empty", "(l)", ctx), 0);
        return (graph_t)(uintptr_t)h;
    }
    /* "<fmt>:m" = load from memory: file_name is the buffer address and one
     * vararg carries the byte size (c_api.c:400-421) */
    const char* colon = model_format ? strchr(model_format, ':') : NULL;
    if (colon && colon[1] == 'm') {
        va_list ap;
        va_start(ap, file_name);
        int size = va_arg(ap, int);
        va_end(ap);
        long h = ret_long(
            bridge_call("create_graph_mem", "(lsy#)", ctx, model_format,
                        (const char*)file_name, (Py_ssize_t)size),
            0);
        return (graph_t)(uintptr_t)h;
    }
    long h = ret_long(bridge_call("create_graph", "(lss)", ctx, model_format, file_name), 0);
    return (graph_t)(uintptr_t)h;
}

int destroy_graph(graph_t graph)
{
    return (int)ret_long(bridge_call("destroy_graph", "(l)", (long)(uintptr_t)graph), -1);
}

int prerun_graph(graph_t graph)
{
    return (int)ret_long(bridge_call("prerun_graph", "(lii)", (long)(uintptr_t)graph, 0, -1), -1);
}

int prerun_graph_multithread(graph_t graph, struct options opt)
{
    return (int)ret_long(
        bridge_call("prerun_graph", "(lii)", (long)(uintptr_t)graph,
                    opt.num_thread, opt.precision),
        -1);
}

int run_graph(graph_t graph, int block)
{
    return (int)ret_long(bridge_call("run_graph", "(li)", (long)(uintptr_t)graph, block), -1);
}

int postrun_graph(graph_t graph)
{
    return (int)ret_long(bridge_call("postrun_graph", "(l)", (long)(uintptr_t)graph), -1);
}

int get_graph_input_node_number(graph_t graph)
{
    return (int)ret_long(bridge_call("input_count", "(l)", (long)(uintptr_t)graph), -1);
}

int get_graph_output_node_number(graph_t graph)
{
    return (int)ret_long(bridge_call("output_count", "(l)", (long)(uintptr_t)graph), -1);
}

tensor_t get_graph_input_tensor(graph_t graph, int node_idx, int tensor_idx)
{
    long t = ret_long(
        bridge_call("input_tensor_idx", "(lii)", (long)(uintptr_t)graph, node_idx, tensor_idx),
        -1);
    return t < 0 ? NULL : T_HANDLE((uintptr_t)graph, t);
}

tensor_t get_graph_output_tensor(graph_t graph, int node_idx, int tensor_idx)
{
    long t = ret_long(
        bridge_call("output_tensor_idx", "(lii)", (long)(uintptr_t)graph, node_idx, tensor_idx),
        -1);
    return t < 0 ? NULL : T_HANDLE((uintptr_t)graph, t);
}

tensor_t get_graph_tensor(graph_t graph, const char* tensor_name)
{
    long t = ret_long(
        bridge_call("tensor_idx_by_name", "(ls)", (long)(uintptr_t)graph, tensor_name), -1);
    return t < 0 ? NULL : T_HANDLE((uintptr_t)graph, t);
}

int get_tensor_shape(tensor_t tensor, int dims[], int dim_number)
{
    PyObject* r = bridge_call("tensor_shape", "(ll)", T_GRAPH(tensor), T_IDX(tensor));
    if (!r)
        return -1;
    PyGILState_STATE st = PyGILState_Ensure();
    int n = -1;
    if (PyList_Check(r)) {
        n = (int)PyList_Size(r);
        for (int i = 0; i < n && i < dim_number; i++)
            dims[i] = (int)PyLong_AsLong(PyList_GetItem(r, i));
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return n;
}

int set_tensor_shape(tensor_t tensor, const int dims[], int dim_number)
{
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* lst = PyList_New(dim_number);
    for (int i = 0; i < dim_number; i++)
        PyList_SetItem(lst, i, PyLong_FromLong(dims[i]));
    PyGILState_Release(st);
    PyObject* r = bridge_call("set_tensor_shape", "(llO)", T_GRAPH(tensor), T_IDX(tensor), lst);
    st = PyGILState_Ensure();
    Py_DECREF(lst);
    PyGILState_Release(st);
    return (int)ret_long(r, -1);
}

int get_tensor_buffer_size(tensor_t tensor)
{
    return (int)ret_long(
        bridge_call("tensor_buffer_size", "(ll)", T_GRAPH(tensor), T_IDX(tensor)), -1);
}

void* get_tensor_buffer(tensor_t tensor)
{
    long addr = ret_long(
        bridge_call("get_tensor_buffer", "(ll)", T_GRAPH(tensor), T_IDX(tensor)), 0);
    return (void*)(uintptr_t)addr;
}

int set_tensor_buffer(tensor_t tensor, void* buffer, int buffer_size)
{
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* mv = PyMemoryView_FromMemory((char*)buffer, buffer_size, PyBUF_READ);
    PyGILState_Release(st);
    if (!mv)
        return -1;
    PyObject* r = bridge_call("set_tensor_buffer", "(llO)", T_GRAPH(tensor), T_IDX(tensor), mv);
    st = PyGILState_Ensure();
    Py_DECREF(mv);
    PyGILState_Release(st);
    return (int)ret_long(r, -1);
}

int get_tensor_data_type(tensor_t tensor)
{
    return (int)ret_long(
        bridge_call("tensor_dtype", "(ll)", T_GRAPH(tensor), T_IDX(tensor)), -1);
}

int set_log_level(int level)
{
    return (int)ret_long(bridge_call("set_log_level", "(i)", level), -1);
}

int dump_graph(graph_t graph)
{
    return (int)ret_long(bridge_call("dump_graph", "(l)", (long)(uintptr_t)graph), -1);
}

/* ---- tensor quant params (c_api.h:924-936) ---- */

int set_tensor_quant_param(tensor_t tensor, const float* scale, const int* zero_point, int number)
{
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* ls = PyList_New(number);
    PyObject* lz = PyList_New(number);
    for (int i = 0; i < number; i++) {
        PyList_SetItem(ls, i, PyFloat_FromDouble(scale[i]));
        PyList_SetItem(lz, i, PyLong_FromLong(zero_point[i]));
    }
    PyGILState_Release(st);
    PyObject* r = bridge_call("set_tensor_quant_param", "(llOO)", T_GRAPH(tensor),
                              T_IDX(tensor), ls, lz);
    st = PyGILState_Ensure();
    Py_DECREF(ls);
    Py_DECREF(lz);
    PyGILState_Release(st);
    return (int)ret_long(r, -1);
}

int get_tensor_quant_param(tensor_t tensor, float* scale, int* zero_point, int number)
{
    PyObject* r = bridge_call("get_tensor_quant_param", "(lli)", T_GRAPH(tensor),
                              T_IDX(tensor), number);
    if (!r)
        return -1;
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    if (PyTuple_Check(r) && PyTuple_Size(r) == 2) {
        PyObject* ls = PyTuple_GetItem(r, 0);
        PyObject* lz = PyTuple_GetItem(r, 1);
        int n = (int)PyList_Size(ls);
        for (int i = 0; i < n && i < number; i++) {
            scale[i] = (float)PyFloat_AsDouble(PyList_GetItem(ls, i));
            zero_point[i] = (int)PyLong_AsLong(PyList_GetItem(lz, i));
        }
        rc = 0;
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return rc;
}

/* ---- node accessors (c_api.h:487-602); node handles pack like tensors ---- */

int get_graph_node_num(graph_t graph)
{
    return (int)ret_long(bridge_call("node_num", "(l)", (long)(uintptr_t)graph), -1);
}

node_t get_graph_node_by_idx(graph_t graph, int idx)
{
    long n = ret_long(bridge_call("node_check", "(li)", (long)(uintptr_t)graph, idx), -1);
    return n < 0 ? NULL : T_HANDLE((uintptr_t)graph, n);
}

node_t get_graph_node(graph_t graph, const char* node_name)
{
    long n = ret_long(
        bridge_call("node_idx_by_name", "(ls)", (long)(uintptr_t)graph, node_name), -1);
    return n < 0 ? NULL : T_HANDLE((uintptr_t)graph, n);
}

/* name/op return pointers into a small ring of static buffers, valid until
 * 8 further calls — same informal lifetime class as the reference's
 * pointers into IR memory */
static const char* str_ring(PyObject* r)
{
    static char bufs[8][256];
    static int slot = 0;
    if (!r)
        return NULL;
    PyGILState_STATE st = PyGILState_Ensure();
    const char* s = PyUnicode_Check(r) ? PyUnicode_AsUTF8(r) : NULL;
    char* out = NULL;
    if (s) {
        out = bufs[slot = (slot + 1) % 8];
        snprintf(out, sizeof(bufs[0]), "%s", s);
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return out;
}

const char* get_node_name(node_t node)
{
    return str_ring(bridge_call("node_name", "(ll)", T_GRAPH(node), T_IDX(node)));
}

const char* get_node_op(node_t node)
{
    return str_ring(bridge_call("node_op", "(ll)", T_GRAPH(node), T_IDX(node)));
}

int get_node_input_number(node_t node)
{
    return (int)ret_long(bridge_call("node_input_count", "(ll)", T_GRAPH(node), T_IDX(node)), -1);
}

int get_node_output_number(node_t node)
{
    return (int)ret_long(bridge_call("node_output_count", "(ll)", T_GRAPH(node), T_IDX(node)), -1);
}

tensor_t get_node_input_tensor(node_t node, int input_idx)
{
    long t = ret_long(
        bridge_call("node_input_tensor_idx", "(lli)", T_GRAPH(node), T_IDX(node), input_idx), -1);
    return t < 0 ? NULL : T_HANDLE((uintptr_t)T_GRAPH(node), t);
}

tensor_t get_node_output_tensor(node_t node, int output_idx)
{
    long t = ret_long(
        bridge_call("node_output_tensor_idx", "(lli)", T_GRAPH(node), T_IDX(node), output_idx), -1);
    return t < 0 ? NULL : T_HANDLE((uintptr_t)T_GRAPH(node), t);
}

/* ---- custom kernels (c_api.h:183-309, :742-752) ----
 * The struct pointer is forwarded as an integer; capi_bridge reads it with
 * ctypes and runs ops->run in the forward: directly on the CPU, as a host
 * node of the captured CUDA graph on the card. */

int set_custom_kernel(node_t node, const char* dev_name, void* kernel_ops)
{
    return (int)ret_long(
        bridge_call("set_custom_kernel", "(llsl)", T_GRAPH(node), T_IDX(node),
                    dev_name ? dev_name : "", (long)(uintptr_t)kernel_ops),
        -1);
}

int remove_custom_kernel(node_t node, const char* dev_name)
{
    return (int)ret_long(
        bridge_call("remove_custom_kernel", "(lls)", T_GRAPH(node), T_IDX(node),
                    dev_name ? dev_name : ""),
        -1);
}

/* ---- graph construction from C (c_api.h:477-520, 560-602, 766) ----
 * The reference's op unit tests build graphs through this tier
 * (tests/op/test_onnx_op.h): empty graph + InputOp/Const/op nodes, tensors
 * wired by index, attrs by name, then the normal prerun/run path. */

node_t create_graph_node(graph_t graph, const char* node_name, const char* op_name)
{
    long n = ret_long(
        bridge_call("create_graph_node", "(lss)", (long)(uintptr_t)graph,
                    node_name, op_name),
        -1);
    return n < 0 ? NULL : T_HANDLE((uintptr_t)graph, n);
}

tensor_t create_graph_tensor(graph_t graph, const char* tensor_name, int data_type)
{
    long t = ret_long(
        bridge_call("create_graph_tensor", "(lsi)", (long)(uintptr_t)graph,
                    tensor_name, data_type),
        -1);
    return t < 0 ? NULL : T_HANDLE((uintptr_t)graph, t);
}

int set_node_input_tensor(node_t node, int input_idx, tensor_t tensor)
{
    return (int)ret_long(
        bridge_call("set_node_input_tensor", "(llil)", T_GRAPH(node),
                    T_IDX(node), input_idx, T_IDX(tensor)),
        -1);
}

int set_node_output_tensor(node_t node, int output_idx, tensor_t tensor, int tensor_type)
{
    return (int)ret_long(
        bridge_call("set_node_output_tensor", "(llili)", T_GRAPH(node),
                    T_IDX(node), output_idx, T_IDX(tensor), tensor_type),
        -1);
}

/* node attrs map to op params by name (set_node_attr_int, c_api.h:686) */
int set_node_attr_int(node_t node, const char* attr_name, const int* attr_val)
{
    return (int)ret_long(
        bridge_call("set_node_attr", "(llsii)", T_GRAPH(node), T_IDX(node),
                    attr_name, *attr_val, 1),
        -1);
}

int set_node_attr_float(node_t node, const char* attr_name, const float* attr_val)
{
    return (int)ret_long(
        bridge_call("set_node_attr", "(llsfi)", T_GRAPH(node), T_IDX(node),
                    attr_name, (double)*attr_val, 0),
        -1);
}

int get_node_attr_int(node_t node, const char* attr_name, int* attr_val)
{
    PyObject* r = bridge_call("get_node_attr", "(lls)", T_GRAPH(node), T_IDX(node), attr_name);
    if (!r)
        return -1;
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    if (PyLong_Check(r)) {
        *attr_val = (int)PyLong_AsLong(r);
        rc = 0;
    } else if (PyFloat_Check(r)) {
        *attr_val = (int)PyFloat_AsDouble(r);
        rc = 0;
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return rc;
}

int get_node_attr_float(node_t node, const char* attr_name, float* attr_val)
{
    PyObject* r = bridge_call("get_node_attr", "(lls)", T_GRAPH(node), T_IDX(node), attr_name);
    if (!r)
        return -1;
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = -1;
    if (PyFloat_Check(r) || PyLong_Check(r)) {
        *attr_val = (float)PyFloat_AsDouble(r);
        rc = 0;
    }
    Py_DECREF(r);
    PyGILState_Release(st);
    return rc;
}

static PyObject* name_list(const char* names[], int number)
{
    PyObject* lst = PyList_New(number);
    for (int i = 0; i < number; i++)
        PyList_SetItem(lst, i, PyUnicode_FromString(names[i]));
    return lst;
}

int set_graph_input_node(graph_t graph, const char* input_nodes[], int input_number)
{
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* lst = name_list(input_nodes, input_number);
    PyGILState_Release(st);
    PyObject* r = bridge_call("set_graph_io_nodes", "(lOO)", (long)(uintptr_t)graph, lst, Py_None);
    st = PyGILState_Ensure();
    Py_DECREF(lst);
    PyGILState_Release(st);
    return (int)ret_long(r, -1);
}

int set_graph_output_node(graph_t graph, const char* output_nodes[], int output_number)
{
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject* lst = name_list(output_nodes, output_number);
    PyGILState_Release(st);
    PyObject* r = bridge_call("set_graph_io_nodes", "(lOO)", (long)(uintptr_t)graph, Py_None, lst);
    st = PyGILState_Ensure();
    Py_DECREF(lst);
    PyGILState_Release(st);
    return (int)ret_long(r, -1);
}

int wait_graph(graph_t graph, int try_wait)
{
    return (int)ret_long(
        bridge_call("wait_graph", "(li)", (long)(uintptr_t)graph, try_wait), -1);
}

/* the reference refcounts these handles; ours are plain (graph, idx) packs
 * owned by the IR, so release is a no-op — same as its exit path */
void release_graph_tensor(tensor_t tensor) { (void)tensor; }
void release_graph_node(node_t node) { (void)node; }

/* ---- contexts / devices (c_api.h:1120-1186) ---- */

context_t create_context(const char* context_name, int empty_context)
{
    long h = ret_long(
        bridge_call("create_context", "(si)", context_name ? context_name : "",
                    empty_context),
        0);
    return (context_t)(uintptr_t)h;
}

void destroy_context(context_t context)
{
    PyObject* r = bridge_call("destroy_context", "(l)", (long)(uintptr_t)context);
    if (r) {
        PyGILState_STATE st = PyGILState_Ensure();
        Py_DECREF(r);
        PyGILState_Release(st);
    }
}

int set_context_device(context_t context, const char* dev_name, const void* dev_option, size_t dev_opt_size)
{
    (void)dev_option;
    (void)dev_opt_size; /* device options are not read: the name picks the device */
    return (int)ret_long(
        bridge_call("set_context_device", "(ls)", (long)(uintptr_t)context,
                    dev_name ? dev_name : ""),
        -1);
}

int get_context_device_number(context_t context)
{
    return (int)ret_long(
        bridge_call("get_context_device_number", "(l)", (long)(uintptr_t)context), -1);
}

/* ---- plugins / layout / default device (c_api.h:374, 1078, 1259-1270) ---- */

int load_tengine_plugin(const char* plugin_name, const char* file_name, const char* init_func_name)
{
    return (int)ret_long(
        bridge_call("load_plugin", "(sss)", plugin_name ? plugin_name : "",
                    file_name ? file_name : "",
                    init_func_name ? init_func_name : ""),
        -1);
}

int unload_tengine_plugin(const char* plugin_name, const char* rel_func_name)
{
    return (int)ret_long(
        bridge_call("unload_plugin", "(ss)", plugin_name ? plugin_name : "",
                    rel_func_name ? rel_func_name : ""),
        -1);
}

int set_graph_layout(graph_t graph, int layout_type)
{
    return (int)ret_long(
        bridge_call("set_graph_layout", "(li)", (long)(uintptr_t)graph, layout_type),
        -1);
}

int set_default_device(const char* device)
{
    return (int)ret_long(
        bridge_call("set_default_device", "(s)", device ? device : ""), -1);
}
