/* A C program that embeds tengine_tpu_torch through its C ABI
 * (c_api_shim.c), as Tengine's examples embed libtengine-lite.so; and a C
 * custom kernel (y = 2 * x) for graphs built through the C API.
 *
 * Build, with the library native/__init__.py:build_capi gives:
 *
 *   gcc -O2 capi_example.c <libtengine_tpu_torch_capi-....so> \
 *       -Wl,-rpath,<its directory> -o capi_example
 *
 * and run with PYTHONPATH naming the repository and the site-packages that
 * hold torch (an embedded interpreter does not see a virtual environment's):
 *
 *   capi_example <model.tmfile> <images.bin> <b1 runs> <batch> <batched runs> <out prefix> [device]
 *
 * images.bin holds <batch> images in the model input's dtype and shape.
 * Without [device] the program asks for no device, so the graph runs on the
 * card; with one (CPU or CUDA) it asks set_default_device for it. It runs images
 * 0 .. <b1 runs>-1 at batch 1, one a run_graph call (Tengine's yolov5s
 * example runs one image), then sets the input to <batch> and runs the whole
 * file <batched runs> times. It writes output k of run r at batch N to
 * <out prefix>_b<N>_r<r>_<k>.bin and prints the host time of each run_graph
 * call (clock_gettime; the outputs' download included).
 *
 * Built as a shared library (-shared -fPIC), it gives example_double_ops():
 * the custom_kernel_ops of the y = 2 * x kernel, for set_custom_kernel.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

typedef void* context_t;
typedef void* graph_t;
typedef void* tensor_t;

#define MAX_SHAPE_DIM_NUM 8

struct custom_kernel_tensor {
    int dim[MAX_SHAPE_DIM_NUM];
    int dim_num;
    int element_num;
    int element_size;
    int data_type;
    int dev_type;
    int layout_type;
    int quant_type;
    float* scale;
    int* zero_point;
    int* quant_number;
    void* data;
    void* dev_mem;
    void* mapped_mem;
};

struct custom_kernel_ops {
    const char* kernel_name;
    const char* op;
    int force;
    void* kernel_param;
    int kernel_param_size;
    int (*infer_shape)(struct custom_kernel_ops*, const int*[], int, int*[], int, int);
    int (*inplace_info)(struct custom_kernel_ops*, int);
    int (*bind)(void);
    int (*prerun)(void);
    int (*reshape)(void);
    int (*run)(struct custom_kernel_ops*, struct custom_kernel_tensor*[], int,
               struct custom_kernel_tensor*[], int);
    int (*postrun)(void);
    void (*release)(struct custom_kernel_ops*);
};

extern int init_tengine(void);
extern void release_tengine(void);
extern const char* get_tengine_version(void);
extern graph_t create_graph(context_t, const char*, const char*, ...);
extern int prerun_graph(graph_t);
extern int run_graph(graph_t, int);
extern int destroy_graph(graph_t);
extern tensor_t get_graph_input_tensor(graph_t, int, int);
extern tensor_t get_graph_output_tensor(graph_t, int, int);
extern int get_graph_output_node_number(graph_t);
extern int get_tensor_shape(tensor_t, int*, int);
extern int set_tensor_shape(tensor_t, const int*, int);
extern int get_tensor_buffer_size(tensor_t);
extern void* get_tensor_buffer(tensor_t);
extern int set_tensor_buffer(tensor_t, void*, int);
extern int set_default_device(const char*);

/* the custom kernel: y = 2 * x, float */
static int double_run(struct custom_kernel_ops* ops, struct custom_kernel_tensor* in[],
                      int in_num, struct custom_kernel_tensor* out[], int out_num)
{
    (void)ops;
    (void)in_num;
    (void)out_num;
    const float* x = (const float*)in[0]->data;
    float* y = (float*)out[0]->data;
    for (int i = 0; i < out[0]->element_num; i++)
        y[i] = 2.0f * x[i];
    return 0;
}

static struct custom_kernel_ops double_ops = {
    .kernel_name = "double", .op = "ReLu", .run = double_run,
};

struct custom_kernel_ops* example_double_ops(void) { return &double_ops; }

static double now_ms(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

/* run_graph once, timed; the outputs' download happens inside it */
static int timed_run(graph_t g, const char* what, int i)
{
    double t0 = now_ms();
    int rc = run_graph(g, 1);
    double ms = now_ms() - t0;
    printf("run_graph %s #%d: %.3f ms\n", what, i, ms);
    fflush(stdout);
    return rc;
}

static int write_outputs(graph_t g, const char* prefix, int batch, int run)
{
    int n = get_graph_output_node_number(g);
    for (int k = 0; k < n; k++) {
        tensor_t t = get_graph_output_tensor(g, k, 0);
        int nbytes = get_tensor_buffer_size(t);
        void* p = get_tensor_buffer(t);
        if (!t || nbytes <= 0 || !p)
            return -1;
        char path[4096];
        snprintf(path, sizeof(path), "%s_b%d_r%d_%d.bin", prefix, batch, run, k);
        FILE* f = fopen(path, "wb");
        if (!f || fwrite(p, 1, (size_t)nbytes, f) != (size_t)nbytes)
            return -1;
        fclose(f);
    }
    return n;
}

int main(int argc, char** argv)
{
    if (argc != 7 && argc != 8) {
        fprintf(stderr,
                "usage: %s model.tmfile images.bin b1_runs batch batched_runs out_prefix [device]\n",
                argv[0]);
        return 2;
    }
    const int b1_runs = atoi(argv[3]), batch = atoi(argv[4]), batched_runs = atoi(argv[5]);
    if (init_tengine() != 0) {
        fprintf(stderr, "init_tengine failed\n");
        return 3;
    }
    printf("tengine_tpu_torch %s\n", get_tengine_version());
    if (argc == 8 && set_default_device(argv[7]) != 0) {
        fprintf(stderr, "set_default_device(\"%s\") failed\n", argv[7]);
        return 3;
    }
    graph_t g = create_graph(NULL, "tengine", argv[1]);
    if (!g) {
        fprintf(stderr, "create_graph failed\n");
        return 4;
    }
    tensor_t tin = get_graph_input_tensor(g, 0, 0);
    int dims[4];
    if (get_tensor_shape(tin, dims, 4) != 4) {
        fprintf(stderr, "the input is not 4-D\n");
        return 5;
    }
    const int image_bytes = get_tensor_buffer_size(tin) / dims[0];
    char* images = (char*)malloc((size_t)image_bytes * batch);
    FILE* f = fopen(argv[2], "rb");
    if (!images || !f || fread(images, (size_t)image_bytes, (size_t)batch, f) != (size_t)batch) {
        fprintf(stderr, "could not read %d images of %d bytes from %s\n", batch, image_bytes,
                argv[2]);
        return 6;
    }
    fclose(f);

    dims[0] = 1;
    if (set_tensor_shape(tin, dims, 4) != 0 || prerun_graph(g) != 0) {
        fprintf(stderr, "prerun_graph at batch 1 failed\n");
        return 7;
    }
    for (int i = 0; i < b1_runs; i++) {
        if (set_tensor_buffer(tin, images + (size_t)i * image_bytes, image_bytes) != 0 ||
            timed_run(g, "b1", i) != 0 || write_outputs(g, argv[6], 1, i) < 0) {
            fprintf(stderr, "run %d at batch 1 failed\n", i);
            return 8;
        }
    }

    dims[0] = batch;
    if (set_tensor_shape(tin, dims, 4) != 0 || prerun_graph(g) != 0) {
        fprintf(stderr, "prerun_graph at batch %d failed\n", batch);
        return 10;
    }
    char what[32];
    snprintf(what, sizeof(what), "b%d", batch);
    for (int i = 0; i < batched_runs; i++) {
        if (set_tensor_buffer(tin, images, image_bytes * batch) != 0 || timed_run(g, what, i) != 0 ||
            write_outputs(g, argv[6], batch, i) < 0) {
            fprintf(stderr, "run %d at batch %d failed\n", i, batch);
            return 11;
        }
    }
    destroy_graph(g);
    free(images);
    release_tengine();
    printf("capi_example ok\n");
    return 0;
}
