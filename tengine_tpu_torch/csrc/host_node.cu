// A C custom kernel as a host node of the captured forward.
//
// Replaces no TPU kernel. The C ABI's set_custom_kernel (c_api.h:742) hands
// the engine an embedder's struct custom_kernel_ops, whose run() is a C
// function over host buffers. The JAX package runs it as a
// jax.pure_callback inside the jitted program (tengine_tpu/capi_bridge.py:
// _lower_custom_kernel). The port's forward on the card is captured into a
// CUDA graph and replayed without Python, so run() becomes three operations
// on the forward's stream, all recorded into the graph:
//
//   1. an async copy of each input from the card into a page-locked staging
//      buffer;
//   2. cudaLaunchHostFunc of host_node_fn, which calls ops->run() over
//      struct custom_kernel_tensor views of those buffers;
//   3. an async copy of each output's staging buffer back to the card.
//
// CUDA calls a host function on a thread of its own. host_node_fn is plain
// C and needs no Python: a ctypes callback there would need the GIL, which
// the thread that replays the graph may hold. The staging buffers and the
// views are allocated once, before the capture (ops/cuda/host_node.py), and
// outlive every replay of the graph; only the device pointers, which the
// capture fixes, come with each launch.
//
// What bounds it: the link and the host. The copies cross PCIe twice (each
// input read once, each output written once at ~50 GB/s pinned), and the
// stream waits for run() on the host in between; the card idles meanwhile.

#include <cuda_runtime.h>

typedef int (*ck_run_fn)(void* ops, void** ins, int in_num, void** outs, int out_num);

// One node's staging, as ops/cuda/host_node.py:HostNode mirrors it field for
// field. ins/outs are arrays of struct custom_kernel_tensor* whose data
// fields point into h_in/h_out.
struct HostNode {
  void* ops;
  ck_run_fn run;
  void** ins;
  void** outs;
  void** h_in;
  void** h_out;
  const long long* in_bytes;
  const long long* out_bytes;
  int n_in;
  int n_out;
  int rc;     // run()'s return code at its last call
  int calls;  // run() calls so far (warm-up, eager forwards, replays)
};

static void CUDART_CB host_node_fn(void* user) {
  HostNode* n = static_cast<HostNode*>(user);
  n->rc = n->run(n->ops, n->ins, n->n_in, n->outs, n->n_out);
  n->calls += 1;
}

// Record the node's copies and its host function on `stream` (captured or
// not): d_in[i] -> h_in[i], run(), h_out[j] -> d_out[j]. Returns the first
// CUDA error, 0 on success.
extern "C" int tt_host_node_launch(HostNode* node, void* const* d_in, void* const* d_out,
                                   void* stream) {
  if (node == nullptr || node->run == nullptr || node->n_in < 0 || node->n_out < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < node->n_in && err == cudaSuccess; ++i)
    err = cudaMemcpyAsync(node->h_in[i], d_in[i], (size_t)node->in_bytes[i],
                          cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaLaunchHostFunc(s, host_node_fn, node);
  for (int j = 0; j < node->n_out && err == cudaSuccess; ++j)
    err = cudaMemcpyAsync(d_out[j], node->h_out[j], (size_t)node->out_bytes[j],
                          cudaMemcpyHostToDevice, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// sizeof(HostNode), which the Python mirror is held to.
extern "C" int tt_host_node_size(void) { return (int)sizeof(HostNode); }
