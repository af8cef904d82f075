// Fused quantized stem convolution for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tengine_tpu/ops/pallas/stem_conv.py:
// stem_qconv_packed (_stem_kernel): the first layer of a quantized conv net,
// stride 2, k <= 7, C_in <= 4, k <= 2*pad + 2, NCHW s8/u8 input, NHWC output.
//
//   out = clip(round_half_away(act(acc * M[c] + B[c])) + zp_out, lo, hi)
//   acc = sum (x - c0) * w          (exact int32; w = stored weight - zp_w)
//
// c0 re-centres unsigned input (128) and is 0 for signed input; the host
// folds the constant (c0 - zp_in) * rowsum(w) * M into B exactly as
// pack_stem_weights does on the TPU side, so acc * M + B is the same f32
// expression as the Pallas kernel's and the outputs are the same integers.
// Padding reads zp_in (stored here re-centred, zp_in - c0).
//
// What bounds it: bytes. The yolov5s-640 b8 stem reads 9.8 MB of int8 input
// and writes 26.2 MB of int8 NHWC output for 5.7 G int ops, far below the
// int8 tensor-core rate per byte. This first design is simple rather than
// fast: each block stages one input band (all C_in, re-centred, zero-point
// padded) and the weight matrix in shared memory, each thread accumulates
// CPT channels of one output pixel with int32 multiply-adds, and a warp
// writes 32 neighbouring pixels' channel vectors as 16-byte stores, so the
// output — the bulk of the bytes — leaves in full coalesced lines. The
// multiply-adds, not the bytes, limit it; dp4a or tensor cores would be the
// next step.
//
// The epilogue is f32 without contraction (-fmad=false in the build, and
// explicit __fmul_rn/__fadd_rn): the Pallas epilogue rounds the product
// and the sum separately. round() is C round (half away from zero); SiLU
// uses expf, not __expf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;   // output columns per block (one warp)
constexpr int TILE_H = 8;    // output rows per block
constexpr int CPT = 32;      // output channels per thread (one channel chunk)
constexpr int MAX_C = 4;
constexpr int MAX_K = 7;
constexpr int IN_ROWS = 2 * TILE_H + MAX_K - 1;
constexpr int IN_COLS = 2 * TILE_W + MAX_K - 1;
constexpr int MAX_KK = MAX_C * MAX_K * MAX_K;

enum OutKind { OUT_S8 = 0, OUT_U8 = 1, OUT_F32 = 2 };

__device__ __forceinline__ float epilogue(int acc, float m, float b, int act,
                                          float s_out, float act_lo,
                                          float act_hi, float zp_out,
                                          float lo, float hi) {
  float q = __fadd_rn(__fmul_rn((float)acc, m), b);
  if (act >= 0) {
    if (act == 100) {  // fused SiLU: q * sigmoid(q * s_out)
      float z = __fmul_rn(q, s_out);
      float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
      q = __fmul_rn(q, sig);
    } else if (act == 1) {
      q = fminf(fmaxf(q, act_lo), act_hi);
    } else {
      q = fmaxf(q, 0.0f);
      if (act > 0) q = fminf(q, act_hi);
    }
  }
  float r = __fadd_rn(roundf(q), zp_out);
  return fminf(fmaxf(r, lo), hi);
}

template <bool SIGNED_IN>
__global__ void __launch_bounds__(TILE_W * TILE_H)
stem_qconv_kernel(const uint8_t* __restrict__ x,   // [B, C, H, W] s8/u8
                  const int16_t* __restrict__ w,   // [Cout, C*k*k]
                  const float* __restrict__ mvec,  // [Cout]
                  const float* __restrict__ bvec,  // [Cout]
                  void* __restrict__ out,          // [B, OH, OW, Cout]
                  int C, int H, int W, int Cout, int k, int pad,
                  int act, float s_out, float act_lo, float act_hi,
                  int zp_in, int zp_out, float lo, float hi, int out_kind) {
  // re-centred input fits int16; 12.3 KB + 25 KB stays under the 48 KB of
  // static shared memory a block may use
  __shared__ int16_t s_x[MAX_C][IN_ROWS][IN_COLS];
  __shared__ __align__(16) int s_w[MAX_KK][CPT];  // read as int4 rows

  const int OH = H / 2, OW = W / 2;
  const int n_chunks = (Cout + CPT - 1) / CPT;
  const int b = blockIdx.z / n_chunks;
  const int chunk = blockIdx.z % n_chunks;
  const int oh0 = blockIdx.y * TILE_H, ow0 = blockIdx.x * TILE_W;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int nthreads = TILE_W * TILE_H;
  const int kk = C * k * k;
  const int c0 = SIGNED_IN ? 0 : 128;

  // weights of this channel chunk, [tap][channel], zero beyond Cout
  for (int i = tid; i < kk * CPT; i += nthreads) {
    int tap = i / CPT, j = i % CPT, co = chunk * CPT + j;
    s_w[tap][j] = co < Cout ? (int)w[(size_t)co * kk + tap] : 0;
  }
  // input band, re-centred; outside the image the padding value zp_in
  const int rows = 2 * TILE_H + k - 1, cols = 2 * TILE_W + k - 1;
  const int ih0 = 2 * oh0 - pad, iw0 = 2 * ow0 - pad;
  for (int i = tid; i < C * rows * cols; i += nthreads) {
    int c = i / (rows * cols), r = (i / cols) % rows, col = i % cols;
    int ih = ih0 + r, iw = iw0 + col;
    int v = zp_in;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
      uint8_t raw = x[(((size_t)b * C + c) * H + ih) * W + iw];
      v = SIGNED_IN ? (int)(int8_t)raw : (int)raw;
    }
    s_x[c][r][col] = (int16_t)(v - c0);
  }
  __syncthreads();

  const int oh = oh0 + threadIdx.y, ow = ow0 + threadIdx.x;
  if (oh >= OH || ow >= OW) return;

  int acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0;
  for (int c = 0; c < C; ++c) {
    for (int u = 0; u < k; ++u) {
      const int16_t* xrow = &s_x[c][2 * threadIdx.y + u][2 * threadIdx.x];
      const int tap0 = (c * k + u) * k;
      for (int v = 0; v < k; ++v) {
        const int xv = (int)xrow[v];
        const int4* wr = reinterpret_cast<const int4*>(s_w[tap0 + v]);
#pragma unroll
        for (int j4 = 0; j4 < CPT / 4; ++j4) {
          int4 ww = wr[j4];
          acc[4 * j4 + 0] += xv * ww.x;
          acc[4 * j4 + 1] += xv * ww.y;
          acc[4 * j4 + 2] += xv * ww.z;
          acc[4 * j4 + 3] += xv * ww.w;
        }
      }
    }
  }

  const size_t pix = ((size_t)b * OH + oh) * OW + ow;
  const int cbase = chunk * CPT;
  const float zpo = (float)zp_out;
  if (out_kind == OUT_F32) {
    float* o = reinterpret_cast<float*>(out) + pix * Cout + cbase;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (cbase + j < Cout)
        o[j] = epilogue(acc[j], mvec[cbase + j], bvec[cbase + j], act, s_out,
                        act_lo, act_hi, zpo, lo, hi);
    }
    return;
  }
  uint8_t* o = reinterpret_cast<uint8_t*>(out) + pix * Cout + cbase;
  const bool full = cbase + CPT <= Cout && (Cout % 16) == 0;
  if (full) {
    uint32_t packed[CPT / 4];
#pragma unroll
    for (int j4 = 0; j4 < CPT / 4; ++j4) {
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int j = 4 * j4 + t;
        float r = epilogue(acc[j], mvec[cbase + j], bvec[cbase + j], act,
                           s_out, act_lo, act_hi, zpo, lo, hi);
        uint32_t byte = (uint32_t)((int)r) & 0xFFu;
        word |= byte << (8 * t);
      }
      packed[j4] = word;
    }
    uint4* o4 = reinterpret_cast<uint4*>(o);
#pragma unroll
    for (int q4 = 0; q4 < CPT / 16; ++q4)
      o4[q4] = make_uint4(packed[4 * q4], packed[4 * q4 + 1],
                          packed[4 * q4 + 2], packed[4 * q4 + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (cbase + j < Cout) {
        float r = epilogue(acc[j], mvec[cbase + j], bvec[cbase + j], act,
                           s_out, act_lo, act_hi, zpo, lo, hi);
        o[j] = (uint8_t)((int)r & 0xFF);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes, dtypes, contiguity and alignment.
extern "C" int stem_qconv_launch(const void* x, const void* w,
                                 const void* mvec, const void* bvec, void* out,
                                 int B, int C, int H, int W, int Cout, int k,
                                 int pad, int act, float s_out, float act_lo,
                                 float act_hi, int zp_in, int zp_out, float lo,
                                 float hi, int out_kind, int signed_in,
                                 void* stream) {
  if (C < 1 || C > MAX_C || k < 1 || k > MAX_K || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  const int OH = H / 2, OW = W / 2;
  const int n_chunks = (Cout + CPT - 1) / CPT;
  dim3 block(TILE_W, TILE_H);
  dim3 grid((OW + TILE_W - 1) / TILE_W, (OH + TILE_H - 1) / TILE_H,
            B * n_chunks);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  const int16_t* wb = reinterpret_cast<const int16_t*>(w);
  const float* mb = reinterpret_cast<const float*>(mvec);
  const float* bb = reinterpret_cast<const float*>(bvec);
  if (signed_in)
    stem_qconv_kernel<true><<<grid, block, 0, s>>>(
        xb, wb, mb, bb, out, C, H, W, Cout, k, pad, act, s_out, act_lo, act_hi,
        zp_in, zp_out, lo, hi, out_kind);
  else
    stem_qconv_kernel<false><<<grid, block, 0, s>>>(
        xb, wb, mb, bb, out, C, H, W, Cout, k, pad, act, s_out, act_lo, act_hi,
        zp_in, zp_out, lo, hi, out_kind);
  return (int)cudaGetLastError();
}
