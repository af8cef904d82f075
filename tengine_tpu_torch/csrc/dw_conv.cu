// Quantized depthwise k×k convolution with fused requantization, for Hopper
// (sm_90a). Replaces the Pallas TPU kernel
//
//   tengine_tpu/ops/pallas/dw_conv.py: dw_qconv_hwcn (_dw_kernel)
//
//   acc[p,c] = sum_{ky,kx} x[p*s - pad + (ky,kx), c] * w[ky*k+kx, c]   exact int32
//   q        = float(acc) * M[c] + B[c]                two f32 roundings
//   q        = activation clamp around 0 (requant domain): -1 none, 0 relu,
//              1 clip to +-1/s_out, n > 1 relu-n
//   out      = clip(roundf(q) + zp_out, lo, hi)        half away from zero
//
// x holds the raw stored values (int8, or uint8 0..255); taps outside the
// image read the input zero-point zp_in, and the caller folds the constant
// -zp_in * colsum(w) * M into B. w holds the true tap values w_q - zp_w as
// int16 (up to +-255 on a uint8 graph). B does not carry zp_out: it is added
// after the round. |acc| <= 25 * 255 * 255 < 2^24, so int32 sums and their
// conversion to f32 are exact, as the TPU kernel's f32 sums are.
//
// What bounds it on this card: bytes. The largest launch of YOLO-Fastest-320
// at batch 32 (160x160x32, stride 1) reads 26.2 MB and writes as many for
// 236 M multiply-adds: 0.016 ms of HBM traffic at 3.35 TB/s. There is no
// tensor-core mapping (nothing is summed across channels), so the
// multiply-adds run on the CUDA cores as int32 IMADs, about as long again at
// 64 a clock and SM, plus the byte unpacking. What the design does about it:
// the kernel reads NHWC bytes and writes NHWC bytes, once each from device
// memory. A thread owns 4 neighbouring channels (one 32-bit word) of
// TW = 4 neighbouring output columns of one output row: it loads each input
// row of its window once as (TW-1)*s + k words and reuses the overlapping
// columns from registers; neighbouring threads hold neighbouring channel
// words, so a warp's loads and stores fill whole 32-byte sectors, and the
// k/s-fold reuse of input rows between neighbouring output rows lands in
// L1/L2. The taps of the thread's 4 channels stay in registers. None of the
// TPU kernel's machinery carries over: the [H, W, C, N] batch-in-lanes
// layout and its two transposes, the halo DMA with its carry between
// sequential grid steps, the f32 row window and the VMEM row bands (and
// with them the limits on C, N and the bottom pad). Shared-memory tiles with
// halos, cp.async or TMA are the next step if the L1/L2 reuse falls short.
//
// The epilogue is f32 without contraction (--fmad=false in the build, and
// explicit __fmul_rn/__fadd_rn); the clamp thresholds arrive as f32 values
// that the host computed in double.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by DwArgs in ops/cuda/dw_conv.py (ctypes).
struct DwArgs {
  const void* x;       // [N, H, W, C] int8/uint8, NHWC contiguous
  const int16_t* w;    // [k*k, cp] true tap values, zero beyond C
  const float* mult;   // [C]
  const float* bias;   // [C]
  void* out;           // [N, OH, OW, C] int8/uint8
  int n, h, w_in, c;
  int oh, ow;
  int cp;              // tap row stride: C rounded up to a multiple of 4
  int k, stride, pad_t, pad_l;
  int zp_in, act, x_u8;
  float act_lo, act_hi, zp_out, lo, hi;
};

namespace {

constexpr int THREADS = 256;
constexpr int TW = 4;  // output columns per thread
constexpr int CV = 4;  // channels per thread: one 32-bit word

template <bool U8>
__device__ __forceinline__ int byte_of(uint32_t word, int b) {
  const uint32_t v = (word >> (8 * b)) & 0xFFu;
  return U8 ? (int)v : (int)(int8_t)v;
}

template <int K, int S, bool U8, bool VEC>
__global__ void __launch_bounds__(THREADS) dw_qconv_kernel(const DwArgs a, unsigned items,
                                                           unsigned wtiles, unsigned cwords) {
  const unsigned idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= items) return;
  // channel word fastest, then the column tile, the output row, the image
  const int cwi = (int)(idx % cwords);
  unsigned t = idx / cwords;
  const int wt = (int)(t % wtiles);
  t /= wtiles;
  const int oy = (int)(t % (unsigned)a.oh);
  const int img = (int)(t / (unsigned)a.oh);
  const int c0 = cwi * CV;
  const int ox0 = wt * TW;

  // the taps of this thread's channels: rows of w are padded to cp, so the
  // 8-byte load is aligned and in range for a ragged C too
  int tap[K * K][CV];
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    const uint2 q = *reinterpret_cast<const uint2*>(a.w + (size_t)i * a.cp + c0);
    tap[i][0] = (int)(int16_t)(q.x & 0xFFFFu);
    tap[i][1] = (int)(int16_t)(q.x >> 16);
    tap[i][2] = (int)(int16_t)(q.y & 0xFFFFu);
    tap[i][3] = (int)(int16_t)(q.y >> 16);
  }

  int acc[TW][CV];
#pragma unroll
  for (int o = 0; o < TW; ++o)
#pragma unroll
    for (int b = 0; b < CV; ++b) acc[o][b] = 0;

  constexpr int COLS = (TW - 1) * S + K;
  const int iy0 = oy * S - a.pad_t, ix0 = ox0 * S - a.pad_l;
  const uint8_t* xb = static_cast<const uint8_t*>(a.x) + (size_t)img * a.h * a.w_in * a.c;

#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int iy = iy0 + r;
    const bool row_ok = iy >= 0 && iy < a.h;
    int v[COLS][CV];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int ix = ix0 + j;
      if (row_ok && ix >= 0 && ix < a.w_in) {
        const uint8_t* p = xb + ((size_t)iy * a.w_in + ix) * a.c + c0;
        if (VEC) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
          for (int b = 0; b < CV; ++b) v[j][b] = byte_of<U8>(word, b);
        } else {
#pragma unroll
          for (int b = 0; b < CV; ++b)
            v[j][b] = (c0 + b < a.c) ? byte_of<U8>((uint32_t)p[b], 0) : 0;
        }
      } else {
        // outside the image: the input zero-point, the conv's zero
#pragma unroll
        for (int b = 0; b < CV; ++b) v[j][b] = a.zp_in;
      }
    }
#pragma unroll
    for (int o = 0; o < TW; ++o)
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
#pragma unroll
        for (int b = 0; b < CV; ++b) acc[o][b] += v[o * S + kx][b] * tap[r * K + kx][b];
  }

  float m[CV], bz[CV];
#pragma unroll
  for (int b = 0; b < CV; ++b) {
    const bool ok = c0 + b < a.c;
    m[b] = ok ? a.mult[c0 + b] : 0.0f;
    bz[b] = ok ? a.bias[c0 + b] : 0.0f;
  }
  uint8_t* orow =
      static_cast<uint8_t*>(a.out) + (((size_t)img * a.oh + oy) * a.ow) * a.c + c0;
#pragma unroll
  for (int o = 0; o < TW; ++o) {
    const int ox = ox0 + o;
    if (ox >= a.ow) break;
    uint32_t packed = 0u;
#pragma unroll
    for (int b = 0; b < CV; ++b) {
      float q = __fadd_rn(__fmul_rn(__int2float_rn(acc[o][b]), m[b]), bz[b]);
      if (a.act >= 0) {
        if (a.act == 1) {
          q = fminf(fmaxf(q, a.act_lo), a.act_hi);
        } else {
          q = fmaxf(q, 0.0f);
          if (a.act > 0) q = fminf(q, a.act_hi);
        }
      }
      const float y = fminf(fmaxf(__fadd_rn(roundf(q), a.zp_out), a.lo), a.hi);
      packed |= ((uint32_t)((int)y) & 0xFFu) << (8 * b);
    }
    uint8_t* op = orow + (size_t)ox * a.c;
    if (VEC) {
      *reinterpret_cast<uint32_t*>(op) = packed;
    } else {
      for (int b = 0; b < CV && c0 + b < a.c; ++b) op[b] = (uint8_t)(packed >> (8 * b));
    }
  }
}

template <int K, int S>
void launch(const DwArgs& a, bool vec, unsigned items, unsigned wtiles, unsigned cwords,
            cudaStream_t s) {
  const unsigned grid = (items + THREADS - 1) / THREADS;
  if (a.x_u8) {
    if (vec)
      dw_qconv_kernel<K, S, true, true><<<grid, THREADS, 0, s>>>(a, items, wtiles, cwords);
    else
      dw_qconv_kernel<K, S, true, false><<<grid, THREADS, 0, s>>>(a, items, wtiles, cwords);
  } else {
    if (vec)
      dw_qconv_kernel<K, S, false, true><<<grid, THREADS, 0, s>>>(a, items, wtiles, cwords);
    else
      dw_qconv_kernel<K, S, false, false><<<grid, THREADS, 0, s>>>(a, items, wtiles, cwords);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes, dtypes and contiguity; the taps are
// 8-byte aligned and, with vec (C % 4 == 0), the input and the output 4-byte.
extern "C" int dw_qconv_launch(const DwArgs* args, int vec, void* stream) {
  const DwArgs& a = *args;
  if (a.n < 1 || a.c < 1 || a.oh < 1 || a.ow < 1 || a.h < 1 || a.w_in < 1 ||
      a.cp % CV != 0 || a.cp < a.c || (vec && a.c % CV != 0))
    return (int)cudaErrorInvalidValue;
  const unsigned wtiles = (unsigned)(a.ow + TW - 1) / TW;
  const unsigned cwords = (unsigned)(a.c + CV - 1) / CV;
  const long long total = (long long)a.n * a.oh * wtiles * cwords;
  if (total > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;  // 32-bit thread index
  const unsigned items = (unsigned)total;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a.k == 3 && a.stride == 1)
    launch<3, 1>(a, vec != 0, items, wtiles, cwords, s);
  else if (a.k == 3 && a.stride == 2)
    launch<3, 2>(a, vec != 0, items, wtiles, cwords, s);
  else if (a.k == 5 && a.stride == 1)
    launch<5, 1>(a, vec != 0, items, wtiles, cwords, s);
  else if (a.k == 5 && a.stride == 2)
    launch<5, 2>(a, vec != 0, items, wtiles, cwords, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
