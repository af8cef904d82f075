// The two elementwise passes around the fast tier's float64 library conv, for
// Hopper (sm_90a). They replace no TPU kernel: on the TPU, XLA fused these
// steps into the conv (tengine_tpu/ops/quantized.py:_conv_quant_common,
// _requant_conv_out); in PyTorch they were some 17 ATen launches a conv, each
// reading and writing the whole tensor.
//
//   qwiden_kernel    stored integer activation -> the float64 buffer the
//                    library conv reads: x - zp_in ("shift"), the raw values
//                    ("raw"), or the raw values padded with zp_in ("fill");
//                    where the lowering pads, the padded buffer.
//   qrequant_kernel  the conv's (or FC's) float64 sums -> the stored integer
//                    output, every f32 step of the plain version in its order
//                    (csrc/requant_steps.cuh lists them), the FC's zero-point
//                    fold joining first: a = f32(acc) + corr.
//
// What bounds them on this card: bytes. The widen reads 1 byte and writes 8
// an element, the requant reads 8 (plus a residual byte) and writes 1; about
// a dozen to fifty f32 and integer instructions an element stay under what
// the SMs issue at 3.35 TB/s. What the design does about it:
//   - The float64 side moves in 16-byte loads and stores, the integer side in
//     2- or 8-byte ones, where the pointers are aligned (a scalar path with
//     bounds checks covers the rest and the ragged end). A requant thread
//     owns VEC = 8 consecutive elements (its 64 bytes of loads come through
//     L1, its 8-byte store is coalesced across the warp); a widen warp owns
//     256, each lane two neighbours at a time, so that every store of the
//     warp writes 512 contiguous bytes.
//   - Any dense layout: the wrapper describes the output's storage order as
//     four levels (outer to inner) and, for each stream the element needs
//     (the channel, the correction's offset, the residual's offset; or the
//     input's offset and its row and column), its step a level. A thread
//     decodes its first element with three multiply-high divisions and walks
//     the other seven with an odometer, so NHWC and NCHW tensors (the library
//     conv returns both) take the same path, the channel changing anywhere
//     inside a vector (255-channel heads, 7x7 maps).
//   - M, B and the corrections are read through the read-only cache.
//   - Blocks walk the vectors grid-stride, a few blocks an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "requant_steps.cuh"

#define VEC 8
#define THREADS 256
#define NUM_SMS 132
#define BLOCKS_PER_SM 8
#define NSTREAM 3

// The output's storage order: level 0 outermost. An element's stream offsets
// are base + sum over levels of index * step; carry[s][k] (k < 3) is what
// stream s gains when level k + 1 wraps to 0 and level k steps.
// Mirrored field for field by Walk in ops/cuda/requant.py (ctypes).
struct Walk {
  int sz[4];
  unsigned mag[4];  // multiply-high divisors of sz (levels 1..3)
  int shf[4];
  int base[NSTREAM];
  int step[NSTREAM][4];
  int carry[NSTREAM][3];
};

// Mirrored field for field by WidenArgs in ops/cuda/requant.py (ctypes).
struct WidenArgs {
  const void* x;      // int8/uint8, any strides
  double* out;        // dense, in walk's order
  Walk walk;          // streams: x's offset, input row, input column
  int n;              // output elements
  int h, w;           // the input's rows and columns
  int x_u8;
  int flat;           // x dense in out's order, no padding
  int vec_ok;         // out 16-byte aligned (and x 2-byte aligned when flat)
  double sub, fill;   // x - sub inside, fill outside
};

// Mirrored field for field by RequantArgs in ops/cuda/requant.py (ctypes).
struct RequantArgs {
  const double* acc;   // dense, in walk's order (the output's order too)
  const float* mult;   // [C]
  const float* bias;   // [C], read where steps.has_bias
  const float* corr;   // per channel or per position, or null
  const void* res;     // int8/uint8 residual, any strides, or null
  void* out;           // int8/uint8, acc's strides
  Walk walk;           // streams: channel, correction's offset, residual's offset
  int n;
  int corr_first;      // FC: the correction joins before the multiply
  int vec_ok;
  RequantSteps steps;  // the rest (requant_steps.cuh)
};

__device__ __forceinline__ unsigned fdiv(unsigned n, unsigned mag, int shf) {
  return (__umulhi(n, mag) + n) >> shf;
}

// The running offsets of one element and its level indices.
struct Odo {
  int idx[4];
  int off[NSTREAM];
};

__device__ __forceinline__ void odo_start(const Walk& w, unsigned i, Odo& o) {
  unsigned r = i;
#pragma unroll
  for (int k = 3; k >= 1; --k) {
    const unsigned q = fdiv(r, w.mag[k], w.shf[k]);
    o.idx[k] = (int)(r - q * (unsigned)w.sz[k]);
    r = q;
  }
  o.idx[0] = (int)r;
#pragma unroll
  for (int s = 0; s < NSTREAM; ++s) {
    int v = w.base[s];
#pragma unroll
    for (int k = 0; k < 4; ++k) v += o.idx[k] * w.step[s][k];
    o.off[s] = v;
  }
}

__device__ __forceinline__ void odo_next(const Walk& w, Odo& o) {
#pragma unroll
  for (int s = 0; s < NSTREAM; ++s) o.off[s] += w.step[s][3];
  if (++o.idx[3] < w.sz[3]) return;
  o.idx[3] = 0;
#pragma unroll
  for (int s = 0; s < NSTREAM; ++s) o.off[s] += w.carry[s][2];
  if (++o.idx[2] < w.sz[2]) return;
  o.idx[2] = 0;
#pragma unroll
  for (int s = 0; s < NSTREAM; ++s) o.off[s] += w.carry[s][1];
  if (++o.idx[1] < w.sz[1]) return;
  o.idx[1] = 0;
#pragma unroll
  for (int s = 0; s < NSTREAM; ++s) o.off[s] += w.carry[s][0];
  ++o.idx[0];
}

// ---------------------------------------------------------------------------
// widen
// ---------------------------------------------------------------------------

__device__ __forceinline__ double widen_one(const WidenArgs& a, const Odo& o) {
  const int hi = o.off[1], wi = o.off[2];
  if (hi < 0 || hi >= a.h || wi < 0 || wi >= a.w) return a.fill;
  const double v = a.x_u8 ? (double)__ldg((const uint8_t*)a.x + o.off[0])
                          : (double)__ldg((const int8_t*)a.x + o.off[0]);
  return __dsub_rn(v, a.sub);
}

// The value of a stored byte (flat path: x in out's order).
__device__ __forceinline__ double flat_one(const WidenArgs& a, uint32_t b) {
  return __dsub_rn(a.x_u8 ? (double)(b & 0xffu) : (double)(int8_t)(b & 0xffu), a.sub);
}

// A warp owns chunks of 256 consecutive output elements; in each of its four
// steps a lane takes two neighbours, so that a warp's stores are 512
// contiguous bytes (and the flat path's loads 64).
__global__ void __launch_bounds__(THREADS) qwiden_kernel(const __grid_constant__ WidenArgs a) {
  const unsigned n = (unsigned)a.n, lane = threadIdx.x & 31u;
  const unsigned nchunk = (n + 255u) / 256u, nwarp = gridDim.x * (THREADS / 32);
  for (unsigned ch = (blockIdx.x * THREADS + threadIdx.x) / 32; ch < nchunk; ch += nwarp) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned i0 = ch * 256u + j * 64u + 2u * lane;
      if (i0 >= n) continue;
      const bool pair = i0 + 1 < n, vec = a.vec_ok && pair;
      double r0, r1 = 0.0;
      if (a.flat) {
        const uint8_t* x = (const uint8_t*)a.x + i0;
        const uint32_t raw = vec ? (uint32_t)__ldg(reinterpret_cast<const uint16_t*>(x))
                                 : (uint32_t)__ldg(x) | (pair ? (uint32_t)__ldg(x + 1) << 8 : 0u);
        r0 = flat_one(a, raw);
        r1 = flat_one(a, raw >> 8);
      } else {
        Odo o;
        odo_start(a.walk, i0, o);
        r0 = widen_one(a, o);
        if (pair) {
          odo_next(a.walk, o);
          r1 = widen_one(a, o);
        }
      }
      if (vec) {
        *reinterpret_cast<double2*>(a.out + i0) = make_double2(r0, r1);
      } else {
        a.out[i0] = r0;
        if (pair) a.out[i0 + 1] = r1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// requant
// ---------------------------------------------------------------------------

__device__ __forceinline__ float requant_one(const RequantArgs& a, double accv, const Odo& o) {
  const RequantSteps& s = a.steps;
  const int c = o.off[0];
  float q = __double2float_rn(accv);
  if (a.corr_first) q = __fadd_rn(q, __ldg(a.corr + o.off[1]));
  const float b = s.has_bias ? __ldg(a.bias + c) : 0.0f;
  const float corr = s.has_corr ? __ldg(a.corr + o.off[1]) : 0.0f;
  const uint32_t rb = s.res_mode != 0 ? (uint32_t)__ldg((const uint8_t*)a.res + o.off[2]) : 0u;
  return requant_steps::apply(s, q, __ldg(a.mult + c), b, corr, rb);
}

__global__ void __launch_bounds__(THREADS) qrequant_kernel(const __grid_constant__ RequantArgs a) {
  const unsigned nvec = ((unsigned)a.n + VEC - 1) / VEC;
  for (unsigned v = blockIdx.x * THREADS + threadIdx.x; v < nvec; v += gridDim.x * THREADS) {
    const unsigned i0 = v * VEC;
    const bool full = a.vec_ok && i0 + VEC <= (unsigned)a.n;
    double accv[VEC];
    if (full) {
      const double2* src = reinterpret_cast<const double2*>(a.acc + i0);
#pragma unroll
      for (int e = 0; e < VEC; e += 2) {
        const double2 d = __ldg(src + e / 2);
        accv[e] = d.x;
        accv[e + 1] = d.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) accv[e] = i0 + e < (unsigned)a.n ? a.acc[i0 + e] : 0.0;
    }
    Odo o;
    odo_start(a.walk, i0, o);
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (i0 + e < (unsigned)a.n) {
        const int y = __float2int_rn(requant_one(a, accv[e], o));
        word[e / 4] |= ((uint32_t)y & 0xffu) << (8 * (e % 4));
      }
      if (e + 1 < VEC) odo_next(a.walk, o);
    }
    if (full) {
      *reinterpret_cast<uint2*>((uint8_t*)a.out + i0) = make_uint2(word[0], word[1]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (i0 + e < (unsigned)a.n) ((uint8_t*)a.out)[i0 + e] = (uint8_t)(word[e / 4] >> (8 * (e % 4)));
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

static int grid_for(int n) {
  // VEC elements a thread: a requant thread's vector, a widen lane's four pairs
  const long long nvec = ((long long)n + VEC - 1) / VEC;
  const long long blocks = (nvec + THREADS - 1) / THREADS;
  const long long cap = (long long)NUM_SMS * BLOCKS_PER_SM;
  return (int)(blocks < cap ? blocks : cap);
}

static bool walk_ok(const Walk& w) {
  for (int k = 0; k < 4; ++k)
    if (w.sz[k] < 1) return false;
  return true;
}

// Launch on `stream`; return cudaGetLastError() after the launch (0 on
// success). The wrapper checks dtypes, shapes, strides and alignment, and
// describes the walk; an empty tensor launches nothing.
extern "C" int qwiden_launch(const WidenArgs* args, void* stream) {
  const WidenArgs& a = *args;
  if (a.n < 0 || !walk_ok(a.walk)) return (int)cudaErrorInvalidValue;
  if (a.n == 0) return 0;
  qwiden_kernel<<<grid_for(a.n), THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int qrequant_launch(const RequantArgs* args, void* stream) {
  const RequantArgs& a = *args;
  if (a.n < 0 || !walk_ok(a.walk) || a.mult == nullptr || (a.steps.has_bias && a.bias == nullptr) ||
      (a.steps.res_mode != 0 && a.res == nullptr) || ((a.steps.has_corr || a.corr_first) && a.corr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.n == 0) return 0;
  qrequant_kernel<<<grid_for(a.n), THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
