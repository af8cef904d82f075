// Int8 implicit-GEMM convolution with fused requantization, for Hopper
// (sm_90a). One kernel serves three Pallas TPU kernels of the JAX package:
//
//   tengine_tpu/ops/pallas/qconv.py: qconv_direct  k×k conv, stride 1/2, any pads
//   tengine_tpu/ops/pallas/qconv.py: qconv1x1      1×1 conv as a flat GEMM
//   tengine_tpu/ops/pallas/qgemm.py: qgemm_requant [M,K]×[K,N] GEMM (1×1 convs, FC)
//
// qconv1x1 and qgemm_requant are its kh = kw = 1 case over a flat [M, K]
// (one image of height 1 and width M).
//
//   acc[m,n] = sum_{tap,c} x'[m,tap,c] * w[n,tap,c]       exact int32
//   accf     = float(acc) (+ cw * float(rowsum x'[m]))    uint8 zero-point term
//   q        = accf * M[n] + B[n]                          two f32 roundings
//   q        = activation clamp around zp_out
//   t        = clip(roundf(q), lo, hi)                     half away from zero
//   with a fused residual r (the unfused eltwise-sum numerics):
//   t        = clip(max?(roundf(((t-zp_mid)*s_mid + (r-zp_r)*s_r) * f32(1/s_out2)) + zp_out2), lo, hi)
//
// x' is the stored input, re-centred by -128 (a byte XOR 0x80) when it is
// uint8; taps outside the image read the input zero-point zp_in (re-centred
// too) and count in the rowsum, as the Pallas wrapper's zp_in padding does.
// The rowsum is summed directly with dp4a against 0x01010101: the TPU
// kernel's MXU ones-column gives the same int32.
//
// What bounds it on this card: operations. yolov3-416 batch 8 gives the
// k×k convs 204 GMAC over 236 MB, about 0.2 ms at the 1,979 TOP/s int8
// tensor-core rate against 0.07 ms of HBM traffic. This first design does
// not reach the tensor cores: it is a tiled dp4a GEMM. Each 256-thread block
// computes a 128-pixel × 128-channel output tile; the K loop walks taps ×
// 32-channel chunks, staging the input patch rows and the weight tile in
// shared memory as 4-byte k-words (k-major, rows padded by 4 words so the
// transposing stores are free of bank conflicts), with the next chunk's
// global loads held in registers while the current one is multiplied. Each
// thread accumulates an 8 × 8 int32 micro-tile with __dp4a. Ragged pixel,
// channel and K edges are masked and zero-filled. mma.sync / wgmma with TMA
// are the next step.
//
// The epilogue is f32 without contraction (-fmad=false in the build, and
// explicit __fmul_rn/__fadd_rn), as the Pallas epilogue rounds each
// product and sum separately; the clamp thresholds arrive as f32 values that
// the host computed in double.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by QconvArgs in ops/cuda/qconv.py (ctypes).
struct QconvArgs {
  const void* x;      // [N, H, W, C] int8/uint8, NHWC contiguous
  const void* w;      // [C2, kh*kw, cstride] int8, zero beyond C
  const float* mult;  // [C2]
  const float* bias;  // [C2]
  const void* res;    // [N, OH, OW, C2] int8/uint8 residual, or null
  void* out;          // [N, OH, OW, C2] int8/uint8
  int n, h, w_in, c;
  int oh, ow, c2;
  int kh, kw, stride, pad_t, pad_l;
  int cstride;  // weight channels per tap: C rounded up to a multiple of 32
  int zp_in, cw, act;
  float act_lo, act_hi, zp_out, lo, hi;
  int x_u8, res_u8, out_u8, has_res, relu2;
  float s_mid, zp_mid, s_r, zp_r, inv_s_out2, zp_out2;  // inv_s_out2 = f32(1 / s_out2)
};

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 32;   // int8 k values per chunk
constexpr int KW = BK / 4;
constexpr int TM = 8, TN = 8;  // per-thread micro-tile
constexpr int THREADS = 256;   // 16 × 16 threads of TM × TN
constexpr int SA = BM + 4;     // shared row stride in words
constexpr int SB = BN + 4;

__device__ __forceinline__ uint32_t pad_word(uint32_t padb, int ch, int c) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (ch + b < c) w |= padb << (8 * b);
  return w;
}

// This thread's 16 input bytes and 16 weight bytes of chunk t: pixel lm of
// the tile, channels [cb, cb + 16) of one tap; re-centred, zero beyond C.
template <bool VEC>
__device__ __forceinline__ void load_chunk(const QconvArgs& a, int t, int nck,
                                           bool m_ok, int iy0, int ix0,
                                           const int8_t* xb, bool n_ok,
                                           const int8_t* wrow, int half,
                                           uint32_t flip, uint32_t padb,
                                           uint32_t (&v)[4], uint32_t (&wv)[4]) {
  const int tap = t / nck;
  const int cb = (t - tap * nck) * BK + half * 16;
  const int ky = tap / a.kw, kx = tap - ky * a.kw;
  const int iy = iy0 + ky, ix = ix0 + kx;
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = wv[j] = 0u;
  if (m_ok && cb < a.c) {
    const bool inside = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w_in;
    if (!inside) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = pad_word(padb, cb + 4 * j, a.c);
    } else {
      const int8_t* xp = xb + ((size_t)iy * a.w_in + ix) * a.c + cb;
      if (VEC) {
        const uint4 q = *reinterpret_cast<const uint4*>(xp);
        v[0] = q.x ^ flip; v[1] = q.y ^ flip; v[2] = q.z ^ flip; v[3] = q.w ^ flip;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int ch = cb + 4 * j + b;
            if (ch < a.c)
              v[j] |= (((uint32_t)(uint8_t)xp[4 * j + b]) ^ (flip & 0xFFu)) << (8 * b);
          }
        }
      }
    }
  }
  if (n_ok && cb < a.c) {
    const uint4 q = *reinterpret_cast<const uint4*>(wrow + (size_t)tap * a.cstride + cb);
    wv[0] = q.x; wv[1] = q.y; wv[2] = q.z; wv[3] = q.w;
  }
}

// two blocks per SM: at most 128 registers a thread
template <bool VEC, bool ROWSUM>
__global__ void __launch_bounds__(THREADS, 2) qconv_igemm_kernel(const QconvArgs a) {
  __shared__ __align__(16) int As[KW][SA];
  __shared__ __align__(16) int Bs[KW][SB];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int M = a.n * a.oh * a.ow;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // loader role: pixel / output channel lm of the tile, 16-byte half `half`
  // of each 32-byte chunk (two neighbouring threads read one 32-byte sector)
  const int lm = tid >> 1, half = tid & 1;
  const int gm = m0 + lm;
  const bool m_ok = gm < M;
  int img = 0, oy = 0, ox = 0;
  if (m_ok) {
    const int plane = a.oh * a.ow;
    img = gm / plane;
    const int r = gm - img * plane;
    oy = r / a.ow;
    ox = r - oy * a.ow;
  }
  const int iy0 = oy * a.stride - a.pad_t, ix0 = ox * a.stride - a.pad_l;
  const int8_t* xb = static_cast<const int8_t*>(a.x) + (size_t)img * a.h * a.w_in * a.c;
  const int gn = n0 + lm;
  const bool n_ok = gn < a.c2;
  const int taps = a.kh * a.kw;
  const int8_t* wrow =
      static_cast<const int8_t*>(a.w) + (size_t)(n_ok ? gn : 0) * taps * a.cstride;

  const uint32_t flip = a.x_u8 ? 0x80808080u : 0u;
  const uint32_t padb = ((uint32_t)a.zp_in & 0xFFu) ^ (flip & 0xFFu);

  int acc[TM][TN];
  int rs[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rs[i] = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  }

  const int nck = (a.c + BK - 1) / BK;
  const int n_chunks = taps * nck;
  uint32_t v[4], wv[4];
  load_chunk<VEC>(a, 0, nck, m_ok, iy0, ix0, xb, n_ok, wrow, half, flip, padb, v, wv);
  for (int t = 0; t < n_chunks; ++t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[half * 4 + j][lm] = (int)v[j];
      Bs[half * 4 + j][lm] = (int)wv[j];
    }
    __syncthreads();
    if (t + 1 < n_chunks)
      load_chunk<VEC>(a, t + 1, nck, m_ok, iy0, ix0, xb, n_ok, wrow, half, flip, padb, v, wv);
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int4 a0 = *reinterpret_cast<const int4*>(&As[k][ty * TM]);
      const int4 a1 = *reinterpret_cast<const int4*>(&As[k][ty * TM + 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Bs[k][tx * TN]);
      const int4 b1 = *reinterpret_cast<const int4*>(&Bs[k][tx * TN + 4]);
      const int av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
        if (ROWSUM) rs[i] = __dp4a(av[i], 0x01010101, rs[i]);
      }
    }
    __syncthreads();
  }

  // epilogue: requant, optional residual, store TN bytes per pixel
  const float cwf = (float)a.cw;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int pm = m0 + ty * TM + i;
    if (pm >= M) break;
    const float rsf = ROWSUM ? __fmul_rn(cwf, __int2float_rn(rs[i])) : 0.0f;
    const size_t row = (size_t)pm * a.c2;
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int pn = n0 + tx * TN + j;
      if (pn >= a.c2) break;
      float accf = __int2float_rn(acc[i][j]);
      if (ROWSUM) accf = __fadd_rn(accf, rsf);
      float q = __fadd_rn(__fmul_rn(accf, a.mult[pn]), a.bias[pn]);
      if (a.act >= 0) {
        if (a.act == 1) {
          q = fminf(fmaxf(q, a.act_lo), a.act_hi);
        } else {
          q = fmaxf(q, a.zp_out);
          if (a.act > 0) q = fminf(q, a.act_hi);
        }
      }
      float y = fminf(fmaxf(roundf(q), a.lo), a.hi);
      if (a.has_res) {
        const float r = a.res_u8 ? (float)static_cast<const uint8_t*>(a.res)[row + pn]
                                 : (float)static_cast<const int8_t*>(a.res)[row + pn];
        const float tf = __fmul_rn(__fsub_rn(y, a.zp_mid), a.s_mid);
        const float rf = __fmul_rn(__fsub_rn(r, a.zp_r), a.s_r);
        y = __fadd_rn(roundf(__fmul_rn(__fadd_rn(tf, rf), a.inv_s_out2)), a.zp_out2);
        if (a.relu2) y = fmaxf(y, a.zp_out2);
        y = fminf(fmaxf(y, a.lo), a.hi);
      }
      packed[j >> 2] |= ((uint32_t)((int)y) & 0xFFu) << (8 * (j & 3));
    }
    uint8_t* o = static_cast<uint8_t*>(a.out) + row + n0 + tx * TN;
    if (n0 + tx * TN + TN <= a.c2 && (a.c2 % TN) == 0) {
      *reinterpret_cast<uint2*>(o) = make_uint2(packed[0], packed[1]);
    } else {
      for (int j = 0; j < TN && n0 + tx * TN + j < a.c2; ++j)
        o[j] = (uint8_t)(packed[j >> 2] >> (8 * (j & 3)));
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes, dtypes, contiguity and alignment: the
// weights and (with vec) the input are 16-byte aligned, the output 8-byte.
extern "C" int qconv_igemm_launch(const QconvArgs* args, int vec, void* stream) {
  const QconvArgs& a = *args;
  if (a.n < 1 || a.c < 1 || a.c2 < 1 || a.kh < 1 || a.kw < 1 || a.stride < 1 ||
      a.cstride % BK != 0 || a.cstride < a.c)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)a.n * a.oh * a.ow;
  if (M < 1 || M > 0x7FFFFFFFLL - BM) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((a.c2 + BN - 1) / BN));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool rowsum = a.cw != 0;
  if (vec) {
    if (rowsum)
      qconv_igemm_kernel<true, true><<<grid, THREADS, 0, s>>>(a);
    else
      qconv_igemm_kernel<true, false><<<grid, THREADS, 0, s>>>(a);
  } else {
    if (rowsum)
      qconv_igemm_kernel<false, true><<<grid, THREADS, 0, s>>>(a);
    else
      qconv_igemm_kernel<false, false><<<grid, THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
