// Fused quantized stem convolution for Hopper (sm_90a), on the int8 tensor
// cores.
//
// Replaces the Pallas TPU kernel tengine_tpu/ops/pallas/stem_conv.py:
// stem_qconv_packed (_stem_kernel): the first layer of a quantized conv net,
// stride 2, k <= 7, C_in <= 4, k <= 2*pad + 2, NCHW s8/u8 input, NHWC output.
//
//   out = clip(round_half_away(act(acc * M[c] + B[c])) + zp_out, lo, hi)
//   acc = sum (x - c0) * w_true     exact int32; w_true = stored weight - zp_w
//
// c0 re-centres unsigned input (128) and is 0 for signed input, so every
// patch value (padding included: zp_in - c0) fits int8; the host folds the
// constant (c0 - zp_in) * rowsum(w_true) * M into B exactly as the Pallas
// packing does. The weights arrive in the Pallas kernel's own int8 matrix
// [Kp, Ce] (pack_stem_weights, byte for byte): true values where zp_w == 0;
// where zp_w != 0 the stored values re-centred, w_q - 128, and an all-ones
// column at Cout, so that acc = acc_stored + (128 - zp_w) * patchsum, the
// patch sums coming out of the tensor cores beside the products. Every sum
// is an exact int32 below 2^24, so acc * M + B is the same f32 expression
// as the Pallas kernel's and the outputs are the same integers.
//
// What bounds it: bytes, on paper. The yolov5s-640 b8 stem reads 9.8 MB of
// int8 input and writes 26.2 MB of int8 NHWC output (0.0108 ms at 3.35
// TB/s) for 2.83 G multiply-adds, which as scalar int32 IMADs (64 a clock
// and SM) would take 0.19 ms alone. The kernel is an implicit GEMM on
// mma.sync m16n8k32 (csrc/mma_s8.cuh): M = output pixels, N = a
// chunk of 32 output channels (+ 8 for the ones column), K = the patch. The
// products then cost little; what is left is the gather of the patch rows
// and the epilogue, about a dozen instructions an output, and with SiLU an
// expf and a reciprocal besides:
//   - A block stages a tile's input band (all C_in rows of 2*TR + k - 2
//     input rows, TC output columns wide) by 4-byte cp.async copies of the
//     raw rows, then builds it in shared memory twice, re-centred by a byte
//     XOR 0x80 for uint8 and padded with zp_in: as it is, and shifted by two
//     bytes. An output pixel at column lx starts its taps at band byte 2*lx,
//     which is word lx/2 of the first copy (lx even) or of the shifted one
//     (lx odd): every 4 taps of a patch row are one aligned 32-bit shared
//     load, so the kernel orders K as (c, u, v/4, v%4) and loads each A
//     fragment register with one LDS. Taps v >= k in the last group of a
//     row meet zero weights. K = C*k*4*ceil(k/4), padded to 32 (yolov5s:
//     144 -> 160, 5 k-steps).
//   - Blocks are persistent: once a tile's band is built, its raw rows'
//     buffer takes the next tile's copies while the warps compute.
//   - The weights of the block's channel chunk are reordered into that K
//     order in shared memory once; a warp loads its B fragments by ldmatrix
//     at each k-step, so that a thread needs few enough registers for three
//     blocks (24 warps) an SM.
//   - Each warp takes 16-pixel rows of the tile in turn; its outputs go
//     through a small shared buffer and leave as 16-byte NHWC stores.
//   - The epilogue folds the activation clamp and the output clip into one
//     clamp before an exact round-half-away (lo, hi and zp_out are
//     integers, so clipping before the rounding equals clipping after it).
//
// The epilogue is f32 without contraction (-fmad=false in the build, and
// explicit __fmul_rn/__fadd_rn): the Pallas epilogue rounds the product
// and the sum separately. SiLU uses expf (not __expf) and __frcp_rn, the
// correctly rounded reciprocal, which is the value __fdiv_rn(1.0f, x) gives.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

// Mirrored field for field by StemArgs in ops/cuda/stem_conv.py (ctypes).
struct StemArgs {
  const void* x;      // [B, C, H, W] int8/uint8 NCHW
  const int8_t* w;    // [kp, ce] int8, pack_stem_weights' matrix
  const float* mult;  // [Cout]
  const float* bias;  // [Cout]
  void* out;          // [B, H/2, W/2, Cout] int8/uint8/f32 NHWC
  int n, c, h, w_in, cout, k, pad;
  int kp, ce, w_corr;  // matrix shape; 128 - zp_w with a ones column at cout, else 0
  int act, zp_in, zp_out, out_kind, signed_in;
  int tr, tc;          // block tile: output rows, output columns
  float s_out, act_lo, act_hi, lo, hi;
};

namespace {

using namespace mma_s8;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NCH = 32;          // output channels a block computes
constexpr int NT = NCH / 8 + 1;  // n-tiles: four of channels, one for the ones column
constexpr int MAX_C = 4;
constexpr int MAX_K = 7;

enum OutKind { OUT_S8 = 0, OUT_U8 = 1, OUT_F32 = 2 };

// Shared-memory layout of a block, in 32-bit words: the raw input rows of a
// tile (the next one arrives there while the current one is computed from
// the band), the band in two copies, the reordered weights, M and B of the
// chunk, the warps' output buffers.
struct Layout {
  int qk, kwords, kwp, rows_in, ww, wwp, rws, raw, copy, band, wrow, wmat, mb, obuf;
  __host__ __device__ Layout(int c, int k, int tr, int tc, int nks, bool f32) {
    qk = (k + 3) / 4;                 // 4-tap groups of a patch row
    kwords = c * k * qk;              // K / 4 before padding
    kwp = nks * 8;                    // K / 4 padded to the k-steps
    rows_in = 2 * (tr - 1) + k;
    ww = (tc - 1) / 2 + qk;           // words of a band row a pixel may read
    wwp = ww + 1;                     // the shifted copy reads one word on
    wwp += (8 - wwp % 32 + 32) % 32;  // = 8 mod 32: patch rows u, u+1 on other banks
    rws = wwp + 1;                    // raw words of a row: the copies read one on
    raw = (c * rows_in * rws + 3) & ~3;
    copy = c * rows_in * wwp;
    copy += (16 - copy % 32 + 32) % 32;  // = 16 mod 32: the two copies on other banks
    band = 2 * copy;
    wrow = kwp + 4;                   // B rows (16-byte aligned) on distinct banks
    wmat = NT * 8 * wrow;
    mb = 2 * NCH;
    obuf = WARPS * 16 * (f32 ? 36 : 12);  // a warp's 16 output pixels, rows padded
  }
  __host__ __device__ int total_bytes() const { return 4 * (raw + band + wmat + mb + obuf); }
};

// C's round(): half away from zero, as an integer, for |q| < 2^22: adding
// the float just below 0.5 (with q's sign) and truncating (the one value
// that q + 0.5 would get wrong, 0.49999997, stays below 1).
__device__ __forceinline__ int round_away_small(float q) {
  return __float2int_rz(__fadd_rn(q, copysignf(0.49999997f, q)));
}

// acc * M + B, the activation, the output clip: the output integer. Where the
// activation is a clamp, [q_lo, q_hi] holds it and the clip in one (see the
// kernel); for SiLU it is the clip alone.
__device__ __forceinline__ int epilogue(int acc, float m, float b, bool silu, float s_out,
                                        float q_lo, float q_hi, int zp_out) {
  float q = __fadd_rn(__fmul_rn((float)acc, m), b);
  if (silu) {  // q * sigmoid(q * s_out)
    const float z = __fmul_rn(q, s_out);
    // 1 / (1 + e), correctly rounded: the value __fdiv_rn(1.0f, .) gives
    const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-z)));
    q = __fmul_rn(q, sig);
  }
  return round_away_small(fminf(fmaxf(q, q_lo), q_hi)) + zp_out;
}

// pi / tc for a pixel of a tile (pi < 2^16, tc <= 2^12): the fraction of
// (pi + 0.5) / tc stays at least 1 / (2 tc) from an integer, far above the
// float product's error
__device__ __forceinline__ int row_of(int pi, float inv_tc) {
  return __float2int_rz(__fmul_rn(__int2float_rn(pi) + 0.5f, inv_tc));
}

// A tile: its channel chunk, image and output corner.
struct Tile {
  int chunk, img, oy0, ox0;
};

__device__ __forceinline__ Tile tile_of(int t, int ctiles, int rtiles, int n, int tr, int tc) {
  Tile r;
  r.ox0 = (t % ctiles) * tc;
  t /= ctiles;
  r.oy0 = (t % rtiles) * tr;
  t /= rtiles;
  r.img = t % n;
  r.chunk = t / n;
  return r;
}

// Stage a tile's raw input rows: word jj of (c, row) holds input columns
// 4*(j0 + jj) .. +3 of input row 2*oy0 - pad + row, j0 = floor((2*ox0 - pad)/4),
// and zp_in outside the image. By 4-byte cp.async where the rows are 4-byte
// aligned (W % 4 == 0), else byte by byte.
__device__ __forceinline__ void stage_raw(const StemArgs& a, const Layout& L, const Tile& t,
                                          uint32_t* raw, bool words) {
  const uint32_t zp4 = (uint32_t)(a.zp_in & 0xFF) * 0x01010101u;
  const uint8_t* xb = static_cast<const uint8_t*>(a.x) + (size_t)t.img * a.c * a.h * a.w_in;
  const int ih0 = 2 * t.oy0 - a.pad, j0 = (2 * t.ox0 - a.pad) >> 2;
  const int lane = threadIdx.x & 31;
  for (int cr = threadIdx.x >> 5; cr < a.c * L.rows_in; cr += WARPS) {  // a warp a row
    const int row = cr % L.rows_in, c = cr / L.rows_in, ih = ih0 + row;
    const bool row_in = ih >= 0 && ih < a.h;
    const uint8_t* rowp = xb + ((size_t)c * a.h + (row_in ? ih : 0)) * a.w_in;
    for (int jj = lane; jj < L.rws; jj += 32) {
      const int col = 4 * (j0 + jj);
      uint32_t* dst = raw + cr * L.rws + jj;
      if (!row_in || col + 3 < 0 || col >= a.w_in) {
        *dst = zp4;
      } else if (words) {
        cp_async_small<4>(smem_u32(dst), rowp + col, 4);
      } else {
        uint32_t v = 0u;
        for (int b = 0; b < 4; ++b) {
          const int cb = col + b;
          v |= (cb >= 0 && cb < a.w_in ? (uint32_t)rowp[cb] : (zp4 & 0xFFu)) << (8 * b);
        }
        *dst = v;
      }
    }
  }
}

// Persistent: a block walks the tiles blockIdx.x, + gridDim.x, ..., and
// stages the next tile's raw rows while it computes the current one from the
// band. Three blocks an SM: the B fragments come from shared memory by
// ldmatrix at each k-step rather than living in registers.
template <int NKS>
__global__ void __launch_bounds__(THREADS, 3) stem_qconv_kernel(const StemArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const bool f32 = a.out_kind == OUT_F32;
  const Layout L(a.c, a.k, a.tr, a.tc, NKS, f32);
  uint32_t* raw = smem;
  uint32_t* band = raw + L.raw;
  uint32_t* s_w = band + L.band;
  float* s_m = reinterpret_cast<float*>(s_w + L.wmat);
  float* s_b = s_m + NCH;
  uint32_t* s_o = reinterpret_cast<uint32_t*>(s_b + NCH);

  const int OH = a.h / 2, OW = a.w_in / 2;
  const int ctiles = (OW + a.tc - 1) / a.tc, rtiles = (OH + a.tr - 1) / a.tr;
  const int ntiles = ctiles * rtiles * a.n * ((a.cout + NCH - 1) / NCH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k = a.k, qk = L.qk;
  const bool ones = a.w_corr != 0;
  const uint32_t flip = a.signed_in ? 0u : 0x80808080u;
  const bool words = (a.w_in & 3) == 0 && (reinterpret_cast<uintptr_t>(a.x) & 3) == 0;
  // The activation clamp [A, B] and the output clip [lo, hi] - zp_out in one
  // clamp: lo, hi and zp_out are integers, so clipping before the rounding
  // gives what clipping after it gives, and a clamp of a clamp is the clamp
  // onto [clamp(A, L, H), clamp(B, L, H)].
  const bool silu = a.act == 100;
  const float cl = __fsub_rn(a.lo, (float)a.zp_out), chh = __fsub_rn(a.hi, (float)a.zp_out);
  float q_lo = cl, q_hi = chh;
  if (a.act == 1) {
    q_lo = fminf(fmaxf(a.act_lo, cl), chh);
    q_hi = fminf(fmaxf(a.act_hi, cl), chh);
  } else if (a.act >= 0 && !silu) {
    q_lo = fminf(fmaxf(0.0f, cl), chh);
    if (a.act > 0) q_hi = fminf(fmaxf(a.act_hi, cl), chh);
  }
  const int tile_px = a.tr * a.tc;
  const float inv_tc = 1.0f / (float)a.tc;
  const int ostride = f32 ? 36 : 12;  // words of a buffered pixel
  uint32_t* ob = s_o + warp * 16 * ostride;
  const uintptr_t oalign = reinterpret_cast<uintptr_t>(a.out);
  const bool vec = f32 ? (a.cout % 4 == 0 && (oalign & 15) == 0)
                       : (a.cout % 16 == 0 && (oalign & 15) == 0);

  // the band offsets of this lane's two K-words a k-step (a0/a1 and a2/a3);
  // a padding word reads word 0: its weights are zero
  int koff[NKS][2];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wk = ks * 8 + 4 * h + t4;
      const int q = wk % qk, cu = wk / qk, c = cu / k, u = cu % k;
      koff[ks][h] = wk < L.kwords ? (c * L.rows_in + u) * L.wwp + q : 0;
    }
  // ldmatrix rows of this lane: matrix j = lane / 8 is n-tile pair member
  // j / 2, K half j % 2; its row lane % 8
  const uint32_t b_lane = smem_u32(s_w + (((lane >> 4) * 8) + (lane & 7)) * L.wrow +
                                   4 * ((lane >> 3) & 1));
  int ntv = 0, nv = 0, cur_chunk = -1;

  int t = blockIdx.x;
  if (t < ntiles) stage_raw(a, L, tile_of(t, ctiles, rtiles, a.n, a.tr, a.tc), raw, words);
  cp_async_commit();
  for (; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_of(t, ctiles, rtiles, a.n, a.tr, a.tc);
    const bool new_chunk = tl.chunk != cur_chunk;  // the same for the whole block
    const int n0 = tl.chunk * NCH;
    cp_async_wait<0>();  // this tile's raw rows have landed
    __syncthreads();
    // ---- the band in two copies, re-centred: the first holds band bytes
    // 4m .. 4m + 3 in word m (band byte 0 = input column 2*ox0 - pad), the
    // second band bytes 4m + 2 .. 4m + 5
    {
      const int sh = (2 * tl.ox0 - a.pad) & 3, sh2 = sh + 2;
      for (int cr = warp; cr < a.c * L.rows_in; cr += WARPS) {  // a warp a row
        for (int m = lane; m < L.wwp; m += 32) {
          const uint32_t* r = raw + cr * L.rws + m;
          band[cr * L.wwp + m] = __funnelshift_r(r[0], r[1], 8 * sh) ^ flip;
          if (m < L.ww) {
            const uint32_t* r2 = r + (sh2 >> 2);
            band[L.copy + cr * L.wwp + m] = __funnelshift_r(r2[0], r2[1], 8 * (sh2 & 3)) ^ flip;
          }
        }
      }
    }
    if (new_chunk) {  // after the barrier: the last tile's products read s_w
      // the chunk's weights in the kernel's K order (c, u, q, v % 4): rows
      // 0..31 its channels, row 32 the ones column, zero elsewhere
      for (int i = tid; i < NT * 8 * L.kwp; i += THREADS) {
        const int wk = i % L.kwp, nl = i / L.kwp;
        const int col = nl < NCH ? (n0 + nl < a.cout ? n0 + nl : -1)
                                 : (nl == NCH && ones ? a.cout : -1);
        uint32_t v = 0u;
        if (col >= 0 && wk < L.kwords) {
          const int q = wk % qk, cu = wk / qk;  // cu = c * k + u
          for (int b = 0; b < 4; ++b) {
            const int tap = 4 * q + b;
            if (tap < k)
              v |= (uint32_t)(uint8_t)a.w[(size_t)(cu * k + tap) * a.ce + col] << (8 * b);
          }
        }
        s_w[nl * L.wrow + wk] = v;
      }
      for (int j = tid; j < NCH; j += THREADS) {
        const bool ok = n0 + j < a.cout;
        s_m[j] = ok ? a.mult[n0 + j] : 0.0f;
        s_b[j] = ok ? a.bias[n0 + j] : 0.0f;
      }
      cur_chunk = tl.chunk;
      ntv = min(NCH, a.cout - n0 + 7) / 8;  // n-tiles holding a channel
      nv = min(NCH, a.cout - n0);           // channels of this chunk
    }
    __syncthreads();
    // the raw rows are free again: the next tile's arrive while this one is
    // computed
    {
      const int nt_ = t + gridDim.x;
      if (nt_ < ntiles) stage_raw(a, L, tile_of(nt_, ctiles, rtiles, a.n, a.tr, a.tc), raw, words);
      cp_async_commit();
    }

    for (int mc = warp; mc * 16 < tile_px; mc += WARPS) {
      // this lane's pixels: rows g and g + 8 of the 16 (a pixel past the
      // tile reads word 0; its outputs are not stored)
      int pbase[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pi = mc * 16 + g + 8 * h;
        const int r = row_of(pi, inv_tc), lx = pi - r * a.tc;
        pbase[h] = pi < tile_px ? (lx & 1) * L.copy + 2 * r * L.wwp + (lx >> 1) : 0;
      }
      int acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = 0;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        const uint32_t af[4] = {band[pbase[0] + koff[ks][0]], band[pbase[1] + koff[ks][0]],
                                band[pbase[0] + koff[ks][1]], band[pbase[1] + koff[ks][1]]};
        uint32_t bq[4];  // b0, b1 of n-tiles 2p and 2p + 1
        ldmatrix_x4(bq, b_lane + 4 * (ks * 8));
        mma_s8s8(acc[0], af, bq[0], bq[1]);
        if (ntv > 1) mma_s8s8(acc[1], af, bq[2], bq[3]);
        if (ntv > 2) {
          ldmatrix_x4(bq, b_lane + 4 * (16 * L.wrow + ks * 8));
          mma_s8s8(acc[2], af, bq[0], bq[1]);
          if (ntv > 3) mma_s8s8(acc[3], af, bq[2], bq[3]);
        }
        if (ones) {
          const uint32_t* r = s_w + (4 * 8 + g) * L.wrow + ks * 8 + t4;
          mma_s8s8(acc[4], af, r[0], r[4]);
        }
      }
      // the patch sums of rows g and g + 8 sit in column 0 of the ones tile,
      // held by the lane with t4 == 0
      const int ps0 = __shfl_sync(0xffffffffu, acc[4][0], lane & ~3);
      const int ps1 = __shfl_sync(0xffffffffu, acc[4][2], lane & ~3);
      const int corr[2] = {ones ? a.w_corr * ps0 : 0, ones ? a.w_corr * ps1 : 0};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= ntv) continue;
        const float2 mv = *reinterpret_cast<const float2*>(s_m + nt * 8 + 2 * t4);
        const float2 bv = *reinterpret_cast<const float2*>(s_b + nt * 8 + 2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r0 = epilogue(acc[nt][2 * h] + corr[h], mv.x, bv.x, silu, a.s_out, q_lo,
                                  q_hi, a.zp_out);
          const int r1 = epilogue(acc[nt][2 * h + 1] + corr[h], mv.y, bv.y, silu, a.s_out,
                                  q_lo, q_hi, a.zp_out);
          const int row = g + 8 * h, col = nt * 8 + 2 * t4;
          if (f32) {
            *reinterpret_cast<float2*>(ob + row * ostride + col) =
                make_float2((float)r0, (float)r1);
          } else {
            const uint32_t pair = ((uint32_t)r0 & 0xFFu) | (((uint32_t)r1 & 0xFFu) << 8);
            reinterpret_cast<uint16_t*>(ob + row * ostride)[col >> 1] = (uint16_t)pair;
          }
        }
      }
      __syncwarp();
      // ---- 16 pixels x nv channels out, NHWC
      const int esz = f32 ? 4 : 1;
      uint8_t* outb = static_cast<uint8_t*>(a.out);
      if (vec && !f32 && nv == NCH) {  // a lane a half pixel
        const int px = lane >> 1, pi = mc * 16 + px;
        const int r = row_of(pi, inv_tc), lx = pi - r * a.tc;
        if (pi < tile_px && tl.oy0 + r < OH && tl.ox0 + lx < OW) {
          const size_t pg = ((size_t)tl.img * OH + tl.oy0 + r) * OW + tl.ox0 + lx;
          const uint4 v = *reinterpret_cast<const uint4*>(ob + px * ostride + 4 * (lane & 1));
          *reinterpret_cast<uint4*>(outb + pg * a.cout + n0 + 16 * (lane & 1)) = v;
        }
      } else if (vec) {
        const int per_px = nv * esz / 16;  // 16-byte pieces of a pixel
        for (int i = lane; i < 16 * per_px; i += 32) {
          const int px = i / per_px, piece = i % per_px;
          const int pi = mc * 16 + px;
          const int r = row_of(pi, inv_tc), lx = pi - r * a.tc;
          if (pi < tile_px && tl.oy0 + r < OH && tl.ox0 + lx < OW) {
            const size_t pg = ((size_t)tl.img * OH + tl.oy0 + r) * OW + tl.ox0 + lx;
            const uint4 v = *reinterpret_cast<const uint4*>(ob + px * ostride + 4 * piece);
            *reinterpret_cast<uint4*>(outb + (pg * a.cout + n0) * esz + 16 * piece) = v;
          }
        }
      } else {
        for (int i = lane; i < 16 * nv; i += 32) {
          const int px = i / nv, co = i % nv;
          const int pi = mc * 16 + px;
          const int r = row_of(pi, inv_tc), lx = pi - r * a.tc;
          if (pi < tile_px && tl.oy0 + r < OH && tl.ox0 + lx < OW) {
            const size_t pg = ((size_t)tl.img * OH + tl.oy0 + r) * OW + tl.ox0 + lx;
            if (f32)
              reinterpret_cast<float*>(a.out)[pg * a.cout + n0 + co] =
                  reinterpret_cast<const float*>(ob + px * ostride)[co];
            else
              outb[pg * a.cout + n0 + co] = reinterpret_cast<const uint8_t*>(ob + px * ostride)[co];
          }
        }
      }
      __syncwarp();
    }
    // the next iteration's first barrier orders this tile's reads of the
    // band, s_w, M and B before their next writes
  }
  cp_async_wait<0>();
}

template <int NKS>
int launch(const StemArgs& a, int bytes, long long tiles, cudaStream_t s) {
  static int opted = 0;
  if (bytes > 48 * 1024 && opted < bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        stem_qconv_kernel<NKS>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    opted = 227 * 1024;
  }
  // persistent: as many blocks as fit on the card at once, at most one a tile
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_qconv_kernel<NKS>, THREADS, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  stem_qconv_kernel<NKS><<<(unsigned)grid, THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one block (bytes) for this geometry; the wrapper mirrors it.
extern "C" int stem_qconv_smem_bytes(int c, int k, int tr, int tc, int f32) {
  const int nks = (c * k * ((k + 3) / 4) + 7) / 8;
  return Layout(c, k, tr, tc, nks, f32 != 0).total_bytes();
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes, dtypes and contiguity.
extern "C" int stem_qconv_launch(const StemArgs* args, void* stream) {
  const StemArgs& a = *args;
  if (a.n < 1 || a.c < 1 || a.c > MAX_C || a.k < 1 || a.k > MAX_K || a.h < 2 || a.w_in < 2 ||
      a.h % 2 || a.w_in % 2 || a.cout < 1 || a.tr < 1 || a.tc < 1 || a.kp < a.c * a.k * a.k ||
      a.ce < a.cout + (a.w_corr != 0) || !(a.out_kind >= OUT_S8 && a.out_kind <= OUT_F32))
    return (int)cudaErrorInvalidValue;
  const int nks = (a.c * a.k * ((a.k + 3) / 4) + 7) / 8;
  const int bytes = Layout(a.c, a.k, a.tr, a.tc, nks, a.out_kind == OUT_F32).total_bytes();
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int OH = a.h / 2, OW = a.w_in / 2;
  const long long tiles = (long long)a.n * ((OH + a.tr - 1) / a.tr) * ((OW + a.tc - 1) / a.tc) *
                          ((a.cout + NCH - 1) / NCH);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (nks) {
    case 1: return launch<1>(a, bytes, tiles, s);
    case 2: return launch<2>(a, bytes, tiles, s);
    case 3: return launch<3>(a, bytes, tiles, s);
    case 4: return launch<4>(a, bytes, tiles, s);
    case 5: return launch<5>(a, bytes, tiles, s);
    case 6: return launch<6>(a, bytes, tiles, s);
    case 7: return launch<7>(a, bytes, tiles, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
