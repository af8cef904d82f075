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
// tensor-core mapping (nothing is summed across channels), and as scalar
// int32 IMADs (64 a clock and SM) the multiply-adds alone would take as
// long as the bytes, before the byte unpacking and the epilogue (about 10
// instructions an output). What the design does about it:
//   - A block owns an output tile: BH = nrs*RPT rows x BW = ncs*TW columns x
//     a group of cgw channel words (4 channels a word). It stages the input
//     window with its halo in shared memory once, by 16-byte cp.async copies
//     where C % 16 == 0 (4-byte, or bytes, for a ragged C), writing zp_in
//     itself wherever the window leaves the image; its taps, M and B once.
//     Each input byte thus crosses from L2 to the SM once per block (plus
//     the halo), and the tile choice (pick_dw_tile in ops/cuda/dw_conv.py, a
//     pure function of the shape) keeps 2+ blocks an SM from 160x160x32 down
//     to 7x7x1024.
//   - A thread owns one channel word, TW neighbouring output columns and RPT
//     output rows, and walks down them keeping the last k input rows in
//     registers: each input word leaves shared memory about k/s times.
//   - The products are packed integer dots: __byte_perm pairs one channel's
//     bytes at two neighbouring columns, and __dp2a_lo/__dp2a_hi multiply
//     them with two int16 taps of that channel (int16 takes the uint8 graph's
//     +-255 taps). A row of k taps takes (k+1)/2 dp2a a channel; the pairings
//     of a column pair are shared by the thread's TW outputs (at stride 1 the
//     odd outputs use the taps shifted by one, a second set of tap pairs).
//     uint8 input is re-centred to int8 by a byte XOR 0x80 and the exact
//     128 * sum(taps) is added back to every sum.
//   - A block is persistent: it walks its tiles and stages the next tile's
//     window (a second buffer) while it computes the current one.
//   - Each thread stores its outputs from registers, 4 bytes (one channel
//     word) at a time; a warp's lanes hold neighbouring words, so a store
//     fills whole 32-byte sectors.
//   - The epilogue folds the activation clamp and the output clip into one
//     clamp before an exact round-half-away (lo, hi and zp_out are integers,
//     so clipping before the rounding equals clipping after it), and packs
//     the 4 bytes with byte permutes.
// Columns of the shared window are padded by one word every PIN columns so
// that a warp's column slots fall on distinct banks.
//
// The epilogue is f32 without contraction (--fmad=false in the build, and
// explicit __fmul_rn/__fadd_rn); the clamp thresholds arrive as f32 values
// that the host computed in double.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

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
  int cgw, ncs, nrs, rpt;  // tile: channel words, column slots, row strips, rows a thread walks
  int mode;            // copy width: 16 (C % 16 == 0), 4 (C % 4 == 0) or 1 byte
  float act_lo, act_hi, zp_out, lo, hi;
};

namespace {

using namespace mma_s8;

constexpr int MAX_THREADS = 256;

// Per (k, stride): output columns a thread owns (TW); RPT, the output rows it
// walks, is 8 or 2 for k = 3 (2 at stride 2 and where the output is at most
// 8 rows tall, so that more threads share a small image) and 4 for k = 5.
// Mirrored by THREAD_TILE in ops/cuda/dw_conv.py.
template <int K, int S, int R>
struct Geo {
  static constexpr int TW = K == 3 ? (S == 1 ? 4 : 2) : 1;
  static constexpr int RPT = R;
  static constexpr int NP = (K + 1) / 2;                      // tap pairs of a row
  static constexpr int NPAIRS = ((TW - 1) * S) / 2 + NP;      // column pairs a thread reads
  static constexpr int POS = 2 * NPAIRS;                      // input columns a thread reads
  static constexpr int NVAR = (S == 1 && TW > 1) ? 2 : 1;     // tap-pair phases
  static constexpr int IN_ROWS = (RPT - 1) * S + K;           // input rows of a strip
  // bank padding: one word every PIN input columns
  static constexpr int PIN = TW * S >= 2 ? TW * S : 4;
};

// column col of a tile whose columns are padded by one every `period`
__host__ __device__ __forceinline__ int padc(int col, int period) { return col + col / period; }

__host__ __device__ __forceinline__ int round4(int words) { return (words + 3) & ~3; }

// Shared-memory layout of a block, in 32-bit words (mirrored by
// dw_smem_bytes in ops/cuda/dw_conv.py): two input windows (the tile being
// computed and the next one arriving), M and B, the taps.
struct Layout {
  int bw, bh, cols_in, rows_in, pcols_in;
  int in_words, mb_words, tap_words;
  __host__ __device__ Layout(int k, int s, int tw, int rpt, int pos, int pin, int cgw, int ncs,
                             int nrs) {
    bw = ncs * tw;
    bh = nrs * rpt;
    cols_in = (ncs - 1) * tw * s + pos;
    rows_in = (bh - 1) * s + k;
    pcols_in = padc(cols_in - 1, pin) + 1;
    in_words = round4(rows_in * pcols_in * cgw);
    mb_words = 8 * cgw;              // M and B, 4 channels a word each
    tap_words = round4(k * k * cgw * 2);  // int16 taps, 4 channels a word
  }
  __host__ __device__ int total_bytes() const {
    return 4 * (2 * in_words + mb_words + tap_words);
  }
};

// C's round(): half away from zero, as an integer, for |q| < 2^22: adding
// the float just below 0.5 (with q's sign) and truncating (the one value
// that q + 0.5 would get wrong, 0.49999997, stays below 1).
__device__ __forceinline__ int round_away_small(float q) {
  return __float2int_rz(__fadd_rn(q, copysignf(0.49999997f, q)));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// j / d for small non-negative j (< 2^16) and d (<= 2^10), inv = 1.0f / d:
// the fraction of (j + 0.5) / d stays at least 1 / (2 d) from an integer, far
// above the float product's error
__device__ __forceinline__ int fdiv(int j, float inv) {
  return __float2int_rz(__fmul_rn(__int2float_rn(j) + 0.5f, inv));
}

// A tile: its channel group, image and output corner.
struct Tile {
  int cg, img, oy0, ox0;
};

__device__ __forceinline__ Tile tile_of(int t, int ctiles, int rtiles, int n, const Layout& L) {
  Tile r;
  r.ox0 = (t % ctiles) * L.bw;
  t /= ctiles;
  r.oy0 = (t % rtiles) * L.bh;
  t /= rtiles;
  r.img = t % n;
  r.cg = t / n;
  return r;
}

// Stage one tile's input window (zp_in outside the image) into `dst`: cp.async
// where the bytes are in the image, plain stores of zp_in elsewhere.
template <int PIN>
__device__ __forceinline__ void stage(const DwArgs& a, const Layout& L, const Tile& t,
                                      uint32_t* s_in, int iy0, int ix0) {
  const int cgw = a.cgw, cwords = (a.c + 3) >> 2, w0 = t.cg * cgw;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const uint32_t zp4 = (uint32_t)(a.zp_in & 0xFF) * 0x01010101u;
  const uint8_t* xb = static_cast<const uint8_t*>(a.x) + (size_t)t.img * a.h * a.w_in * a.c;
  if (a.mode == 16) {
    const int cq = cgw >> 2, per_row = L.cols_in * cq;
    const float inv_row = 1.0f / (float)per_row, inv_cq = 1.0f / (float)cq;
    const int total = L.rows_in * per_row;
    for (int i = tid; i < total; i += nthreads) {
      const int row = fdiv(i, inv_row), rc = i - row * per_row;
      const int col = fdiv(rc, inv_cq), q = rc - col * cq;
      const int iy = iy0 + row, ix = ix0 + col, wq = w0 + 4 * q;
      const uint32_t dst = smem_u32(s_in + (row * L.pcols_in + padc(col, PIN)) * cgw + 4 * q);
      if (iy >= 0 && iy < a.h && ix >= 0 && ix < a.w_in && wq < cwords)
        cp_async16(dst, xb + ((size_t)iy * a.w_in + ix) * a.c + 4 * wq, 16);
      else
        st_shared_v4(dst, zp4, zp4, zp4, zp4);
    }
  } else {
    const int per_row = L.cols_in * cgw;
    const float inv_row = 1.0f / (float)per_row, inv_cgw = 1.0f / (float)cgw;
    const int total = L.rows_in * per_row;
    for (int i = tid; i < total; i += nthreads) {
      const int row = fdiv(i, inv_row), rc = i - row * per_row;
      const int col = fdiv(rc, inv_cgw), wi = rc - col * cgw;
      const int iy = iy0 + row, ix = ix0 + col, ch = 4 * (w0 + wi);
      uint32_t* dst = s_in + (row * L.pcols_in + padc(col, PIN)) * cgw + wi;
      const bool in = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w_in;
      if (!in || ch >= a.c) {
        *dst = zp4;
      } else {
        const uint8_t* p = xb + ((size_t)iy * a.w_in + ix) * a.c + ch;
        if (a.mode == 4) {
          cp_async_small<4>(smem_u32(dst), p, 4);
        } else {  // a ragged C: the bytes beyond it are never stored
          uint32_t v = 0u;
          for (int b = 0; b < 4 && ch + b < a.c; ++b) v |= (uint32_t)p[b] << (8 * b);
          *dst = v;
        }
      }
    }
  }
}

// Persistent: a block walks the tiles blockIdx.x, + gridDim.x, ..., and
// stages the next tile's window while it computes the current one.
template <int K, int S, int R>
__global__ void __launch_bounds__(MAX_THREADS, 2) dw_qconv_kernel(const DwArgs a) {
  using G = Geo<K, S, R>;
  constexpr int TW = G::TW, RPT = G::RPT, NP = G::NP, NPAIRS = G::NPAIRS, POS = G::POS;
  constexpr int NVAR = G::NVAR, PIN = G::PIN;
  extern __shared__ __align__(16) uint32_t smem[];

  const int cgw = a.cgw, ncs = a.ncs;
  const Layout L(K, S, TW, RPT, POS, PIN, cgw, ncs, a.nrs);
  float* s_m = reinterpret_cast<float*>(smem + 2 * L.in_words);
  float* s_b = s_m + 4 * cgw;
  int16_t* s_tap = reinterpret_cast<int16_t*>(s_b + 4 * cgw);

  const int cwords = (a.c + 3) >> 2;
  const int ctiles = (a.ow + L.bw - 1) / L.bw, rtiles = (a.oh + L.bh - 1) / L.bh;
  const int ntiles = ctiles * rtiles * a.n * ((cwords + cgw - 1) / cgw);
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // ---- this thread: channel word wi, column slot cs, row strip rs
  const int wi = tid % cgw, t2 = tid / cgw;
  const int cs = t2 % ncs, rs = t2 / ncs;

  // The activation clamp [A, B] and the output clip [lo, hi] - zp_out in one
  // clamp: lo, hi and zp_out are integers, so clipping before the rounding
  // gives what clipping after it gives, and a clamp of a clamp is the clamp
  // onto [clamp(A, L, H), clamp(B, L, H)].
  const float cl = __fsub_rn(a.lo, a.zp_out), ch_ = __fsub_rn(a.hi, a.zp_out);
  float q_lo = cl, q_hi = ch_;
  if (a.act == 1) {
    q_lo = clampf(a.act_lo, cl, ch_);
    q_hi = clampf(a.act_hi, cl, ch_);
  } else if (a.act >= 0) {
    q_lo = clampf(0.0f, cl, ch_);
    if (a.act > 0) q_hi = clampf(a.act_hi, cl, ch_);
  }
  const int zpo = (int)a.zp_out;
  const uint32_t flip = a.x_u8 ? 0x80808080u : 0u;
  int coff[POS];  // word offsets of this thread's input columns
#pragma unroll
  for (int p = 0; p < POS; ++p) coff[p] = padc(cs * TW * S + p, PIN) * cgw + wi;

  // tap pairs: tp[ph][ky][j][ch] = (tap kx = 2j - ph, tap kx = 2j + 1 - ph),
  // zero outside 0..K-1; ph is the output's column phase at stride 1
  int tp[NVAR][K][NP][4];
  int corr[4];
  float m[4], bz[4];
  int cur_cg = -1;

  int t = blockIdx.x;
  if (t < ntiles) {
    const Tile tl = tile_of(t, ctiles, rtiles, a.n, L);
    stage<PIN>(a, L, tl, smem, tl.oy0 * S - a.pad_t, tl.ox0 * S - a.pad_l);
  }
  cp_async_commit();
  for (int buf = 0; t < ntiles; t += gridDim.x, buf ^= 1) {
    const Tile tl = tile_of(t, ctiles, rtiles, a.n, L);
    const bool new_cg = tl.cg != cur_cg;  // the same for the whole block
    if (new_cg) {  // this channel group's taps, M and B, once a block, as a group of copies
      const int c0 = 4 * tl.cg * cgw;
      const float inv_cgw = 1.0f / (float)cgw;
      for (int i = tid; i < K * K * cgw; i += nthreads) {  // 4 taps of a tap row a copy
        const int tap = fdiv(i, inv_cgw), wj = i - tap * cgw, ch = c0 + 4 * wj;
        cp_async_small<8>(smem_u32(s_tap + 4 * i), a.w + (size_t)tap * a.cp + (ch < a.cp ? ch : 0),
                          ch < a.cp ? 8 : 0);
      }
      for (int j = tid; j < cgw * 4; j += nthreads) {
        const bool ok = c0 + j < a.c;
        cp_async_small<4>(smem_u32(s_m + j), a.mult + (ok ? c0 + j : 0), ok ? 4 : 0);
        cp_async_small<4>(smem_u32(s_b + j), a.bias + (ok ? c0 + j : 0), ok ? 4 : 0);
      }
      cp_async_commit();
    }
    const int nt = t + gridDim.x;
    if (nt < ntiles) {
      const Tile tn = tile_of(nt, ctiles, rtiles, a.n, L);
      stage<PIN>(a, L, tn, smem + (buf ^ 1) * L.in_words, tn.oy0 * S - a.pad_t,
                 tn.ox0 * S - a.pad_l);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's window has landed
    __syncthreads();
    if (new_cg) {
      cur_cg = tl.cg;
      int tv[K][K][4];
#pragma unroll
      for (int ky = 0; ky < K; ++ky)
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const uint2 q = *reinterpret_cast<const uint2*>(s_tap + ((ky * K + kx) * cgw + wi) * 4);
          tv[ky][kx][0] = (int)(int16_t)(q.x & 0xFFFFu);
          tv[ky][kx][1] = (int)(int16_t)(q.x >> 16);
          tv[ky][kx][2] = (int)(int16_t)(q.y & 0xFFFFu);
          tv[ky][kx][3] = (int)(int16_t)(q.y >> 16);
        }
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        int sum = 0;
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx) sum += tv[ky][kx][ch];
#pragma unroll
          for (int ph = 0; ph < NVAR; ++ph)
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              const int ka = 2 * j - ph, kb = 2 * j + 1 - ph;
              const int ta = (ka >= 0 && ka < K) ? tv[ky][ka][ch] : 0;
              const int tb = (kb >= 0 && kb < K) ? tv[ky][kb][ch] : 0;
              tp[ph][ky][j][ch] = (int)(((uint32_t)ta & 0xFFFFu) | ((uint32_t)tb << 16));
            }
        }
        corr[ch] = a.x_u8 ? 128 * sum : 0;  // x = (x ^ 0x80) + 128 for uint8
      }
      const float4 mv = *reinterpret_cast<const float4*>(s_m + 4 * wi);
      const float4 bv = *reinterpret_cast<const float4*>(s_b + 4 * wi);
      m[0] = mv.x, m[1] = mv.y, m[2] = mv.z, m[3] = mv.w;
      bz[0] = bv.x, bz[1] = bv.y, bz[2] = bv.z, bz[3] = bv.w;
    }

    // ---- walk down the strip: input row ir feeds output rows (ir - ky) / S
    const uint32_t* src = smem + buf * L.in_words + (rs * RPT * S) * L.pcols_in * cgw;
    // this thread's outputs: 4 bytes of channels at (oy0 + rs*RPT + r, ox0 +
    // cs*TW + o); a warp's lanes hold neighbouring channel words, so each
    // store fills whole 32-byte sectors
    const int w0 = tl.cg * cgw, oyt = tl.oy0 + rs * RPT, oxt = tl.ox0 + cs * TW;
    const bool word_ok = w0 + wi < cwords;
    uint8_t* dst = static_cast<uint8_t*>(a.out) +
                   (((size_t)tl.img * a.oh + oyt) * a.ow + oxt) * a.c + 4 * (w0 + wi);
    int pairs[K][NPAIRS][2];
#pragma unroll
    for (int ir = 0; ir < G::IN_ROWS; ++ir) {
      const int slot = ir % K;
      const uint32_t* rowp = src + ir * L.pcols_in * cgw;
      uint32_t xw[POS];
#pragma unroll
      for (int p = 0; p < POS; ++p) xw[p] = rowp[coff[p]] ^ flip;
#pragma unroll
      for (int j = 0; j < NPAIRS; ++j) {
        // one channel's bytes at columns 2j and 2j+1: channels 0, 1 in lo,
        // channels 2, 3 in hi
        pairs[slot][j][0] = (int)__byte_perm(xw[2 * j], xw[2 * j + 1], 0x5140);
        pairs[slot][j][1] = (int)__byte_perm(xw[2 * j], xw[2 * j + 1], 0x7362);
      }
      if (ir >= K - 1 && (ir - (K - 1)) % S == 0) {
        const int r = (ir - (K - 1)) / S;
#pragma unroll
        for (int o = 0; o < TW; ++o) {
          const int p0 = o * S, ph = NVAR == 2 ? (p0 & 1) : 0, base = p0 >> 1;
          int acc[4] = {corr[0], corr[1], corr[2], corr[3]};
#pragma unroll
          for (int ky = 0; ky < K; ++ky) {
            const int sl = (r * S + ky) % K;
#pragma unroll
            for (int j = 0; j < NP; ++j) {
              acc[0] = __dp2a_lo(tp[ph][ky][j][0], pairs[sl][base + j][0], acc[0]);
              acc[1] = __dp2a_hi(tp[ph][ky][j][1], pairs[sl][base + j][0], acc[1]);
              acc[2] = __dp2a_lo(tp[ph][ky][j][2], pairs[sl][base + j][1], acc[2]);
              acc[3] = __dp2a_hi(tp[ph][ky][j][3], pairs[sl][base + j][1], acc[3]);
            }
          }
          int y[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float q =
                clampf(__fadd_rn(__fmul_rn(__int2float_rn(acc[b]), m[b]), bz[b]), q_lo, q_hi);
            y[b] = round_away_small(q) + zpo;
          }
          // the low bytes of y[0..3], in order
          const uint32_t packed = __byte_perm(__byte_perm(y[0], y[1], 0x0040),
                                              __byte_perm(y[2], y[3], 0x0040), 0x5410);
          if (word_ok && oyt + r < a.oh && oxt + o < a.ow) {
            uint8_t* p = dst + ((size_t)r * a.ow + o) * a.c;
            if (a.mode != 1) {
              *reinterpret_cast<uint32_t*>(p) = packed;
            } else {  // a ragged C: the bytes beyond it are not stored
              for (int b = 0; b < 4 && 4 * (w0 + wi) + b < a.c; ++b)
                p[b] = (uint8_t)(packed >> (8 * b));
            }
          }
        }
      }
    }
    __syncthreads();  // this window's last reads before the staging into it
  }
  cp_async_wait<0>();
}

template <int K, int S, int R>
Layout layout(int cgw, int ncs, int nrs) {
  using G = Geo<K, S, R>;
  return Layout(K, S, G::TW, G::RPT, G::POS, G::PIN, cgw, ncs, nrs);
}

template <int K, int S, int R>
int launch(const DwArgs& a, cudaStream_t s) {
  const Layout L = layout<K, S, R>(a.cgw, a.ncs, a.nrs);
  const int bytes = L.total_bytes();
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  static int opted = 0;  // the dynamic shared memory this instance may use
  if (bytes > 48 * 1024 && opted < bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_qconv_kernel<K, S, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    opted = 227 * 1024;
  }
  const int threads = a.cgw * a.ncs * a.nrs;
  const long long cwords = (a.c + 3) / 4;
  const long long tiles = (long long)a.n * ((a.oh + L.bh - 1) / L.bh) *
                          ((a.ow + L.bw - 1) / L.bw) * ((cwords + a.cgw - 1) / a.cgw);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
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
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dw_qconv_kernel<K, S, R>, threads, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  dw_qconv_kernel<K, S, R><<<(unsigned)grid, threads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int K, int S>
int launch_rpt(const DwArgs& a, cudaStream_t s) {
  if constexpr (K == 3) {
    if (a.rpt == 8) return launch<K, S, 8>(a, s);
    if (a.rpt == 2) return launch<K, S, 2>(a, s);
  } else {
    if (a.rpt == 4) return launch<K, S, 4>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int K, int S>
int smem_rpt(int rpt, int cgw, int ncs, int nrs) {
  if constexpr (K == 3) {
    if (rpt == 8) return layout<K, S, 8>(cgw, ncs, nrs).total_bytes();
    if (rpt == 2) return layout<K, S, 2>(cgw, ncs, nrs).total_bytes();
  } else {
    if (rpt == 4) return layout<K, S, 4>(cgw, ncs, nrs).total_bytes();
  }
  return -1;
}

}  // namespace

// Shared memory a block of this tile takes (bytes); the wrapper mirrors it.
extern "C" int dw_qconv_smem_bytes(int k, int stride, int cgw, int ncs, int nrs, int rpt) {
  if (k == 3 && stride == 1) return smem_rpt<3, 1>(rpt, cgw, ncs, nrs);
  if (k == 3 && stride == 2) return smem_rpt<3, 2>(rpt, cgw, ncs, nrs);
  if (k == 5 && stride == 1) return smem_rpt<5, 1>(rpt, cgw, ncs, nrs);
  if (k == 5 && stride == 2) return smem_rpt<5, 2>(rpt, cgw, ncs, nrs);
  return -1;
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes, dtypes and contiguity, picks the tile
// and the copy width (16: C % 16 == 0, cgw % 4 == 0, x and out 16-byte
// aligned; 4: C % 4 == 0, both 4-byte aligned); the taps are 8-byte aligned.
extern "C" int dw_qconv_launch(const DwArgs* args, void* stream) {
  const DwArgs& a = *args;
  const int threads = a.cgw * a.ncs * a.nrs;
  if (a.n < 1 || a.c < 1 || a.oh < 1 || a.ow < 1 || a.h < 1 || a.w_in < 1 || a.cp % 4 != 0 ||
      a.cp < a.c || a.cgw < 1 || a.ncs < 1 || a.nrs < 1 || threads > MAX_THREADS ||
      !(a.mode == 16 || a.mode == 4 || a.mode == 1) ||
      (a.mode == 16 && (a.c % 16 != 0 || a.cgw % 4 != 0)) || (a.mode == 4 && a.c % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a.k == 3 && a.stride == 1) return launch_rpt<3, 1>(a, s);
  if (a.k == 3 && a.stride == 2) return launch_rpt<3, 2>(a, s);
  if (a.k == 5 && a.stride == 1) return launch_rpt<5, 1>(a, s);
  if (a.k == 5 && a.stride == 2) return launch_rpt<5, 2>(a, s);
  return (int)cudaErrorInvalidValue;
}
