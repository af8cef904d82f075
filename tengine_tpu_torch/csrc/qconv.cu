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
//
// What bounds it on this card: operations for the k×k convs (yolov3-416
// batch 8 gives them 204 GMAC over 236 MB: about 0.2 ms at the 1,979 TOP/s
// int8 tensor-core rate against 0.07 ms of HBM traffic), bytes for the narrow
// pointwise convs. The design, for both:
//
//   - The product runs on the int8 tensor cores with int32 accumulators that
//     wrap (no .satfinite). Both operands are K-major as stored (NHWC input,
//     [C2, tap, Cp] weights), which is what the instructions take. Two
//     routes, one kernel body:
//       wgmma  warpgroup MMA m64n128k32 s8·s8, both operands read by the
//              tensor core straight from shared memory through descriptors,
//              asynchronous: one chunk's products run through the next
//              chunk's barrier and copies. For int8 input without a rowsum
//              term and the 128-channel tiles.
//       mma    mma.sync m16n8k32, fragments loaded with ldmatrix, each warp a
//              32×32 (or 64×32) part of the tile. Every case: uint8 input,
//              the rowsum, the narrow tiles.
//   - A block owns BM-pixel × BN-channel output tiles, the size chosen per
//     shape by the caller from TILES so that narrow C2 multiplies no masked
//     channels and small M still fills the card. The kernel is persistent:
//     the grid is what the card holds at once and block b walks tiles b,
//     b + grid, ... (a row band's column tiles adjacent, for the L2).
//   - The K loop walks taps × 64-channel chunks through a ring of four
//     shared-memory stages filled by cp.async (16 bytes a thread, the
//     implicit-GEMM gather computed per thread: per row once a tile an offset
//     and a bit mask of the taps inside the image, then an add and a bit test
//     per copy), one barrier per chunk. The loader runs up to three chunks
//     ahead and across tile boundaries, so the next tile's operands arrive
//     during a tile's epilogue. Rows are 64 bytes with their 16-byte chunks
//     XOR-swizzled by (row / 2) % 4: free of bank conflicts for the copies
//     and for ldmatrix, and exactly the tensor core's 64-byte swizzle mode. A
//     tap outside the image is zero-filled by the copy when zp_in is 0 and
//     written as zp_in bytes by a plain shared store otherwise; channels
//     beyond C read 0. An input whose C is a multiple of 8 or 4 only (and
//     aligned so) is copied in pieces of that size, still asynchronously; any
//     other goes through a scalar loader into the same layout. A chunk's second k32 step is skipped when it holds no channel.
//   - uint8 input stays raw in shared memory; the A fragment is XOR-ed with
//     0x80808080 in registers before the product. The rowsum (cw != 0) is one
//     more MMA of the raw fragment against a fragment of ones (u8·s8 for
//     uint8), which gives sum(raw) exactly; the re-centring comes off
//     afterwards in int32: rowsum(x') = rowsum(raw) - 128·kh·kw·C, pad taps
//     included since they hold the raw zp_in.
//   - The epilogue requantizes in the accumulators' own layout (M and B read
//     once per block into shared memory), with the activation clamp and the
//     output clip folded into one clamp before a three-instruction exact
//     rounding, and stages the tile as bytes in shared memory. It leaves row
//     by row, 16 bytes a thread on neighbouring addresses, the fused residual
//     read the same way and added on the way out. C2 that is no multiple of
//     16 falls to 4-byte, then to single-byte stores.
//
// The epilogue is f32 without contraction (-fmad=false in the build, and
// explicit __fmul_rn/__fadd_rn), as the Pallas epilogue rounds each
// product and sum separately; the clamp thresholds arrive as f32 values that
// the host computed in double.
//
// The fast tier's INT8 convs at zero point 0 (ops/cuda/qconv.py:qconv_fast)
// run the same mainloop with another epilogue: the f32 steps of the tier's
// qrequant (csrc/requant_steps.cuh, which csrc/requant.cu includes too) on
// each int32 accumulator, so that the output is the bytes the float64
// library conv and qrequant give, in one launch and with no float64 buffer.
// Its residual, where there is one, is staged into the output tile first,
// since the relaxed form adds it before the rounding. The steps' branches
// (activation, residual) are taken when the kernel is built (EPI), not
// between every two accumulators: left in, they made the kernel run 1.2-2.5x
// longer at yolov5s-640's shapes on an H100.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_s8.cuh"
#include "requant_steps.cuh"

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
  int bm, bn;  // the block's tile, one of TILES
  int wgmma;   // 1: the product by warpgroup MMA (int8 input, no rowsum, BN = 128)
  // 1: the fast tier's epilogue in place of the one above (int8 input,
  // zp_in 0, no rowsum; has_res 0, res read where steps.res_mode says)
  int fast;
  RequantSteps steps;  // its f32 steps (requant_steps.cuh); B[c] where steps.has_bias
};

namespace {

using namespace mma_s8;

constexpr int STAGES = 4;        // depth of the shared-memory ring
constexpr int BK = 64;           // K bytes per ring stage: two k32 MMA steps
constexpr int CHUNKS = BK / 16;  // 16-byte chunks per tile row
constexpr int OPAD = 16;         // byte padding of a staged output row

__host__ __device__ constexpr int stage_bytes(int bm, int bn) { return (bm + bn) * BK; }

// the ring, the staged output tile, then M and B of the tile's channels
__host__ __device__ constexpr int smem_bytes(int bm, int bn) {
  return STAGES * stage_bytes(bm, bn) + bm * (bn + OPAD) + 2 * bn * 4;
}

// Byte offset of 16-byte chunk `ch` of row `row` in a [rows][64 B] tile.
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return (uint32_t)(row * BK + ((ch ^ ((row >> 1) & 3)) << 4));
}

// C's round(): half away from zero; equal to roundf for every finite q
using requant_steps::round_away;

// The same for |q| < 2^22, as an integer: adding the float just below 0.5
// (with q's sign) and truncating. A tie k + 0.5 rounds up to k + 1 in the
// sum, and the one value that q + 0.5 itself would get wrong, 0.49999997,
// stays below 1 (tests/test_torch_igemm_edges.py walks every float).
__device__ __forceinline__ int round_away_small(float q) {
  return __float2int_rz(__fadd_rn(q, copysignf(0.49999997f, q)));
}

// bits [lo, hi) set; 0 <= lo, hi <= 16
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  return hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
}

using requant_steps::clip;

// accf*M + B, clamp, round: one output byte. [q_lo, q_hi] is the activation
// clamp and the output clip in one (see the kernel).
__device__ __forceinline__ uint32_t requant(float accf, float m, float b, float q_lo, float q_hi) {
  const float q = clip(__fadd_rn(__fmul_rn(accf, m), b), q_lo, q_hi);
  return (uint32_t)round_away_small(q) & 0xFFu;
}

// the fused residual on 4 packed bytes t (the conv's output) and r
__device__ __forceinline__ uint32_t add_residual(const QconvArgs& a, uint32_t t, uint32_t r) {
  uint32_t packed = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t tb = (t >> (8 * j)) & 0xFFu, rb = (r >> (8 * j)) & 0xFFu;
    const float tv = a.out_u8 ? (float)tb : (float)(int8_t)tb;
    const float rv = a.res_u8 ? (float)rb : (float)(int8_t)rb;
    const float tf = __fmul_rn(__fsub_rn(tv, a.zp_mid), a.s_mid);
    const float rf = __fmul_rn(__fsub_rn(rv, a.zp_r), a.s_r);
    float y = __fadd_rn(round_away(__fmul_rn(__fadd_rn(tf, rf), a.inv_s_out2)), a.zp_out2);
    if (a.relu2) y = fmaxf(y, a.zp_out2);
    packed |= ((uint32_t)(int)fminf(fmaxf(y, a.lo), a.hi) & 0xFFu) << (8 * j);
  }
  return packed;
}

// The epilogue a kernel is built with: the Pallas kernels' folds (the
// epilogue arguments of QconvArgs), or the fast tier's steps (args.steps)
// for any steps, for SiLU without a residual, or for any other activation
// without one (requant_steps::apply: the last two leave the branches out).
enum Epi { EPI_PALLAS, EPI_FAST, EPI_FAST_SILU, EPI_FAST_NOSILU };

template <int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS, bool ROWSUM, bool WGMMA, int EPI>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, MIN_BLOCKS)
    qconv_mma_kernel(const QconvArgs a, const int vec) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // the warp's tile
  constexpr int MI = WM / 16, NI = WN / 8;             // its m16 and n8 MMA tiles
  constexpr int ROWS_PER_PASS = THREADS / CHUNKS;
  constexpr int A_ITERS = BM / ROWS_PER_PASS, B_ITERS = BN / ROWS_PER_PASS;
  constexpr int SO = BN + OPAD;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  // a warpgroup's product is 64 rows (16 a warp) by all of BN = 128 columns
  static_assert(!WGMMA || (WM == 16 && WARPS_M % 4 == 0 && WARPS_N == 1 && BN == 128 && !ROWSUM),
                "warpgroup tile");
  constexpr bool FAST = EPI != EPI_PALLAS;
  static_assert(!FAST || !ROWSUM, "the fast epilogue takes int8 input");
  static_assert(A_ITERS >= 1 && B_ITERS >= 1 && BM % ROWS_PER_PASS == 0 &&
                BN % ROWS_PER_PASS == 0, "loader");
  // rows lr + i * ROWS_PER_PASS share (row / 2) % 4: one swizzled offset serves
  static_assert(ROWS_PER_PASS % 8 == 0, "swizzle period");

  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = smem_u32(smem);
  constexpr int S = STAGES;
  uint8_t* so = smem + S * stage_bytes(BM, BN);  // the staged output tile
  float* sm_mult = reinterpret_cast<float*>(so + BM * SO);
  float* sm_bias = sm_mult + BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int M = a.n * a.oh * a.ow;
  const int C = a.c, taps = a.kh * a.kw;
  const int tiles_n = (a.c2 + BN - 1) / BN;
  const int total = ((M + BM - 1) / BM) * tiles_n;  // tiles, a row band's columns adjacent
  const int n_chunks = taps * ((C + BK - 1) / BK);

  const uint8_t* xg = static_cast<const uint8_t*>(a.x);
  const int8_t* wg = static_cast<const int8_t*>(a.w);
  const uint32_t padb = (uint32_t)a.zp_in & 0xFFu;
  const uint32_t padw = padb * 0x01010101u;

  // The loader runs ahead of the MMAs by up to three chunks, across tile
  // boundaries: its tile and its place in it are its own. Role: 16-byte chunk
  // lc of tile rows lr, lr + ROWS_PER_PASS, ... Per row, once a tile: the byte
  // offset of its tap (0, 0) and one bit per ky and per kx that says whether
  // that tap lies inside the image; a stage's load then costs an add and a
  // bit test per copy.
  const int lc = tid % CHUNKS, lr = tid / CHUNKS;
  const uint32_t ld_dst = swz(lr, lc);
  long long a_off[A_ITERS], b_off[B_ITERS];
  uint32_t a_in[A_ITERS];  // bits 0..15: ky inside, bits 16..31: kx inside
  uint32_t b_ok = 0u;
  int ld_tile = blockIdx.x, ld_left = n_chunks, ld_slot = 0, ld_ky = 0, ld_kx = 0, ld_cb = 0;

  auto setup_loader = [&](int tile) {
    const int tm = tile / tiles_n, m0 = tm * BM, n0 = (tile - tm * tiles_n) * BN;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int gm = m0 + lr + i * ROWS_PER_PASS;
      a_off[i] = 0;
      a_in[i] = 0u;  // a row beyond M is never stored: let it read as padding
      if (gm < M) {
        int img = 0, oy = 0, ox = gm;
        if (a.n * a.oh != 1) {  // not a flat [M, K]: two divisions a row
          const int plane = a.oh * a.ow;
          img = gm / plane;
          const int r = gm - img * plane;
          oy = r / a.ow;
          ox = r - oy * a.ow;
        }
        const int iy0 = oy * a.stride - a.pad_t, ix0 = ox * a.stride - a.pad_l;
        a_off[i] = ((long long)img * a.h * a.w_in + (long long)iy0 * a.w_in + ix0) * C + lc * 16;
        a_in[i] = bit_range(max(0, -iy0), min(a.kh, a.h - iy0)) |
                  (bit_range(max(0, -ix0), min(a.kw, a.w_in - ix0)) << 16);
      }
    }
    b_ok = 0u;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int gn = n0 + lr + i * ROWS_PER_PASS;
      const bool ok = gn < a.c2;
      b_off[i] = (long long)(ok ? gn : 0) * taps * a.cstride + lc * 16;
      b_ok |= (ok ? 1u : 0u) << i;
    }
  };

  // chunk (tap ky, kx; channels cb..cb+63) of the loader's tile -> ring slot
  auto load_stage = [&](int slot, int ky, int kx, int cb) {
    const int left = C - cb;
    const int kneed = left >= BK ? BK : ((left + 31) & ~31);  // bytes the MMA steps read
    if (lc * 16 >= kneed) return;
    const uint32_t a_dst = ring + slot * stage_bytes(BM, BN) + ld_dst;
    const uint32_t b_dst = a_dst + BM * BK;
    const bool ch_ok = cb + lc * 16 < C;
    const long long tap_off = ((long long)ky * a.w_in + kx) * C + cb;
    const uint32_t tap_bits = (1u << ky) | (0x10000u << kx);
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const uint32_t dst = a_dst + i * ROWS_PER_PASS * BK;
      const bool inside = (a_in[i] & tap_bits) == tap_bits;
      const uint8_t* src = xg + (inside ? a_off[i] + tap_off : 0);
      if (vec == 16) {
        if (ch_ok && !inside && padw != 0u)
          st_shared_v4(dst, padw, padw, padw, padw);
        else
          cp_async16(dst, src, ch_ok && inside ? 16 : 0);
      } else if (vec == 8 || vec == 4) {
        // C is a multiple of 8 (or 4): the chunk in pieces of that size, each
        // wholly below C or wholly beyond, still copied asynchronously
#pragma unroll
        for (int b = 0; b < 16; b += 4) {
          if (vec == 8 && (b & 4)) continue;
          const bool ok = cb + lc * 16 + b < C;
          if (ok && !inside && padw != 0u) {
            st_shared_b32(dst + b, padw);
            if (vec == 8) st_shared_b32(dst + b + 4, padw);
          } else if (vec == 8) {
            cp_async_small<8>(dst + b, src + b, ok && inside ? 8 : 0);
          } else {
            cp_async_small<4>(dst + b, src + b, ok && inside ? 4 : 0);
          }
        }
      } else {
        uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (cb + lc * 16 + b < C) {
            const uint32_t v = inside ? (uint32_t)src[b] : padb;
            wd[b >> 2] |= v << (8 * (b & 3));
          }
        }
        st_shared_v4(dst, wd[0], wd[1], wd[2], wd[3]);
      }
    }
    const long long w_off = (long long)(ky * a.kw + kx) * a.cstride + cb;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i)
      cp_async16(b_dst + i * ROWS_PER_PASS * BK, wg + b_off[i] + w_off, (b_ok >> i) & 1u ? 16 : 0);
  };

  // one chunk into the ring (or nothing, past the block's last tile), one group
  auto push_chunk = [&]() {
    if (ld_tile < total) {
      load_stage(ld_slot, ld_ky, ld_kx, ld_cb);
      ld_cb += BK;
      if (ld_cb >= C) {
        ld_cb = 0;
        if (++ld_kx == a.kw) {
          ld_kx = 0;
          ++ld_ky;
        }
      }
      if (--ld_left == 0) {
        ld_tile += gridDim.x;
        ld_left = n_chunks;
        ld_ky = ld_kx = 0;
        if (ld_tile < total) setup_loader(ld_tile);
      }
    }
    cp_async_commit();
    ld_slot = ld_slot + 1 == S ? 0 : ld_slot + 1;
  };
  setup_loader(ld_tile);  // the grid holds no more blocks than there are tiles
  // The copies run S - 1 chunks ahead of the mma.sync products. The
  // warpgroup products are asynchronous too: one chunk's may still read its
  // slot while the next is started, so there the copies run S - 2 ahead.
  constexpr int LAG = WGMMA ? 2 : 1;
  for (int s = 0; s < S - LAG; ++s) push_chunk();

  // ldmatrix row and chunk of this lane (mma_s8.cuh): A rows lane % 16, k half
  // lane / 16; B rows lane % 8 + 8 * (lane / 16), k half (lane / 8) % 2
  const int a_row = wm0 + (lane & 15), a_kc = lane >> 4;
  const int b_row = wn0 + (lane & 7) + ((lane >> 4) << 3), b_kc = (lane >> 3) & 1;
  const int g = lane >> 2, tg = lane & 3;
  const uint32_t flip = a.x_u8 ? 0x80808080u : 0u;
  const int rs_off = a.x_u8 ? 128 * taps * C : 0;  // rowsum(x') = rowsum(raw) - 128·K
  const float cwf = (float)a.cw;
  // The activation clamp [A, B] and the output clip [lo, hi] in one clamp:
  // lo and hi are integers, so clipping before the rounding gives what
  // clipping after it gives, and a clamp of a clamp is the clamp onto
  // [clamp(A, lo, hi), clamp(B, lo, hi)].
  float q_lo = a.lo, q_hi = a.hi;
  if (a.act == 1) {
    q_lo = clip(a.act_lo, a.lo, a.hi);
    q_hi = clip(a.act_hi, a.lo, a.hi);
  } else if (a.act >= 0) {
    q_lo = clip(a.zp_out, a.lo, a.hi);
    if (a.act > 0) q_hi = clip(a.act_hi, a.lo, a.hi);
  }
  // the widest store every row of the output (and of the residual) allows
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.out) | reinterpret_cast<uintptr_t>(a.res) |
                          (uintptr_t)a.c2;
  const int width = (align & 15) == 0 ? 16 : (align & 3) == 0 ? 4 : 1;
  const uint8_t* resg = static_cast<const uint8_t*>(a.res);
  uint8_t* outg = static_cast<uint8_t*>(a.out);
  // f(r, c, at, bytes) for the pieces of a tile's rows inside the output,
  // `width` neighbouring bytes a thread: tile row r, column c, output offset at
  auto stage_rows = [&](int m0, int n0, auto&& f) {
    auto rows = [&](auto bytes) {
      constexpr int B = decltype(bytes)::value, PER_ROW = BN / B;
      for (int item = tid; item < BM * PER_ROW; item += THREADS) {
        const int r = item / PER_ROW, c = (item - r * PER_ROW) * B;
        if (m0 + r >= M || n0 + c >= a.c2) continue;
        f(r, c, (size_t)(m0 + r) * a.c2 + n0 + c, B);
      }
    };
    if (width == 16)
      rows(std::integral_constant<int, 16>{});
    else if (width == 4)
      rows(std::integral_constant<int, 4>{});
    else
      rows(std::integral_constant<int, 1>{});
  };

  int slot = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int tm = tile / tiles_n, m0 = tm * BM, n0 = (tile - tm * tiles_n) * BN;
    // M and B of this tile's channels: every thread is past the last tile's
    // reads of them, and the chunk barriers below come before the next
    for (int j = tid; j < BN; j += THREADS) {
      const bool ok = n0 + j < a.c2;
      sm_mult[j] = ok ? a.mult[n0 + j] : 0.0f;
      sm_bias[j] = ok && a.bias != nullptr ? a.bias[n0 + j] : 0.0f;
    }
    int acc[MI][NI][4];
    int rs[MI][4];  // every warp sums its own rows: no exchange, no barrier
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int q = 0; q < 4; ++q) rs[mi][q] = 0;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;
    }

    int cb = 0;
    for (int t = 0; t < n_chunks; ++t) {
      cp_async_wait<S - 1 - LAG>();
      if (WGMMA) wgmma_wait<1>();  // this warpgroup's products have read the chunk before last
      __syncthreads();  // this chunk has landed; every warp is done with the one before
      const uint32_t a_src = ring + slot * stage_bytes(BM, BN);
      const uint32_t b_src = a_src + BM * BK;
      const int ksteps = (C - cb > 32) ? 2 : 1;
      if constexpr (WGMMA) {
        // The tensor core reads both operands from the ring as they lie:
        // the rows' swizzle is its 64-byte mode. The products run while this
        // thread starts the next copies, through the next chunk's barrier.
        int(&d)[64] = reinterpret_cast<int(&)[64]>(acc);
        fence_proxy_async();
        wgmma_fence();
        const uint32_t a_wg = a_src + (warp >> 2) * 64 * BK;
        for (int ks = 0; ks < ksteps; ++ks)
          wgmma_m64n128k32_s8s8(d, gmma_desc_k64(a_wg + ks * 32), gmma_desc_k64(b_src + ks * 32));
        wgmma_commit();
      }
      push_chunk();  // refills the slot of the chunk before (before last: warpgroup products)
#pragma unroll
      for (int ks = 0; ks < (WGMMA ? 0 : 2); ++ks) {
        if (ks >= ksteps) break;
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(af[mi], a_src + swz(a_row + mi * 16, ks * 2 + a_kc));
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(r, b_src + swz(b_row + nj * 16, ks * 2 + b_kc));
          bf[2 * nj][0] = r[0];
          bf[2 * nj][1] = r[1];
          bf[2 * nj + 1][0] = r[2];
          bf[2 * nj + 1][1] = r[3];
        }
        if (ROWSUM) {
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            if (a.x_u8)
              mma_u8s8(rs[mi], af[mi], 0x01010101u, 0x01010101u);
            else
              mma_s8s8(rs[mi], af[mi], 0x01010101u, 0x01010101u);
          }
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
          for (int q = 0; q < 4; ++q) af[mi][q] ^= flip;
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_s8s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
        }
      }
      slot = slot + 1 == S ? 0 : slot + 1;
      cb += BK;
      if (cb >= C) cb = 0;
    }
    if constexpr (WGMMA) {
      wgmma_wait<0>();
      fence_registers(reinterpret_cast<int(&)[64]>(acc));
    }

    // Epilogue, while the loader's copies for the next tile are in flight.
    // In the fast mode a fused residual comes first: its tile is staged
    // where the output tile will be, so that each accumulator's requant reads
    // its byte there and its output byte takes the byte's place.
    const bool res_in = FAST && a.steps.res_mode != 0;
    if (res_in) {
      stage_rows(m0, n0, [&](int r, int c, size_t at, int bytes) {
        if (bytes == 16)
          *reinterpret_cast<uint4*>(&so[r * SO + c]) = *reinterpret_cast<const uint4*>(resg + at);
        else if (bytes == 4)
          *reinterpret_cast<uint32_t*>(&so[r * SO + c]) = *reinterpret_cast<const uint32_t*>(resg + at);
        else
          so[r * SO + c] = resg[at];
      });
      __syncthreads();
    }
    // Each thread requantizes its own accumulators. It holds columns 2tg,
    // 2tg+1 of rows g and g+8 of every m16 x n8 tile; lanes tg and tg^1 swap
    // a pair so that the even one stores 4 bytes of row g and the odd one 4
    // bytes of row g+8 into the staged tile (a lane's residual bytes are read
    // before the swap, so no byte is overwritten before it is read).
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      float rsf[2] = {0.0f, 0.0f};
      if (ROWSUM) {
        rsf[0] = __fmul_rn(cwf, __int2float_rn(rs[mi][0] - rs_off));
        rsf[1] = __fmul_rn(cwf, __int2float_rn(rs[mi][2] - rs_off));
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = wn0 + ni * 8 + tg * 2;
        const float2 m2 = *reinterpret_cast<const float2*>(&sm_mult[col]);
        const float2 b2 = *reinterpret_cast<const float2*>(&sm_bias[col]);
        uint32_t pair[2];
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          float f0 = __int2float_rn(acc[mi][ni][2 * hv]), f1 = __int2float_rn(acc[mi][ni][2 * hv + 1]);
          if constexpr (FAST) {
            uint32_t rr = 0u;
            if (res_in) rr = *reinterpret_cast<const uint16_t*>(&so[(wm0 + mi * 16 + g + 8 * hv) * SO + col]);
            constexpr int SILU = EPI == EPI_FAST_SILU ? 1 : EPI == EPI_FAST_NOSILU ? 0 : -1;
            constexpr int RES = EPI == EPI_FAST ? -1 : 0;
            const float y0 = requant_steps::apply<SILU, RES>(a.steps, f0, m2.x, b2.x, 0.0f, rr);
            const float y1 = requant_steps::apply<SILU, RES>(a.steps, f1, m2.y, b2.y, 0.0f, rr >> 8);
            pair[hv] = ((uint32_t)__float2int_rn(y0) & 0xFFu) | (((uint32_t)__float2int_rn(y1) & 0xFFu) << 8);
          } else {
            if (ROWSUM) {
              f0 = __fadd_rn(f0, rsf[hv]);
              f1 = __fadd_rn(f1, rsf[hv]);
            }
            pair[hv] = requant(f0, m2.x, b2.x, q_lo, q_hi) | (requant(f1, m2.y, b2.y, q_lo, q_hi) << 8);
          }
        }
        const uint32_t got = __shfl_xor_sync(0xFFFFFFFFu, (tg & 1) ? pair[0] : pair[1], 1);
        const uint32_t word = (tg & 1) ? (got | (pair[1] << 16)) : (pair[0] | (got << 16));
        const int row = wm0 + mi * 16 + g + ((tg & 1) << 3);
        *reinterpret_cast<uint32_t*>(&so[row * SO + wn0 + ni * 8 + ((tg >> 1) << 2)]) = word;
      }
    }
    __syncthreads();
    // Then the tile goes out row by row, 16 (or 4, or 1) neighbouring bytes a
    // thread, the Pallas epilogue's fused residual read the same way and
    // added on the way.
    const bool res_out = !FAST && a.has_res;
    stage_rows(m0, n0, [&](int r, int c, size_t at, int bytes) {
      if (bytes == 16) {
        uint4 t = *reinterpret_cast<const uint4*>(&so[r * SO + c]);
        if (res_out) {
          const uint4 rr = *reinterpret_cast<const uint4*>(resg + at);
          t.x = add_residual(a, t.x, rr.x);
          t.y = add_residual(a, t.y, rr.y);
          t.z = add_residual(a, t.z, rr.z);
          t.w = add_residual(a, t.w, rr.w);
        }
        *reinterpret_cast<uint4*>(outg + at) = t;
      } else if (bytes == 4) {
        uint32_t t = *reinterpret_cast<const uint32_t*>(&so[r * SO + c]);
        if (res_out) t = add_residual(a, t, *reinterpret_cast<const uint32_t*>(resg + at));
        *reinterpret_cast<uint32_t*>(outg + at) = t;
      } else {
        uint32_t t = so[r * SO + c];
        if (res_out) t = add_residual(a, t, resg[at]);
        outg[at] = (uint8_t)t;
      }
    });
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS, bool ROWSUM, bool WGMMA = false,
          int EPI = EPI_PALLAS>
int launch_kernel(const QconvArgs& a, int vec, cudaStream_t s) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  auto kernel = qconv_mma_kernel<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, ROWSUM, WGMMA, EPI>;
  // Once per kernel: above 48 KB of dynamic shared memory it has to opt in,
  // and the persistent grid is as many blocks as the card holds. A refusal
  // comes back as the error.
  static int resident = 0;
  static cudaError_t ready = [&]() {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(BM, BN));
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem_bytes(BM, BN));
    resident = per_sm * sms;
    return e;
  }();
  if (ready != cudaSuccess) return (int)ready;
  if (resident < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long M = (long long)a.n * a.oh * a.ow;
  const long long tiles = ((M + BM - 1) / BM) * ((a.c2 + BN - 1) / BN);
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  kernel<<<grid, THREADS, smem_bytes(BM, BN), s>>>(a, vec);
  return (int)cudaGetLastError();
}

// The fast epilogue's kernel for these steps, on the warpgroup route or not.
template <int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS, bool WGMMA>
int launch_fast(const QconvArgs& a, int vec, cudaStream_t s) {
  if (a.steps.res_mode != 0)
    return launch_kernel<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, false, WGMMA, EPI_FAST>(a, vec, s);
  if (a.steps.act == 100)
    return launch_kernel<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, false, WGMMA, EPI_FAST_SILU>(a, vec, s);
  return launch_kernel<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, false, WGMMA, EPI_FAST_NOSILU>(a, vec, s);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS>
int launch_tile(const QconvArgs& a, int vec, cudaStream_t s) {
  if (a.fast && (a.cw != 0 || a.x_u8 || a.zp_in != 0 || a.has_res)) return (int)cudaErrorInvalidValue;
  if constexpr (BN == 128) {  // one warpgroup for every 64 rows
    if (a.wgmma) {
      if (a.cw != 0 || a.x_u8) return (int)cudaErrorInvalidValue;
      if (a.fast) return launch_fast<BM, BN, BM / 16, 1, MIN_BLOCKS, true>(a, vec, s);
      return launch_kernel<BM, BN, BM / 16, 1, MIN_BLOCKS, false, true>(a, vec, s);
    }
  } else if (a.wgmma) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.fast) return launch_fast<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, false>(a, vec, s);
  if (a.cw != 0) return launch_kernel<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, true>(a, vec, s);
  return launch_kernel<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, false>(a, vec, s);
}

}  // namespace

// Launch on `stream`; returns the CUDA error of the launch (0 on success).
// The caller checks shapes, dtypes, contiguity and alignment: the weights
// are 16-byte aligned; vec (16, 8, 4 or 0) says that C is a multiple of it
// and the input aligned to it; the input holds fewer than 2^31 bytes. args->bm, bn name one of TILES (BM, BN):
//   (128, 128) (64, 128) (128, 64) (64, 64) (128, 32) (64, 32)
// and args->wgmma asks for the warpgroup route (BN = 128, int8 input, cw = 0).
extern "C" int qconv_igemm_launch(const QconvArgs* args, int vec, void* stream) {
  const QconvArgs& a = *args;
  if (a.n < 1 || a.c < 1 || a.c2 < 1 || a.kh < 1 || a.kw < 1 || a.stride < 1 ||
      a.kh > 16 || a.kw > 16 || a.cstride % 32 != 0 || a.cstride < a.c)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)a.n * a.oh * a.ow;
  if (M < 1 || M > 0x7FFFFFFFLL - 256) return (int)cudaErrorInvalidValue;
  if ((long long)a.n * a.h * a.w_in * a.c > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (a.bm * 1000 + a.bn) {
    case 128128: return launch_tile<128, 128, 2, 4, 2>(a, vec, s);
    case 128064: return launch_tile<128, 64, 4, 2, 2>(a, vec, s);
    case 128032: return launch_tile<128, 32, 4, 1, 4>(a, vec, s);
    case 64128: return launch_tile<64, 128, 2, 4, 2>(a, vec, s);
    case 64064: return launch_tile<64, 64, 2, 2, 4>(a, vec, s);
    case 64032: return launch_tile<64, 32, 2, 1, 8>(a, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
