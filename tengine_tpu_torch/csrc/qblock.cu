// A chain of fused int8 ResNet bottlenecks in one launch, for Hopper
// (sm_90a): the port of the Pallas TPU kernel
// tengine_tpu/ops/pallas/qblock.py: qblock_chain. ops/cuda/qblock.py holds
// the arithmetic contract and the plain PyTorch version.
//
//   q1 = requant(x·w1)                    1×1, K = c_in, on the tile + 1-pixel halo
//   q2 = requant(conv3×3(q1, w2))         stride 1, pad 1; q1 = 0 outside the image
//   t  = q2·w3,  r = x·w4 or x            1×1 convs, projection or identity residual
//   y  = exact or relaxed residual epilogue, int8 out
//
// What the design keeps from the TPU kernel is what it keeps out of device
// memory: q1, q2, t and r never leave the SM. A thread block owns a spatial
// tile of one image (8×8, 7×7 or 4×4 output pixels). It computes conv1 on
// the tile plus a one-pixel halo (recomputing the halo that neighbouring
// tiles also compute) and keeps q1 in shared memory as k-major 4-byte
// words, forced to 0 where the halo leaves the image: that is the 3×3's
// zero padding, where requant(0) would give round(B1). conv2 reads its nine
// taps straight out of that buffer and leaves q2 in shared memory the same
// way; conv3 reads q2 from there, the projection streams x from device
// memory again, and the residual epilogue runs on the two int32 register
// tiles. The widest block (c_in 2048, c_mid 512) cannot hold a tile's x in
// shared memory, so every K loop over x streams it in 64-byte chunks.
//
// The chain is one persistent cooperative launch: as many thread blocks as
// the card holds at once walk over the tiles of bottleneck b, meet at a
// grid-wide barrier, and go on to bottleneck b + 1, whose 3×3 halo needs
// its neighbours' outputs. A bottleneck's output passes to the next through
// a device buffer of its own (written once, read after the barrier, so it
// stays in L2 at ResNet's sizes and no SM holds a stale line of it).
//
// The products run on the int8 tensor cores: mma.sync m16n8k32 s8·s8 with
// int32 accumulators (exact, as the plain version's sums are). The block's
// 8 warps tile each GEMM's BM rows × BN columns: 64 × 128 in 2 × 4 warps of
// 32 × 32, 64 × 64 where c_mid <= 64, 16 × 256 for the 4×4 tiles. A warp
// whose rows or columns all lie past the GEMM's skips it; the others run
// every fragment, so the product loop has no branch per fragment and loads
// a k-step's fragments before its MMAs. The operands are already in the
// instruction's shape: 32 bytes of K are 8 k-words, one m16n8k32 step, and
// the fragment registers are words (mma_s8.cuh): lane (g, t) takes words t
// and t + 4 of rows g and g + 8. So conv2's A fragment is four 32-bit
// shared loads at q1s[(k-word + t [+4])·hpp + the row's halo pixel + the
// tap's offset], conv3's the same out of q2s, with no repacking. Weight
// chunks of 64 bytes of K (and, for conv1 and the projection, x's rows)
// stream from L2 through a ring of four stages filled by cp.async, rows 80
// bytes apart so that the fragment loads of 8 rows hit 32 distinct banks;
// the row strides of q1s and q2s are padded to 8 mod 16 words for the same
// reason.
//
// The epilogues requantize in the accumulators' layout (c0, c1: row g,
// columns 2t, 2t + 1; c2, c3: row g + 8), and neighbouring lanes swap a half
// so that each holds one 4-channel word. M and B of the whole bottleneck
// are read into shared memory once per bottleneck. A column pass of the
// block's output is staged in shared memory: the identity residual's bytes
// arrive there by cp.async with the pass's first chunk, each lane pair
// overwrites the bytes it read with its words, and the tile leaves row by
// row in 16-byte stores (read and written fragment by fragment, a warp's
// accesses touched 16 rows each, and the L1 took most of the epilogue's
// time over them). The tier and the head are template parameters of that
// epilogue and the activations are clamps, so no element waits behind a
// branch.
//
// What bounds it on this card: not the operations (a ResNet-50 bottleneck
// does 1,100 to 2,300 multiply-adds per activation byte moved). The product
// loop is held by the 32-bit shared loads that feed mma.sync (two per
// k-word and fragment), one barrier per 64-byte chunk with 8 warps on an SM
// at the late stages, and the ring's restart at each GEMM; every tile
// re-reads the block's weights from L2 (0.07 to 4.3 MB a tile and
// bottleneck). The tile size trades the halo's recompute against those
// re-reads and the card's fill (ops/cuda/qblock.py: pick_tile).
//
// The epilogues are f32 without contraction (--fmad=false in the build and
// explicit __fmul_rn/__fadd_rn): each product and sum rounds once, as the
// plain version's separate tensor ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

// Mirrored field for field by QblockArgs in ops/cuda/qblock.py (ctypes).
struct QblockArgs {
  const int8_t* x;   // [N, H, W, c_in] int8, NHWC contiguous
  int8_t* out;       // [N, H, W, c_out]
  const int8_t* w1;  // [c_mid, kp_in], zero beyond c_in
  const float* m1;
  const float* b1;
  const int8_t* w2;  // [c_mid, 9, kp_mid], taps (ky, kx)
  const float* m2;
  const float* b2;
  const int8_t* w3;  // [c_out, kp_mid]
  const float* m3;
  const float* b3;
  const int8_t* w4;  // [c_out, kp_in] or null
  const float* m4;
  const float* b4;
  int n, h, w, c_in, c_mid, c_out;
  int kp_in, kp_mid;    // c_in, c_mid rounded up to a multiple of 32
  int tile_h, tile_w;   // output pixels of one thread block
  int act1, act2;       // -1 none, 0 relu, 1 clip, n > 1 relu-n
  int proj, relaxed;
  int relu;             // 0 none, 1 on the sum's grid, 2 on its own grid
  float act1_lo, act1_hi, act2_lo, act2_hi;
  float s_mid, s_r;
  float inv_s_out;      // f32(1 / s_out): the sum's grid, as a multiplier
  float relu_k;         // f32(s_out * f32(1 / s_relu)): the ReLu's own grid
  float beta;           // relaxed: s_r / s_fin
};

// One chain: the blocks in order, block b + 1 reading what block b wrote.
// Mirrored by ChainArgs in ops/cuda/qblock.py.
constexpr int MAX_CHAIN = 8;
struct ChainArgs {
  int nblocks;
  QblockArgs blk[MAX_CHAIN];
};

namespace {

using namespace mma_s8;

constexpr int THREADS = 256;
constexpr int KW = 8;             // 4-byte k-words of one m16n8k32 step (32 bytes of K)
constexpr int KSTEPS = 2;         // m16n8k32 steps per ring stage
constexpr int BKW = KSTEPS * KW;  // k-words per ring stage
constexpr int STAGES = 4;         // depth of the ring of weight (and x) chunks
constexpr int RW = BKW + 4;       // words between two rows of a ring stage

// The smallest stride >= v that is 8 mod 16 words: words t and t + 4 of
// rows g = 0..7 then fall in 32 distinct banks. ops/cuda/qblock.py mirrors it.
__host__ __device__ constexpr int pad8(int v) { return v + ((24 - v % 16) % 16); }

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int BM = BM_;  // pixel rows of one GEMM tile
  static constexpr int BN = BN_;  // channel columns of one GEMM tile
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WM = BM / WARPS_M_, WN = BN / WARPS_N_;  // a warp's part
  static constexpr int MF = WM / 16, NF = WN / 8;               // its m16 and n8 fragments
  static constexpr int SA = pad8(BM);                           // q2s row stride in words
  static constexpr int STAGE = (BM + BN) * RW;                  // words of one ring stage
  static constexpr int PIECES = BKW / 4;                           // 16-byte copies of a stage row
  static constexpr int NB = (PIECES * BN + THREADS - 1) / THREADS;  // weight copies a thread
  static constexpr int TPR = THREADS / BM;                          // x loaders of a row
  static constexpr int SO = BN / 4 + 4;                   // words of a staged output row
  static constexpr int NO = BM * BN / 16 / THREADS;       // 16-byte staged pieces a thread
  static_assert(WARPS_M_ * WARPS_N_ * 32 == THREADS && WM % 16 == 0 && WN % 8 == 0, "warp tiles");
  static_assert(NB * THREADS == PIECES * BN && TPR * BM == THREADS && PIECES <= TPR &&
                    NO * 16 * THREADS == BM * BN,
                "every copy of a stage and of the staged tile has one thread");
};

// The A operand of one GEMM: rows of x in device memory (staged through
// the ring), the q1 halo buffer read through a tap offset, or the q2 buffer.
enum { A_GLOBAL = 0, A_Q1 = 1, A_Q2 = 2 };

// clip(round(clamp(f32(acc)·M + B, lo, hi))), round half away from zero;
// [lo, hi] is the activation's clamp in the requant domain (act_clamp).
__device__ __forceinline__ float requant(int acc, float m, float b, float lo, float hi) {
  const float q = fminf(fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), m), b), lo), hi);
  return fminf(fmaxf(roundf(q), -127.0f), 127.0f);
}

// The activation of conv1 or conv2 as one clamp: -1 none, 0 relu, 1 clip to
// [lo, hi], n > 1 relu-n (clamp to [0, hi]). For a finite q each is the
// clamp the branches of the reference compute, so the epilogue has none.
__device__ __forceinline__ float2 act_clamp(int act, float lo, float hi) {
  const float inf = __int_as_float(0x7f800000);
  if (act < 0) return make_float2(-inf, inf);
  if (act == 1) return make_float2(lo, hi);
  return make_float2(0.0f, act > 0 ? hi : inf);
}

__device__ __forceinline__ uint32_t q_byte(float q) { return (uint32_t)(int)q & 0xFFu; }

// Lanes t and t ^ 1 hold columns 2t, 2t + 1 of rows g and g + 8 as two
// bytes each (pair[0] row g, pair[1] row g + 8). After the swap the even
// lane holds the 4-channel word of row g and the odd one that of row g + 8.
__device__ __forceinline__ uint32_t swap_halves(const uint32_t (&pair)[2], int odd) {
  const uint32_t got = __shfl_xor_sync(0xFFFFFFFFu, odd ? pair[0] : pair[1], 1);
  return odd ? (got | (pair[1] << 16)) : (pair[0] | (got << 16));
}

template <class C>
__device__ __forceinline__ void zero(int (&acc)[C::MF][C::NF][4]) {
#pragma unroll
  for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NF; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;
}

// acc += A[rows, K] · W[n0 + cols, K]^T over taps × K chunks, rows below
// mrows and columns below ncols. Every thread of the block calls it with the
// same arguments but its own arow; it leaves the ring free for the next call.
// A warp whose rows or columns all lie past mrows or ncols skips its
// products; the others compute every fragment (padding rows and columns
// hold zeros or are dropped by the epilogue), so the product loop has no
// branch per fragment and loads each k-step's fragments before its MMAs.
template <class C, int ASRC>
__device__ __forceinline__ void gemm_tile(
    int (&acc)[C::MF][C::NF][4], const int8_t* __restrict__ wbase, int n0, int ncols,
    int wrow_stride, int kp, int taps, int mrows,
    const int8_t* arow, int c_in, bool vec,                        // A_GLOBAL: this loader's row
    const int* q1s, int hpp, const int (&hb)[C::MF][2], int halo_w,  // A_Q1
    const int* q2s,                                                // A_Q2
    int* ring) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  const int kpw = kp / 4;                 // k-words of a row
  const int nck = (kpw + BKW - 1) / BKW;  // chunks of a tap
  const int n_chunks = taps * nck;
  const int nvalid = ncols - n0;
  const bool active = wm0 < mrows && wn0 < nvalid;

  // The loader: this thread's weight copies (rows lm of the stage, 16-byte
  // pieces) and x copies, addressed from their row starts; (ld_tap, ld_kw)
  // is the next chunk to load.
  const int8_t* bsrc[C::NB];
  int bdst[C::NB];
  uint32_t bok = 0u;  // bit i: copy i fills a row below ncols
#pragma unroll
  for (int i = 0; i < C::NB; ++i) {
    const int s = tid + i * THREADS;
    const int lm = s / C::PIECES, piece = s % C::PIECES;
    const bool ok = lm < nvalid;
    bsrc[i] = wbase + (size_t)(ok ? n0 + lm : 0) * wrow_stride + piece * 16;
    bdst[i] = C::BM * RW + lm * RW + piece * 4;
    bok |= (ok ? 1u : 0u) << i;
  }
  int ld_tap = 0, ld_kw = 0, ld_slot = 0;
  auto load = [&]() {
    int* st = ring + ld_slot * C::STAGE;
#pragma unroll
    for (int i = 0; i < C::NB; ++i) {
      const int piece = (tid + i * THREADS) % C::PIECES;
      if (ld_kw + piece * 4 < kpw)
        cp_async16(smem_u32(st + bdst[i]), bsrc[i] + (size_t)ld_tap * kp + ld_kw * 4,
                   (bok >> i) & 1u ? 16 : 0);
    }
    const int piece = tid % C::TPR;  // this loader's 16 bytes of its x row
    const int cb = (ld_kw + piece * 4) * 4;
    if (ASRC == A_GLOBAL && piece < C::PIECES && cb < kp) {
      int* dst = st + (tid / C::TPR) * RW + piece * 4;
      if (vec) {  // c_in % 16 == 0: 16 bytes lie wholly below c_in or wholly past it
        const bool ok = arow != nullptr && cb < c_in;
        cp_async16(smem_u32(dst), ok ? arow + cb : wbase, ok ? 16 : 0);
      } else {
        uint32_t av[4] = {0u, 0u, 0u, 0u};
        if (arow != nullptr) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int ch = cb + 4 * j + b;
              if (ch < c_in) av[j] |= ((uint32_t)(uint8_t)arow[ch]) << (8 * b);
            }
        }
        *reinterpret_cast<int4*>(dst) = make_int4((int)av[0], (int)av[1], (int)av[2], (int)av[3]);
      }
    }
    ld_kw += BKW;
    if (ld_kw >= kpw) {
      ld_kw = 0;
      ++ld_tap;
    }
    ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
  };

  // this lane's fragment offsets in words: ring rows (A and B), q1s (its
  // rows' halo pixels, word t), q2s (its rows, word t)
  const int aoff = (wm0 + g) * RW + t, boff = C::BM * RW + (wn0 + g) * RW + t;
  int q1off[C::MF][2];
#pragma unroll
  for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) q1off[mi][h] = t * hpp + hb[mi][h];
  const int q2off = t * C::SA + wm0 + g;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load();
    cp_async_commit();
  }
  int tap = 0, ty = 0, tx = 0, kw0 = 0, slot = 0;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1's slot
    if (c + STAGES - 1 < n_chunks) load();
    cp_async_commit();

    if (active) {
      const int* st = ring + slot * C::STAGE;
      const int* q1b = q1s + kw0 * hpp + ty * halo_w + tx;
      const int* q2b = q2s + kw0 * C::SA + q2off;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        if (ks > 0 && kw0 + ks * KW >= kpw) break;
        uint32_t af[C::MF][4], bf[C::NF][2];
#pragma unroll
        for (int mi = 0; mi < C::MF; ++mi) {
          if (ASRC == A_GLOBAL) {
            const int* p = st + aoff + mi * 16 * RW + ks * KW;
            af[mi][0] = p[0];
            af[mi][1] = p[8 * RW];
            af[mi][2] = p[4];
            af[mi][3] = p[8 * RW + 4];
          } else if (ASRC == A_Q1) {
            const int* p = q1b + ks * KW * hpp;
            af[mi][0] = p[q1off[mi][0]];
            af[mi][1] = p[q1off[mi][1]];
            af[mi][2] = p[4 * hpp + q1off[mi][0]];
            af[mi][3] = p[4 * hpp + q1off[mi][1]];
          } else {
            const int* p = q2b + ks * KW * C::SA + mi * 16;
            af[mi][0] = p[0];
            af[mi][1] = p[8];
            af[mi][2] = p[4 * C::SA];
            af[mi][3] = p[4 * C::SA + 8];
          }
        }
#pragma unroll
        for (int ni = 0; ni < C::NF; ++ni) {
          const int* p = st + boff + ni * 8 * RW + ks * KW;
          bf[ni][0] = p[0];
          bf[ni][1] = p[4];
        }
#pragma unroll
        for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
          for (int ni = 0; ni < C::NF; ++ni) mma_s8s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
    }
    kw0 += BKW;
    if (kw0 >= kpw) {
      kw0 = 0;
      ++tap;
      if (++tx == 3) {
        tx = 0;
        ++ty;
      }
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  __syncthreads();  // every warp is done with the ring (and the caller's A buffer)
}

// The block's epilogue constants: the exact tier's grids, the ReLu's own
// grid (rk = 1 where it has none: y·1 rounds to y), the relaxed tier's beta,
// and the lower clamp of each tier's ReLu (-127 or -FLT_MAX without one: the
// identity on what reaches it).
struct Epi {
  float s_mid, s_r, inv_s_out, rk, beta, relu_lo, relu_lo_relaxed;
};

// One column pass of the block's output into the staged tile xo (BM rows of
// BN bytes, SO words apart, where the identity residual's bytes already
// lie): conv3's sums (acc) and the projection's (acc4), the exact or
// relaxed epilogue op for op, one 4-channel word per lane. No branch per
// element: the tier and the head are template parameters, the ReLu a clamp.
// Each residual byte is read by the lane pair (t, t ^ 1) that overwrites it,
// before the pair's swap.
template <class C, bool RELAXED, bool PROJ>
__device__ __forceinline__ void block_out(
    const int (&acc)[C::MF][C::NF][4], const int (&acc4)[C::MF][C::NF][4], int* xo, int n0,
    int c_out, const float* mb3, int cmax, const Epi& e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, odd = t & 1;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(xo);
#pragma unroll
  for (int ni = 0; ni < C::NF; ++ni) {
    const int f0 = n0 + wn0 + ni * 8;
    if (f0 >= c_out) continue;
    const int col = f0 + 2 * t;
    const float2 m3 = *reinterpret_cast<const float2*>(mb3 + col);
    const float2 b3 = *reinterpret_cast<const float2*>(mb3 + cmax + col);
    const float2 m4 = *reinterpret_cast<const float2*>(mb3 + 2 * cmax + col);
    const float2 b4 = *reinterpret_cast<const float2*>(mb3 + 3 * cmax + col);
#pragma unroll
    for (int mi = 0; mi < C::MF; ++mi) {
      uint32_t pair[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm0 + mi * 16 + g + 8 * h;
        const uint32_t xr2 =
            PROJ ? 0u : *reinterpret_cast<const uint16_t*>(xb + row * 4 * C::SO + (col - n0));
        pair[h] = 0u;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float mm3 = j ? m3.y : m3.x, bb3 = j ? b3.y : b3.x;
          const float mm4 = j ? m4.y : m4.x, bb4 = j ? b4.y : b4.x;
          const int a3 = acc[mi][ni][2 * h + j];
          const float xr = (float)(int8_t)(xr2 >> (8 * j));
          float y;
          if (RELAXED) {
            y = __fadd_rn(__fmul_rn(__int2float_rn(a3), mm3), bb3);
            if (PROJ) {
              y = __fadd_rn(y, __fmul_rn(__int2float_rn(acc4[mi][ni][2 * h + j]), mm4));
              y = __fadd_rn(y, bb4);
            } else {
              y = __fadd_rn(y, __fmul_rn(xr, e.beta));
            }
            y = fminf(fmaxf(roundf(fmaxf(y, e.relu_lo_relaxed)), -127.0f), 127.0f);
          } else {
            const float tq = requant(a3, mm3, bb3, -INFINITY, INFINITY);
            const float r = PROJ ? requant(acc4[mi][ni][2 * h + j], mm4, bb4, -INFINITY, INFINITY) : xr;
            const float sum = __fadd_rn(__fmul_rn(tq, e.s_mid), __fmul_rn(r, e.s_r));
            y = fminf(fmaxf(roundf(__fmul_rn(sum, e.inv_s_out)), e.relu_lo), 127.0f);
            y = fminf(fmaxf(roundf(__fmul_rn(y, e.rk)), -127.0f), 127.0f);
          }
          if (col + j < c_out) pair[h] |= q_byte(y) << (8 * j);
        }
      }
      const uint32_t word = swap_halves(pair, odd);
      xo[(wm0 + mi * 16 + g + 8 * odd) * C::SO + ((f0 - n0) >> 2) + (t >> 1)] = (int)word;
    }
  }
}

// Widest c_out of a chain, rounded up to a multiple of 8: the stride at
// which the M and B vectors of conv3 and the projection are staged (an n8
// fragment's columns stay inside their vector).
__host__ __device__ inline int chain_cmax(const ChainArgs& c) {
  int m = 0;
  for (int b = 0; b < c.nblocks; ++b) m = c.blk[b].c_out > m ? c.blk[b].c_out : m;
  return (m + 7) / 8 * 8;
}

// Shared memory of one thread block, in 4-byte words: q2 [kwm][SA], the
// ring, q1 [kwm][pad8(halo pixels)], the staged output tile [BM][SO], then M
// and B of the bottleneck (m1 b1 m2 b2 at stride kp_mid, m3 b3 m4 b4 at
// stride cmax). ops/cuda/qblock.py mirrors it.
template <class C>
__host__ __device__ inline int smem_words(int tile_h, int tile_w, int kp_mid, int cmax) {
  const int kwm = kp_mid / 4;
  return kwm * C::SA + STAGES * C::STAGE + kwm * pad8((tile_h + 2) * (tile_w + 2)) +
         C::BM * C::SO + 4 * kp_mid + 4 * cmax;
}

// One bottleneck on one spatial tile (tile index of the chain's grid); every
// thread of the block calls it with the same arguments. mb holds its M and B.
template <class C>
__device__ __forceinline__ void qblock_tile(const QblockArgs& a, int tile, int* smem,
                                            const float* mb, int cmax) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, odd = t & 1;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  const int th = a.tile_h, tw = a.tile_w;
  const int halo_w = tw + 2;
  const int HP = (th + 2) * halo_w;  // halo pixels
  const int hpp = pad8(HP);          // row stride of the q1 buffer
  const int kpm = a.kp_mid, kwm = kpm / 4;
  const int npix = th * tw;
  const int c_in = a.c_in, c_mid = a.c_mid, c_out = a.c_out;

  // q1s and q2s need no clearing: every word a product reads is written
  // first, or lies past c_mid where the packed weights are zero, or belongs
  // to a row whose result is dropped
  int* q2s = smem;                        // [kwm][SA]
  int* ring = q2s + kwm * C::SA;          // [STAGES][BM + BN][RW]
  int* q1s = ring + STAGES * C::STAGE;    // [kwm][hpp]
  int* xo = q1s + kwm * hpp;              // [BM][SO]: a column pass's output bytes

  const int tiles_x = (a.w + tw - 1) / tw, tiles_y = (a.h + th - 1) / th;
  const int img = tile / (tiles_x * tiles_y);
  const int bid = tile - img * tiles_x * tiles_y;
  const int y0 = (bid / tiles_x) * th, x0 = (bid % tiles_x) * tw;
  const int8_t* ximg = a.x + (size_t)img * a.h * a.w * c_in;
  const bool vec = (c_in % 16) == 0;

  const int hb0[C::MF][2] = {};
  int acc[C::MF][C::NF][4];

  // ---- conv1 on the tile and its halo -> q1s ----
  const float2 k1 = act_clamp(a.act1, a.act1_lo, a.act1_hi);
  for (int r0 = 0; r0 < HP; r0 += C::BM) {
    const int8_t* arow = nullptr;  // this loader thread's x row
    {
      const int row = r0 + tid / C::TPR;
      const int iy = y0 - 1 + row / halo_w, ix = x0 - 1 + row % halo_w;
      if (row < HP && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w)
        arow = ximg + ((size_t)iy * a.w + ix) * c_in;
    }
    bool inside[C::MF][2];
#pragma unroll
    for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wm0 + mi * 16 + g + 8 * h;
        const int iy = y0 - 1 + row / halo_w, ix = x0 - 1 + row % halo_w;
        inside[mi][h] = row < HP && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
      }
    for (int n0 = 0; n0 < c_mid; n0 += C::BN) {
      zero<C>(acc);
      gemm_tile<C, A_GLOBAL>(acc, a.w1, n0, c_mid, a.kp_in, a.kp_in, 1, HP - r0,
                             arow, c_in, vec, nullptr, 0, hb0, 0, nullptr, ring);
#pragma unroll
      for (int ni = 0; ni < C::NF; ++ni) {
        const int f0 = n0 + wn0 + ni * 8;
        if (f0 >= c_mid) continue;
        const float2 m = *reinterpret_cast<const float2*>(mb + f0 + 2 * t);
        const float2 b = *reinterpret_cast<const float2*>(mb + kpm + f0 + 2 * t);
#pragma unroll
        for (int mi = 0; mi < C::MF; ++mi) {
          if (r0 + wm0 + mi * 16 >= HP) continue;
          uint32_t pair[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t lo = q_byte(requant(acc[mi][ni][2 * h], m.x, b.x, k1.x, k1.y));
            const uint32_t hi = q_byte(requant(acc[mi][ni][2 * h + 1], m.y, b.y, k1.x, k1.y));
            const int col = f0 + 2 * t;
            pair[h] = inside[mi][h] ? (col < c_mid ? lo : 0u) | (col + 1 < c_mid ? hi << 8 : 0u) : 0u;
          }
          const uint32_t word = swap_halves(pair, odd);
          const int row = r0 + wm0 + mi * 16 + g + 8 * odd;
          if (row < HP) q1s[((f0 >> 2) + (t >> 1)) * hpp + row] = (int)word;
        }
      }
    }
  }
  // (the first chunk of the next GEMM synchronises before it reads q1s)

  // ---- conv2: nine taps out of q1s -> q2s ----
  const float2 k2 = act_clamp(a.act2, a.act2_lo, a.act2_hi);
  int hb[C::MF][2];
#pragma unroll
  for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm0 + mi * 16 + g + 8 * h;
      hb[mi][h] = row < npix ? (row / tw) * halo_w + row % tw : 0;
    }
  for (int n0 = 0; n0 < c_mid; n0 += C::BN) {
    zero<C>(acc);
    gemm_tile<C, A_Q1>(acc, a.w2, n0, c_mid, 9 * kpm, kpm, 9, npix,
                       nullptr, 0, false, q1s, hpp, hb, halo_w, nullptr, ring);
#pragma unroll
    for (int ni = 0; ni < C::NF; ++ni) {
      const int f0 = n0 + wn0 + ni * 8;
      if (f0 >= c_mid) continue;
      const float2 m = *reinterpret_cast<const float2*>(mb + 2 * kpm + f0 + 2 * t);
      const float2 b = *reinterpret_cast<const float2*>(mb + 3 * kpm + f0 + 2 * t);
#pragma unroll
      for (int mi = 0; mi < C::MF; ++mi) {
        if (wm0 + mi * 16 >= npix) continue;
        uint32_t pair[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t lo = q_byte(requant(acc[mi][ni][2 * h], m.x, b.x, k2.x, k2.y));
          const uint32_t hi = q_byte(requant(acc[mi][ni][2 * h + 1], m.y, b.y, k2.x, k2.y));
          const int col = f0 + 2 * t;
          pair[h] = (col < c_mid ? lo : 0u) | (col + 1 < c_mid ? hi << 8 : 0u);
        }
        const uint32_t word = swap_halves(pair, odd);
        q2s[((f0 >> 2) + (t >> 1)) * C::SA + wm0 + mi * 16 + g + 8 * odd] = (int)word;
      }
    }
  }

  // ---- conv3, the residual and the block's epilogue -> out ----
  const int8_t* prow = nullptr;  // this loader thread's x row for the projection
  {
    const int row = tid / C::TPR;
    const int oy = y0 + row / tw, ox = x0 + row % tw;
    if (row < npix && oy < a.h && ox < a.w) prow = ximg + ((size_t)oy * a.w + ox) * c_in;
  }
  // the staged tile's rows this thread copies in (the identity residual) and
  // out: 16-byte pieces, row piece / (BN / 16), and their pixels (-1 none)
  int cpix[C::NO];
#pragma unroll
  for (int k = 0; k < C::NO; ++k) {
    const int row = (tid + k * THREADS) / (C::BN / 16);
    const int oy = y0 + row / tw, ox = x0 + row % tw;
    cpix[k] = (row < npix && oy < a.h && ox < a.w) ? (img * a.h + oy) * a.w + ox : -1;
  }
  const int proj = a.proj, relaxed = a.relaxed;
  const Epi e = {a.s_mid, a.s_r, a.inv_s_out, a.relu == 2 ? a.relu_k : 1.0f, a.beta,
                 a.relu ? 0.0f : -127.0f, a.relu ? 0.0f : -__int_as_float(0x7f7fffff)};
  const int8_t* xg = a.x;
  int8_t* out = a.out;
  uint8_t* xob = reinterpret_cast<uint8_t*>(xo);
  const float* mb3 = mb + 4 * kpm;  // m3, b3, m4, b4 at stride cmax
  for (int n0 = 0; n0 < c_out; n0 += C::BN) {
    // the identity residual's BM × BN bytes, with the products' first chunk
    if (!proj) {
#pragma unroll
      for (int k = 0; k < C::NO; ++k) {
        const int piece = tid + k * THREADS;
        const int row = piece / (C::BN / 16), q = piece % (C::BN / 16);
        const int col = n0 + 16 * q;
        uint8_t* dst = xob + row * 4 * C::SO + 16 * q;
        const int8_t* src = xg + (size_t)(cpix[k] < 0 ? 0 : cpix[k]) * c_in + col;
        if (vec) {
          cp_async16(smem_u32(dst), cpix[k] >= 0 && col < c_out ? src : xg,
                     cpix[k] >= 0 && col < c_out ? 16 : 0);
        } else {
          for (int b = 0; b < 16; ++b)
            dst[b] = cpix[k] >= 0 && col + b < c_out ? (uint8_t)src[b] : 0;
        }
      }
    }
    int acc4[C::MF][C::NF][4];
    zero<C>(acc);
    zero<C>(acc4);
    gemm_tile<C, A_Q2>(acc, a.w3, n0, c_out, kpm, kpm, 1, npix,
                       nullptr, 0, false, nullptr, 0, hb0, 0, q2s, ring);
    if (proj)
      gemm_tile<C, A_GLOBAL>(acc4, a.w4, n0, c_out, a.kp_in, a.kp_in, 1, npix,
                             prow, c_in, vec, nullptr, 0, hb0, 0, nullptr, ring);
    if (relaxed) {
      if (proj) block_out<C, true, true>(acc, acc4, xo, n0, c_out, mb3, cmax, e);
      else block_out<C, true, false>(acc, acc4, xo, n0, c_out, mb3, cmax, e);
    } else {
      if (proj) block_out<C, false, true>(acc, acc4, xo, n0, c_out, mb3, cmax, e);
      else block_out<C, false, false>(acc, acc4, xo, n0, c_out, mb3, cmax, e);
    }
    __syncthreads();
    // the tile leaves row by row, 16 neighbouring bytes a thread
#pragma unroll
    for (int k = 0; k < C::NO; ++k) {
      const int piece = tid + k * THREADS;
      const int row = piece / (C::BN / 16), q = piece % (C::BN / 16);
      const int col = n0 + 16 * q;
      if (cpix[k] < 0 || col >= c_out) continue;
      const uint8_t* src = xob + row * 4 * C::SO + 16 * q;
      int8_t* dst = out + (size_t)cpix[k] * c_out + col;
      if ((c_out & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int b = 0; b < 16 && col + b < c_out; ++b) dst[b] = (int8_t)src[b];
      }
    }
    __syncthreads();  // every thread is done with xo before the next pass fills it
  }
}

template <class C>
__global__ void __launch_bounds__(THREADS, C::MIN_BLOCKS) qblock_kernel(const ChainArgs c) {
  extern __shared__ __align__(16) int smem[];
  const QblockArgs& a0 = c.blk[0];
  const int tiles = a0.n * ((a0.h + a0.tile_h - 1) / a0.tile_h) *
                    ((a0.w + a0.tile_w - 1) / a0.tile_w);
  const int cmax = chain_cmax(c);
  const int kpm = a0.kp_mid;
  float* mb = reinterpret_cast<float*>(smem) +
              (smem_words<C>(a0.tile_h, a0.tile_w, kpm, cmax) - 4 * kpm - 4 * cmax);
  // The bottleneck's arguments go to shared memory: indexed by b in the
  // parameter space they would sit in registers for the whole tile and push
  // the GEMMs' accumulators out into spills.
  __shared__ QblockArgs a;
  for (int b = 0; b < c.nblocks; ++b) {
    if (b > 0) cooperative_groups::this_grid().sync();
    __syncthreads();
    if (threadIdx.x < sizeof(QblockArgs) / 4)
      reinterpret_cast<int*>(&a)[threadIdx.x] =
          reinterpret_cast<const int*>(&c.blk[b])[threadIdx.x];
    __syncthreads();
    // its M and B, once for all its tiles (0 past c_mid and c_out)
    for (int i = threadIdx.x; i < kpm; i += THREADS) {
      const bool ok = i < a.c_mid;
      mb[i] = ok ? a.m1[i] : 0.0f;
      mb[kpm + i] = ok ? a.b1[i] : 0.0f;
      mb[2 * kpm + i] = ok ? a.m2[i] : 0.0f;
      mb[3 * kpm + i] = ok ? a.b2[i] : 0.0f;
    }
    for (int i = threadIdx.x; i < cmax; i += THREADS) {
      const bool ok = i < a.c_out;
      float* m3 = mb + 4 * kpm;
      m3[i] = ok ? a.m3[i] : 0.0f;
      m3[cmax + i] = ok ? a.b3[i] : 0.0f;
      m3[2 * cmax + i] = ok && a.proj ? a.m4[i] : 0.0f;
      m3[3 * cmax + i] = ok && a.proj ? a.b4[i] : 0.0f;
    }
    __syncthreads();
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      qblock_tile<C>(a, tile, smem, mb, cmax);
  }
}

template <class C>
int launch(const ChainArgs& c, cudaStream_t s) {
  const QblockArgs& a = c.blk[0];
  if (a.tile_h * a.tile_w > C::BM) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)smem_words<C>(a.tile_h, a.tile_w, a.kp_mid, chain_cmax(c));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(qblock_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)a.n * ((a.h + a.tile_h - 1) / a.tile_h) *
                          ((a.w + a.tile_w - 1) / a.tile_w);
  if (tiles < 1 || tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // a cooperative launch holds every thread block on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qblock_kernel<C>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long resident = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  void* params[] = {const_cast<ChainArgs*>(&c)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&qblock_kernel<C>),
                                  dim3(grid), dim3(THREADS), params, smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Launch one chain on `stream`; returns the CUDA error of the launch (0 on
// success). The caller checks shapes, dtypes, contiguity and 16-byte
// alignment of every pointer, and that the blocks share one geometry (n, h,
// w, c_mid, tile). Tiles of at most 16 pixels run 16 × 256 GEMM tiles
// (warps 1 × 8), larger ones 64 × 128 (warps 2 × 4), or 64 × 64 (warps
// 4 × 2) where c_mid <= 64. ops/cuda/qblock.py mirrors the choice.
extern "C" int qblock_chain_launch(const ChainArgs* chain, void* stream) {
  const ChainArgs& c = *chain;
  if (c.nblocks < 1 || c.nblocks > MAX_CHAIN) return (int)cudaErrorInvalidValue;
  const QblockArgs& a0 = c.blk[0];
  for (int b = 0; b < c.nblocks; ++b) {
    const QblockArgs& a = c.blk[b];
    if (a.n < 1 || a.h < 1 || a.w < 1 || a.c_in < 1 || a.c_mid < 1 || a.c_out < 1 ||
        a.tile_h < 1 || a.tile_w < 1 || a.kp_in % 32 != 0 || a.kp_in < a.c_in ||
        a.kp_mid % 32 != 0 || a.kp_mid < a.c_mid || (a.proj && a.w4 == nullptr) ||
        (!a.proj && a.c_in != a.c_out) || a.n != a0.n || a.h != a0.h || a.w != a0.w ||
        a.kp_mid != a0.kp_mid || a.tile_h != a0.tile_h || a.tile_w != a0.tile_w ||
        (b > 0 && a.x != c.blk[b - 1].out))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a0.tile_h * a0.tile_w <= 16) return launch<Cfg<16, 256, 1, 8, 2>>(c, s);
  if (a0.c_mid <= 64) return launch<Cfg<64, 64, 4, 2, 2>>(c, s);
  // A grid of at most one tile per SM holds one block on each: there the
  // 64 × 128 tile takes the registers it wants instead of spilling at two
  // blocks' share.
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)a0.n * ((a0.h + a0.tile_h - 1) / a0.tile_h) *
                          ((a0.w + a0.tile_w - 1) / a0.tile_w);
  if (tiles <= sms) return launch<Cfg<64, 128, 2, 4, 1>>(c, s);
  return launch<Cfg<64, 128, 2, 4, 2>>(c, s);
}
