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
// shared memory, so every K loop over x streams it in 32-byte chunks.
//
// The chain is one persistent cooperative launch: as many thread blocks as
// the card holds at once walk over the tiles of bottleneck b, meet at a
// grid-wide barrier, and go on to bottleneck b + 1, whose 3×3 halo needs
// its neighbours' outputs. A bottleneck's output passes to the next through
// a device buffer of its own (written once, read after the barrier, so it
// stays in L2 at ResNet's sizes and no SM holds a stale line of it).
//
// What bounds it on this card: operations (a ResNet-50 bottleneck does
// 1,100 to 2,300 multiply-adds per activation byte moved). This first
// design does not reach the tensor cores: every product is a tiled __dp4a
// GEMM, 256 threads, each thread a 4-pixel × TN-channel int32 micro-tile,
// weights staged through shared memory with the next chunk's loads held in
// registers. Weights are re-read from L2 by every tile. mma/wgmma with TMA
// are the next steps.
//
// The epilogues are f32 without contraction (--fmad=false in the build and
// explicit __fmul_rn/__fadd_rn): each product and sum rounds once, as the
// plain version's separate tensor ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int THREADS = 256;
constexpr int TM = 4;  // pixels per thread
constexpr int KW = 8;  // 4-byte k-words per 32-byte K chunk

__device__ __forceinline__ float requant(int acc, float m, float b, int act, float lo, float hi) {
  float q = __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
  if (act >= 0) {
    if (act == 1) {
      q = fminf(fmaxf(q, lo), hi);
    } else {
      q = fmaxf(q, 0.0f);
      if (act > 0) q = fminf(q, hi);
    }
  }
  return fminf(fmaxf(roundf(q), -127.0f), 127.0f);
}

template <int TY, int TN>
struct Cfg {
  static constexpr int TX = THREADS / TY;
  static constexpr int BM = TY * TM;    // pixel rows of one GEMM tile
  static constexpr int BN = TX * TN;    // channel columns of one GEMM tile
  static constexpr int NG = TN / 4;     // 4-channel groups per thread
  static constexpr int GS = BN / NG;    // column stride between a thread's groups
  static constexpr int SA = BM + 4;     // shared row strides in words
  static constexpr int SB = BN + 4;
  static constexpr int NB = (2 * BN + THREADS - 1) / THREADS;  // weight loads per thread
};

// The A operand of one GEMM: rows of x in device memory (staged through
// As), the q1 halo buffer read through a tap offset, or the q2 buffer.
enum { A_GLOBAL = 0, A_Q1 = 1, A_Q2 = 2 };

// acc[TM][TN] += A[rows, K] · W[n0 + cols, K]^T over taps × K chunks.
// Every thread of the block calls it with the same trip counts.
template <int TY, int TN, int ASRC>
__device__ __forceinline__ void gemm_tile(
    int (&acc)[TM][TN], const int8_t* __restrict__ wbase, int n0, int ncols,
    size_t wrow_stride, int kp, int taps,
    const int8_t* arow, int c_in, bool vec,  // A_GLOBAL: this loader thread's row
    const int* q1s, int hpp, const int (&hb)[TM], int halo_w,  // A_Q1
    const int* q2s,                                         // A_Q2
    int* As, int* Bs) {
  using C = Cfg<TY, TN>;
  const int tid = threadIdx.x;
  const int tx = tid % C::TX, ty = tid / C::TX;
  const int nck = kp / 32;
  const int n_chunks = taps * nck;

  uint4 wv[C::NB];
  uint32_t av[4];

  auto load = [&](int t) {
    const int tap = t / nck;
    const int kc = t - tap * nck;
#pragma unroll
    for (int i = 0; i < C::NB; ++i) {
      const int s = tid + i * THREADS;
      const int lm = s >> 1, half = s & 1;
      wv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (s < 2 * C::BN && n0 + lm < ncols)
        wv[i] = *reinterpret_cast<const uint4*>(
            wbase + (size_t)(n0 + lm) * wrow_stride + (size_t)tap * kp + kc * 32 + half * 16);
    }
    if (ASRC == A_GLOBAL && tid < 2 * C::BM) {
      const int cb = kc * 32 + (tid & 1) * 16;
#pragma unroll
      for (int j = 0; j < 4; ++j) av[j] = 0u;
      if (arow != nullptr && cb < c_in) {
        if (vec) {
          const uint4 q = *reinterpret_cast<const uint4*>(arow + cb);
          av[0] = q.x; av[1] = q.y; av[2] = q.z; av[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int ch = cb + 4 * j + b;
              if (ch < c_in) av[j] |= ((uint32_t)(uint8_t)arow[ch]) << (8 * b);
            }
        }
      }
    }
  };

  load(0);
  for (int t = 0; t < n_chunks; ++t) {
#pragma unroll
    for (int i = 0; i < C::NB; ++i) {
      const int s = tid + i * THREADS;
      if (s < 2 * C::BN) {
        const int lm = s >> 1, half = s & 1;
        Bs[(half * 4 + 0) * C::SB + lm] = (int)wv[i].x;
        Bs[(half * 4 + 1) * C::SB + lm] = (int)wv[i].y;
        Bs[(half * 4 + 2) * C::SB + lm] = (int)wv[i].z;
        Bs[(half * 4 + 3) * C::SB + lm] = (int)wv[i].w;
      }
    }
    if (ASRC == A_GLOBAL && tid < 2 * C::BM) {
      const int lm = tid >> 1, half = tid & 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) As[(half * 4 + j) * C::SA + lm] = (int)av[j];
    }
    __syncthreads();
    if (t + 1 < n_chunks) load(t + 1);

    const int tap = t / nck;
    const int kc = t - tap * nck;
    const int tapoff = (tap / 3) * halo_w + (tap % 3);
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      int a[TM];
      if (ASRC == A_GLOBAL) {
        const int4 v = *reinterpret_cast<const int4*>(&As[k * C::SA + ty * TM]);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else if (ASRC == A_Q1) {
        const int* base = q1s + (size_t)(kc * KW + k) * hpp + tapoff;
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = base[hb[i]];
      } else {
        const int4 v = *reinterpret_cast<const int4*>(&q2s[(kc * KW + k) * C::SA + ty * TM]);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < C::NG; ++g) {
        const int4 v = *reinterpret_cast<const int4*>(&Bs[k * C::SB + g * C::GS + tx * 4]);
        const int b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][g * 4 + j] = __dp4a(a[i], b[j], acc[i][g * 4 + j]);
      }
    }
    __syncthreads();
  }
}

template <int TM_, int TN>
__device__ __forceinline__ void zero(int (&acc)[TM_][TN]) {
#pragma unroll
  for (int i = 0; i < TM_; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
}

// One bottleneck on one spatial tile (tile index bid); every thread of the
// block calls it with the same arguments.
template <int TY, int TN>
__device__ __forceinline__ void qblock_tile(const QblockArgs& a, int bid, int* smem) {
  using C = Cfg<TY, TN>;

  const int tid = threadIdx.x;
  const int tx = tid % C::TX, ty = tid / C::TX;
  const int th = a.tile_h, tw = a.tile_w;
  const int halo_w = tw + 2;
  const int HP = (th + 2) * halo_w;  // halo pixels
  const int hpp = HP | 1;            // odd row stride of the q1 buffer
  const int kwm = a.kp_mid / 4;      // k-words of a c_mid vector

  int* q2s = smem;                   // [kwm][SA]
  int* As = q2s + kwm * C::SA;       // [KW][SA]
  int* Bs = As + KW * C::SA;         // [KW][SB]
  int* q1s = Bs + KW * C::SB;        // [kwm][hpp]

  const int tiles_x = (a.w + tw - 1) / tw, tiles_y = (a.h + th - 1) / th;
  const int img = bid / (tiles_x * tiles_y);
  bid -= img * tiles_x * tiles_y;
  const int y0 = (bid / tiles_x) * th, x0 = (bid % tiles_x) * tw;
  const int8_t* ximg = a.x + (size_t)img * a.h * a.w * a.c_in;
  const bool vec = (a.c_in % 16) == 0;

  for (int i = tid; i < kwm * C::SA; i += THREADS) q2s[i] = 0;
  for (int i = tid; i < kwm * hpp; i += THREADS) q1s[i] = 0;
  __syncthreads();

  const int hb0[TM] = {0, 0, 0, 0};
  int acc[TM][TN];

  // ---- conv1 on the tile and its halo -> q1s ----
  for (int r0 = 0; r0 < HP; r0 += C::BM) {
    const int8_t* arow = nullptr;
    if (tid < 2 * C::BM) {
      const int row = r0 + (tid >> 1);
      if (row < HP) {
        const int iy = y0 - 1 + row / halo_w, ix = x0 - 1 + row % halo_w;
        if (iy >= 0 && iy < a.h && ix >= 0 && ix < a.w)
          arow = ximg + ((size_t)iy * a.w + ix) * a.c_in;
      }
    }
    bool inside[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = r0 + ty * TM + i;
      const int iy = y0 - 1 + row / halo_w, ix = x0 - 1 + row % halo_w;
      inside[i] = row < HP && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
    }
    for (int n0 = 0; n0 < a.c_mid; n0 += C::BN) {
      zero(acc);
      gemm_tile<TY, TN, A_GLOBAL>(acc, a.w1, n0, a.c_mid, (size_t)a.kp_in, a.kp_in, 1,
                                  arow, a.c_in, vec, nullptr, 0, hb0, 0, nullptr, As, Bs);
#pragma unroll
      for (int g = 0; g < C::NG; ++g) {
        const int nb = n0 + g * C::GS + tx * 4;
        if (nb >= a.kp_mid) continue;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = r0 + ty * TM + i;
          if (row >= HP) continue;
          uint32_t word = 0u;
          if (inside[i]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = nb + j;
              if (n < a.c_mid) {
                const float q = requant(acc[i][g * 4 + j], a.m1[n], a.b1[n], a.act1,
                                        a.act1_lo, a.act1_hi);
                word |= ((uint32_t)((int)q) & 0xFFu) << (8 * j);
              }
            }
          }
          q1s[(nb >> 2) * hpp + row] = (int)word;
        }
      }
    }
  }
  // (the first chunk of the next GEMM synchronises before it reads q1s)

  // ---- conv2: nine taps out of q1s -> q2s ----
  int hb[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty * TM + i;
    hb[i] = row < th * tw ? (row / tw) * halo_w + row % tw : 0;
  }
  for (int n0 = 0; n0 < a.c_mid; n0 += C::BN) {
    zero(acc);
    gemm_tile<TY, TN, A_Q1>(acc, a.w2, n0, a.c_mid, (size_t)9 * a.kp_mid, a.kp_mid, 9,
                            nullptr, 0, false, q1s, hpp, hb, halo_w, nullptr, As, Bs);
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      const int nb = n0 + g * C::GS + tx * 4;
      if (nb >= a.kp_mid) continue;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nb + j;
          if (n < a.c_mid) {
            const float q = requant(acc[i][g * 4 + j], a.m2[n], a.b2[n], a.act2,
                                    a.act2_lo, a.act2_hi);
            word |= ((uint32_t)((int)q) & 0xFFu) << (8 * j);
          }
        }
        q2s[(nb >> 2) * C::SA + ty * TM + i] = (int)word;
      }
    }
  }

  // ---- conv3, the residual and the block's epilogue -> out ----
  const int8_t* prow = nullptr;  // this loader thread's x row for the projection
  if (tid < 2 * C::BM) {
    const int row = tid >> 1;
    const int oy = y0 + row / tw, ox = x0 + row % tw;
    if (row < th * tw && oy < a.h && ox < a.w) prow = ximg + ((size_t)oy * a.w + ox) * a.c_in;
  }
  long long pix[TM];  // this thread's output pixels, -1 outside the image
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty * TM + i;
    const int oy = y0 + row / tw, ox = x0 + row % tw;
    pix[i] = (row < th * tw && oy < a.h && ox < a.w)
                 ? ((long long)img * a.h + oy) * a.w + ox : -1;
  }
  const bool out_vec = (a.c_out % 4) == 0;
  int acc4[TM][TN];
  for (int n0 = 0; n0 < a.c_out; n0 += C::BN) {
    zero(acc);
    gemm_tile<TY, TN, A_Q2>(acc, a.w3, n0, a.c_out, (size_t)a.kp_mid, a.kp_mid, 1,
                            nullptr, 0, false, nullptr, 0, hb0, 0, q2s, As, Bs);
    if (a.proj) {
      zero(acc4);
      gemm_tile<TY, TN, A_GLOBAL>(acc4, a.w4, n0, a.c_out, (size_t)a.kp_in, a.kp_in, 1,
                                  prow, a.c_in, vec, nullptr, 0, hb0, 0, nullptr, As, Bs);
    }
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
      const int nb = n0 + g * C::GS + tx * 4;
      if (nb >= a.c_out) continue;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (pix[i] < 0) continue;
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nb + j;
          if (n >= a.c_out) break;
          const int a3 = acc[i][g * 4 + j];
          float y;
          if (a.relaxed) {
            y = __fadd_rn(__fmul_rn(__int2float_rn(a3), a.m3[n]), a.b3[n]);
            if (a.proj) {
              y = __fadd_rn(y, __fmul_rn(__int2float_rn(acc4[i][g * 4 + j]), a.m4[n]));
              y = __fadd_rn(y, a.b4[n]);
            } else {
              const float r = (float)a.x[(size_t)pix[i] * a.c_in + n];
              y = __fadd_rn(y, __fmul_rn(r, a.beta));
            }
            if (a.relu) y = fmaxf(y, 0.0f);
            y = fminf(fmaxf(roundf(y), -127.0f), 127.0f);
          } else {
            const float t = requant(a3, a.m3[n], a.b3[n], -1, 0.0f, 0.0f);
            const float r = a.proj
                ? requant(acc4[i][g * 4 + j], a.m4[n], a.b4[n], -1, 0.0f, 0.0f)
                : (float)a.x[(size_t)pix[i] * a.c_in + n];
            const float sum = __fadd_rn(__fmul_rn(t, a.s_mid), __fmul_rn(r, a.s_r));
            y = fminf(fmaxf(roundf(__fmul_rn(sum, a.inv_s_out)), -127.0f), 127.0f);
            if (a.relu) {
              y = fmaxf(y, 0.0f);
              if (a.relu == 2) {
                y = roundf(__fmul_rn(y, a.relu_k));
                y = fminf(fmaxf(y, -127.0f), 127.0f);
              }
            }
          }
          word |= ((uint32_t)((int)y) & 0xFFu) << (8 * j);
        }
        int8_t* o = a.out + (size_t)pix[i] * a.c_out + nb;
        if (out_vec) {
          *reinterpret_cast<uint32_t*>(o) = word;
        } else {
          for (int j = 0; j < 4 && nb + j < a.c_out; ++j) o[j] = (int8_t)(word >> (8 * j));
        }
      }
    }
  }
}

template <int TY, int TN>
__global__ void __launch_bounds__(THREADS, 2) qblock_kernel(const ChainArgs c) {
  extern __shared__ __align__(16) int smem[];
  const QblockArgs& a0 = c.blk[0];
  const int tiles = a0.n * ((a0.h + a0.tile_h - 1) / a0.tile_h) *
                    ((a0.w + a0.tile_w - 1) / a0.tile_w);
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
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      qblock_tile<TY, TN>(a, tile, smem);
  }
}

template <int TY, int TN>
int launch(const ChainArgs& c, cudaStream_t s) {
  using C = Cfg<TY, TN>;
  const QblockArgs& a = c.blk[0];
  if (a.tile_h * a.tile_w > C::BM) return (int)cudaErrorInvalidValue;
  const int HP = (a.tile_h + 2) * (a.tile_w + 2);
  const int kwm = a.kp_mid / 4;
  const size_t smem = sizeof(int) * ((size_t)kwm * C::SA + KW * C::SA + KW * C::SB +
                                     (size_t)kwm * (HP | 1));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(qblock_kernel<TY, TN>,
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
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qblock_kernel<TY, TN>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long resident = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  void* params[] = {const_cast<ChainArgs*>(&c)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&qblock_kernel<TY, TN>),
                                  dim3(grid), dim3(THREADS), params, smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Launch one chain on `stream`; returns the CUDA error of the launch (0 on
// success). The caller checks shapes, dtypes, contiguity and 16-byte
// alignment of every pointer, and that the blocks share one geometry (n, h,
// w, c_mid, tile). Tiles of at most 16 pixels run 4 rows of 64 threads
// (512-channel GEMM tiles), larger ones 16 rows of 16 (128-channel tiles, or
// 64-channel tiles where c_mid <= 64).
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
  if (a0.tile_h * a0.tile_w <= 16) return launch<4, 8>(c, s);
  if (a0.c_mid <= 64) return launch<16, 4>(c, s);
  return launch<16, 8>(c, s);
}
