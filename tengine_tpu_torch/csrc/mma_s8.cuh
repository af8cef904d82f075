// Hopper (sm_80 and later) building blocks for int8 tensor-core kernels that
// stage K-major operand tiles in shared memory: asynchronous 16-byte copies,
// ldmatrix fragment loads and the m16n8k32 int8 warp-level product.
//
// Fragment layout of mma.m16n8k32 (g = lane / 4, t = lane % 4), as in the PTX
// manual and cute/arch/mma_sm80.hpp:
//   A (16 x 32 bytes, row-major)   a0: row g,   k 4t..4t+3     a1: row g+8, same k
//                                  a2: row g,   k 16+4t..      a3: row g+8, k 16+4t..
//   B (32 bytes x 8, column-major) b0: k 4t..4t+3, column g    b1: k 16+4t.., column g
//   C (16 x 8 int32)               c0, c1: row g,   columns 2t, 2t+1
//                                  c2, c3: row g+8, columns 2t, 2t+1
// One ldmatrix.x4 of four 8-row x 16-byte matrices delivers exactly these
// registers when lanes 8j..8j+7 hold the row addresses of matrix j: a thread
// receives bytes 4t..4t+3 of row g of every matrix.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_s8 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; the first
// src_bytes (0 or 16) come from src, the rest of the 16 are written as zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The same for 4 or 8 bytes (through L1: .cg takes 16 bytes only).
template <int BYTES>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src, int src_bytes) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's committed groups are still in
// flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t dst, uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t dst, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(dst), "r"(a) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a * b, int32 accumulation that wraps (no .satfinite).
__device__ __forceinline__ void mma_s8s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with A read as unsigned bytes.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- warpgroup MMA (sm_90a only): four warps start one asynchronous
// m64n128k32 product whose operands the tensor core reads from shared memory
// through 64-bit descriptors. Accumulator layout of a thread (warp w of the
// group owns rows 16w..16w+15): d[4j..4j+3] is the m16n8 C fragment above for
// columns 8j..8j+7.

// Descriptor of a K-major tile of 64-byte rows whose 16-byte chunks are
// XOR-swizzled by (row / 2) % 4 (the 64-byte swizzle mode; the tile starts
// on a 512-byte boundary): start address, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t gmma_desc_k64(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFFu) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the tensor core's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most PENDING of this warpgroup's committed groups are unfinished.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving uses of the accumulators across the point
// where the asynchronous products are known to have written them.
__device__ __forceinline__ void fence_registers(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A * B, A [64 x 32] and B [128 x 32] int8, both K-major in shared
// memory; int32 accumulation that wraps (no .satfinite).
__device__ __forceinline__ void wgmma_m64n128k32_s8s8(int (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

}  // namespace mma_s8
