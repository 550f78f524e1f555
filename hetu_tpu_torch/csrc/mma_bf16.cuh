// Shared tensor-core primitives of the port's kernels (sm_90a): the bf16
// m16n8k16 product and its fragments, ldmatrix fragment loads, cp.async
// copies, the repack of an fp32 accumulator into a bf16 A operand, and
// the XOR-swizzled shared-memory row layout that ldmatrix reads without
// bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hetu {

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Operand fragments of one m16n8k16 product c (16 x 8, fp32) += A (16 x
// 16) B (16 x 8). Lane (g, t) = (lane / 4, lane % 4) holds c's rows g and
// g + 8, columns 2t and 2t + 1. The fragments come by ldmatrix (below); a
// caller loads one once and reuses it across the products that share it.
// (fused_ce.cu's Mma<float> runs the same layout on the CUDA cores.)
template <typename T> struct Mma;

// bf16: registers in mma.sync's layout, the product on the tensor cores
template <> struct Mma<__nv_bfloat16> {
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  __device__ __forceinline__ static void mma(float (&c)[4], const A& a,
                                             const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

using MmaBf16 = Mma<__nv_bfloat16>;

// ---- shared-memory tiles --------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Element (row, col) of a row-major tile of D bf16 columns, D a multiple
// of 64: 16-byte chunk c of row r is stored at chunk c ^ (r & 7) (within
// its group of 8 chunks, 128 bytes). The 8 rows one ldmatrix matrix reads
// at one logical chunk then land in 8 different 16-byte bank groups: no
// conflicts. cp.async writes whole chunks, so the swizzle costs nothing.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(D % 64 == 0, "swizzled rows hold whole 128-byte groups");
  const int c = col >> 3;
  return row * D + (((c ^ row) & 7) | (c & ~7)) * 8 + (col & 7);
}

// ---- ldmatrix: four 8 x 8 bf16 matrices per call --------------------------
// Lane l gives the address of row (l & 7) of matrix (l >> 3); register i
// receives matrix i in mma.sync's fragment layout (lane (g, t) holds row g,
// columns 2t and 2t + 1), or, with .trans, its transpose (row 2t and
// 2t + 1, column g).

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The A fragment of the 16 x 16 block at (r0, c0) of a swizzled tile.
template <int D>
__device__ __forceinline__ MmaBf16::A ldsm_a(const __nv_bfloat16* tile,
                                             int r0, int c0) {
  const int lane = threadIdx.x & 31;
  MmaBf16::A a;
  ldsm_x4(a.r, tile + swz<D>(r0 + (lane & 15), c0 + (lane >> 4) * 8));
  return a;
}

// B fragments of two n-tiles where B[k][n] = tile[n][k] (k contiguous:
// K in q k^T): n rows n0..n0+15, k columns k0..k0+15; b0 covers n0..n0+7,
// b1 n0+8..n0+15.
template <int D>
__device__ __forceinline__ void ldsm_bt(MmaBf16::B& b0, MmaBf16::B& b1,
                                        const __nv_bfloat16* tile, int n0,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4(r, tile + swz<D>(n0 + ((lane >> 4) << 3) + (lane & 7),
                           k0 + ((lane >> 3) & 1) * 8));
  b0 = {{r[0], r[1]}};
  b1 = {{r[2], r[3]}};
}

// B fragments of two n-tiles where B[k][n] = tile[k][n] (n contiguous: V
// in p v): k rows k0..k0+15, n columns n0..n0+15; b0 covers n0..n0+7,
// b1 n0+8..n0+15.
template <int D>
__device__ __forceinline__ void ldsm_b(MmaBf16::B& b0, MmaBf16::B& b1,
                                       const __nv_bfloat16* tile, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4_trans(r, tile + swz<D>(k0 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                 n0 + (lane >> 4) * 8));
  b0 = {{r[0], r[1]}};
  b1 = {{r[2], r[3]}};
}

// ---- the accumulator as the next product's A operand ---------------------
// c0 and c1 are the m16n8 fp32 accumulators of columns k..k+7 and
// k+8..k+15; each pair of a row is rounded to bf16 (round to nearest even,
// as __float2bfloat16) and packed, low column in the low half.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ MmaBf16::A acc_to_a(const float (&c0)[4],
                                               const float (&c1)[4]) {
  return {{pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]),
           pack_bf16(c1[0], c1[1]), pack_bf16(c1[2], c1[3])}};
}

// ---- cp.async: global -> shared without a trip through registers ---------
// `pred` false writes zeros and reads nothing (src-size 0): rows past a
// ragged edge come in as zeros.

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace hetu
