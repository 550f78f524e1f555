// Shared pieces of the port's attention kernels: element conversion, warp
// reductions, and the online-softmax update of one query row against one
// tile of 32 keys (one key per lane).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace hetu {

// 4 warps per block, 4 query rows per warp; keys are staged 32 at a time,
// one per lane; each lane owns head_dim / 32 output columns (head_dim <= 256).
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kTile = 32;
constexpr int kMaxCols = 8;
// masked logits are finite, as in the reference: a fully masked row ends
// with l == 0 and gives out = 0, lse = kNegInf, never NaN
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to the element type T and back: the softmax scale is folded
// into q and cast back to q's dtype before the dot, as the TPU kernels do
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// murmur3 fmix32 (hetu_tpu/core/bits.py)
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The flash kernels' dropout lane (hetu_tpu/ops/flash_pallas.py:108
// _dropout_keep): a counter hash of the absolute (q, k) position, the
// batch row and the q head, so every kernel regenerates the same mask
// whatever its tiles. `threshold` is min(2^32 - 1, int(rate * 2^32)),
// computed on the host; a kept probability is scaled by 1 / (1 - rate).
// The seed is a word in device memory (null when off), read where a block
// takes its salt, so a captured graph replays with the seed the host
// staged for that step.
struct Dropout {
  int on;
  const uint32_t* seed;
  uint32_t threshold;
  float inv_keep;

  // the per-(batch row, q head) salt
  __device__ __forceinline__ uint32_t salt(int ib, int ih) const {
    const uint32_t s = on ? __ldg(seed) : 0u;
    return fmix32(s ^ ((uint32_t)ib * 0x27D4EB2Fu) ^
                  ((uint32_t)ih * 0x165667B1u));
  }
  // the factor a probability at absolute (qpos, kpos) is multiplied by
  // before it meets v (or dO): 0 if dropped, 1 / (1 - rate) if kept
  __device__ __forceinline__ float scale(uint32_t salt, int qpos,
                                         int kpos) const {
    if (!on) return 1.f;
    const uint32_t u = fmix32(((uint32_t)qpos * 0x9E3779B1u) ^
                              ((uint32_t)kpos * 0x85EBCA77u) ^ salt);
    return u >= threshold ? inv_keep : 0.f;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether an element type is bf16: the lanes whose V was staged from bf16
// round p before p v.
template <typename T>
constexpr bool kIsBf16 = false;
template <>
constexpr bool kIsBf16<__nv_bfloat16> = true;

// One online-softmax step for one query row against the staged key tile.
// Called by a whole warp; lane j holds key j. qrow: the row's scaled q in
// shared memory; ks/vs: the tile (kTile rows of stride ld); live: whether
// lane's key is visible to this row; drop: the dropout factor of lane's
// key (1 without dropout), which scales only what meets v, so l and the
// lse stay undropped. m starts at -inf (so exp(m_prev - m_next) never
// sees -inf - -inf), l and acc at 0. kRoundP (V staged from bf16): p,
// relative to the running max and times the dropout factor, is rounded to
// bf16 before p v, as the TPU kernels cast p to v's dtype
// (paged_pallas.py:148, flash_pallas.py:235); l stays fp32, undropped and
// unrounded.
template <bool kRoundP>
__device__ __forceinline__ void online_softmax_tile(
    const float* qrow, const float* ks, const float* vs, int ld, int d,
    bool live, float& m, float& l, float (&acc)[kMaxCols],
    float drop = 1.f) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(qrow[c], ks[lane * ld + c], s);
  s = live ? s : kNegInf;
  const float m_next = fmaxf(m, warp_max(s));
  const float p = live ? expf(s - m_next) : 0.f;
  const float alpha = expf(m - m_next);
  l = alpha * l + warp_sum(p);
  m = m_next;
  float pv = p * drop;
  if (kRoundP) pv = __bfloat162float(__float2bfloat16_rn(pv));
  const int ncol = d >> 5;
#pragma unroll
  for (int t = 0; t < kMaxCols; ++t) acc[t] *= alpha;
  for (int j = 0; j < kTile; ++j) {
    const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
    for (int t = 0; t < kMaxCols; ++t)
      if (t < ncol) acc[t] = fmaf(pj, vs[j * ld + lane + 32 * t], acc[t]);
  }
}

// Final normalisation of one row: out = acc / l, lse = m + log(l); a row
// that saw no live key (l == 0) gives exact 0 and kNegInf.
template <typename T>
__device__ __forceinline__ void finish_row(T* out_row, float* lse_slot,
                                           int d, float m, float l,
                                           const float (&acc)[kMaxCols]) {
  const int lane = threadIdx.x & 31;
  const float l_safe = l == 0.f ? 1.f : l;
  const int ncol = d >> 5;
#pragma unroll
  for (int t = 0; t < kMaxCols; ++t)
    if (t < ncol) store(out_row + lane + 32 * t, acc[t] / l_safe);
  if (lse_slot != nullptr && lane == 0)
    *lse_slot = l == 0.f ? kNegInf : m + logf(l_safe);
}

// Dynamic shared memory of one block: kRows scaled q rows plus one K and
// one V tile, all fp32 with a padded stride of d + 1 (lane j reading key
// row j at column c then hits bank (j + c) % 32: no conflicts), plus one
// int per key for segment ids.
inline size_t smem_bytes(int d) {
  return (size_t)(kRows + 2 * kTile) * (d + 1) * sizeof(float) +
         kTile * sizeof(int);
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace hetu

extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
