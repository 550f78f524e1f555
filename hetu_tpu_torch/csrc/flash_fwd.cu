// Flash attention forward with log-sum-exp, for sm_90a (H100).
//
// Replaces hetu_tpu/ops/flash_pallas.py:184 _fwd_kernel (host wrapper
// _flash_fwd :257). Computes, per (batch, q head), softmax(q k^T * scale)
// v over the keys that survive the masks, streaming keys with an online
// softmax, and returns out in q's dtype plus the fp32 lse:
//   - GQA: q head h reads kv head h / (hq / hkv), no repeated KV;
//   - segment ids: query and key must carry equal ids (packed batches; pad
//     tokens carry -1 and so attend each other, as in the reference);
//   - causal with static absolute offsets: q row i at i + q_offset may see
//     key j at j + kv_offset iff i + q_offset >= j + kv_offset;
//   - key tiles wholly above the diagonal are never loaded (the TPU kernel's
//     diagonal block skip);
//   - a fully masked row gives out = 0 and lse = -1e30;
//   - dropout on the probabilities (the TPU kernel's in-kernel lane): the
//     position-hashed keep mask of attention_common.cuh `Dropout` scales
//     only what meets v, so l and the lse stay undropped (:226-234).
//
// What bounds it on an H100: bytes from HBM. At the serving path's shape
// (one packed row of C = 64 tokens, 12 heads, d = 64, fp32) the call must
// read q, K, V and write out and lse once, about 0.8 MB, and do at most
// 4 * 64 * 64 * 64 flops per head (fewer: causal and segment masks), so
// bytes over 3.35 TB/s outweigh flops over the 67 TFLOP/s of the fp32
// cores. Both are far below a launch; in practice latency sets the time:
// one HBM round trip per tile and the serial online softmax. At long
// sequences the flops (4 * sq * sk * d per head) take over.
//
// Design in response: one block per (16-query chunk, q head, batch row);
// the TPU kernel's sequential kv grid axis becomes a loop inside the
// block, carrying m, l and the accumulator in registers (4 rows per warp,
// d / 32 columns per lane). Keys are staged 32 at a time in shared memory,
// one key per lane for q k^T and one output column per lane for p v, all
// on fp32 CUDA cores. Tensor cores (wgmma) and TMA are later work.

#include "attention_common.cuh"

namespace {

using namespace hetu;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, T* __restrict__ out,
                 float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                 int d, float scale, int causal, int q_offset, int kv_offset,
                 Dropout drop) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;
  float* ks = qs + kRows * ld;
  float* vs = ks + kTile * ld;
  int* kseg = reinterpret_cast<int*>(vs + kTile * ld);

  const int q0 = blockIdx.x * kRows, ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qbase = ((size_t)ib * hq + ih) * sq * d;
  const size_t kbase = ((size_t)ib * hkv + ikv) * sk * d;
  const uint32_t salt = drop.salt(ib, ih);

  for (int e = threadIdx.x; e < kRows * d; e += blockDim.x) {
    const int r = e / d, c = e - r * d, qi = q0 + r;
    float x = 0.f;
    if (qi < sq) x = round_as(to_float(q[qbase + (size_t)qi * d + c]) * scale, q);
    qs[r * ld + c] = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxCols];
  int qseg[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
    qseg[i] = (q_seg != nullptr && qi < sq) ? q_seg[(size_t)ib * sq + qi] : 0;
#pragma unroll
    for (int t = 0; t < kMaxCols; ++t) acc[i][t] = 0.f;
  }

  // diagonal skip: keys past the block's last query position are masked
  // for every row of the block, so their tiles are never loaded
  int k_end = sk;
  if (causal) k_end = min(sk, max(0, q0 + kRows - 1 + q_offset - kv_offset + 1));

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // q staged / previous tile consumed
    for (int e = threadIdx.x; e < kTile * d; e += blockDim.x) {
      const int j = e / d, c = e - j * d, kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < sk) {
        const size_t src = kbase + (size_t)kj * d + c;
        kx = to_float(k[src]);
        vx = to_float(v[src]);
      }
      ks[j * ld + c] = kx;
      vs[j * ld + c] = vx;
    }
    if (threadIdx.x < kTile) {
      const int kj = k0 + threadIdx.x;
      kseg[threadIdx.x] =
          (kv_seg != nullptr && kj < sk) ? kv_seg[(size_t)ib * sk + kj] : 0;
    }
    __syncthreads();
    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i, qi = q0 + r;
      if (qi >= sq) continue;  // warp-uniform
      if (causal && k0 + kv_offset > qi + q_offset) continue;  // whole tile masked
      bool live = kj < sk;
      if (causal) live = live && (qi + q_offset >= kj + kv_offset);
      if (q_seg != nullptr) live = live && (qseg[i] == kseg[lane]);
      online_softmax_tile(qs + r * ld, ks, vs, ld, d, live, m[i], l[i], acc[i],
                          drop.scale(salt, qi + q_offset, kj + kv_offset));
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= sq) continue;
    finish_row(out + qbase + (size_t)qi * d,
               lse + ((size_t)ib * hq + ih) * sq + qi, d, m[i], l[i], acc[i]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* q_seg,
           const void* kv_seg, void* out, void* lse, int b, int hq, int hkv,
           int sq, int sk, int d, float scale, int causal, int q_offset,
           int kv_offset, Dropout drop, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kRows - 1) / kRows, hq, b);
  flash_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<T*>(out),
      static_cast<float*>(lse), hq, hkv, sq, sk, d, scale, causal, q_offset,
      kv_offset, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, sq, d), k/v (b, hkv, sk, d), contiguous, fp32 (bf16 == 0) or
// bf16 (bf16 == 1); q_seg (b, sq) / kv_seg (b, sk) int32, or both null;
// out (b, hq, sq, d) in q's dtype; lse (b, hq, sq) fp32; dropout when
// `drop_on`, with the uint32 seed and threshold and 1 / (1 - rate).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hetu_flash_fwd(const void* q, const void* k, const void* v,
                              const void* q_seg, const void* kv_seg,
                              void* out, void* lse, int b, int hq, int hkv,
                              int sq, int sk, int d, float scale, int causal,
                              int q_offset, int kv_offset, int bf16,
                              int drop_on, uint32_t seed, uint32_t threshold,
                              float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_on, seed, threshold, inv_keep};
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv,
                                 sq, sk, d, scale, causal, q_offset,
                                 kv_offset, drop, s);
  return launch<float>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv, sq, sk,
                       d, scale, causal, q_offset, kv_offset, drop, s);
}
