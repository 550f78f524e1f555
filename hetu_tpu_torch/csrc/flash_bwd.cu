// Flash attention backward, for sm_90a (H100): two kernels.
//
// Replaces hetu_tpu/ops/flash_pallas.py:355 _bwd_dq_kernel and :418
// _bwd_dkv_kernel (host wrapper _flash_bwd :492). From the forward's lse
// and delta = rowsum(dO * O) (an input: the wrapper computes it, a ring
// hop passes its own), with q~ = q * scale rounded to q's dtype as the
// forward does:
//   s  = q~ k^T, masked;  p = exp(s - lse), zeroed under the mask AFTER
//        the exp (a fully masked row has lse = s = -1e30, so exp gives 1);
//   dp = dO v^T, times the dropout factor (0 or 1 / (1 - rate));
//   ds = p (dp - delta);
//   dq = scale * ds k;  dk = ds^T q~;  dv = p~^T dO  (p~: p times the
//        dropout factor, what the forward mixed into out).
// Masks as in flash_fwd.cu: GQA, segment ids, causal with static absolute
// offsets; tiles wholly above the diagonal are skipped; the dropout mask
// is the forward's position hash (attention_common.cuh `Dropout`), so it
// does not depend on either kernel's tiles. p and ds stay fp32 for the
// second product, where the TPU kernels round them to the operand dtype
// (:402, :466, :475): bf16 grads differ in the last bits.
//
// What bounds them on an H100: operations. At the training shape (b rows
// of 1024 tokens, 12 heads, d = 64, causal) each kernel does 4 (dq) or 8
// (dk/dv) flops per (live q, k, column) against a few hundred bytes per
// row, so flops over the 67 TFLOP/s of the fp32 cores are the floor here
// (989 TFLOP/s once the products move to bf16 tensor cores).
//
// Design in response, for now simple and right: both kernels use the
// forward's layout of 4 warps on fp32 CUDA cores and shared-memory tiles
// of stride d + 1 (conflict-free per-lane rows).
//   - dq: one block per (16-query chunk, q head, batch row) loops over kv
//     tiles of 32 keys, one key per lane, and accumulates dq in registers
//     (d / 32 columns per lane), as the forward accumulates out.
//   - dk/dv: one block per (16-key chunk, KV head, batch row) loops over
//     the g = hq / hkv q heads of its group and their live q tiles of 32
//     queries, one query per lane. Summing the GQA group inside the block
//     needs no (b, hq, sk, d) fp32 buffer and no atomics, and the result
//     is deterministic (the TPU kernel writes per q head and sums after,
//     :614-616).
// Tensor cores (wgmma), TMA and a copy pipeline are later work.

#include "attention_common.cuh"

namespace {

using namespace hetu;

__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// Stage `rows` rows from row `r0` of a (n, d) matrix at `src` into smem
// (stride ld), fp32; q rows are pre-scaled and rounded like the forward's.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int rows, int n, int d, int ld,
                                           float scale, bool rounded) {
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    const int r = e / d, c = e - r * d, i = r0 + r;
    float x = 0.f;
    if (i < n) {
      x = to_float(src[(size_t)i * d + c]);
      if (rounded) x = round_as(x * scale, src);
    }
    dst[r * ld + c] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, T* __restrict__ dq,
                    int hq, int hkv, int sq, int sk, int d, float scale,
                    int causal, int q_offset, int kv_offset, Dropout drop) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                 // kRows x ld: q~
  float* dos = qs + kRows * ld;     // kRows x ld: dO
  float* ks = dos + kRows * ld;     // kTile x ld
  float* vs = ks + kTile * ld;      // kTile x ld
  int* kseg = reinterpret_cast<int*>(vs + kTile * ld);

  const int q0 = blockIdx.x * kRows, ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qbase = ((size_t)ib * hq + ih) * sq * d;
  const size_t kbase = ((size_t)ib * hkv + ikv) * sk * d;
  const size_t sbase = ((size_t)ib * hq + ih) * sq;
  const uint32_t salt = drop.salt(ib, ih);

  stage_rows(qs, q + qbase, q0, kRows, sq, d, ld, scale, true);
  stage_rows(dos, dout + qbase, q0, kRows, sq, d, ld, 1.f, false);

  float row_lse[kRowsPerWarp], row_delta[kRowsPerWarp], acc[kRowsPerWarp][kMaxCols];
  int qseg[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    const bool in = qi < sq;
    row_lse[i] = in ? lse[sbase + qi] : 0.f;
    row_delta[i] = in ? delta[sbase + qi] : 0.f;
    qseg[i] = (q_seg != nullptr && in) ? q_seg[(size_t)ib * sq + qi] : 0;
#pragma unroll
    for (int t = 0; t < kMaxCols; ++t) acc[i][t] = 0.f;
  }

  // diagonal skip: keys past the block's last query position are masked
  // for every row of the block
  int k_end = sk;
  if (causal) k_end = min(sk, max(0, q0 + kRows - 1 + q_offset - kv_offset + 1));

  const int ncol = d >> 5;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // q/dO staged / previous tile consumed
    stage_rows(ks, k + kbase, k0, kTile, sk, d, ld, 1.f, false);
    stage_rows(vs, v + kbase, k0, kTile, sk, d, ld, 1.f, false);
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
      if (qi >= sq) continue;                                   // warp-uniform
      if (causal && k0 + kv_offset > qi + q_offset) continue;  // tile masked
      bool live = kj < sk;
      if (causal) live = live && (qi + q_offset >= kj + kv_offset);
      if (q_seg != nullptr) live = live && (qseg[i] == kseg[lane]);
      const float s = dot_rows(qs + r * ld, ks + lane * ld, d);
      const float p = live ? expf(s - row_lse[i]) : 0.f;
      const float dp = dot_rows(dos + r * ld, vs + lane * ld, d) *
                       drop.scale(salt, qi + q_offset, kj + kv_offset);
      const float ds = p * (dp - row_delta[i]);
      for (int j = 0; j < kTile; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int t = 0; t < kMaxCols; ++t)
          if (t < ncol) acc[i][t] = fmaf(dsj, ks[j * ld + lane + 32 * t], acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= sq) continue;
    T* row = dq + qbase + (size_t)qi * d;
#pragma unroll
    for (int t = 0; t < kMaxCols; ++t)
      if (t < ncol) store(row + lane + 32 * t, acc[i][t] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, T* __restrict__ dk,
                     T* __restrict__ dv, int hq, int hkv, int sq, int sk,
                     int d, float scale, int causal, int q_offset,
                     int kv_offset, Dropout drop) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;                  // kRows x ld: this block's keys
  float* vs = ks + kRows * ld;       // kRows x ld
  float* qs = vs + kRows * ld;       // kTile x ld: q~ of one q tile
  float* dos = qs + kTile * ld;      // kTile x ld: its dO
  float* q_lse = dos + kTile * ld;   // kTile
  float* q_delta = q_lse + kTile;    // kTile
  int* q_ids = reinterpret_cast<int*>(q_delta + kTile);

  const int k0 = blockIdx.x * kRows, ikv = blockIdx.y, ib = blockIdx.z;
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t kbase = ((size_t)ib * hkv + ikv) * sk * d;

  stage_rows(ks, k + kbase, k0, kRows, sk, d, ld, 1.f, false);
  stage_rows(vs, v + kbase, k0, kRows, sk, d, ld, 1.f, false);

  float dk_acc[kRowsPerWarp][kMaxCols], dv_acc[kRowsPerWarp][kMaxCols];
  int kseg[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int kj = k0 + warp * kRowsPerWarp + i;
    kseg[i] = (kv_seg != nullptr && kj < sk) ? kv_seg[(size_t)ib * sk + kj] : 0;
#pragma unroll
    for (int t = 0; t < kMaxCols; ++t) dk_acc[i][t] = dv_acc[i][t] = 0.f;
  }

  // diagonal skip: queries before the block's first key position see none
  // of its keys, so their tiles are never loaded
  int q_begin = 0;
  if (causal) q_begin = (min(sq, max(0, k0 + kv_offset - q_offset)) / kTile) * kTile;

  const int ncol = d >> 5;
  for (int ih = ikv * g; ih < (ikv + 1) * g; ++ih) {
    const size_t qbase = ((size_t)ib * hq + ih) * sq * d;
    const size_t sbase = ((size_t)ib * hq + ih) * sq;
    const uint32_t salt = drop.salt(ib, ih);
    for (int q0 = q_begin; q0 < sq; q0 += kTile) {
      __syncthreads();  // k/v staged / previous tile consumed
      stage_rows(qs, q + qbase, q0, kTile, sq, d, ld, scale, true);
      stage_rows(dos, dout + qbase, q0, kTile, sq, d, ld, 1.f, false);
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        const bool in = qi < sq;
        q_lse[threadIdx.x] = in ? lse[sbase + qi] : 0.f;
        q_delta[threadIdx.x] = in ? delta[sbase + qi] : 0.f;
        q_ids[threadIdx.x] =
            (q_seg != nullptr && in) ? q_seg[(size_t)ib * sq + qi] : 0;
      }
      __syncthreads();
      const int qi = q0 + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i, kj = k0 + r;
        if (kj >= sk) continue;                                   // warp-uniform
        if (causal && q0 + kTile - 1 + q_offset < kj + kv_offset) continue;
        bool live = qi < sq;
        if (causal) live = live && (qi + q_offset >= kj + kv_offset);
        if (q_seg != nullptr) live = live && (q_ids[lane] == kseg[i]);
        const float s = dot_rows(qs + lane * ld, ks + r * ld, d);
        const float p = live ? expf(s - q_lse[lane]) : 0.f;
        const float f = drop.scale(salt, qi + q_offset, kj + kv_offset);
        const float dp = dot_rows(dos + lane * ld, vs + r * ld, d) * f;
        const float ds = p * (dp - q_delta[lane]);
        const float pd = p * f;
        for (int j = 0; j < kTile; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pd, j);
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int t = 0; t < kMaxCols; ++t)
            if (t < ncol) {
              const int c = j * ld + lane + 32 * t;
              dv_acc[i][t] = fmaf(pj, dos[c], dv_acc[i][t]);
              dk_acc[i][t] = fmaf(dsj, qs[c], dk_acc[i][t]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int kj = k0 + warp * kRowsPerWarp + i;
    if (kj >= sk) continue;
    const size_t off = kbase + (size_t)kj * d;
#pragma unroll
    for (int t = 0; t < kMaxCols; ++t)
      if (t < ncol) {
        store(dk + off + lane + 32 * t, dk_acc[i][t]);
        store(dv + off + lane + 32 * t, dv_acc[i][t]);
      }
  }
}

// Both kernels stage (kRows + kTile) x 2 rows of stride d + 1, plus a few
// words per tile row.
inline size_t bwd_smem_bytes(int d) {
  return (size_t)(2 * kRows + 2 * kTile) * (d + 1) * sizeof(float) +
         3 * kTile * sizeof(float);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* q_seg,
              const void* kv_seg, void* dq, int b, int hq, int hkv, int sq,
              int sk, int d, float scale, int causal, int q_offset,
              int kv_offset, Dropout drop, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kRows - 1) / kRows, hq, b);
  flash_bwd_dq_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<T*>(dq), hq, hkv, sq, sk, d, scale, causal, q_offset,
      kv_offset, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* q_seg,
               const void* kv_seg, void* dk, void* dv, int b, int hq, int hkv,
               int sq, int sk, int d, float scale, int causal, int q_offset,
               int kv_offset, Dropout drop, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(d);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + kRows - 1) / kRows, hkv, b);
  flash_bwd_dkv_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv, sq, sk, d, scale,
      causal, q_offset, kv_offset, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q/dout (b, hq, sq, d), k/v (b, hkv, sk, d), contiguous, fp32 (bf16 == 0)
// or bf16 (bf16 == 1); lse/delta (b, hq, sq) fp32; q_seg (b, sq) / kv_seg
// (b, sk) int32, or both null; dropout as in hetu_flash_fwd. dq comes out
// in q's dtype, dk/dv in k's. Each launches on `stream` and returns
// cudaGetLastError().
extern "C" int hetu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_seg,
                                 const void* kv_seg, void* dq, int b, int hq,
                                 int hkv, int sq, int sk, int d, float scale,
                                 int causal, int q_offset, int kv_offset,
                                 int bf16, int drop_on, uint32_t seed,
                                 uint32_t threshold, float inv_keep,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_on, seed, threshold, inv_keep};
  if (bf16)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, q_seg, kv_seg,
                                    dq, b, hq, hkv, sq, sk, d, scale, causal,
                                    q_offset, kv_offset, drop, s);
  return launch_dq<float>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, b, hq,
                          hkv, sq, sk, d, scale, causal, q_offset, kv_offset,
                          drop, s);
}

extern "C" int hetu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* q_seg,
                                  const void* kv_seg, void* dk, void* dv,
                                  int b, int hq, int hkv, int sq, int sk,
                                  int d, float scale, int causal,
                                  int q_offset, int kv_offset, int bf16,
                                  int drop_on, uint32_t seed,
                                  uint32_t threshold, float inv_keep,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_on, seed, threshold, inv_keep};
  if (bf16)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, q_seg, kv_seg,
                                     dk, dv, b, hq, hkv, sq, sk, d, scale,
                                     causal, q_offset, kv_offset, drop, s);
  return launch_dkv<float>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, b,
                           hq, hkv, sq, sk, d, scale, causal, q_offset,
                           kv_offset, drop, s);
}
