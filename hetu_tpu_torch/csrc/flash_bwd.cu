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
// does not depend on either kernel's tiles. With bf16 inputs ds is rounded
// to k's dtype before dq = ds k (:402), p~ to dO's before dv (:466) and
// ds to q's before dk (:475), as the TPU kernels round them.
//
// What bounds them on an H100: operations. At the training shape (32 rows
// of 1024 tokens, 12 heads, d = 64, causal, bf16) each kernel does 6 (dq)
// or 8 (dk/dv) flops per (live q, k, column) against a few hundred bytes
// per row: dk/dv's 103.2 GFLOP take 0.1043 ms on the 989 TFLOP/s of the
// bf16 tensor cores (1.54 ms on the 67 TFLOP/s of the fp32 cores), its
// 305 MB 0.0911 ms at 3.35 TB/s; dq's 77.4 GFLOP take 0.0782 ms, its
// 255 MB 0.0761 ms.
//
// Each kernel has two lanes, picked from dtype and head_dim before the
// launch (ops/flash.py flash_lane): the tensor cores for bf16 at d = 64
// and 128, the CUDA cores for fp32 at any d and bf16 at other d.
//
// dq (#3):
//   - Tensor cores: one block of 4 warps per (64-query tile, q head,
//     batch row); warp w owns queries 16w..16w+15 and keeps their dq in
//     fp32 registers (d / 2 a thread). q and dO of the tile come in once
//     by cp.async; each thread rounds the q chunks it copied to q~ = q *
//     scale in bf16 in place (bit-equal to the forward's q~). They stay
//     as A fragments in registers at d = 64 and are re-read by ldmatrix
//     per kv tile at d = 128. lse, delta and the q segment ids of a
//     thread's two rows stay in registers. K, V and the key segment ids
//     stream in 64-key tiles through a 2-stage cp.async ring, up to the
//     block's last visible key (tiles wholly above the diagonal never
//     load). Per kv tile, all on mma.sync m16n8k16 with fp32
//     accumulators:
//       S = q~ K^T;  dP = dO V^T (K and V k-contiguous B operands);
//       P = exp(S - lse), zeroed under the mask after the exp;
//       dS = P (dP x the dropout factor - delta);
//       dQ += round_bf16(dS) K (dS repacked in registers as the A
//       operand, K an n-contiguous B operand by ldmatrix.trans).
//     Masks only on tiles that straddle the diagonal, the ragged edge or
//     (a warp vote) a segment boundary. dq = round_bf16(acc * scale) is
//     written once, in packed pairs: no atomics, a deterministic result.
//     Shared memory: q~, dO and two stages of K, V and the key ids, rows
//     XOR-swizzled: 49,664 B at d = 64, 98,816 B at d = 128.
//   - CUDA cores: the forward's CUDA-core layout of 4 warps on fp32
//     cores, shared-memory tiles of stride d + 1 (conflict-free per-lane
//     rows). One block per (16-query chunk, q head, batch row) loops over
//     kv tiles of 32 keys, one key per lane, and accumulates dq in
//     registers (d / 32 columns per lane), as the forward accumulates out.
//
// dk/dv (#4). Both lanes sum the g = hq / hkv q heads of a GQA
// group inside the block: no (b, hq, sk, d) fp32 buffer, no atomics, a
// deterministic result (the TPU kernel writes per q head and sums after,
// :614-616).
//   - Tensor cores, bf16 at d = 64 and 128: one block of 4 warps per
//     (64-key tile, kv head, batch row); warp w owns keys 16w..16w+15 and
//     keeps their dK and dV in fp32 registers (d / 2 each a thread). The
//     block loops over the q heads of its group and their live 64-query
//     tiles (the first from the causal skip), streaming q, dO, lse, delta
//     and the q segment ids per tile through a 2-stage cp.async ring; each
//     thread rounds the q chunks it copied to q~ = q * scale in bf16 in
//     place (bit-equal to the forward's q~). K and V stay resident. Per q
//     tile, all on mma.sync m16n8k16 with fp32 accumulators:
//       S^T = K q~^T;  P^T = exp(S^T - lse), zeroed under the mask;
//       dV += round_bf16(P~^T) dO;  dP^T = V dO^T x the dropout factor;
//       dS^T = P^T (dP^T - delta);  dK += round_bf16(dS^T) q~.
//     P and dS become the next product's A operand in registers; q~ and
//     dO are B operands by ldmatrix (.trans for the k-major ones); masks
//     only on tiles that straddle the diagonal, the ragged edge or a
//     segment boundary. Shared memory: K, V and two stages of q~, dO and
//     the per-query words, rows XOR-swizzled: 50,688 B at d = 64, 99,840 B
//     at d = 128.
//   - CUDA cores, fp32 at any d and bf16 at other d: one block per (16-key
//     chunk, kv head, batch row) loops over the q tiles of 32 queries of
//     every q head of its group, one query per lane; with bf16 inputs p~
//     and ds are rounded before their products (round_as) as above.

#include "attention_common.cuh"
#include "mma_bf16.cuh"

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
      // ds rounded to k's dtype before ds k (flash_pallas.py:402)
      const float ds = round_as(p * (dp - row_delta[i]), k);
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
        // rounded where the TPU kernel rounds (flash_pallas.py:466, :475)
        const float ds = round_as(p * (dp - q_delta[lane]), q);
        const float pd = round_as(p * f, dout);
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

// ---- the tensor-core lanes (bf16, d = 64 or 128) ---------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps x 16 keys (dk/dv) or queries (dq)
constexpr int kTcKeys = 64;      // keys per tile
constexpr int kTcRows = 64;      // queries per tile

// K and V, then 2 stages of q~, dO and the per-query lse, delta, segment id
template <int D>
__host__ __device__ constexpr size_t tc_stage_bytes() {
  return (size_t)2 * kTcRows * D * sizeof(bf16) + 3 * kTcRows * 4;
}
template <int D>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return (size_t)2 * kTcKeys * D * sizeof(bf16) + 2 * tc_stage_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ kv_seg, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int hq, int hkv, int sq,
                        int sk, float scale, int causal, int q_offset,
                        int kv_offset, Dropout drop) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kTcKeys x D
  bf16* vs = ks + kTcKeys * D;                   // kTcKeys x D
  unsigned char* stages = reinterpret_cast<unsigned char*>(vs + kTcKeys * D);
  // stage st: q~ and dO (kTcRows x D each), then lse, delta, segment ids
  auto q_at = [&](int st) {
    return reinterpret_cast<bf16*>(stages + st * tc_stage_bytes<D>());
  };
  auto do_at = [&](int st) { return q_at(st) + kTcRows * D; };
  auto lse_at = [&](int st) {
    return reinterpret_cast<float*>(do_at(st) + kTcRows * D);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTcKeys, ikv = blockIdx.y, ib = blockIdx.z;
  const int g = hq / hkv;
  const size_t kbase = ((size_t)ib * hkv + ikv) * sk * D;
  const bool has_seg = q_seg != nullptr;

  // diagonal skip: queries before the block's first key position see none
  // of its keys, so their tiles are never loaded
  int q_first = 0;
  if (causal) q_first = max(0, k0 + kv_offset - q_offset);
  const int q_begin = (q_first / kTcRows) * kTcRows;
  const int n_qt = q_first >= sq ? 0 : (sq - q_begin + kTcRows - 1) / kTcRows;
  const int n_it = g * n_qt;

  for (int c = tid; c < kTcKeys * CH; c += kTcThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool in = k0 + r < sk;
    const size_t src = kbase + (size_t)(in ? k0 + r : 0) * D + col;
    cp_async16(ks + swz<D>(r, col), k + src, in);
    cp_async16(vs + swz<D>(r, col), v + src, in);
  }
  cp_async_commit();

  auto load_q = [&](int it) {
    const int ih = ikv * g + it / n_qt, q0 = q_begin + (it % n_qt) * kTcRows;
    const int st = it & 1;
    const size_t sbase = ((size_t)ib * hq + ih) * sq;
    bf16 *qd = q_at(st), *dod = do_at(st);
    for (int c = tid; c < kTcRows * CH; c += kTcThreads) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool in = q0 + r < sq;
      const size_t src = (sbase + (in ? q0 + r : 0)) * D + col;
      cp_async16(qd + swz<D>(r, col), q + src, in);
      cp_async16(dod + swz<D>(r, col), dout + src, in);
    }
    if (tid < kTcRows) {
      const bool in = q0 + tid < sq;
      const size_t i = sbase + (in ? q0 + tid : 0);
      float* w = lse_at(st);
      cp_async4(w + tid, lse + i, in);
      cp_async4(w + kTcRows + tid, delta + i, in);
      if (has_seg)
        cp_async4(w + 2 * kTcRows + tid,
                  q_seg + (size_t)ib * sq + (in ? q0 + tid : 0), in);
    }
    cp_async_commit();
  };
  if (n_it > 0) load_q(0);

  const int kw = k0 + warp * 16;  // this warp's first key
  const int keys[2] = {kw + gr, kw + gr + 8};
  int kseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (has_seg && keys[r] < sk) kseg[r] = kv_seg[(size_t)ib * sk + keys[r]];

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_q(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int ih = ikv * g + it / n_qt, q0 = q_begin + (it % n_qt) * kTcRows;
    const int st = it & 1;
    bf16* qt = q_at(st);
    const bf16* dot = do_at(st);
    const float* w = lse_at(st);
    // q~ = q * scale rounded to bf16, in place, by the thread that copied
    // each chunk (its own cp.async writes are visible to it after the wait)
    for (int c = tid; c < kTcRows * CH; c += kTcThreads) {
      const int r = c / CH, col = (c % CH) * 8;
      uint4* p = reinterpret_cast<uint4*>(qt + swz<D>(r, col));
      uint4 x = *p;
      bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      *p = x;
    }
    __syncthreads();  // stage it (and K/V) complete for every thread

    // warp-uniform: every query of the tile before this warp's first key
    const bool dead = causal && q0 + kTcRows - 1 + q_offset < kw + kv_offset;
    if (!dead) {
      const uint32_t salt = drop.salt(ib, ih);
      // S^T (16 keys x 64 queries) = K q~^T
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const MmaBf16::A a = ldsm_a<D>(ks, warp * 16, kk * 16);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          MmaBf16::B b0, b1;
          ldsm_bt<D>(b0, b1, qt, n * 8, kk * 16);
          MmaBf16::mma(s[n], a, b0);
          MmaBf16::mma(s[n + 1], a, b1);
        }
      }

      // masks, only where the tile is not wholly live for this warp;
      // element (n, i): key keys[i >> 1], query q0 + n * 8 + 2t + (i & 1)
      bool masked = q0 + kTcRows > sq ||
                    (causal && q0 + q_offset < kw + 15 + kv_offset);
      const int* qseg = reinterpret_cast<const int*>(w + 2 * kTcRows);
      if (has_seg && !masked) {
        bool same = true;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int id = qseg[n * 8 + 2 * t + e];
            same = same && id == kseg[0] && id == kseg[1];
          }
        masked = !__all_sync(0xffffffffu, same);
      }
      uint32_t keep = 0xffffffffu;  // bit 4n + i: the dropout keep bit
      // P^T = exp(S^T - lse), zeroed under the mask after the exp
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = n * 8 + 2 * t + (i & 1), qi = q0 + c;
          const int kj = keys[i >> 1];
          bool ok = true;
          if (masked) {
            ok = qi < sq;
            if (causal) ok = ok && qi + q_offset >= kj + kv_offset;
            if (has_seg) ok = ok && qseg[c] == kseg[i >> 1];
          }
          const float x = ok ? s[n][i] : kNegInf;
          s[n][i] = ok ? __expf(x - w[c]) : 0.f;
          if (drop.on &&
              drop.scale(salt, qi + q_offset, kj + kv_offset) == 0.f)
            keep &= ~(1u << (4 * n + i));
        }

      // dV += round_bf16(P~^T) dO: queries kk*16..kk*16+15 are the k-step
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float pd[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = 2 * kk + h;
            const bool kept = (keep >> (4 * n + i)) & 1u;
            pd[h][i] = drop.on ? (kept ? s[n][i] * drop.inv_keep : 0.f)
                               : s[n][i];
          }
        const MmaBf16::A a = acc_to_a(pd[0], pd[1]);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          MmaBf16::B b0, b1;
          ldsm_b<D>(b0, b1, dot, kk * 16, n * 8);
          MmaBf16::mma(dva[n], a, b0);
          MmaBf16::mma(dva[n + 1], a, b1);
        }
      }

      // dP^T (16 keys x 64 queries) = V dO^T
      float dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const MmaBf16::A a = ldsm_a<D>(vs, warp * 16, kk * 16);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          MmaBf16::B b0, b1;
          ldsm_bt<D>(b0, b1, dot, n * 8, kk * 16);
          MmaBf16::mma(dp[n], a, b0);
          MmaBf16::mma(dp[n + 1], a, b1);
        }
      }
      // dS^T = P^T (dP^T x factor - delta), into dp
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = dp[n][i];
          if (drop.on)
            x = (keep >> (4 * n + i)) & 1u ? x * drop.inv_keep : 0.f;
          dp[n][i] = s[n][i] * (x - w[kTcRows + n * 8 + 2 * t + (i & 1)]);
        }

      // dK += round_bf16(dS^T) q~
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const MmaBf16::A a = acc_to_a(dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          MmaBf16::B b0, b1;
          ldsm_b<D>(b0, b1, qt, kk * 16, n * 8);
          MmaBf16::mma(dka[n], a, b0);
          MmaBf16::mma(dka[n + 1], a, b1);
        }
      }
    }
    __syncthreads();  // stage it consumed before tile it + 2 refills it
  }
  cp_async_wait<0>();  // the K/V group when there was no q tile

  // dK and dV written once, in k's and v's dtype
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= sk) continue;
    const size_t off = kbase + (size_t)keys[r] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* q_seg, const void* kv_seg, void* dk, void* dv,
                  int b, int hq, int hkv, int sq, int sk, float scale,
                  int causal, int q_offset, int kv_offset, Dropout drop,
                  cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + kTcKeys - 1) / kTcKeys, hkv, b);
  flash_bwd_dkv_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, sq, sk, scale,
      causal, q_offset, kv_offset, drop);
  return (int)cudaGetLastError();
}

// ---- dq on the tensor cores -------------------------------------------------

// q~ and dO of the block's queries, then 2 stages of K, V and the key
// segment ids
template <int D>
__host__ __device__ constexpr size_t dq_tc_smem_bytes() {
  return (size_t)(2 * kTcRows + 4 * kTcKeys) * D * sizeof(bf16) +
         2 * kTcKeys * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ q_seg,
                       const int* __restrict__ kv_seg, bf16* __restrict__ dq,
                       int hq, int hkv, int sq, int sk, float scale,
                       int causal, int q_offset, int kv_offset, Dropout drop) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  // q~ and dO as A fragments in registers at d = 64; at d = 128 they are
  // read again by ldmatrix for each kv tile, which keeps the registers
  // under the 2-blocks-per-SM budget
  constexpr bool kResident = D == 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kTcRows x D: q~
  bf16* dos = qs + kTcRows * D;                  // kTcRows x D: dO
  bf16* ks = dos + kTcRows * D;                  // 2 stages x kTcKeys x D
  bf16* vs = ks + 2 * kTcKeys * D;               // 2 stages x kTcKeys x D
  int* kseg_s = reinterpret_cast<int*>(vs + 2 * kTcKeys * D);  // 2 x kTcKeys

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTcRows, ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const size_t sbase = ((size_t)ib * hq + ih) * sq;  // row (ib, ih, 0)
  const bf16* kb = k + ((size_t)ib * hkv + ikv) * sk * D;
  const bf16* vb = v + ((size_t)ib * hkv + ikv) * sk * D;
  const bool has_seg = q_seg != nullptr;

  // diagonal skip: tiles past the block's last query position never load
  int k_end = sk;
  if (causal)
    k_end = min(sk, max(0, q0 + kTcRows - 1 + q_offset - kv_offset + 1));
  const int n_tiles = (k_end + kTcKeys - 1) / kTcKeys;

  for (int c = tid; c < kTcRows * CH; c += kTcThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool in = q0 + r < sq;
    const size_t src = (sbase + (in ? q0 + r : 0)) * D + col;
    cp_async16(qs + swz<D>(r, col), q + src, in);
    cp_async16(dos + swz<D>(r, col), dout + src, in);
  }
  cp_async_commit();

  auto load_tile = [&](int j) {
    const int k0 = j * kTcKeys, st = j & 1;
    bf16* kd = ks + st * kTcKeys * D;
    bf16* vd = vs + st * kTcKeys * D;
    for (int c = tid; c < kTcKeys * CH; c += kTcThreads) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool in = k0 + r < sk;
      const size_t src = (size_t)(in ? k0 + r : 0) * D + col;
      cp_async16(kd + swz<D>(r, col), kb + src, in);
      cp_async16(vd + swz<D>(r, col), vb + src, in);
    }
    if (has_seg && tid < kTcKeys) {
      const bool in = k0 + tid < sk;
      cp_async4(kseg_s + st * kTcKeys + tid,
                kv_seg + (size_t)ib * sk + (in ? k0 + tid : 0), in);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_tile(0);
    cp_async_wait<1>();  // q and dO landed; tile 0 may be in flight
  } else {
    cp_async_wait<0>();
  }
  // q~ = q * scale rounded to bf16, in place, by the thread that copied
  // each chunk (bit-equal to the forward's q~)
  for (int c = tid; c < kTcRows * CH; c += kTcThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4* p = reinterpret_cast<uint4*>(qs + swz<D>(r, col));
    uint4 x = *p;
    bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
    *p = x;
  }

  const int qw = q0 + warp * 16;  // this warp's first query row
  const int rows[2] = {qw + gr, qw + gr + 8};
  float row_lse[2], row_delta[2];
  int qseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < sq;
    row_lse[r] = in ? lse[sbase + rows[r]] : 0.f;
    row_delta[r] = in ? delta[sbase + rows[r]] : 0.f;
    if (has_seg && in) qseg[r] = q_seg[(size_t)ib * sq + rows[r]];
  }
  __syncthreads();  // q~ and dO complete for every thread
  MmaBf16::A qa[D / 16], da[D / 16];
  if (kResident) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk] = ldsm_a<D>(qs, warp * 16, kk * 16);
      da[kk] = ldsm_a<D>(dos, warp * 16, kk * 16);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const uint32_t salt = drop.salt(ib, ih);

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every thread
    const int k0 = j * kTcKeys, st = j & 1;
    const bf16* kt = ks + st * kTcKeys * D;
    const bf16* vt = vs + st * kTcKeys * D;
    const int* kseg = kseg_s + st * kTcKeys;
    // warp-uniform: every key of the tile above this warp's diagonal
    const bool dead = causal && k0 + kv_offset > qw + 15 + q_offset;
    if (!dead) {
      // S = q~ K^T and dP = dO V^T (16 queries x 64 keys each)
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const MmaBf16::A a =
            kResident ? qa[kk] : ldsm_a<D>(qs, warp * 16, kk * 16);
        const MmaBf16::A b =
            kResident ? da[kk] : ldsm_a<D>(dos, warp * 16, kk * 16);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          MmaBf16::B b0, b1;
          ldsm_bt<D>(b0, b1, kt, n * 8, kk * 16);
          MmaBf16::mma(s[n], a, b0);
          MmaBf16::mma(s[n + 1], a, b1);
          ldsm_bt<D>(b0, b1, vt, n * 8, kk * 16);
          MmaBf16::mma(dp[n], b, b0);
          MmaBf16::mma(dp[n + 1], b, b1);
        }
      }

      // masks, only where the tile is not wholly live for this warp;
      // element (n, i): query rows[i >> 1], key k0 + n * 8 + 2t + (i & 1)
      bool masked = k0 + kTcKeys > sk ||
                    (causal && k0 + kTcKeys - 1 + kv_offset > qw + q_offset);
      if (has_seg && !masked) {
        bool same = true;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int id = kseg[n * 8 + 2 * t + e];
            same = same && id == qseg[0] && id == qseg[1];
          }
        masked = !__all_sync(0xffffffffu, same);
      }
      // P = exp(S - lse), zeroed under the mask after the exp; dS = P (dP
      // x the dropout factor - delta), into dp
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + n * 8 + 2 * t + (i & 1), r = i >> 1;
          bool ok = true;
          if (masked) {
            ok = kj < sk;
            if (causal) ok = ok && rows[r] + q_offset >= kj + kv_offset;
            if (has_seg) ok = ok && kseg[kj - k0] == qseg[r];
          }
          const float p = ok ? __expf(s[n][i] - row_lse[r]) : 0.f;
          float x = dp[n][i];
          if (drop.on)
            x *= drop.scale(salt, rows[r] + q_offset, kj + kv_offset);
          dp[n][i] = p * (x - row_delta[r]);
        }

      // dQ += round_bf16(dS) K: keys kk*16..kk*16+15 are the k-step
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const MmaBf16::A a = acc_to_a(dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          MmaBf16::B b0, b1;
          ldsm_b<D>(b0, b1, kt, kk * 16, n * 8);
          MmaBf16::mma(acc[n], a, b0);
          MmaBf16::mma(acc[n + 1], a, b1);
        }
      }
    }
    __syncthreads();  // stage j & 1 consumed before tile j + 2 refills it
  }

  // dq = round_bf16(acc * scale), written once; a row that saw no live
  // key gives exact 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    bf16* row = dq + (sbase + rows[r]) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* q_seg, const void* kv_seg, void* dq, int b,
                 int hq, int hkv, int sq, int sk, float scale, int causal,
                 int q_offset, int kv_offset, Dropout drop,
                 cudaStream_t stream) {
  const size_t smem = dq_tc_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kTcRows - 1) / kTcRows, hq, b);
  flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<bf16*>(dq), hq, hkv, sq, sk, scale, causal, q_offset,
      kv_offset, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q/dout (b, hq, sq, d), k/v (b, hkv, sk, d), contiguous, fp32 (bf16 == 0)
// or bf16 (bf16 == 1; 16-byte aligned at d = 64 and 128);
// lse/delta (b, hq, sq) fp32; q_seg (b, sq) / kv_seg
// (b, sk) int32, or both null; dropout as in hetu_flash_fwd. dq comes out
// in q's dtype, dk/dv in k's. Each launches on `stream` and returns
// cudaGetLastError().
extern "C" int hetu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_seg,
                                 const void* kv_seg, void* dq, int b, int hq,
                                 int hkv, int sq, int sk, int d, float scale,
                                 int causal, int q_offset, int kv_offset,
                                 int bf16, int drop_on, const void* seed,
                                 uint32_t threshold, float inv_keep,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_on, static_cast<const uint32_t*>(seed), threshold,
                     inv_keep};
  // the lane, from dtype and head_dim alone (ops/flash.py flash_lane)
  if (bf16 && d == 64)
    return launch_dq_tc<64>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, b,
                            hq, hkv, sq, sk, scale, causal, q_offset,
                            kv_offset, drop, s);
  if (bf16 && d == 128)
    return launch_dq_tc<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, b,
                             hq, hkv, sq, sk, scale, causal, q_offset,
                             kv_offset, drop, s);
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
                                  int drop_on, const void* seed,
                                  uint32_t threshold, float inv_keep,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_on, static_cast<const uint32_t*>(seed), threshold,
                     inv_keep};
  // the lane, from dtype and head_dim alone (ops/flash.py flash_lane)
  if (bf16 && d == 64)
    return launch_dkv_tc<64>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv,
                             b, hq, hkv, sq, sk, scale, causal, q_offset,
                             kv_offset, drop, s);
  if (bf16 && d == 128)
    return launch_dkv_tc<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk,
                              dv, b, hq, hkv, sq, sk, scale, causal, q_offset,
                              kv_offset, drop, s);
  if (bf16)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, q_seg, kv_seg,
                                     dk, dv, b, hq, hkv, sq, sk, d, scale,
                                     causal, q_offset, kv_offset, drop, s);
  return launch_dkv<float>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, b,
                           hq, hkv, sq, sk, d, scale, causal, q_offset,
                           kv_offset, drop, s);
}
