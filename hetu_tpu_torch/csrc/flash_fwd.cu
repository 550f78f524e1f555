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
// What bounds it on an H100. At the serving path's shape (one packed row
// of C = 64 tokens, 12 heads, d = 64, fp32) the call must read q, K, V and
// write out and lse once, about 0.8 MB, and do at most 4 * 64 * 64 * 64
// flops per head: both far below a launch, so latency sets the time. At
// the training shape (32 rows of 1024 tokens, 12 heads, d = 64, causal,
// bf16) the two bounds are close: 4d flops per live (q, k) pair, 51.6
// GFLOP, take 0.0522 ms on the 989 TFLOP/s of the bf16 tensor cores, and
// its 203 MB (q, K, V read, out and lse written once) 0.0606 ms at 3.35
// TB/s. Either way only the tensor cores come near it: the 67 TFLOP/s of
// the fp32 cores alone need 0.77 ms.
//
// Two lanes, picked from dtype and head_dim before the launch
// (ops/flash.py flash_lane):
//
// The tensor-core lane: bf16 at d = 64 and 128 (the training shape, the
// Llama pack). One block of 4 warps per (64-query tile, q head, batch
// row); warp w owns query rows 16w..16w+15 of the tile.
//   - q~ = q * scale is rounded to bf16 (as the TPU kernel's host wrapper
//     does, :275) on its way into shared memory and held, after one
//     ldmatrix pass, as mma.sync A fragments in registers (d / 4 a thread).
//   - K and V stream in 64-key tiles through a 2-stage cp.async ring:
//     tile j + 1 is in flight while tile j is multiplied. Shared memory
//     holds q~ and both stages of K and V, rows XOR-swizzled by 16-byte
//     chunk (mma_bf16.cuh swz: conflict-free ldmatrix): 5 * 64 * d * 2
//     bytes plus the key segment ids, 41,472 B at d = 64, 82,432 B at
//     d = 128 (opted in above 48 KB).
//   - S = q~ K^T by mma.sync m16n8k16 (fp32 accumulators, 32 a thread).
//     Causal, segment, offset and ragged-edge masks are applied on the
//     accumulator fragment by absolute (row, col), and only on tiles that
//     straddle the diagonal or the edge, or whose keys' segment ids are
//     not all the warp's rows' (a warp vote); a tile wholly above a
//     warp's diagonal is skipped by that warp.
//   - The online softmax keeps m and l per row in the quad of 4 threads
//     that holds it (__shfl_xor_sync 1, 2); p is zeroed under the mask
//     after the exp, as flash_pallas.py:221 does. p times the dropout
//     factor is rounded to bf16 (:234-235) and repacked in registers into
//     the A fragments of O += P V, whose V fragments come by
//     ldmatrix.trans. l stays fp32, undropped and unrounded.
// The CUDA-core lane: fp32 at any d, bf16 at other d (multiples of 32 up
// to 256): one block per (16-query chunk, q head, batch row), the TPU
// kernel's sequential kv grid axis a loop inside the block carrying m, l
// and the accumulator in registers (4 rows per warp, d / 32 columns per
// lane), keys staged 32 at a time in fp32 shared memory, one key per lane
// for q k^T and one output column per lane for p v. With bf16 inputs p~
// is rounded to bf16 before p v (:235), as in the tensor-core lane.

#include "attention_common.cuh"
#include "mma_bf16.cuh"

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
      online_softmax_tile<kIsBf16<T>>(
          qs + r * ld, ks, vs, ld, d, live, m[i], l[i], acc[i],
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

// ---- the tensor-core lane (bf16, d = 64 or 128) ---------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps x 16 query rows
constexpr int kTcRows = 64;      // queries per block
constexpr int kTcKeys = 64;      // keys per streamed tile

template <int D>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return (size_t)(kTcRows + 4 * kTcKeys) * D * sizeof(bf16) +
         2 * kTcKeys * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, bf16* __restrict__ out,
                    float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                    float scale, int causal, int q_offset, int kv_offset,
                    Dropout drop) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kTcRows x D: q~
  bf16* ks = qs + kTcRows * D;                   // 2 stages x kTcKeys x D
  bf16* vs = ks + 2 * kTcKeys * D;               // 2 stages x kTcKeys x D
  int* kseg_s = reinterpret_cast<int*>(vs + 2 * kTcKeys * D);  // 2 x kTcKeys

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTcRows, ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const bf16* qb = q + ((size_t)ib * hq + ih) * sq * D;
  const bf16* kb = k + ((size_t)ib * hkv + ikv) * sk * D;
  const bf16* vb = v + ((size_t)ib * hkv + ikv) * sk * D;
  const bool has_seg = q_seg != nullptr;

  // diagonal skip: tiles past the block's last query position never load
  int k_end = sk;
  if (causal)
    k_end = min(sk, max(0, q0 + kTcRows - 1 + q_offset - kv_offset + 1));
  const int n_tiles = (k_end + kTcKeys - 1) / kTcKeys;

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
  if (n_tiles > 0) load_tile(0);

  // q~ = q * scale rounded to bf16, rows past sq zero
  for (int c = tid; c < kTcRows * CH; c += kTcThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < sq)
      x = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + col);
    bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
    *reinterpret_cast<uint4*>(qs + swz<D>(r, col)) = x;
  }
  const int qw = q0 + warp * 16;  // this warp's first query row
  const int rows[2] = {qw + gr, qw + gr + 8};
  int qseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (has_seg && rows[r] < sq) qseg[r] = q_seg[(size_t)ib * sq + rows[r]];
  __syncthreads();
  MmaBf16::A qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    qa[kk] = ldsm_a<D>(qs, warp * 16, kk * 16);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
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
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          MmaBf16::B b0, b1;
          ldsm_bt<D>(b0, b1, kt, n * 8, kk * 16);
          MmaBf16::mma(s[n], qa[kk], b0);
          MmaBf16::mma(s[n + 1], qa[kk], b1);
        }

      // masks, only where the tile is not wholly live for this warp
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
      uint32_t live = 0xffffffffu;  // bit 4n + i: fragment element (n, i)
      if (masked) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = n * 8 + 2 * t + (i & 1), kj = k0 + c;
            const int qi = rows[i >> 1];
            bool ok = kj < sk;
            if (causal) ok = ok && qi + q_offset >= kj + kv_offset;
            if (has_seg) ok = ok && kseg[c] == qseg[i >> 1];
            if (!ok) {
              s[n][i] = kNegInf;
              live &= ~(1u << (4 * n + i));
            }
          }
      }

      // online softmax: the row max over the quad that holds the row
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = __expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = __expf(s[n][i] - m[i >> 1]);
          if (!((live >> (4 * n + i)) & 1u)) p = 0.f;  // after the exp
          l[i >> 1] += p;
          if (drop.on)
            p *= drop.scale(salt, rows[i >> 1] + q_offset,
                            k0 + n * 8 + 2 * t + (i & 1) + kv_offset);
          s[n][i] = p;
        }

      // O += round_bf16(p~) V: keys kk*16..kk*16+15 are the k-step
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const MmaBf16::A a = acc_to_a(s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          MmaBf16::B b0, b1;
          ldsm_b<D>(b0, b1, vt, kk * 16, n * 8);
          MmaBf16::mma(o[n], a, b0);
          MmaBf16::mma(o[n + 1], a, b1);
        }
      }
    }
    __syncthreads();  // stage j & 1 consumed before tile j + 2 refills it
  }

  // finish as finish_row does: l summed over the quad, out = acc / l, a
  // row that saw no live key gives exact 0 and lse = -1e30
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    bf16* orow = out + ((size_t)ib * hq + ih) * sq * D + (size_t)rows[r] * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t == 0)
      lse[((size_t)ib * hq + ih) * sq + rows[r]] =
          l[r] == 0.f ? kNegInf : m[r] + logf(l[r]);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* q_seg,
              const void* kv_seg, void* out, void* lse, int b, int hq,
              int hkv, int sq, int sk, float scale, int causal, int q_offset,
              int kv_offset, Dropout drop, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kTcRows - 1) / kTcRows, hq, b);
  flash_fwd_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<bf16*>(out),
      static_cast<float*>(lse), hq, hkv, sq, sk, scale, causal, q_offset,
      kv_offset, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, sq, d), k/v (b, hkv, sk, d), contiguous, fp32 (bf16 == 0) or
// bf16 (bf16 == 1; 16-byte aligned at d = 64 and 128); q_seg (b, sq) /
// kv_seg (b, sk) int32, or both null;
// out (b, hq, sq, d) in q's dtype; lse (b, hq, sq) fp32; dropout when
// `drop_on`, with the address of the uint32 seed word in device memory,
// the uint32 threshold and 1 / (1 - rate).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hetu_flash_fwd(const void* q, const void* k, const void* v,
                              const void* q_seg, const void* kv_seg,
                              void* out, void* lse, int b, int hq, int hkv,
                              int sq, int sk, int d, float scale, int causal,
                              int q_offset, int kv_offset, int bf16,
                              int drop_on, const void* seed,
                              uint32_t threshold, float inv_keep,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_on, static_cast<const uint32_t*>(seed), threshold,
                     inv_keep};
  // the lane, from dtype and head_dim alone (ops/flash.py flash_lane)
  if (bf16 && d == 64)
    return launch_tc<64>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv, sq, sk,
                         scale, causal, q_offset, kv_offset, drop, s);
  if (bf16 && d == 128)
    return launch_tc<128>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv, sq,
                          sk, scale, causal, q_offset, kv_offset, drop, s);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv,
                                 sq, sk, d, scale, causal, q_offset,
                                 kv_offset, drop, s);
  return launch<float>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv, sq, sk,
                       d, scale, causal, q_offset, kv_offset, drop, s);
}
