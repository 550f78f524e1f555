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
// the fp32 cores alone need 0.77 ms. In fp32 the tensor cores run TF32 at
// 495 TFLOP/s, so 3xTF32's fp32-exact products reach at most ~165.
//
// Three lanes, picked from dtype and head_dim before the launch
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
// The fp32 tensor-core lane: fp32 at d = 64 and 128 (GPT-2's and
// GPT-MoE's fp32 packed prefill, the fp32 Llama engine, the fp32 training
// oracles). Products to about fp32's precision on the tensor cores by
// 3xTF32: each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: nearest, ties away from zero) and a b is taken as lo_a hi_b +
// hi_a lo_b + hi_a hi_b by mma.sync m16n8k8 tf32 (fp32 accumulators), the
// small terms first; the dropped lo_a lo_b and the residues are about
// 2^-22 of the product, where plain TF32 keeps 2^-11. At the serving shape
// latency, not bytes or flops, sets the time, so the grid spreads the
// little work there is (TfGrid below; port_probe.py flash-variants times
// the alternatives): a block holds kWarpsQ x kWarpsK warps, warp (wq, wk)
// owns query rows 16 wq .. 16 wq + 15 of the block and keys wk KW ..
// (wk + 1) KW - 1 of every kKeys-key tile (KW = kKeys / kWarpsK), and the
// key slices' (m, l, O) meet once in shared memory after the last tile.
// Built: at d = 64 1 x 4 warps on 64-key tiles (the fastest grid at GPT-2's
// pack), at d = 128 2 x 2 on 32-key tiles (the fastest at the Llama pack).
//   - K, V and the key segment ids stream through a 2-stage cp.async ring
//     of 16-byte chunks; fp32 rows are padded to d + 4 floats, so the
//     scalar 32-bit loads of the B fragments (K's: row g, column t; V's:
//     row 2t, column g) and of q's A fragments hit 32 distinct banks.
//   - q~ = q * scale is split once into hi and lo in shared memory; at
//     d = 64 a warp then holds its A fragments in registers (64 a thread),
//     at d = 128 it reads them from shared memory each tile (128 registers
//     of q beside 64 of O would leave too few).
//   - P stays in registers: the S accumulator holds keys 2t and 2t + 1 of
//     each 8-key slice, the tf32 A fragment wants k-indices t and t + 4,
//     so the B fragment of P V reads V's rows in the accumulator's key
//     order (k-index t is key 2t, t + 4 is key 2t + 1): a sum over keys
//     does not care about their order.
//   - Masks, the online softmax (expf, within the quad) and dropout as in
//     the bf16 tensor-core lane; p is split after the dropout factor, l
//     stays undropped.
// The CUDA-core lane: fp32 and bf16 at other d (multiples of 32 up to
// 256): one block per (16-query chunk, q head, batch row), the TPU
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

// ---- the fp32 tensor-core lane (fp32, d = 64 or 128): 3xTF32 -------------

// x as a tf32 operand: cvt.rna rounds to the nearest tf32 (10 mantissa
// bits), ties away from zero; the low 13 bits come back zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + a residue of about 2^-22 |x|: lo is x - hi (exact in
// fp32) rounded to tf32 in turn
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Fragments of one m16n8k8 tf32 product c (16 x 8) += A (16 x 8) B (8 x
// 8), lane (g, t) = (lane / 4, lane % 4): A's (row, k) (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B's (k, n) (t, g), (t + 4, g); c's (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). Each holds its hi and lo.
struct Tf32A {
  uint32_t hi[4], lo[4];
};
struct Tf32B {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b to about fp32's precision: the two cross terms, then hi hi
// (P V; S takes the same terms into kTfSChains chains)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32A& a,
                                           const Tf32B& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// The lane's grid, per head_dim: kWarpsQ x kWarpsK warps a block, the
// block's 16 kWarpsQ query rows against kKeys-key tiles, each tile's keys
// split kWarpsK ways. port_probe.py flash-variants rewrites these lines.
template <int D>
struct TfGrid;
template <> struct TfGrid<64> { static constexpr int kWarpsQ = 1, kWarpsK = 4, kKeys = 64; };
template <> struct TfGrid<128> { static constexpr int kWarpsQ = 2, kWarpsK = 2, kKeys = 32; };
// S's independent accumulator chains per 8-key slice: 1 (every term of
// every k-step into one), 2 (the small terms into one, hi hi into the
// other) or 4 (each of those by k-step parity), summed as (small) + (big)
// after the last k-step. A chain of d / 8 k-steps of dependent mma.sync
// leaves the tensor pipe idle; port_probe.py flash-variants rewrites this.
constexpr int kTfSChains = 4;
static_assert(kTfSChains == 1 || kTfSChains == 2 || kTfSChains == 4,
              "one, two or four chains");

// Dynamic shared memory: q~'s hi and lo (16 kWarpsQ rows each), two
// stages of K and V (kKeys rows each), rows padded to D + 4 floats, then
// two stages of key segment ids. After the last tile the K / V stages hold
// the key slices' (O, m, l) for the merge.
template <int D>
__host__ __device__ constexpr size_t tf_smem_bytes() {
  using G = TfGrid<D>;
  return (size_t)(2 * 16 * G::kWarpsQ + 4 * G::kKeys) * (D + 4) *
             sizeof(float) +
         2 * G::kKeys * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(TfGrid<D>::kWarpsQ* TfGrid<D>::kWarpsK * 32)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ kv_seg,
                        float* __restrict__ out, float* __restrict__ lse,
                        int hq, int hkv, int sq, int sk, float scale,
                        int causal, int q_offset, int kv_offset,
                        Dropout drop) {
  using G = TfGrid<D>;
  constexpr int WQ = G::kWarpsQ, WK = G::kWarpsK, BK = G::kKeys;
  constexpr int RQ = 16 * WQ;        // query rows a block
  constexpr int KW = BK / WK;        // keys a warp takes of each tile
  constexpr int NT = WQ * WK * 32;   // threads
  constexpr int LD = D + 4;          // padded row, floats
  constexpr int CH = D / 4;          // 16-byte chunks a row
  constexpr int LO = D + 8;          // a merged O row, floats
  constexpr bool kQRegs = D <= 64;   // q~'s fragments held in registers
  static_assert(KW % 8 == 0 && KW <= 64, "a warp takes 8-key slices");
  static_assert((WK - 1) * RQ * (LO + 2) <= 4 * BK * LD,
                "the merge fits in the K / V stages");
  extern __shared__ __align__(16) float smem_f[];
  float* qh = smem_f;              // RQ x LD: tf32 hi of q~
  float* ql = qh + RQ * LD;        // RQ x LD: tf32 lo of q~
  float* ks = ql + RQ * LD;        // 2 stages x BK x LD
  float* vs = ks + 2 * BK * LD;    // 2 stages x BK x LD
  int* kseg_s = reinterpret_cast<int*>(vs + 2 * BK * LD);  // 2 x BK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wq = warp / WK, wk = warp % WK;
  const int gr = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * RQ, ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = ih / (hq / hkv);
  const float* qb = q + ((size_t)ib * hq + ih) * sq * D;
  const float* kb = k + ((size_t)ib * hkv + ikv) * sk * D;
  const float* vb = v + ((size_t)ib * hkv + ikv) * sk * D;
  const bool has_seg = q_seg != nullptr;

  // diagonal skip: tiles past the block's last query position never load
  int k_end = sk;
  if (causal) k_end = min(sk, max(0, q0 + RQ - 1 + q_offset - kv_offset + 1));
  const int n_tiles = (k_end + BK - 1) / BK;

  // q's rows (past sq: zeros), a cp.async group of their own
  for (int c = tid; c < RQ * CH; c += NT) {
    const int r = c / CH, col = (c % CH) * 4;
    const bool in = q0 + r < sq;
    cp_async16(qh + r * LD + col, qb + (size_t)(in ? q0 + r : 0) * D + col,
               in);
  }
  cp_async_commit();
  auto load_tile = [&](int j) {
    const int k0 = j * BK, st = j & 1;
    float* kd = ks + st * BK * LD;
    float* vd = vs + st * BK * LD;
    for (int c = tid; c < BK * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * 4;
      const bool in = k0 + r < sk;
      const size_t src = (size_t)(in ? k0 + r : 0) * D + col;
      cp_async16(kd + r * LD + col, kb + src, in);
      cp_async16(vd + r * LD + col, vb + src, in);
    }
    if (has_seg)
      for (int i = tid; i < BK; i += NT) {
        const bool in = k0 + i < sk;
        cp_async4(kseg_s + st * BK + i,
                  kv_seg + (size_t)ib * sk + (in ? k0 + i : 0), in);
      }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);

  // q~ = q * scale, split once into hi and lo (tile 0 may be in flight)
  if (n_tiles > 0)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < RQ * D; e += NT) {
    const int i = (e / D) * LD + e % D;
    uint32_t hi, lo;
    split_tf32(qh[i] * scale, hi, lo);
    qh[i] = __uint_as_float(hi);
    ql[i] = __uint_as_float(lo);
  }
  __syncthreads();
  // the A fragment of q~'s k-step kk (dimensions 8 kk .. 8 kk + 7)
  auto q_frag = [&](int kk, Tf32A& a) {
    const int i = (wq * 16 + gr) * LD + kk * 8 + t;
    const int at[4] = {i, i + 8 * LD, i + 4, i + 8 * LD + 4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a.hi[e] = __float_as_uint(qh[at[e]]);
      a.lo[e] = __float_as_uint(ql[at[e]]);
    }
  };
  Tf32A qa[kQRegs ? D / 8 : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) q_frag(kk, qa[kk]);
  }

  const int qw = q0 + wq * 16;  // this warp's first query row
  const int rows[2] = {qw + gr, qw + gr + 8};
  int qseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (has_seg && rows[r] < sq) qseg[r] = q_seg[(size_t)ib * sq + rows[r]];
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
    const int st = j & 1;
    const int kw0 = j * BK + wk * KW;  // this warp's first key
    const float* kt = ks + (st * BK + wk * KW) * LD;
    const float* vt = vs + (st * BK + wk * KW) * LD;
    const int* kseg = kseg_s + st * BK + wk * KW;
    // warp-uniform: no key of this warp's slice is visible to its rows
    const bool dead =
        kw0 >= sk || (causal && kw0 + kv_offset > qw + 15 + q_offset);
    if (!dead) {
      // S = q~ K^T: B fragment (k, n) = K[key 8n + g][dim 8kk + t], in
      // kTfSChains accumulator chains (small terms in the even ones)
      float acc[kTfSChains][KW / 8][4];
#pragma unroll
      for (int c = 0; c < kTfSChains; ++c)
#pragma unroll
        for (int n = 0; n < KW / 8; ++n)
          acc[c][n][0] = acc[c][n][1] = acc[c][n][2] = acc[c][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Tf32A a;
        if constexpr (kQRegs)
          a = qa[kk];
        else
          q_frag(kk, a);
        constexpr int kBig = kTfSChains == 1 ? 0 : 1;
        const int c0 = kTfSChains == 4 ? 2 * (kk & 1) : 0;
#pragma unroll
        for (int n = 0; n < KW / 8; ++n) {
          const float* kr = kt + (n * 8 + gr) * LD + kk * 8 + t;
          Tf32B b;
          split_tf32(kr[0], b.hi[0], b.lo[0]);
          split_tf32(kr[4], b.hi[1], b.lo[1]);
          mma_tf32(acc[c0][n], a.lo, b.hi);
          mma_tf32(acc[c0][n], a.hi, b.lo);
          mma_tf32(acc[c0 + kBig][n], a.hi, b.hi);
        }
      }
      float s[KW / 8][4];
#pragma unroll
      for (int n = 0; n < KW / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kTfSChains == 1)
            s[n][i] = acc[0][n][i];
          else if constexpr (kTfSChains == 2)
            s[n][i] = acc[0][n][i] + acc[1][n][i];
          else
            s[n][i] = (acc[0][n][i] + acc[2][n][i]) +
                      (acc[1][n][i] + acc[3][n][i]);
        }

      // masks, only where the slice is not wholly live for this warp
      bool masked = kw0 + KW > sk ||
                    (causal && kw0 + KW - 1 + kv_offset > qw + q_offset);
      if (has_seg && !masked) {
        bool same = true;
#pragma unroll
        for (int n = 0; n < KW / 8; ++n)
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
        for (int n = 0; n < KW / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = n * 8 + 2 * t + (i & 1), kj = kw0 + c;
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
      for (int n = 0; n < KW / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
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
      for (int n = 0; n < KW / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = expf(s[n][i] - m[i >> 1]);
          if (!((live >> (4 * n + i)) & 1u)) p = 0.f;  // after the exp
          l[i >> 1] += p;
          if (drop.on)
            p *= drop.scale(salt, rows[i >> 1] + q_offset,
                            kw0 + n * 8 + 2 * t + (i & 1) + kv_offset);
          s[n][i] = p;
        }

      // O += p~ V, k-step n = the 8-key slice n in the accumulator's key
      // order: k-index t is key 2t, t + 4 key 2t + 1; B fragment (k, n)
      // = V[that key][column 8c + g]
#pragma unroll
      for (int n = 0; n < KW / 8; ++n) {
        Tf32A a;
        split_tf32(s[n][0], a.hi[0], a.lo[0]);  // row g, key 2t
        split_tf32(s[n][2], a.hi[1], a.lo[1]);  // row g + 8, key 2t
        split_tf32(s[n][1], a.hi[2], a.lo[2]);  // row g, key 2t + 1
        split_tf32(s[n][3], a.hi[3], a.lo[3]);  // row g + 8, key 2t + 1
        const float* vr = vt + (n * 8 + 2 * t) * LD + gr;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          Tf32B b;
          split_tf32(vr[c * 8], b.hi[0], b.lo[0]);
          split_tf32(vr[LD + c * 8], b.hi[1], b.lo[1]);
          mma_3xtf32(o[c], a, b);
        }
      }
    }
    __syncthreads();  // stage j & 1 consumed before tile j + 2 refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (WK > 1) {
    // the key slices meet: warps wk > 0 leave (O, m, l) in the free K / V
    // stages, warp wk = 0 of each row group rescales to the common max
    // and sums them (a slice that saw no live key has m = -inf, l = 0)
    float* so = ks;                       // (WK - 1) x RQ x LO
    float* sm = so + (WK - 1) * RQ * LO;  // (WK - 1) x RQ
    float* sl = sm + (WK - 1) * RQ;       // (WK - 1) x RQ
    if (wk > 0) {
      const int row = (wk - 1) * RQ + wq * 16 + gr;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(so + row * LO + n * 8 + 2 * t) =
            make_float2(o[n][0], o[n][1]);
        *reinterpret_cast<float2*>(so + (row + 8) * LO + n * 8 + 2 * t) =
            make_float2(o[n][2], o[n][3]);
      }
      if (t == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sm[row + 8 * r] = m[r];
          sl[row + 8 * r] = l[r];
        }
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int w = 1; w < WK; ++w)
        mx = fmaxf(mx, sm[(w - 1) * RQ + wq * 16 + gr + 8 * r]);
      const float f0 = m[r] == -CUDART_INF_F ? 0.f : expf(m[r] - mx);
      l[r] *= f0;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * r] *= f0;
        o[n][2 * r + 1] *= f0;
      }
#pragma unroll
      for (int w = 1; w < WK; ++w) {
        const int row = (w - 1) * RQ + wq * 16 + gr + 8 * r;
        const float mw = sm[row];
        const float f = mw == -CUDART_INF_F ? 0.f : expf(mw - mx);
        l[r] += f * sl[row];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 x =
              *reinterpret_cast<const float2*>(so + row * LO + n * 8 + 2 * t);
          o[n][2 * r] += f * x.x;
          o[n][2 * r + 1] += f * x.y;
        }
      }
      m[r] = mx;
    }
  }

  // out = O / l, lse = m + log l; a row that saw no live key gives exact 0
  // and lse = -1e30
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    float* orow = out + ((size_t)ib * hq + ih) * sq * D + (size_t)rows[r] * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t == 0)
      lse[((size_t)ib * hq + ih) * sq + rows[r]] =
          l[r] == 0.f ? kNegInf : m[r] + logf(l[r]);
  }
}

template <int D>
int launch_tf32x3(const void* q, const void* k, const void* v,
                  const void* q_seg, const void* kv_seg, void* out, void* lse,
                  int b, int hq, int hkv, int sq, int sk, float scale,
                  int causal, int q_offset, int kv_offset, Dropout drop,
                  cudaStream_t stream) {
  using G = TfGrid<D>;
  constexpr int rows = 16 * G::kWarpsQ;
  const size_t smem = tf_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_tf32x3_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + rows - 1) / rows, hq, b);
  flash_fwd_tf32x3_kernel<D>
      <<<grid, G::kWarpsQ * G::kWarpsK * 32, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const int*>(q_seg),
          static_cast<const int*>(kv_seg), static_cast<float*>(out),
          static_cast<float*>(lse), hq, hkv, sq, sk, scale, causal, q_offset,
          kv_offset, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, sq, d), k/v (b, hkv, sk, d), contiguous, fp32 (bf16 == 0) or
// bf16 (bf16 == 1), 16-byte aligned at d = 64 and 128; q_seg (b, sq) /
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
  if (!bf16 && d == 64)
    return launch_tf32x3<64>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv, sq,
                             sk, scale, causal, q_offset, kv_offset, drop, s);
  if (!bf16 && d == 128)
    return launch_tf32x3<128>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv,
                              sq, sk, scale, causal, q_offset, kv_offset,
                              drop, s);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv,
                                 sq, sk, d, scale, causal, q_offset,
                                 kv_offset, drop, s);
  return launch<float>(q, k, v, q_seg, kv_seg, out, lse, b, hq, hkv, sq, sk,
                       d, scale, causal, q_offset, kv_offset, drop, s);
}
