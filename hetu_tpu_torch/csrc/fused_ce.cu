// Fused LM-head cross-entropy, for sm_90a (H100): three kernels, two
// lanes each.
//
// Replaces hetu_tpu/ops/fused_ce_pallas.py:53 _fwd_kernel, :112
// _dh_kernel and :134 _dw_kernel (host wrappers _fused_fwd_impl :170 and
// _fused_core_bwd :222). h (n, E) holds the tokens' hidden states, w (V, E)
// the vocab-major head weight; s = h w^T is never written to device memory.
//   fwd: per token, lse = logsumexp_v s[v] (online over vocab tiles) and
//        tgt = s[label] (0 for label -1, a token outside this weight);
//   dh:  dh = P w,   dw: dw = P^T h,   with the dlogits tile
//        P = glse * exp(s - lse) + gtgt * onehot(label)
//        (_p_tile :96) rounded to h's dtype before the product, as the TPU
//        kernels round it (:126, :150): this p is absolute, not
//        tile-relative, so the rounding is JAX's exactly.
// Each w tile is cast to h's dtype as it is staged (:64, :121, :144); s,
// the softmax and P are fp32; dh comes out in h's dtype and dw in w's,
// both summed in fp32. Columns at or past V are -1e30 in the max and 0 in
// P; token rows at or past n are zero-filled on load and never stored, so
// nothing is padded in device memory.
//
// What bounds them on an H100: operations. At the training shape (n = b *
// 1024 tokens, V = 50257, E = 768, bf16) fwd does 2nVE flops and dh/dw 4nVE
// each (the logits tile is recomputed), against about (n + V) E * 2 bytes:
// hundreds of flops per byte, far above the card's 295. At n = 49152 the
// bounds are 3.836 ms (fwd) and 7.673 ms (dh, dw) on 989 TFLOP/s.
//
// Lanes, picked from h's dtype before the launch (ops/fused_ce.py
// fused_ce_lane; the entry points below branch on the same rule): bf16 h
// runs all three on the tensor-core lane (fused_ce_fwd_tc_kernel,
// fused_ce_dh_tc_kernel, fused_ce_dw_tc_kernel, below). fwd and dh read
// bf16 w only (the wrapper casts an fp32 w once: the values of the
// per-tile astype); dw, whose resident operand is w, reads w in its own
// dtype and rounds an fp32 w to bf16 as it stages it. fp32 h runs the
// CUDA-core lane.
//
// The CUDA-core lane (fused_ce_fwd_kernel, fused_ce_bwd_body: fp32 h,
// fp32 or bf16 w), simple and right first:
//   - fp32 operands (w cast to fp32 as it is staged) take mma.sync's
//     m16n8k16 fragment layout on the CUDA cores (Mma<float>, no TF32),
//     in k order.
//   - No state crosses a grid axis and nothing is atomic, so every sum is
//     deterministic. fwd and dh: one block per token tile, looping over
//     every vocab tile. dw: one block per vocab tile, looping over every
//     token tile. The block keeps its own (rows x E) operand resident in
//     shared memory and stages the streamed (kT x E) tile whole, one load
//     per tile, so the copy is latency-bound once per tile rather than
//     once per k step.
//   - The (32 x E) fp32 dh/dw accumulator lives in registers: 8 warps,
//     each owning every 8th group of 8 columns (E / 64 groups, 96 floats a
//     thread at E = 768). E is therefore a multiple of 64 and at most
//     kMaxE = 768, which also keeps both operand tiles inside the 227 KB
//     of shared memory; wider E takes the wide lane (below).
// No copy pipeline: every streamed tile is staged through registers
// between two barriers, and fwd keeps fp32 logits in shared memory.
//
// The tensor-core lane answers five costs of this design at bf16's rate:
//   1. unpipelined staging: all three kernels stream through cp.async
//      rings (mma_bf16.cuh cp_async16) into XOR-swizzled rows (swz), so a
//      copy in flight overlaps the products before it;
//   2. one block per SM with nothing hiding the copies: fwd's ring is 4
//      k-chunks deep and its copies are spread over the products; dh's
//      and dw's next tile is copied in the shadow of their cluster
//      barrier;
//   3. fp32 logits through shared memory: fwd keeps s in the mma.sync
//      accumulators and takes the row max, the rescaled sum and the
//      target logit from registers with quad shuffles; dh and dw form P
//      in registers;
//   4. hand-indexed fragment loads: every fragment comes by ldmatrix
//      (ldsm_a, ldsm_bt, ldsm_b) into warp tiles of 32 rows, 160-256
//      bytes of ldmatrix a product;
//   5. a 32-row tile re-streamed all of the other operand for every 32
//      rows: a two-CTA cluster now owns 64 (dh: tokens, dw: vocab rows),
//      each CTA half of E (below).
// The details and the L2 reckoning are at each kernel.
//
// The wide lanes (E past kMaxE, any multiple of 64, on both lanes): the
// CUDA-core forward and backward kernels stream E in 64-column k-chunks,
// their dh / dw splitting E across a grid axis, each block recomputing
// the logits over the whole of E for its 512 output columns
// (fused_ce_fwd_wide_kernel, fused_ce_bwd_wide_body). The tensor-core dh
// and dw (fused_ce_bwd_wide_tc_body) split E across the CTAs of a cluster
// of up to 8 instead, which sum the logits once and share them through
// distributed shared memory, on wgmma. The tensor-core forward
// (fused_ce_fwd_wide_tc_kernel) splits the vocab across the CTAs of a
// cluster that share one token tile, on wgmma fed by TMA, and combines
// their online-softmax states through distributed shared memory.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the driver is reached by entry point)

#include <type_traits>

#include "attention_common.cuh"
#include "mma_bf16.cuh"

// Mma<bf16> (the tensor-core product and its fragments) is in mma_bf16.cuh
namespace hetu {

// fp32: the same fragment product on the CUDA cores, k in order (no
// TF32); a "fragment" is where its operand lies in shared memory
template <> struct Mma<float> {
  struct A { const float* p; int ld; };
  struct B { const float* p; int sk, sj; };  // B[k][j] = p[k * sk + j * sj]
  __device__ __forceinline__ static A load_a(const float* a, int lda) {
    return {a, lda};
  }
  template <bool kBT>
  __device__ __forceinline__ static B load_b(const float* b, int ldb) {
    return kBT ? B{b, 1, ldb} : B{b, ldb, 1};
  }
  __device__ __forceinline__ static void mma(float (&c)[4], const A& a,
                                             const B& b) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float x0 = a.p[g * a.ld + k], x1 = a.p[(g + 8) * a.ld + k];
      const float y0 = b.p[k * b.sk + 2 * t * b.sj];
      const float y1 = b.p[k * b.sk + (2 * t + 1) * b.sj];
      c[0] = fmaf(x0, y0, c[0]);
      c[1] = fmaf(x0, y1, c[1]);
      c[2] = fmaf(x1, y0, c[2]);
      c[3] = fmaf(x1, y1, c[3]);
    }
  }
};

}  // namespace hetu

namespace {

using namespace hetu;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBwdRows = 32;   // dh: tokens, dw: vocab rows per block
constexpr int kMaxE = 768;

// per element type (fp32 h only: bf16 h takes the tensor-core lane):
// streamed rows per tile, fwd tokens per block, and a row pad of 16
// bytes, which puts consecutive rows 4 banks apart (the fragment loads
// below are then free of bank conflicts)
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int kT = 32, kFwdRows = 32, kPad = 4;
};

__device__ __forceinline__ float cvt(float x, const float*) { return x; }

// Copy columns [c0, c0 + K) of rows [r0, r0 + rows) of a (n, E) matrix into
// shared memory (row stride ld), cast to T; rows at or past n are
// zero-filled. The wide lanes stage one k-chunk at a time, stage() whole
// rows.
template <typename T, typename S>
__device__ __forceinline__ void stage_chunk(T* dst, int ld, const S* src,
                                            int n, int E, int r0, int rows,
                                            int c0, int K) {
  if constexpr (std::is_same<T, S>::value) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = K / V;
    for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
      const int r = i / vpr, c = (i - r * vpr) * V;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n)
        x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * E + c0 +
                                            c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
      const int r = i / K, c = i - r * K;
      const float x =
          r0 + r < n ? to_float(src[(size_t)(r0 + r) * E + c0 + c]) : 0.f;
      dst[r * ld + c] = cvt(x, dst);
    }
  }
}

// Copy rows [r0, r0 + rows) of a (n, E) matrix into shared memory (row
// stride ld), cast to T; rows at or past n are zero-filled.
template <typename T, typename S>
__device__ __forceinline__ void stage(T* dst, int ld, const S* src, int n,
                                      int E, int r0, int rows) {
  stage_chunk(dst, ld, src, n, E, r0, rows, 0, E);
}

// s = X Y^T for X (R x E) and Y (kT x E) in shared memory. The block's
// (R/16) x (kT/8) fragments are dealt to the 8 warps: warp w owns column
// tile ni = w % (kT/8) and row tiles mi(q) = w / (kT/8) + q * (8 / (kT/8)),
// kPairs of them, so one B fragment serves all of a warp's products.
template <typename T, int R, int kT>
struct Logits {
  static constexpr int kN = kT / 8, kPairs = R * kN / 128;
  static_assert(kPairs >= 1 && 8 % kN == 0 && (R / 16) % (8 / kN) == 0,
                "tile shape");
  float s[kPairs][4];

  __device__ __forceinline__ static int ni() { return (threadIdx.x >> 5) % kN; }
  __device__ __forceinline__ static int mi(int q) {
    return (threadIdx.x >> 5) / kN + q * (8 / kN);
  }
  __device__ __forceinline__ void compute(const T* xs, int ldx, const T* ys,
                                          int ldy, int E) {
    zero();
    add(xs, ldx, ys, ldy, E);
  }
  // the wide lane calls these apart: s = 0, then s += X[:, chunk] Y[:,
  // chunk]^T for each k-chunk of K columns in turn (k in order, as compute)
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) s[q][0] = s[q][1] = s[q][2] = s[q][3] = 0.f;
  }
  __device__ __forceinline__ void add(const T* xs, int ldx, const T* ys,
                                      int ldy, int K) {
#pragma unroll 4
    for (int k = 0; k < K; k += 16) {
      const auto b = Mma<T>::template load_b<true>(ys + ni() * 8 * ldy + k, ldy);
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
        Mma<T>::mma(s[q], Mma<T>::load_a(xs + mi(q) * 16 * ldx + k, ldx), b);
    }
  }
  // (row, column) in the tile of fragment element i (0..3) of pair q
  __device__ __forceinline__ static int row(int q, int i) {
    return mi(q) * 16 + ((threadIdx.x & 31) >> 2) + (i >> 1) * 8;
  }
  __device__ __forceinline__ static int col(int q, int i) {
    return ni() * 8 + 2 * (threadIdx.x & 3) + (i & 1);
  }
};

// ---- fwd (#5): one block per kFwdRows tokens --------------------------------

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const T* __restrict__ h, const TW* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ tgt, int n, int vocab, int E) {
  constexpr int R = Cfg<T>::kFwdRows, kT = Cfg<T>::kT;
  constexpr int kRowsPerWarp = R / 8, kColsPerLane = kT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = E + Cfg<T>::kPad, lds = kT + 4;
  T* xs = reinterpret_cast<T*>(smem);      // R x ldx: this block's tokens
  T* ys = xs + R * ldx;                    // kT x ldx: one vocab tile
  float* ss = reinterpret_cast<float*>(ys + kT * ldx);  // R x lds: s

  const int r0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage(xs, ldx, h, n, E, r0, R);

  // warp `warp` keeps the online state of rows warp * kRowsPerWarp + j;
  // every lane holds the row's m and l, and its own part of tgt
  float m[kRowsPerWarp], l[kRowsPerWarp], tp[kRowsPerWarp];
  int lab[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int i = r0 + warp * kRowsPerWarp + j;
    m[j] = -CUDART_INF_F;
    l[j] = tp[j] = 0.f;
    lab[j] = i < n ? labels[i] : -1;
  }

  Logits<T, R, kT> lg;
  for (int v0 = 0; v0 < vocab; v0 += kT) {
    __syncthreads();  // xs staged / previous tile's ys and ss consumed
    stage(ys, ldx, w, vocab, E, v0, kT);
    __syncthreads();
    lg.compute(xs, ldx, ys, ldx, E);
#pragma unroll
    for (int q = 0; q < lg.kPairs; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) ss[lg.row(q, i) * lds + lg.col(q, i)] = lg.s[q][i];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const float* srow = ss + (warp * kRowsPerWarp + j) * lds;
      float s[kColsPerLane], mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int v = v0 + lane + 32 * c;
        s[c] = v < vocab ? srow[lane + 32 * c] : kNegInf;
        if (v == lab[j]) tp[j] += s[c];
        mx = fmaxf(mx, s[c]);
      }
      const float m_next = fmaxf(m[j], warp_max(mx));
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) e += expf(s[c] - m_next);
      l[j] = expf(m[j] - m_next) * l[j] + warp_sum(e);
      m[j] = m_next;
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int i = r0 + warp * kRowsPerWarp + j;
    const float t = warp_sum(tp[j]);
    if (lane == 0 && i < n) {
      lse[i] = m[j] + logf(l[j]);
      tgt[i] = t;
    }
  }
}

// ---- dh (#6) and dw (#7): one shared body ------------------------------------
//
// fp32 h only (bf16 h takes the tensor-core lane below). X (kBwdRows x
// E) is the block's resident operand, Y (kT x E) the streamed one; per Y
// tile: s = X Y^T, P into shared memory, then acc (kBwdRows x E) += P Y.
// dh: X = h (tokens), Y = w (vocab), the token statistics are per row of
// P. dw: X = w, Y = h, P is the dlogits tile transposed and the
// statistics are per column.

template <typename T, typename TW, bool kDW>
__device__ __forceinline__ void fused_ce_bwd_body(
    const T* __restrict__ h, const TW* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ glse, const float* __restrict__ gtgt,
    void* __restrict__ out, int n, int vocab, int E) {
  constexpr int R = kBwdRows, kT = Cfg<T>::kT, kGroups = kMaxE / 64;
  constexpr int kStat = R > kT ? R : kT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = E + Cfg<T>::kPad, ldp = kT + Cfg<T>::kPad;
  T* xs = reinterpret_cast<T*>(smem);   // R x ldx
  T* ys = xs + R * ldx;                 // kT x ldx
  T* ps = ys + kT * ldx;                // R x ldp: P
  float* st_lse = reinterpret_cast<float*>(ps + R * ldp);
  float* st_glse = st_lse + kStat;
  float* st_gtgt = st_glse + kStat;
  int* st_lab = reinterpret_cast<int*>(st_gtgt + kStat);

  const int r0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_x = kDW ? vocab : n, n_y = kDW ? n : vocab;
  const int groups = E / 64;

  // statistics of the tokens: this block's rows (dh), or each Y tile's (dw)
  auto stage_stats = [&](int i0, int count) {
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const bool in = i0 + i < n;
      st_lse[i] = in ? lse[i0 + i] : 0.f;
      st_glse[i] = in ? glse[i0 + i] : 0.f;
      st_gtgt[i] = in ? gtgt[i0 + i] : 0.f;
      st_lab[i] = in ? labels[i0 + i] : -1;
    }
  };
  if (kDW)
    stage(xs, ldx, w, n_x, E, r0, R);
  else {
    stage(xs, ldx, h, n_x, E, r0, R);
    stage_stats(r0, R);
  }

  float acc[kGroups][R / 16][4];
#pragma unroll
  for (int c = 0; c < kGroups; ++c)
#pragma unroll
    for (int mi = 0; mi < R / 16; ++mi)
      acc[c][mi][0] = acc[c][mi][1] = acc[c][mi][2] = acc[c][mi][3] = 0.f;

  Logits<T, R, kT> lg;
  for (int y0 = 0; y0 < n_y; y0 += kT) {
    __syncthreads();  // xs staged / previous tile's ys, ps, stats consumed
    if (kDW) {
      stage(ys, ldx, h, n_y, E, y0, kT);
      stage_stats(y0, kT);
    } else {
      stage(ys, ldx, w, n_y, E, y0, kT);
    }
    __syncthreads();
    lg.compute(xs, ldx, ys, ldx, E);
#pragma unroll
    for (int q = 0; q < lg.kPairs; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lg.row(q, i), c = lg.col(q, i);
        const int tok = kDW ? c : r;               // index into the stats
        const int v = kDW ? r0 + r : y0 + c;       // vocab column
        float p = v < vocab ? st_glse[tok] * expf(lg.s[q][i] - st_lse[tok])
                            : 0.f;
        if (v == st_lab[tok]) p += st_gtgt[tok];
        ps[r * ldp + c] = cvt(p, ps);
      }
    __syncthreads();
    // acc += P (R x kT) Y (kT x E); warp owns column group c * 64 + warp * 8
#pragma unroll
    for (int k = 0; k < kT; k += 16) {
      typename Mma<T>::A a[R / 16];
#pragma unroll
      for (int mi = 0; mi < R / 16; ++mi)
        a[mi] = Mma<T>::load_a(ps + mi * 16 * ldp + k, ldp);
#pragma unroll
      for (int c = 0; c < kGroups; ++c)
        if (c < groups) {
          const auto b = Mma<T>::template load_b<false>(
              ys + k * ldx + c * 64 + warp * 8, ldx);
#pragma unroll
          for (int mi = 0; mi < R / 16; ++mi) Mma<T>::mma(acc[c][mi], a[mi], b);
        }
    }
  }

#pragma unroll
  for (int c = 0; c < kGroups; ++c)
    if (c < groups)
#pragma unroll
      for (int mi = 0; mi < R / 16; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + mi * 16 + g + (i >> 1) * 8;
          const int col = c * 64 + warp * 8 + 2 * t + (i & 1);
          if (r >= n_x) continue;
          if (kDW)
            store(static_cast<TW*>(out) + (size_t)r * E + col, acc[c][mi][i]);
          else
            store(static_cast<T*>(out) + (size_t)r * E + col, acc[c][mi][i]);
        }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
fused_ce_dh_kernel(const T* __restrict__ h, const TW* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ glse,
                   const float* __restrict__ gtgt, T* __restrict__ dh, int n,
                   int vocab, int E) {
  fused_ce_bwd_body<T, TW, false>(h, w, labels, lse, glse, gtgt, dh, n, vocab,
                                  E);
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
fused_ce_dw_kernel(const T* __restrict__ h, const TW* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ glse,
                   const float* __restrict__ gtgt, TW* __restrict__ dw, int n,
                   int vocab, int E) {
  fused_ce_bwd_body<T, TW, true>(h, w, labels, lse, glse, gtgt, dw, n, vocab,
                                 E);
}

template <typename T>
size_t fwd_smem(int E) {
  constexpr int R = Cfg<T>::kFwdRows, kT = Cfg<T>::kT;
  return (size_t)(R + kT) * (E + Cfg<T>::kPad) * sizeof(T) +
         (size_t)R * (kT + 4) * sizeof(float);
}

template <typename T>
size_t bwd_smem(int E) {
  constexpr int R = kBwdRows, kT = Cfg<T>::kT;
  constexpr int kStat = R > kT ? R : kT;
  return (size_t)(R + kT) * (E + Cfg<T>::kPad) * sizeof(T) +
         (size_t)R * (kT + Cfg<T>::kPad) * sizeof(T) + 4 * kStat * 4;
}

template <typename T, typename TW>
int launch_fwd(const void* h, const void* w, const void* labels, void* lse,
               void* tgt, int n, int vocab, int E, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value,
                "bf16 h takes the tensor-core lane");
  const size_t smem = fwd_smem<T>(E);
  cudaError_t err = allow_smem(fused_ce_fwd_kernel<T, TW>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + Cfg<T>::kFwdRows - 1) / Cfg<T>::kFwdRows;
  fused_ce_fwd_kernel<T, TW><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const TW*>(w),
      static_cast<const int*>(labels), static_cast<float*>(lse),
      static_cast<float*>(tgt), n, vocab, E);
  return (int)cudaGetLastError();
}

template <typename T, typename TW, bool kDW>
int launch_bwd(const void* h, const void* w, const void* labels,
               const void* lse, const void* glse, const void* gtgt, void* out,
               int n, int vocab, int E, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value,
                "bf16 h takes the tensor-core lane");
  const size_t smem = bwd_smem<T>(E);
  const int blocks = ((kDW ? vocab : n) + kBwdRows - 1) / kBwdRows;
  const T* hp = static_cast<const T*>(h);
  const TW* wp = static_cast<const TW*>(w);
  const int* lp = static_cast<const int*>(labels);
  const float *a = static_cast<const float*>(lse),
              *b = static_cast<const float*>(glse),
              *c = static_cast<const float*>(gtgt);
  cudaError_t err;
  if constexpr (kDW) {
    err = allow_smem(fused_ce_dw_kernel<T, TW>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_ce_dw_kernel<T, TW><<<blocks, kThreads, smem, stream>>>(
        hp, wp, lp, a, b, c, static_cast<TW*>(out), n, vocab, E);
  } else {
    err = allow_smem(fused_ce_dh_kernel<T, TW>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_ce_dh_kernel<T, TW><<<blocks, kThreads, smem, stream>>>(
        hp, wp, lp, a, b, c, static_cast<T*>(out), n, vocab, E);
  }
  return (int)cudaGetLastError();
}

// ---- the wide lanes (E > kMaxE): the CUDA-core kernels ----------------------
//
// Past kMaxE neither lane above fits: the CUDA-core kernels keep a (rows x
// E) operand resident and a (32 x E) accumulator in registers; the
// tensor-core dh/dw keep 64 rows x E/2 of operand and accumulator a CTA
// (256 KB and 512 KB at E = 4096, where an SM has 228 KB of shared memory
// and 256 KB of registers). The wide lane, simple and right first:
//   - every operand streams through shared memory in k-chunks of
//     kWideK = 64 columns, so shared memory does not grow with E;
//   - dh and dw split E across a grid axis (blockIdx.y): a block owns the
//     kWideSlice = 512 output columns [512 y, 512 y + 512) of its rows and
//     recomputes the logits tile s = X Y^T over the whole of E for every Y
//     tile, then adds P Y[:, slice] into its (rows x 512) accumulator. One
//     launch, no state across blocks, nothing atomic: every sum has one
//     order, so reruns are bit-equal.
//   - the Y k-chunks inside the block's slice are staged into the slice
//     buffer the product reads, so the slice is read once a tile.
// The cost of the recompute: dh and dw each do (E / 512) 2nVE flops for the
// logits plus 2nVE for the product, 18 nVE at E = 4096, 4.5x the 4nVE of
// the bound. Sharing s across the blocks of a cluster is the fast design.
// The CUDA-core forward needs no split (its accumulator does not hold E):
// it streams k-chunks of both operands into the same Logits fragments.
constexpr int kWideK = 64;       // E columns per streamed k-chunk
constexpr int kWideSlice = 512;  // dh / dw output columns per block

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_wide_kernel(const T* __restrict__ h, const TW* __restrict__ w,
                         const int* __restrict__ labels,
                         float* __restrict__ lse, float* __restrict__ tgt,
                         int n, int vocab, int E) {
  constexpr int R = Cfg<T>::kFwdRows, kT = Cfg<T>::kT;
  constexpr int kRowsPerWarp = R / 8, kColsPerLane = kT / 32;
  constexpr int ld = kWideK + Cfg<T>::kPad, lds = kT + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // R x ld: a k-chunk of the tokens
  T* ys = xs + R * ld;                 // kT x ld: a k-chunk of a vocab tile
  float* ss = reinterpret_cast<float*>(ys + kT * ld);  // R x lds: s

  const int r0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m[kRowsPerWarp], l[kRowsPerWarp], tp[kRowsPerWarp];
  int lab[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int i = r0 + warp * kRowsPerWarp + j;
    m[j] = -CUDART_INF_F;
    l[j] = tp[j] = 0.f;
    lab[j] = i < n ? labels[i] : -1;
  }

  Logits<T, R, kT> lg;
  for (int v0 = 0; v0 < vocab; v0 += kT) {
    lg.zero();
    for (int k0 = 0; k0 < E; k0 += kWideK) {
      __syncthreads();  // the previous chunk (and tile's ss) consumed
      stage_chunk(xs, ld, h, n, E, r0, R, k0, kWideK);
      stage_chunk(ys, ld, w, vocab, E, v0, kT, k0, kWideK);
      __syncthreads();
      lg.add(xs, ld, ys, ld, kWideK);
    }
#pragma unroll
    for (int q = 0; q < lg.kPairs; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) ss[lg.row(q, i) * lds + lg.col(q, i)] = lg.s[q][i];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const float* srow = ss + (warp * kRowsPerWarp + j) * lds;
      float s[kColsPerLane], mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int v = v0 + lane + 32 * c;
        s[c] = v < vocab ? srow[lane + 32 * c] : kNegInf;
        if (v == lab[j]) tp[j] += s[c];
        mx = fmaxf(mx, s[c]);
      }
      const float m_next = fmaxf(m[j], warp_max(mx));
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) e += expf(s[c] - m_next);
      l[j] = expf(m[j] - m_next) * l[j] + warp_sum(e);
      m[j] = m_next;
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int i = r0 + warp * kRowsPerWarp + j;
    const float t = warp_sum(tp[j]);
    if (lane == 0 && i < n) {
      lse[i] = m[j] + logf(l[j]);
      tgt[i] = t;
    }
  }
}

// dh / dw of the CUDA-core wide lane: fused_ce_bwd_body with s over
// streamed k-chunks and the accumulator over this block's E slice.
template <typename T, typename TW, bool kDW>
__device__ __forceinline__ void fused_ce_bwd_wide_body(
    const T* __restrict__ h, const TW* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ glse, const float* __restrict__ gtgt,
    void* __restrict__ out, int n, int vocab, int E) {
  constexpr int R = kBwdRows, kT = Cfg<T>::kT, kGroups = kWideSlice / 64;
  constexpr int kStat = R > kT ? R : kT;
  constexpr int ld = kWideK + Cfg<T>::kPad, lds = kWideSlice + Cfg<T>::kPad;
  constexpr int ldp = kT + Cfg<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // R x ld: X's k-chunk
  T* yc = xs + R * ld;                 // kT x ld: Y's k-chunk off the slice
  T* ysl = yc + kT * ld;               // kT x lds: Y's tile on the slice
  T* ps = ysl + kT * lds;              // R x ldp: P
  float* st_lse = reinterpret_cast<float*>(ps + R * ldp);
  float* st_glse = st_lse + kStat;
  float* st_gtgt = st_glse + kStat;
  int* st_lab = reinterpret_cast<int*>(st_gtgt + kStat);

  const int r0 = blockIdx.x * R;
  const int e0 = blockIdx.y * kWideSlice;
  const int ew = min(kWideSlice, E - e0);  // this block's output columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_x = kDW ? vocab : n, n_y = kDW ? n : vocab;
  const int groups = ew / 64;

  auto stage_stats = [&](int i0, int count) {
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const bool in = i0 + i < n;
      st_lse[i] = in ? lse[i0 + i] : 0.f;
      st_glse[i] = in ? glse[i0 + i] : 0.f;
      st_gtgt[i] = in ? gtgt[i0 + i] : 0.f;
      st_lab[i] = in ? labels[i0 + i] : -1;
    }
  };
  if (!kDW) stage_stats(r0, R);

  float acc[kGroups][R / 16][4];
#pragma unroll
  for (int c = 0; c < kGroups; ++c)
#pragma unroll
    for (int mi = 0; mi < R / 16; ++mi)
      acc[c][mi][0] = acc[c][mi][1] = acc[c][mi][2] = acc[c][mi][3] = 0.f;

  Logits<T, R, kT> lg;
  for (int y0 = 0; y0 < n_y; y0 += kT) {
    lg.zero();
    for (int k0 = 0; k0 < E; k0 += kWideK) {
      const bool on_slice = k0 >= e0 && k0 < e0 + ew;
      T* yk = on_slice ? ysl + (k0 - e0) : yc;
      const int ldy = on_slice ? lds : ld;
      // the previous chunk consumed; at k0 = 0 also the previous tile's
      // P, slice and statistics
      __syncthreads();
      if (kDW) {
        stage_chunk(xs, ld, w, n_x, E, r0, R, k0, kWideK);
        stage_chunk(yk, ldy, h, n_y, E, y0, kT, k0, kWideK);
        if (k0 == 0) stage_stats(y0, kT);
      } else {
        stage_chunk(xs, ld, h, n_x, E, r0, R, k0, kWideK);
        stage_chunk(yk, ldy, w, n_y, E, y0, kT, k0, kWideK);
      }
      __syncthreads();
      lg.add(xs, ld, yk, ldy, kWideK);
    }
#pragma unroll
    for (int q = 0; q < lg.kPairs; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lg.row(q, i), c = lg.col(q, i);
        const int tok = kDW ? c : r;
        const int v = kDW ? r0 + r : y0 + c;
        float p = v < vocab ? st_glse[tok] * expf(lg.s[q][i] - st_lse[tok])
                            : 0.f;
        if (v == st_lab[tok]) p += st_gtgt[tok];
        ps[r * ldp + c] = cvt(p, ps);
      }
    __syncthreads();
    // acc += P (R x kT) Y[:, slice] (kT x ew); warp owns column group
    // c * 64 + warp * 8 of the slice
#pragma unroll
    for (int k = 0; k < kT; k += 16) {
      typename Mma<T>::A a[R / 16];
#pragma unroll
      for (int mi = 0; mi < R / 16; ++mi)
        a[mi] = Mma<T>::load_a(ps + mi * 16 * ldp + k, ldp);
#pragma unroll
      for (int c = 0; c < kGroups; ++c)
        if (c < groups) {
          const auto b = Mma<T>::template load_b<false>(
              ysl + k * lds + c * 64 + warp * 8, lds);
#pragma unroll
          for (int mi = 0; mi < R / 16; ++mi) Mma<T>::mma(acc[c][mi], a[mi], b);
        }
    }
  }

#pragma unroll
  for (int c = 0; c < kGroups; ++c)
    if (c < groups)
#pragma unroll
      for (int mi = 0; mi < R / 16; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + mi * 16 + g + (i >> 1) * 8;
          const int col = e0 + c * 64 + warp * 8 + 2 * t + (i & 1);
          if (r >= n_x) continue;
          if (kDW)
            store(static_cast<TW*>(out) + (size_t)r * E + col, acc[c][mi][i]);
          else
            store(static_cast<T*>(out) + (size_t)r * E + col, acc[c][mi][i]);
        }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
fused_ce_dh_wide_kernel(const T* __restrict__ h, const TW* __restrict__ w,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ glse,
                        const float* __restrict__ gtgt, T* __restrict__ dh,
                        int n, int vocab, int E) {
  fused_ce_bwd_wide_body<T, TW, false>(h, w, labels, lse, glse, gtgt, dh, n,
                                       vocab, E);
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
fused_ce_dw_wide_kernel(const T* __restrict__ h, const TW* __restrict__ w,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ glse,
                        const float* __restrict__ gtgt, TW* __restrict__ dw,
                        int n, int vocab, int E) {
  fused_ce_bwd_wide_body<T, TW, true>(h, w, labels, lse, glse, gtgt, dw, n,
                                      vocab, E);
}

template <typename T>
constexpr size_t fwd_wide_smem() {
  constexpr int R = Cfg<T>::kFwdRows, kT = Cfg<T>::kT;
  return (size_t)(R + kT) * (kWideK + Cfg<T>::kPad) * sizeof(T) +
         (size_t)R * (kT + 4) * sizeof(float);
}

template <typename T>
constexpr size_t bwd_wide_smem() {
  constexpr int R = kBwdRows, kT = Cfg<T>::kT;
  constexpr int kStat = R > kT ? R : kT;
  return ((size_t)(R + kT) * (kWideK + Cfg<T>::kPad) +
          (size_t)kT * (kWideSlice + Cfg<T>::kPad) +
          (size_t)R * (kT + Cfg<T>::kPad)) * sizeof(T) +
         4 * kStat * 4;
}

template <typename T, typename TW>
int launch_fwd_wide(const void* h, const void* w, const void* labels,
                    void* lse, void* tgt, int n, int vocab, int E,
                    cudaStream_t stream) {
  constexpr size_t smem = fwd_wide_smem<T>();
  cudaError_t err = allow_smem(fused_ce_fwd_wide_kernel<T, TW>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + Cfg<T>::kFwdRows - 1) / Cfg<T>::kFwdRows;
  fused_ce_fwd_wide_kernel<T, TW><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const TW*>(w),
      static_cast<const int*>(labels), static_cast<float*>(lse),
      static_cast<float*>(tgt), n, vocab, E);
  return (int)cudaGetLastError();
}

template <typename T, typename TW, bool kDW>
int launch_bwd_wide(const void* h, const void* w, const void* labels,
                    const void* lse, const void* glse, const void* gtgt,
                    void* out, int n, int vocab, int E, cudaStream_t stream) {
  constexpr size_t smem = bwd_wide_smem<T>();
  const dim3 grid(((kDW ? vocab : n) + kBwdRows - 1) / kBwdRows,
                  (E + kWideSlice - 1) / kWideSlice);
  const T* hp = static_cast<const T*>(h);
  const TW* wp = static_cast<const TW*>(w);
  const int* lp = static_cast<const int*>(labels);
  const float *a = static_cast<const float*>(lse),
              *b = static_cast<const float*>(glse),
              *c = static_cast<const float*>(gtgt);
  cudaError_t err;
  if constexpr (kDW) {
    err = allow_smem(fused_ce_dw_wide_kernel<T, TW>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_ce_dw_wide_kernel<T, TW><<<grid, kThreads, smem, stream>>>(
        hp, wp, lp, a, b, c, static_cast<TW*>(out), n, vocab, E);
  } else {
    err = allow_smem(fused_ce_dh_wide_kernel<T, TW>, smem);
    if (err != cudaSuccess) return (int)err;
    fused_ce_dh_wide_kernel<T, TW><<<grid, kThreads, smem, stream>>>(
        hp, wp, lp, a, b, c, static_cast<T*>(out), n, vocab, E);
  }
  return (int)cudaGetLastError();
}

// ---- the tensor-core lane (bf16 h and w, E a multiple of 64) ---------------

namespace cgrp = cooperative_groups;

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kChunk = 64;       // E columns per streamed k-chunk (128 bytes)

// fwd (#5): fused_ce_fwd_tc_kernel. One block of 8 warps per 128 tokens,
// walking the vocab in 256-column tiles, in order.
//   - Warp (wr, wc) owns tokens 32 wr..32 wr + 31 and columns 128 wc.. of
//     every tile: its s is 2 x 16 m16n8 accumulators (128 fp32 registers
//     a thread), and one k16 step loads 2 A and 8 B fragment pairs by
//     ldmatrix (ldsm_a, ldsm_bt) for 32 products, 160 bytes a product.
//   - s never leaves the accumulators: a row's max, rescaled sum and
//     target logit over the warp's columns come from registers with quad
//     shuffles (__shfl_xor_sync 1, 2), each thread keeping a partial l
//     over its own columns, rescaled by the quad's common max. The two
//     column halves of a row keep separate online states and meet once,
//     at the end, through shared memory (the only fp32 there).
//   - Both operands stream as 64-wide k-chunks of E, the 128 token rows
//     and the 256 vocab rows of a chunk in one stage of a 4-stage cp.async
//     ring (48 KB a stage, 192 KB), rows XOR-swizzled: the copies of chunk
//     c + 3 are issued three per k16 step of chunk c, so they overlap its
//     products and never stall the warps in a burst, and the ring runs on
//     across the end of a vocab tile, under the softmax update. Shared
//     memory no longer bounds E.
//   - L2 reckoning: each call reads n V E 2 (1 / 128 + 1 / 256) bytes, 44.5
//     GB at n = 49152 (59 GB with 128 x 128 tiles), and every block walks w
//     in the same order, so the blocks resident together share each w tile
//     in the 50 MB L2; the h tiles they re-read hold 132 x 192 KB = 26 MB.
//     A 128 x 256 tile is the largest whose accumulators fit 8 warps'
//     registers beside the fragments (255 a thread at one block an SM).
// Past kMaxE the forward takes fused_ce_fwd_wide_tc_kernel (below, after
// the wgmma primitives).
constexpr int kFwdTokens = 128;
constexpr int kFwdVocab = 256;
constexpr int kFwdStages = 4;
constexpr size_t kFwdTcSmem =
    (size_t)kFwdStages * (kFwdTokens + kFwdVocab) * kChunk * sizeof(bf16);

__global__ void __launch_bounds__(kTcThreads, 1)
fused_ce_fwd_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                       const int* __restrict__ labels,
                       float* __restrict__ lse, float* __restrict__ tgt,
                       int n, int vocab, int E) {
  constexpr int kFwdNT = kFwdVocab / 2 / 8;  // n8 tiles a warp
  constexpr int kStage = (kFwdTokens + kFwdVocab) * kChunk;  // elements
  constexpr int kCopies = (kFwdTokens + kFwdVocab) * 8 / kTcThreads;  // 12
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const int r0 = blockIdx.x * kFwdTokens;
  const int kc = E / kChunk;  // k-chunks per vocab tile
  const int n_tiles = (vocab + kFwdVocab - 1) / kFwdVocab;
  const int total = n_tiles * kc;

  // copy k (< kCopies) of chunk c (vocab tile c / kc, E columns (c % kc) *
  // 64..): 16 bytes (tid & 7) of token row tid / 8 + 32 k (k < 4), else of
  // the tile's vocab row tid / 8 + 32 (k - 4); rows past n or V zero-filled
  auto copy = [&](int c, int k) {
    const int e0 = (c % kc) * kChunk + (tid & 7) * 8;
    bf16* hs = ring + (c % kFwdStages) * kStage;
    const int r = (tid >> 3) + 32 * (k & 3);
    if (k < 4) {
      const bool in = r0 + r < n;
      cp_async16(hs + swz<kChunk>(r, (tid & 7) * 8),
                 h + (size_t)(in ? r0 + r : 0) * E + e0, in);
    } else {
      const int rv = r + 128 * ((k - 4) >> 2);
      const int v = (c / kc) * kFwdVocab + rv;
      const bool in = v < vocab;
      cp_async16(hs + kFwdTokens * kChunk + swz<kChunk>(rv, (tid & 7) * 8),
                 w + (size_t)(in ? v : 0) * E + e0, in);
    }
  };
  for (int c = 0; c < kFwdStages - 1; ++c) {
    if (c < total)
      for (int k = 0; k < kCopies; ++k) copy(c, k);
    cp_async_commit();  // one group per chunk, empty past the end
  }

  // this thread's rows 32 wr + 16 i + g + 8 r; their state over the
  // warp's columns
  int lab[2][2];
  float m[2][2], l[2][2], tp[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + wr * 32 + i * 16 + g + 8 * r;
      lab[i][r] = row < n ? labels[row] : -1;
      m[i][r] = -CUDART_INF_F;
      l[i][r] = tp[i][r] = 0.f;
    }

  float s[2][kFwdNT][4];
  for (int vt = 0; vt < n_tiles; ++vt) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kFwdNT; ++j)
        s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
    for (int kq = 0; kq < kc; ++kq) {
      const int c = vt * kc + kq;
      cp_async_wait<kFwdStages - 2>();
      __syncthreads();  // chunk c landed for all; chunk c - 1's stage free
      const bool more = c + kFwdStages - 1 < total;
      const bf16* hs = ring + (c % kFwdStages) * kStage;
      const bf16* ws = hs + kFwdTokens * kChunk;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        if (more)
#pragma unroll
          for (int k = 0; k < kCopies / 4; ++k)
            copy(c + kFwdStages - 1, kk * (kCopies / 4) + k);
        const MmaBf16::A a0 = ldsm_a<kChunk>(hs, wr * 32, kk * 16);
        const MmaBf16::A a1 = ldsm_a<kChunk>(hs, wr * 32 + 16, kk * 16);
        // the next B pair is loaded while one is multiplied
        MmaBf16::B b[2][2];
        ldsm_bt<kChunk>(b[0][0], b[0][1], ws, wc * (kFwdVocab / 2), kk * 16);
#pragma unroll
        for (int j = 0; j < kFwdNT; j += 2) {
          const int cur = (j >> 1) & 1;
          if (j + 2 < kFwdNT)
            ldsm_bt<kChunk>(b[cur ^ 1][0], b[cur ^ 1][1], ws,
                            wc * (kFwdVocab / 2) + (j + 2) * 8, kk * 16);
          MmaBf16::mma(s[0][j], a0, b[cur][0]);
          MmaBf16::mma(s[0][j + 1], a0, b[cur][1]);
          MmaBf16::mma(s[1][j], a1, b[cur][0]);
          MmaBf16::mma(s[1][j + 1], a1, b[cur][1]);
        }
      }
      cp_async_commit();
    }

    // the warp's columns v0 + j * 8 + 2t + (e & 1); past V: -1e30
    const int v0 = vt * kFwdVocab + wc * (kFwdVocab / 2);
    if (v0 + kFwdVocab / 2 > vocab) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kFwdNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (v0 + j * 8 + 2 * t + (e & 1) >= vocab) s[i][j][e] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rel[2] = {lab[i][0] - v0 - 2 * t, lab[i][1] - v0 - 2 * t};
      float mx[2] = {m[i][0], m[i][1]};
#pragma unroll
      for (int j = 0; j < kFwdNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j * 8 + (e & 1) == rel[e >> 1]) tp[i][e >> 1] += s[i][j][e];
          mx[e >> 1] = fmaxf(mx[e >> 1], s[i][j][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float x[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kFwdNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e >> 1] += __expf(s[i][j][e] - mx[e >> 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[i][r] = l[i][r] * __expf(m[i][r] - mx[r]) + x[r];
        m[i][r] = mx[r];
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();     // the ring is free: it takes the halves' states

  // (m, l, tgt) of each row from each column half, then one thread a row:
  // m = max(m0, m1), l = l0 e^(m0 - m) + l1 e^(m1 - m)
  float* st = reinterpret_cast<float*>(smem_raw);  // 2 x 3 x kFwdTokens
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[i][r], tt = tp[i][r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      tt += __shfl_xor_sync(0xffffffffu, tt, 1);
      tt += __shfl_xor_sync(0xffffffffu, tt, 2);
      const int row = wr * 32 + i * 16 + g + 8 * r;
      if (t == 0) {
        st[(wc * 3 + 0) * kFwdTokens + row] = m[i][r];
        st[(wc * 3 + 1) * kFwdTokens + row] = lt;
        st[(wc * 3 + 2) * kFwdTokens + row] = tt;
      }
    }
  __syncthreads();
  if (tid < kFwdTokens && r0 + tid < n) {
    const float m0 = st[tid], m1 = st[3 * kFwdTokens + tid];
    const float mm = fmaxf(m0, m1);
    const float lt = st[kFwdTokens + tid] * __expf(m0 - mm) +
                     st[4 * kFwdTokens + tid] * __expf(m1 - mm);
    lse[r0 + tid] = mm + logf(lt);
    tgt[r0 + tid] = st[2 * kFwdTokens + tid] + st[5 * kFwdTokens + tid];
  }
}

int launch_fwd_tc(const void* h, const void* w, const void* labels,
                  void* lse, void* tgt, int n, int vocab, int E,
                  cudaStream_t stream) {
  cudaError_t err = allow_smem(fused_ce_fwd_tc_kernel, kFwdTcSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kFwdTokens - 1) / kFwdTokens;
  fused_ce_fwd_tc_kernel<<<blocks, kTcThreads, kFwdTcSmem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<float*>(lse),
      static_cast<float*>(tgt), n, vocab, E);
  return (int)cudaGetLastError();
}

// dh (#6) and dw (#7): fused_ce_dh_tc_kernel<C> and fused_ce_dw_tc_kernel<C,
// TW>, two thin kernels over one body, fused_ce_bwd_tc_body<C, kDW, TX>.
// dW = P^T h is dH = P w transposed: per streamed tile, s = X Y^T, P from
// s, acc += P Y, with X = h (resident) and Y = w (streamed) for dh, X = w
// and Y = h for dw, where P is the dlogits tile transposed and the token
// statistics run along its columns. Below, "rows" are X's (dh: tokens,
// dw: vocab rows) and "columns" Y's.
//
// A cluster of C = 2 CTAs (a thread-block cluster: neighbouring SMs that
// write each other's shared memory) owns 64 rows; CTA r owns E-chunks
// [r p, (r + 1) p) of the E / 64, p = ceil(E / 128): at E = 768, 384
// columns each.
//   - The CTA's X slice (64 rows x its chunks) is resident in shared
//     memory (dw: an fp32 w is rounded to bf16 as it is staged, once per
//     CTA, the values of the TPU kernel's per-tile astype); its slice of
//     each 64-row Y tile streams through a 2-stage cp.async ring (48 KB a
//     stage). dw's stage also carries the tile's 64 tokens' lse, glse,
//     gtgt and labels (1 KB; past n: zeros, so P is 0 there).
//   - Per Y tile j, the CTA's partial logits s_r over its E-slice: warps
//     0-3 take its even chunks and warps 4-7 its odd ones, each warp a
//     (32 rows x 32 columns) tile, so one k16 step loads 2 A and 2 B
//     fragments by ldmatrix for 8 products; each warp hands the half of
//     its tile that its partner sums to shared memory, in mma fragment
//     order (one float4 per lane and m16n8 tile: conflict-free both ways).
//   - Each warp keeps its summed part of s_r in registers and pushes a
//     copy into its peer CTA's shared memory (distributed shared memory
//     stores: the writer does not wait), then one cluster barrier, split:
//     tile j + 1's copies are issued between arrive and wait, in the
//     shadow of the pushes and the peer. The peer's slots are
//     double-buffered, so the next push never overwrites partials the
//     peer is still reading. Every CTA then sums s_0 + s_1 (two terms:
//     the same bits in either order), so both hold bit-identical s and P,
//     and reruns are bit-equal (no atomics), and forms P = glse * exp(s -
//     lse) + gtgt * onehot, 0 at a vocab index >= V, rounded to bf16
//     (absolute: JAX's rounding, fused_ce_pallas.py:126, :150), once per
//     element, into a swizzled bf16 tile. exp is ex2.approx (__expf, as
//     fwd).
//   - out[rows, slice] += P Y_tile[:, slice] on mma.sync, P by ldsm_a and
//     Y by ldsm_b from the slice the ring already holds: each Y byte feeds
//     both products, and the work stays 4 n V E. Warp (pr, pc) owns rows
//     32 pr.. and the pc-th 16-column pair of every chunk: 2 A and p B
//     fragments a k16 step for 4 p products.
//   - Every k16 step's fragments are loaded while the step before is
//     multiplied (registers double-buffered): with 2 warps a scheduler,
//     an ldmatrix feeding the next mma at once would stall it.
//   - The accumulator: 64 rows x 64 p columns, 96 fp32 registers a
//     thread, where the CUDA-core lane's 32 rows held all of E. C = 4
//     (128 rows) would need three pushed partials a tile, 64 KB
//     double-buffered beside the ring: not built.
// Why the design is so: dH's rate does not move with V or n, w in L2 or
// not (port_probe.py fused), so the time is spent inside the SM.
// clock64() counters around each phase (in a build made for that) showed
// these costs beside the two products: pulling the peer's partials after
// the barrier; a burst of each tile's copies; expf's exact rounding; an
// ldmatrix feeding the next mma at once; the cluster barrier, whose
// release waits for the pushes. Hence the push, the copies in the
// barrier's shadow, __expf and the double-buffered fragments.
//
// dh (#6) replaces fused_ce_pallas.py:112 _dh_kernel. L2 reckoning: w is
// read once per cluster, n V E 2 / 64 bytes, 59 GB at n = 49152 (119 GB
// with 32 tokens).
//
// dw (#7) replaces fused_ce_pallas.py:134 _dw_kernel. Bound: operations,
// 4 n V E (the logits are recomputed), 7.673 ms at n = 49152, V = 50257,
// E = 768 on 989 TFLOP/s. L2 reckoning: h (75.5 MB) is read once per
// cluster, n E 2 V / 64 bytes, 59 GB a call, where 32-row blocks (the
// CUDA-core body) read it V / 32 times (118 GB); 786 clusters (1,572
// CTAs, one an SM: 202 KB of shared memory each), about 12 waves. The
// CUDA-core body's five costs with bf16 operands, and what answers each:
//   1. 32 vocab rows a block: the 2-CTA cluster owns 64 (L2 traffic
//      halved, no logit recomputed);
//   2. unpipelined staging through registers between two barriers, one
//      block an SM: the cp.async ring, the next tile's copies (and its
//      statistics) in the shadow of the cluster barrier;
//   3. hand-indexed fragments (P h's B operand from four 16-bit loads
//      each): ldsm_a, ldsm_bt and ldsm_b;
//   4. m16n8 tile pairs with A reloaded for every product: 32 x 32 warp
//      tiles, fragments double-buffered in registers;
//   5. P through a padded tile with scalar stores and exactly rounded
//      expf: P formed in registers, packed in pairs into a swizzled tile,
//      __expf; the statistics read as float2 pairs from the ring.
constexpr int kTcTile = 64;    // Y rows per streamed tile
constexpr int kTcStages = 2;   // Y tiles in the ring

template <int C>
struct BwdTc {
  static_assert(C == 2, "the partial exchange is laid out for 2 CTAs");
  static constexpr int kRows = 32 * C;
  static constexpr int kMT = C;  // m16 tiles a warp, in both products
  static constexpr int kChunks = (kMaxE / kChunk + C - 1) / C;  // per CTA
  static constexpr int kSlot = kRows / 16 * (kTcTile / 8) * 32;  // float4s
  // X slice, ring, where the K halves meet, two slots of the peer's
  // partials, one P tile; dw: the ring's token statistics
  static constexpr size_t smem(bool dw) {
    return (size_t)(kRows + kTcStages * kTcTile) * kChunks * kChunk *
               sizeof(bf16) +
           3 * (size_t)kSlot * sizeof(float4) +
           (size_t)kRows * kTcTile * sizeof(bf16) +
           (dw ? (size_t)kTcStages * 4 * kTcTile * sizeof(float) : 0);
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// two adjacent columns of an output row, rounded to its type
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// x (n_x, E) in TX (bf16, or fp32 for an fp32 w), y (n_y, E) bf16; out
// (n_x, E) in TX. dh: x = h, y = w; dw: x = w, y = h.
template <int C, bool kDW, typename TX>
__device__ __forceinline__ void fused_ce_bwd_tc_body(
    const TX* __restrict__ x, const bf16* __restrict__ y,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ glse, const float* __restrict__ gtgt,
    TX* __restrict__ out, int n, int vocab, int E) {
  using K = BwdTc<C>;
  constexpr int kTile = kTcTile * kChunk;  // elements of one chunk tile
  constexpr int kMT = K::kMT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // kChunks x kRows x 64
  bf16* ys = xs + K::kChunks * K::kRows * kChunk;  // stages x kChunks x tile
  float4* half =  // where the two K halves of s_r meet
      reinterpret_cast<float4*>(ys + kTcStages * K::kChunks * kTile);
  float4* peer = half + K::kSlot;  // 2 slots: the peer's partials
  bf16* ps = reinterpret_cast<bf16*>(peer + 2 * K::kSlot);  // P, kRows x 64
  // dw: per stage, (lse, glse, gtgt, labels) of the tile's kTcTile tokens
  float* stats = reinterpret_cast<float*>(ps + K::kRows * kTcTile);

  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // s product: K half kh, rows 32 rq.., columns 32 cq..; P Y: rows 32
  // pr.., the pc-th pair of each chunk
  const int kh = warp >> 2, rq = (warp >> 1) & 1, cq = warp & 1;
  const int pr = warp >> 2, pc = warp & 3;
  const int n_x = kDW ? vocab : n, n_y = kDW ? n : vocab;
  const int r0 = (blockIdx.x / C) * K::kRows;
  const int per = (E / kChunk + C - 1) / C;
  const int ch0 = min(E / kChunk, rank * per);
  const int nch = min(E / kChunk, ch0 + per) - ch0;  // may be 0 at small E
  const int n_tiles = (n_y + kTcTile - 1) / kTcTile;
  // the peer's slots for this CTA's partials
  float4* to_peer = cluster.map_shared_rank(peer, rank ^ 1);

  // the X slice, once
  for (int i = tid; i < nch * K::kRows * 8; i += kTcThreads) {
    const int q = i / (K::kRows * 8), r = (i >> 3) % K::kRows;
    const int col = (i & 7) * 8;
    const bool in = r0 + r < n_x;
    const TX* src = x + (size_t)(in ? r0 + r : 0) * E + (ch0 + q) * kChunk +
                    col;
    bf16* dst = xs + q * K::kRows * kChunk + swz<kChunk>(r, col);
    if constexpr (std::is_same<TX, bf16>::value) {
      cp_async16(dst, src, in);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        const float4 a = reinterpret_cast<const float4*>(src)[0];
        const float4 b = reinterpret_cast<const float4*>(src)[1];
        v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                       pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  // copy k (< 2 nch) of Y tile j: chunk k / 2, row tid / 8 + 32 (k & 1),
  // 16 bytes (tid & 7) of it; dw: then the tile's statistics, thread tid
  // one value (array tid / 64, token tid % 64)
  auto copy = [&](int j, int k) {
    const int q = k >> 1, r = (tid >> 3) + 32 * (k & 1), col = (tid & 7) * 8;
    const int yr = j * kTcTile + r;
    const bool in = yr < n_y;
    cp_async16(ys + ((j % kTcStages) * K::kChunks + q) * kTile +
                   swz<kChunk>(r, col),
               y + (size_t)(in ? yr : 0) * E + (ch0 + q) * kChunk + col, in);
  };
  auto copy_stats = [&](int j) {
    if constexpr (kDW) {
      const int a = tid / kTcTile, i = j * kTcTile + tid % kTcTile;
      const float* src = a == 0   ? lse
                         : a == 1 ? glse
                         : a == 2 ? gtgt
                                  : reinterpret_cast<const float*>(labels);
      const bool in = i < n;
      cp_async4(stats + ((j % kTcStages) * 4 + a) * kTcTile + tid % kTcTile,
                src + (in ? i : 0), in);
    }
  };
  static_assert(!kDW || kTcThreads == 4 * kTcTile, "one statistic a thread");
  for (int k = 0; k < 2 * nch; ++k) copy(0, k);
  copy_stats(0);
  cp_async_commit();

  // the rows this thread forms P for: m16 tile 2 rq + kh, rows g and
  // g + 8. dh: their token statistics; dw: their vocab index
  const int pm = rq * kMT + kh;
  float st_lse[2], st_glse[2], st_gtgt[2];
  int st_lab[2], vrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + pm * 16 + g + 8 * r;
    vrow[r] = row;
    if constexpr (!kDW) {
      const bool in = row < n;
      st_lse[r] = in ? lse[row] : 0.f;
      st_glse[r] = in ? glse[row] : 0.f;
      st_gtgt[r] = in ? gtgt[row] : 0.f;
      st_lab[r] = in ? labels[row] : -1;
    }
  }
  // float4 index of this thread's element of (m16 tile mt, n8 tile nt)
  auto slot = [&](int mt, int nt) { return (mt * 8 + nt) * 32 + lane; };

  float acc[K::kChunks][kMT][2][4];
#pragma unroll
  for (int q = 0; q < K::kChunks; ++q)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[q][i][e][0] = acc[q][i][e][1] = acc[q][i][e][2] =
            acc[q][i][e][3] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; tile jt - 1's stage and P free
    const bf16* yt = ys + (jt % kTcStages) * K::kChunks * kTile;

    // this warp's half of s_r: rows 32 rq.., columns 32 cq.., over chunks
    // kh, kh + 2, ..; each k16 step's fragments are loaded while the step
    // before is multiplied
    float s[kMT][4][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j][0] = s[i][j][1] = s[i][j][2] =
          s[i][j][3] = 0.f;
    MmaBf16::A a[2][kMT];
    MmaBf16::B b[2][4];
    auto frags = [&](int q, int kk, MmaBf16::A(&fa)[kMT],
                     MmaBf16::B(&fb)[4]) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        fa[i] = ldsm_a<kChunk>(xs + q * K::kRows * kChunk,
                               (rq * kMT + i) * 16, kk * 16);
      ldsm_bt<kChunk>(fb[0], fb[1], yt + q * kTile, cq * 32, kk * 16);
      ldsm_bt<kChunk>(fb[2], fb[3], yt + q * kTile, cq * 32 + 16, kk * 16);
    };
    if (kh < nch) frags(kh, 0, a[0], b[0]);
    for (int q = kh; q < nch; q += 2)
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const int cur = kk & 1;
        if (kk + 1 < kChunk / 16)
          frags(q, kk + 1, a[cur ^ 1], b[cur ^ 1]);
        else if (q + 2 < nch)
          frags(q + 2, 0, a[cur ^ 1], b[cur ^ 1]);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            MmaBf16::mma(s[i][j], a[cur][i], b[cur][j]);
      }

    // s_r = even half + odd half, m16 tile 2 rq + kh by warp (kh, rq,
    // cq): each warp leaves its other tile to its partner, then sums its
    // own and pushes the sum to the peer's slot
    float mine[4][4];  // s[kh], selected: registers take no runtime index
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      half[slot(rq * kMT + (kh ^ 1), cq * 4 + j)] =
          kh ? make_float4(s[0][j][0], s[0][j][1], s[0][j][2], s[0][j][3])
             : make_float4(s[1][j][0], s[1][j][1], s[1][j][2], s[1][j][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[j][e] = kh ? s[1][j][e] : s[0][j][e];
    }
    __syncthreads();
    float4* dst = to_peer + (jt & 1) * K::kSlot;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = slot(pm, cq * 4 + j);
      const float4 v = half[at];
      mine[j][0] += v.x;
      mine[j][1] += v.y;
      mine[j][2] += v.z;
      mine[j][3] += v.w;
      dst[at] = make_float4(mine[j][0], mine[j][1], mine[j][2], mine[j][3]);
    }
    cluster_arrive();
    // tile jt + 1's copies, into the stage tile jt - 1 left, while the
    // pushes land and the peer arrives
    if (jt + 1 < n_tiles) {
      for (int k = 0; k < 2 * nch; ++k) copy(jt + 1, k);
      copy_stats(jt + 1);
    }
    cp_async_commit();
    cluster_wait();  // both ranks' partials of tile jt in both CTAs

    // s = s_0 + s_1 (rank order; two terms commute exactly) for m16 tile
    // pm, n8 tiles 4 cq.., then P
    const float4* theirs = peer + (jt & 1) * K::kSlot;
    const float* st = stats + (jt % kTcStages) * 4 * kTcTile;
    const int y0 = jt * kTcTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = theirs[slot(pm, cq * 4 + j)];
      const float sv[4] = {mine[j][0] + v.x, mine[j][1] + v.y,
                           mine[j][2] + v.z, mine[j][3] + v.w};
      const int c = (cq * 4 + j) * 8 + 2 * t;
      float p[4];
      if constexpr (kDW) {
        // columns c, c + 1 are tokens y0 + c..; rows are vocab rows
        const float2 sl = *reinterpret_cast<const float2*>(st + c);
        const float2 sg = *reinterpret_cast<const float2*>(st + kTcTile + c);
        const float2 stg =
            *reinterpret_cast<const float2*>(st + 2 * kTcTile + c);
        const int2 sb = *reinterpret_cast<const int2*>(st + 3 * kTcTile + c);
        const float cl[2] = {sl.x, sl.y}, cg[2] = {sg.x, sg.y};
        const float ct[2] = {stg.x, stg.y};
        const int cb[2] = {sb.x, sb.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, k = e & 1;
          p[e] = vrow[r] < vocab ? cg[k] * __expf(sv[e] - cl[k]) : 0.f;
          if (vrow[r] == cb[k]) p[e] += ct[k];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = y0 + c + (e & 1), r = e >> 1;
          p[e] = v < vocab ? st_glse[r] * __expf(sv[e] - st_lse[r]) : 0.f;
          if (v == st_lab[r]) p[e] += st_gtgt[r];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            ps + swz<kTcTile>(pm * 16 + g + 8 * r, c)) =
            pack_bf16(p[2 * r], p[2 * r + 1]);
    }
    __syncthreads();  // the P tile written

    // out[rows, slice] += P Y_tile[:, slice] for the warp's rows and
    // pairs (the next chunk's B fragments are loaded while one is
    // multiplied)
#pragma unroll
    for (int kk = 0; kk < kTcTile / 16; ++kk) {
      MmaBf16::A pa[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        pa[i] = ldsm_a<kTcTile>(ps, (pr * kMT + i) * 16, kk * 16);
      MmaBf16::B pb[2][2];
      if (nch > 0) ldsm_b<kChunk>(pb[0][0], pb[0][1], yt, kk * 16, pc * 16);
#pragma unroll
      for (int q = 0; q < K::kChunks; ++q)
        if (q < nch) {
          if (q + 1 < nch)
            ldsm_b<kChunk>(pb[(q + 1) & 1][0], pb[(q + 1) & 1][1],
                           yt + (q + 1) * kTile, kk * 16, pc * 16);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            MmaBf16::mma(acc[q][i][0], pa[i], pb[q & 1][0]);
            MmaBf16::mma(acc[q][i][1], pa[i], pb[q & 1][1]);
          }
        }
    }
  }
  cluster.sync();  // no CTA leaves while its peer may still push to it

#pragma unroll
  for (int q = 0; q < K::kChunks; ++q)
    if (q < nch)
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r0 + (pr * kMT + i) * 16 + g + 8 * r;
            const int col = (ch0 + q) * kChunk + pc * 16 + e * 8 + 2 * t;
            if (row < n_x)
              store2(out + (size_t)row * E + col, acc[q][i][e][2 * r],
                     acc[q][i][e][2 * r + 1]);
          }
}

template <int C>
__global__ void __launch_bounds__(kTcThreads, 1)
fused_ce_dh_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                      const int* __restrict__ labels,
                      const float* __restrict__ lse,
                      const float* __restrict__ glse,
                      const float* __restrict__ gtgt, bf16* __restrict__ dh,
                      int n, int vocab, int E) {
  fused_ce_bwd_tc_body<C, false, bf16>(h, w, labels, lse, glse, gtgt, dh, n,
                                       vocab, E);
}

template <int C, typename TW>
__global__ void __launch_bounds__(kTcThreads, 1)
fused_ce_dw_tc_kernel(const bf16* __restrict__ h, const TW* __restrict__ w,
                      const int* __restrict__ labels,
                      const float* __restrict__ lse,
                      const float* __restrict__ glse,
                      const float* __restrict__ gtgt, TW* __restrict__ dw,
                      int n, int vocab, int E) {
  fused_ce_bwd_tc_body<C, true, TW>(w, h, labels, lse, glse, gtgt, dw, n,
                                    vocab, E);
}

// the cluster size of both backward kernels
constexpr int kBwdCluster = 2;

// Launch `kernel` on clusters of kBwdCluster CTAs, one cluster per 64 rows
// of its resident operand.
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), int rows, size_t smem,
                   cudaStream_t stream, A... args) {
  constexpr int C = kBwdCluster;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((rows + BwdTc<C>::kRows - 1) / BwdTc<C>::kRows));
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_dh_tc(const void* h, const void* w, const void* labels,
                 const void* lse, const void* glse, const void* gtgt,
                 void* dh, int n, int vocab, int E, cudaStream_t stream) {
  return launch_cluster(
      fused_ce_dh_tc_kernel<kBwdCluster>, n, BwdTc<kBwdCluster>::smem(false),
      stream, static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(glse), static_cast<const float*>(gtgt),
      static_cast<bf16*>(dh), n, vocab, E);
}

template <typename TW>
int launch_dw_tc(const void* h, const void* w, const void* labels,
                 const void* lse, const void* glse, const void* gtgt,
                 void* dw, int n, int vocab, int E, cudaStream_t stream) {
  return launch_cluster(
      fused_ce_dw_tc_kernel<kBwdCluster, TW>, vocab,
      BwdTc<kBwdCluster>::smem(true), stream, static_cast<const bf16*>(h),
      static_cast<const TW*>(w), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(glse),
      static_cast<const float*>(gtgt), static_cast<TW*>(dw), n, vocab, E);
}

// ---- the wide lanes (E > kMaxE): dh and dw on the tensor cores --------------
//
// fused_ce_dh_wide_tc_kernel (#6, replaces fused_ce_pallas.py:112
// _dh_kernel, called at :234) and fused_ce_dw_wide_tc_kernel<TO> (#7,
// replaces :134 _dw_kernel, called at :252), one body,
// fused_ce_bwd_wide_tc_body<kDW, TO>, with X, Y and P as in
// fused_ce_bwd_tc_body: dh = P w (X = h, Y = w), dw = P^T h (X = w, Y =
// h), P = glse exp(s - lse) + gtgt onehot from fp32 s, 0 at a vocab index
// >= V, rounded to bf16 (__expf). X and Y are bf16 (an fp32 w is cast
// once by the wrapper); out is bf16 for dh and TO (w's dtype) for dw.
//
// Bound: operations, 4 n V E (s and P Y once each), 4.343 ms at the Llama
// training shape (n 8192, V 32000, E 4096) on 989 TFLOP/s.
//
// A cluster of C CTAs (thread-block cluster, distributed shared memory)
// owns 64 rows of X and shares one s. C and the slice are picked at
// launch from E (wide_plan): C = 2, 4 or 8, the least that gives each CTA
// at most 8 of the E / 64 chunks; CTA r owns chunks [r p, r p + p), p =
// ceil(E / 64 / C) (E = 4096: C = 8, 512 columns a CTA; E = 832: C = 2,
// 7 and 6 chunks).
//   - X[rows, slice r] (64 KB at most) is loaded once and stays resident;
//     Y streams in 64-row tiles through two tile buffers (128 KB), CTA r
//     copying only Y[tile, slice r]: the same bytes feed its partial s_r
//     = X[:, slice] Y[tile, slice]^T and then its out[:, slice] += P
//     Y[tile, slice]. A cluster reads each Y tile once: L2 traffic is
//     (n / 64) V E 2 bytes for dh and (V / 64) n E 2 for dw, 33.5 GB each
//     at the Llama shape (about 0.5 TB when each 512-column block
//     recomputed s), and s is computed once per (row block, Y tile).
//   - Warp specialization: two consumer warpgroups run the products; a
//     third, the exchange warpgroup, reduces this CTA's band of the
//     partials, sends its P rows and issues every copy, so the exchange
//     runs beside the products. setmaxnreg gives the consumers 224
//     registers each and the exchange warpgroup 48. The role is chosen
//     on the warpgroup index taken through a shuffle: in a branch ptxas
//     cannot prove warpgroup-uniform it serializes the wgmma (warning
//     C7520), which ran slower on the card.
//   - Copies by TMA (cp.async.bulk.tensor, 64 x 64 boxes in the 128-byte
//     swizzle, rows past the tensor zero-filled), each chunk on its own
//     mbarrier, so the s product takes a chunk as soon as it lands; tile
//     j + 2's copies go out once all 8 consumer warps have arrived on an
//     mbarrier after tile j's P Y.
//   - Both products run on wgmma from shared memory, every operand a
//     64 x 64 bf16 tile (swz<64>, 1024-byte aligned): warpgroup wg sums
//     s_r[:, 32 wg..] with m64n32k16 (A = X, B = Y, both K-major), each
//     64-column chunk from zero into its own accumulator, two chunks in
//     flight at a time, and then added into s in chunk order: the tensor
//     cores' own fp32 sum over E / 16 steps put dh 2.3x outside
//     fused_grad_bound at E = 5120. (Issuing chunk q + 2 as soon as chunk
//     q was added, behind a wgmma.fence, ran slower than pairs on the
//     card.) Then out[:, 256 wg..] += P Y[tile, slice] with m64n256k16 (B
//     MN-major): 128 fp32 accumulators a thread over the 2 consumer
//     warpgroups.
//   - The exchange, nothing atomic, no cluster-wide barrier in the loop:
//     (A) each CTA sends band q (64 / C rows) of its partial s_r to CTA q
//     by st.async (in wgmma fragment order), counted on q's mbarrier;
//     (B) CTA q's exchange warpgroup sums the C partials of each element
//     of its band in rank order 0..C-1, forms P, rounds it to bf16 into
//     its rows of the P tile and sends those rows (one contiguous run) to
//     every peer by one bulk copy each, counted on the peer's mbarrier;
//     its own rows count as the arrival of that phase, made only once
//     the phase before is over. Every CTA then holds the same P, formed
//     once per element; reruns are bit-equal. Each CTA waits only for the
//     bytes it needs (16 KB of partials, then the peers' P rows). One
//     slot of each kind suffices: a CTA sends tile j + 1's partials only
//     once it holds all of tile j's P, which every owner sends after
//     reading tile j's partials, and an owner sends tile j + 1's P only
//     once it holds every peer's tile j + 1 partials, which each peer
//     sends after its P Y of tile j.
//   - The next tile's s is split in chunk order (same order, same bits):
//     its first half runs while tile j's partials travel, its second
//     after tile j's P Y, while tile j + 2's copies land.
//   - Past C 512 = 4096 columns (E = 5120, Llama-70B's 8192) the E-group
//     path: C = 8, each CTA's s slice is p = ceil(E / 512) chunks, and a
//     grid axis of ceil(p / 8) E-groups each outputs 8 of them; every
//     group computes the same s (the recompute factor is the number of
//     groups, ceil(E / 4096)), streaming X and Y chunk by chunk through a
//     2-stage cp.async ring, the Y chunks of its output slice into the
//     tile buffer.
//   - Shared memory: X or the ring 64 KB, two Y tiles 128 KB, the partials
//     received 16 KB, P 8 KB, token statistics 2 KB, 20 mbarriers: 218 KB,
//     one CTA of 384 threads an SM. A call is one launch
//     (cudaLaunchKernelEx with a cluster dimension attribute);
//     hetu_fused_ce_wide_info reports C, p, the groups and
//     cudaOccupancyMaxActiveClusters (15 clusters of 8 on an H100 SXM:
//     120 of its 132 SMs).
constexpr int kWRows = 64;   // X rows per cluster
constexpr int kWTile = 64;   // Y rows per streamed tile
constexpr int kWSlice = kWideSlice / kChunk;  // output chunks a CTA: 8
constexpr int kWMaxCluster = 8;
constexpr int kWTileElems = 64 * kChunk;      // one 64 x 64 bf16 tile
constexpr int kWTileBytes = kWTileElems * 2;  // 8 KB
// shared memory, bytes from a 1024-byte aligned base
constexpr int kWOffX = 0;  // X's slice, or the E-group path's ring
constexpr int kWOffY = kWOffX + kWSlice * kWTileBytes;             // 2 tiles
constexpr int kWOffRecv = kWOffY + 2 * kWSlice * kWTileBytes;      // fp32 s
constexpr int kWOffP = kWOffRecv + kWRows * kWTile * 4;            // bf16 P
constexpr int kWOffStats = kWOffP + kWRows * kWTile * 2;           // 2 x 1 KB
constexpr int kWOffBar = kWOffStats + 2 * 4 * kWTile * 4;  // mbarriers
constexpr size_t kWSmem = kWOffBar + (4 + 2 * kWSlice) * 8 + 1024;  // + align
// threads: two consumer warpgroups and the exchange warpgroup, whose
// registers setmaxnreg moves to the consumers (224 x 256 + 48 x 128 of
// the SM's 65,536; 216 and 72 ran no faster); named barriers of each
// role (0 is __syncthreads)
constexpr int kWConsumers = 256;
constexpr int kWThreads = kWConsumers + 128;
constexpr int kWConsumerRegs = 224;
constexpr int kWExchangeRegs = 48;
constexpr int kWConsumerBar = 1;
constexpr int kWExchangeBar = 2;

struct WidePlan {
  int C;       // cluster size
  int per;     // E chunks of s a CTA sums
  int groups;  // E-groups (grid y): each recomputes s
};

__host__ __device__ inline WidePlan wide_plan(int E) {
  const int kc = E / kChunk;
  int C = 2;
  while (C < kWMaxCluster && C * kWSlice < kc) C *= 2;
  const int per = (kc + C - 1) / C;
  return {C, per, (per + kWSlice - 1) / kWSlice};
}

// ---- wgmma (sm_90a): operands in shared memory by descriptor --------------
// A descriptor of a 128-byte swizzled operand: start address, leading and
// stride byte offsets (16-byte units), layout 1 (128-byte swizzle). K-major
// (rows of 64 bf16 along K): 8-row groups 1024 bytes apart, the next k16
// step 32 bytes on. MN-major (rows of 64 bf16 along N, one per k): the
// next 8 k 1024 bytes on, the next 64 columns `lbo` bytes on.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching an accumulator across a wgmma wait
__device__ __forceinline__ void wg_pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
// this thread's generic-proxy writes to its CTA's shared memory (cp.async,
// st.shared) made visible to the async proxy (wgmma, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers and distributed shared memory (sm_90) -----------------------
// the shared::cluster address of shared::cta address `addr` in CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// this thread's arrival on the current phase, which then also waits for
// `bytes` of data (signalled by st.async or a bulk copy)
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// until the phase of this parity has completed; what peers of the cluster
// wrote into it is visible after
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one arrival on this CTA's mbarrier
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// a barrier of `count` threads (a multiple of 32), named `id` (1..15)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// 8 bytes into a CTA of the cluster (`addr`, `bar` from mapa), counted on
// its mbarrier; the writer does not wait
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}
// a 64 x 64 bf16 box of a 2-D tensor map at (column c0, row r0) into
// shared memory, in the map's 128-byte swizzle (rows past the tensor
// zero-filled), counted on this CTA's mbarrier `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int r0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar)
      : "memory");
}
// `bytes` of this CTA's shared memory from `src` to `dst` in another CTA
// of the cluster, counted on its mbarrier `bar`
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d (64 x 32 fp32) = or += A (64 x 16, K-major) B (16 x 32, K-major);
// scale_d 0 starts from zero. Thread (warp w of the warpgroup, lane g t)
// holds d[4 j + e] at row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 256 fp32) = or += A (64 x 16, K-major) B (16 x 256, MN-major),
// the same fragment layout over 32 column blocks of 8
__device__ __forceinline__ void wgmma_n256_tb(float (&d)[128], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// x (n_x, E) and y (n_y, E) bf16; out (n_x, E) in TO. dh: x = h, y = w;
// dw: x = w, y = h. Warpgroups 0 and 1 run the products (consumers);
// warpgroup 2 reduces this CTA's band of the partials, sends its P rows
// and issues the copies (the exchange warpgroup).
template <bool kDW, typename TO>
__device__ __forceinline__ void fused_ce_bwd_wide_tc_body(
    const CUtensorMap* tmx, const CUtensorMap* tmy,
    const bf16* __restrict__ x, const bf16* __restrict__ y,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ glse, const float* __restrict__ gtgt,
    TO* __restrict__ out, int n, int vocab, int E) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  unsigned char* smem =
      wide_smem + ((1024 - (smem_addr(wide_smem) & 1023)) & 1023);
  bf16* xs = reinterpret_cast<bf16*>(smem + kWOffX);  // X, or the ring
  bf16* yt = reinterpret_cast<bf16*>(smem + kWOffY);  // 2 x kWSlice tiles
  float2* recv = reinterpret_cast<float2*>(smem + kWOffRecv);
  bf16* ps = reinterpret_cast<bf16*>(smem + kWOffP);  // P, 64 x 64
  // (lse, glse, gtgt, labels) of 64 tokens: dh the cluster's rows; dw
  // each Y tile's, by tile parity
  float* stats = reinterpret_cast<float*>(smem + kWOffStats);
  // the partials of this CTA's band have landed / tile j's P is whole
  const uint32_t bar_s = smem_addr(smem + kWOffBar);
  const uint32_t bar_p = bar_s + 8;
  // resident: chunk q of tile buffer b has landed (tile j: buffer j & 1,
  // phase parity (j >> 1) & 1)
  auto full = [&](int b, int q) {
    return bar_s + 16 + (b * kWSlice + q) * 8;
  };
  // every consumer warp is done with tile buffer b (and with P)
  auto empty = [&](int b) { return bar_s + 16 + (2 * kWSlice + b) * 8; };

  cgrp::cluster_group cluster = cgrp::this_cluster();
  uint32_t nctas;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(nctas));
  const int C = (int)nctas;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, through a shuffle so the compiler sees it uniform
  // (wgmma in a branch it cannot prove uniform is serialized)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int n_x = kDW ? vocab : n, n_y = kDW ? n : vocab;
  const int r0 = (blockIdx.x / C) * kWRows;
  const int kc = E / kChunk;
  const int per = (kc + C - 1) / C;
  // this CTA sums s over chunks [s0, s0 + ns) and outputs [o0, o0 + no)
  const int s0 = min(kc, rank * per), ns = min(kc, s0 + per) - s0;
  const int o0 = s0 + blockIdx.y * kWSlice;
  const int no = max(0, min(s0 + ns, o0 + kWSlice) - o0);
  const bool resident = gridDim.y == 1;  // else the E-group path
  const int n_tiles = (n_y + kWTile - 1) / kWTile;
  const int band = kWRows / C;  // rows of s a CTA owns: 32, 16 or 8
  const int slot = band * 32;   // float2s a CTA receives from each peer
  auto tile_of = [&](int j, int q) {  // output chunk q's slot, tile j
    return yt + ((j & 1) * kWSlice + q) * kWTileElems;
  };

  if (tid == 0) {
    for (int i = 0; i < 2 + 2 * kWSlice; ++i) mbar_init(bar_s + 8 * i, 1);
    for (int b = 0; b < 2; ++b) mbar_init(empty(b), kWConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA's mbarriers set before any peer signals one

  if (wg == kWConsumers / 128) {
    // ---- the exchange warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWExchangeRegs));
    const int et = tid - kWConsumers, ew = et >> 5;
    // the statistics of 64 tokens from i0, two values a thread
    auto copy_stats = [&](float* dst, int i0) {
#pragma unroll
      for (int v = et; v < 4 * kWTile; v += 128) {
        const int a = v >> 6, i = i0 + (v & 63);
        const float* src = a == 0   ? lse
                           : a == 1 ? glse
                           : a == 2 ? gtgt
                                    : reinterpret_cast<const float*>(labels);
        const bool in = i < n;
        cp_async4(dst + v, src + (in ? i : 0), in);
      }
    };
    // tile j: dw's statistics by cp.async; resident, its output chunks
    // by TMA, each on its own mbarrier (at j = 0 with its X chunk), chunk
    // q by lane 0 of warp q % 4
    auto issue_tile = [&](int j) {
      if (kDW) copy_stats(stats + (j & 1) * 4 * kWTile, j * kWTile);
      cp_async_commit();
      if (!resident || lane != 0) return;
      for (int q = ew; q < no; q += 4) {
        const uint32_t bar = full(j & 1, q);
        mbar_expect(bar, (j == 0 ? 2 : 1) * kWTileBytes);
        if (j == 0)
          tma_load(xs + q * kWTileElems, tmx, (o0 + q) * kChunk, r0, bar);
        tma_load(tile_of(j, q), tmy, (o0 + q) * kChunk, j * kWTile, bar);
      }
    };
    if (!kDW) copy_stats(stats, r0);
    issue_tile(0);
    if (n_tiles > 1) issue_tile(1);
    for (int j = 0; j < n_tiles; ++j) {
      cp_async_wait<0>();  // tile j's statistics (and the next's)
      named_sync(kWExchangeBar, 128);
      if (et == 0) mbar_expect(bar_s, kWRows * kWTile * 4);
      mbar_wait(bar_s, j & 1);  // (A) every partial of this band, tile j
      // (B) s = the C partials summed in rank order, P rounded to bf16
      // into this CTA's rows of the P tile, then those rows (one
      // contiguous, swizzled run) to every peer's P tile
      const float* st = kDW ? stats + (j & 1) * 4 * kWTile : stats;
      const int* lab = reinterpret_cast<const int*>(st) + 3 * kWTile;
      const int y0 = j * kWTile;
      for (int k = et; k < slot; k += 128) {
        float2 v = recv[k];
#pragma unroll
        for (int src = 1; src < kWMaxCluster; ++src)
          if (src < C) {
            const float2 u = recv[src * slot + k];
            v.x += u.x;
            v.y += u.y;
          }
        const int l = k & 31;
        const int row = rank * band + (k >> 8) * 8 + (l >> 2);
        const int col =
            ((k >> 7) & 1) * 32 + ((k >> 5) & 3) * 8 + 2 * (l & 3);
        const float sv[2] = {v.x, v.y};
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // dh: token row, vocab index y0 + col; dw: token col, vocab
          // index r0 + row
          const int tok = kDW ? col + e : row;
          const int vi = kDW ? r0 + row : y0 + col + e;
          p[e] =
              vi < vocab ? st[kWTile + tok] * __expf(sv[e] - st[tok]) : 0.f;
          if (vi == lab[tok]) p[e] += st[2 * kWTile + tok];
        }
        *reinterpret_cast<uint32_t*>(ps + swz<kWTile>(row, col)) =
            pack_bf16(p[0], p[1]);
      }
      fence_proxy_async();  // the rows, for the bulk copies and wgmma
      named_sync(kWExchangeBar, 128);
      if (lane == 0)
        for (int peer = ew; peer < C; peer += 4)
          if (peer != rank) {
            const uint32_t rows = smem_addr(ps + rank * band * kWTile);
            bulk_to_peer(mapa(rows, peer), rows, band * kWTile * 2,
                         mapa(bar_p, peer));
          }
      // this CTA's rows are the arrival of P's phase j, once phase j - 1
      // is over (its last peer rows landed)
      if (et == 0) {
        if (j > 0) mbar_wait(bar_p, (j - 1) & 1);
        mbar_expect(bar_p, (C - 1) * band * kWTile * 2);
      }
      if (j + 2 < n_tiles) {
        mbar_wait(empty(j & 1), (j >> 1) & 1);  // tile j's P Y done
        issue_tile(j + 2);
      }
    }
    cluster.sync();  // no CTA leaves while a copy to or from it may run
  } else {
    // ---- the two consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWConsumerRegs));
    const int w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
    // 64 rows of src (n_rows, E) from row0, chunk c, into a swizzled
    // tile by cp.async (the E-group path); rows past n_rows zero-filled
    auto copy_tile = [&](bf16* dst, const bf16* src, int n_rows, int row0,
                         int c) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = tid + kWConsumers * k, r = i >> 3, col = (i & 7) * 8;
        const bool in = row0 + r < n_rows;
        cp_async16(dst + swz<kChunk>(r, col),
                   src + (size_t)(in ? row0 + r : 0) * E + c * kChunk + col,
                   in);
      }
    };
    // s_r[:, 32 wg..] of Y tile j, chunk by chunk from zero into p0 / p1,
    // added into s in chunk order
    float s[16], p0[16], p1[16];
    auto chunk_s = [&](float(&d)[16], const bf16* xa, const bf16* yb) {
      const uint64_t da = wg_desc(xa, 16, 1024);
      const uint64_t db = wg_desc(yb + wg * 32 * kChunk, 16, 1024);
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k)
        wgmma_n32(d, da + 2 * k, db + 2 * k, k);
      wg_commit();
    };
    auto add_s = [&](float(&d)[16]) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        wg_pin(d[e]);
        s[e] += d[e];
      }
    };
    // resident: chunks [qa, qb) of tile j into s (from zero at qa = 0),
    // two at a time, each pair's products issued together once both
    // chunks have landed
    auto s_chunks = [&](int j, int qa, int qb) {
      if (qa == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] = 0.f;
      }
      const int par = (j >> 1) & 1;
      for (int q = qa; q < qb; q += 2) {
        const bool two = q + 1 < qb;
        mbar_wait(full(j & 1, q), par);
        if (two) mbar_wait(full(j & 1, q + 1), par);
        wg_fence();
        chunk_s(p0, xs + q * kWTileElems, tile_of(j, q));
        if (two) {
          chunk_s(p1, xs + (q + 1) * kWTileElems, tile_of(j, q + 1));
          wg_wait<1>();
        } else {
          wg_wait<0>();
        }
        add_s(p0);
        if (two) {
          wg_wait<0>();
          add_s(p1);
        }
      }
    };
    // E-group path: chunk i = s0 + i of X and Y through a 2-stage ring,
    // Y's chunks of the output slice into tile j's buffer
    auto s_streamed = [&](int j) {
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
      auto ring = [&](int i) { return xs + (i & 1) * 2 * kWTileElems; };
      auto ysrc = [&](int i) {
        const int c = s0 + i;
        return c >= o0 && c < o0 + no ? tile_of(j, c - o0)
                                      : ring(i) + kWTileElems;
      };
      auto issue = [&](int i) {
        copy_tile(ring(i), x, n_x, r0, s0 + i);
        copy_tile(ysrc(i), y, n_y, j * kWTile, s0 + i);
        cp_async_commit();
      };
      named_sync(kWConsumerBar, kWConsumers);  // the ring's last chunk read
      if (ns > 0) issue(0);
      for (int i = 0; i < ns; ++i) {
        cp_async_wait<0>();
        fence_proxy_async();
        named_sync(kWConsumerBar, kWConsumers);  // chunk i landed
        if (i + 1 < ns) issue(i + 1);
        wg_fence();
        chunk_s(p0, ring(i), ysrc(i));
        wg_wait<0>();
        add_s(p0);
      }
    };

    // (A) rows 16 w + g + 8 h of s_r to their band's owner, in fragment
    // order: float2 ((c * 2 + wg) * 4 + i) * 32 + lane of the sender's
    // slot, c the 8-row block within the band
    auto push_partials = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rb = 2 * w + h;
        const int owner = rb / (band / 8), c = rb % (band / 8);
        const uint32_t dst =
            mapa(smem_addr(recv + rank * slot + (c * 2 + wg) * 128 + lane),
                 owner);
        const uint32_t bar = mapa(bar_s, owner);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st_async2(dst + i * 32 * 8, s[4 * i + 2 * h],
                    s[4 * i + 2 * h + 1], bar);
      }
    };

    // out[:, 256 wg..] of the output slice: 128 accumulators a thread
    float acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0.f;
    const bool has_out = 4 * wg < no;
    auto py = [&](int j) {
      if (!has_out) return;
      const uint64_t da = wg_desc(ps, 16, 1024);
      const uint64_t db = wg_desc(tile_of(j, 4 * wg), kWTileBytes, 1024);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kWTile / 16; ++k)
        wgmma_n256_tb(acc, da + 2 * k, db + (16 * 128 >> 4) * k, 1);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int e = 0; e < 128; ++e) wg_pin(acc[e]);
    };

    // resident: the next tile's s in two halves, chunks [0, half) while
    // tile j's partials travel, the rest after tile j's P Y, while tile
    // j + 2's copies land
    const int half = (ns + 1) / 2;
    if (resident)
      s_chunks(0, 0, ns);
    else
      s_streamed(0);
    push_partials();
    for (int j = 0; j < n_tiles; ++j) {
      const bool next = j + 1 < n_tiles;
      if (next) {
        if (resident)
          s_chunks(j + 1, 0, half);
        else
          s_streamed(j + 1);
      }
      mbar_wait(bar_p, j & 1);  // (B) every band of tile j's P
      py(j);
      if (lane == 0) mbar_arrive(empty(j & 1));
      if (next) {
        if (resident) s_chunks(j + 1, half, ns);  // while tile j + 2 lands
        push_partials();
      }
    }
    cluster.sync();  // no CTA leaves while a copy to or from it may run

    if (!has_out) return;
#pragma unroll
    for (int jb = 0; jb < 32; ++jb) {
      const int q = 4 * wg + jb / 8;
      if (q >= no) continue;
      const int col = (o0 + q) * kChunk + (jb % 8) * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * w + g + 8 * h;
        if (row < n_x)
          store2(out + (size_t)row * E + col, acc[4 * jb + 2 * h],
                 acc[4 * jb + 2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kWThreads, 1)
fused_ce_dh_wide_tc_kernel(const __grid_constant__ CUtensorMap tmh,
                           const __grid_constant__ CUtensorMap tmw,
                           const bf16* __restrict__ h,
                           const bf16* __restrict__ w,
                           const int* __restrict__ labels,
                           const float* __restrict__ lse,
                           const float* __restrict__ glse,
                           const float* __restrict__ gtgt,
                           bf16* __restrict__ dh, int n, int vocab, int E) {
  fused_ce_bwd_wide_tc_body<false, bf16>(&tmh, &tmw, h, w, labels, lse, glse,
                                         gtgt, dh, n, vocab, E);
}

// dw in TO (w's dtype) from bf16 w
template <typename TO>
__global__ void __launch_bounds__(kWThreads, 1)
fused_ce_dw_wide_tc_kernel(const __grid_constant__ CUtensorMap tmh,
                           const __grid_constant__ CUtensorMap tmw,
                           const bf16* __restrict__ h,
                           const bf16* __restrict__ w,
                           const int* __restrict__ labels,
                           const float* __restrict__ lse,
                           const float* __restrict__ glse,
                           const float* __restrict__ gtgt,
                           TO* __restrict__ dw, int n, int vocab, int E) {
  fused_ce_bwd_wide_tc_body<true, TO>(&tmw, &tmh, w, h, labels, lse, glse,
                                      gtgt, dw, n, vocab, E);
}

// the launch configuration of a wide kernel: clusters of C CTAs, one per
// 64 rows of the resident operand and E-group
inline cudaLaunchConfig_t wide_config(const WidePlan& pl, int rows,
                                      cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.C * ((rows + kWRows - 1) / kWRows), pl.groups);
  cfg.blockDim = dim3(kWThreads);
  cfg.dynamicSmemBytes = kWSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cuTensorMapEncodeTiled from the driver, by entry point (nothing links
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The (rows, E) bf16 matrix at p as boxes of box_rows x 64 in the
// 128-byte swizzle; rows past `rows` read as zeros.
cudaError_t wide_tensor_map(CUtensorMap* map, const void* p, int rows, int E,
                            int box_rows = 64) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)E, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)E * sizeof(bf16)};
  const cuuint32_t box[2] = {kChunk, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// h (n, E) and w (V, E) bf16; `rows` of the resident operand
template <typename... P, typename... A>
int launch_wide_tc(void (*kernel)(P...), int rows, const void* h,
                   const void* w, int n, int vocab, int E,
                   cudaStream_t stream, A... args) {
  cudaError_t err = allow_smem(kernel, kWSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmh, tmw;
  err = wide_tensor_map(&tmh, h, n, E);
  if (err == cudaSuccess) err = wide_tensor_map(&tmw, w, vocab, E);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wide_config(wide_plan(E), rows, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, tmh, tmw, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_dh_wide_tc(const void* h, const void* w, const void* labels,
                      const void* lse, const void* glse, const void* gtgt,
                      void* dh, int n, int vocab, int E,
                      cudaStream_t stream) {
  return launch_wide_tc(
      fused_ce_dh_wide_tc_kernel, n, h, w, n, vocab, E, stream,
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(glse), static_cast<const float*>(gtgt),
      static_cast<bf16*>(dh), n, vocab, E);
}

template <typename TO>
int launch_dw_wide_tc(const void* h, const void* w, const void* labels,
                      const void* lse, const void* glse, const void* gtgt,
                      void* dw, int n, int vocab, int E,
                      cudaStream_t stream) {
  return launch_wide_tc(
      fused_ce_dw_wide_tc_kernel<TO>, vocab, h, w, n, vocab, E, stream,
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(glse), static_cast<const float*>(gtgt),
      static_cast<TO*>(dw), n, vocab, E);
}

// ---- the wide lane's forward (#5, E > kMaxE) on the tensor cores ----------
//
// fused_ce_fwd_wide_tc_kernel replaces fused_ce_pallas.py:53 _fwd_kernel
// (called at :187 through _fused_fwd_impl :170) past kMaxE, for bf16 h and
// w (an fp32 w is cast once by the wrapper): per token, lse = logsumexp
// over v of s[v], s = h w^T, online over vocab tiles, and tgt = s[label]
// (0 for label -1); columns at or past V are -1e30.
//
// Bound: operations, 2 n V E, 2.171 ms at the Llama training shape (n
// 8192, V 32000, E 4096) on 989 TFLOP/s.
//
// A cluster of C CTAs (1, 2, 4 or 8: fwd_wide_cluster) shares one tile of
// 128 tokens and splits the vocab: CTA r walks the 128-column vocab tiles
// r, r + C, r + 2C, ..., so C ceil(n / 128) CTAs run: one CTA a token
// tile would leave 68 of the 132 SMs idle at n = 8192.
//   - Warp specialization: one producer thread (warpgroup 2, setmaxnreg
//     40) issues every copy; two consumer warpgroups (232 registers) own
//     64 tokens each and run s[64 x 128] on wgmma m64n128k16 from shared
//     memory, A = h and B = w, both K-major in the 128-byte swizzle
//     (1024-byte aligned tiles). The role is chosen on the warpgroup
//     index taken through a shuffle, as in the wide dh / dw body.
//   - Copies by TMA through a ring of kWfStages stages, each one 64-column
//     k-chunk of the 128 tokens and of the CTA's vocab tile (16 + 16 KB),
//     with a full and an empty mbarrier a stage. The C CTAs read the same
//     h chunk at every step, so CTA r copies rows [r 128 / C, (r + 1) 128
//     / C) of it and multicasts them to every CTA of the cluster: h's L2
//     reads fall by C. A stage is free once the 8 consumer warps of every
//     CTA of the cluster have released it (8 C arrivals on each CTA's
//     empty mbarrier, each with a CTA-scope release: a cluster-scope one
//     made every step cost about a microsecond, and the kernel twice as
//     slow). Rows past n and V read as zeros; nothing is padded in device
//     memory.
//   - Each 64-column k-chunk's four products are summed from zero into p
//     and then added into the fp32 s in chunk order (the tensor cores'
//     own fp32 sum over E / 16 steps drifts with E: at E = 5120 it stood
//     0.95 of FUSED_TOL_LSE from the plain version's). s and p take 64 +
//     64 registers a thread; a 256-column tile would need 256.
//   - After a tile's last chunk: columns past V to -1e30, the target
//     logit, the row max by quad shuffles and the rescaled sum (__expf),
//     each thread keeping a partial l over its own columns. One
//     warpgroup's update runs beside the other's products.
//   - The combine, nothing atomic: each CTA writes its rows' (m, l, tgt)
//     to shared memory; after a cluster barrier CTA r reads rows [r 128 /
//     C, (r + 1) 128 / C) of every CTA through distributed shared memory
//     and sums them in rank order: m = max m_r, l = sum l_r e^(m_r - m),
//     tgt = sum tgt_r, lse = m + log l. Reruns are bit-equal.
//   - Every CTA of a cluster walks ceil(vocab tiles / C) tiles, so the
//     multicast stays in step; a CTA whose last tile is past V takes its
//     h chunks and releases them, and its products (of a w buffer no copy
//     refilled) are not used.
//   - L2 reckoning: w is read once a token tile and h once per C vocab
//     tiles, n V E 2 (1 / 128 + 1 / (128 C)) bytes: 25.2 GB at the Llama
//     shape with C = 2 (33.6 GB if each CTA read its own h). The copies
//     bound it: without its products the kernel takes 0.85 of its time
//     (port_probe.py fwd-variants).
//   - Shared memory: the ring 192 KB, the states 1.5 KB, 12 mbarriers:
//     one CTA of 384 threads an SM. One launch a call (cudaLaunchKernelEx
//     with a cluster dimension); hetu_fused_ce_fwd_wide_info reports the
//     plan.
constexpr int kWfTokens = 128;  // tokens a cluster: two 64-row warpgroups
constexpr int kWfVocab = 128;   // vocab columns a tile
constexpr int kWfStages = 6;
constexpr int kWfHBytes = kWfTokens * kChunk * 2;  // an h k-chunk, 16 KB
constexpr int kWfWBytes = kWfVocab * kChunk * 2;   // a w k-chunk, 16 KB
constexpr int kWfStageBytes = kWfHBytes + kWfWBytes;
// shared memory, bytes from a 1024-byte aligned base
constexpr int kWfOffStats = kWfStages * kWfStageBytes;      // m, l, tgt
constexpr int kWfOffBar = kWfOffStats + 3 * kWfTokens * 4;  // mbarriers
constexpr size_t kWfSmem = kWfOffBar + 2 * kWfStages * 8 + 1024;  // + align
// two consumer warpgroups and the producer's, whose registers setmaxnreg
// moves to the consumers (232 x 256 + 40 x 128 = the 168 x 384 of the
// launch)
constexpr int kWfThreads = 384;
constexpr int kWfConsumerRegs = 232;
constexpr int kWfProducerRegs = 40;

// a box of a 2-D tensor map, as tma_load, written at the same offset into
// the shared memory of every CTA of the cluster in `mask` and counted on
// each one's mbarrier at `bar`'s offset
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   int c0, int r0,
                                                   uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(bar),
      "h"(mask)
      : "memory");
}
// one arrival on the mbarrier at `bar`'s offset in CTA `rank` of the
// cluster, with the default (CTA-scope) release: what it releases is
// shared memory that this warp's wgmma has finished reading. (With
// .release.cluster each arrival cost about a microsecond, and a step of
// the ring took that long.)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   mapa(bar, rank))
               : "memory");
}

// d (64 x 128 fp32) = or += A (64 x 16, K-major) B (16 x 128, K-major),
// the fragment layout of wgmma_n32 over 16 column blocks of 8
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__global__ void __launch_bounds__(kWfThreads, 1)
fused_ce_fwd_wide_tc_kernel(const __grid_constant__ CUtensorMap tmh,
                            const __grid_constant__ CUtensorMap tmw,
                            const int* __restrict__ labels,
                            float* __restrict__ lse, float* __restrict__ tgt,
                            int n, int vocab, int E) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  unsigned char* smem =
      fwd_smem + ((1024 - (smem_addr(fwd_smem) & 1023)) & 1023);
  // (m, l, tgt) of the 128 rows over this CTA's columns, for the combine
  float* stats = reinterpret_cast<float*>(smem + kWfOffStats);
  const uint32_t bar0 = smem_addr(smem + kWfOffBar);
  // stage s has landed / is free in every CTA of the cluster
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kWfStages + s); };

  cgrp::cluster_group cluster = cgrp::this_cluster();
  uint32_t nctas;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(nctas));
  const int C = (int)nctas;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  // the warpgroup, through a shuffle so the compiler sees it uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int r0 = (blockIdx.x / C) * kWfTokens;
  const int kc = E / kChunk;
  const int n_tiles = (vocab + kWfVocab - 1) / kWfVocab;
  const int tiles = (n_tiles + C - 1) / C;  // vocab tiles every CTA walks

  if (tid == 0) {
    for (int s = 0; s < kWfStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA's mbarriers set before any peer signals one

  if (wg == 2) {
    // ---- the producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kWfProducerRegs));
    if (tid == 2 * 128) {
      const int hb = kWfTokens / C;  // h rows this CTA copies for all
      const uint16_t mask = (uint16_t)((1u << C) - 1);
      int st = 0, ph = 0;
      for (int i = 0; i < tiles; ++i) {
        const int vt = rank + C * i;
        for (int q = 0; q < kc; ++q) {
          // the stage's previous round released by the whole cluster
          if (i * kc + q >= kWfStages) mbar_wait(empty(st), ph ^ 1);
          unsigned char* hs = smem + st * kWfStageBytes;
          mbar_expect(full(st), kWfHBytes + (vt < n_tiles ? kWfWBytes : 0));
          if (C == 1)
            tma_load(hs, &tmh, q * kChunk, r0, full(st));
          else
            tma_load_multicast(hs + rank * hb * kChunk * 2, &tmh, q * kChunk,
                               r0 + rank * hb, full(st), mask);
          if (vt < n_tiles)
            tma_load(hs + kWfHBytes, &tmw, q * kChunk, vt * kWfVocab,
                     full(st));
          if (++st == kWfStages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    cluster.sync();  // the states written
    cluster.sync();  // and read
  } else {
    // ---- the two consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kWfConsumerRegs));
    const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
    // rows 64 wg + 16 w + g + 8 h of the token tile: their labels and
    // online state over this thread's columns (m is the quad's)
    int lab[2];
    float m[2], l[2], tp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 64 * wg + 16 * w + g + 8 * h;
      lab[h] = row < n ? labels[row] : -1;
      m[h] = -CUDART_INF_F;
      l[h] = tp[h] = 0.f;
    }
    // s[4 j + e]: row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
    float s[64], p[64];
    int st = 0, ph = 0;
    for (int i = 0; i < tiles; ++i) {
#pragma unroll
      for (int e = 0; e < 64; ++e) s[e] = 0.f;
      for (int q = 0; q < kc; ++q) {
        mbar_wait(full(st), ph);
        const unsigned char* hs = smem + st * kWfStageBytes;
        const uint64_t da = wg_desc(hs + wg * 64 * kChunk * 2, 16, 1024);
        const uint64_t db = wg_desc(hs + kWfHBytes, 16, 1024);
        wg_fence();
#pragma unroll
        for (int k = 0; k < kChunk / 16; ++k)
          wgmma_n128(p, da + 2 * k, db + 2 * k, k);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          wg_pin(p[e]);
          s[e] += p[e];
        }
        // this warp is done with the stage: one arrival in every CTA
        __syncwarp();
        if (lane < C) mbar_arrive_remote(empty(st), lane);
        if (++st == kWfStages) {
          st = 0;
          ph ^= 1;
        }
      }
      const int vt = rank + C * i;
      if (vt < n_tiles) {
        const int v0 = vt * kWfVocab;
        if (v0 + kWfVocab > vocab) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (v0 + 8 * j + 2 * t + (e & 1) >= vocab)
                s[4 * j + e] = kNegInf;
        }
        const int rel[2] = {lab[0] - v0 - 2 * t, lab[1] - v0 - 2 * t};
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (8 * j + (e & 1) == rel[e >> 1]) tp[e >> 1] += s[4 * j + e];
            mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
        float x[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e >> 1] += __expf(s[4 * j + e] - mx[e >> 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] = l[h] * __expf(m[h] - mx[h]) + x[h];
          m[h] = mx[h];
        }
      }
    }
    // each row's state over this CTA's columns, one thread of the quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h], tt = tp[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      tt += __shfl_xor_sync(0xffffffffu, tt, 1);
      tt += __shfl_xor_sync(0xffffffffu, tt, 2);
      const int row = 64 * wg + 16 * w + g + 8 * h;
      if (t == 0) {
        stats[row] = m[h];
        stats[kWfTokens + row] = lt;
        stats[2 * kWfTokens + row] = tt;
      }
    }
    cluster.sync();  // every CTA's states written (every copy landed)
    // rows [rank rows, (rank + 1) rows) from every CTA, in rank order
    const int rows = kWfTokens / C;
    if (tid < rows && r0 + rank * rows + tid < n) {
      const int row = rank * rows + tid;
      float mm = -CUDART_INF_F;
      for (int src = 0; src < C; ++src)
        mm = fmaxf(mm, cluster.map_shared_rank(stats, src)[row]);
      float lt = 0.f, tt = 0.f;
      for (int src = 0; src < C; ++src) {
        const float* ps = cluster.map_shared_rank(stats, src);
        lt += ps[kWfTokens + row] * __expf(ps[row] - mm);
        tt += ps[2 * kWfTokens + row];
      }
      lse[r0 + row] = mm + logf(lt);
      tgt[r0 + row] = tt;
    }
    cluster.sync();  // no CTA leaves while a peer reads its states
  }
}

// the launch configuration of the wide forward: `ctas` CTAs in clusters
// of C
inline cudaLaunchConfig_t fwd_wide_config(int C, int ctas,
                                          cudaStream_t stream,
                                          cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kWfThreads);
  cfg.dynamicSmemBytes = kWfSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// slots[i]: the CTAs of clusters of 1 << i that the current card holds at
// once (cudaOccupancyMaxActiveClusters x the cluster size), asked once a
// device
cudaError_t fwd_wide_slots(int (&slots)[4]) {
  constexpr int kDevices = 64;
  static int cache[kDevices][4];
  static bool known[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kDevices && known[dev];
  if (!cached) {
    err = allow_smem(fused_ce_fwd_wide_tc_kernel, kWfSmem);
    for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg =
          fwd_wide_config(1 << i, 1 << i, nullptr, attr);
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(
          &clusters, reinterpret_cast<const void*>(fused_ce_fwd_wide_tc_kernel),
          &cfg);
      slots[i] = clusters << i;
    }
    if (err != cudaSuccess) return err;
    if (dev < kDevices) {
      for (int i = 0; i < 4; ++i) cache[dev][i] = slots[i];
      known[dev] = true;
    }
  } else {
    for (int i = 0; i < 4; ++i) slots[i] = cache[dev][i];
  }
  return cudaSuccess;
}

// The forward's cluster size at (n, vocab): of C = 1, 2, 4 and 8, the one
// with the fewest tile-steps, ceil(C ceil(n / 128) / slots_C) waves of
// ceil(vocab tiles / C) tiles each; a tie goes to the smaller C (less h
// traffic, a shorter combine). 0 if no cluster size fits the card.
// ops/fused_ce.py wide_fwd_plan is the same rule.
int fwd_wide_cluster(int n, int vocab, const int (&slots)[4]) {
  const long long tiles = (n + kWfTokens - 1) / kWfTokens;
  const long long vtiles = (vocab + kWfVocab - 1) / kWfVocab;
  int best = 0;
  long long best_steps = 0;
  for (int i = 0; i < 4; ++i) {
    if (slots[i] <= 0) continue;
    const long long C = 1 << i;
    const long long steps =
        (C * tiles + slots[i] - 1) / slots[i] * ((vtiles + C - 1) / C);
    if (best == 0 || steps < best_steps) {
      best = (int)C;
      best_steps = steps;
    }
  }
  return best;
}

int launch_fwd_wide_tc(const void* h, const void* w, const void* labels,
                       void* lse, void* tgt, int n, int vocab, int E,
                       cudaStream_t stream) {
  int slots[4];
  cudaError_t err = fwd_wide_slots(slots);
  if (err != cudaSuccess) return (int)err;
  const int C = fwd_wide_cluster(n, vocab, slots);
  if (C == 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tmh, tmw;
  err = wide_tensor_map(&tmh, h, n, E, kWfTokens / C);
  if (err == cudaSuccess)
    err = wide_tensor_map(&tmw, w, vocab, E, kWfVocab);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fwd_wide_config(
      C, C * ((n + kWfTokens - 1) / kWfTokens), stream, attr);
  err = cudaLaunchKernelEx(&cfg, fused_ce_fwd_wide_tc_kernel, tmh, tmw,
                           static_cast<const int*>(labels),
                           static_cast<float*>(lse), static_cast<float*>(tgt),
                           n, vocab, E);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The wide tensor-core forward's plan at (n, vocab): info[0] the cluster
// size C (fwd_wide_cluster), info[1..4] the CTAs of clusters of 1, 2, 4
// and 8 that the card holds at once, info[5] the CTAs launched, C ceil(n
// / 128).
extern "C" int hetu_fused_ce_fwd_wide_info(int n, int vocab, int* info) {
  if (n <= 0 || vocab <= 0) return (int)cudaErrorInvalidValue;
  int slots[4];
  const cudaError_t err = fwd_wide_slots(slots);
  if (err != cudaSuccess) return (int)err;
  info[0] = fwd_wide_cluster(n, vocab, slots);
  for (int i = 0; i < 4; ++i) info[1 + i] = slots[i];
  info[5] = info[0] * ((n + kWfTokens - 1) / kWfTokens);
  return 0;
}

// The wide tensor-core dh / dw plan at width E (a multiple of 64 past
// kMaxE): info[0] the cluster size, info[1] the E chunks of s a CTA sums,
// info[2] the E-groups (how many times s is computed), info[3]
// cudaOccupancyMaxActiveClusters of dW's kernel (dw != 0) or dH's.
extern "C" int hetu_fused_ce_wide_info(int E, int dw, int* info) {
  if (E % 64 || E <= kMaxE) return (int)cudaErrorInvalidValue;
  const WidePlan pl = wide_plan(E);
  info[0] = pl.C;
  info[1] = pl.per;
  info[2] = pl.groups;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wide_config(pl, kWRows, nullptr, attr);
  const void* kernel =
      dw ? reinterpret_cast<const void*>(fused_ce_dw_wide_tc_kernel<bf16>)
         : reinterpret_cast<const void*>(fused_ce_dh_wide_tc_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&info[3], kernel, &cfg);
  return (int)err;
}

// h (n, E) and w (V, E), contiguous, each fp32 (flag 0) or bf16 (flag 1);
// labels (n,) int32 in [-1, V); lse/tgt/glse/gtgt (n,) fp32. Each launches
// on `stream` and returns cudaGetLastError() (or the error of raising the
// kernel's shared-memory limit).
//
// Each picks its lane as ops/fused_ce.py fused_ce_lane does: bf16 h takes
// the tensor-core kernels, fp32 h the CUDA-core ones; E up to kMaxE the
// lanes above, E past it the wide lanes. Each refuses
// (cudaErrorInvalidValue, nothing launched) what no kernel of it takes: E
// not a whole number of 64-column chunks, on either lane; with bf16 h an
// fp32 w, except for the narrow dw (the wrapper casts it once); and for dw
// a dtype (dw_bf16) other than w's, except on the wide tensor-core lane,
// which reads the cast w and writes dw in the dtype of the w it was cast
// from.
extern "C" int hetu_fused_ce_fwd(const void* h, const void* w,
                                 const void* labels, void* lse, void* tgt,
                                 int n, int vocab, int E, int h_bf16,
                                 int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E % 64 || E < 64) return (int)cudaErrorInvalidValue;
  if (h_bf16) {
    if (!w_bf16) return (int)cudaErrorInvalidValue;
    if (E > kMaxE)
      return launch_fwd_wide_tc(h, w, labels, lse, tgt, n, vocab, E, s);
    return launch_fwd_tc(h, w, labels, lse, tgt, n, vocab, E, s);
  }
  if (E > kMaxE) {
    if (w_bf16)
      return launch_fwd_wide<float, bf16>(h, w, labels, lse, tgt, n, vocab,
                                          E, s);
    return launch_fwd_wide<float, float>(h, w, labels, lse, tgt, n, vocab, E,
                                         s);
  }
  if (w_bf16)
    return launch_fwd<float, bf16>(h, w, labels, lse, tgt, n, vocab, E, s);
  return launch_fwd<float, float>(h, w, labels, lse, tgt, n, vocab, E, s);
}

// dh (n, E) in h's dtype.
extern "C" int hetu_fused_ce_dh(const void* h, const void* w,
                                const void* labels, const void* lse,
                                const void* glse, const void* gtgt, void* dh,
                                int n, int vocab, int E, int h_bf16,
                                int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E % 64 || E < 64) return (int)cudaErrorInvalidValue;
  if (h_bf16) {
    if (!w_bf16) return (int)cudaErrorInvalidValue;
    if (E > kMaxE)
      return launch_dh_wide_tc(h, w, labels, lse, glse, gtgt, dh, n, vocab, E,
                               s);
    return launch_dh_tc(h, w, labels, lse, glse, gtgt, dh, n, vocab, E, s);
  }
  if (E > kMaxE) {
    if (w_bf16)
      return launch_bwd_wide<float, bf16, false>(h, w, labels, lse, glse,
                                                 gtgt, dh, n, vocab, E, s);
    return launch_bwd_wide<float, float, false>(h, w, labels, lse, glse, gtgt,
                                                dh, n, vocab, E, s);
  }
  if (w_bf16)
    return launch_bwd<float, bf16, false>(h, w, labels, lse, glse, gtgt, dh,
                                          n, vocab, E, s);
  return launch_bwd<float, float, false>(h, w, labels, lse, glse, gtgt, dh, n,
                                         vocab, E, s);
}

// dw (V, E) in dw_bf16's dtype, the dtype of the caller's w.
extern "C" int hetu_fused_ce_dw(const void* h, const void* w,
                                const void* labels, const void* lse,
                                const void* glse, const void* gtgt, void* dw,
                                int n, int vocab, int E, int h_bf16,
                                int w_bf16, int dw_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E % 64 || E < 64) return (int)cudaErrorInvalidValue;
  if (h_bf16 && E > kMaxE) {
    if (!w_bf16) return (int)cudaErrorInvalidValue;
    if (dw_bf16)
      return launch_dw_wide_tc<bf16>(h, w, labels, lse, glse, gtgt, dw, n,
                                     vocab, E, s);
    return launch_dw_wide_tc<float>(h, w, labels, lse, glse, gtgt, dw, n,
                                    vocab, E, s);
  }
  if (dw_bf16 != w_bf16) return (int)cudaErrorInvalidValue;
  if (h_bf16) {
    if (w_bf16)
      return launch_dw_tc<bf16>(h, w, labels, lse, glse, gtgt, dw, n, vocab,
                                E, s);
    return launch_dw_tc<float>(h, w, labels, lse, glse, gtgt, dw, n, vocab, E,
                               s);
  }
  if (E > kMaxE) {
    if (w_bf16)
      return launch_bwd_wide<float, bf16, true>(h, w, labels, lse, glse, gtgt,
                                                dw, n, vocab, E, s);
    return launch_bwd_wide<float, float, true>(h, w, labels, lse, glse, gtgt,
                                               dw, n, vocab, E, s);
  }
  if (w_bf16)
    return launch_bwd<float, bf16, true>(h, w, labels, lse, glse, gtgt, dw, n,
                                         vocab, E, s);
  return launch_bwd<float, float, true>(h, w, labels, lse, glse, gtgt, dw, n,
                                        vocab, E, s);
}
