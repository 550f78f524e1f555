// Fused LM-head cross-entropy, for sm_90a (H100): three kernels.
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
// hundreds of flops per byte, far above the card's 295.
//
// Design in response, simple and right first:
//   - bf16 operands go through the tensor cores with mma.sync m16n8k16
//     (fp32 accumulators), fragments loaded from shared memory by hand
//     and each kept in registers across the products that share it;
//     fp32 operands take the same fragment layout on the CUDA cores (no
//     TF32), so both types share every index computation.
//   - No state crosses a grid axis and nothing is atomic, so every sum is
//     deterministic. fwd and dh: one block per token tile, looping over
//     every vocab tile. dw: one block per vocab tile, looping over every
//     token tile. The block keeps its own (rows x E) operand resident in
//     shared memory and stages the streamed (kT x E) tile whole, one load
//     per tile, so the copy is latency-bound once per tile rather than
//     once per k step.
//   - The (32 x E) fp32 dh/dw accumulator lives in registers: 8 warps,
//     each owning every 8th group of 8 columns (E / 64 groups, 96 floats a
//     thread at E = 768). E is therefore a multiple of 64 and at most 768,
//     which also keeps both operand tiles inside the 227 KB of shared
//     memory. Splitting E across blocks would lift that limit at the cost
//     of recomputing s once per E chunk; it is not needed for GPT-2 small.
// No copy pipeline, TMA or wgmma yet: later work.

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

// per element type: streamed rows per tile, fwd tokens per block, and a
// row pad of 16 bytes, which puts consecutive rows 4 banks apart (the
// fragment loads below are then free of bank conflicts)
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int kT = 64, kFwdRows = 64, kPad = 8;
};
template <> struct Cfg<float> {
  static constexpr int kT = 32, kFwdRows = 32, kPad = 4;
};

__device__ __forceinline__ float cvt(float x, const float*) { return x; }
__device__ __forceinline__ bf16 cvt(float x, const bf16*) {
  return __float2bfloat16(x);
}

// Copy rows [r0, r0 + rows) of a (n, E) matrix into shared memory (row
// stride ld), cast to T; rows at or past n are zero-filled.
template <typename T, typename S>
__device__ __forceinline__ void stage(T* dst, int ld, const S* src, int n,
                                      int E, int r0, int rows) {
  if constexpr (std::is_same<T, S>::value) {
    constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
    const int vpr = E / V;
    for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
      const int r = i / vpr, c = (i - r * vpr) * V;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < n)
        x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * E + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, c = i - r * E;
      const float x = r0 + r < n ? to_float(src[(size_t)(r0 + r) * E + c]) : 0.f;
      dst[r * ld + c] = cvt(x, dst);
    }
  }
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
#pragma unroll
    for (int q = 0; q < kPairs; ++q) s[q][0] = s[q][1] = s[q][2] = s[q][3] = 0.f;
#pragma unroll 4
    for (int k = 0; k < E; k += 16) {
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
// X (kBwdRows x E) is the block's resident operand, Y (kT x E) the streamed
// one; per Y tile: s = X Y^T, P (rounded to T) into shared memory, then
// acc (kBwdRows x E) += P Y. dh: X = h (tokens), Y = w (vocab), the token
// statistics are per row of P. dw: X = w, Y = h, P is the dlogits tile
// transposed and the statistics are per column.

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
  const size_t smem = bwd_smem<T>(E);
  const int blocks = ((kDW ? vocab : n) + kBwdRows - 1) / kBwdRows;
  const T* hp = static_cast<const T*>(h);
  const TW* wp = static_cast<const TW*>(w);
  const int* lp = static_cast<const int*>(labels);
  const float *a = static_cast<const float*>(lse),
              *b = static_cast<const float*>(glse),
              *c = static_cast<const float*>(gtgt);
  cudaError_t err;
  if (kDW) {
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

}  // namespace

// h (n, E) and w (V, E), contiguous, each fp32 (flag 0) or bf16 (flag 1);
// labels (n,) int32 in [-1, V); lse/tgt/glse/gtgt (n,) fp32. E must be a
// multiple of 64, at most 768 (the wrapper checks). Each launches on
// `stream` and returns cudaGetLastError() (or the error of raising the
// kernel's shared-memory limit).
#define HETU_FUSED_CE_DISPATCH(CALL)                                  \
  if (h_bf16 && w_bf16) return CALL(bf16, bf16);                     \
  if (h_bf16) return CALL(bf16, float);                              \
  if (w_bf16) return CALL(float, bf16);                              \
  return CALL(float, float);

extern "C" int hetu_fused_ce_fwd(const void* h, const void* w,
                                 const void* labels, void* lse, void* tgt,
                                 int n, int vocab, int E, int h_bf16,
                                 int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, TW) launch_fwd<T, TW>(h, w, labels, lse, tgt, n, vocab, E, s)
  HETU_FUSED_CE_DISPATCH(CALL)
#undef CALL
}

// dh (n, E) in h's dtype.
extern "C" int hetu_fused_ce_dh(const void* h, const void* w,
                                const void* labels, const void* lse,
                                const void* glse, const void* gtgt, void* dh,
                                int n, int vocab, int E, int h_bf16,
                                int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, TW) \
  launch_bwd<T, TW, false>(h, w, labels, lse, glse, gtgt, dh, n, vocab, E, s)
  HETU_FUSED_CE_DISPATCH(CALL)
#undef CALL
}

// dw (V, E) in w's dtype.
extern "C" int hetu_fused_ce_dw(const void* h, const void* w,
                                const void* labels, const void* lse,
                                const void* glse, const void* gtgt, void* dw,
                                int n, int vocab, int E, int h_bf16,
                                int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, TW) \
  launch_bwd<T, TW, true>(h, w, labels, lse, glse, gtgt, dw, n, vocab, E, s)
  HETU_FUSED_CE_DISPATCH(CALL)
#undef CALL
}
