// Paged decode attention through per-slot block tables, for sm_90a (H100).
//
// Replaces hetu_tpu/ops/paged_pallas.py:86 _paged_kernel (host wrapper
// paged_attention_pallas :167). The KV arena is (n_blocks, block_size,
// hkv, d); slot s keeps position p at arena page block_tables[s, p / bs],
// row p % bs. q is (S, R, hq, d): row i of slot s attends the positions
// <= q_offset[s] + i of its own KV (R = 1 for decode, C one-row slots for
// the packed prefill's arena history). Returns out (S, R, hq, d) in q's
// dtype and, on request, the fp32 lse (S, hq, R). A row whose offset is
// negative (an empty history: the packed prefill passes hist - 1 = -1)
// attends nothing and gives out = 0, lse = -1e30, so the LSE-combine gives
// it weight 0. Table lanes padded with the null block lie past every live
// position and stay masked.
//
// Arena lanes: fp32 or bf16 like q (hetu_paged_attention), or int8 codes
// with an fp32 scale per (arena row, kv head) in separate (n_blocks, bs,
// hkv, 1) arrays (hetu_paged_attention_int8, the TPU kernel's quant lane,
// :99-103 and :123-127). The int8 lane dequantizes each element as it is
// staged, float(code) * scale in fp32, exactly as the TPU kernel
// dequantizes its tile; everything after staging is the same fp32 code
// for every lane but one rounding point: the bf16 arena lane rounds p to
// bf16 before p v (:148 casts p to v's dtype), while the fp32 and int8
// lanes keep it fp32 (the int8 lane's v is fp32, as in the TPU kernel).
// A row never written has scale 0 and dequantizes to 0.
//
// What bounds it on an H100: bytes from HBM. A (slot, kv head) reads its
// live K and V rows once -- 2 * context * d * itemsize bytes, plus 8 bytes
// of scales per row in the int8 lane -- and does 4 * (R * g) * context * d
// flops on them; for decode (R * g = 1) that is at most 2 flops per int8
// byte, far below the ~20 where the fp32 CUDA cores would become the
// limit. The int8 lane reads a quarter of the fp32 lane's bytes.
//
// Design in response: one block per (slot, kv head, 16-row chunk), so a
// K/V tile loaded once from HBM serves every q head of the GQA group and
// every row of the slot. Row r of a block is row r / g of q head
// h * g + r % g. The TPU kernel's sequential grid axis over table lanes
// becomes a loop inside the block, carrying the online-softmax state in
// registers; the block reads its own table entries as it goes. The loop
// stops at the block's last live position, min(W * bs, q_offset[s] +
// last row + 1) keys -- the dead-lane skip: cost follows the live context,
// not the table width -- and a row skips the tiles past its own position.
// Keys are staged 32 at a time in shared memory (fp32, whatever the arena
// type), whatever the page size.

#include "attention_common.cuh"

namespace {

using namespace hetu;

// One arena element as fp32: fp lanes convert, the int8 lane multiplies
// the code by its row's scale (index si = arena row * hkv + kv head).
__device__ __forceinline__ float load_kv(const float* p, const float*,
                                         size_t i, size_t) {
  return p[i];
}
__device__ __forceinline__ float load_kv(const __nv_bfloat16* p,
                                         const float*, size_t i, size_t) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_kv(const int8_t* p,
                                         const float* __restrict__ scale,
                                         size_t i, size_t si) {
  return (float)p[i] * scale[si];
}

// T: q and out; KV: the arena (T itself, or int8 with k_scale/v_scale)
template <typename T, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ q_offset, T* __restrict__ out,
                       float* __restrict__ lse, int R, int hq, int hkv, int d,
                       int bs, int W, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;
  float* ks = qs + kRows * ld;
  float* vs = ks + kTile * ld;

  const int s = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * kRows;
  const int g = hq / hkv, rows = R * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int off = q_offset[s];
  const int* table = tables + (size_t)s * W;

  for (int e = threadIdx.x; e < kRows * d; e += blockDim.x) {
    const int r = e / d, c = e - r * d, rr = r0 + r;
    float x = 0.f;
    if (rr < rows) {
      const int i = rr / g, head = h * g + rr % g;
      x = round_as(to_float(q[(((size_t)s * R + i) * hq + head) * d + c]) * scale, q);
    }
    qs[r * ld + c] = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxCols; ++t) acc[i][t] = 0.f;
  }

  const int last_row = min(rows, r0 + kRows) - 1;
  const int n_keys = min(W * bs, off + last_row / g + 1);  // dead-lane skip
  const size_t key_stride = (size_t)hkv * d;

  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    __syncthreads();  // q staged / previous tile consumed
    for (int e = threadIdx.x; e < kTile * d; e += blockDim.x) {
      const int j = e / d, c = e - j * d, kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < n_keys) {
        const size_t row = (size_t)table[kp / bs] * bs + kp % bs;
        const size_t src = row * key_stride + (size_t)h * d + c;
        const size_t si = row * hkv + h;
        kx = load_kv(k, k_scale, src, si);
        vx = load_kv(v, v_scale, src, si);
      }
      ks[j * ld + c] = kx;
      vs[j * ld + c] = vx;
    }
    __syncthreads();
    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i, rr = r0 + r;
      if (rr >= rows) continue;  // warp-uniform
      const int qpos = off + rr / g;
      if (k0 > qpos) continue;   // this row's dead lanes
      const bool live = kp < n_keys && kp <= qpos;
      online_softmax_tile<kIsBf16<KV>>(qs + r * ld, ks, vs, ld, d, live, m[i],
                                       l[i], acc[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rr = r0 + warp * kRowsPerWarp + i;
    if (rr >= rows) continue;
    const int row = rr / g, head = h * g + rr % g;
    finish_row(out + (((size_t)s * R + row) * hq + head) * d,
               lse == nullptr ? nullptr : lse + ((size_t)s * hq + head) * R + row,
               d, m[i], l[i], acc[i]);
  }
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tables, const void* q_offset,
           void* out, void* lse, int S, int R, int hq, int hkv, int d, int bs,
           int W, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = allow_smem(paged_attention_kernel<T, KV>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = R * (hq / hkv);
  const dim3 grid(S, hkv, (rows + kRows - 1) / kRows);
  paged_attention_kernel<T, KV><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(q_offset), static_cast<T*>(out),
      static_cast<float*>(lse), R, hq, hkv, d, bs, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (S, R, hq, d); k/v arena (n_blocks, bs, hkv, d); all contiguous, fp32
// (bf16 == 0) or bf16 (bf16 == 1); tables (S, W) int32; q_offset (S,)
// int32; out like q; lse (S, hq, R) fp32 or null. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int hetu_paged_attention(const void* q, const void* k,
                                    const void* v, const void* tables,
                                    const void* q_offset, void* out,
                                    void* lse, int S, int R, int hq, int hkv,
                                    int d, int bs, int W, float scale,
                                    int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, tables, q_offset, out, lse, S, R, hq, hkv,
        d, bs, W, scale, s);
  return launch<float, float>(q, k, v, nullptr, nullptr, tables, q_offset,
                              out, lse, S, R, hq, hkv, d, bs, W, scale, s);
}

// The int8 lane: k/v int8 codes (n_blocks, bs, hkv, d), k_scale/v_scale
// fp32 (n_blocks, bs, hkv, 1); q/out fp32 (bf16 == 0) or bf16 (bf16 ==
// 1); the rest as hetu_paged_attention.
extern "C" int hetu_paged_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* q_offset, void* out,
    void* lse, int S, int R, int hq, int hkv, int d, int bs, int W,
    float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, int8_t>(q, k, v, k_scale, v_scale, tables,
                                         q_offset, out, lse, S, R, hq, hkv, d,
                                         bs, W, scale, s);
  return launch<float, int8_t>(q, k, v, k_scale, v_scale, tables, q_offset,
                               out, lse, S, R, hq, hkv, d, bs, W, scale, s);
}
