// Paged causal attention through block tables, for sm_90a (H100).
//
// Replaces hetu_tpu/ops/paged_pallas.py:86 _paged_kernel (host wrapper
// paged_attention_pallas :167). The KV arena is (n_blocks, block_size,
// hkv, d); a table row keeps position p at arena page table[p / bs], row
// p % bs. q is (S, R, hq, d): row i of q slot s attends the positions
// <= q_offset[s] + i of the KV its table row maps -- its own (row s of the
// (S, W) tables) or, with row_slot, row row_slot[s] of the engine's own
// tables (the packed prefill: one q slot per pack token, every token of a
// request's run naming the request's slot). Returns out (S, R, hq, d) in
// q's dtype and, on request, the fp32 lse (S, hq, R). A row whose offset
// is negative (an empty history: the packed prefill passes hist - 1 = -1)
// attends nothing and gives out = 0, lse = -1e30, so the LSE-combine gives
// it weight 0. Table lanes padded with the null block lie past every live
// position and are never read (the dead-lane skip: cost follows the live
// context, not the table width).
//
// Arena types: fp32 or bf16 like q (hetu_paged_attention), or int8 codes
// with an fp32 scale per (arena row, kv head) in separate (n_blocks, bs,
// hkv, 1) arrays (hetu_paged_attention_int8, the TPU kernel's quant lane,
// :99-103 and :123-127). Rounding points, as the TPU kernel's: q~ = q *
// scale is rounded to q's dtype (:215); the bf16 arena lane rounds p to
// bf16 before p v (:148 casts p to v's dtype); the fp32 and int8 lanes keep
// p and v in fp32 (the int8 lane's v is its codes dequantized in fp32). A
// row never written has scale 0 and dequantizes to 0.
//
// What bounds it on an H100: bytes from HBM. A call must read every
// distinct live K and V row once -- 2 * d * itemsize bytes per (row, kv
// head), plus 8 bytes of scales in the int8 lane -- and q, and write out
// and lse once. Decode (R * g = 1) does 4 flops per (key, column): at
// most 2 per int8 byte of K and V, far below the ~20 where the fp32 CUDA
// cores would become the limit; the
// packed prefill's history is 4 * rows * keys * d flops over few distinct
// rows, where only the tensor cores keep the arithmetic under the bytes.
//
// Two lanes -- split_kv, and tile on the tensor cores or the CUDA cores
// (ops/paged.py LANES: split_kv, tile_tc, tile) -- picked by ops/paged.py
// paged_lane before the launch and passed in as `lane` (the entry points
// take what the rule picked and refuse a lane the shapes do not fit;
// nothing falls back):
//
// split_kv (decode: no row_slot, R * g <= 4 rows per slot, d 64 or 128).
//   One warp per (q slot, q row, split of `split` keys: ops/paged.py
//   SPLIT_KEYS, 128); a block holds
//   the 4 consecutive splits of one q row, and the rows of one kv head's
//   group sit in neighbouring blocks, so their K/V reads meet in L2. A
//   split past its row's last live position exits at once. Each lane
//   loads one 16-byte chunk of a key row (an int8 d-128 row is 8 lanes x
//   16 B, an fp32 d-64 row 16 x 16 B), 8 key rows deep, with the int8
//   lane's two scales beside the codes, so a warp has 8 KB in flight
//   before it computes. q.k is a per-lane dot over the chunk and a
//   shuffle sum over the row's lanes; p.v accumulates per lane and sums
//   over the key groups once, at the end. The split's normalised out and
//   lse go to fp32 scratch (o_part, lse_part, allocated by the wrapper);
//   a second kernel, launched by the same entry point, combines a row's
//   live splits in order -- m = max lse, w = exp(lse - m), out = sum o w /
//   sum w, lse = m + log sum w (ops/paged.py combine_attention_lse's
//   arithmetic): no atomics, the same bits on every run. A call whose
//   table spans one split writes out directly. The bf16 arena lane rounds
//   p relative to its split's running max, updated every step of 8 loads
//   (16 keys at d 128, 32 at d 64), where the TPU kernel rounds relative
//   to the running max over every page so far; the tile lane rounds it
//   relative to its 64-key tiles' running max.
//
// tile (everything else: the packed prefill's history, GQA groups and
//   verify rows with R * g > 4, head dims other than 64/128). Rows are
//   flattened per kv head h -- row r is q slot r / (R g), q row r % (R g)
//   / g, q head h g + r % g -- and a block owns a tile of consecutive
//   rows. Within its tile, each maximal stretch of rows that reads one
//   table row (the rows of one request's run in the packed prefill) reads
//   that table's pages once, up to the stretch's last live position, and
//   applies every staged key tile to every row of the stretch; rows
//   outside the stretch are masked, rows at offset -1 read nothing. So a
//   run's history is read once per row tile, not once per token (148,480
//   key rows per head at the Llama pack against 1,536 distinct).
//   - bf16 q at d 64/128 (paged_tile_tc_kernel): 64 rows per block, one
//     m16n8k16 fragment of 16 rows per warp. q~ is held as mma.sync A
//     fragments; K/V pages stream in 64-key tiles through a 2-stage
//     cp.async ring (16-byte chunks, XOR-swizzled rows, csrc/mma_bf16.cuh).
//     The bf16 arena lane multiplies on the tensor cores as the flash
//     forward does, p rounded to bf16. The int8 lane copies the codes raw
//     and widens them to bf16 in shared memory (exact); q~ . codes runs on
//     the tensor cores (exact products, fp32 sums) and the per-key k scale
//     multiplies the fp32 scores after; p stays fp32: p * v_scale is split
//     into bf16 hi + lo, and hi.codes + lo.codes are two tensor-core
//     products summed in fp32 (2^-16 of p's relative size is lost).
//   - fp32 q, or another d (paged_tile_kernel): 4 rows per block, one per
//     warp, on the CUDA cores; keys are staged 32 at a time in shared
//     memory as fp32 (the int8 lane dequantizes as it stages), and each
//     warp runs attention_common.cuh online_softmax_tile for its row. A
//     small tile keeps enough blocks in flight to hide the staging's
//     latency: on an H100, 16-row tiles gave the GPT-2 pack (64 rows,
//     12 heads, fp32) 48 blocks and took 0.122 ms, 4-row ones 0.061.

#include <type_traits>

#include "attention_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace hetu;
using bf16 = __nv_bfloat16;

// The lanes, numbered as ops/paged.py LANES lists them.
constexpr int kLaneSplitKv = 0;
constexpr int kLaneTileTc = 1;
constexpr int kLaneTile = 2;

constexpr int kSplitWarps = 4;    // a split_kv block: 4 splits of one q row
constexpr int kSplitDepth = 8;    // key rows each lane has in flight
constexpr int kSplitMaxRows = 4;  // R * g of a split_kv call

constexpr int kTileThreads = 128;  // paged_tile_tc_kernel: 4 warps
constexpr int kTileRows = 64;      //   x 16 rows
constexpr int kTileKeys = 64;      // keys per streamed tile

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t word(const uint4& x, int n) {
  return n == 0 ? x.x : n == 1 ? x.y : n == 2 ? x.z : x.w;
}

// Element e of a 16-byte chunk of arena type KV, as fp32 (an int8 code as
// its integer value); e is a constant after unrolling, so the chunk stays
// in registers.
template <typename KV>
__device__ __forceinline__ float chunk_elem(const uint4& x, int e) {
  if constexpr (std::is_same<KV, float>::value) {
    return __uint_as_float(word(x, e));
  } else if constexpr (std::is_same<KV, bf16>::value) {
    const uint32_t w = word(x, e >> 1);
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  } else {
    return (float)(int8_t)(word(x, e >> 2) >> (8 * (e & 3)));
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- split_kv -------------------------------------------------------------

// Grid (ceil(n_split / 4), R * hq, S); warp w of block x takes split 4x + w
// of q row blockIdx.y = i * hq + head of q slot blockIdx.z.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kSplitWarps * 32)
paged_split_kv_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                      const KV* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ tables,
                      const int* __restrict__ q_offset, T* __restrict__ out,
                      float* __restrict__ lse, float* __restrict__ o_part,
                      float* __restrict__ lse_part, int R, int hq, int hkv,
                      int bs, int W, int split, int n_split, float scale) {
  constexpr int E = 16 / sizeof(KV);  // elements of one 16-byte chunk
  constexpr int LK = D / E;           // lanes per key row, one chunk each
  static_assert(LK >= 2 && LK <= 32 && 32 % LK == 0,
                "a key row is 2 to 32 chunks");
  constexpr int KPL = 32 / LK;        // key rows per warp-wide load
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gk = lane / LK, c = lane % LK;
  const int sp = blockIdx.x * kSplitWarps + warp;
  const int s = blockIdx.z, row = blockIdx.y;
  const int i = row / hq, head = row - i * hq, h = head / (hq / hkv);
  const int n_keys = max(0, min(W * bs, q_offset[s] + i + 1));
  const int k_begin = sp * split;
  // a dead split: its row's combine reads only the live ones
  if (sp >= n_split || (n_split > 1 && k_begin >= n_keys)) return;
  const int k_end = min(n_keys, k_begin + split);
  const int* table = tables + (size_t)s * W;
  const size_t rid = (size_t)s * gridDim.y + row;  // (s, i, head)

  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    qv[e] = round_as(to_float(q[rid * D + c * E + e]) * scale, q);

  float m = -CUDART_INF_F, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += KPL * kSplitDepth) {
    uint4 kx[kSplitDepth], vx[kSplitDepth];
    float ksc[kSplitDepth], vsc[kSplitDepth];
#pragma unroll
    for (int u = 0; u < kSplitDepth; ++u) {
      const int kp = k0 + u * KPL + gk;
      kx[u] = vx[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = vsc[u] = 0.f;
      if (kp < k_end) {
        const size_t arow = (size_t)table[kp / bs] * bs + kp % bs;
        const size_t at = (arow * hkv + h) * D + c * E;
        kx[u] = load16(k + at);
        vx[u] = load16(v + at);
        if constexpr (kInt8) {
          ksc[u] = k_scale[arow * hkv + h];
          vsc[u] = v_scale[arow * hkv + h];
        }
      }
    }
    float sc[kSplitDepth];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kSplitDepth; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e)
        part = fmaf(qv[e], chunk_elem<KV>(kx[u], e), part);
#pragma unroll
      for (int o = LK / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if constexpr (kInt8) part *= ksc[u];  // the per-key scale, after
      sc[u] = k0 + u * KPL + gk < k_end ? part : kNegInf;
      mx = fmaxf(mx, sc[u]);
    }
#pragma unroll
    for (int o = LK; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float alpha = expf(m - mx);  // m = -inf at the first step: 0
    m = mx;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kSplitDepth; ++u) {
      float p = k0 + u * KPL + gk < k_end ? expf(sc[u] - m) : 0.f;
      l += p;  // each lane of a key group holds its group's sum
      if constexpr (kIsBf16<KV>) p = round_bf16(p);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float x = chunk_elem<KV>(vx[u], e);
        if constexpr (kInt8) x *= vsc[u];  // dequantized in fp32
        acc[e] = fmaf(p, x, acc[e]);
      }
    }
  }
  // sum over the KPL key groups
#pragma unroll
  for (int o = LK; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (gk != 0) return;
  const float l_safe = l == 0.f ? 1.f : l;
  const float row_lse = l == 0.f ? kNegInf : m + logf(l_safe);
  if (n_split == 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) store(out + rid * D + c * E + e, acc[e] / l_safe);
    if (c == 0 && lse != nullptr)
      lse[((size_t)s * hq + head) * R + i] = row_lse;
  } else {
    float* po = o_part + (rid * n_split + sp) * D + c * E;
#pragma unroll
    for (int e = 0; e < E; ++e) po[e] = acc[e] / l_safe;
    if (c == 0) lse_part[rid * n_split + sp] = row_lse;
  }
}

// One warp per q row: its live splits combined in split order. A row with
// no live key (every split dead) gives exact 0 and lse = -1e30.
template <typename T, int D>
__global__ void __launch_bounds__(kSplitWarps * 32)
paged_split_kv_combine_kernel(const float* __restrict__ o_part,
                              const float* __restrict__ lse_part,
                              const int* __restrict__ q_offset,
                              T* __restrict__ out, float* __restrict__ lse,
                              int R, int hq, int bs, int W, int split,
                              int n_split, int n_rows) {
  const int rid = blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (rid >= n_rows) return;
  const int s = rid / (R * hq), row = rid - s * R * hq;
  const int i = row / hq, head = row - i * hq;
  const int n_keys = max(0, min(W * bs, q_offset[s] + i + 1));
  const int n_live = (n_keys + split - 1) / split;
  const float* lp = lse_part + (size_t)rid * n_split;
  float m = kNegInf;
  for (int j = 0; j < n_live; ++j) m = fmaxf(m, lp[j]);
  float den = 0.f;
  for (int j = 0; j < n_live; ++j) den += expf(lp[j] - m);
  if (den == 0.f) den = 1.f;
  float acc[D / 32];
#pragma unroll
  for (int t = 0; t < D / 32; ++t) acc[t] = 0.f;
  for (int j = 0; j < n_live; ++j) {
    const float w = expf(lp[j] - m) / den;
    const float* po = o_part + ((size_t)rid * n_split + j) * D;
#pragma unroll
    for (int t = 0; t < D / 32; ++t) acc[t] += po[lane + 32 * t] * w;
  }
#pragma unroll
  for (int t = 0; t < D / 32; ++t) store(out + (size_t)rid * D + lane + 32 * t, acc[t]);
  if (lane == 0 && lse != nullptr)
    lse[((size_t)s * hq + head) * R + i] = n_live == 0 ? kNegInf
                                                        : m + logf(den);
}

// ---- tile, tensor cores (bf16 q, d 64/128) --------------------------------

// The rows' table owners and positions, read by every thread of the block
// to walk the stretches: row r of the tile (flattened per kv head) reads
// table row own[r] up to position pos[r]; own = -1 past the last row.
__device__ __forceinline__ void stage_rows(int* own_s, int* pos_s, int rows,
                                           int r0, int n_rows, int rg, int g,
                                           const int* row_slot,
                                           const int* q_offset) {
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int r = r0 + t;
    int own = -1, pos = -1;
    if (r < n_rows) {
      const int s = r / rg;
      own = row_slot == nullptr ? s : row_slot[s];
      pos = q_offset[s] + (r - s * rg) / g;
    }
    own_s[t] = own;
    pos_s[t] = pos;
  }
}

// The end of the stretch that starts at row a (rows [a, b) read one table
// row), and how many keys it reads: up to its last live position, at most
// the table's width; 0 when no row of it sees a key.
__device__ __forceinline__ int stretch(const int* own_s, const int* pos_s,
                                       int rows, int a, int max_key,
                                       int& n_keys) {
  int b = a + 1, last = pos_s[a];
  while (b < rows && own_s[b] == own_s[a]) last = max(last, pos_s[b++]);
  n_keys = own_s[a] < 0 ? 0 : max(0, min(max_key, last + 1));
  return b;
}

template <typename KV, int D>
constexpr size_t tile_tc_smem() {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  return kTileRows * D * 2                         // q~
         + (kInt8 ? 1 : 2) * 2 * kTileKeys * D * 2  // bf16 K, V (x2 stages)
         + (kInt8 ? 2 * 2 * kTileKeys * D          // raw codes, 2 stages
                        + 2 * 2 * kTileKeys * 4    // scales, 2 stages
                  : 0)
         + 2 * kTileRows * 4;                      // row owners, positions
}

// Grid (ceil(n_rows / 64), hkv); n_rows = S * R * g.
template <typename KV, int D>
__global__ void __launch_bounds__(kTileThreads)
paged_tile_tc_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ tables,
                     const int* __restrict__ row_slot,
                     const int* __restrict__ q_offset, bf16* __restrict__ out,
                     float* __restrict__ lse, int R, int hq, int hkv, int bs,
                     int W, int n_rows, float scale) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int CH = D / 8;                   // 16-byte chunks of a bf16 row
  constexpr int RCH = D * sizeof(KV) / 16;    // ... of an arena row
  constexpr int kStages = kInt8 ? 1 : 2;      // bf16 K/V tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kTileRows x D: q~
  bf16* kb = qs + kTileRows * D;                 // kStages x kTileKeys x D
  bf16* vb = kb + kStages * kTileKeys * D;
  int8_t* kraw = reinterpret_cast<int8_t*>(vb + kStages * kTileKeys * D);
  int8_t* vraw = kraw + (kInt8 ? 2 * kTileKeys * D : 0);  // 2 stages
  float* ksc = reinterpret_cast<float*>(vraw + (kInt8 ? 2 * kTileKeys * D : 0));
  float* vsc = ksc + (kInt8 ? 2 * kTileKeys : 0);
  int* own_s = reinterpret_cast<int*>(vsc + (kInt8 ? 2 * kTileKeys : 0));
  int* pos_s = own_s + kTileRows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, g = hq / hkv, rg = R * g;
  const int r0 = blockIdx.x * kTileRows, wr0 = warp * 16;

  stage_rows(own_s, pos_s, kTileRows, r0, n_rows, rg, g, row_slot, q_offset);
  // q~ = q * scale rounded to bf16, rows past n_rows zero
  for (int ci = tid; ci < kTileRows * CH; ci += kTileThreads) {
    const int r = ci / CH, col = (ci % CH) * 8, rr = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (rr < n_rows) {
      const int s = rr / rg, j = rr - s * rg;
      x = load16(q + (((size_t)s * R + j / g) * hq + h * g + j % g) * D + col);
    }
    bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      e[n] = __float2bfloat16(__bfloat162float(e[n]) * scale);
    *reinterpret_cast<uint4*>(qs + swz<D>(r, col)) = x;
  }
  __syncthreads();
  MmaBf16::A qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) qa[kk] = ldsm_a<D>(qs, wr0, kk * 16);
  const int rpos[2] = {pos_s[wr0 + gr], pos_s[wr0 + gr + 8]};

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int a = 0; a < kTileRows;) {
    int n_keys;
    const int b = stretch(own_s, pos_s, kTileRows, a, W * bs, n_keys);
    if (n_keys > 0) {
      const int* table = tables + (size_t)own_s[a] * W;
      const bool active = wr0 < b && wr0 + 16 > a;  // warp-uniform
      const bool in[2] = {wr0 + gr >= a && wr0 + gr < b,
                          wr0 + gr + 8 >= a && wr0 + gr + 8 < b};
      const int n_tiles = (n_keys + kTileKeys - 1) / kTileKeys;
      auto load_tile = [&](int jt) {
        const int k0 = jt * kTileKeys, st = jt & 1;
        for (int ci = tid; ci < kTileKeys * RCH; ci += kTileThreads) {
          const int r = ci / RCH, cc = ci % RCH, kp = k0 + r;
          const bool ok = kp < n_keys;
          const size_t arow = ok ? (size_t)table[kp / bs] * bs + kp % bs : 0;
          const size_t src = (arow * hkv + h) * D + cc * (16 / sizeof(KV));
          if constexpr (kInt8) {
            const size_t dst = (size_t)(st * kTileKeys + r) * D + cc * 16;
            cp_async16(kraw + dst, k + src, ok);
            cp_async16(vraw + dst, v + src, ok);
          } else {
            const int dst = st * kTileKeys * D + swz<D>(r, cc * 8);
            cp_async16(kb + dst, k + src, ok);
            cp_async16(vb + dst, v + src, ok);
          }
        }
        if constexpr (kInt8) {
          if (tid < kTileKeys) {
            const int kp = k0 + tid;
            const bool ok = kp < n_keys;
            const size_t si =
                ok ? ((size_t)table[kp / bs] * bs + kp % bs) * hkv + h : 0;
            cp_async4(ksc + st * kTileKeys + tid, k_scale + si, ok);
            cp_async4(vsc + st * kTileKeys + tid, v_scale + si, ok);
          }
        }
        cp_async_commit();
      };
      load_tile(0);

      for (int jt = 0; jt < n_tiles; ++jt) {
        if (jt + 1 < n_tiles) {
          load_tile(jt + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // tile jt has landed for every thread
        const int k0 = jt * kTileKeys, st = jt & 1;
        const bf16* kt = kb + (kInt8 ? 0 : st * kTileKeys * D);
        const bf16* vt = vb + (kInt8 ? 0 : st * kTileKeys * D);
        if constexpr (kInt8) {
          // the codes widened to bf16 (exact) into the swizzled tiles
          for (int ci = tid; ci < kTileKeys * RCH; ci += kTileThreads) {
            const int r = ci / RCH, col = (ci % RCH) * 16;
            const size_t at = (size_t)(st * kTileKeys + r) * D + col;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int8_t* src = half ? vraw + at : kraw + at;
              bf16* dst = half ? vb : kb;
              const uint4 x = load16(src);
              uint32_t w[8];
#pragma unroll
              for (int n = 0; n < 8; ++n)
                w[n] = pack_bf16(chunk_elem<int8_t>(x, 2 * n),
                                 chunk_elem<int8_t>(x, 2 * n + 1));
              *reinterpret_cast<uint4*>(dst + swz<D>(r, col)) =
                  make_uint4(w[0], w[1], w[2], w[3]);
              *reinterpret_cast<uint4*>(dst + swz<D>(r, col + 8)) =
                  make_uint4(w[4], w[5], w[6], w[7]);
            }
          }
          __syncthreads();
        }
        if (active) {
          float sc[8][4];
#pragma unroll
          for (int n = 0; n < 8; ++n)
            sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
            for (int n = 0; n < 8; n += 2) {
              MmaBf16::B b0, b1;
              ldsm_bt<D>(b0, b1, kt, n * 8, kk * 16);
              MmaBf16::mma(sc[n], qa[kk], b0);
              MmaBf16::mma(sc[n + 1], qa[kk], b1);
            }
          // the int8 lane's per-key scale, then the masks: rows of this
          // stretch see keys up to their own position
          uint32_t live = 0u;  // bit 4n + e: fragment element (n, e)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cidx = n * 8 + 2 * t + (e & 1), kp = k0 + cidx;
              const int r = e >> 1;
              const bool ok = in[r] && kp <= rpos[r] && kp < n_keys;
              float x = sc[n][e];
              if constexpr (kInt8) x *= ksc[st * kTileKeys + cidx];
              sc[n][e] = ok ? x : kNegInf;
              live |= (uint32_t)ok << (4 * n + e);
            }
          // online softmax: the row max over the quad that holds the row;
          // a row outside the stretch keeps its state (alpha = 1, p = 0)
          float mx[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
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
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = 0.f;
              if ((live >> (4 * n + e)) & 1u) p = expf(sc[n][e] - m[e >> 1]);
              l[e >> 1] += p;
              if constexpr (kInt8) p *= vsc[st * kTileKeys + n * 8 + 2 * t + (e & 1)];
              sc[n][e] = p;
            }
          // O += p V over the tile's 4 k-steps of 16 keys
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if constexpr (kInt8) {
              // p * v_scale = hi + lo, both bf16; hi.codes + lo.codes
              float hi[2][4], lo[2][4];
#pragma unroll
              for (int x = 0; x < 2; ++x)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  hi[x][e] = round_bf16(sc[2 * kk + x][e]);
                  lo[x][e] = sc[2 * kk + x][e] - hi[x][e];
                }
              const MmaBf16::A ah = acc_to_a(hi[0], hi[1]);
              const MmaBf16::A al = acc_to_a(lo[0], lo[1]);
#pragma unroll
              for (int n = 0; n < D / 8; n += 2) {
                MmaBf16::B b0, b1;
                ldsm_b<D>(b0, b1, vt, kk * 16, n * 8);
                MmaBf16::mma(o[n], ah, b0);
                MmaBf16::mma(o[n], al, b0);
                MmaBf16::mma(o[n + 1], ah, b1);
                MmaBf16::mma(o[n + 1], al, b1);
              }
            } else {
              // the bf16 arena lane: p rounded to bf16 (:148)
              const MmaBf16::A a = acc_to_a(sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
              for (int n = 0; n < D / 8; n += 2) {
                MmaBf16::B b0, b1;
                ldsm_b<D>(b0, b1, vt, kk * 16, n * 8);
                MmaBf16::mma(o[n], a, b0);
                MmaBf16::mma(o[n + 1], a, b1);
              }
            }
          }
        }
        __syncthreads();  // this stage consumed before it is refilled
      }
    }
    a = b;
  }

  // l summed over the quad; out = acc / l; a row that saw no live key
  // gives exact 0 and lse = -1e30
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int rr = r0 + wr0 + gr + 8 * r;
    if (rr >= n_rows) continue;
    const int s = rr / rg, j = rr - s * rg, i = j / g, head = h * g + j % g;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    bf16* orow = out + (((size_t)s * R + i) * hq + head) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * r] / l_safe, o[n][2 * r + 1] / l_safe);
    if (t == 0 && lse != nullptr)
      lse[((size_t)s * hq + head) * R + i] =
          l[r] == 0.f ? kNegInf : m[r] + logf(l_safe);
  }
}

// ---- tile, CUDA cores (fp32 q, other d) -----------------------------------

// One arena element as fp32: fp lanes convert, the int8 lane multiplies
// the code by its row's scale (index si = arena row * hkv + kv head).
__device__ __forceinline__ float load_kv(const float* p, const float*,
                                         size_t i, size_t) {
  return p[i];
}
__device__ __forceinline__ float load_kv(const bf16* p, const float*,
                                         size_t i, size_t) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_kv(const int8_t* p,
                                         const float* __restrict__ scale,
                                         size_t i, size_t si) {
  return (float)p[i] * scale[si];
}

constexpr int kCoreRows = kWarps;  // paged_tile_kernel: one row per warp

inline size_t tile_smem(int d) {
  return (size_t)(kCoreRows + 2 * kTile) * (d + 1) * sizeof(float) +
         2 * kCoreRows * sizeof(int);
}

// Grid (ceil(n_rows / 4), hkv); warp w owns row w of the tile.
template <typename T, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
paged_tile_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ tables,
                  const int* __restrict__ row_slot,
                  const int* __restrict__ q_offset, T* __restrict__ out,
                  float* __restrict__ lse, int R, int hq, int hkv, int d,
                  int bs, int W, int n_rows, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;
  float* ks = qs + kCoreRows * ld;
  float* vs = ks + kTile * ld;
  int* own_s = reinterpret_cast<int*>(vs + kTile * ld);
  int* pos_s = own_s + kCoreRows;

  const int r0 = blockIdx.x * kCoreRows, h = blockIdx.y;
  const int g = hq / hkv, rg = R * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_rows(own_s, pos_s, kCoreRows, r0, n_rows, rg, g, row_slot,
             q_offset);
  for (int e = threadIdx.x; e < kCoreRows * d; e += blockDim.x) {
    const int r = e / d, c = e - r * d, rr = r0 + r;
    float x = 0.f;
    if (rr < n_rows) {
      const int s = rr / rg, j = rr - s * rg;
      x = round_as(
          to_float(q[(((size_t)s * R + j / g) * hq + h * g + j % g) * d + c]) *
              scale,
          q);
    }
    qs[r * ld + c] = x;
  }
  __syncthreads();

  float m = -CUDART_INF_F, l = 0.f, acc[kMaxCols];
#pragma unroll
  for (int t = 0; t < kMaxCols; ++t) acc[t] = 0.f;
  const size_t key_stride = (size_t)hkv * d;

  for (int a = 0; a < kCoreRows;) {
    int n_keys;
    const int b = stretch(own_s, pos_s, kCoreRows, a, W * bs, n_keys);
    const int* table = tables + (size_t)max(own_s[a], 0) * W;
    for (int k0 = 0; k0 < n_keys; k0 += kTile) {
      __syncthreads();  // the previous tile consumed
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
      // warp-uniform: the warp's row is in this stretch and sees the tile
      if (warp < a || warp >= b || k0 > pos_s[warp]) continue;
      const int kp = k0 + lane;
      const bool live = kp < n_keys && kp <= pos_s[warp];
      online_softmax_tile<kIsBf16<KV>>(qs + warp * ld, ks, vs, ld, d, live,
                                       m, l, acc);
    }
    a = b;
  }

  const int rr = r0 + warp;
  if (rr >= n_rows) return;
  const int s = rr / rg, j = rr - s * rg, ri = j / g, head = h * g + j % g;
  finish_row(out + (((size_t)s * R + ri) * hq + head) * d,
             lse == nullptr ? nullptr : lse + ((size_t)s * hq + head) * R + ri,
             d, m, l, acc);
}

// ---- launches --------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *tables, *row_slot, *q_offset;
  void *out, *lse, *o_part, *lse_part;
  int S, R, hq, hkv, d, bs, W, split, n_split;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D>
int launch_split_kv(const Args& a) {
  if (a.n_split < 1 || a.split < 1 ||
      (a.n_split > 1 && (a.o_part == nullptr || a.lse_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.n_split + kSplitWarps - 1) / kSplitWarps, a.R * a.hq,
                  a.S);
  paged_split_kv_kernel<T, KV, D><<<grid, kSplitWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.q_offset), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.o_part),
      static_cast<float*>(a.lse_part), a.R,
      a.hq, a.hkv, a.bs, a.W, a.split, a.n_split, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return (int)err;
  const int n_rows = a.S * a.R * a.hq;
  paged_split_kv_combine_kernel<T, D>
      <<<(n_rows + kSplitWarps - 1) / kSplitWarps, kSplitWarps * 32, 0,
         a.stream>>>(static_cast<const float*>(a.o_part),
                     static_cast<const float*>(a.lse_part),
                     static_cast<const int*>(a.q_offset),
                     static_cast<T*>(a.out), static_cast<float*>(a.lse), a.R,
                     a.hq, a.bs, a.W, a.split, a.n_split, n_rows);
  return (int)cudaGetLastError();
}

template <typename KV, int D>
int launch_tile_tc(const Args& a) {
  constexpr size_t smem = tile_tc_smem<KV, D>();
  cudaError_t err = allow_smem(paged_tile_tc_kernel<KV, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = a.S * a.R * (a.hq / a.hkv);
  const dim3 grid((n_rows + kTileRows - 1) / kTileRows, a.hkv);
  paged_tile_tc_kernel<KV, D><<<grid, kTileThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.row_slot), static_cast<const int*>(a.q_offset),
      static_cast<bf16*>(a.out), static_cast<float*>(a.lse), a.R, a.hq, a.hkv,
      a.bs, a.W, n_rows, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch_tile(const Args& a) {
  const size_t smem = tile_smem(a.d);
  cudaError_t err = allow_smem(paged_tile_kernel<T, KV>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = a.S * a.R * (a.hq / a.hkv);
  const dim3 grid((n_rows + kCoreRows - 1) / kCoreRows, a.hkv);
  paged_tile_kernel<T, KV><<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.row_slot), static_cast<const int*>(a.q_offset),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.R, a.hq, a.hkv,
      a.d, a.bs, a.W, n_rows, a.scale);
  return (int)cudaGetLastError();
}

// The lane the caller picked, if these shapes fit it.
template <typename T, typename KV>
int launch(int lane, const Args& a) {
  if (lane == kLaneSplitKv && a.row_slot == nullptr &&
      a.R * (a.hq / a.hkv) <= kSplitMaxRows) {
    if (a.d == 64) return launch_split_kv<T, KV, 64>(a);
    if (a.d == 128) return launch_split_kv<T, KV, 128>(a);
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (lane == kLaneTileTc && a.d == 64) return launch_tile_tc<KV, 64>(a);
    if (lane == kLaneTileTc && a.d == 128) return launch_tile_tc<KV, 128>(a);
  }
  if (lane == kLaneTile) return launch_tile<T, KV>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (S, R, hq, d); k/v arena (n_blocks, bs, hkv, d); all contiguous, fp32
// (bf16 == 0) or bf16 (bf16 == 1); tables (n_tables, W) int32 (n_tables =
// S without row_slot); row_slot (S,) int32 or null; q_offset (S,) int32;
// out like q; lse (S, hq, R) fp32 or null; o_part (S * R * hq, n_split, d)
// and lse_part (S * R * hq, n_split) fp32 scratch of the split_kv lane
// when n_split > 1, else null; split: keys per split; lane: 0 split_kv, 1
// tile on the tensor cores, 2 tile on the CUDA cores. Launches on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for a lane these
// shapes do not fit).
extern "C" int hetu_paged_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* row_slot, const void* q_offset, void* out, void* lse,
    void* o_part, void* lse_part, int S, int R, int hq, int hkv, int d,
    int bs, int W, int split, int n_split, int lane, float scale, int bf16,
    void* stream) {
  const Args a{q, k, v, nullptr, nullptr, tables, row_slot, q_offset,
               out, lse, o_part, lse_part, S, R, hq, hkv, d, bs, W, split,
               n_split, scale, static_cast<cudaStream_t>(stream)};
  return bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(lane, a)
              : launch<float, float>(lane, a);
}

// The int8 lane: k/v int8 codes (n_blocks, bs, hkv, d), k_scale/v_scale
// fp32 (n_blocks, bs, hkv, 1); q/out fp32 (bf16 == 0) or bf16 (bf16 ==
// 1); the rest as hetu_paged_attention.
extern "C" int hetu_paged_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* row_slot,
    const void* q_offset, void* out, void* lse, void* o_part, void* lse_part,
    int S, int R, int hq, int hkv, int d, int bs, int W, int split,
    int n_split, int lane, float scale, int bf16, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, tables, row_slot, q_offset,
               out, lse, o_part, lse_part, S, R, hq, hkv, d, bs, W, split,
               n_split, scale, static_cast<cudaStream_t>(stream)};
  return bf16 ? launch<__nv_bfloat16, int8_t>(lane, a)
              : launch<float, int8_t>(lane, a);
}
