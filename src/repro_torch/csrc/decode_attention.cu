// Split-KV flash-decode attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas).  For each (batch row b, kv head h) the
// rows = m*g query rows of the GQA group (every new position times every q
// head sharing kv head h; row r is position r / g, q head h*g + r % g)
// attend causally, with an optional sliding window, over a dense
// (B, C, Hkv, D) cache.  The mask is decided by kv_pos alone (-1 = empty
// slot), so slot order is irrelevant: ring caches work as they are.  q and
// q_pos are read, and out written, in their own (B, m, Hq, D) layout: a
// call is exactly two launches, the split kernel and the merge.
//
// What bounds it on the H100: bytes.  The function reads K and V once:
// at B 4, C 4096, Hkv 8, D 128 in bf16 that is 67.1 MB, about 0.020 ms at
// 3.35 TB/s, against m*g*4*D FLOPs per cached key and kv head -- under 8
// FLOP per byte at decode widths.
//
// Why not the TPU kernel's shape: it carries (m, l, acc) across a
// sequential kv-tile grid axis.  On Hopper a grid of B*Hkv blocks is 32
// blocks at B 4 on 132 SMs.  So the kv axis is split: grid (B*Hkv, n_split),
// n_split chosen by the wrapper (ops.split_plan) from C and the kernel's
// occupancy so that the grid fills the SMs.  Each block walks its split in
// tiles of TILE keys, each K/V tile loaded ONCE for all `rows` query rows
// (the GQA reuse of the TPU kernel), keeps a float32 online softmax and
// writes its unnormalised partial (m, l, acc) to scratch.  The merge kernel
// combines the splits in fixed split order; a split with no valid key
// (m = -1e30, l = 0, acc = 0) is an exact identity in it.  Output is 0
// where no key is valid.
//
// Two split kernels, chosen by the wrapper (ops.decode_variant):
//
// decode_mma_kernel (bf16 at the (Dk, Dv) pairs of the REPRO_DECODE_MMA_CASE
// lines) runs on the tensor cores:
//   * K/V tiles stay bf16 and arrive by 16-byte cp.async into rows padded
//     by 16 bytes (ldmatrix without bank conflicts), in a ring of STAGES
//     tiles, so the copies of the next tiles are in flight while one is
//     computed.  The ragged last tile is zero-filled through cp.async's
//     src-size operand and masked.  A block first lists the tiles of its
//     split that hold a key some query row may attend; only those are
//     copied, so skipped tiles never stall the ring.
//   * S = Q K^T on mma.sync.m16n8k16 (bf16 in, float32 accumulate): Q
//     unscaled from its A-fragments, K from ldmatrix, the scale applied to
//     the float32 score.  Rows pad to 16 per m-tile.
//   * Warps split the keys of a tile, not only the rows: with one m-tile
//     (rows <= 16: at m 1 only 4 of 16 rows are real) each of the 4 warps
//     takes 16 keys of every tile; with two m-tiles, two key groups of 32;
//     with three or four, one warp per m-tile.  Each warp keeps its own
//     (m, l, acc); the block merges its key groups in order before it
//     writes the split's partial.
//   * P.V exact to float32: p = hi + lo with hi = bf16(p), lo = bf16(p - hi)
//     (the residual is below 2^-17 p), two mma into one float32
//     accumulator.  A single bf16 rounding of p, as flash prefill does, puts
//     near-zero outputs tens of times past the one-ulp bar this kernel is
//     held to (its plain version keeps p in float32).
//
// decode_split_kernel (float32, and bf16 at any other pair) is the scalar
// kernel: q cast to float32 and then scaled, K and V converted to float32
// in shared memory, scalar FMAs register-blocked over query rows,
// probabilities in float32.  In float32 the tensor cores would compute in
// TF32, short of the 1e-5 float32 bar.  Head dims run to 256 (Gemma's):
// past 128, K and V of a tile share one shared-memory buffer (V is loaded
// over K once the scores are taken, while the softmax step runs), so 64
// query rows at 256 fit in 210 KB (separate tiles would need 274 KB).

#include <limits.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int THREADS = 256;  // scalar split kernel
constexpr int WARPS = THREADS / 32;
constexpr int MERGE_THREADS = 128;
constexpr int TILE = 64;  // keys per shared-memory tile: two per lane
static_assert(TILE == 64, "the softmax step gives each lane keys lane, lane+32");
// head dims above which the scalar kernel's K and V tiles share a buffer
constexpr int KV_SEPARATE_MAX = 128;
// rows of a P.V register block at most (tile_pv); more rows take turns
constexpr int PV_ROWS = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool key_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// q row r of kv head h: position r / g, q head h * g + r % g
__device__ __forceinline__ size_t q_row(int b, int h, int r, int m, int g, int Hkv) {
  return ((size_t)b * m + r / g) * Hkv * g + h * g + r % g;
}

// ------------------------------------------------------------------ scalar
// One thread per key and row group for the scores, per d and row group for
// P.V: each K or V element is read from shared memory once per NR rows
// (a register block), the q and p values are broadcast across the warp.
// Every sum runs in ascending d or key order, one FMA chain per output.

constexpr int SCORE_GROUPS = THREADS / TILE;  // row groups of the score step

// a register block's row count as a type, for the dispatch below
template <int N>
using Rows = std::integral_constant<int, N>;

// scores of key t (K row kr) against rows r0, r0 + stride, ... (NR of
// them; rows past `rows` are computed from row rows - 1 and dropped)
template <int NR>
__device__ __forceinline__ void tile_scores(const float* qs, const float* kr,
                                            float* sc, const int* kp_s,
                                            const int* qp_s, int rows, int Dk,
                                            int window, int t, int r0,
                                            int stride) {
  const float* qr[NR];
  float s[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    qr[j] = qs + min(r0 + stride * j, rows - 1) * Dk;
    s[j] = 0.f;
  }
  for (int d = 0; d < Dk; ++d) {
    const float kd = kr[d];
#pragma unroll
    for (int j = 0; j < NR; ++j) s[j] += qr[j][d] * kd;
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int r = r0 + stride * j;
    if (r < rows) sc[r * TILE + t] = key_valid(kp_s[t], qp_s[r], window) ? s[j] : NEG_INF;
  }
}

// acc[r][d] = acc[r][d] * alpha_r + sum_t p[r][t] v[t][d] for rows r0,
// r0 + stride, ... (vd = vs + d, ad = acc + d)
template <int NR>
__device__ __forceinline__ void tile_pv(const float* sc, const float* vd,
                                        float* ad, const float* alpha_s,
                                        int rows, int Dv, int r0, int stride) {
  const float* pr[NR];
  float pv[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    pr[j] = sc + min(r0 + stride * j, rows - 1) * TILE;
    pv[j] = 0.f;
  }
  for (int t = 0; t < TILE; ++t) {
    const float x = vd[t * Dv];
#pragma unroll
    for (int j = 0; j < NR; ++j) pv[j] += pr[j][t] * x;
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int r = r0 + stride * j;
    if (r < rows) ad[r * Dv] = ad[r * Dv] * alpha_s[r] + pv[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const T* __restrict__ q,          // (B, m, Hq, Dk)
    const T* __restrict__ k,          // (B, C, Hkv, Dk)
    const T* __restrict__ v,          // (B, C, Hkv, Dv)
    const int* __restrict__ q_pos,    // (B, m)
    const int* __restrict__ kv_pos,   // (B, C)
    float* __restrict__ part_ml,      // (B*Hkv, n_split, rows, 2)
    float* __restrict__ part_acc,     // (B*Hkv, n_split, rows, Dv)
    int C, int Hkv, int m, int g, int Dk, int Dv, int split_len, int window,
    float scale) {
  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int lane = tid & 31, warp = tid >> 5;
  const int rows = m * g;
  const int ldk = Dk + 1;  // padded row: no bank conflicts on K reads
  const bool kv_shared = Dk > KV_SEPARATE_MAX || Dv > KV_SEPARATE_MAX;
  extern __shared__ float smem[];
  float* qs = smem;                  // rows * Dk
  float* ks = qs + rows * Dk;        // TILE * ldk
  float* vs = kv_shared ? ks : ks + TILE * ldk;  // TILE * Dv
  // rows * TILE: scores, then probabilities
  float* sc = kv_shared ? ks + TILE * max(ldk, Dv) : vs + TILE * Dv;
  float* acc = sc + rows * TILE;     // rows * Dv
  float* m_s = acc + rows * Dv;      // rows
  float* l_s = m_s + rows;           // rows
  float* alpha_s = l_s + rows;       // rows
  int* kp_s = reinterpret_cast<int*>(alpha_s + rows);  // TILE
  int* qp_s = kp_s + TILE;                              // rows

  for (int i = tid; i < rows * Dk; i += THREADS) {
    const int r = i / Dk, d = i - r * Dk;
    qs[i] = to_f(q[q_row(b, h, r, m, g, Hkv) * Dk + d]) * scale;
  }
  for (int i = tid; i < rows * Dv; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < rows; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    qp_s[r] = q_pos[(size_t)b * m + r / g];
  }
  __syncthreads();

  const int start = split * split_len;
  const int stop = min(C, start + split_len);
  for (int t0 = start; t0 < stop; t0 += TILE) {
    const int n = min(TILE, stop - t0);
    // each key's validity against every query row; a tile where none is
    // valid is an identity step, skipped before its K/V load
    int any = 0;
    for (int t = tid; t < TILE; t += THREADS) {
      const int kp = t < n ? kv_pos[(size_t)b * C + t0 + t] : -1;
      kp_s[t] = kp;
      for (int r = 0; r < rows && !any; ++r) any = key_valid(kp, qp_s[r], window);
    }
    if (!__syncthreads_or(any)) continue;

    const size_t key0 = (size_t)b * C + t0;
    const auto load_v = [&]() {
      for (int i = tid; i < TILE * Dv; i += THREADS) {
        const int t = i / Dv, d = i - t * Dv;
        vs[i] = t < n ? to_f(v[((key0 + t) * Hkv + h) * Dv + d]) : 0.f;
      }
    };
    for (int i = tid; i < TILE * Dk; i += THREADS) {
      const int t = i / Dk, d = i - t * Dk;
      ks[t * ldk + d] = t < n ? to_f(k[((key0 + t) * Hkv + h) * Dk + d]) : 0.f;
    }
    if (!kv_shared) load_v();
    __syncthreads();

    {  // thread (key t, row group) over rows rg, rg + SCORE_GROUPS, ...
      const int t = tid % TILE, rg = tid / TILE;
      const int nr = (rows - rg + SCORE_GROUPS - 1) / SCORE_GROUPS;
      const auto f = [&](auto nrc) {
        tile_scores<decltype(nrc)::value>(qs, ks + t * ldk, sc, kp_s, qp_s, rows,
                                          Dk, window, t, rg, SCORE_GROUPS);
      };
      if (nr <= 1) f(Rows<1>{});
      else if (nr <= 2) f(Rows<2>{});
      else if (nr <= 4) f(Rows<4>{});
      else if (nr <= 8) f(Rows<8>{});
      else f(Rows<16>{});
    }
    __syncthreads();
    // the scores are taken: V may overwrite K (the step below reads sc only)
    if (kv_shared) load_v();

    // one warp per query row: running max, probabilities, sum
    for (int r = warp; r < rows; r += WARPS) {
      float* row = sc + r * TILE;
      const int qp = qp_s[r];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(row[lane], row[lane + 32])));
      float lsum = 0.f;
      for (int t = lane; t < TILE; t += 32) {
        const float p = key_valid(kp_s[t], qp, window) ? expf(row[t] - m_new) : 0.f;
        row[t] = p;
        lsum += p;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + lsum;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    {  // thread (d, row group) over rows rg, rg + groups, ..., PV_ROWS of
       // them at a time (more than PV_ROWS only at Dv > 128: one group)
      const int groups = THREADS / Dv, d = tid % Dv, rg = tid / Dv;
      for (int rb = rg; rg < groups && rb < rows; rb += groups * PV_ROWS) {
        const int nr = min(PV_ROWS, (rows - rb + groups - 1) / groups);
        const auto f = [&](auto nrc) {
          tile_pv<decltype(nrc)::value>(sc, vs + d, acc + d, alpha_s, rows, Dv, rb,
                                        groups);
        };
        if (nr <= 1) f(Rows<1>{});
        else if (nr <= 2) f(Rows<2>{});
        else if (nr <= 4) f(Rows<4>{});
        else if (nr <= 8) f(Rows<8>{});
        else if (nr <= 16) f(Rows<16>{});
        else f(Rows<PV_ROWS>{});
      }
    }
    __syncthreads();
  }

  // the split's unnormalised partial
  const size_t part = ((size_t)bh * gridDim.y + split) * rows;
  for (int r = tid; r < rows; r += THREADS) {
    part_ml[(part + r) * 2] = m_s[r];
    part_ml[(part + r) * 2 + 1] = l_s[r];
  }
  for (int i = tid; i < rows * Dv; i += THREADS) part_acc[part * Dv + i] = acc[i];
}

size_t scalar_smem(int rows, int Dk, int Dv) {
  const size_t kv = Dk > KV_SEPARATE_MAX || Dv > KV_SEPARATE_MAX
                        ? (size_t)TILE * std::max(Dk + 1, Dv)
                        : (size_t)TILE * (Dk + 1) + (size_t)TILE * Dv;
  const size_t floats = (size_t)rows * Dk + kv + (size_t)rows * TILE +
                        (size_t)rows * Dv + 3 * (size_t)rows;
  return floats * sizeof(float) + (size_t)(TILE + rows) * sizeof(int);
}

// ------------------------------------------------------------------ mma
// Fragment layouts are those of PTX's m16n8k16 (gr = lane / 4, t = lane %
// 4): A holds rows gr and gr + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9;
// B holds column gr at rows 2t, 2t + 1 and 2t + 8, 2t + 9; C holds rows gr
// and gr + 8 at columns 2t, 2t + 1.  The helpers are those of
// flash_attention.cu.

constexpr int MMA_THREADS = 128;
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int STAGES = 3;     // K/V tiles in the cp.async ring
constexpr int PAD = 8;        // bf16 of padding per shared row: 16 bytes
constexpr int LIST_TILES = 16;  // tiles per split assumed for occupancy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros (a key past C)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b over one m16n8k16 tile, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to bf16 in one register, lo in the low half
// (the lower column of a fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// what bf16 rounding leaves of x: x - bf16(x), exact in float32
__device__ __forceinline__ float bf16_residual(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

template <int DK, int DV>
struct MmaSmem {
  static constexpr int KLD = DK + PAD;
  static constexpr int VLD = DV + PAD;
  // float rows of the staged partials: a half-warp's float2 stores at rows
  // gr, columns 2t fall on 32 distinct banks
  static constexpr int ALD = DV + 8;
  static constexpr size_t STAGE_BYTES = (size_t)TILE * (KLD + VLD) * 2;
  static constexpr size_t RING = STAGES * STAGE_BYTES;
  // after the loop the ring holds every warp's partial: acc (16 x ALD), then
  // (m, l) per row, then the key-group weights
  static constexpr size_t STAGED =
      (size_t)MMA_WARPS * 16 * (ALD + 2) * 4 + (size_t)MMA_WARPS * 64 * 4;
  static_assert(STAGED <= RING, "the staged partials reuse the K/V ring");
  // ring | q tile (16 per m-tile rows) | key positions [STAGES][TILE] |
  // tile flags, visit list [split tiles each] | visit count
  static size_t bytes(int mtiles, int split_tiles) {
    return RING + (size_t)mtiles * 16 * KLD * 2 +
           ((size_t)STAGES * TILE + 2 * (size_t)split_tiles + 4) * sizeof(int);
  }
};

template <int DK, int DV, int KG>
__global__ void __launch_bounds__(MMA_THREADS) decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, m, Hq, DK)
    const __nv_bfloat16* __restrict__ k,  // (B, C, Hkv, DK)
    const __nv_bfloat16* __restrict__ v,  // (B, C, Hkv, DV)
    const int* __restrict__ q_pos,        // (B, m)
    const int* __restrict__ kv_pos,       // (B, C)
    float* __restrict__ part_ml,          // (B*Hkv, n_split, rows, 2)
    float* __restrict__ part_acc,         // (B*Hkv, n_split, rows, DV)
    int C, int Hkv, int m, int g, int split_len, int window, float scale) {
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DK <= 128 && DV <= 128,
                "head dims are multiples of 16 up to 128");
  static_assert(KG == 1 || KG == 2 || KG == 4, "key groups per tile");
  using L = MmaSmem<DK, DV>;
  constexpr int MTP = MMA_WARPS / KG;  // m-tiles the warps cover
  constexpr int KW = TILE / KG;        // keys of a tile per warp
  constexpr int NS = KW / 8;           // n8 tiles of S per warp
  constexpr int KS = DK / 16;          // k-steps of S = Q K^T
  constexpr int NO = DV / 8;           // n8 tiles of the output

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int rows = m * g, mtiles = (rows + 15) / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int mt = warp % MTP, kg = warp / MTP;  // this warp's m-tile, key group
  const bool active = mt < mtiles;
  const int start = split * split_len;
  const int stop = min(C, start + split_len);
  const int n_tiles = (stop - start + TILE - 1) / TILE;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::RING);
  int* kp_s = reinterpret_cast<int*>(smem_raw + L::RING +
                                     (size_t)mtiles * 16 * L::KLD * 2);
  int* flags = kp_s + STAGES * TILE;  // [n_tiles]
  int* list = flags + n_tiles;        // [n_tiles]
  int* count = list + n_tiles;

  // ---- the q rows, in flight while the block lists its tiles (padded rows
  // are zero)
  for (int c = tid; c < mtiles * 16 * (DK / 8); c += MMA_THREADS) {
    const int r = c / (DK / 8), d = (c % (DK / 8)) * 8;
    const bool real = r < rows;
    cp_async16(smem_u32(qs + r * L::KLD + d),
               q + q_row(b, h, real ? r : 0, m, g, Hkv) * DK + d, real ? 16 : 0);
  }
  cp_async_commit();

  // ---- the tiles of this split holding a key that some query row may
  // attend, by the rows' smallest and largest position (conservative: a
  // visited tile without a valid pair is an exact identity step)
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < m; ++i) {
    const int p = q_pos[(size_t)b * m + i];
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
  for (int i = tid; i < n_tiles; i += MMA_THREADS) flags[i] = 0;
  __syncthreads();
  for (int i = start + tid; i < stop; i += MMA_THREADS) {
    const int kp = kv_pos[(size_t)b * C + i];
    if (kp >= 0 && kp <= qmax && (window == 0 || qmin - kp < window))
      flags[(i - start) / TILE] = 1;
  }
  __syncthreads();
  if (warp == 0) {  // compact the flags into the visit list, in tile order
    int n = 0;
    for (int i0 = 0; i0 < n_tiles; i0 += 32) {
      const bool f = i0 + lane < n_tiles && flags[i0 + lane];
      const unsigned mask = __ballot_sync(FULL, f);
      if (f) list[n + __popc(mask & ((1u << lane) - 1))] = i0 + lane;
      n += __popc(mask);
    }
    if (lane == 0) *count = n;
  }
  cp_async_wait<0>();  // the q rows
  __syncthreads();
  const int n_visit = *count;

  // ---- q A-fragments of this warp's m-tile at every k-step, unscaled
  uint32_t qa[KS][4];
  {
    const int r = mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int d = (lane >> 4) * 8;
#pragma unroll
    for (int st = 0; st < KS; ++st)
      if (active) ldmatrix_x4(qa[st], smem_u32(qs + r * L::KLD + st * 16 + d));
  }
  // this thread's rows mt*16 + gr and + 8; padded rows have position -1,
  // so every key is masked for them
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = mt * 16 + gr + 8 * i;
    qp[i] = r < rows ? q_pos[(size_t)b * m + r / g] : -1;
  }

  // tile `tile` of the split into ring stage `buf`: K, V and the key
  // positions (keys past C are zero with position -1).  Split lengths are
  // whole tiles, so only the last split's last tile is ragged.
  auto issue = [&](int tile, int buf) {
    const int k0 = start + tile * TILE;
    const uint32_t kdst = smem_u32(ring + buf * (L::STAGE_BYTES / 2));
    const uint32_t vdst = kdst + TILE * L::KLD * 2;
#pragma unroll
    for (int c = tid; c < TILE * DK / 8; c += MMA_THREADS) {
      const int r = c / (DK / 8), d = (c % (DK / 8)) * 8, ki = k0 + r;
      cp_async16(kdst + (r * L::KLD + d) * 2,
                 k + (((size_t)b * C + min(ki, C - 1)) * Hkv + h) * DK + d,
                 ki < stop ? 16 : 0);
    }
#pragma unroll
    for (int c = tid; c < TILE * DV / 8; c += MMA_THREADS) {
      const int r = c / (DV / 8), d = (c % (DV / 8)) * 8, ki = k0 + r;
      cp_async16(vdst + (r * L::VLD + d) * 2,
                 v + (((size_t)b * C + min(ki, C - 1)) * Hkv + h) * DV + d,
                 ki < stop ? 16 : 0);
    }
    if (tid < TILE) {
      int* dst = kp_s + buf * TILE + tid;
      if (k0 + tid < stop)
        cp_async4(smem_u32(dst), kv_pos + (size_t)b * C + k0 + tid);
      else
        *dst = -1;
    }
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  // one commit group per tile slot, empty past the list, so that
  // wait_group<STAGES - 2> always means "tile it has landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_visit) issue(list[s], s);
    cp_async_commit();
  }
  for (int it = 0; it < n_visit; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it is visible; every warp is done with it - 1
    {
      const int nxt = it + STAGES - 1;
      if (nxt < n_visit) issue(list[nxt], nxt % STAGES);
      cp_async_commit();
    }
    if (!active) continue;
    const int buf = it % STAGES;
    const __nv_bfloat16* kb = ring + buf * (L::STAGE_BYTES / 2) + kg * KW * L::KLD;
    const __nv_bfloat16* vb =
        ring + buf * (L::STAGE_BYTES / 2) + TILE * L::KLD + kg * KW * L::VLD;
    const int* kp = kp_s + buf * TILE + kg * KW;

    // S = Q K^T over this warp's KW keys; one ldmatrix.x4 gives the
    // B-fragments of two n8 tiles
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    {
      const int key = (lane >> 4) * 8 + (lane & 7);
      const int d = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int st = 0; st < KS; ++st) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_u32(kb + (np * 16 + key) * L::KLD + st * 16 + d));
          mma_bf16(s[2 * np], qa[st], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qa[st], bf[2], bf[3]);
        }
      }
    }

    // scale, mask, row max across the quad, p, alpha, l
    uint32_t valid = 0;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key_valid(kp[n * 8 + 2 * t + (e & 1)], qp[e >> 1], window)) {
          valid |= 1u << (n * 4 + e);
          s[n][e] *= scale;
        } else {
          s[n][e] = NEG_INF;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], m_new[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (valid >> (n * 4 + e)) & 1u ? expf(s[n][e] - m_new[e >> 1]) : 0.f;
        lsum[e >> 1] += p;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + lsum[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V with P = hi + lo: the S accumulators of n8 tiles 2j and
    // 2j + 1 are the A-fragment of k-step j; one ldmatrix.x4.trans gives
    // V's B-fragments of two n8 tiles of the output
    {
      const int key = ((lane >> 3) & 1) * 8 + (lane & 7);
      const int d = (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {  // x: n8 tile 2j + x / 2, rows + 8 (x % 2)
          const float a = s[2 * j + x / 2][2 * (x % 2)];
          const float c = s[2 * j + x / 2][2 * (x % 2) + 1];
          hi[x] = pack_bf16(a, c);
          lo[x] = pack_bf16(bf16_residual(a), bf16_residual(c));
        }
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, smem_u32(vb + (j * 16 + key) * L::VLD + np * 16 + d));
          mma_bf16(o[2 * np], hi, bf[0], bf[1]);
          mma_bf16(o[2 * np + 1], hi, bf[2], bf[3]);
          mma_bf16(o[2 * np], lo, bf[0], bf[1]);
          mma_bf16(o[2 * np + 1], lo, bf[2], bf[3]);
        }
      }
    }
  }

  // ---- stage every warp's (m, l, acc) in the ring, merge the key groups
  // of each m-tile in group order, write the split's partial (real rows)
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* st_acc = reinterpret_cast<float*>(smem_raw);  // [warp][16][ALD]
  float* st_ml = st_acc + MMA_WARPS * 16 * L::ALD;     // [warp][16][2]
  float* st_w = st_ml + MMA_WARPS * 16 * 2;            // [KG][rows]
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(FULL, l, 1);
      l += __shfl_xor_sync(FULL, l, 2);
      float* acc_row = st_acc + (warp * 16 + gr + 8 * i) * L::ALD;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(acc_row + n * 8 + 2 * t) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (t == 0) {
        st_ml[(warp * 16 + gr + 8 * i) * 2] = m_run[i];
        st_ml[(warp * 16 + gr + 8 * i) * 2 + 1] = l;
      }
    }
  }
  __syncthreads();
  const size_t part = ((size_t)bh * gridDim.y + split) * rows;
  for (int r = tid; r < rows; r += MMA_THREADS) {
    // a key group that saw no valid key has m = -1e30, l = 0, acc = 0: its
    // weight is 0 once M is finite, 1 when every group is empty
    const int w0 = r / 16, rr = r % 16;
    float M = NEG_INF;
#pragma unroll
    for (int j = 0; j < KG; ++j) M = fmaxf(M, st_ml[((j * MTP + w0) * 16 + rr) * 2]);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < KG; ++j) {
      const float* ml = st_ml + ((j * MTP + w0) * 16 + rr) * 2;
      const float w = expf(ml[0] - M);
      st_w[j * rows + r] = w;
      l += w * ml[1];
    }
    part_ml[(part + r) * 2] = M;
    part_ml[(part + r) * 2 + 1] = l;
  }
  __syncthreads();
  for (int i = tid; i < rows * DV; i += MMA_THREADS) {
    const int r = i / DV, d = i - r * DV, w0 = r / 16, rr = r % 16;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < KG; ++j)
      a += st_w[j * rows + r] * st_acc[((j * MTP + w0) * 16 + rr) * L::ALD + d];
    part_acc[(part + r) * DV + d] = a;
  }
}

// ------------------------------------------------------------------ merge

// Merge the splits of every (b, h) in split order: weights exp(m_s - M)
// against the largest split max M, staged once per (split, row) in shared
// memory, then acc / l with one output element per thread, 0 where no key
// was valid.  Grid (B*Hkv, ceil(rows*Dv / MERGE_THREADS)).
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS) decode_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out,               // (B, m, Hq, Dv)
    int Hkv, int m, int g, int n_split, int Dv) {
  extern __shared__ float msm[];
  const int bh = blockIdx.x, b = bh / Hkv, h = bh - b * Hkv;
  const int tid = threadIdx.x, rows = m * g;
  float* ml = msm;                      // n_split * rows * 2
  float* w = ml + 2 * n_split * rows;   // n_split * rows
  float* l_s = w + n_split * rows;      // rows
  const size_t base = (size_t)bh * n_split * rows;
  for (int i = tid; i < 2 * n_split * rows; i += MERGE_THREADS)
    ml[i] = part_ml[base * 2 + i];
  __syncthreads();
  for (int r = tid; r < rows; r += MERGE_THREADS) {
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[(s * rows + r) * 2]);
    // a split with no valid key has m = -1e30, l = 0, acc = 0: its weight
    // is 0 once M is finite, 1 when every split is empty -- either way it
    // adds exact zeros
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ws = expf(ml[(s * rows + r) * 2] - M);
      w[s * rows + r] = ws;
      l += ws * ml[(s * rows + r) * 2 + 1];
    }
    l_s[r] = l;
  }
  __syncthreads();
  const int i = blockIdx.y * MERGE_THREADS + tid;
  if (i >= rows * Dv) return;
  const int r = i / Dv, d = i - r * Dv;
  // eight splits' loads go out together; the sum stays in split order
  float a = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = s0 + j < n_split
                 ? part_acc[(base + (size_t)(s0 + j) * rows + r) * Dv + d]
                 : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s0 + j < n_split) a += w[(s0 + j) * rows + r] * x[j];
  }
  const float l = l_s[r];
  out[q_row(b, h, r, m, g, Hkv) * Dv + d] =
      from_f<T>(l > 0.f ? a / fmaxf(l, 1e-30f) : 0.f);
}

template <typename T>
cudaError_t launch_merge(const void* part_ml, const void* part_acc, void* out,
                         int B, int Hkv, int m, int g, int Dv, int n_split,
                         cudaStream_t stream) {
  const int rows = m * g;
  const size_t smem = (3 * (size_t)n_split * rows + rows) * sizeof(float);
  cudaError_t err = repro::allow_smem(decode_merge_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (rows * Dv + MERGE_THREADS - 1) / MERGE_THREADS);
  decode_merge_kernel<T><<<grid, MERGE_THREADS, smem, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), Hkv, m, g, n_split, Dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          const void* q_pos, const void* kv_pos, void* part_ml,
                          void* part_acc, void* out, int B, int Hkv, int C,
                          int m, int g, int Dk, int Dv, int n_split,
                          int split_len, int window, float scale,
                          cudaStream_t stream) {
  const size_t smem = scalar_smem(m * g, Dk, Dv);
  cudaError_t err = repro::allow_smem(decode_split_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T><<<dim3(B * Hkv, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), C, Hkv, m, g, Dk, Dv, split_len, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<T>(part_ml, part_acc, out, B, Hkv, m, g, Dv, n_split, stream);
}

using MmaKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                          const __nv_bfloat16*, const int*, const int*, float*,
                          float*, int, int, int, int, int, int, float);

// the instantiation for `rows` query rows: 4 key groups per tile at one
// m-tile, 2 x 2 at two, one warp per m-tile at three or four
template <int DK, int DV>
MmaKernel mma_kernel(int rows) {
  const int mtiles = (rows + 15) / 16;
  return mtiles == 1   ? decode_mma_kernel<DK, DV, 4>
         : mtiles == 2 ? decode_mma_kernel<DK, DV, 2>
                       : decode_mma_kernel<DK, DV, 1>;
}

template <int DK, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* q_pos, const void* kv_pos, void* part_ml,
                       void* part_acc, void* out, int B, int Hkv, int C, int m,
                       int g, int n_split, int split_len, int window,
                       float scale, cudaStream_t stream) {
  const MmaKernel kernel = mma_kernel<DK, DV>(m * g);
  const size_t smem =
      MmaSmem<DK, DV>::bytes((m * g + 15) / 16, (split_len + TILE - 1) / TILE);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * Hkv, n_split), MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), C, Hkv, m, g, split_len, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<__nv_bfloat16>(part_ml, part_acc, out, B, Hkv, m, g, DV,
                                     n_split, stream);
}

template <int DK, int DV>
cudaError_t mma_occupancy(int rows, int* blocks) {
  const MmaKernel kernel = mma_kernel<DK, DV>(rows);
  const size_t smem = MmaSmem<DK, DV>::bytes((rows + 15) / 16, LIST_TILES);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       MMA_THREADS, smem);
}

template <typename T>
cudaError_t scalar_occupancy(int rows, int Dk, int Dv, int* blocks) {
  const size_t smem = scalar_smem(rows, Dk, Dv);
  cudaError_t err = repro::allow_smem(decode_split_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_split_kernel<T>, THREADS, smem);
}

}  // namespace

// The instantiated (Dk, Dv) pairs of the tensor-core kernel: those of
// ops.MMA_HEAD_DIMS.  Any other pair is refused, never re-routed.
#define REPRO_DECODE_MMA_CASES      \
  REPRO_DECODE_MMA_CASE(128, 128)   \
  REPRO_DECODE_MMA_CASE(64, 32)     \
  REPRO_DECODE_MMA_CASE(96, 64)

// The bf16 tensor-core split kernel and the merge: two launches.
extern "C" int decode_attention_mma(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* part_ml, void* part_acc, void* out, int B,
    int Hkv, int C, int m, int g, int Dk, int Dv, int n_split, int split_len,
    int window, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_MMA_CASE(DK, DV)                                          \
  if (Dk == DK && Dv == DV)                                                    \
    return launch_mma<DK, DV>(q, k, v, q_pos, kv_pos, part_ml, part_acc, out,  \
                              B, Hkv, C, m, g, n_split, split_len, window,     \
                              scale, s);
  REPRO_DECODE_MMA_CASES
#undef REPRO_DECODE_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

// The scalar split kernel (dtype 0 = float32, 1 = bf16) and the merge: two
// launches.
extern "C" int decode_attention(
    int dtype, const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* part_ml, void* part_acc, void* out, int B,
    int Hkv, int C, int m, int g, int Dk, int Dv, int n_split, int split_len,
    int window, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scalar<float>(q, k, v, q_pos, kv_pos, part_ml, part_acc, out,
                                B, Hkv, C, m, g, Dk, Dv, n_split, split_len,
                                window, scale, s);
  if (dtype == 1)
    return launch_scalar<__nv_bfloat16>(q, k, v, q_pos, kv_pos, part_ml,
                                        part_acc, out, B, Hkv, C, m, g, Dk, Dv,
                                        n_split, split_len, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the split kernel a call of this shape launches
// (mma = 1: the tensor-core kernel), for the wrapper's split plan.
extern "C" int decode_attention_occupancy(int mma, int dtype, int Dk, int Dv,
                                          int rows, int* blocks) {
  if (mma) {
#define REPRO_DECODE_MMA_CASE(DK, DV) \
  if (Dk == DK && Dv == DV) return mma_occupancy<DK, DV>(rows, blocks);
    REPRO_DECODE_MMA_CASES
#undef REPRO_DECODE_MMA_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return scalar_occupancy<float>(rows, Dk, Dv, blocks);
  if (dtype == 1) return scalar_occupancy<__nv_bfloat16>(rows, Dk, Dv, blocks);
  return (int)cudaErrorInvalidValue;
}
