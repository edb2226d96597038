// Page-table-native decode attention for Hopper (sm_90a), split over the KV
// axis at logical-block boundaries.
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py
// (paged_attention_pallas).  For each (batch row b, kv head h) the m*g query
// rows that share kv head h (every decode/probe position times every GQA
// head of the group) attend over the row's mapped pages, read through the
// compacted page list: rank j < counts[b] holds logical block logical[b, j]
// in physical page pages[b, j], ranks ascending in logical block.
//
// What bounds it on the H100: bytes.  A call reads each mapped K/V page once
// per (row, kv head) and does m*g*4*D FLOPs per cached key -- under 16 FLOP
// per byte at decode widths.  One block per (row, kv head) walking every
// page of the row is 32 blocks at B 4 on 132 SMs: the KV axis is split.
//
// The split.  The grid is (B*Hkv, n_split); split s holds the ranks whose
// logical block lies in [s*K, (s+1)*K).  K depends on the page size alone
// (ops.split_plan), so a ring call (every logical block, unmapped ones fully
// masked) and a paged call (mapped blocks only) of one cache put the same
// non-identity pages into the same split, in the same order.  A fully masked
// page is an exact identity step (it is skipped outright, row by row), so
// each split's partial is bitwise the same on both sides, and so is the
// ordered merge: the serving stack's paged == ring contract
// (repro/kernels/paged_attention/ref.py) survives the split.
//
// The rounding points are the plain version's: q is scaled and rounded
// through T, each probability p = exp(s - m) is rounded through T before
// P.V, and m is the row's running max over every earlier page in logical
// order -- not the split's own max.  A split therefore cannot start from
// -inf.  Three launches:
//   paged_max_kernel   every score of the split's pages (kept in scratch)
//                      and the split's row max;
//   paged_fold_kernel  the online softmax over the split's pages from the
//                      max over splits < s, reading the kept scores and
//                      the V pages: the split's (m, l, acc);
//   paged_merge_kernel the splits of each (b, h) in split order, weights
//                      exp(m_s - M), written as (B, m, Hq, Dv).
// Each score is one FMA chain over d in ascending order, the order of the
// plain version's float32 product on this card, so the probabilities round
// to the same bf16 values: a score summed in another order can tip a
// probability across a rounding boundary, and with it the output by
// several bf16 ulps.
//
// Inside a split: 16-byte cp.async copies of each K page (max pass) or V
// page and its scores (fold) into shared memory, double-buffered, so page
// j+1 is in flight while page j is computed.  Scores: one thread per
// (query row, key).  Max, softmax: one warp per query row, a lane per key,
// shuffle trees.  P.V: the same warp, lanes over D, keys in order.  Every
// reduction has one fixed order that depends only on the page's contents,
// positions and q, never on its rank or its place in the split.

#include <limits.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::round_t;
using repro::to_f;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PS = 64;  // keys per page: two per lane in the softmax step
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;         // (B, m, Hq, Dk), Hq = Hkv * g
  const void* k_pool;    // (P, ps, Hkv, Dk)
  const void* v_pool;    // (P, ps, Hkv, Dv)
  const int* pages;      // (B, NBK)
  const int* logical;    // (B, NBK)
  const int* counts;     // (B,)
  const int* bpos;       // (B, NBK, ps)
  const int* q_pos;      // (B, m)
  float* split_max;      // (B*Hkv, n_split, rows)
  float* part_ml;        // (B*Hkv, n_split, rows, 2)
  float* part_acc;       // (B*Hkv, n_split, rows, Dv)
  float* scores;         // (B*Hkv, n_split, K, rows, ps), from the max pass
  int Hkv, m, g, Dk, Dv, ps, NBK, split_blocks, n_split, window;
  float scale;
};

// Byte offsets of the dynamic shared memory of the max pass (fold = false)
// or the fold; every section a multiple of 16 bytes (the wrapper requires
// D * sizeof(T) % 16 == 0).  K rows are padded by 16 bytes, so the threads
// of a warp reading 16 keys at one d spread over the banks.
struct Layout {
  int kld, kbuf, vbuf, qraw, qs, sc, acc, ml, qp, smx, pg, bp, live, end;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(const Params& p, int esize, bool fold) {
  const int rows = p.m * p.g;
  Layout s;
  int o = 0;
  s.kld = p.Dk + 16 / esize;
  s.kbuf = o; o += fold ? 0 : 2 * p.ps * s.kld * esize;
  s.vbuf = o; o += fold ? 2 * p.ps * p.Dv * esize : 0;
  s.qraw = o; o += fold ? 0 : rows * p.Dk * esize;
  s.qs = o;   o += fold ? 0 : rows * p.Dk * 4;
  s.sc = o;   o += align16((fold ? 2 : 1) * rows * p.ps * 4);
  s.acc = o;  o += fold ? rows * p.Dv * 4 : 0;
  s.ml = o;   o += align16(2 * rows * 4);
  s.qp = o;   o += align16(rows * 4);
  s.smx = o;  o += fold ? align16(p.n_split * rows * 4) : 0;
  s.pg = o;   o += align16(p.split_blocks * 4);
  s.bp = o;   o += align16(p.split_blocks * p.ps * 4);
  s.live = o; o += align16(p.split_blocks * 4);
  s.end = o;
  return s;
}

__device__ __forceinline__ bool key_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// The xor tree leaves the same bits on every lane (each add is a + b on one
// lane and b + a on its partner).
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// s + q[0..VEC) . k[0..VEC), one FMA at a time in ascending d; VEC is 16
// bytes of T, read with one shared load
__device__ __forceinline__ float dot16(float s, const float* q, const float* k) {
  const float4 kv = *reinterpret_cast<const float4*>(k);
  const float4 qv = *reinterpret_cast<const float4*>(q);
  s = fmaf(qv.x, kv.x, s);
  s = fmaf(qv.y, kv.y, s);
  s = fmaf(qv.z, kv.z, s);
  return fmaf(qv.w, kv.w, s);
}

__device__ __forceinline__ float dot16(float s, const float* q,
                                       const __nv_bfloat16* k) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 kv = __bfloat1622float2(k2[j]);
    const float2 qv = *reinterpret_cast<const float2*>(q + 2 * j);
    s = fmaf(qv.x, kv.x, s);
    s = fmaf(qv.y, kv.y, s);
  }
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy ps key rows of D elements (row stride `stride` elements) into shared
// rows `ld` elements apart, 16 bytes per cp.async.
template <typename T>
__device__ __forceinline__ void copy_page(T* dst, int ld, const T* src, int ps,
                                          int D, size_t stride, int tid) {
  const int chunks = D * (int)sizeof(T) / 16;
  constexpr int per = 16 / sizeof(T);
  for (int c = tid; c < ps * chunks; c += THREADS) {
    const int t = c / chunks, x = c - t * chunks;
    cp_async16(smem_u32(dst + t * ld + x * per), src + t * stride + x * per);
  }
}

// The split's ranks: j < counts[b] with logical[b, j] in [split*K,
// (split+1)*K) -- the list ascends, so they are the ranks [j0, j1).  Issues
// the cp.async copies of their physical pages and key positions and returns
// their number.
__device__ __forceinline__ int find_split(const Params& p, int b, int split,
                                          int tid, int* pg_s, int* bp_s) {
  const int n = min(p.counts[b], p.NBK);
  const int lo = split * p.split_blocks, hi = lo + p.split_blocks;
  int j0 = 0, j1 = 0;
  for (int base = 0; base < p.NBK; base += THREADS) {
    const int j = base + tid;
    const int lg = j < p.NBK ? p.logical[(size_t)b * p.NBK + j] : 0;
    j0 += __syncthreads_count(j < n && lg < lo);
    j1 += __syncthreads_count(j < n && lg < hi);
  }
  const int np = min(j1 - j0, p.split_blocks);  // distinct blocks: at most K
  for (int i = tid; i < np; i += THREADS)
    cp_async4(smem_u32(pg_s + i), p.pages + (size_t)b * p.NBK + j0 + i);
  for (int i = tid; i < np * p.ps; i += THREADS)
    cp_async4(smem_u32(bp_s + i), p.bpos + ((size_t)b * p.NBK + j0) * p.ps + i);
  return np;
}

// Warp 0: the split's pages on which some (query row, key) pair may be
// valid, in rank order, into live_s and their count into *n_live.  A page
// left out has every key masked for every row (an identity step).
__device__ __forceinline__ void live_pages(const Params& p, int np, int rows,
                                           const int* qp_s, const int* bp_s,
                                           int* live_s, int* n_live, int lane) {
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = lane; r < rows; r += 32) {
    qlo = min(qlo, qp_s[r]);
    qhi = max(qhi, qp_s[r]);
  }
  qlo = __reduce_min_sync(FULL, qlo);
  qhi = __reduce_max_sync(FULL, qhi);
  int cnt = 0;
  for (int base = 0; base < np; base += 32) {
    const int i = base + lane;
    bool live = false;
    for (int t = 0; i < np && t < p.ps; ++t) {
      const int kp = bp_s[i * p.ps + t];
      live |= kp >= 0 && kp <= qhi && (p.window == 0 || qlo - kp < p.window);
    }
    const unsigned bal = __ballot_sync(FULL, live);
    if (live) live_s[cnt + __popc(bal & ((1u << lane) - 1u))] = i;
    cnt += __popc(bal);
  }
  if (lane == 0) *n_live = cnt;
}

// p.scores of page i (rank j0 + i) of split `split` of (b, h) `bh`
__device__ __forceinline__ float* page_scores(const Params& p, int bh, int split,
                                              int i) {
  const int rows = p.m * p.g;
  return p.scores + (((size_t)bh * p.n_split + split) * p.split_blocks + i) *
                        rows * p.ps;
}

// The max pass, one split of one (b, h): every score of the split's live
// pages (kept in p.scores for the fold), and each row's max over them.
template <typename T>
__global__ void __launch_bounds__(THREADS) paged_max_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_live_s;
  const Layout L = layout(p, sizeof(T), false);
  T* kbuf = reinterpret_cast<T*>(smem + L.kbuf);
  T* qraw = reinterpret_cast<T*>(smem + L.qraw);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  int* qp_s = reinterpret_cast<int*>(smem + L.qp);
  int* pg_s = reinterpret_cast<int*>(smem + L.pg);
  int* bp_s = reinterpret_cast<int*>(smem + L.bp);
  int* live_s = reinterpret_cast<int*>(smem + L.live);

  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int g = p.g, rows = p.m * g, ps = p.ps, Dk = p.Dk, kld = L.kld;

  // q (row r: position r / g, q head h*g + r % g) and the query positions
  // go to shared memory asynchronously, while the block finds its ranks
  {
    const int chunks = Dk * (int)sizeof(T) / 16;
    constexpr int per = 16 / sizeof(T);
    const T* qb = static_cast<const T*>(p.q);
    for (int c = tid; c < rows * chunks; c += THREADS) {
      const int r = c / chunks, x = c - r * chunks;
      const size_t row = ((size_t)b * p.m + r / g) * p.Hkv * g + h * g + r % g;
      cp_async16(smem_u32(qraw + r * Dk + x * per), qb + row * Dk + x * per);
    }
  }
  for (int r = tid; r < rows; r += THREADS)
    cp_async4(smem_u32(qp_s + r), p.q_pos + (size_t)b * p.m + r / g);
  const int np = find_split(p, b, split, tid, pg_s, bp_s);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();

  // q scaled and rounded through T, as the plain version does
  const float scale_t = round_t<T>(p.scale);
  for (int i = tid; i < rows * Dk; i += THREADS)
    qs[i] = round_t<T>(to_f(qraw[i]) * scale_t);
  for (int r = tid; r < rows; r += THREADS) m_s[r] = NEG_INF;
  if (warp == 0) live_pages(p, np, rows, qp_s, bp_s, live_s, &n_live_s, lane);
  __syncthreads();
  const int n_live = n_live_s;

  const size_t kstride = (size_t)p.Hkv * Dk;
  auto issue = [&](int k) {
    const size_t page = (size_t)pg_s[live_s[k]] * ps * p.Hkv + h;
    copy_page(kbuf + (k & 1) * ps * kld, kld,
              static_cast<const T*>(p.k_pool) + page * Dk, ps, Dk, kstride, tid);
  };
  if (n_live > 0) issue(0);
  cp_async_commit();

  constexpr int VEC = 16 / sizeof(T);
  for (int k = 0; k < n_live; ++k) {
    if (k + 1 < n_live) issue(k + 1);
    cp_async_commit();
    cp_async_wait1();  // page k has landed
    __syncthreads();
    const T* kb = kbuf + (k & 1) * ps * kld;
    const int* kpp = bp_s + live_s[k] * ps;
    float* sg = page_scores(p, bh, split, live_s[k]);
    // one thread per (row, key), one FMA chain in ascending d; a masked
    // key's score is -1e30
    for (int i = tid; i < rows * ps; i += THREADS) {
      const int r = i / ps, t = i - r * ps;
      float s = NEG_INF;
      if (key_valid(kpp[t], qp_s[r], p.window)) {
        const float* qr = qs + r * Dk;
        const T* kr = kb + t * kld;
        s = 0.f;
        for (int d = 0; d < Dk; d += VEC) s = dot16(s, qr + d, kr + d);
      }
      sc[i] = s;
      sg[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += WARPS) {
      const float s0 = lane < ps ? sc[r * ps + lane] : NEG_INF;
      const float s1 = lane + 32 < ps ? sc[r * ps + lane + 32] : NEG_INF;
      const float m_new = fmaxf(m_s[r], warp_max(fmaxf(s0, s1)));
      __syncwarp();
      if (lane == 0) m_s[r] = m_new;
    }
    __syncthreads();  // buffer k & 1 is refilled by the next iteration's copy
  }
  const size_t part = ((size_t)bh * p.n_split + split) * rows;
  for (int r = tid; r < rows; r += THREADS) p.split_max[part + r] = m_s[r];
}

// The fold, one split of one (b, h): the online softmax over the split's
// live pages in rank order, from the max of the earlier splits and the max
// pass's scores, and the split's unnormalised partial (m, l, acc).  CPL:
// pairs of Dv elements per lane in P.V, ceil(Dv / 64).
template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS) paged_fold_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_live_s;
  const Layout L = layout(p, sizeof(T), true);
  T* vbuf = reinterpret_cast<T*>(smem + L.vbuf);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  int* qp_s = reinterpret_cast<int*>(smem + L.qp);
  float* smx = reinterpret_cast<float*>(smem + L.smx);
  int* pg_s = reinterpret_cast<int*>(smem + L.pg);
  int* bp_s = reinterpret_cast<int*>(smem + L.bp);
  int* live_s = reinterpret_cast<int*>(smem + L.live);

  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int g = p.g, rows = p.m * g, ps = p.ps, Dv = p.Dv;
  float* l_s = m_s + rows;

  for (int r = tid; r < rows; r += THREADS)
    cp_async4(smem_u32(qp_s + r), p.q_pos + (size_t)b * p.m + r / g);
  for (int i = tid; i < split * rows; i += THREADS)
    cp_async4(smem_u32(smx + i), p.split_max + (size_t)bh * p.n_split * rows + i);
  const int np = find_split(p, b, split, tid, pg_s, bp_s);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();

  // every row starts from the running max over the earlier splits
  for (int r = tid; r < rows; r += THREADS) {
    float m0 = NEG_INF;
    for (int s = 0; s < split; ++s) m0 = fmaxf(m0, smx[s * rows + r]);
    m_s[r] = m0;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < rows * Dv; i += THREADS) acc[i] = 0.f;
  if (warp == 0) live_pages(p, np, rows, qp_s, bp_s, live_s, &n_live_s, lane);
  __syncthreads();
  const int n_live = n_live_s;

  const int nsc = rows * ps;
  const size_t vstride = (size_t)p.Hkv * Dv;
  auto issue = [&](int k) {
    const size_t page = (size_t)pg_s[live_s[k]] * ps * p.Hkv + h;
    copy_page(vbuf + (k & 1) * ps * Dv, Dv,
              static_cast<const T*>(p.v_pool) + page * Dv, ps, Dv, vstride, tid);
    const float* sg = page_scores(p, bh, split, live_s[k]);
    for (int i = tid; i < nsc; i += THREADS)
      cp_async4(smem_u32(sc + (k & 1) * nsc + i), sg + i);
  };
  if (n_live > 0) issue(0);
  cp_async_commit();

  for (int k = 0; k < n_live; ++k) {
    if (k + 1 < n_live) issue(k + 1);
    cp_async_commit();
    cp_async_wait1();  // page k has landed
    __syncthreads();
    const T* vb = vbuf + (k & 1) * ps * Dv;
    const float* sk = sc + (k & 1) * nsc;
    const int* kpp = bp_s + live_s[k] * ps;
    const int kpos0 = lane < ps ? kpp[lane] : -1;
    const int kpos1 = lane + 32 < ps ? kpp[lane + 32] : -1;
    for (int r = warp; r < rows; r += WARPS) {
      const int qp = qp_s[r];
      const bool val0 = key_valid(kpos0, qp, p.window);
      const bool val1 = key_valid(kpos1, qp, p.window);
      const unsigned vm0 = __ballot_sync(FULL, val0), vm1 = __ballot_sync(FULL, val1);
      if (!(vm0 | vm1)) continue;  // every key masked for this row: identity
      const float sc0 = val0 ? sk[r * ps + lane] : NEG_INF;
      const float sc1 = val1 ? sk[r * ps + lane + 32] : NEG_INF;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sc0, sc1)));
      // probabilities: a masked p is exactly 0; l sums the unrounded p, P.V
      // takes p rounded through T
      const float e0 = val0 ? expf(sc0 - m_new) : 0.f;
      const float e1 = val1 ? expf(sc1 - m_new) : 0.f;
      const float lsum = warp_sum(e0 + e1);
      const float p0 = round_t<T>(e0), p1 = round_t<T>(e1);
      const float alpha = expf(m_prev - m_new);
      // P.V: lanes over Dv, one FMA chain per element over the keys in order
      float2 pv[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) pv[c] = make_float2(0.f, 0.f);
      for (int t = 0; t < ps; ++t) {
        if (!(((t < 32 ? vm0 : vm1) >> (t & 31)) & 1u)) continue;
        const float pt = __shfl_sync(FULL, t < 32 ? p0 : p1, t & 31);
        const T* vr = vb + t * Dv;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int d = 2 * (lane + 32 * c);
          if (d < Dv) {
            const float2 vv = load2(vr + d);
            pv[c].x = fmaf(pt, vv.x, pv[c].x);
            pv[c].y = fmaf(pt, vv.y, pv[c].y);
          }
        }
      }
      float* ar = acc + r * Dv;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = 2 * (lane + 32 * c);
        if (d < Dv) {
          float2 a = load2(ar + d);
          a.x = a.x * alpha + pv[c].x;
          a.y = a.y * alpha + pv[c].y;
          *reinterpret_cast<float2*>(ar + d) = a;
        }
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + lsum;
      }
    }
    __syncthreads();  // buffer k & 1 is refilled by the next iteration's copy
  }

  const size_t part = ((size_t)bh * p.n_split + split) * rows;
  for (int r = tid; r < rows; r += THREADS) {
    p.part_ml[(part + r) * 2] = m_s[r];
    p.part_ml[(part + r) * 2 + 1] = l_s[r];
  }
  for (int i = tid; i < rows * Dv; i += THREADS) p.part_acc[part * Dv + i] = acc[i];
}

// Merge the splits of every (b, h) in split order: weights exp(m_s - M)
// against the largest split max M, then acc / l, 0 where no key was valid,
// written to out (B, m, Hq, Dv).  A split that folded no key has l = 0 and
// acc = 0: it adds exact zeros.  Grid (B*Hkv, ceil(rows*Dv / THREADS)): one
// output element per thread.  The splits' (m, l) are staged in shared
// memory and each row's weights and sum computed once per block.
template <typename T>
__global__ void __launch_bounds__(THREADS) paged_merge_kernel(const Params p,
                                                              T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int tid = threadIdx.x, g = p.g, rows = p.m * g, Dv = p.Dv;
  const int n_split = p.n_split;
  float* ml = reinterpret_cast<float*>(smem);  // n_split * rows * 2
  float* w = ml + 2 * n_split * rows;          // n_split * rows
  float* l_s = w + n_split * rows;             // rows
  const size_t base = (size_t)bh * n_split * rows;
  for (int i = tid; i < 2 * n_split * rows; i += THREADS) ml[i] = p.part_ml[base * 2 + i];
  __syncthreads();
  for (int r = tid; r < rows; r += THREADS) {
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[(s * rows + r) * 2]);
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ws = expf(ml[(s * rows + r) * 2] - M);
      w[s * rows + r] = ws;
      l += ws * ml[(s * rows + r) * 2 + 1];
    }
    l_s[r] = l;
  }
  __syncthreads();
  const int i = blockIdx.y * THREADS + tid;
  if (i >= rows * Dv) return;
  const int r = i / Dv, d = i - r * Dv;
  // eight splits' loads go out together; the sum stays in split order
  float a = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = s0 + j < n_split
                 ? p.part_acc[(base + (size_t)(s0 + j) * rows + r) * Dv + d]
                 : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s0 + j < n_split) a += w[(s0 + j) * rows + r] * v[j];
  }
  const float l = l_s[r];
  const size_t row = ((size_t)b * p.m + r / g) * p.Hkv * g + h * g + r % g;
  out[row * Dv + d] = from_f<T>(l > 0.f ? a / fmaxf(l, 1e-30f) : 0.f);
}

template <typename T, int CPL>
cudaError_t launch(const Params& p, void* out, int B, cudaStream_t stream) {
  const dim3 grid(B * p.Hkv, p.n_split);
  const size_t s_max = layout(p, sizeof(T), false).end;
  const size_t s_fold = layout(p, sizeof(T), true).end;
  const size_t s_merge = (size_t)(3 * p.n_split + 1) * p.m * p.g * sizeof(float);
  cudaError_t err = repro::allow_smem(paged_max_kernel<T>, s_max);
  if (err == cudaSuccess) err = repro::allow_smem(paged_fold_kernel<T, CPL>, s_fold);
  if (err == cudaSuccess) err = repro::allow_smem(paged_merge_kernel<T>, s_merge);
  if (err != cudaSuccess) return err;
  paged_max_kernel<T><<<grid, THREADS, s_max, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  paged_fold_kernel<T, CPL><<<grid, THREADS, s_fold, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 merge_grid(B * p.Hkv, (p.m * p.g * p.Dv + THREADS - 1) / THREADS);
  paged_merge_kernel<T><<<merge_grid, THREADS, s_merge, stream>>>(
      p, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cpl(const Params& p, void* out, int B, cudaStream_t stream) {
  if (p.Dv <= 64) return launch<T, 1>(p, out, B, stream);
  if (p.Dv <= 128) return launch<T, 2>(p, out, B, stream);
  if (p.Dv <= 256) return launch<T, 4>(p, out, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* pages, const void* logical, const void* counts,
    const void* bpos, const void* q_pos, void* split_max, void* part_ml,
    void* part_acc, void* scores, void* out, int B, int Hkv, int m, int g,
    int Dk, int Dv, int ps, int NBK, int split_blocks, int n_split, int window,
    float scale, void* stream) {
  if (ps < 1 || ps > MAX_PS || split_blocks < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  Params p{q, k_pool, v_pool,
           static_cast<const int*>(pages), static_cast<const int*>(logical),
           static_cast<const int*>(counts), static_cast<const int*>(bpos),
           static_cast<const int*>(q_pos), static_cast<float*>(split_max),
           static_cast<float*>(part_ml), static_cast<float*>(part_acc),
           static_cast<float*>(scores), Hkv, m, g, Dk, Dv, ps, NBK,
           split_blocks, n_split, window, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cpl<float>(p, out, B, s);
  if (dtype == 1) return launch_cpl<__nv_bfloat16>(p, out, B, s);
  return (int)cudaErrorInvalidValue;
}
