// Masked GQA flash attention with explicit integer positions, for Hopper
// (sm_90a).  The prefill attention of the serving path.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas).  Semantics are the reference's: a key is valid
// when its position is >= 0, and (causal) not after the query's position,
// and (window > 0) less than `window` positions behind it.  q head h reads
// kv head h / g.  Dv may differ from Dk.  Rows with no valid key give 0.
//
// Four kernels, chosen by the wrapper's rule (ops.flash_variant):
//
// * flash_mma_kernel: bfloat16 at the head dims instantiated below, on the
//   tensor cores (mma.sync.m16n8k16, bf16 in, float32 accumulate).  One
//   block of 4 warps per (64-query tile, q head, batch row); q tiles run
//   longest-first.  Each warp holds its 16 query rows of q as register
//   A-fragments.  K/V tiles of 64 keys are double-buffered in shared memory
//   by 16-byte cp.async copies (rows padded by 16 bytes, so ldmatrix reads
//   without bank conflicts) while the previous tile is computed.  S = Q K^T
//   stays in registers; the online softmax runs there (row statistics
//   across the 4 threads of a quad), and P is re-packed from the S
//   accumulators into the A-fragments of P V (the C layout of m16n8 is the
//   A layout of m16n8k16), with V fragments from ldmatrix.trans.
// * flash_mla_kernel (+ flash_mla_merge_kernel at decode): bfloat16 at
//   MLA's absorbed pairs (Dk, Dv) = (kv_lora + rope, kv_lora) instantiated
//   below: 128 q heads against ONE kv head of 576, V the first 512 columns
//   of K (the latent c of cat(c, kr)).  Described below.
// * flash_wide_kernel: bfloat16 at head dims above 128 instantiated below
//   (Gemma's (256, 256)), on the tensor cores.  Described below.
// * flash_kernel: the first, scalar kernel: float32 FMAs from shared
//   memory.  It serves float32 (the tensor cores would compute in TF32,
//   about 3 decimal digits, short of the 1e-5 float32 bar) and bf16 head
//   dims outside the instantiated sets (MLA's expanded 192/128 among them).
//
// The wide kernel.  flash_mma_kernel keeps a warp's 16 rows of q as
// register A-fragments and a 16 x Dv float32 accumulator: at 256 that is
// 64 + 128 registers a thread before S, P and the addresses, past what a
// thread holds without spilling.  Two layouts were open: (i) that kernel's
// 4 warps of 16 query rows, each warp the whole Dv, with the q tile staged
// in shared memory and read by ldmatrix at every k-step (flash_mla_kernel
// reads its q so), or (ii) flash_mla_kernel's 8 warps as 4 row groups x 2
// column halves, which must either compute S twice (at Dk = Dv that is
// 1.5x the products) or trade probabilities and row statistics through
// shared memory behind a barrier per tile.  This is (i): one S per row, no
// exchange, 128 accumulator registers a thread as flash_mla_kernel holds
// them.  The 64 x 256 q tile is 33,792 B with 16-byte row padding; K and V
// come in separate 32-key tiles (16,896 B each, padded), double-buffered
// by 16-byte cp.async, 101.6 KB in all: two blocks (8 warps) per SM.  A
// block is 64 queries of one q head, so at g > 1 (gemma-2b: 8 q heads on
// one kv head) each kv head's tiles are read g times, from L2 after the
// first.  What bounds it on the H100, at gemma-7b's prefill (B 4, S 512,
// 16 q and 16 kv heads of 256, left-padded): bytes.  q/k/v/out are 67.1 MB
// (0.020 ms at 3.35 TB/s) against 357k valid causal pairs per head x 16 x
// 4 x 256 = 5.85 GFLOP (0.006 ms at 989 TFLOP/s); mma.sync with q re-read
// from shared memory at every k-step runs well below that peak, so the
// products, not the bytes, are what a faster (wgmma/TMA) version would
// have to move.
//
// The MLA kernel.  flash_mma_kernel's block is 64 queries of one q head:
// at MLA's shape each block would read every key tile of the one shared kv
// head for itself, 128 times over, and a decode (m 1) would fill one row
// in 64.  So rows of a block are (query position, q head) pairs of one kv
// head, as decode_mma_kernel takes rows = m * g: 64 consecutive rows, i.e.
// 64 heads of one position at g = 128, and each key tile is read once for
// them.  The 64 x 576 q tile stays in shared memory (74,752 B with 16-byte
// row padding; in registers it would not fit beside the accumulator); 32-key
// K tiles are double-buffered by cp.async (37,376 B each), 149.5 KB in all,
// one block per SM.  V is not loaded: P V reads the K tile's first 512
// columns again through ldmatrix.trans, so the op takes v only as the view
// k[..., :Dv] (ops.flash_attention_cuda checks it).  The 64 x 512 float32
// accumulator is 128 KB of registers: 8 warps, 4 row groups of 16 rows x 2
// column halves of 256, 128 accumulator registers a thread (FlashMLA's
// layout of a 64-row tile).  The two warps of a row group both compute S =
// Q K^T for their rows (one FMA order, the same bits), which doubles the QK
// products (1.5x the MMA work) but needs no exchange of row statistics or
// probabilities through shared memory and no barrier between them.
// At decode (m 1, B 4: 8 row tiles for 132 SMs) the keys are split: the
// wrapper asks for splits of MLA_SPLIT_KEYS keys (a fixed multiple of the
// key tile, never derived from Skv) whenever the grid has fewer row tiles
// than the card has SMs, a rule of B, m and the heads alone; each split
// writes its unnormalised (m, l, acc) rows and flash_mla_merge_kernel folds
// them in increasing split order.  Splits and tiles are aligned at key 0,
// and an empty tile or split is an exact identity step, so a gathered paged
// view and a ring of another length give the same bits (see below).
// What bounds it on the H100: bytes.  The cohort prefill (B 4, m 512, 128
// heads, 357,184 valid causal pairs): q and out are 570 MB (0.17 ms at 3.35
// TB/s) against 99.5 GFLOP (0.10 ms at 989 TFLOP/s; mma.sync with S computed
// twice runs at well under half of that, so in practice the products bound
// it: the design keeps each block's products on the tensor cores with the K
// tile read once per 64 rows).  A decode (m 1 over 704 slots): 4.4 MB of q,
// the latent cache and out, 0.0013 ms, where launch latency and the split
// count decide.
//
// Each kernel rounds where the plain version rounds: q times the bf16-rounded
// scale, rounded to the storage type; float32 scores, masked to -1e30
// before the row max; p = exp(s - m) in float32 (exactly 0 where masked),
// summed unrounded into l; p rounded to the storage type for P V; float32
// acc rescaled by exp(m_prev - m_new); acc / l rounded, 0 where l == 0.
//
// Bitwise independence of trailing masked key slots (paged == ring serves
// rest on it): kv tiles are aligned at key 0, and a tile in which no pair
// of the block is valid is an exact identity step (p = 0, alpha = 1), so
// skipping it, or visiting it, leaves the state unchanged bit for bit.
// Each kernel skips the tiles it can prove empty before loading them (the
// upper triangle of a causal prefill); the mma kernel lists its tiles once
// before the loop, from the block's smallest and largest query position,
// so its copies can run one tile ahead.
//
// What bounds it on the H100, at the main path's prefill (B 4, S 512, Hq
// 32, Hkv 8, D 128, left-padded): bytes.  The valid causal pairs are 357k
// per head; 357k x 32 heads x 4 x 128 = 5.85 GFLOP, 0.0059 ms at 989 bf16
// TFLOP/s, against 41.9 MB of q/k/v/positions/out, 0.0125 ms at 3.35 TB/s.
// mma.sync at half the tensor cores' peak is under the byte bound, so the
// mma kernel is built to keep the copies in flight (cp.async one tile
// ahead, two blocks per SM) rather than on wgmma/TMA.

#include <climits>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::round_t;
using repro::to_f;

constexpr int THREADS = 128;
constexpr int BQ = 16;
constexpr int BKV = 32;

__device__ __forceinline__ bool is_valid(int qp, int kp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window == 0 || qp - kp < window);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q,          // (B, Sq, Hq, Dk)
    const T* __restrict__ k,          // (B, Skv, Hkv, Dk)
    const T* __restrict__ v,          // (B, Skv, Hkv, Dv)
    const int* __restrict__ q_pos,    // (B, Sq)
    const int* __restrict__ kv_pos,   // (B, Skv)
    T* __restrict__ out,              // (B, Sq, Hq, Dv)
    int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv, int causal, int window,
    float scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int ldk = Dk + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ * Dk
  float* ks = qs + BQ * Dk;          // BKV * ldk
  float* vs = ks + BKV * ldk;        // BKV * Dv
  float* p_s = vs + BKV * Dv;        // BQ * BKV: scores, then probabilities
  float* acc = p_s + BQ * BKV;       // BQ * Dv
  float* m_s = acc + BQ * Dv;        // BQ
  float* l_s = m_s + BQ;             // BQ
  float* alpha_s = l_s + BQ;         // BQ
  int* qp_s = reinterpret_cast<int*>(alpha_s + BQ);  // BQ
  int* kp_s = qp_s + BQ;                             // BKV

  const float scale_t = round_t<T>(scale);
  for (int i = tid; i < BQ * Dk; i += THREADS) {
    const int r = i / Dk, d = i - r * Dk, qi = q0 + r;
    qs[i] = qi < Sq
        ? round_t<T>(to_f(q[(((size_t)b * Sq + qi) * Hq + h) * Dk + d]) * scale_t)
        : 0.f;
  }
  for (int i = tid; i < BQ * Dv; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    qp_s[r] = q0 + r < Sq ? q_pos[(size_t)b * Sq + q0 + r] : -1;
  }
  __syncthreads();

  for (int k0 = 0; k0 < Skv; k0 += BKV) {
    for (int c = tid; c < BKV; c += THREADS)
      kp_s[c] = k0 + c < Skv ? kv_pos[(size_t)b * Skv + k0 + c] : -1;
    __syncthreads();
    int any = 0;
    for (int i = tid; i < BQ * BKV; i += THREADS) {
      const int r = i / BKV, c = i - r * BKV;
      any |= (q0 + r < Sq) && is_valid(qp_s[r], kp_s[c], causal, window);
    }
    if (!__syncthreads_or(any)) continue;  // identity step: skip the tile

    for (int i = tid; i < BKV * Dk; i += THREADS) {
      const int c = i / Dk, d = i - c * Dk, ki = k0 + c;
      ks[c * ldk + d] =
          ki < Skv ? to_f(k[(((size_t)b * Skv + ki) * Hkv + hk) * Dk + d]) : 0.f;
    }
    for (int i = tid; i < BKV * Dv; i += THREADS) {
      const int c = i / Dv, d = i - c * Dv, ki = k0 + c;
      vs[i] = ki < Skv ? to_f(v[(((size_t)b * Skv + ki) * Hkv + hk) * Dv + d]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < BQ * BKV; i += THREADS) {
      const int r = i / BKV, c = i - r * BKV;
      float s = 0.f;
      for (int d = 0; d < Dk; ++d) s += qs[r * Dk + d] * ks[c * ldk + d];
      p_s[i] = is_valid(qp_s[r], kp_s[c], causal, window) ? s : NEG_INF;
    }
    __syncthreads();

    for (int r = tid; r < BQ; r += THREADS) {
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int c = 0; c < BKV; ++c) m_new = fmaxf(m_new, p_s[r * BKV + c]);
      float lsum = 0.f;
      for (int c = 0; c < BKV; ++c) {
        const float p = is_valid(qp_s[r], kp_s[c], causal, window)
                            ? expf(p_s[r * BKV + c] - m_new) : 0.f;
        lsum += p;
        p_s[r * BKV + c] = round_t<T>(p);
      }
      const float alpha = expf(m_prev - m_new);
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + lsum;
      alpha_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < BQ * Dv; i += THREADS) {
      const int r = i / Dv, d = i - r * Dv;
      float pv = 0.f;
      for (int c = 0; c < BKV; ++c) pv += p_s[r * BKV + c] * vs[c * Dv + d];
      acc[i] = acc[i] * alpha_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < BQ * Dv; i += THREADS) {
    const int r = i / Dv, d = i - r * Dv, qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = l_s[r];
    out[(((size_t)b * Sq + qi) * Hq + h) * Dv + d] =
        from_f<T>(l > 0.f ? acc[i] / fmaxf(l, 1e-30f) : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, void* out, int B,
                   int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
                   int causal, int window, float scale, cudaStream_t stream) {
  const size_t floats = (size_t)BQ * Dk + (size_t)BKV * (Dk + 1) +
                        (size_t)BKV * Dv + (size_t)BQ * BKV + (size_t)BQ * Dv +
                        3 * (size_t)BQ;
  const size_t smem = floats * sizeof(float) + (size_t)(BQ + BKV) * sizeof(int);
  cudaError_t err = repro::allow_smem(flash_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(out), Sq, Skv, Hq, Hkv,
      Dk, Dv, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ mma
// The bf16 tensor-core kernel.  Fragment layouts are those of PTX's
// m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and g + 8 at
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B holds column g at rows 2t, 2t + 1
// and 2t + 8, 2t + 9; C holds rows g and g + 8 at columns 2t, 2t + 1.

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int MMA_BQ = 64;
constexpr int MMA_BKV = 64;
constexpr int PAD = 8;            // bf16 of padding per shared row: 16 bytes
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros (a key past Skv)
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

// One key tile of the online softmax on the S accumulators of a warp's 16
// rows (this thread's rows g and g + 8, columns 2t, 2t + 1 of each n8
// tile): scores of invalid pairs masked to -1e30 before the row max (taken
// across the quad), p = exp(s - m_new) in float32, exactly 0 where masked,
// left in s; l and the accumulator o rescaled by exp(m_prev - m_new).  A
// tile without a valid pair leaves m, l and o as they were, bit for bit.
template <int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], float (&o)[NO][4],
                                             float (&m_run)[2], float (&l_run)[2],
                                             const int (&qp)[2], const int* kp, int t,
                                             int causal, int window) {
  uint32_t valid = 0;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (is_valid(qp[e >> 1], kp[n * 8 + 2 * t + (e & 1)], causal, window))
        valid |= 1u << (n * 4 + e);
      else
        s[n][e] = NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
  float alpha[2], m_new[2], lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
    m_new[i] = fmaxf(m_run[i], mx[i]);
    alpha[i] = expf(m_run[i] - m_new[i]);
    m_run[i] = m_new[i];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = (valid >> (n * 4 + e)) & 1u ? expf(s[n][e] - m_new[e >> 1]) : 0.f;
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
}

template <int DK, int DV>
struct MmaSmem {
  static constexpr int QLD = (DK > DV ? DK : DV) + PAD;  // q tile, then output
  static constexpr int KLD = DK + PAD;
  static constexpr int VLD = DV + PAD;
  static constexpr size_t Q_BYTES = (size_t)MMA_BQ * QLD * 2;
  static constexpr size_t K_BYTES = (size_t)MMA_BKV * KLD * 2;  // per buffer
  static constexpr size_t V_BYTES = (size_t)MMA_BKV * VLD * 2;
  // q | K[2] | V[2] | key positions [2][64] | qmin, qmax x 2, count | tiles
  static size_t bytes(int n_tiles) {
    return Q_BYTES + 2 * K_BYTES + 2 * V_BYTES +
           (2 * MMA_BKV + 5 + (size_t)n_tiles) * sizeof(int);
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(MMA_THREADS) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Sq, Hq, DK)
    const __nv_bfloat16* __restrict__ k,  // (B, Skv, Hkv, DK)
    const __nv_bfloat16* __restrict__ v,  // (B, Skv, Hkv, DV)
    const int* __restrict__ q_pos,        // (B, Sq)
    const int* __restrict__ kv_pos,       // (B, Skv)
    __nv_bfloat16* __restrict__ out,      // (B, Sq, Hq, DV)
    int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale) {
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DK <= 128 && DV <= 128,
                "head dims are multiples of 16 up to 128");
  using L = MmaSmem<DK, DV>;
  constexpr int KS = DK / 16;        // k-steps of S = Q K^T
  constexpr int NS = MMA_BKV / 8;    // n8 tiles of S
  constexpr int NO = DV / 8;         // n8 tiles of the output

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MMA_BQ;  // longest rows first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (Skv + MMA_BKV - 1) / MMA_BKV;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q_BYTES);
  __nv_bfloat16* vs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q_BYTES + 2 * L::K_BYTES);
  int* kp_s = reinterpret_cast<int*>(smem_raw + L::Q_BYTES + 2 * L::K_BYTES +
                                     2 * L::V_BYTES);  // [2][MMA_BKV]
  int* red = kp_s + 2 * MMA_BKV;  // qmin, qmax of warps 0 and 1, tile count
  int* tiles = red + 5;           // [n_tiles]

  // ---- the raw q tile, in flight while the block lists its kv tiles
  // (rows past Sq are zero)
  for (int c = tid; c < MMA_BQ * DK / 8; c += MMA_THREADS) {
    const int r = c / (DK / 8), d = (c % (DK / 8)) * 8, qi = q0 + r;
    cp_async16(smem_u32(qs + r * L::QLD + d),
               q + (((size_t)b * Sq + min(qi, Sq - 1)) * Hq + h) * DK + d,
               qi < Sq ? 16 : 0);
  }
  cp_async_commit();

  // ---- the block's smallest and largest query position (rows below Sq)
  {
    int lo = INT_MAX, hi = INT_MIN;
    if (tid < MMA_BQ && q0 + tid < Sq) lo = hi = q_pos[(size_t)b * Sq + q0 + tid];
    lo = __reduce_min_sync(FULL_MASK, lo);
    hi = __reduce_max_sync(FULL_MASK, hi);
    if (lane == 0 && warp < MMA_BQ / 32) {
      red[2 * warp] = lo;
      red[2 * warp + 1] = hi;
    }
  }
  for (int i = tid; i < n_tiles; i += MMA_THREADS) tiles[i] = 0;
  __syncthreads();

  // ---- the kv tiles this block visits: those holding a key that some
  // query of the block may attend, by the block's smallest and largest
  // position (conservative: a visited tile without a valid pair is an
  // exact identity step)
  {
    const int qmin = min(red[0], red[2]), qmax = max(red[1], red[3]);
    for (int i = tid; i < Skv; i += MMA_THREADS) {
      const int kp = kv_pos[(size_t)b * Skv + i];
      if (kp >= 0 && (!causal || kp <= qmax) && (window == 0 || qmin - kp < window))
        tiles[i / MMA_BKV] = 1;
    }
  }
  cp_async_wait<0>();  // the q tile
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (tiles[i]) tiles[n++] = i;
    red[4] = n;
  }
  __syncthreads();
  const int n_visit = red[4];

  // ---- q A-fragments, each warp its 16 rows at every k-step: q times the
  // bf16-rounded scale, rounded to bf16, as the plain version does
  uint32_t qa[KS][4];
  {
    const float scale_t = round_t<__nv_bfloat16>(scale);
    const int r = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int d = (lane >> 4) * 8;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      ldmatrix_x4(qa[st], smem_u32(qs + r * L::QLD + st * 16 + d));
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // a bf16 is the top half of its float32
        const uint32_t x = qa[st][j];
        qa[st][j] = pack_bf16(__uint_as_float(x << 16) * scale_t,
                              __uint_as_float(x & 0xffff0000u) * scale_t);
      }
    }
  }
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qp[i] = row0 + 8 * i < Sq ? q_pos[(size_t)b * Sq + row0 + 8 * i] : -1;
  const bool active = q0 + warp * 16 < Sq;  // the warp has a row below Sq

  // one kv tile into buffer `buf`: K, V and the key positions (keys past
  // Skv are zero with position -1)
  auto issue = [&](int tile, int buf) {
    const int k0 = tile * MMA_BKV;
    const uint32_t kdst = smem_u32(ks + buf * (L::K_BYTES / 2));
    const uint32_t vdst = smem_u32(vs + buf * (L::V_BYTES / 2));
#pragma unroll
    for (int c = tid; c < MMA_BKV * DK / 8; c += MMA_THREADS) {
      const int r = c / (DK / 8), d = (c % (DK / 8)) * 8, ki = k0 + r;
      const __nv_bfloat16* src =
          k + (((size_t)b * Skv + min(ki, Skv - 1)) * Hkv + hk) * DK + d;
      cp_async16(kdst + (r * L::KLD + d) * 2, src, ki < Skv ? 16 : 0);
    }
#pragma unroll
    for (int c = tid; c < MMA_BKV * DV / 8; c += MMA_THREADS) {
      const int r = c / (DV / 8), d = (c % (DV / 8)) * 8, ki = k0 + r;
      const __nv_bfloat16* src =
          v + (((size_t)b * Skv + min(ki, Skv - 1)) * Hkv + hk) * DV + d;
      cp_async16(vdst + (r * L::VLD + d) * 2, src, ki < Skv ? 16 : 0);
    }
    if (tid < MMA_BKV) {
      int* dst = kp_s + buf * MMA_BKV + tid;
      if (k0 + tid < Skv)
        cp_async4(smem_u32(dst), kv_pos + (size_t)b * Skv + k0 + tid);
      else
        *dst = -1;
    }
    cp_async_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  if (n_visit > 0) issue(tiles[0], 0);
  for (int it = 0; it < n_visit; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_visit) {  // the next tile's copies overlap this tile
      issue(tiles[it + 1], buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const __nv_bfloat16* kb = ks + buf * (L::K_BYTES / 2);
      const __nv_bfloat16* vb = vs + buf * (L::V_BYTES / 2);
      const int* kp = kp_s + buf * MMA_BKV;

      // S = Q K^T; one ldmatrix.x4 gives the B-fragments of two n8 tiles
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

      softmax_tile(s, o, m_run, l_run, qp, kp, t, causal, window);

      // O += P V: the S accumulators of n8 tiles 2j and 2j + 1, rounded to
      // bf16, are the A-fragment of k-step j; one ldmatrix.x4.trans gives
      // V's B-fragments of two n8 tiles of the output
      {
        const int key = ((lane >> 3) & 1) * 8 + (lane & 7);
        const int d = (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                  pack_bf16(s[2 * j][2], s[2 * j][3]),
                                  pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                  pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, smem_u32(vb + (j * 16 + key) * L::VLD + np * 16 + d));
            mma_bf16(o[2 * np], pa, bf[0], bf[1]);
            mma_bf16(o[2 * np + 1], pa, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies refill this buffer
  }

  // ---- acc / l, 0 where no key was valid, staged through this warp's own
  // rows of the q tile for 16-byte stores
  if (!active) return;
  float l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(FULL_MASK, l, 1);
    l += __shfl_xor_sync(FULL_MASK, l, 2);
    l_row[i] = l;
  }
  __nv_bfloat16* stage = qs + warp * 16 * L::QLD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float den = fmaxf(l_row[i], 1e-30f);
      const float x0 = l_row[i] > 0.f ? o[n][2 * i] / den : 0.f;
      const float x1 = l_row[i] > 0.f ? o[n][2 * i + 1] / den : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * i) * L::QLD + n * 8 + 2 * t) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * DV / 8; c += 32) {
    const int r = c / (DV / 8), d = (c % (DV / 8)) * 8, qi = q0 + warp * 16 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qi) * Hq + h) * DV + d) =
          *reinterpret_cast<const uint4*>(stage + r * L::QLD + d);
  }
}

template <int DK, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* q_pos, const void* kv_pos, void* out, int B,
                       int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                       float scale, cudaStream_t stream) {
  const size_t smem = MmaSmem<DK, DV>::bytes((Skv + MMA_BKV - 1) / MMA_BKV);
  cudaError_t err = repro::allow_smem(flash_mma_kernel<DK, DV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + MMA_BQ - 1) / MMA_BQ);
  flash_mma_kernel<DK, DV><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<__nv_bfloat16*>(out), Sq, Skv,
      Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ mla
// The bf16 tensor-core kernel for MLA's absorbed attention (see the header).
// Rows of a block are (query position, q head) pairs of one kv head: row r
// of the m * g rows of (b, kv head) is position r / g, q head hk * g + r % g.
// Warp w owns rows 16 (w % 4) .. + 16 and output columns (w / 4) * DV / 2 ..
// + DV / 2; the two warps of a row group compute the same S for their rows
// (one FMA order: the same bits), so each has every p of its rows in
// registers without an exchange through shared memory.  V is K's first DV
// columns: the K tile in shared memory is read again, transposed, for P V.

constexpr int MLA_THREADS = 256;     // 8 warps: 4 row groups x 2 column halves
constexpr int MLA_BM = 64;           // rows per block
constexpr int MLA_BN = 32;           // keys per K tile
constexpr int MLA_SPLIT_KEYS = 64;   // keys per split (ops.MLA_SPLIT_KEYS)
constexpr int MLA_MERGE_WARPS = 8;   // merge: one row per warp

template <int DK>
struct MlaSmem {
  static constexpr int LD = DK + PAD;  // q tile (then the output), K tiles
  static constexpr size_t Q_BYTES = (size_t)MLA_BM * LD * 2;
  static constexpr size_t K_BYTES = (size_t)MLA_BN * LD * 2;  // per buffer
  // q | K[2] | key positions [2][MLA_BN] | qmin, qmax x 2, count | tiles
  static size_t bytes(int n_tiles) {
    return Q_BYTES + 2 * K_BYTES + (2 * MLA_BN + 5 + (size_t)n_tiles) * sizeof(int);
  }
};

// part_acc == nullptr: the whole key range, acc / l written to out (bf16).
// Otherwise blockIdx.z is a split of MLA_SPLIT_KEYS keys, and the block
// writes its unnormalised (m, l, acc) rows to part_ml / part_acc at
// [(b * Hkv + hk) * n_split + split] * rows + r for flash_mla_merge_kernel.
template <int DK, int DV>
__global__ void __launch_bounds__(MLA_THREADS, 1) flash_mla_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Sq, Hq, DK)
    const __nv_bfloat16* __restrict__ k,  // (B, Skv, Hkv, DK); V = k[..., :DV]
    const int* __restrict__ q_pos,        // (B, Sq)
    const int* __restrict__ kv_pos,       // (B, Skv)
    __nv_bfloat16* __restrict__ out,      // (B, Sq, Hq, DV)
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale) {
  static_assert(DK % 16 == 0 && DV % 32 == 0 && DV <= DK,
                "DK a multiple of 16, DV of 32, V inside K's row");
  using L = MlaSmem<DK>;
  constexpr int KS = DK / 16;         // k-steps of S = Q K^T
  constexpr int NS = MLA_BN / 8;      // n8 tiles of S
  constexpr int HALF = DV / 2;        // output columns per warp
  constexpr int NO = HALF / 8;        // n8 tiles of a warp's output

  const int gq = Hq / Hkv, rows = Sq * gq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * MLA_BM;  // longest rows first
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh - b * Hkv;
  const bool split = part_acc != nullptr;
  const int k_lo = split ? blockIdx.z * MLA_SPLIT_KEYS : 0;
  const int k_hi = split ? min(Skv, k_lo + MLA_SPLIT_KEYS) : Skv;
  const int t_lo = k_lo / MLA_BN;
  const int n_tiles = max(0, (k_hi - k_lo + MLA_BN - 1) / MLA_BN);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, ch = warp >> 2;

  // the (B, Sq, Hq) index of row r
  auto head_row = [&](int r) -> size_t {
    const int qi = r / gq;
    return ((size_t)b * Sq + qi) * Hq + hk * gq + (r - qi * gq);
  };

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q_BYTES);
  int* kp_s = reinterpret_cast<int*>(smem_raw + L::Q_BYTES + 2 * L::K_BYTES);
  int* red = kp_s + 2 * MLA_BN;  // qmin, qmax of warps 0 and 1, tile count
  int* tiles = red + 5;          // [n_tiles]

  // ---- the raw q tile, in flight while the block lists its key tiles
  // (rows past m * g are zero)
  for (int c = tid; c < MLA_BM * DK / 8; c += MLA_THREADS) {
    const int r = c / (DK / 8), d = (c % (DK / 8)) * 8, R = r0 + r;
    cp_async16(smem_u32(qs + r * L::LD + d), q + head_row(min(R, rows - 1)) * DK + d,
               R < rows ? 16 : 0);
  }
  cp_async_commit();

  // ---- the block's smallest and largest query position
  {
    int lo = INT_MAX, hi = INT_MIN;
    if (tid < MLA_BM && r0 + tid < rows) lo = hi = q_pos[(size_t)b * Sq + (r0 + tid) / gq];
    lo = __reduce_min_sync(FULL_MASK, lo);
    hi = __reduce_max_sync(FULL_MASK, hi);
    if (lane == 0 && warp < MLA_BM / 32) {
      red[2 * warp] = lo;
      red[2 * warp + 1] = hi;
    }
  }
  for (int i = tid; i < n_tiles; i += MLA_THREADS) tiles[i] = 0;
  __syncthreads();

  // ---- the key tiles of [k_lo, k_hi) this block visits (conservative, by
  // the block's smallest and largest position: a visited tile without a
  // valid pair is an exact identity step)
  {
    const int qmin = min(red[0], red[2]), qmax = max(red[1], red[3]);
    for (int i = k_lo + tid; i < k_hi; i += MLA_THREADS) {
      const int kp = kv_pos[(size_t)b * Skv + i];
      if (kp >= 0 && (!causal || kp <= qmax) && (window == 0 || qmin - kp < window))
        tiles[i / MLA_BN - t_lo] = 1;
    }
  }
  cp_async_wait<0>();  // the q tile
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (tiles[i]) tiles[n++] = t_lo + i;
    red[4] = n;
  }
  // q times the bf16-rounded scale, rounded to bf16, in place, as the plain
  // version scales it
  {
    const float scale_t = round_t<__nv_bfloat16>(scale);
    for (int c = tid; c < MLA_BM * DK / 2; c += MLA_THREADS) {
      const int r = c / (DK / 2), d = (c % (DK / 2)) * 2;
      auto* p = reinterpret_cast<__nv_bfloat162*>(qs + r * L::LD + d);
      const float2 x = __bfloat1622float2(*p);
      *p = __floats2bfloat162_rn(x.x * scale_t, x.y * scale_t);
    }
  }
  __syncthreads();
  const int n_visit = red[4];

  const int row0 = r0 + rg * 16 + g;  // this thread's rows: row0, row0 + 8
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qp[i] = row0 + 8 * i < rows ? q_pos[(size_t)b * Sq + (row0 + 8 * i) / gq] : -1;
  const bool active = r0 + rg * 16 < rows;  // the warp has a real row

  // one key tile into buffer `buf`: K (V is its first DV columns) and the
  // key positions (keys past Skv are zero with position -1)
  auto issue = [&](int tile, int buf) {
    const int k0 = tile * MLA_BN;
    const uint32_t kdst = smem_u32(ks + buf * (L::K_BYTES / 2));
    for (int c = tid; c < MLA_BN * DK / 8; c += MLA_THREADS) {
      const int r = c / (DK / 8), d = (c % (DK / 8)) * 8, ki = k0 + r;
      const __nv_bfloat16* src =
          k + (((size_t)b * Skv + min(ki, Skv - 1)) * Hkv + hk) * DK + d;
      cp_async16(kdst + (r * L::LD + d) * 2, src, ki < Skv ? 16 : 0);
    }
    if (tid < MLA_BN) {
      int* dst = kp_s + buf * MLA_BN + tid;
      if (k0 + tid < Skv)
        cp_async4(smem_u32(dst), kv_pos + (size_t)b * Skv + k0 + tid);
      else
        *dst = -1;
    }
    cp_async_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  if (n_visit > 0) issue(tiles[0], 0);
  for (int it = 0; it < n_visit; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_visit) {  // the next tile's copies overlap this tile
      issue(tiles[it + 1], buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const __nv_bfloat16* kb = ks + buf * (L::K_BYTES / 2);
      const int* kp = kp_s + buf * MLA_BN;

      // S = Q K^T: Q's A-fragments from shared memory at every k-step; one
      // ldmatrix.x4 gives the B-fragments of two n8 tiles of keys
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      {
        const int ar = rg * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int ad = (lane >> 4) * 8;
        const int key = (lane >> 4) * 8 + (lane & 7);
        const int d = ((lane >> 3) & 1) * 8;
#pragma unroll 6
        for (int st = 0; st < KS; ++st) {
          uint32_t qa[4];
          ldmatrix_x4(qa, smem_u32(qs + ar * L::LD + st * 16 + ad));
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t bf[4];
            ldmatrix_x4(bf, smem_u32(kb + (np * 16 + key) * L::LD + st * 16 + d));
            mma_bf16(s[2 * np], qa, bf[0], bf[1]);
            mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
          }
        }
      }

      softmax_tile(s, o, m_run, l_run, qp, kp, t, causal, window);

      // O += P V over this warp's column half: the S accumulators of n8
      // tiles 2j and 2j + 1, rounded to bf16, are the A-fragment of k-step
      // j; ldmatrix.x4.trans of the K tile's first DV columns gives V's
      // B-fragments of two n8 tiles of the output
      {
        const int key = ((lane >> 3) & 1) * 8 + (lane & 7);
        const int d = ch * HALF + (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                  pack_bf16(s[2 * j][2], s[2 * j][3]),
                                  pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                  pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, smem_u32(kb + (j * 16 + key) * L::LD + np * 16 + d));
            mma_bf16(o[2 * np], pa, bf[0], bf[1]);
            mma_bf16(o[2 * np + 1], pa, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies refill this buffer
  }

  if (!active) return;
  float l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(FULL_MASK, l, 1);
    l += __shfl_xor_sync(FULL_MASK, l, 2);
    l_row[i] = l;
  }

  if (split) {
    // the split's unnormalised partial rows
    const size_t base = ((size_t)bh * gridDim.z + blockIdx.z) * rows;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int R = row0 + 8 * i;
      if (R >= rows) continue;
      float* dst = part_acc + (base + R) * DV + ch * HALF + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (ch == 0 && t == 0) {
        part_ml[(base + R) * 2] = m_run[i];
        part_ml[(base + R) * 2 + 1] = l_row[i];
      }
    }
    return;
  }

  // acc / l, 0 where no key was valid, staged through this warp's rows and
  // columns of the q tile for 16-byte stores
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float den = fmaxf(l_row[i], 1e-30f);
      const float x0 = l_row[i] > 0.f ? o[n][2 * i] / den : 0.f;
      const float x1 = l_row[i] > 0.f ? o[n][2 * i + 1] / den : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(qs + (rg * 16 + g + 8 * i) * L::LD + ch * HALF +
                                         n * 8 + 2 * t) = __floats2bfloat162_rn(x0, x1);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * HALF / 8; c += 32) {
    const int r = c / (HALF / 8), d = ch * HALF + (c % (HALF / 8)) * 8;
    const int R = r0 + rg * 16 + r;
    if (R < rows)
      *reinterpret_cast<uint4*>(out + head_row(R) * DV + d) =
          *reinterpret_cast<const uint4*>(qs + (rg * 16 + r) * L::LD + d);
  }
}

// Folds the splits of each row in increasing split order, as
// decode_merge_kernel does: M = the largest split max, then l and acc summed
// with weights exp(m_s - M).  A split with no valid key (m = -1e30, l = 0,
// acc = 0) adds exact zeros, so trailing empty splits leave the bits alone.
template <int DV>
__global__ void __launch_bounds__(MLA_MERGE_WARPS * 32) flash_mla_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    __nv_bfloat16* __restrict__ out,  // (B, Sq, Hq, DV)
    int Sq, int Hq, int Hkv, int n_split) {
  const int gq = Hq / Hkv, rows = Sq * gq;
  const int bh = blockIdx.x, b = bh / Hkv, hk = bh - b * Hkv;
  const int lane = threadIdx.x & 31;
  const int R = blockIdx.y * MLA_MERGE_WARPS + (threadIdx.x >> 5);
  if (R >= rows) return;
  const size_t base = (size_t)bh * n_split * rows + R;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, part_ml[(base + (size_t)s * rows) * 2]);
  float l = 0.f, a[DV / 32];
#pragma unroll
  for (int j = 0; j < DV / 32; ++j) a[j] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t i = base + (size_t)s * rows;
    const float w = expf(part_ml[i * 2] - M);
    l += w * part_ml[i * 2 + 1];
#pragma unroll
    for (int j = 0; j < DV / 32; ++j) a[j] += w * part_acc[i * DV + j * 32 + lane];
  }
  const int qi = R / gq;
  __nv_bfloat16* dst = out + (((size_t)b * Sq + qi) * Hq + hk * gq + (R - qi * gq)) * DV;
#pragma unroll
  for (int j = 0; j < DV / 32; ++j)
    dst[j * 32 + lane] = __float2bfloat16_rn(l > 0.f ? a[j] / fmaxf(l, 1e-30f) : 0.f);
}

template <int DK, int DV>
cudaError_t launch_mla(const void* q, const void* k, const void* q_pos,
                       const void* kv_pos, void* out, void* part_ml, void* part_acc,
                       int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                       int window, float scale, int n_split, cudaStream_t stream) {
  const int rows = Sq * (Hq / Hkv);
  const int span = n_split > 0 ? MLA_SPLIT_KEYS : Skv;
  const size_t smem = MlaSmem<DK>::bytes((span + MLA_BN - 1) / MLA_BN);
  cudaError_t err = repro::allow_smem(flash_mla_kernel<DK, DV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + MLA_BM - 1) / MLA_BM, B * Hkv, n_split > 0 ? n_split : 1);
  flash_mla_kernel<DK, DV><<<grid, MLA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<__nv_bfloat16*>(out),
      n_split > 0 ? static_cast<float*>(part_ml) : nullptr,
      n_split > 0 ? static_cast<float*>(part_acc) : nullptr, Sq, Skv, Hq, Hkv,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return err;
  dim3 mgrid(B * Hkv, (rows + MLA_MERGE_WARPS - 1) / MLA_MERGE_WARPS);
  flash_mla_merge_kernel<DV><<<mgrid, MLA_MERGE_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<__nv_bfloat16*>(out), Sq, Hq, Hkv, n_split);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- wide
// The bf16 tensor-core kernel for head dims of 256 (see the header): the
// block and warp rows of flash_mma_kernel (64 queries of one q head, 16 rows
// a warp, the whole Dv a warp), q read from shared memory at every k-step
// as flash_mla_kernel reads it, K and V in separate 32-key tiles.

constexpr int WIDE_THREADS = 128;  // 4 warps x 16 query rows
constexpr int WIDE_BQ = 64;
constexpr int WIDE_BKV = 32;

template <int DK, int DV>
struct WideSmem {
  static constexpr int QLD = (DK > DV ? DK : DV) + PAD;  // q tile, then output
  static constexpr int KLD = DK + PAD;
  static constexpr int VLD = DV + PAD;
  static constexpr size_t Q_BYTES = (size_t)WIDE_BQ * QLD * 2;
  static constexpr size_t K_BYTES = (size_t)WIDE_BKV * KLD * 2;  // per buffer
  static constexpr size_t V_BYTES = (size_t)WIDE_BKV * VLD * 2;
  // q | K[2] | V[2] | key positions [2][32] | qmin, qmax x 2, count | tiles
  static size_t bytes(int n_tiles) {
    return Q_BYTES + 2 * K_BYTES + 2 * V_BYTES +
           (2 * WIDE_BKV + 5 + (size_t)n_tiles) * sizeof(int);
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(WIDE_THREADS, 2) flash_wide_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Sq, Hq, DK)
    const __nv_bfloat16* __restrict__ k,  // (B, Skv, Hkv, DK)
    const __nv_bfloat16* __restrict__ v,  // (B, Skv, Hkv, DV)
    const int* __restrict__ q_pos,        // (B, Sq)
    const int* __restrict__ kv_pos,       // (B, Skv)
    __nv_bfloat16* __restrict__ out,      // (B, Sq, Hq, DV)
    int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale) {
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DK > 128 && DV > 128,
                "head dims are multiples of 16 above flash_mma_kernel's 128");
  using L = WideSmem<DK, DV>;
  constexpr int KS = DK / 16;        // k-steps of S = Q K^T
  constexpr int NS = WIDE_BKV / 8;   // n8 tiles of S
  constexpr int NO = DV / 8;         // n8 tiles of the output

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WIDE_BQ;  // longest rows first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (Skv + WIDE_BKV - 1) / WIDE_BKV;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q_BYTES);
  __nv_bfloat16* vs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L::Q_BYTES + 2 * L::K_BYTES);
  int* kp_s = reinterpret_cast<int*>(smem_raw + L::Q_BYTES + 2 * L::K_BYTES +
                                     2 * L::V_BYTES);  // [2][WIDE_BKV]
  int* red = kp_s + 2 * WIDE_BKV;  // qmin, qmax of warps 0 and 1, tile count
  int* tiles = red + 5;            // [n_tiles]

  // ---- the raw q tile, in flight while the block lists its kv tiles
  // (rows past Sq are zero)
  for (int c = tid; c < WIDE_BQ * DK / 8; c += WIDE_THREADS) {
    const int r = c / (DK / 8), d = (c % (DK / 8)) * 8, qi = q0 + r;
    cp_async16(smem_u32(qs + r * L::QLD + d),
               q + (((size_t)b * Sq + min(qi, Sq - 1)) * Hq + h) * DK + d,
               qi < Sq ? 16 : 0);
  }
  cp_async_commit();

  // ---- the block's smallest and largest query position (rows below Sq)
  {
    int lo = INT_MAX, hi = INT_MIN;
    if (tid < WIDE_BQ && q0 + tid < Sq) lo = hi = q_pos[(size_t)b * Sq + q0 + tid];
    lo = __reduce_min_sync(FULL_MASK, lo);
    hi = __reduce_max_sync(FULL_MASK, hi);
    if (lane == 0 && warp < WIDE_BQ / 32) {
      red[2 * warp] = lo;
      red[2 * warp + 1] = hi;
    }
  }
  for (int i = tid; i < n_tiles; i += WIDE_THREADS) tiles[i] = 0;
  __syncthreads();

  // ---- the kv tiles this block visits (conservative, by the block's
  // smallest and largest position: a visited tile without a valid pair is
  // an exact identity step)
  {
    const int qmin = min(red[0], red[2]), qmax = max(red[1], red[3]);
    for (int i = tid; i < Skv; i += WIDE_THREADS) {
      const int kp = kv_pos[(size_t)b * Skv + i];
      if (kp >= 0 && (!causal || kp <= qmax) && (window == 0 || qmin - kp < window))
        tiles[i / WIDE_BKV] = 1;
    }
  }
  cp_async_wait<0>();  // the q tile
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (tiles[i]) tiles[n++] = i;
    red[4] = n;
  }
  // q times the bf16-rounded scale, rounded to bf16, in place, as the plain
  // version scales it
  {
    const float scale_t = round_t<__nv_bfloat16>(scale);
    for (int c = tid; c < WIDE_BQ * DK / 2; c += WIDE_THREADS) {
      const int r = c / (DK / 2), d = (c % (DK / 2)) * 2;
      auto* p = reinterpret_cast<__nv_bfloat162*>(qs + r * L::QLD + d);
      const float2 x = __bfloat1622float2(*p);
      *p = __floats2bfloat162_rn(x.x * scale_t, x.y * scale_t);
    }
  }
  __syncthreads();
  const int n_visit = red[4];

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qp[i] = row0 + 8 * i < Sq ? q_pos[(size_t)b * Sq + row0 + 8 * i] : -1;
  const bool active = q0 + warp * 16 < Sq;  // the warp has a row below Sq

  // one kv tile into buffer `buf`: K, V and the key positions (keys past
  // Skv are zero with position -1)
  auto issue = [&](int tile, int buf) {
    const int k0 = tile * WIDE_BKV;
    const uint32_t kdst = smem_u32(ks + buf * (L::K_BYTES / 2));
    const uint32_t vdst = smem_u32(vs + buf * (L::V_BYTES / 2));
#pragma unroll
    for (int c = tid; c < WIDE_BKV * DK / 8; c += WIDE_THREADS) {
      const int r = c / (DK / 8), d = (c % (DK / 8)) * 8, ki = k0 + r;
      const __nv_bfloat16* src =
          k + (((size_t)b * Skv + min(ki, Skv - 1)) * Hkv + hk) * DK + d;
      cp_async16(kdst + (r * L::KLD + d) * 2, src, ki < Skv ? 16 : 0);
    }
#pragma unroll
    for (int c = tid; c < WIDE_BKV * DV / 8; c += WIDE_THREADS) {
      const int r = c / (DV / 8), d = (c % (DV / 8)) * 8, ki = k0 + r;
      const __nv_bfloat16* src =
          v + (((size_t)b * Skv + min(ki, Skv - 1)) * Hkv + hk) * DV + d;
      cp_async16(vdst + (r * L::VLD + d) * 2, src, ki < Skv ? 16 : 0);
    }
    if (tid < WIDE_BKV) {
      int* dst = kp_s + buf * WIDE_BKV + tid;
      if (k0 + tid < Skv)
        cp_async4(smem_u32(dst), kv_pos + (size_t)b * Skv + k0 + tid);
      else
        *dst = -1;
    }
    cp_async_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  if (n_visit > 0) issue(tiles[0], 0);
  for (int it = 0; it < n_visit; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_visit) {  // the next tile's copies overlap this tile
      issue(tiles[it + 1], buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const __nv_bfloat16* kb = ks + buf * (L::K_BYTES / 2);
      const __nv_bfloat16* vb = vs + buf * (L::V_BYTES / 2);
      const int* kp = kp_s + buf * WIDE_BKV;

      // S = Q K^T: Q's A-fragments from shared memory at every k-step; one
      // ldmatrix.x4 gives the B-fragments of two n8 tiles of keys.  The
      // k-steps unroll by 4: unrolled whole, ptxas spills (255 registers,
      // 104 bytes of spill stores); by 4 it holds 235 and spills nothing
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      {
        const int ar = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int ad = (lane >> 4) * 8;
        const int key = (lane >> 4) * 8 + (lane & 7);
        const int d = ((lane >> 3) & 1) * 8;
#pragma unroll 4
        for (int st = 0; st < KS; ++st) {
          uint32_t qa[4];
          ldmatrix_x4(qa, smem_u32(qs + ar * L::QLD + st * 16 + ad));
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t bf[4];
            ldmatrix_x4(bf, smem_u32(kb + (np * 16 + key) * L::KLD + st * 16 + d));
            mma_bf16(s[2 * np], qa, bf[0], bf[1]);
            mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
          }
        }
      }

      softmax_tile(s, o, m_run, l_run, qp, kp, t, causal, window);

      // O += P V: the S accumulators of n8 tiles 2j and 2j + 1, rounded to
      // bf16, are the A-fragment of k-step j; one ldmatrix.x4.trans gives
      // V's B-fragments of two n8 tiles of the output
      {
        const int key = ((lane >> 3) & 1) * 8 + (lane & 7);
        const int d = (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                  pack_bf16(s[2 * j][2], s[2 * j][3]),
                                  pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                  pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, smem_u32(vb + (j * 16 + key) * L::VLD + np * 16 + d));
            mma_bf16(o[2 * np], pa, bf[0], bf[1]);
            mma_bf16(o[2 * np + 1], pa, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copies refill this buffer
  }

  // ---- acc / l, 0 where no key was valid, staged through this warp's own
  // rows of the q tile for 16-byte stores
  if (!active) return;
  float l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(FULL_MASK, l, 1);
    l += __shfl_xor_sync(FULL_MASK, l, 2);
    l_row[i] = l;
  }
  __nv_bfloat16* stage = qs + warp * 16 * L::QLD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float den = fmaxf(l_row[i], 1e-30f);
      const float x0 = l_row[i] > 0.f ? o[n][2 * i] / den : 0.f;
      const float x1 = l_row[i] > 0.f ? o[n][2 * i + 1] / den : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * i) * L::QLD + n * 8 + 2 * t) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
  __syncwarp();
  for (int c = lane; c < 16 * DV / 8; c += 32) {
    const int r = c / (DV / 8), d = (c % (DV / 8)) * 8, qi = q0 + warp * 16 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qi) * Hq + h) * DV + d) =
          *reinterpret_cast<const uint4*>(stage + r * L::QLD + d);
  }
}

template <int DK, int DV>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out, int B,
                        int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                        float scale, cudaStream_t stream) {
  const size_t smem = WideSmem<DK, DV>::bytes((Skv + WIDE_BKV - 1) / WIDE_BKV);
  cudaError_t err = repro::allow_smem(flash_wide_kernel<DK, DV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + WIDE_BQ - 1) / WIDE_BQ);
  flash_wide_kernel<DK, DV><<<grid, WIDE_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<__nv_bfloat16*>(out), Sq, Skv,
      Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// The bf16 tensor-core kernel at the instantiated (Dk, Dv) pairs: those of
// ops.MMA_HEAD_DIMS.  Any other pair is refused, never re-routed.
extern "C" int flash_attention_mma(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* kv_pos,
                                   void* out, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int Dk, int Dv, int causal,
                                   int window, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_MMA_CASE(DK, DV)                                                  \
  if (Dk == DK && Dv == DV)                                                     \
    return launch_mma<DK, DV>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv, \
                              causal, window, scale, s);
  REPRO_MMA_CASE(16, 16)
  REPRO_MMA_CASE(32, 32)
  REPRO_MMA_CASE(64, 64)
  REPRO_MMA_CASE(128, 128)
  REPRO_MMA_CASE(96, 64)
  REPRO_MMA_CASE(80, 80)
#undef REPRO_MMA_CASE
  return (int)cudaErrorInvalidValue;
}

// The bf16 MLA kernel at the instantiated (Dk, Dv) pairs: those of
// ops.MLA_HEAD_DIMS; any other pair is refused, never re-routed.  V is
// k[..., :Dv] (no v pointer).  n_split 0: one launch over all keys;
// n_split > 0: that many splits of MLA_SPLIT_KEYS keys into part_ml
// (n_split * B * Hkv * Sq * Hq / Hkv * 2 floats) and part_acc (the same
// rows times Dv), then the merge: two launches.
extern "C" int flash_attention_mla(const void* q, const void* k, const void* q_pos,
                                   const void* kv_pos, void* out, void* part_ml,
                                   void* part_acc, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int Dk, int Dv, int causal, int window,
                                   float scale, int n_split, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_MLA_CASE(DK, DV)                                                      \
  if (Dk == DK && Dv == DV)                                                         \
    return launch_mla<DK, DV>(q, k, q_pos, kv_pos, out, part_ml, part_acc, B, Sq, \
                              Skv, Hq, Hkv, causal, window, scale, n_split, s);
  REPRO_MLA_CASE(576, 512)
  REPRO_MLA_CASE(48, 32)
#undef REPRO_MLA_CASE
  return (int)cudaErrorInvalidValue;
}

// The bf16 wide kernel at the instantiated (Dk, Dv) pairs: those of
// ops.WIDE_HEAD_DIMS; any other pair is refused, never re-routed.
extern "C" int flash_attention_wide(const void* q, const void* k, const void* v,
                                    const void* q_pos, const void* kv_pos,
                                    void* out, int B, int Sq, int Skv, int Hq,
                                    int Hkv, int Dk, int Dv, int causal,
                                    int window, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_WIDE_CASE(DK, DV)                                                  \
  if (Dk == DK && Dv == DV)                                                      \
    return launch_wide<DK, DV>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv, \
                               causal, window, scale, s);
  REPRO_WIDE_CASE(256, 256)
#undef REPRO_WIDE_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* q_pos,
                               const void* kv_pos, void* out, int B, int Sq,
                               int Skv, int Hq, int Hkv, int Dk, int Dv,
                               int causal, int window, float scale,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq, Hkv, Dk,
                         Dv, causal, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq,
                                 Hkv, Dk, Dv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
