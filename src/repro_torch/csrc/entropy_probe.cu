// Fused unembedding + next-token entropy for Hopper (sm_90a): the EAT signal.
//
// Replaces the TPU kernel repro/kernels/entropy_probe/kernel.py
// (entropy_probe_pallas).  Computes H(softmax(h W)[:vocab]) per row without
// writing the (B, Vp) logits to device memory: per vocab tile the running
// statistics m = max logit, Z = sum exp(logit - m), T = sum exp(logit - m) *
// (logit - m), merged across tiles by rescaling (T moves to a new max m' as
// exp(m - m') (T + (m - m') Z)), and H = log Z - T / Z.  The reference's T
// is taken about 0 and its H = m + log Z - T / Z cancels: where one token
// takes nearly all the mass, m + log Z and T / Z both near m, and the
// rounding of each sum that adds a small term to them (one ulp of m, 1.9e-6
// at a logit of 27) lands in H whole; about the max, the small terms stay
// small.  Columns >= vocab (the padded vocabulary) are masked: -1e30 in the
// max, 0 in Z and T.
//
// On the TPU the vocab tiles ran in order on one core and carried (m, Z, T)
// in scratch.  Blocks on Hopper run in parallel, so a call is two launches:
// a statistics kernel that writes one (m, Z, T) partial per (block, row)
// into a (n_part, B, 3) float32 scratch, then merge_kernel, one block per
// row, which folds the partials by rescaling and writes H.
//
// What bounds it on the H100: bytes.  W is d x Vp (4096 x 152064 bf16 =
// 1.25 GB at eat-paper-8b, 0.372 ms at 3.35 TB/s) and must be read once per
// call, against 2 B d FLOPs per column: B FLOPs per byte, far below the
// card's ~295.  Two statistics kernels, chosen by the wrapper
// (ops.entropy_variant):
//
// entropy_mma_kernel (bf16, W in one of two layouts, 16-byte aligned):
//   * W streams through shared memory ONCE per row group of up to 32 rows,
//     16 bytes a thread per cp.async copy (each miss fetching 128 bytes
//     into L2), in a ring of 3 or 4 stages of 16 or 32 KB, so two or three
//     stages are in flight while one is computed.  The ring runs across
//     tile boundaries: the next tile's first stages load during this
//     tile's last stage and epilogue.  h's k-slab (rows x TK, from L2)
//     rides in each stage beside W: h of 32 rows x 4096 would not fit the
//     shared memory of a block.
//   * One template on the layout, not two kernels.  Untied: W (d, Vp) with
//     vocab contiguous (strides (ld, 1)); a stage is TK_UNTIED = 64 rows of
//     d by TVM = 128 vocab, and its A-fragments come through
//     ldmatrix.trans.  Tied: the transposed view of the (Vp, d) embedding
//     (strides (1, ld)), read in place; a stage is TVM vocab rows by
//     TK_TIED = 128 of d, A-fragments by ldmatrix.  Either way a stage row
//     is 256 contiguous bytes (shorter rows of the tied view read slower).
//     Ragged edges (d past the last stage, Vp past the last tile) are
//     zero-filled through the copy's src-size operand.
//   * The product on the tensor cores, mma.sync.m16n8k16 bf16 x bf16 with
//     M = vocab columns and N = rows ("swap AB"): a batch of 4 fills half
//     an n-tile, a batch of 32 four n-tiles that share each W fragment.
//     bf16 products are exact in float32.  Each k-step of 16 is summed into
//     a zeroed fragment and added to the float32 logit with an ordinary
//     add, rounded to nearest: the tensor cores' own accumulation, run over
//     all of d, drifts toward zero with the sign of the running sum.
//   * Each of the 8 warps owns 16 vocab columns of every tile.  After a
//     tile's last stage it takes (m, Z, T) of its 16 columns per row from
//     the fragments with warp shuffles and merges them into its running
//     statistics.  The grid is G <= the card's resident blocks (the wrapper
//     asks entropy_probe_occupancy and gives every block the same number of
//     tiles, give or take one); block i walks tiles i, i + G, ..., so the
//     blocks in flight read neighbouring columns.  At its end a block
//     merges its 8 warps in warp order into one partial per row.
//   * A call keeps no state: no counters, no buffers of its own.
//
// tile_stats_kernel (float32, and bf16 in any other layout) is the scalar
// kernel: one block per (group of up to ROWS rows, tile of TV columns), one
// thread per column walking d with scalar FMAs; h staged in shared memory.
// Any strided W is read in place, though only a vocab-contiguous W gives
// coalesced loads.  In float32 the tensor cores would compute in TF32,
// short of the 1e-5 float32 bar.

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::to_f;

constexpr unsigned FULL = 0xffffffffu;
constexpr int TV = 256;       // scalar: vocab columns per tile = threads per block
constexpr int DCH = 256;      // scalar: h columns staged in shared memory per step
constexpr int ROWS = 16;      // scalar: rows per block (one group of the batch)

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Block-wide reduction of one value per thread; every thread gets the result.
template <bool IS_MAX>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  x = IS_MAX ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float y = IS_MAX ? NEG_INF : 0.f;
  for (int w = 0; w < n_warps; ++w) y = IS_MAX ? fmaxf(y, red[w]) : y + red[w];
  return y;
}

// ------------------------------------------------------------------ scalar

template <typename T>
__global__ void __launch_bounds__(TV) tile_stats_kernel(
    const T* __restrict__ h,     // (B, d) contiguous
    const T* __restrict__ w,     // (d, Vp) with strides (sd, sv)
    float* __restrict__ part,    // (n_tiles, B, 3)
    int B, int d, int Vp, long long sd, long long sv, int vocab) {
  __shared__ float hs[ROWS * DCH];
  __shared__ float red[TV / 32];
  const int b0 = blockIdx.x * ROWS, tile = blockIdx.y, tid = threadIdx.x;
  const int nb = min(ROWS, B - b0);  // rows of this group
  const int col = tile * TV + tid;
  const bool in_range = col < Vp;
  float lg[ROWS];
#pragma unroll
  for (int b = 0; b < ROWS; ++b) lg[b] = 0.f;

  for (int d0 = 0; d0 < d; d0 += DCH) {
    const int dn = min(DCH, d - d0);
    __syncthreads();
    for (int i = tid; i < nb * DCH; i += TV) {
      const int b = i / DCH, dd = i - b * DCH;
      hs[i] = dd < dn ? to_f(h[(size_t)(b0 + b) * d + d0 + dd]) : 0.f;
    }
    __syncthreads();
    if (in_range) {
      const T* wc = w + (size_t)col * sv + (size_t)d0 * sd;
      for (int dd = 0; dd < dn; ++dd) {
        const float wv = to_f(wc[(size_t)dd * sd]);
#pragma unroll
        for (int b = 0; b < ROWS; ++b)
          if (b < nb) lg[b] += hs[b * DCH + dd] * wv;
      }
    }
  }

  const bool valid = col < vocab;  // vocab <= Vp: padded columns masked
#pragma unroll
  for (int b = 0; b < ROWS; ++b) {
    if (b >= nb) break;
    const float x = valid ? lg[b] : NEG_INF;
    const float m = block_reduce<true>(x, red);
    const float e = valid ? expf(x - m) : 0.f;
    const float z = block_reduce<false>(e, red);
    const float t = block_reduce<false>(valid ? e * (x - m) : 0.f, red);
    if (tid == 0) {
      float* o = part + ((size_t)tile * B + b0 + b) * 3;
      o[0] = m;
      o[1] = z;
      o[2] = t;
    }
  }
}

// ------------------------------------------------------------------ merge

// Fold the n_part partials of row blockIdx.x: weights exp(m_p - M) against
// the largest partial max M, each T_p moved to M by (m_p - M) Z_p.  A
// partial that saw no valid column (m = -1e30, Z = T = 0) adds exact zeros.
__global__ void __launch_bounds__(TV) merge_kernel(
    const float* __restrict__ part, float* __restrict__ out, int B, int n_part) {
  __shared__ float red[TV / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  float m = NEG_INF;
  for (int t = tid; t < n_part; t += TV) m = fmaxf(m, part[((size_t)t * B + b) * 3]);
  m = block_reduce<true>(m, red);
  float z = 0.f, tt = 0.f;
  for (int t = tid; t < n_part; t += TV) {
    const float* p = part + ((size_t)t * B + b) * 3;
    const float s = expf(p[0] - m);
    z += p[1] * s;
    tt += (p[2] + (p[0] - m) * p[1]) * s;
  }
  z = block_reduce<false>(z, red);
  tt = block_reduce<false>(tt, red);
  if (tid == 0) out[b] = logf(z) - tt / z;
}

// ------------------------------------------------------------------ mma
// Fragment layouts are those of PTX's m16n8k16 (gr = lane / 4, t = lane %
// 4): A holds rows gr and gr + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9;
// B holds column gr at rows 2t, 2t + 1 and 2t + 8, 2t + 9; C holds rows gr
// and gr + 8 at columns 2t, 2t + 1.  Here A = W^T (rows: vocab columns,
// columns: d), B = h^T (rows: d, columns: batch rows), C = logits^T.

constexpr int MMA_THREADS = 256;
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int PAD = 8;               // bf16 of padding per shared row: 16 bytes
constexpr int MAX_NT = 4;            // n8 tiles per row group: 32 rows
constexpr int TVM = MMA_WARPS * 16;  // vocab columns per tile: 16 per warp
// d per stage and ring stages, per layout.  A stage row is 256 bytes
// either way: TVM vocab (untied) or TK_TIED of d (tied).
constexpr int TK_UNTIED = 64, STAGES_UNTIED = 3;
constexpr int TK_TIED = 128, STAGES_TIED = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bytes past src_bytes written as zeros; each
// miss fetches 128 bytes into L2 (the copies of one stage row are adjacent)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
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

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// acc += a * b over one m16n8k16 k-step: the step's 16 exact products are
// summed from zero on the tensor cores, then added to acc to nearest
__device__ __forceinline__ void mma_step(float (&acc)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float c[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], c[i]);
}

// Shared-memory shape of one ring stage: W's tile, then h's k-slab of the
// row group (8 NT rows)
template <int TIED, int NT>
struct Stage {
  static constexpr int TK = TIED ? TK_TIED : TK_UNTIED;
  static constexpr int STAGES = TIED ? STAGES_TIED : STAGES_UNTIED;
  static constexpr int W_ROWS = TIED ? TVM : TK;  // vocab rows / d rows
  static constexpr int WLD = (TIED ? TK : TVM) + PAD;
  static constexpr int HLD = TK + PAD;
  static constexpr int W_ELEMS = W_ROWS * WLD;
  static constexpr int ELEMS = W_ELEMS + 8 * NT * HLD;
  static constexpr size_t BYTES = (size_t)STAGES * ELEMS * 2;
  // after the loop the ring holds every warp's (m, Z, T) per row
  static_assert((size_t)MMA_WARPS * 8 * NT * 3 * 4 <= BYTES, "staged statistics");
  static_assert(TK % 16 == 0 && TK * TVM / 8 % MMA_THREADS == 0,
                "whole k-steps and copy rounds");
};

// Grid (n_part, row groups of 8 NT rows); block x writes partial x of the
// rows of its group.
template <int TIED, int NT>
__global__ void __launch_bounds__(MMA_THREADS) entropy_mma_kernel(
    const __nv_bfloat16* __restrict__ h,  // (B, d) contiguous
    const __nv_bfloat16* __restrict__ w,  // (d, Vp): strides (ld, 1), or (1, ld) if TIED
    float* __restrict__ part,             // (n_part, B, 3)
    int B, int d, int Vp, long long ld, int vocab) {
  static_assert(NT == 1 || NT == 2 || NT == 4, "n8 tiles per row group");
  using S = Stage<TIED, NT>;
  constexpr int TK = S::TK, STAGES = S::STAGES;
  constexpr int HLD = S::HLD;
  constexpr int R = 8 * NT;      // rows per group
  constexpr int KS = TK / 16;    // k-steps per stage
  constexpr int CH = TK / 8;     // 16-byte chunks along d per row of a stage
  constexpr int W_COPIES = TK * TVM / 8 / MMA_THREADS;  // copies per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * R;
  const int n_tiles = (Vp + TVM - 1) / TVM;
  // this block's tiles: blockIdx.x, + gridDim.x, ... (gridDim.x <= n_tiles)
  const int G = gridDim.x, n_k = (d + TK - 1) / TK;
  const int n_stages = (n_tiles - (int)blockIdx.x + G - 1) / G * n_k;
  auto tile_of = [&](int j) { return (int)blockIdx.x + j * G; };

  // stage s of this block (its tile s / n_k, d from (s % n_k) TK) into
  // ring slot buf; past d, Vp or B the copies write zeros
  auto issue = [&](int s, int buf) {
    const int k0 = (s % n_k) * TK, v0 = tile_of(s / n_k) * TVM;
    const uint32_t wdst = smem_u32(ring + buf * S::ELEMS);
    const uint32_t hdst = wdst + S::W_ELEMS * 2;
#pragma unroll
    for (int i = 0; i < W_COPIES; ++i) {
      const int c = tid + i * MMA_THREADS;
      if constexpr (TIED) {  // TVM vocab rows of TK contiguous d
        const int r = c / CH, kk = (c % CH) * 8, v = v0 + r, k = k0 + kk;
        const int n = v < Vp ? min(max(d - k, 0), 8) : 0;
        cp_async16(wdst + (r * S::WLD + kk) * 2, n ? w + v * ld + k : w, 2 * n);
      } else {               // TK rows of d of TVM contiguous vocab
        const int r = c / (TVM / 8), vv = (c % (TVM / 8)) * 8, k = k0 + r, v = v0 + vv;
        const int n = k < d ? min(max(Vp - v, 0), 8) : 0;
        cp_async16(wdst + (r * S::WLD + vv) * 2, n ? w + k * ld + v : w, 2 * n);
      }
    }
#pragma unroll
    for (int i = 0; i < (R * CH + MMA_THREADS - 1) / MMA_THREADS; ++i) {
      const int c = tid + i * MMA_THREADS;
      if (c >= R * CH) break;
      const int r = c / CH, kk = (c % CH) * 8, row = r0 + r, k = k0 + kk;
      const bool real = row < B && k < d;  // d % 8 == 0: a chunk is all in or out
      cp_async16(hdst + (r * HLD + kk) * 2, real ? h + (size_t)row * d + k : h,
                 real ? 16 : 0);
    }
  };

  // logits of this warp's columns warp*16 + (gr, gr + 8) for rows nt*8 +
  // 2t + (0, 1), and the running (m, Z, T) of its columns
  float acc[NT][4];
  float m_run[NT][2], z_run[NT][2], t_run[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_run[nt][j] = NEG_INF;
      z_run[nt][j] = 0.f;
      t_run[nt][j] = 0.f;
    }
  }

  // lane addresses of the fragments within a stage (k-step 0)
  const int a_off = TIED
      ? (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::WLD + (lane >> 4) * 8
      : ((lane & 7) + ((lane >> 4) & 1) * 8) * S::WLD + warp * 16 + ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * HLD + ((lane >> 3) & 1) * 8;

  // one commit group per stage slot, empty past the last stage, so that
  // wait_group<STAGES - 2> always means "stage s has landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) issue(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s is visible; every warp is done with s - 1
    {
      const int nxt = s + STAGES - 1;
      if (nxt < n_stages) issue(nxt, nxt % STAGES);
      cp_async_commit();
    }
    const __nv_bfloat16* ws = ring + (s % STAGES) * S::ELEMS;
    const __nv_bfloat16* hs = ws + S::W_ELEMS;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (TIED)
        ldmatrix_x4(a, smem_u32(ws + a_off + ks * 16));
      else
        ldmatrix_x4_trans(a, smem_u32(ws + a_off + ks * 16 * S::WLD));
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np) {
        uint32_t b[4];
        const uint32_t addr = smem_u32(hs + b_off + np * 16 * HLD + ks * 16);
        if constexpr (NT == 1)
          ldmatrix_x2(b, addr);
        else
          ldmatrix_x4(b, addr);
        mma_step(acc[2 * np], a, b[0], b[1]);
        if (2 * np + 1 < NT) mma_step(acc[(2 * np + 1) % NT], a, b[2], b[3]);
      }
    }

    if (s % n_k == n_k - 1) {
      // the tile is done: this warp's columns v_lo and v_lo + 8 of rows
      // nt*8 + 2t + j sit in acc[nt][j] and acc[nt][2 + j]; their (m, Z, T)
      // over the warp's 16 columns, by shuffles, merge into its running
      // statistics
      const int v_lo = tile_of(s / n_k) * TVM + warp * 16 + gr;
      const bool ok_lo = v_lo < vocab, ok_hi = v_lo + 8 < vocab;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x0 = ok_lo ? acc[nt][j] : NEG_INF;
          const float x1 = ok_hi ? acc[nt][2 + j] : NEG_INF;
          float mx = fmaxf(x0, x1);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
          const float m_new = fmaxf(m_run[nt][j], mx);
          const float alpha = expf(m_run[nt][j] - m_new);
          const float e0 = ok_lo ? expf(x0 - m_new) : 0.f;
          const float e1 = ok_hi ? expf(x1 - m_new) : 0.f;
          float zs = e0 + e1;
          float ts = (ok_lo ? e0 * (x0 - m_new) : 0.f) + (ok_hi ? e1 * (x1 - m_new) : 0.f);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            zs += __shfl_xor_sync(FULL, zs, o);
            ts += __shfl_xor_sync(FULL, ts, o);
          }
          t_run[nt][j] = (t_run[nt][j] + (m_run[nt][j] - m_new) * z_run[nt][j]) * alpha + ts;
          z_run[nt][j] = z_run[nt][j] * alpha + zs;
          m_run[nt][j] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      }
    }
  }

  // ---- merge the 8 warps' statistics in warp order: one partial per row
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* st = reinterpret_cast<float*>(smem_raw);  // [warp][R][3]
  if (gr == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* o = st + (warp * R + nt * 8 + 2 * t + j) * 3;
        o[0] = m_run[nt][j];
        o[1] = z_run[nt][j];
        o[2] = t_run[nt][j];
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < R; r += MMA_THREADS) {
    const int row = r0 + r;
    if (row >= B) continue;
    float M = NEG_INF;
#pragma unroll
    for (int wi = 0; wi < MMA_WARPS; ++wi) M = fmaxf(M, st[(wi * R + r) * 3]);
    float Z = 0.f, T = 0.f;
#pragma unroll
    for (int wi = 0; wi < MMA_WARPS; ++wi) {
      const float* p = st + (wi * R + r) * 3;
      const float sc = expf(p[0] - M);
      Z += p[1] * sc;
      T += (p[2] + (p[0] - M) * p[1]) * sc;
    }
    float* o = part + ((size_t)blockIdx.x * B + row) * 3;
    o[0] = M;
    o[1] = Z;
    o[2] = T;
  }
}

// ------------------------------------------------------------------ launch

template <typename T>
cudaError_t launch_scalar(const void* h, const void* w, void* part, void* out,
                          int B, int d, int Vp, long long sd, long long sv,
                          int vocab, cudaStream_t stream) {
  if (B < 1) return cudaErrorInvalidValue;
  const int n_tiles = (Vp + TV - 1) / TV;
  const dim3 grid((B + ROWS - 1) / ROWS, n_tiles);
  tile_stats_kernel<T><<<grid, TV, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<float*>(part), B, d, Vp, sd, sv, vocab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<B, TV, 0, stream>>>(static_cast<const float*>(part),
                                     static_cast<float*>(out), B, n_tiles);
  return cudaGetLastError();
}

using MmaKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, float*,
                          int, int, int, long long, int);

// n8 tiles per row group for a batch of B rows: 8, 16, then groups of 32
int n_tiles_n(int B) { return B <= 8 ? 1 : B <= 16 ? 2 : MAX_NT; }

template <int TIED>
MmaKernel mma_kernel(int nt, size_t* smem) {
  if (nt == 1) {
    *smem = Stage<TIED, 1>::BYTES;
    return entropy_mma_kernel<TIED, 1>;
  }
  if (nt == 2) {
    *smem = Stage<TIED, 2>::BYTES;
    return entropy_mma_kernel<TIED, 2>;
  }
  *smem = Stage<TIED, MAX_NT>::BYTES;
  return entropy_mma_kernel<TIED, MAX_NT>;
}

MmaKernel mma_kernel(int tied, int B, size_t* smem) {
  const int nt = n_tiles_n(B);
  return tied ? mma_kernel<1>(nt, smem) : mma_kernel<0>(nt, smem);
}

}  // namespace

// The scalar statistics kernel (dtype 0 = float32, 1 = bf16; W (d, Vp) with
// any strides (sd, sv)) and the merge: two launches.  part holds
// ceil(Vp / 256) partials per row.
extern "C" int entropy_probe(int dtype, const void* h, const void* w,
                             void* part, void* out, int B, int d, int Vp,
                             long long sd, long long sv, int vocab,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_scalar<float>(h, w, part, out, B, d, Vp, sd, sv, vocab, s);
  if (dtype == 1)
    return launch_scalar<__nv_bfloat16>(h, w, part, out, B, d, Vp, sd, sv, vocab, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core statistics kernel and the merge: two launches.  W is
// untied (tied = 0: strides (ld, 1)) or the tied view (tied = 1: strides
// (1, ld)); ld and d multiples of 8, h and w 16-byte aligned.  part holds
// n_part partials per row, n_part <= ceil(Vp / 128) (each block takes at
// least one tile).
extern "C" int entropy_probe_mma(const void* h, const void* w, void* part,
                                 void* out, int B, int d, int Vp, long long ld,
                                 int tied, int vocab, int n_part, void* stream) {
  if (B < 1 || d < 8 || d % 8 || Vp < 1 || ld % 8 || n_part < 1 ||
      n_part > (Vp + TVM - 1) / TVM || reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  const MmaKernel kernel = mma_kernel(tied, B, &smem);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 8 * n_tiles_n(B);
  kernel<<<dim3(n_part, (B + rows - 1) / rows), MMA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(part), B, d, Vp, ld, vocab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<B, TV, 0, s>>>(static_cast<const float*>(part),
                                static_cast<float*>(out), B, n_part);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the tensor-core statistics kernel a call of B
// rows in this layout launches, for the wrapper's grid.
extern "C" int entropy_probe_occupancy(int tied, int B, int* blocks) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const MmaKernel kernel = mma_kernel(tied, B, &smem);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            MMA_THREADS, smem);
}
