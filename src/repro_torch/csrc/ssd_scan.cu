// Mamba2 SSD chunk scan for Hopper (sm_90a): the SSM prefill.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py (ssd_scan_pallas)
// and computes what repro/models/ssm.py ssd_chunked computes, initial state
// included.  Per (row b, head h), over chunks of L steps:
//
//   intra:  y_t  = sum_{s<=t} (C_t . B_s) exp(cs_t - cs_s) u_s
//   inter:  y_t += exp(cs_t) C_t . h_prev
//   state:  h    = exp(cs_L) h_prev + sum_s exp(cs_L - cs_s) B_s u_s^T
//
// with cs the inclusive cumsum of logd over the chunk, taken in step order
// by one thread (at |cs| ~ 1000 one float32 ulp is 6e-5; a parallel scan
// would round differently).  The decays are formed as exp(cs_t - cs_s) and
// exp(cs_L - cs_s), never as a product of exp(cs_t) and exp(-cs_s): logd
// cumsums to below -1000 on fast-decaying heads, where exp(cs) alone
// underflows to 0.  B and C of group h / (nh / G) serve head h.  Padding: a
// partial last chunk runs over its len < L steps with u = B = C = 0 past
// len, which is what ssd_chunked's zero padding (logd = 0) computes.
//
// What bounds it on the H100: operations.  Per (b, group, chunk of len
// steps) the causal triangle of C B^T costs len (len + 1) N FLOPs; per
// (b, h, chunk) its product with U costs len (len + 1) hp, C h_prev and the
// state update 4 len N hp.  A mamba2-2.7b prefill of B 4, S 512 (L = N =
// 128, hp = 64, 80 heads, G = 1) is 6.76 GFLOP against 107 MB moved (u, y,
// logd, B, C, h0, h_final).  Two variants, chosen by the wrapper from the
// shape alone (ops.ssd_variant):
//
// "mma" (L, N and hp multiples of 8): the chunked SSD decomposition on the
// tensor cores, every chunk in parallel, three launches on one stream and
// no state kept between calls:
//   1. ssd_state_kernel, grid (chunk, nh + G * L / 64, b).  A block with
//      y < nh takes one chunk of one head: the chunk's cumsum, its total
//      cs_L (into a (B, nh, nc) scratch) and its state
//      S_c = (w * B)^T U, w_s = exp(cs_L - cs_s), into a (B, nh, nc, N, hp)
//      scratch.  A block with y >= nh computes 64 rows of one group's C B^T
//      over the causal triangle into a (B, nc, G, Lp, Lp) scratch (Lp = L
//      rounded up to 16), once for all the heads of the group.
//   2. ssd_pass_kernel, grid (b * nh, slices of N hp): the pass over the
//      chunks, the only sequential part and elementwise: h_before[c] = h
//      over S_c, then h = exp(cs_L) h + S_c, from h0 (zeros when NULL), and
//      h_final.
//   3. ssd_out_kernel, grid (chunk, head, b): y = exp(cs_t) (C h_before)
//      + M U, M = (C B^T) * exp(cs_t - cs_s) over the causal triangle and
//      0 above it.
// Every product runs as 3xTF32 on mma.sync.m16n8k8 with float32
// accumulators: each operand x (U, w * B, C, B, M, h_before) splits on the
// fly into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna); each k-step's
// lo.hi + hi.lo + hi.hi sums from zero and is added to the float32
// accumulator to nearest.  One TF32 product misses the 1e-5 float32
// bar many times over at mamba2-2.7b's shapes; the split keeps about 22 of
// float32's 24 bits (tests/test_torch_ssd_mma.py emulates both).  The
// bound of this variant is the tensor cores': three times the FLOPs above
// at the dense TF32 rate, 495 TFLOP/s, which only wgmma reaches; mma.sync
// runs well below it.  A block runs 8 warps on 32 x 32 output tiles with
// compile-time tile counts (a missing tile is computed from padding and
// dropped); in the output kernel warp pair p takes m-tiles p and 7 - p, so
// the causal triangle's work splits evenly.  Operands arrive by cp.async
// into rows padded against bank conflicts.  Each block holds about 105 KB
// of shared memory, two per SM: the output kernel loads C and h_before for
// the inter term, then reuses that space for M and U.
//
// "scalar" (ssd_scan_kernel, any shape within the limits): the first port.
// One block per (b, h) walks the chunks in order, the state (N x hp
// float32) resident in shared memory from h0 to h_final; scalar float32
// FMAs from shared memory, each thread holding a small register tile (rows
// by warp, columns by lane).  The L x L matrix C B^T does not fit beside u
// and B at L = N = 128, so the intra and inter terms run over tiles of TR
// rows, the state update once every tile has read h_prev.  Its bound is
// float32 FMAs at 67 TFLOP/s, and its grid of B * nh blocks of 165 KB, one
// per SM, leaves SMs idle at a B 1 admission (80 blocks on 132 SMs).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int N_MAX = 128;         // d_state bound
constexpr int WARPS = THREADS / 32;
constexpr int TR = 32;             // rows (steps) of one intra-chunk tile
constexpr int RT = TR / WARPS;     // tile rows per thread
constexpr int RS = 4;              // chunk columns per thread (L <= 128)
constexpr int RP = 2;              // head-dim columns per thread (hp <= 64)
constexpr int RN = N_MAX / WARPS;  // state rows per thread in the update

size_t smem_floats(int N, int hp, int L) {
  return (size_t)N * hp + (size_t)L * hp + (size_t)L * (N + 1) + (size_t)TR * N +
         (size_t)TR * L + 2 * (size_t)L;
}

// One instantiation serves every SSM config of the repo (head_dim <= 64,
// d_state <= 128): columns past hp and state rows past N are clamped on
// load and skipped on store.
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const float* __restrict__ u, const float* __restrict__ logd,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ hf, int S, int nh, int hp, int G, int N,
                int L) {
  extern __shared__ float smem[];
  const int NB = N + 1;              // padded row stride: conflict-free columns
  float* sh_h = smem;                // N x hp   running state
  float* sh_u = sh_h + N * hp;       // L x hp   the chunk's u
  float* sh_b = sh_u + L * hp;       // L x NB   the chunk's B rows
  float* sh_c = sh_b + L * NB;       // TR x N   the tile's C rows
  float* sh_m = sh_c + TR * N;       // TR x L   the tile's masked C B^T
  float* sh_cs = sh_m + TR * L;      // L        inclusive cumsum of logd
  float* sh_w = sh_cs + L;           // L        exp(cs_L - cs_s)

  const int head = blockIdx.x, b = blockIdx.y;
  const int g = head / (nh / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t state = ((size_t)b * nh + head) * N * hp;
  // element (step t, column j) of a (B, S, X, J) tensor, for this b
  auto at = [&](int t, int x, int X, int J, int j) {
    return (((size_t)b * S + t) * X + x) * J + j;
  };

  for (int i = tid; i < N * hp; i += THREADS) sh_h[i] = h0 ? h0[state + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int len = min(L, S - c0);
    __syncthreads();  // the previous chunk's state update is done with sh_u/sh_b
    for (int i = tid; i < len * hp; i += THREADS) {
      const int t = i / hp;
      sh_u[i] = u[at(c0 + t, head, nh, hp, i - t * hp)];
    }
    for (int i = tid; i < len * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      sh_b[t * NB + n] = bm[at(c0 + t, g, G, N, n)];
    }
    for (int t = tid; t < len; t += THREADS) sh_cs[t] = logd[at(c0 + t, 0, 1, nh, head)];
    __syncthreads();
    if (tid == 0)
      for (int t = 1; t < len; ++t) sh_cs[t] += sh_cs[t - 1];
    __syncthreads();
    const float total = sh_cs[len - 1];
    for (int t = tid; t < len; t += THREADS) sh_w[t] = expf(total - sh_cs[t]);

    for (int t0 = 0; t0 < len; t0 += TR) {
      const int rows = min(TR, len - t0);
      for (int i = tid; i < rows * N; i += THREADS) {
        const int r = i / N;
        sh_c[i] = cm[at(c0 + t0 + r, g, G, N, i - r * N)];
      }
      __syncthreads();
      {  // sh_m[i][s] = (C_i . B_s) exp(cs_t - cs_s) for s <= t = t0 + i
        float acc[RT][RS] = {};
        for (int n = 0; n < N; ++n) {
          float cv[RT], bv[RS];
#pragma unroll
          for (int r = 0; r < RT; ++r) cv[r] = sh_c[min(warp + WARPS * r, rows - 1) * N + n];
#pragma unroll
          for (int q = 0; q < RS; ++q) bv[q] = sh_b[min(lane + 32 * q, len - 1) * NB + n];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int q = 0; q < RS; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = warp + WARPS * r, t = t0 + i;
#pragma unroll
          for (int q = 0; q < RS; ++q) {
            const int s = lane + 32 * q;
            if (s < L)
              sh_m[i * L + s] =
                  (s <= t && t < len) ? acc[r][q] * expf(sh_cs[t] - sh_cs[s]) : 0.f;
          }
        }
      }
      __syncthreads();
      {  // y_t = sh_m[i] . U + exp(cs_t) C_i . h_prev
        float acc[RT][RP] = {}, inter[RT][RP] = {};
        const int s_end = min(len, t0 + rows);   // sh_m is 0 past the diagonal
        for (int s = 0; s < s_end; ++s) {
          float mv[RT], uv[RP];
#pragma unroll
          for (int r = 0; r < RT; ++r) mv[r] = sh_m[(warp + WARPS * r) * L + s];
#pragma unroll
          for (int q = 0; q < RP; ++q) uv[q] = sh_u[s * hp + min(lane + 32 * q, hp - 1)];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int q = 0; q < RP; ++q) acc[r][q] = fmaf(mv[r], uv[q], acc[r][q]);
        }
        for (int n = 0; n < N; ++n) {
          float cv[RT], hv[RP];
#pragma unroll
          for (int r = 0; r < RT; ++r) cv[r] = sh_c[min(warp + WARPS * r, rows - 1) * N + n];
#pragma unroll
          for (int q = 0; q < RP; ++q) hv[q] = sh_h[n * hp + min(lane + 32 * q, hp - 1)];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int q = 0; q < RP; ++q) inter[r][q] = fmaf(cv[r], hv[q], inter[r][q]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = warp + WARPS * r;
          if (i >= rows) continue;
          const float decay = expf(sh_cs[t0 + i]);
#pragma unroll
          for (int q = 0; q < RP; ++q) {
            const int p = lane + 32 * q;
            if (p < hp) y[at(c0 + t0 + i, head, nh, hp, p)] = acc[r][q] + decay * inter[r][q];
          }
        }
      }
      __syncthreads();  // the next tile rewrites sh_c and sh_m
    }

    {  // h = exp(cs_L) h_prev + sum_s (exp(cs_L - cs_s) B_s) u_s^T
      float acc[RN][RP] = {};
      for (int s = 0; s < len; ++s) {
        const float ws = sh_w[s];
        float bv[RN], uv[RP];
#pragma unroll
        for (int r = 0; r < RN; ++r) bv[r] = ws * sh_b[s * NB + min(warp + WARPS * r, N - 1)];
#pragma unroll
        for (int q = 0; q < RP; ++q) uv[q] = sh_u[s * hp + min(lane + 32 * q, hp - 1)];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) acc[r][q] = fmaf(bv[r], uv[q], acc[r][q]);
      }
      const float a = expf(total);
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int n = warp + WARPS * r;
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          const int p = lane + 32 * q;
          if (n < N && p < hp) sh_h[n * hp + p] = a * sh_h[n * hp + p] + acc[r][q];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * hp; i += THREADS) hf[state + i] = sh_h[i];
}


// --------------------------------------------------------------------- mma

constexpr int MMA_THREADS = 256;  // 8 warps, each on 32 x 32 output tiles
constexpr int CB_ROWS = 64;       // rows of C B^T per block

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Row strides (floats) of the shared-memory operands, free of bank
// conflicts for the fragment reads: 4 mod 32 where a warp reads 8 rows of 4
// consecutive floats, 8 mod 32 where it reads 4 rows of 8.
__host__ __device__ constexpr int ld4(int cols) { return round_up(cols, 32) + 4; }
__host__ __device__ constexpr int ld8(int cols) { return round_up(cols, 32) + 8; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d = a b + c (float32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], const float (&c)[4]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// acc[i][j] += sum_k A(row0[i] + r, k) B(k, col0 + 8 j + c) in 3xTF32 over
// the warp's MT m-tiles of 16 rows and NT n-tiles of 8 columns, for
// k0 <= k < k1 (multiples of 8).  a(r, k) and b(k, c) read the operands
// from shared memory.  Every tile is computed: the tile counts are
// compile-time, which keeps the mma unpredicated (with runtime counts the
// loop ran markedly slower on the H100); callers point a missing m-tile at
// a real one and drop missing tiles when they store.  Fragments of mma.m16n8k8 .tf32,
// lane = 4 g + q: A (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4);
// B (q, g), (q + 4, g); C (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).
// The tensor cores round each sum they add into an accumulator more
// coarsely than float32's round-to-nearest, at the accumulator's scale:
// each k-step's three products therefore start from zero in a fragment of
// their own, which is then added to acc in float32 (as many roundings at
// acc's scale as k-steps, each to nearest).  The error of y then matches
// the scalar kernel's, so that its bf16 roundings in the model match the
// plain version's as often.
template <int MT, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma3(float (&acc)[MT][NT][4], FA a, FB b,
                                     const int (&row0)[MT], int col0, int k0,
                                     int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = col0 + 8 * j + g;
      split_tf32(b(k + q, c), bh[j][0], bl[j][0]);
      split_tf32(b(k + q + 4, c), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = row0[i] + g;
      split_tf32(a(r, k + q), ah[i][0], al[i][0]);
      split_tf32(a(r + 8, k + q), ah[i][1], al[i][1]);
      split_tf32(a(r, k + q + 4), ah[i][2], al[i][2]);
      split_tf32(a(r + 8, k + q + 4), ah[i][3], al[i][3]);
    }
    float step[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(step[i][j], al[i], bh[j], zero);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(step[i][j], ah[i], bl[j], step[i][j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_tf32(step[i][j], ah[i], bh[j], step[i][j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += step[i][j][e];
      }
  }
}

// f(row, col, value) for every accumulator element of the warp's tiles,
// skipping m-tiles with row0[i] < 0 and n-tiles from nt on
template <int MT, int NT, typename F>
__device__ __forceinline__ void for_each_acc(float (&acc)[MT][NT][4],
                                             const int (&row0)[MT], int col0,
                                             int nt, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (row0[i] < 0) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(row0[i] + g + 8 * (e >> 1), col0 + 8 * j + 2 * q + (e & 1), acc[i][j][e]);
    }
  }
}

// 16 bytes from global to shared memory without a stop in registers
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// wait for every copy this thread has started
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Start the copies dst[r * ld + c] = src[r * stride + c] for r < valid_rows
// and c < valid_cols; 0 (stored at once) elsewhere in rows x cols.  cols,
// valid_cols, ld and stride are multiples of 4 and src is 16-byte aligned.
// Every copy of the block is in flight together until the caller waits
// for them (then a barrier).  The threads walk the 16-byte pieces in order
// without a division per piece: the copies' own instructions compete with
// the mma for issue slots.
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src,
                                          size_t stride, int rows, int cols,
                                          int valid_rows, int valid_cols) {
  const int c4 = cols / 4;
  if (c4 == 0) return;
  const int dr = blockDim.x / c4, dc = blockDim.x - dr * c4;
  int r = threadIdx.x / c4, c = threadIdx.x - r * c4;
  while (r < rows) {
    if (r < valid_rows && 4 * c < valid_cols)
      cp_async16(dst + r * ld + 4 * c, src + r * stride + 4 * c);
    else
      *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = make_float4(0.f, 0.f, 0.f, 0.f);
    r += dr;
    c += dc;
    if (c >= c4) {
      c -= c4;
      ++r;
    }
  }
}

// cs[t] = logd_0 + ... + logd_t over the chunk (logd[t * nh] is step t), in
// step order, for t < len; 0 for len <= t < Lp.  Also ends the block's
// copies in flight.  Ends synchronised.
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* __restrict__ logd,
                                             int nh, int len, int Lp) {
  for (int t = threadIdx.x; t < Lp; t += blockDim.x)
    cs[t] = t < len ? logd[(size_t)t * nh] : 0.f;
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 1; t < len; ++t) cs[t] += cs[t - 1];
  __syncthreads();
}

// C B^T of group g's chunk c, rows t0 .. t0 + CB_ROWS - 1: cb[b, c, g][t][s]
// = C_t . B_s over the 32-column tiles that reach s <= t (tiles wholly above
// the diagonal are skipped; entries above it inside a tile are written but
// never read).  Warp w: rows t0 + 32 (w / 4) .., columns 32 (w % 4) ..
__device__ __forceinline__ void cb_tile(float* smem, const float* __restrict__ bm,
                                        const float* __restrict__ cm,
                                        float* __restrict__ cb, int b, int c, int g,
                                        int t0, int S, int nc, int G, int N, int L) {
  const int Lp = round_up(L, 16), ld = ld4(N);
  const int c0 = c * L, len = min(L, S - c0);
  if (t0 >= len) return;
  float* sc = smem;                 // CB_ROWS x ld: C rows t0 ..
  float* sb = sc + CB_ROWS * ld;    // B rows 0 .. (at most t0 + CB_ROWS)
  const size_t row = (size_t)G * N;  // between steps of bm and cm
  const size_t base = ((size_t)b * S + c0) * row + (size_t)g * N;
  copy_tile(sc, ld, cm + base + t0 * row, row, CB_ROWS, N, len - t0, N);
  copy_tile(sb, ld, bm + base, row, min(t0 + CB_ROWS, round_up(len, 8)), N, len, N);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int r0 = t0 + 32 * (warp >> 2), col0 = 32 * (warp & 3);
  if (r0 >= len || col0 > r0) return;
  const int nt = min(4, (min(round_up(len, 8), r0 + 32) - col0) / 8);
  const int rows[2] = {r0 - t0, r0 - t0 + 16};  // rows past len are zeros
  const int row0[2] = {rows[0], r0 + 16 < len ? rows[1] : -1};
  float acc[2][4][4] = {};
  mma3(acc, [&](int r, int k) { return sc[r * ld + k]; },
       [&](int k, int s) { return sb[s * ld + k]; }, rows, col0, 0, N);
  float* out = cb + (((size_t)b * nc + c) * G + g) * Lp * Lp;
  for_each_acc(acc, row0, col0, nt,
               [&](int r, int s, float v) { out[(size_t)(t0 + r) * Lp + s] = v; });
}

// The state of chunk c of (b, head), S_c = sum_s exp(cs_L - cs_s) B_s u_s^T
// (N x hp), into st, and its total cs_L into tot.  Warp w: state rows
// 32 (w / 2) .., columns 32 (w % 2) ..
__device__ __forceinline__ void chunk_state(float* smem, const float* __restrict__ u,
                                            const float* __restrict__ logd,
                                            const float* __restrict__ bm,
                                            float* __restrict__ st, float* __restrict__ tot,
                                            int b, int head, int c, int S, int nc,
                                            int nh, int hp, int G, int N, int L) {
  const int Lp = round_up(L, 16), Np = round_up(N, 16);
  const int ldw = ld8(Np), ldu = ld8(hp);
  const int g = head / (nh / G), c0 = c * L, len = min(L, S - c0);
  const int K = round_up(len, 8);
  float* cs = smem;             // Lp
  float* w = cs + Lp;           // Lp: exp(cs_L - cs_s), 0 past len
  float* sb = w + Lp;           // K x ldw: B, step-major
  float* su = sb + Lp * ldw;    // K x ldu
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t row = (size_t)G * N, urow = (size_t)nh * hp;
  const float* bsrc = bm + ((size_t)b * S + c0) * row + (size_t)g * N;
  const float* usrc = u + (((size_t)b * S + c0) * nh + head) * hp;
  copy_tile(sb, ldw, bsrc, row, K, Np, len, N);
  copy_tile(su, ldu, usrc, urow, K, hp, len, hp);
  chunk_cumsum(cs, logd + ((size_t)b * S + c0) * nh + head, nh, len, Lp);
  const float total = cs[len - 1];
  if (tid == 0) tot[((size_t)b * nh + head) * nc + c] = total;
  for (int s = tid; s < Lp; s += MMA_THREADS) w[s] = s < len ? expf(total - cs[s]) : 0.f;
  __syncthreads();
  const int r0 = 32 * (warp >> 1), col0 = 32 * (warp & 1);
  const int nt = min(4, (hp - col0) / 8);
  const bool busy = nt > 0 && r0 < Np;
  // state rows past Np read within sb's padded rows, and are dropped
  const int rows[2] = {r0, r0 + 16};
  const int row0[2] = {r0, r0 + 16 < Np ? r0 + 16 : -1};
  float acc[2][4][4] = {};
  auto a = [&](int n, int s) { return sb[s * ldw + n] * w[s]; };
  auto bu = [&](int s, int p) { return su[s * ldu + p]; };
  if (!busy) return;
  mma3(acc, a, bu, rows, col0, 0, K);
  float* out = st + (((size_t)b * nh + head) * nc + c) * N * hp;
  for_each_acc(acc, row0, col0, nt, [&](int n, int p, float v) {
    if (n < N) out[n * hp + p] = v;
  });
}

__device__ __forceinline__ float4 axpy4(float a, float4 h, float4 s) {
  return make_float4(a * h.x + s.x, a * h.y + s.y, a * h.z + s.z, a * h.w + s.w);
}

// 1. Grid (chunk, nh + G * row tiles, b).  Blocks with y < nh: the state
// of chunk x of head y.  Blocks with y >= nh: a CB_ROWS-row tile of C B^T of
// one group.
__global__ void __launch_bounds__(MMA_THREADS, 2)
ssd_state_kernel(const float* __restrict__ u, const float* __restrict__ logd,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 float* __restrict__ st, float* __restrict__ tot,
                 float* __restrict__ cb, int S, int nh, int hp, int G, int N, int L) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.z;
  if (blockIdx.y >= nh) {
    const int i = blockIdx.y - nh, tiles = (L + CB_ROWS - 1) / CB_ROWS;
    cb_tile(smem, bm, cm, cb, b, c, i / tiles, (i % tiles) * CB_ROWS, S, nc, G, N, L);
    return;
  }
  chunk_state(smem, u, logd, bm, st, tot, b, blockIdx.y, c, S, nc, nh, hp, G, N, L);
}

// 2. The recurrence over the chunks of (b, h) = x, NH = N hp state elements,
// four per thread (slice y): h_before[c] = h overwrites S_c, then
// h = exp(cs_L) h + S_c, from h0 (zeros when NULL); h_final to hf.  The
// loads of PASS_CHUNKS chunks are in flight together, ahead of their
// stores.
constexpr int PASS_CHUNKS = 8;
__global__ void __launch_bounds__(MMA_THREADS)
ssd_pass_kernel(const float* __restrict__ h0, float* __restrict__ st,
                const float* __restrict__ tot, float* __restrict__ hf, int nc, int NH) {
  const size_t bh = blockIdx.x, step = NH / 4;
  const int i = blockIdx.y * MMA_THREADS + threadIdx.x;  // float4 of the state
  if (4 * i >= NH) return;
  const size_t q = bh * step + i;
  float4 h = h0 ? __ldg(reinterpret_cast<const float4*>(h0) + q)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* sc = reinterpret_cast<float4*>(st + bh * nc * NH) + i;
  for (int c0 = 0; c0 < nc; c0 += PASS_CHUNKS) {
    float4 s[PASS_CHUNKS];
    float a[PASS_CHUNKS];
#pragma unroll
    for (int k = 0; k < PASS_CHUNKS; ++k)
      if (c0 + k < nc) {
        s[k] = sc[(c0 + k) * step];
        a[k] = expf(tot[bh * nc + c0 + k]);
      }
#pragma unroll
    for (int k = 0; k < PASS_CHUNKS; ++k)
      if (c0 + k < nc) {
        sc[(c0 + k) * step] = h;
        h = axpy4(a[k], h, s[k]);
      }
  }
  reinterpret_cast<float4*>(hf)[q] = h;
}

// 3. y of one chunk of one (b, h).  Warp w: columns 32 (w % 2) .., the
// m-tiles p and 7 - p (p = w / 2) of 16 rows each, so that every warp pair
// covers 9 of the triangle's 36 16 x 16 tiles in the intra term.
__global__ void __launch_bounds__(MMA_THREADS, 2)
ssd_out_kernel(const float* __restrict__ u, const float* __restrict__ logd,
               const float* __restrict__ cm, const float* __restrict__ st,
               const float* __restrict__ cb, float* __restrict__ y, int S,
               int nh, int hp, int G, int N, int L) {
  extern __shared__ float smem[];
  const int Lp = round_up(L, 16);
  const int ldc = ld4(N), ldh = ld8(hp), ldm = ld4(Lp), ldu = ld8(hp);
  const int c = blockIdx.x, head = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int g = head / (nh / G), c0 = c * L, len = min(L, S - c0);
  const int K = round_up(len, 8);
  float* cs = smem;              // Lp
  float* sc = cs + Lp;           // Lp x ldc   C rows          (inter term)
  float* sh = sc + Lp * ldc;     // N x ldh    h_before        (inter term)
  float* sm = cs + Lp;           // Lp x ldm   M, over sc/sh   (intra term)
  float* su = sm + Lp * ldm;     // K x ldu    U               (intra term)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row = (size_t)G * N, urow = (size_t)nh * hp;
  const float* csrc = cm + ((size_t)b * S + c0) * row + (size_t)g * N;
  const float* hsrc = st + (((size_t)b * nh + head) * nc + c) * N * hp;
  copy_tile(sc, ldc, csrc, row, Lp, N, len, N);
  copy_tile(sh, ldh, hsrc, hp, N, hp, N, hp);
  chunk_cumsum(cs, logd + ((size_t)b * S + c0) * nh + head, nh, len, Lp);

  const int p = warp >> 1, col0 = 32 * (warp & 1);
  const int nt = min(4, (hp - col0) / 8);
  // m-tiles p and 7 - p; a missing second tile (short chunks) recomputes
  // the first and is dropped
  const bool two = 16 * (7 - p) < len;
  const int rows[2] = {16 * p, two ? 16 * (7 - p) : 16 * p};
  const int row0[2] = {16 * p < len ? 16 * p : -1, two ? 16 * (7 - p) : -1};
  const bool busy = nt > 0 && row0[0] >= 0;
  float acc[2][4][4] = {};
  if (busy) {  // y_t = exp(cs_t) (C_t . h_before)
    mma3(acc, [&](int t, int n) { return sc[t * ldc + n]; },
         [&](int n, int q) { return sh[n * ldh + q]; }, rows, col0, 0, N);
    for_each_acc(acc, row0, col0, nt, [&](int t, int, float& v) { v *= expf(cs[t]); });
  }
  __syncthreads();  // sc and sh are read: their space becomes sm and su

  // y_t += sum_{s <= t} M_ts u_s with M_ts = (C_t . B_s) exp(cs_t - cs_s)
  // for s <= t < len, else 0 (a select: entries above the diagonal were
  // never computed)
  copy_tile(sm, ldm, cb + (((size_t)b * nc + c) * G + g) * Lp * Lp, Lp, Lp, K, len, K);
  copy_tile(su, ldu, u + (((size_t)b * S + c0) * nh + head) * hp, urow, K, hp, len, hp);
  cp_async_wait_all();
  __syncthreads();
  for (int t = warp; t < Lp; t += MMA_THREADS / 32)
    for (int s = lane; s < K; s += 32)
      sm[t * ldm + s] = (s <= t && t < len) ? sm[t * ldm + s] * expf(cs[t] - cs[s]) : 0.f;
  __syncthreads();
  if (!busy) return;
  {  // m-tile i needs s < 16 (i + 1): both tiles to the first's end, then
     // the second alone
    const int k_first = min(16 * p + 16, K), k_second = two ? min(16 * (8 - p), K) : 0;
    auto m = [&](int t, int s) { return sm[t * ldm + s]; };
    auto uu = [&](int s, int q) { return su[s * ldu + q]; };
    mma3(acc, m, uu, rows, col0, 0, k_first);
    const int second[1] = {rows[1]};
    mma3(reinterpret_cast<float(&)[1][4][4]>(acc[1]), m, uu, second, col0, k_first,
         k_second);
  }
  float* out = y + (((size_t)b * S + c0) * nh + head) * hp;
  for_each_acc(acc, row0, col0, nt, [&](int t, int q, float v) {
    if (t < len) out[(size_t)t * nh * hp + q] = v;
  });
}

}  // namespace

// u (B, S, nh, hp), logd (B, S, nh), bm/cm (B, S, G, N), h0 (B, nh, N, hp)
// or NULL, y (B, S, nh, hp), hf (B, nh, N, hp); all float32, contiguous.
extern "C" int ssd_scan(const void* u, const void* logd, const void* bm,
                        const void* cm, const void* h0, void* y, void* hf, int B,
                        int S, int nh, int hp, int G, int N, int L, void* stream) {
  if (B < 1 || S < 1 || G < 1 || nh < G || nh % G || hp < 1 || hp > 32 * RP ||
      N < 1 || N > N_MAX || L < 1 || L > 32 * RS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, hp, L) * sizeof(float);
  cudaError_t err = repro::allow_smem(ssd_scan_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  ssd_scan_kernel<<<dim3(nh, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      f(u), f(logd), f(bm), f(cm), f(h0), static_cast<float*>(y),
      static_cast<float*>(hf), S, nh, hp, G, N, L);
  return (int)cudaGetLastError();
}

// The "mma" variant: the same arguments, plus the scratch the wrapper
// allocates: states (B, nh, nc, N, hp), tot (B, nh, nc) and cb
// (B, nc, G, Lp, Lp) float32, uninitialised.  Three launches on `stream`.
extern "C" int ssd_scan_mma(const void* u, const void* logd, const void* bm,
                            const void* cm, const void* h0, void* y, void* hf,
                            void* states, void* tot, void* cb, int B,
                            int S, int nh, int hp, int G, int N, int L, void* stream) {
  if (B < 1 || S < 1 || G < 1 || nh < G || nh % G || hp < 8 || hp > 32 * RP ||
      hp % 8 || N < 8 || N > N_MAX || N % 8 || L < 8 || L > 32 * RS || L % 8)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (S + L - 1) / L, Lp = round_up(L, 16), Np = round_up(N, 16);
  cudaError_t err;

  const size_t state = (size_t)2 * Lp + (size_t)Lp * ld8(Np) + (size_t)Lp * ld8(hp);
  const size_t tile = (size_t)(CB_ROWS + round_up(L, CB_ROWS)) * ld4(N);
  const size_t st_smem = (state > tile ? state : tile) * sizeof(float);
  if ((err = repro::allow_smem(ssd_state_kernel, st_smem)) != cudaSuccess) return (int)err;
  const int tiles = (L + CB_ROWS - 1) / CB_ROWS;
  ssd_state_kernel<<<dim3(nc, nh + G * tiles, B), MMA_THREADS, st_smem, s>>>(
      f(u), f(logd), f(bm), f(cm), w(states), w(tot), w(cb), S, nh, hp, G, N, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int NH = N * hp, slices = (NH / 4 + MMA_THREADS - 1) / MMA_THREADS;
  ssd_pass_kernel<<<dim3(B * nh, slices), MMA_THREADS, 0, s>>>(f(h0), w(states), f(tot),
                                                               w(hf), nc, NH);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t inter = (size_t)Lp * ld4(N) + (size_t)N * ld8(hp);
  const size_t intra = (size_t)Lp * ld4(Lp) + (size_t)Lp * ld8(hp);
  const size_t out_smem = (Lp + (inter > intra ? inter : intra)) * sizeof(float);
  if ((err = repro::allow_smem(ssd_out_kernel, out_smem)) != cudaSuccess) return (int)err;
  ssd_out_kernel<<<dim3(nc, nh, B), MMA_THREADS, out_smem, s>>>(
      f(u), f(logd), f(cm), f(states), f(cb), w(y), S, nh, hp, G, N, L);
  return (int)cudaGetLastError();
}
