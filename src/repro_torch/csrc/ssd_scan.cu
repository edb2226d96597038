// Mamba2 SSD chunk scan for Hopper (sm_90a): the SSM prefill.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py (ssd_scan_pallas)
// and computes what repro/models/ssm.py ssd_chunked computes, initial state
// included.  Per (row b, head h), over chunks of L steps in order:
//
//   intra:  y_t  = sum_{s<=t} (C_t . B_s) exp(cs_t - cs_s) u_s
//   inter:  y_t += exp(cs_t) C_t . h_prev
//   state:  h    = exp(cs_L) h_prev + sum_s exp(cs_L - cs_s) B_s u_s^T
//
// with cs the inclusive cumsum of logd over the chunk.  The decays are
// formed as exp(cs_t - cs_s) and exp(cs_L - cs_s), never as a product of
// exp(cs_t) and exp(-cs_s): logd cumsums to below -1000 on the fast-decaying
// heads of mamba2-2.7b, where exp(cs) alone underflows to 0.
//
// On the TPU the chunk axis of the grid ran in order and the state lived in
// VMEM scratch across grid steps.  Here one block owns one (b, h) and loops
// over the chunks itself, the state (N x hp float32) resident in shared
// memory from h0 (zeros when h0 is NULL) to h_final.  A chunk's u and B
// stay in shared memory for the whole chunk; the L x L matrix C B^T does
// not fit beside them at L = N = 128 (about 256 KB against the 227 KB a
// block may hold), so the intra and inter terms run over tiles of TR rows:
// TR rows of C, the TR x L masked C B^T, then the TR output rows.  The
// state update follows once every tile has read h_prev.  Padding: steps
// past S are never loaded; a partial last chunk runs over its len < L
// steps, which is what ssd_chunked's zero padding (logd = 0, u = B = C = 0)
// computes.  B and C of group h / (nh / G) serve head h.
//
// What bounds it on the H100: operations.  Per (b, h, chunk of len steps)
// the causal triangle of C B^T and its product with U cost
// len (len + 1) (N + hp) FLOPs, C h_prev and the state update 4 len N hp; a
// mamba2-2.7b prefill of B 4, S 512 (L = N = 128, hp = 64, 80 heads) is
// 9.43 GFLOP against 107 MB moved (u, y, logd, B, C, h0, h_final), about 88
// FLOPs per byte, well above float32's 67 TFLOP/s / 3.35 TB/s = 20.  This first
// version runs scalar float32 FMAs from shared memory, each thread holding
// a small register tile (rows by warp, columns by lane), so that one
// shared-memory load feeds several FMAs; tensor cores (TF32 or 3xTF32
// wgmma) and TMA are later work.  At one 165 KB block per SM, B * nh
// blocks fill the card in waves (320 blocks at B 4, 80 at a B 1
// admission).

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
