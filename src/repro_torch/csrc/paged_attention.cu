// Page-table-native flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py
// (paged_attention_pallas).  For each (batch row b, kv head h) one block
// walks the row's compacted mapped-page list in increasing rank order and
// keeps an online softmax (running max m, sum l, weighted-V acc) for the
// m*g query rows that share kv head h (every decode/probe position times
// every GQA head of the group).  Ranks at or past counts[b] are skipped.
//
// What bounds it on the H100: bytes.  A call reads each mapped K/V page
// once (2 * ps * D * dtype bytes per page and kv head) and does m*g*2*D
// FLOPs per cached token -- under 16 FLOP per byte at decode widths, far
// below the ~295 the card needs before compute matters.  The design reads
// each page exactly once per (row, kv head) and scores every query row of
// the group against it from shared memory, so GQA costs no extra traffic.
//
// What it keeps from the reference, deliberately: the KV axis is NOT split
// across blocks.  Pages are folded in rank (= logical) order, masked
// probabilities are exactly 0, and a fully masked page is therefore an
// exact identity step on (m, l, acc).  That is what makes a paged call
// (mapped pages only) bitwise equal to the ring call (every logical block
// through an identity page list) -- the serving stack's paged == ring
// contract (repro/kernels/paged_attention/ref.py).
//
// Simple first: scalar FMA from shared memory, no tensor cores.  Making it
// fast (split-K with a deterministic merge, wgmma) is later work.

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::round_t;
using repro::to_f;

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q,         // (B, Hkv, rows, Dk)
    const T* __restrict__ k_pool,    // (P, ps, Hkv, Dk)
    const T* __restrict__ v_pool,    // (P, ps, Hkv, Dv)
    const int* __restrict__ pages,   // (B, NBK)
    const int* __restrict__ counts,  // (B,)
    const int* __restrict__ bpos,    // (B, NBK, ps)
    const int* __restrict__ q_pos,   // (B, rows)
    T* __restrict__ out,             // (B, Hkv, rows, Dv)
    int Hkv, int rows, int Dk, int Dv, int ps, int NBK, int window,
    float scale) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int ldk = Dk + 1;  // padded row: no bank conflicts on K reads
  extern __shared__ float smem[];
  float* qs = smem;                  // rows * Dk
  float* ks = qs + rows * Dk;        // ps * ldk
  float* vs = ks + ps * ldk;         // ps * Dv
  float* ps_s = vs + ps * Dv;        // rows * ps: scores, then probabilities
  float* acc = ps_s + rows * ps;     // rows * Dv
  float* m_s = acc + rows * Dv;      // rows
  float* l_s = m_s + rows;           // rows
  float* alpha_s = l_s + rows;       // rows
  int* kp_s = reinterpret_cast<int*>(alpha_s + rows);  // ps
  int* qp_s = kp_s + ps;                                // rows

  const float scale_t = round_t<T>(scale);
  const T* qb = q + ((size_t)b * Hkv + h) * rows * Dk;
  for (int i = tid; i < rows * Dk; i += THREADS)
    qs[i] = round_t<T>(to_f(qb[i]) * scale_t);
  for (int i = tid; i < rows * Dv; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < rows; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    qp_s[r] = q_pos[(size_t)b * rows + r];
  }
  const int n = counts[b];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const size_t base = (size_t)pages[(size_t)b * NBK + j] * ps;
    for (int i = tid; i < ps * Dk; i += THREADS) {
      const int t = i / Dk, d = i - t * Dk;
      ks[t * ldk + d] = to_f(k_pool[((base + t) * Hkv + h) * Dk + d]);
    }
    for (int i = tid; i < ps * Dv; i += THREADS) {
      const int t = i / Dv, d = i - t * Dv;
      vs[i] = to_f(v_pool[((base + t) * Hkv + h) * Dv + d]);
    }
    for (int t = tid; t < ps; t += THREADS)
      kp_s[t] = bpos[((size_t)b * NBK + j) * ps + t];
    __syncthreads();

    for (int i = tid; i < rows * ps; i += THREADS) {
      const int r = i / ps, t = i - r * ps;
      float s = 0.f;
      for (int d = 0; d < Dk; ++d) s += qs[r * Dk + d] * ks[t * ldk + d];
      const int kp = kp_s[t], qp = qp_s[r];
      const bool valid = kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
      ps_s[i] = valid ? s : NEG_INF;
    }
    __syncthreads();

    for (int r = tid; r < rows; r += THREADS) {
      const float m_prev = m_s[r];
      float m_new = m_prev;
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, ps_s[r * ps + t]);
      const int qp = qp_s[r];
      float lsum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const int kp = kp_s[t];
        const bool valid = kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
        const float p = valid ? expf(ps_s[r * ps + t] - m_new) : 0.f;
        lsum += p;
        ps_s[r * ps + t] = round_t<T>(p);
      }
      const float alpha = expf(m_prev - m_new);
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + lsum;
      alpha_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < rows * Dv; i += THREADS) {
      const int r = i / Dv, d = i - r * Dv;
      float pv = 0.f;
      for (int t = 0; t < ps; ++t) pv += ps_s[r * ps + t] * vs[t * Dv + d];
      acc[i] = acc[i] * alpha_s[r] + pv;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * Hkv + h) * rows * Dv;
  for (int i = tid; i < rows * Dv; i += THREADS) {
    const float l = l_s[i / Dv];
    ob[i] = from_f<T>(l > 0.f ? acc[i] / fmaxf(l, 1e-30f) : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* pages, const void* counts, const void* bpos,
                   const void* q_pos, void* out, int B, int Hkv, int rows,
                   int Dk, int Dv, int ps, int NBK, int window, float scale,
                   cudaStream_t stream) {
  const size_t floats = (size_t)rows * Dk + (size_t)ps * (Dk + 1) +
                        (size_t)ps * Dv + (size_t)rows * ps +
                        (size_t)rows * Dv + 3 * (size_t)rows;
  const size_t smem = floats * sizeof(float) + (size_t)(ps + rows) * sizeof(int);
  cudaError_t err = repro::allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T><<<dim3(B, Hkv), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(pages),
      static_cast<const int*>(counts), static_cast<const int*>(bpos),
      static_cast<const int*>(q_pos), static_cast<T*>(out), Hkv, rows, Dk, Dv,
      ps, NBK, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* pages, const void* counts, const void* bpos,
    const void* q_pos, void* out, int B, int Hkv, int rows, int Dk, int Dv,
    int ps, int NBK, int window, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, pages, counts, bpos, q_pos, out,
                         B, Hkv, rows, Dk, Dv, ps, NBK, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, pages, counts, bpos,
                                 q_pos, out, B, Hkv, rows, Dk, Dv, ps, NBK,
                                 window, scale, s);
  return (int)cudaErrorInvalidValue;
}
