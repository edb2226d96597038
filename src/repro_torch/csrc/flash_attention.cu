// Masked GQA flash attention with explicit integer positions, for Hopper
// (sm_90a).  The prefill attention of the serving path.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas).  Semantics are the reference's: a key is valid
// when its position is >= 0, and (causal) not after the query's position,
// and (window > 0) less than `window` positions behind it.  q head h reads
// kv head h / g.  Dv may differ from Dk.  Rows with no valid key give 0.
//
// One block per (query tile of BQ rows, q head, batch row) walks the kv
// axis in tiles of BKV keys held in shared memory, with a float32 online
// softmax (running max, sum, weighted-V accumulator) per query row, so the
// (Sq, Skv) score matrix never reaches device memory.  A kv tile in which
// no (query, key) pair of the block is valid -- the upper triangle of a
// causal prefill -- is skipped before its K/V are loaded: a fully masked
// tile is an exact identity step on the softmax state.
//
// What bounds it on the H100: operations.  A causal prefill does about
// 2 * B * Hq * S^2 * D FLOPs over 4 * B * S * (Hq + 2 Hkv) * D bytes of
// q/k/v/out -- hundreds of FLOPs per byte at S = 512, so it is the tensor
// cores' 989 bf16 TFLOP/s that bound it.  This first kernel computes with
// scalar float32 FMAs from shared memory (67 TFLOP/s of float32 at best);
// moving the two products onto wgmma is the next step for this kernel.

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

}  // namespace

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
