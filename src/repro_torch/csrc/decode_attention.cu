// Split-KV flash-decode attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas).  For each (batch row b, kv head h) the
// rows = m*g query rows of the GQA group (every new position times every q
// head sharing kv head h) attend causally, with an optional sliding window,
// over a dense (B, C, Hkv, D) cache.  The mask is decided by kv_pos alone
// (-1 = empty slot), so slot order is irrelevant: ring caches work as they
// are.
//
// What bounds it on the H100: bytes.  The function reads K and V once:
// at B 4, C 4096, Hkv 8, D 128 in bf16 that is 67.1 MB, about 0.020 ms at
// 3.35 TB/s, against m*g*4*D FLOPs per cached key and kv head -- under 8
// FLOP per byte at decode widths.
//
// Why not the TPU kernel's shape: it carries (m, l, acc) across a
// sequential kv-tile grid axis.  On Hopper a grid of B*Hkv blocks is 32
// blocks at B 4 on 132 SMs.  So the kv axis is split: grid (B*Hkv, n_split),
// n_split chosen by the wrapper from C so the grid covers the SMs at least
// twice.  Each block walks its split in tiles of TILE keys, loads each K/V
// tile into shared memory ONCE for all `rows` query rows (the GQA reuse of
// the TPU kernel: K/V bytes are read once per kv head, not once per q
// head), keeps a float32 online softmax (m, l, acc) per row and writes its
// unnormalised partial to scratch.  A second small kernel merges the splits
// in fixed split order; a split with no valid key (m = -1e30, l = 0,
// acc = 0) is an exact identity in the merge, with no exp of two sentinels
// left to make a NaN.  The ragged last tile is masked in-kernel (the TPU
// version pads), and a tile with no valid (query, key) pair is skipped
// before its K/V load.
//
// The arithmetic is the TPU kernel's: q cast to float32 and then scaled, K
// and V in float32, probabilities kept in float32 through P.V, output 0
// where no key is valid.  Simple first: scalar float32 FMAs from shared
// memory; wgmma, TMA and cp.async pipelining are later work.

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;  // keys per shared-memory tile: two per lane
static_assert(TILE == 64, "the softmax step gives each lane keys lane, lane+32");

__device__ __forceinline__ bool key_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const T* __restrict__ q,          // (B, Hkv, rows, Dk)
    const T* __restrict__ k,          // (B, C, Hkv, Dk)
    const T* __restrict__ v,          // (B, C, Hkv, Dv)
    const int* __restrict__ q_pos,    // (B, rows)
    const int* __restrict__ kv_pos,   // (B, C)
    float* __restrict__ part_ml,      // (B*Hkv, n_split, rows, 2)
    float* __restrict__ part_acc,     // (B*Hkv, n_split, rows, Dv)
    int C, int Hkv, int rows, int Dk, int Dv, int split_len, int window,
    float scale) {
  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int b = bh / Hkv, h = bh - b * Hkv;
  const int lane = tid & 31, warp = tid >> 5;
  const int ldk = Dk + 1;  // padded row: no bank conflicts on K reads
  extern __shared__ float smem[];
  float* qs = smem;                  // rows * Dk
  float* ks = qs + rows * Dk;        // TILE * ldk
  float* vs = ks + TILE * ldk;       // TILE * Dv
  float* sc = vs + TILE * Dv;        // rows * TILE: scores, then probabilities
  float* acc = sc + rows * TILE;     // rows * Dv
  float* m_s = acc + rows * Dv;      // rows
  float* l_s = m_s + rows;           // rows
  float* alpha_s = l_s + rows;       // rows
  int* kp_s = reinterpret_cast<int*>(alpha_s + rows);  // TILE
  int* qp_s = kp_s + TILE;                              // rows

  const T* qb = q + (size_t)bh * rows * Dk;
  for (int i = tid; i < rows * Dk; i += THREADS) qs[i] = to_f(qb[i]) * scale;
  for (int i = tid; i < rows * Dv; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < rows; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    qp_s[r] = q_pos[(size_t)b * rows + r];
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
    for (int i = tid; i < TILE * Dk; i += THREADS) {
      const int t = i / Dk, d = i - t * Dk;
      ks[t * ldk + d] = t < n ? to_f(k[((key0 + t) * Hkv + h) * Dk + d]) : 0.f;
    }
    for (int i = tid; i < TILE * Dv; i += THREADS) {
      const int t = i / Dv, d = i - t * Dv;
      vs[i] = t < n ? to_f(v[((key0 + t) * Hkv + h) * Dv + d]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < rows * TILE; i += THREADS) {
      const int r = i / TILE, t = i - r * TILE;
      float s = 0.f;
      for (int d = 0; d < Dk; ++d) s += qs[r * Dk + d] * ks[t * ldk + d];
      sc[i] = key_valid(kp_s[t], qp_s[r], window) ? s : NEG_INF;
    }
    __syncthreads();

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

    for (int i = tid; i < rows * Dv; i += THREADS) {
      const int r = i / Dv, d = i - r * Dv;
      const float* p = sc + r * TILE;
      float pv = 0.f;
      for (int t = 0; t < TILE; ++t) pv += p[t] * vs[t * Dv + d];
      acc[i] = acc[i] * alpha_s[r] + pv;
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

// Merge the splits of every (b, h) in split order: weights exp(m_s - M)
// against the largest split max M, then acc / l, 0 where no key was valid.
template <typename T>
__global__ void __launch_bounds__(THREADS) decode_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out,               // (B, Hkv, rows, Dv)
    int n_split, int rows, int Dv) {
  const size_t base = (size_t)blockIdx.x * n_split * rows;
  for (int i = threadIdx.x; i < rows * Dv; i += THREADS) {
    const int r = i / Dv, d = i - r * Dv;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, part_ml[(base + (size_t)s * rows + r) * 2]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t p = base + (size_t)s * rows + r;
      // a split with no valid key has m = -1e30, l = 0, acc = 0: its weight
      // is 0 once M is finite, 1 when every split is empty -- either way it
      // adds exact zeros
      const float w = expf(part_ml[p * 2] - M);
      l += w * part_ml[p * 2 + 1];
      a += w * part_acc[p * Dv + d];
    }
    out[(size_t)blockIdx.x * rows * Dv + i] =
        from_f<T>(l > 0.f ? a / fmaxf(l, 1e-30f) : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, void* part_ml,
                   void* part_acc, void* out, int B, int Hkv, int C, int rows,
                   int Dk, int Dv, int n_split, int split_len, int window,
                   float scale, cudaStream_t stream) {
  const size_t floats = (size_t)rows * Dk + (size_t)TILE * (Dk + 1) +
                        (size_t)TILE * Dv + (size_t)rows * TILE +
                        (size_t)rows * Dv + 3 * (size_t)rows;
  const size_t smem = floats * sizeof(float) + (size_t)(TILE + rows) * sizeof(int);
  cudaError_t err = repro::allow_smem(decode_split_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T><<<dim3(B * Hkv, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), C, Hkv, rows, Dk, Dv, split_len, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<B * Hkv, THREADS, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), n_split, rows, Dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention(
    int dtype, const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* part_ml, void* part_acc, void* out, int B,
    int Hkv, int C, int rows, int Dk, int Dv, int n_split, int split_len,
    int window, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, q_pos, kv_pos, part_ml, part_acc, out, B,
                         Hkv, C, rows, Dk, Dv, n_split, split_len, window,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, part_ml, part_acc,
                                 out, B, Hkv, C, rows, Dk, Dv, n_split,
                                 split_len, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
