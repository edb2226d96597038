// Fused unembedding + next-token entropy for Hopper (sm_90a): the EAT signal.
//
// Replaces the TPU kernel repro/kernels/entropy_probe/kernel.py
// (entropy_probe_pallas).  Computes H(softmax(h W)[:vocab]) per row without
// writing the (B, Vp) logits to device memory: per vocab tile the running
// statistics m = max logit, Z = sum exp(logit - m), T = sum exp(logit - m) *
// logit, merged across tiles by rescaling, and H = m + log Z - T / Z.
// Columns >= vocab (the padded vocabulary) are masked.
//
// On the TPU the vocab tiles ran in order on one core and carried (m, Z, T)
// in scratch.  Blocks on Hopper run in parallel, so this is two passes:
//   1. one block per (group of up to ROWS rows, vocab tile of TV columns)
//      computes (m, Z, T) of that tile for its rows from one read of its W
//      columns, and writes them to a (n_tiles, B, 3) float32 scratch.  The
//      row groups of one tile are adjacent in the grid (blockIdx.x), so
//      a batch larger than ROWS reads each W tile from device memory once
//      and from L2 for the other groups;
//   2. one block per row merges the tiles and writes H.
//
// What bounds it on the H100: bytes.  W is d x Vp (4096 x 152064 bf16 =
// 1.25 GB at eat-paper-8b) and is read exactly once per call, against
// 2 * B * d FLOPs per column -- B FLOPs per byte, far below the card's
// ~295.  h (B x d) is staged in shared memory in chunks and re-read from
// there; the scratch is 12 * B bytes per tile.  W may be any strided 2-D
// view (the transposed embedding table of a tied config is read in place,
// never copied), though only a column-contiguous W gives coalesced loads.

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::to_f;

constexpr int TV = 256;       // vocab columns per tile = threads per block
constexpr int DCH = 256;      // h columns staged in shared memory per step
constexpr int ROWS = 16;      // rows per block (one group of the batch)

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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
    const float t = block_reduce<false>(valid ? e * x : 0.f, red);
    if (tid == 0) {
      float* o = part + ((size_t)tile * B + b0 + b) * 3;
      o[0] = m;
      o[1] = z;
      o[2] = t;
    }
  }
}

__global__ void __launch_bounds__(TV) merge_kernel(
    const float* __restrict__ part, float* __restrict__ out, int B, int n_tiles) {
  __shared__ float red[TV / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  float m = NEG_INF;
  for (int t = tid; t < n_tiles; t += TV) m = fmaxf(m, part[((size_t)t * B + b) * 3]);
  m = block_reduce<true>(m, red);
  float z = 0.f, tt = 0.f;
  for (int t = tid; t < n_tiles; t += TV) {
    const float* p = part + ((size_t)t * B + b) * 3;
    const float s = expf(p[0] - m);
    z += p[1] * s;
    tt += p[2] * s;
  }
  z = block_reduce<false>(z, red);
  tt = block_reduce<false>(tt, red);
  if (tid == 0) out[b] = m + logf(z) - tt / z;
}

template <typename T>
cudaError_t launch(const void* h, const void* w, void* part, void* out, int B,
                   int d, int Vp, long long sd, long long sv, int vocab,
                   cudaStream_t stream) {
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

}  // namespace

extern "C" int entropy_tile_count(int Vp) { return (Vp + TV - 1) / TV; }

extern "C" int entropy_probe(int dtype, const void* h, const void* w,
                             void* part, void* out, int B, int d, int Vp,
                             long long sd, long long sv, int vocab,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(h, w, part, out, B, d, Vp, sd, sv, vocab, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, w, part, out, B, d, Vp, sd, sv, vocab, s);
  return (int)cudaErrorInvalidValue;
}
