// Shared pieces of the train-path kernels (spatial_block.cu and
// temporal_block.cu): dtype conversion, a register-tiled scalar product over
// shared-memory operands, and the deterministic second passes that sum the
// per-CTA partial gradients.
//
// Cross-CTA reductions.  The TPU kernels accumulate their weight gradients
// in VMEM across an in-order grid.  CTAs on a GPU run in no order, so each
// CTA of a backward kernel owns one slice of a float32 scratch tensor,
// `partial[cta][E]`, written on the CTA's first work item and added to on
// the later ones (every entry has one owning thread, so no atomics), and
// `reduce_partials` sums the slices in CTA order.  The result is the same
// on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace train {
namespace {  // each translation unit keeps its own copy

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// Round a float32 value to T and back.
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// out(b, r, c, sum_{j1 < J1, j2 < J2} a(b, r, j1, j2) * b(b, j1, j2, c))
// for b < NB, r < R, c < C, accumulated in float32 in (j1, j2) order.  The
// CTA's threads share the (b, row-tile, column-tile) tiles of TR x TC
// outputs; out-of-range rows and columns are clamped on load and skipped
// on store.  `out` is called once per output, by one thread.
template <int TR, int TC, typename FA, typename FB, typename FO>
__device__ __forceinline__ void tile_product(int NB, int R, int C, int J1,
                                             int J2, FA a, FB b, FO out) {
  const int nr = (R + TR - 1) / TR;
  const int nc = (C + TC - 1) / TC;
  const int tiles = NB * nr * nc;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int bi = tile / (nr * nc);
    const int rc = tile - bi * nr * nc;
    const int r0 = (rc / nc) * TR;
    const int c0 = (rc % nc) * TC;
    int rr[TR], cc[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) rr[i] = min(r0 + i, R - 1);
#pragma unroll
    for (int j = 0; j < TC; ++j) cc[j] = min(c0 + j, C - 1);
    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    for (int j1 = 0; j1 < J1; ++j1) {
      for (int j2 = 0; j2 < J2; ++j2) {
        float av[TR], bv[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) av[i] = a(bi, rr[i], j1, j2);
#pragma unroll
        for (int j = 0; j < TC; ++j) bv[j] = b(bi, j1, j2, cc[j]);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (r0 + i >= R) continue;
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (c0 + j < C) out(bi, r0 + i, c0 + j, acc[i][j]);
    }
  }
}

// Add v to a CTA-owned partial sum; the CTA's first work item writes it.
__device__ __forceinline__ void accumulate(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// out[e] = sum over ctas of partial[cta * E + e], in CTA order.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ partial, float* __restrict__ out,
                int ctas, long long E) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int c = 0; c < ctas; ++c) s += partial[(long long)c * E + e];
  out[e] = s;
}

inline cudaError_t launch_reduce(const float* partial, float* out, int ctas,
                                 long long E, cudaStream_t stream) {
  const long long blocks = (E + kThreads - 1) / kThreads;
  reduce_partials<<<(unsigned)blocks, kThreads, 0, stream>>>(partial, out,
                                                             ctas, E);
  return cudaGetLastError();
}

// out[e] = sum over slices of partial[slice * E + e] for the few columns
// and many slices of a row-tiled kernel's column sums (the bf16 dx kernels'
// affine gradients): one CTA a column, thread i summing slices i, i + 256,
// ... in order, then a fixed tree.
__global__ void __launch_bounds__(kThreads)
reduce_columns(const float* __restrict__ partial, float* __restrict__ out,
               int slices, int E) {
  __shared__ float part[kThreads];
  const int e = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < slices; i += blockDim.x)
    s += partial[(size_t)i * E + e];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[e] = part[0];
}

inline cudaError_t launch_reduce_columns(const float* partial, float* out,
                                         int slices, int E,
                                         cudaStream_t stream) {
  reduce_columns<<<E, kThreads, 0, stream>>>(partial, out, slices, E);
  return cudaGetLastError();
}

}  // namespace
}  // namespace train
