// The ST-GCN unit's tail as one pass each way: the shortcut add, the ReLU
// and inverted dropout after the temporal op of a fused train unit
// (stgcn_tpu_torch/kernels/unit_tail.py holds the plain version, which is
// PyTorch's chain that this replaces, and the autograd).  Per element, in
// float32, with T the activations' dtype (bf16 or float32):
//
//   v    = relu(u + short)                  (short may be absent)
//   keep = draw < keep_below                (true where there is no draw)
//   out  = keep ? round_T(round_T(v) * inv) : 0   (round_T(v) with no draw)
//   bit  = keep && !(v <= 0)
//   du   = bit ? round_T(dout * inv) : 0    (dout with no draw)
//
// inv = 1 / scale in float32, and du is the gradient of u and of short.
// That is bitwise the chain `torch.relu(u.to(f32) + short.to(f32)).to(T)`
// then `torch.where(draw < keep, out / scale, 0)` on CUDA, and its
// autograd: ATen's `div` by a host scalar multiplies by the float32
// reciprocal, `relu` is `clamp_min` (a NaN stays NaN), its backward passes
// the gradient where the result is not <= 0, and the casts are exact.  The
// draw is a float32 uniform (dropout "exact") or a byte ("bits8", kept
// below an integer threshold); it stays PyTorch's `torch.rand` /
// `torch.randint`, so the generator's stream is unchanged.  It replaces no
// Pallas kernel: it stands for XLA's fusion of the same elementwise tail
// in stgcn_tpu/models/fused.py block_forward_fused_train.
//
// Bound.  Both passes are memory-bound.  The forward reads u and short (2
// bytes an element each in bf16) and the draw (4, or 1 for bits8) and
// writes out (2) and one bit: a KTH unit of 64 x 304 x 25 x 64 elements
// moves 315 MB, 0.094 ms at 3.35 TB/s.  The backward reads dout and the
// bit and writes du: 132 MB, 0.039 ms.  Only the bit lives from the
// forward to the backward (3.9 MB a unit, against the chain's float32 ReLU
// result and bool mask, 155 MB).
//
// Design.  A thread takes 8 consecutive elements of the flat index a step
// of a grid-stride loop: one mask byte, 16-byte loads of u, short and out
// (two for float32), two of the float32 draw (one 8-byte load of a byte
// draw).  Neighbouring threads take neighbouring units, so every access of
// a warp is one coalesced run.  Where a pointer is not aligned for those
// loads, the scalar instantiation loads element by element; the last unit
// of an element count that is no multiple of 8 takes the scalar loads in
// either, and its missing bits stay 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace unit_tail {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kUnit = 8;        // elements a thread a step: one mask byte

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// kUnit elements at p as float32: 16-byte loads (one 8-byte load for a
// byte type) where VEC and the unit is whole, else m scalar loads
template <typename T, bool VEC>
__device__ __forceinline__ void load_unit(const T* __restrict__ p, int m,
                                          float (&v)[kUnit]) {
  if (VEC && m == kUnit) {
    if constexpr (sizeof(T) == 1) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kUnit; ++j) v[j] = to_f32(e[j]);
    } else {
      constexpr int per = 16 / sizeof(T);
#pragma unroll
      for (int k = 0; k < kUnit / per; ++k) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + k);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < per; ++j) v[k * per + j] = to_f32(e[j]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kUnit; ++j) v[j] = j < m ? to_f32(p[j]) : 0.f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_unit(T* __restrict__ p, int m,
                                           const T (&v)[kUnit]) {
  if (VEC && m == kUnit) {
    constexpr int per = 16 / sizeof(T);
#pragma unroll
    for (int k = 0; k < kUnit / per; ++k) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < per; ++j) e[j] = v[k * per + j];
      reinterpret_cast<uint4*>(p)[k] = raw;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kUnit; ++j)
      if (j < m) p[j] = v[j];
  }
}

// T: the activations' type; D: the draw's (float or uint8_t; ignored where
// draw is null); VEC: the 16-byte loads
template <typename T, typename D, bool VEC>
__global__ void __launch_bounds__(kThreads)
unit_tail_fwd_kernel(const T* __restrict__ u, const T* __restrict__ shortcut,
                     const D* __restrict__ draw, T* __restrict__ out,
                     uint8_t* __restrict__ mask, int64_t n, float keep_below,
                     float inv) {
  const int64_t units = (n + kUnit - 1) / kUnit;
  for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < units;
       b += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = b * kUnit;
    const int m = (int)min((int64_t)kUnit, n - i);
    float vu[kUnit], vs[kUnit], vd[kUnit];
    load_unit<T, VEC>(u + i, m, vu);
    if (shortcut != nullptr) load_unit<T, VEC>(shortcut + i, m, vs);
    if (draw != nullptr) load_unit<D, VEC>(draw + i, m, vd);
    T o[kUnit];
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kUnit; ++j) {
      float x = vu[j];
      if (shortcut != nullptr) x = __fadd_rn(x, vs[j]);
      const float v = isnan(x) ? x : fmaxf(x, 0.f);      // clamp_min(x, 0)
      const T r = from_f32<T>(v);
      bool keep = true;
      o[j] = r;
      if (draw != nullptr) {
        keep = vd[j] < keep_below;
        o[j] = keep ? from_f32<T>(__fmul_rn(to_f32(r), inv)) : from_f32<T>(0.f);
      }
      if (keep && !(v <= 0.f) && j < m) bits |= 1u << j;
    }
    store_unit<T, VEC>(out + i, m, o);
    mask[b] = static_cast<uint8_t>(bits);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
unit_tail_bwd_kernel(const uint8_t* __restrict__ mask,
                     const T* __restrict__ dout, T* __restrict__ du,
                     int64_t n, int scaled, float inv) {
  const int64_t units = (n + kUnit - 1) / kUnit;
  for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < units;
       b += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = b * kUnit;
    const int m = (int)min((int64_t)kUnit, n - i);
    const unsigned bits = mask[b];
    float vd[kUnit];
    load_unit<T, VEC>(dout + i, m, vd);
    T g[kUnit];
#pragma unroll
    for (int j = 0; j < kUnit; ++j) {
      const float d = scaled ? __fmul_rn(vd[j], inv) : vd[j];
      g[j] = (bits >> j) & 1u ? from_f32<T>(d) : from_f32<T>(0.f);
    }
    store_unit<T, VEC>(du + i, m, g);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename D>
int forward(const void* u, const void* shortcut, const void* draw, void* out,
            void* mask, int64_t n, float keep_below, float scale, int ctas,
            cudaStream_t s) {
  // ATen's div by a host scalar: the float32 reciprocal of the float32
  // scalar, taken on the host
  const float inv = 1.0f / scale;
  const bool vec = aligned(u, 16) && aligned(shortcut, 16) &&
                   aligned(out, 16) && aligned(draw, sizeof(D) == 1 ? 8 : 16);
  const T* pu = static_cast<const T*>(u);
  const T* ps = static_cast<const T*>(shortcut);
  const D* pd = static_cast<const D*>(draw);
  T* po = static_cast<T*>(out);
  uint8_t* pm = static_cast<uint8_t*>(mask);
  if (vec)
    unit_tail_fwd_kernel<T, D, true><<<ctas, kThreads, 0, s>>>(
        pu, ps, pd, po, pm, n, keep_below, inv);
  else
    unit_tail_fwd_kernel<T, D, false><<<ctas, kThreads, 0, s>>>(
        pu, ps, pd, po, pm, n, keep_below, inv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward_draw(const void* u, const void* shortcut, const void* draw,
                 void* out, void* mask, int64_t n, int draw_kind,
                 float keep_below, float scale, int ctas, cudaStream_t s) {
  switch (draw_kind) {
    case 0:   // no draw: the float instantiation with a null draw
      return forward<T, float>(u, shortcut, nullptr, out, mask, n, keep_below,
                               1.0f, ctas, s);
    case 1:
      return forward<T, float>(u, shortcut, draw, out, mask, n, keep_below,
                               scale, ctas, s);
    case 2:
      return forward<T, uint8_t>(u, shortcut, draw, out, mask, n, keep_below,
                                 scale, ctas, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int backward(const void* mask, const void* dout, void* du, int64_t n,
             int scaled, float scale, int ctas, cudaStream_t s) {
  const float inv = scaled ? 1.0f / scale : 1.0f;
  if (aligned(dout, 16) && aligned(du, 16))
    unit_tail_bwd_kernel<T, true><<<ctas, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(mask), static_cast<const T*>(dout),
        static_cast<T*>(du), n, scaled, inv);
  else
    unit_tail_bwd_kernel<T, false><<<ctas, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(mask), static_cast<const T*>(dout),
        static_cast<T*>(du), n, scaled, inv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace unit_tail

// dtype: 0 float32, 1 bfloat16; draw_kind: 0 none (draw null), 1 float32
// uniforms, 2 bytes; shortcut may be null.  mask: ceil(n / 8) bytes, bit j
// of byte b for element 8b + j.
extern "C" int unit_tail_fwd_launch(const void* u, const void* shortcut,
                                    const void* draw, void* out, void* mask,
                                    long long n, int dtype, int draw_kind,
                                    float keep_below, float scale, int ctas,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return unit_tail::forward_draw<float>(u, shortcut, draw, out, mask, n, draw_kind, keep_below, scale, ctas, s);
    case 1: return unit_tail::forward_draw<__nv_bfloat16>(u, shortcut, draw, out, mask, n, draw_kind, keep_below, scale, ctas, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// scaled: 0 where the forward had no draw (du = bit ? dout : 0).
extern "C" int unit_tail_bwd_launch(const void* mask, const void* dout,
                                    void* du, long long n, int dtype,
                                    int scaled, float scale, int ctas,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return unit_tail::backward<float>(mask, dout, du, n, scaled, scale, ctas, s);
    case 1: return unit_tail::backward<__nv_bfloat16>(mask, dout, du, n, scaled, scale, ctas, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
