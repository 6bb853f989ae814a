// Per-channel batch moments of a channels-last activation, and their
// gradient: the BatchNorm statistics of the train step
// (stgcn_tpu_torch/kernels/bn_moments.py).
//
//   forward:  mean[c] = sum_r x[r, c] / n,  mean_sq[c] = sum_r x[r, c]^2 / n
//   backward: dx[r, c] = round_T(g_mean[c] / n + (g_sq[c] / n) * 2 x[r, c])
//
// over the n = rows of x viewed as (rows, C), accumulated in float32 for
// bf16 and float32 input and in float64 for float64.  It replaces no Pallas
// kernel: it stands for the reduction that XLA fuses out of the plain
// jnp.mean calls of _bn_affine_train (stgcn_tpu/models/fused.py).
//
// Bound.  Both passes are memory-bound: the forward reads x once (a KTH
// activation, 64 x 304 x 25 x 64 bf16, is 62 MB: 0.019 ms at 3.35 TB/s),
// the backward reads x and writes dx once (0.037 ms).  The design keeps to
// that traffic:
//
// * Each thread owns a fixed slice of channels, one vector unit of VEC
//   elements (16 bytes: 8 bf16, 4 float32, 2 float64; 1 element where C is
//   no multiple of VEC or x is not 16-byte aligned), so its sums never move
//   between threads; a CTA's threads cover up to kThreads units of a row
//   and kThreads / units rows a pass, channel chunks of more units go to
//   blockIdx.y.  The CTAs walk the rows with a grid stride, kUnroll rows in
//   flight a thread.
// * No float atomics: each CTA sums its threads' registers through shared
//   memory in a fixed order into its slice of partial[cta][2][C], and a
//   second small kernel sums the slices in CTA order and divides by n.  The
//   CTA count depends only on the shape and the card, so the statistics
//   are bitwise the same on every run and every replay of a CUDA graph.
// * The backward is one elementwise pass with the per-channel coefficients
//   in registers; x is read in its own dtype, so no float32 copy of the
//   activation is made or kept for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bn_moments {
namespace {

constexpr int kThreads = 256;   // threads of a CTA; units of a channel chunk
constexpr int kUnroll = 4;      // rows in flight a thread
constexpr int kFinalWarps = kThreads / 32;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T, typename A> __device__ __forceinline__ T from_acc(A v);
template <> __device__ __forceinline__ __nv_bfloat16
from_acc<__nv_bfloat16, float>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float from_acc<float, float>(float v) {
  return v;
}
template <> __device__ __forceinline__ double
from_acc<double, double>(double v) { return v; }

// VEC elements of T at p, converted to the accumulation type.
template <typename T, int VEC, typename A>
__device__ __forceinline__ void load_unit(const T* p, A (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_acc(p[0]);
  } else {
    static_assert(sizeof(T) * VEC == 16, "a vector unit is 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_acc(e[i]);
  }
}

template <typename T, int VEC, typename A>
__device__ __forceinline__ void store_unit(T* p, const A (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_acc<T, A>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_acc<T, A>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Where a thread works: its unit's first channel, and its row in a pass
// of `per_pass` rows (`active` false for the threads left over).
struct Slot {
  int channel;
  int row;
  int per_pass;
  int width;     // units of this CTA's chunk
  bool active;
};

template <int VEC>
__device__ __forceinline__ Slot slot_of(int c) {
  const int units = c / VEC;
  const int u0 = blockIdx.y * kThreads;
  Slot s;
  s.width = min(units - u0, kThreads);
  s.per_pass = kThreads / s.width;
  const int lane = threadIdx.x % s.width;
  s.row = threadIdx.x / s.width;
  s.channel = (u0 + lane) * VEC;
  s.active = s.row < s.per_pass;
  return s;
}

// Each CTA's sums of x and x^2 over its rows, for the channels of its
// chunk, into partial[blockIdx.x][0 | 1][C].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_moments_partial_kernel(const T* __restrict__ x,
                          typename AccOf<T>::type* __restrict__ partial,
                          int rows, int c) {
  using A = typename AccOf<T>::type;
  __shared__ A red[2][kThreads * VEC];
  const Slot s = slot_of<VEC>(c);
  A sum[VEC], sq[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sum[i] = sq[i] = A(0);
  if (s.active) {
    const long long stride = static_cast<long long>(gridDim.x) * s.per_pass;
    const T* base = x + s.channel;
    long long r = static_cast<long long>(blockIdx.x) * s.per_pass + s.row;
    for (; r + (kUnroll - 1) * stride < rows; r += kUnroll * stride) {
      A v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_unit<T, VEC>(base + (r + u * stride) * c, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sum[i] += v[u][i];
          sq[i] += v[u][i] * v[u][i];
        }
    }
    for (; r < rows; r += stride) {
      A v[VEC];
      load_unit<T, VEC>(base + r * c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sum[i] += v[i];
        sq[i] += v[i] * v[i];
      }
    }
  }
  // thread (row, lane) is threadIdx.x = row * width + lane
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[0][threadIdx.x * VEC + i] = sum[i];
    red[1][threadIdx.x * VEC + i] = sq[i];
  }
  __syncthreads();
  const int outs = s.width * VEC;       // channels of the chunk
  A* dst = partial + static_cast<long long>(blockIdx.x) * 2 * c
           + blockIdx.y * kThreads * VEC;
  for (int o = threadIdx.x; o < outs; o += kThreads) {
    A t0 = A(0), t1 = A(0);
    for (int g = 0; g < s.per_pass; ++g) {   // in row order
      t0 += red[0][g * outs + o];
      t1 += red[1][g * outs + o];
    }
    dst[o] = t0;
    dst[c + o] = t1;
  }
}

// mean and mean_sq from the CTAs' slices, viewed as (ctas, 2 C): each CTA
// takes 32 columns, each warp a fixed run of slices, then the warps' sums
// are added in warp order.
template <typename A>
__global__ void __launch_bounds__(kThreads)
bn_moments_final_kernel(const A* __restrict__ partial, A* __restrict__ mean,
                        A* __restrict__ mean_sq, int ctas, int rows, int c) {
  __shared__ A red[kFinalWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const int width = 2 * c;
  const int per_warp = (ctas + kFinalWarps - 1) / kFinalWarps;
  A t = A(0);
  if (col < width) {
    const int end = min(ctas, (warp + 1) * per_warp);
    for (int g = warp * per_warp; g < end; ++g)
      t += partial[static_cast<long long>(g) * width + col];
  }
  red[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && col < width) {
    A total = A(0);
#pragma unroll
    for (int w = 0; w < kFinalWarps; ++w) total += red[w][lane];
    total /= static_cast<A>(rows);
    if (col < c) mean[col] = total;
    else mean_sq[col - c] = total;
  }
}

// dx = round(g_mean / n + (g_sq / n) * 2 x), autograd's arithmetic for the
// plain version's mean and square().mean.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_moments_bwd_kernel(const T* __restrict__ x,
                      const typename AccOf<T>::type* __restrict__ g_mean,
                      const typename AccOf<T>::type* __restrict__ g_sq,
                      T* __restrict__ dx, int rows, int c) {
  using A = typename AccOf<T>::type;
  const Slot s = slot_of<VEC>(c);
  if (!s.active) return;
  const A n = static_cast<A>(rows);
  A a[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = g_mean[s.channel + i] / n;
    b[i] = g_sq[s.channel + i] / n;
  }
  const long long stride = static_cast<long long>(gridDim.x) * s.per_pass;
  long long r = static_cast<long long>(blockIdx.x) * s.per_pass + s.row;
  for (; r + (kUnroll - 1) * stride < rows; r += kUnroll * stride) {
    A v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_unit<T, VEC>(x + (r + u * stride) * c + s.channel, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[u][i] = a[i] + b[i] * (A(2) * v[u][i]);
      store_unit<T, VEC>(dx + (r + u * stride) * c + s.channel, v[u]);
    }
  }
  for (; r < rows; r += stride) {
    A v[VEC];
    load_unit<T, VEC>(x + r * c + s.channel, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = a[i] + b[i] * (A(2) * v[i]);
    store_unit<T, VEC>(dx + r * c + s.channel, v);
  }
}

template <typename T, int VEC>
int forward(const void* x, void* partial, void* mean, void* mean_sq,
            int rows, int c, int ctas, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  const int chunks = (c / VEC + kThreads - 1) / kThreads;
  bn_moments_partial_kernel<T, VEC><<<dim3(ctas, chunks), kThreads, 0,
                                      stream>>>(
      static_cast<const T*>(x), static_cast<A*>(partial), rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_moments_final_kernel<A><<<(2 * c + 31) / 32, kThreads, 0, stream>>>(
      static_cast<const A*>(partial), static_cast<A*>(mean),
      static_cast<A*>(mean_sq), ctas, rows, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int backward(const void* x, const void* g_mean, const void* g_sq, void* dx,
             int rows, int c, int ctas, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  const int chunks = (c / VEC + kThreads - 1) / kThreads;
  bn_moments_bwd_kernel<T, VEC><<<dim3(ctas, chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const A*>(g_mean),
      static_cast<const A*>(g_sq), static_cast<T*>(dx), rows, c);
  return static_cast<int>(cudaGetLastError());
}

// The vector width of T (16 bytes) or 1; any other width is refused.
template <typename T, typename F1, typename F16>
int by_width(int vec, F1 one, F16 wide) {
  if (vec == 1) return one();
  if (vec == static_cast<int>(16 / sizeof(T))) return wide();
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int rows, int c, int ctas) {
  return rows < 1 || c < 1 || ctas < 1 || ctas > 65535 * 32;
}

}  // namespace
}  // namespace bn_moments

// dtype: 0 float32, 1 bfloat16, 2 float64 (bn_moments.DTYPES); vec: 1 or
// 16 / sizeof(dtype), the elements of a thread's channel unit; ctas: the
// CTAs over the rows, and the slices of partial, (ctas, 2, c) in the
// accumulation type (float64 for float64 x, else float32), as are mean
// and mean_sq (c,).
extern "C" int bn_moments_fwd_launch(const void* x, void* partial,
                                     void* mean, void* mean_sq, int rows,
                                     int c, int dtype, int vec, int ctas,
                                     void* stream) {
  using namespace bn_moments;
  if (bad_shape(rows, c, ctas)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return by_width<float>(
          vec,
          [&] { return forward<float, 1>(x, partial, mean, mean_sq, rows, c,
                                         ctas, s); },
          [&] { return forward<float, 4>(x, partial, mean, mean_sq, rows, c,
                                         ctas, s); });
    case 1:
      return by_width<__nv_bfloat16>(
          vec,
          [&] { return forward<__nv_bfloat16, 1>(x, partial, mean, mean_sq,
                                                 rows, c, ctas, s); },
          [&] { return forward<__nv_bfloat16, 8>(x, partial, mean, mean_sq,
                                                 rows, c, ctas, s); });
    case 2:
      return by_width<double>(
          vec,
          [&] { return forward<double, 1>(x, partial, mean, mean_sq, rows, c,
                                          ctas, s); },
          [&] { return forward<double, 2>(x, partial, mean, mean_sq, rows, c,
                                          ctas, s); });
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g_mean, g_sq: (c,) in the accumulation type; dx like x.
extern "C" int bn_moments_bwd_launch(const void* x, const void* g_mean,
                                     const void* g_sq, void* dx, int rows,
                                     int c, int dtype, int vec, int ctas,
                                     void* stream) {
  using namespace bn_moments;
  if (bad_shape(rows, c, ctas)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return by_width<float>(
          vec,
          [&] { return backward<float, 1>(x, g_mean, g_sq, dx, rows, c, ctas,
                                          s); },
          [&] { return backward<float, 4>(x, g_mean, g_sq, dx, rows, c, ctas,
                                          s); });
    case 1:
      return by_width<__nv_bfloat16>(
          vec,
          [&] { return backward<__nv_bfloat16, 1>(x, g_mean, g_sq, dx, rows,
                                                  c, ctas, s); },
          [&] { return backward<__nv_bfloat16, 8>(x, g_mean, g_sq, dx, rows,
                                                  c, ctas, s); });
    case 2:
      return by_width<double>(
          vec,
          [&] { return backward<double, 1>(x, g_mean, g_sq, dx, rows, c, ctas,
                                           s); },
          [&] { return backward<double, 2>(x, g_mean, g_sq, dx, rows, c, ctas,
                                           s); });
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
