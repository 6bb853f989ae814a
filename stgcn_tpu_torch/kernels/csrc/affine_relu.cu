// A post-activation unit's tail as one pass each way: two per-channel
// affines, their sum and the ReLU (stgcn_tpu_torch/kernels/affine_relu.py
// holds the plain versions, same rounding points).
//
//   out[r, c] = round(relu(a[r, c] sa[c] + b[r, c] sb[c] + t[c]))
//
// with `b` absent (no shortcut) or `sb` absent (an identity shortcut, sb =
// 1); a, b and out in the activations' dtype (bf16, float32 or float64),
// the affines and every sum in at least float32.  The backward, with
// m = dout [out > 0]:
//
//   da = round(m sa), db = round(m sb), dsa = sum_r m a, dsb = sum_r m b,
//   dt = sum_r m
//
// The forward is elementwise, a thread 16 bytes of a row (8 bf16) where
// the channels and the pointers allow it, else an element, a grid-stride
// loop.  The backward writes da and db in the same pass that sums the three
// channel vectors: a CTA a chunk of rows, its threads spread over the
// channels 16 bytes at a time (consecutive threads consecutive channels, so
// each row's read is one coalesced run) and, where the channels are fewer
// than the threads, over groups of rows; each CTA's sums go to a partial slice (ctas, 3, C) that
// a second kernel adds in a fixed order, so the gradients are the same on
// every replay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace affine_relu {

using bf16 = __nv_bfloat16;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T, typename A> __device__ __forceinline__ T from_acc(A v) {
  return static_cast<T>(v);
}
template <> __device__ __forceinline__ bf16 from_acc<bf16, float>(float v) {
  return __float2bfloat16(v);
}

constexpr int THREADS = 256;

// VEC elements of a row from one 16-byte load (VEC = 16 / sizeof(T)), or
// one element (VEC = 1)
template <typename T, int VEC, typename A>
__device__ __forceinline__ void load_vec(const T* p, A (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_acc(*p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_acc(e[j]);
  }
}

template <typename T, int VEC, typename A>
__device__ __forceinline__ void store_vec(T* p, const A (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_acc<T, A>(v[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_acc<T, A>(v[j]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ a, const typename Acc<T>::type* __restrict__ sa,
           const T* __restrict__ b, const typename Acc<T>::type* __restrict__ sb,
           const typename Acc<T>::type* __restrict__ t, T* __restrict__ out,
           int64_t n, int c) {
  using A = typename Acc<T>::type;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       u < n / VEC; u += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = u * VEC;
    const int ch = (int)(i % c);
    A va[VEC], vb[VEC], v[VEC];
    load_vec<T, VEC>(a + i, va);
    if (b != nullptr) load_vec<T, VEC>(b + i, vb);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      A x = va[j] * sa[ch + j] + t[ch + j];
      if (b != nullptr) x += sb != nullptr ? vb[j] * sb[ch + j] : vb[j];
      v[j] = x < A(0) ? A(0) : x;                 // NaN stays NaN
    }
    store_vec<T, VEC>(out + i, v);
  }
}

// partial[cta][0..2][c]: sum of m a, m b, m over the CTA's rows; a thread
// VEC consecutive channels of every groups-th row of the CTA's chunk
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const T* __restrict__ a, const typename Acc<T>::type* __restrict__ sa,
           const T* __restrict__ b, const typename Acc<T>::type* __restrict__ sb,
           const T* __restrict__ out, const T* __restrict__ dout,
           T* __restrict__ da, T* __restrict__ db,
           typename Acc<T>::type* __restrict__ partial, int64_t rows, int c,
           int64_t rows_per_cta) {
  using A = typename Acc<T>::type;
  extern __shared__ unsigned char smem_raw[];
  A* red = reinterpret_cast<A*>(smem_raw);         // (groups, 3, c)
  const int cv = c / VEC;
  const int groups = cv >= THREADS ? 1 : THREADS / cv;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t r1 = min(rows, r0 + rows_per_cta);
  for (int p = threadIdx.x; p < groups * cv; p += blockDim.x) {
    const int ch = (p % cv) * VEC, g = p / cv;
    A s_a[VEC] = {}, s_b[VEC] = {}, s_m[VEC] = {};
    for (int64_t r = r0 + g; r < r1; r += groups) {
      const int64_t i = r * c + ch;
      A vo[VEC], vd[VEC], va[VEC], vb[VEC], m[VEC], w[VEC];
      load_vec<T, VEC>(out + i, vo);
      load_vec<T, VEC>(dout + i, vd);
      load_vec<T, VEC>(a + i, va);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        m[j] = vo[j] <= A(0) ? A(0) : vd[j];
        s_a[j] += m[j] * va[j];
        s_m[j] += m[j];
        w[j] = m[j] * sa[ch + j];
      }
      store_vec<T, VEC>(da + i, w);
      if (b != nullptr) {
        load_vec<T, VEC>(b + i, vb);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s_b[j] += m[j] * vb[j];
          w[j] = sb != nullptr ? m[j] * sb[ch + j] : m[j];
        }
        store_vec<T, VEC>(db + i, w);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[(g * 3 + 0) * c + ch + j] = s_a[j];
      red[(g * 3 + 1) * c + ch + j] = s_b[j];
      red[(g * 3 + 2) * c + ch + j] = s_m[j];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < 3 * c; p += blockDim.x) {
    A s = 0;
    for (int g = 0; g < groups; ++g) s += red[g * 3 * c + p];
    partial[(int64_t)blockIdx.x * 3 * c + p] = s;
  }
}

template <typename A>
__global__ void sum_partials(const A* __restrict__ partial, A* __restrict__ sums,
                             int ctas, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  A s = 0;
  for (int i = 0; i < ctas; ++i) s += partial[(int64_t)i * n + p];
  sums[p] = s;
}

// the vector width every pointer and the channel count allow
template <typename T>
static bool vectors(int c, std::initializer_list<const void*> ptrs) {
  if (c % (16 / sizeof(T)) != 0) return false;
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename T, int VEC>
static void forward_vec(const void* a, const void* sa, const void* b,
                        const void* sb, const void* t, void* out, int64_t n,
                        int c, int ctas, cudaStream_t s) {
  using A = typename Acc<T>::type;
  fwd_kernel<T, VEC><<<ctas, THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<const A*>(sa),
      static_cast<const T*>(b), static_cast<const A*>(sb),
      static_cast<const A*>(t), static_cast<T*>(out), n, c);
}

template <typename T>
static int forward(const void* a, const void* sa, const void* b, const void* sb,
                   const void* t, void* out, int64_t n, int c, int ctas,
                   cudaStream_t s) {
  if (vectors<T>(c, {a, b, out}))
    forward_vec<T, 16 / sizeof(T)>(a, sa, b, sb, t, out, n, c, ctas, s);
  else
    forward_vec<T, 1>(a, sa, b, sb, t, out, n, c, ctas, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int backward_vec(const void* a, const void* sa, const void* b,
                        const void* sb, const void* out, const void* dout,
                        void* da, void* db, void* partial, int64_t rows, int c,
                        int ctas, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const int cv = c / VEC;
  const int groups = cv >= THREADS ? 1 : THREADS / cv;
  const size_t smem = (size_t)groups * 3 * c * sizeof(A);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per = (rows + ctas - 1) / ctas;
  bwd_kernel<T, VEC><<<ctas, THREADS, smem, s>>>(
      static_cast<const T*>(a), static_cast<const A*>(sa),
      static_cast<const T*>(b), static_cast<const A*>(sb),
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<T*>(da), static_cast<T*>(db), static_cast<A*>(partial),
      rows, c, per);
  return 0;
}

template <typename T>
static int backward(const void* a, const void* sa, const void* b,
                    const void* sb, const void* out, const void* dout, void* da,
                    void* db, void* partial, void* sums, int64_t rows, int c,
                    int ctas, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const int err =
      vectors<T>(c, {a, b, out, dout, da, db})
          ? backward_vec<T, 16 / sizeof(T)>(a, sa, b, sb, out, dout, da, db,
                                            partial, rows, c, ctas, s)
          : backward_vec<T, 1>(a, sa, b, sb, out, dout, da, db, partial, rows,
                               c, ctas, s);
  if (err != 0) return err;
  const int n = 3 * c;
  sum_partials<A><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const A*>(partial), static_cast<A*>(sums), ctas, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace affine_relu

// dtype: 0 float32, 1 bfloat16, 2 float64; b and sb may be null.
extern "C" int affine_relu_fwd_launch(const void* a, const void* sa,
                                      const void* b, const void* sb,
                                      const void* t, void* out, long long n,
                                      int c, int dtype, int ctas,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return affine_relu::forward<float>(a, sa, b, sb, t, out, n, c, ctas, s);
    case 1: return affine_relu::forward<__nv_bfloat16>(a, sa, b, sb, t, out, n, c, ctas, s);
    case 2: return affine_relu::forward<double>(a, sa, b, sb, t, out, n, c, ctas, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// sums: (3, C) of sum m a, sum m b, sum m; partial: (ctas, 3, C).
extern "C" int affine_relu_bwd_launch(const void* a, const void* sa,
                                      const void* b, const void* sb,
                                      const void* out, const void* dout,
                                      void* da, void* db, void* partial,
                                      void* sums, long long rows, int c,
                                      int dtype, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return affine_relu::backward<float>(a, sa, b, sb, out, dout, da, db, partial, sums, rows, c, ctas, s);
    case 1: return affine_relu::backward<__nv_bfloat16>(a, sa, b, sb, out, dout, da, db, partial, sums, rows, c, ctas, s);
    case 2: return affine_relu::backward<double>(a, sa, b, sb, out, dout, da, db, partial, sums, rows, c, ctas, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
