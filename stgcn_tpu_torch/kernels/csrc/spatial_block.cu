// spatial_block and spatial_conv: the K-partition graph convolution,
// forward and backward, for Hopper.  spatial_block is the train path's
// spatial op (an affine and ReLU first); spatial_conv is the plain graph
// convolution of the standalone-conv routes.
//
// Replaces five Pallas TPU kernels of the JAX package:
//   * stgcn_tpu/kernels/block_fused.py  spatial_block_vm
//       (_spatial_fwd_kernel, _spatial_bwd_kernel)
//   * stgcn_tpu/kernels/block_fused.py  spatial_block_vm_save
//       (_spatial_fwd_kernel_save, _spatial_bwd_kernel_saved)
//   * stgcn_tpu/kernels/block_packed.py spatial_block_packed
//       (_sp_fwd_kernel, _sp_bwd_kernel)
//   * stgcn_tpu/kernels/spatial_conv.py spatial_conv_fused
//       (_fwd_kernel, _bwd_kernel), on (N, T, V, C)
//   * stgcn_tpu/kernels/spatial_conv.py spatial_conv_fused_vm
//       (_fwd_kernel_vm, _bwd_kernel_vm), on V-major (V, M, C)
// The first three compute spatial_block's function, the last two
// spatial_conv's, which is spatial_block's with the affine and ReLU taken
// out.  The template flag AFF keeps or drops the affine, the ReLU, the ds1
// and dt1 sums and their scratch, and the multiply of dx by s1.  The flag
// SAVE (with AFF; spatial_block_save) makes the forward also write every
// rounded expansion y_k to a saved tensor, and the backward read y_k from
// it for dA where it would otherwise recompute it.  The saved tensor is
// (K, V, M, C_out) in T: partition k's y_k has z's own layout, so the
// backward reads each (frame, joint) row of it as it reads g.  The
// packed variant's two frames per 128-lane row and the 128-lane channel
// padding were TPU layout workarounds; these kernels take the logical
// layouts and any channel count (C_in = 2 for the first block).  Dims.vmajor
// picks the layout in place: V-major (V, M, C), M = N*T frames, where a
// joint is M*C elements apart and a frame C; or frame-major (M, V, C), that
// is (N, T, V, C), where a joint is C apart and a frame V*C.
//
// Function, for frame m, joint v, output channel o ("round" = to the
// activation dtype T; sums in float32; AFF only in brackets):
//   h     = round([relu?](x [* s1 + t1]))           (h = x without AFF)
//   y_k   = round(h . W_k + b_k)
//   z     = sum_k A_k . y_k                        -> round
// Backward, given g = dL/dz (rounding points of _spatial_bwd_kernel and of
// spatial_conv.py _bwd_kernel):
//   t_k   = round(A_k^T . g)
//   dh    = sum_k t_k . W_k^T
//   dpre  = dh [* [pre > 0]] (relu1 only),  dx = round(dpre [* s1])
//   dW_k  = h^T . t_k,  db_k = sum t_k
//   dA_k  = g . round(h . W_k + b_k)^T            (need_da only; with SAVE
//                                                  the saved y_k)
//   [ds1  = sum dpre * x,  dt1 = sum dpre]
// dW, db, dA, ds1 and dt1 sum over all M*V rows: each CTA of the backward
// keeps float32 partial sums in its slice of a scratch tensor and a second
// pass adds the slices in a fixed order (train_common.cuh).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s).  The forward
// needs 2*M*V*C_in*K*C_out + 2*M*K*V*V*C_out operations and moves
// M*V*(C_in + C_out)*sizeof(T) bytes: at the main path's shapes (M = 19,456
// to 4,864 frames, C <= 256) about 1 to 60 GFLOP against 5 to 125 MB, so
// up to 0.06 ms of tensor-core time against up to 0.04 ms of memory time:
// the bound is set by bytes for C_in = 2 and 64 and by operations above.
// The backward does two to three times the operations (the y_k recompute
// for dA, the t_k and dh products) and moves x, g and dx.  SAVE trades the
// recompute's 2*M*V*C_in*K*C_out operations for K*M*V*C_out*sizeof(T)
// bytes written by the forward and read by the backward: 125 MB a block
// at blocks 8-9 (M = 4,864, C_in = C_out = 256, K = 2, bf16), 32 GFLOP.
//
// Design.  This first version is scalar FMA on the CUDA cores, far from that
// bound on purpose: the simple kernel that is right.  A CTA of 256 threads
// takes F whole frames (all V joints, since the aggregation mixes joints),
// keeps h, y_k, g, t_k and the z-sums of those frames in shared memory as
// float32, and runs each product as register tiles of 4x4 outputs
// (tile_product).  The forward launches one CTA per F frames.  The backward
// runs a fixed number of CTAs that each loop over F-frame chunks, so the
// weight-gradient partials stay small (one slice per CTA).  F is the
// largest of 8, 4, 2, 1 whose buffers fit in 227 KB (spatial_block.py
// plan_frames; one frame at C_in = C_out = 256).  Tensor-core tiles are
// later work.
//
// Launch contract (checked by the Python wrappers): x, g, w, b, a, y in T;
// s1, t1 float32 (AFF only); w is (K, C_in, C_out) and wT (K, C_out, C_in);
// the dynamic shared memory is 4*F*V*(C_in + 2*C_out) bytes for the forward
// and 4*F*V*(2*C_in + 3*C_out) for the backward.  Each launcher returns
// cudaGetLastError() after its launches.

#include "train_common.cuh"

namespace {

using train::accumulate;
using train::from_f;
using train::kThreads;
using train::rnd;
using train::tile_product;
using train::to_f;

struct Dims {
  int V, M, C_in, C_out, K, frames, relu1, vmajor;
};

// Offset of (joint v, frame m, channel 0) in a tensor of C channels.
__device__ __forceinline__ size_t row_at(const Dims& d, int v, int m, int C) {
  return d.vmajor ? ((size_t)v * d.M + m) * C : ((size_t)m * d.V + v) * C;
}

// h of one element: x [through the affine and ReLU], rounded to T.
template <typename T, bool AFF>
__device__ __forceinline__ float spatial_in(float xv, const float* s1,
                                            const float* t1, int i,
                                            const Dims& d) {
  if constexpr (AFF) {
    float h = __fadd_rn(__fmul_rn(xv, s1[i]), t1[i]);  // no FMA: as torch
    if (d.relu1) h = fmaxf(h, 0.f);
    return rnd<T>(h);
  } else {
    return xv;
  }
}

// With SAVE, y_k is also written to ysave (K, V, M, C_out).
template <typename T, bool AFF, bool SAVE>
__global__ void __launch_bounds__(kThreads)
spatial_fwd_kernel(const T* __restrict__ x, const float* __restrict__ s1,
                   const float* __restrict__ t1, const T* __restrict__ w,
                   const T* __restrict__ b, const T* __restrict__ a,
                   T* __restrict__ out, T* __restrict__ ysave, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int V = d.V, C_in = d.C_in, C_out = d.C_out;
  const int m0 = blockIdx.x * d.frames;
  const int fc = min(d.frames, d.M - m0);
  const int R = fc * V;
  float* hs = smem;                            // [R][C_in]  h
  float* ys = hs + d.frames * V * C_in;        // [R][C_out] y_k
  float* zs = ys + d.frames * V * C_out;       // [R][C_out] sum over k

  for (int e = threadIdx.x; e < R * C_in; e += blockDim.x) {
    const int r = e / C_in, i = e - r * C_in;
    const int f = r / V, v = r - f * V;
    const float xv = to_f(x[row_at(d, v, m0 + f, C_in) + i]);
    hs[e] = spatial_in<T, AFF>(xv, s1, t1, i, d);
  }
  __syncthreads();

  for (int k = 0; k < d.K; ++k) {
    const T* wk = w + (size_t)k * C_in * C_out;
    const T* bk = b + (size_t)k * C_out;
    const T* ak = a + (size_t)k * V * V;
    T* yk = SAVE ? ysave + (size_t)k * V * d.M * C_out : nullptr;
    tile_product<4, 4>(
        1, R, C_out, 1, C_in,
        [&](int, int r, int, int i) { return hs[r * C_in + i]; },
        [&](int, int, int i, int o) { return to_f(wk[i * C_out + o]); },
        [&](int, int r, int o, float acc) {
          const float y = rnd<T>(acc + to_f(bk[o]));
          ys[r * C_out + o] = y;
          if constexpr (SAVE) {
            const int f = r / V, v = r - f * V;
            yk[row_at(d, v, m0 + f, C_out) + o] = from_f<T>(y);
          }
        });
    __syncthreads();
    const bool last = k == d.K - 1;
    tile_product<4, 4>(
        fc, V, C_out, 1, V,
        [&](int, int v, int, int wj) { return to_f(ak[v * V + wj]); },
        [&](int f, int, int wj, int o) { return ys[(f * V + wj) * C_out + o]; },
        [&](int f, int v, int o, float acc) {
          const int idx = (f * V + v) * C_out + o;
          const float z = k == 0 ? acc : zs[idx] + acc;
          if (last)
            out[row_at(d, v, m0 + f, C_out) + o] = from_f<T>(z);
          else
            zs[idx] = z;
        });
    __syncthreads();
  }
}

// Partial-sum slice of one CTA: dW [K][C_in][C_out], db [K][C_out],
// dA [K][V][V], and with AFF ds1 [C_in], dt1 [C_in].  With SAVE, dA reads
// y_k from ysaved (K, V, M, C_out) and b is not read.
template <typename T, bool AFF, bool SAVE>
__global__ void __launch_bounds__(kThreads)
spatial_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ s1, const float* __restrict__ t1,
                   const T* __restrict__ w, const T* __restrict__ wT,
                   const T* __restrict__ b, const T* __restrict__ a,
                   const T* __restrict__ ysaved, T* __restrict__ dx,
                   float* __restrict__ partial, long long E, int need_da,
                   Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int V = d.V, C_in = d.C_in, C_out = d.C_out, K = d.K;
  const int cap = d.frames * V;
  float* hs = smem;                  // [R][C_in]  h, then dpre * x
  float* dhs = hs + cap * C_in;      // [R][C_in]  dh, then dpre
  float* gs = dhs + cap * C_in;      // [R][C_out] g
  float* ts = gs + cap * C_out;      // [R][C_out] t_k
  float* zs = ts + cap * C_out;      // [R][C_out] y_k (recomputed or saved)
  float* p_dw = partial + (size_t)blockIdx.x * E;
  float* p_db = p_dw + (size_t)K * C_in * C_out;
  float* p_da = p_db + (size_t)K * C_out;
  float* p_ds1 = p_da + (size_t)K * V * V;
  float* p_dt1 = p_ds1 + C_in;
  const int chunks = (d.M + d.frames - 1) / d.frames;

  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const bool first = chunk == (int)blockIdx.x;
    const int m0 = chunk * d.frames;
    const int fc = min(d.frames, d.M - m0);
    const int R = fc * V;
    for (int e = threadIdx.x; e < R * C_in; e += blockDim.x) {
      const int r = e / C_in, i = e - r * C_in;
      const int f = r / V, v = r - f * V;
      const float xv = to_f(x[row_at(d, v, m0 + f, C_in) + i]);
      hs[e] = spatial_in<T, AFF>(xv, s1, t1, i, d);
      dhs[e] = 0.f;
    }
    for (int e = threadIdx.x; e < R * C_out; e += blockDim.x) {
      const int r = e / C_out, o = e - r * C_out;
      const int f = r / V, v = r - f * V;
      gs[e] = to_f(g[row_at(d, v, m0 + f, C_out) + o]);
    }
    __syncthreads();

    for (int k = 0; k < K; ++k) {
      const T* wk = w + (size_t)k * C_in * C_out;
      const T* wTk = wT + (size_t)k * C_out * C_in;
      const T* ak = a + (size_t)k * V * V;
      // t_k = round(A_k^T . g), per frame
      tile_product<4, 4>(
          fc, V, C_out, 1, V,
          [&](int, int wj, int, int v) { return to_f(ak[v * V + wj]); },
          [&](int f, int, int v, int o) { return gs[(f * V + v) * C_out + o]; },
          [&](int f, int wj, int o, float acc) {
            ts[(f * V + wj) * C_out + o] = rnd<T>(acc);
          });
      if constexpr (SAVE) {  // y_k as the forward saved it
        const T* yk = ysaved + (size_t)k * V * d.M * C_out;
        for (int e = threadIdx.x; e < R * C_out; e += blockDim.x) {
          const int r = e / C_out, o = e - r * C_out;
          const int f = r / V, v = r - f * V;
          zs[e] = to_f(yk[row_at(d, v, m0 + f, C_out) + o]);
        }
      } else if (need_da) {  // y_k = round(h . W_k + b_k)
        const T* bk = b + (size_t)k * C_out;
        tile_product<4, 4>(
            1, R, C_out, 1, C_in,
            [&](int, int r, int, int i) { return hs[r * C_in + i]; },
            [&](int, int, int i, int o) { return to_f(wk[i * C_out + o]); },
            [&](int, int r, int o, float acc) {
              zs[r * C_out + o] = rnd<T>(acc + to_f(bk[o]));
            });
      }
      __syncthreads();
      // dW_k += h^T . t_k
      tile_product<4, 4>(
          1, C_in, C_out, 1, R,
          [&](int, int i, int, int r) { return hs[r * C_in + i]; },
          [&](int, int, int r, int o) { return ts[r * C_out + o]; },
          [&](int, int i, int o, float acc) {
            accumulate(&p_dw[((size_t)k * C_in + i) * C_out + o], acc, first);
          });
      // dh += t_k . W_k^T
      tile_product<4, 4>(
          1, R, C_in, 1, C_out,
          [&](int, int r, int, int o) { return ts[r * C_out + o]; },
          [&](int, int, int o, int i) { return to_f(wTk[o * C_in + i]); },
          [&](int, int r, int i, float acc) { dhs[r * C_in + i] += acc; });
      // db_k += sum of t_k
      for (int o = threadIdx.x; o < C_out; o += blockDim.x) {
        float s = 0.f;
        for (int r = 0; r < R; ++r) s += ts[r * C_out + o];
        accumulate(&p_db[k * C_out + o], s, first);
      }
      // dA_k += g . y_k^T, summed over the chunk's frames and channels
      if (need_da) {
        tile_product<4, 4>(
            1, V, V, fc, C_out,
            [&](int, int v, int f, int o) { return gs[(f * V + v) * C_out + o]; },
            [&](int, int f, int o, int wj) { return zs[(f * V + wj) * C_out + o]; },
            [&](int, int v, int wj, float acc) {
              accumulate(&p_da[((size_t)k * V + v) * V + wj], acc, first);
            });
      } else if (first) {
        for (int e = threadIdx.x; e < V * V; e += blockDim.x)
          p_da[(size_t)k * V * V + e] = 0.f;
      }
      __syncthreads();
    }

    // dpre = dh [through the ReLU], dx = round(dpre [* s1]); with AFF keep
    // dpre and dpre * x for the affine's gradients
    for (int e = threadIdx.x; e < R * C_in; e += blockDim.x) {
      const int r = e / C_in, i = e - r * C_in;
      const int f = r / V, v = r - f * V;
      const size_t gi = row_at(d, v, m0 + f, C_in) + i;
      if constexpr (AFF) {
        const float xv = to_f(x[gi]);
        const float pre = __fadd_rn(__fmul_rn(xv, s1[i]), t1[i]);
        float dp = dhs[e];
        if (d.relu1 && !(pre > 0.f)) dp = 0.f;
        dx[gi] = from_f<T>(dp * s1[i]);
        dhs[e] = dp;
        hs[e] = dp * xv;
      } else {
        dx[gi] = from_f<T>(dhs[e]);
      }
    }
    __syncthreads();
    if constexpr (AFF) {
      for (int i = threadIdx.x; i < C_in; i += blockDim.x) {
        float ss = 0.f, st = 0.f;
        for (int r = 0; r < R; ++r) {
          ss += hs[r * C_in + i];
          st += dhs[r * C_in + i];
        }
        accumulate(&p_ds1[i], ss, first);
        accumulate(&p_dt1[i], st, first);
      }
      __syncthreads();
    }
  }
}

// Entries of one CTA's partial-sum slice.
long long partial_size(const Dims& d, bool aff) {
  return (long long)d.K * d.C_in * d.C_out + (long long)d.K * d.C_out +
         (long long)d.K * d.V * d.V + (aff ? 2LL * d.C_in : 0LL);
}

template <typename T, bool AFF, bool SAVE = false>
cudaError_t launch_fwd(const void* x, const void* s1, const void* t1,
                       const void* w, const void* b, const void* a, void* out,
                       const Dims& d, int smem_bytes, cudaStream_t stream,
                       void* ysave = nullptr) {
  auto kernel = spatial_fwd_kernel<T, AFF, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const int grid = (d.M + d.frames - 1) / d.frames;
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s1),
      static_cast<const float*>(t1), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<const T*>(a),
      static_cast<T*>(out), static_cast<T*>(ysave), d);
  return cudaGetLastError();
}

template <typename T, bool AFF, bool SAVE = false>
cudaError_t launch_bwd(const void* x, const void* g, const void* s1,
                       const void* t1, const void* w, const void* wT,
                       const void* b, const void* a, void* dx, void* partial,
                       void* grads, int ctas, int need_da, const Dims& d,
                       int smem_bytes, cudaStream_t stream,
                       const void* ysaved = nullptr) {
  auto kernel = spatial_bwd_kernel<T, AFF, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const long long E = partial_size(d, AFF);
  kernel<<<ctas, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(s1), static_cast<const float*>(t1),
      static_cast<const T*>(w), static_cast<const T*>(wT),
      static_cast<const T*>(b), static_cast<const T*>(a),
      static_cast<const T*>(ysaved), static_cast<T*>(dx),
      static_cast<float*>(partial), E, need_da, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return train::launch_reduce(static_cast<const float*>(partial),
                              static_cast<float*>(grads), ctas, E, stream);
}

Dims make_dims(int V, int M, int C_in, int C_out, int K, int frames,
               int relu1, int vmajor) {
  Dims d;
  d.V = V;
  d.M = M;
  d.C_in = C_in;
  d.C_out = C_out;
  d.K = K;
  d.frames = frames;
  d.relu1 = relu1;
  d.vmajor = vmajor;
  return d;
}

bool bad_bwd_args(int M, int frames, int ctas) {
  return frames < 1 || M < 1 || ctas < 1 || ctas > (M + frames - 1) / frames;
}

}  // namespace

extern "C" int spatial_block_fwd_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, void* out, int V, int M, int C_in,
    int C_out, int K, int frames, int relu1, int is_bf16, int smem_bytes,
    void* stream) {
  if (frames < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16, true>(
                             x, s1, t1, w, b, a, out, d, smem_bytes, s)
                       : launch_fwd<float, true>(x, s1, t1, w, b, a, out, d,
                                                 smem_bytes, s));
}

// grads: float32 [dW | db | dA | ds1 | dt1], the sums of the CTAs' slices
// of partial (ctas slices of the same layout).
extern "C" int spatial_block_bwd_launch(
    const void* x, const void* g, const void* s1, const void* t1,
    const void* w, const void* wT, const void* b, const void* a, void* dx,
    void* partial, void* grads, int V, int M, int C_in, int C_out, int K,
    int frames, int ctas, int relu1, int need_da, int is_bf16,
    int smem_bytes, void* stream) {
  if (bad_bwd_args(M, frames, ctas)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bwd<__nv_bfloat16, true>(
                             x, g, s1, t1, w, wT, b, a, dx, partial, grads,
                             ctas, need_da, d, smem_bytes, s)
                       : launch_bwd<float, true>(x, g, s1, t1, w, wT, b, a,
                                                 dx, partial, grads, ctas,
                                                 need_da, d, smem_bytes, s));
}

// spatial_block_save: the forward also writes y (K, V, M, C_out) in T, and
// the backward reads it for dA (grads as spatial_block_bwd_launch's, with
// dA always computed; b is not needed).
extern "C" int spatial_block_save_fwd_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, void* out, void* y, int V, int M, int C_in,
    int C_out, int K, int frames, int relu1, int is_bf16, int smem_bytes,
    void* stream) {
  if (frames < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16, true, true>(
                             x, s1, t1, w, b, a, out, d, smem_bytes, s, y)
                       : launch_fwd<float, true, true>(
                             x, s1, t1, w, b, a, out, d, smem_bytes, s, y));
}

extern "C" int spatial_block_save_bwd_launch(
    const void* x, const void* g, const void* y, const void* s1,
    const void* t1, const void* w, const void* wT, const void* a, void* dx,
    void* partial, void* grads, int V, int M, int C_in, int C_out, int K,
    int frames, int ctas, int relu1, int is_bf16, int smem_bytes,
    void* stream) {
  if (bad_bwd_args(M, frames, ctas)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bwd<__nv_bfloat16, true, true>(
                             x, g, s1, t1, w, wT, nullptr, a, dx, partial,
                             grads, ctas, 1, d, smem_bytes, s, y)
                       : launch_bwd<float, true, true>(
                             x, g, s1, t1, w, wT, nullptr, a, dx, partial,
                             grads, ctas, 1, d, smem_bytes, s, y));
}

// The plain graph convolution: vmajor = 1 for (V, M, C) tensors, 0 for
// (N, T, V, C) ones (M = N*T).
extern "C" int spatial_conv_fwd_launch(
    const void* x, const void* w, const void* b, const void* a, void* out,
    int V, int M, int C_in, int C_out, int K, int frames, int vmajor,
    int is_bf16, int smem_bytes, void* stream) {
  if (frames < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, 0, vmajor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16, false>(
                             x, nullptr, nullptr, w, b, a, out, d,
                             smem_bytes, s)
                       : launch_fwd<float, false>(x, nullptr, nullptr, w, b,
                                                  a, out, d, smem_bytes, s));
}

// grads: float32 [dW | db | dA], the sums of the CTAs' slices of partial.
extern "C" int spatial_conv_bwd_launch(
    const void* x, const void* g, const void* w, const void* wT,
    const void* b, const void* a, void* dx, void* partial, void* grads,
    int V, int M, int C_in, int C_out, int K, int frames, int ctas,
    int vmajor, int need_da, int is_bf16, int smem_bytes, void* stream) {
  if (bad_bwd_args(M, frames, ctas)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, 0, vmajor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bwd<__nv_bfloat16, false>(
                             x, g, nullptr, nullptr, w, wT, b, a, dx,
                             partial, grads, ctas, need_da, d, smem_bytes, s)
                       : launch_bwd<float, false>(x, g, nullptr, nullptr, w,
                                                  wT, b, a, dx, partial,
                                                  grads, ctas, need_da, d,
                                                  smem_bytes, s));
}
