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
// layouts and any channel count (C_in = 2 for the first block).  vmajor
// (Dims, or Params on the bf16 path) picks the layout in place: V-major
// (V, M, C), M = N*T frames, where a joint is M*C elements apart and a
// frame C; or frame-major (M, V, C), that is (N, T, V, C), where a joint
// is C apart and a frame V*C.
//
// Function, for frame m, joint v, output channel o ("round" = to the
// activation dtype T, bf16 or float32; sums in float32; AFF only in
// brackets):
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
// dW, db, dA, ds1 and dt1 sum over all M*V rows: the CTAs of the backward
// keep float32 partial sums in their slices of scratch tensors and second
// passes add the slices in a fixed order (train_common.cuh).
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
// (chip_smoke.py spatial_cost and save_cost recompute both per block.)
//
// Design, bf16 (every main path): tensor cores through tap_mma.cuh, in
// namespace spatial_mma.  A tile is F whole frames (the aggregation mixes
// joints): F*V rows of a 128-row mma tile (F = 5 of 25 joints: 125 rows).
//   * Forward, one kernel, a CTA a tile.  h is staged once as bf16 at the
//     padded pitch.  Per column block of 64 channels and per partition k,
//     y_k = round(h . W_k + b_k) runs on mma.sync (8 warps of 32 x 32, W_k's
//     C_in chunks through the cp.async ring) into shared memory [and, with
//     SAVE, to the saved tensor]; then z += A_k . y_k per frame as a
//     (32 x 32) . (32 x 64) mma, the joints padded to 32 with zeros in A,
//     z kept in float32 registers across the partitions and rounded once.
//   * Backward, three kernels and the ordered reductions, one op call:
//     the row kernel (a fixed number of CTAs looping over the tiles, g
//     staged once a tile) computes t_k = round(A_k^T . g) per frame on mma
//     and writes it to a bf16 scratch (rounded by definition, so storing it
//     changes no value), and dA_k = sum g . y_k^T with y_k recomputed by
//     the forward's own device function (y_tile: same tiles, same C_in
//     chunk order, so bit for bit the forward's y_k) or, with SAVE, read
//     from the saved tensor; its dA sums stay in shared memory and go to
//     its partial slice once.  The dx kernel is a GEMM over 128-row tiles,
//     dh = sum_k t_k . W_k^T with t_k and W_k^T chunks through the ring; its
//     epilogue writes dx = round(dpre [* s1]) [and the tile's column sums
//     of dpre * x and dpre].  The dW kernel, dW_k = h^T . t_k, splits the
//     M*V rows into slices, recomputes h from x while staging, keeps its
//     sums in registers across its slice and writes its partial once; the
//     CTAs of the first channel tile also sum t_k's columns (db_k).  The
//     slices are summed in a fixed order (train_common.cuh): no atomics,
//     and the gradients repeat bit for bit.
//   The rounding points are the plain versions': the y_k and t_k products
//   are not reassociated (aggregating before the expansion would change
//   y_k's rounding).
// Design, float32 (the port's check type; on tensor cores it would be
// TF32): scalar FMA on the CUDA cores, the first version kept as it was.
// A CTA of 256 threads takes F whole frames, keeps h, y_k, g, t_k and the
// z-sums of those frames in shared memory as float32, and runs each
// product as register tiles of 4x4 outputs (tile_product).  The forward
// launches one CTA per F frames.  The backward runs a fixed number of CTAs
// that each loop over F-frame chunks, so the weight-gradient partials stay
// small (one slice per CTA).  F is the largest of 8, 4, 2, 1 whose buffers
// fit in 227 KB (spatial_block.py plan_frames; one frame at C_in = C_out
// = 256).
//
// Launch contract (checked by the Python wrappers): x, g, w, b, a, y in T;
// s1, t1 float32 (AFF only); w is (K, C_in, C_out) and wT (K, C_out, C_in).
// float32: the dynamic shared memory is 4*F*V*(C_in + 2*C_out) bytes for
// the forward and 4*F*V*(2*C_in + 3*C_out) for the backward.  bf16: V <=
// 32, and the frames and shared bytes that spatial_block.py
// plan_spatial_mma_forward and plan_spatial_mma_backward give.  Each
// launcher returns cudaGetLastError() after its launches.

#include "tap_mma.cuh"
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

// ---- bf16: the tensor-core kernels (tap_mma.cuh) ---------------------------
namespace spatial_mma {

using tap::bf16;
constexpr int BM = 128;        // rows of a tile: F frames of V joints
constexpr int BN = 64;         // columns of a y or dh column block
constexpr int KC = 32;         // weight (or t) columns per ring stage
constexpr int KR = 64;         // dW: rows of the GEMM's K per chunk
constexpr int VP = 32;         // joints, padded with zeros, of A's products
constexpr int MAX_FRAMES = 6;  // frames of a tile (the z registers' units)
constexpr int MAXU = MAX_FRAMES * (BN / 16) / 8;  // z units per warp
constexpr int AP = VP + tap::kPad;   // pitch of a padded adjacency
constexpr int RBP = BN + tap::kPad;  // pitch of a ring stage and of ys
// rows of ys and gs: frame f's aggregation reads rows f*V .. f*V + 31
constexpr int YR = BM + 16;

struct Params {
  const bf16* x;     // (V, M, C_in) or (M, V, C_in)
  const bf16* g;     // dL/dz, x's layout with C_out channels
  const float* s1;   // AFF
  const float* t1;   // AFF
  const bf16* w;     // (K, C_in, C_out)
  const bf16* wT;    // (K, C_out, C_in)
  const bf16* b;     // (K, C_out); not read with SAVE's backward
  const bf16* a;     // (K, V, V)
  bf16* out;         // forward: z
  bf16* y;           // SAVE: (K, ...) of z's layout, the rounded y_k
  bf16* dx;          // backward: dL/dx
  bf16* t;           // backward: (K, M*V, C_out), row m*V + w: t_k
  float* partial;    // backward: the kernel's slices
  int V, M, C_in, C_out, K, frames, relu1, vmajor, need_da, split_rows;
};

// Offset of (joint v, frame m, channel 0) in a tensor of C channels.
__device__ __forceinline__ size_t at(const Params& p, int v, int m, int C) {
  return p.vmajor ? ((size_t)v * p.M + m) * C : ((size_t)m * p.V + v) * C;
}

// Rows 0 .. nrows-1 of the tile whose frames start at m0 (fc of them
// valid) into dst at `pitch`: row r = f*V + v, zero past fc*V and past C
// up to round16(C) [, as h with AFF].
template <bool AFF>
__device__ __forceinline__ void stage_rows(bf16* dst, int pitch,
                                           const bf16* src, int C, int nrows,
                                           int m0, int fc, const Params& p) {
  const int pieces = tap::round16(C) / 8;
  for (int e = threadIdx.x; e < nrows * pieces; e += blockDim.x) {
    const int r = e / pieces;
    const int c = (e - r * pieces) * 8;
    const int f = r / p.V;
    const bool valid = f < fc;
    const bf16* row = src + (valid ? at(p, r - f * p.V, m0 + f, C) : 0);
    tap::stage8<AFF>(dst + (size_t)r * pitch + c, row, c, C, valid, p.s1,
                     p.t1, p.relu1);
  }
}

// The K adjacencies as VP x VP tiles [k][row][col] of pitch AP, zero past
// V; TRANS stores A_k^T.
template <bool TRANS>
__device__ __forceinline__ void stage_adjacency(bf16* dst, const Params& p) {
  const int V = p.V;
  for (int e = threadIdx.x; e < p.K * VP * VP; e += blockDim.x) {
    const int k = e / (VP * VP);
    const int rc = e - k * VP * VP;
    const int r = rc / VP, c = rc - r * VP;
    bf16 val = __float2bfloat16_rn(0.f);
    if (r < V && c < V)
      val = TRANS ? p.a[((size_t)k * V + c) * V + r]
                  : p.a[((size_t)k * V + r) * V + c];
    dst[((size_t)k * VP + r) * AP + c] = val;
  }
}

// Four ldmatrix fragments of a padded adjacency tile: [kk][mi] covers rows
// 16*mi .. and columns 16*kk .. of k's VP x VP tile.
__device__ __forceinline__ void adjacency_frags(uint32_t (&af)[2][2][4],
                                                const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      tap::ldsm_x4(af[kk][mi],
                   tap::smem_u32(tile + (mi * 16 + tap::a_lane_row(lane)) * AP +
                                 kk * 16 + tap::lane_col8(lane)));
}

// ys[r][o - nb] = round(h[r] . W_k[:, o] + b_k[o]) for the BM rows of hs
// and the BN columns o = nb .. (zero past C_out), on mma.sync: 8 warps of
// 32 x 32, W_k's C_in chunks through the ring.  The forward and the
// backward's recompute both call this, with the same tiles and the same
// chunk order, so their y_k agree bit for bit.  With SAVE (the forward)
// the rows of valid frames also go to p.y.
template <bool SAVE>
__device__ __forceinline__ void y_tile(const Params& p, const bf16* hs,
                                       int HP, bf16* ring, bf16* ys, int k,
                                       int nb, int m0, int fc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int Kp = tap::round16(p.C_in);
  const int nkc = (Kp + KC - 1) / KC;
  const int col8 = tap::lane_col8(lane);
  const bf16* wk = p.w + (size_t)k * p.C_in * p.C_out;
  float acc[2][4][4];
  tap::zero(acc);
  tap::ring_loop(
      nkc,
      [&](int ch) {
        const int k0 = ch * KC;
        tap::stage_tile(ring + (ch & 1) * KC * RBP, RBP,
                        k0 < p.C_in ? wk + (size_t)k0 * p.C_out + nb : wk,
                        p.C_out, KC, p.C_in - k0, BN, p.C_out - nb);
        tap::cp_async_commit();
      },
      [&](int ch) {
        const int k0 = ch * KC;
        const int steps = min(KC, Kp - k0) / 16;
        const bf16* bs = ring + (ch & 1) * KC * RBP;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if (kk >= steps) break;
          uint32_t a_addr[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            a_addr[mi] = tap::smem_u32(
                hs + (wm * 32 + mi * 16 + tap::a_lane_row(lane)) * HP + k0 +
                kk * 16 + col8);
          tap::mma_k16<2, 4>(
              acc, a_addr,
              tap::smem_u32(bs + (kk * 16 + (lane & 15)) * RBP + wn * 32 +
                            col8));
        }
      });
  const bf16* bk = p.b + (size_t)k * p.C_out;
  bf16* yk = SAVE ? p.y + (size_t)k * p.V * p.M * p.C_out : nullptr;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + tap::acc_row(mi, 2 * h, lane);
        const int cl = wn * 32 + tap::acc_col(nj, 0, lane);
        const int o = nb + cl;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          v[q] = o + q < p.C_out
                     ? acc[mi][nj][2 * h + q] + __bfloat162float(bk[o + q])
                     : 0.f;
        const __nv_bfloat162 y2 = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(ys + r * RBP + cl) = y2;
        if constexpr (SAVE) {
          const int f = r / p.V;
          if (f < fc && o < p.C_out) {
            bf16* dst = yk + at(p, r - f * p.V, m0 + f, p.C_out) + o;
            if (o + 1 < p.C_out && p.C_out % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = y2;
            } else {
              dst[0] = y2.x;
              if (o + 1 < p.C_out) dst[1] = y2.y;
            }
          }
        }
      }
}

// One bf16 pair of an output row: two channels o, o+1 (o even), the
// second only below C.
__device__ __forceinline__ void store2(bf16* dst, int o, int C, float v0,
                                      float v1) {
  if (o >= C) return;
  if (o + 1 < C && C % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (o + 1 < C) dst[1] = __float2bfloat16_rn(v1);
  }
}

// The forward.  A CTA owns F whole frames (the aggregation mixes joints):
// h of its BM rows is staged once, then per column block of BN channels
// and per partition k, y_k = round(h . W_k + b_k) lands in ys (y_tile) and
// z += A_k . y_k runs per frame as a (VP x VP) . (VP x BN) product; z stays
// in float32 registers across the partitions and is rounded once.  Units
// of the aggregation are (frame, 16 columns), warp w taking w, w + 8, ...
// Shared: ring [2][KC][RBP] | A [K][VP][AP] | hs [BM][HP] | ys [YR][RBP].
template <bool AFF, bool SAVE>
__global__ void __launch_bounds__(tap::kThreads)
spatial_mma_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = tap::pitch_of(p.C_in);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* as = ring + 2 * KC * RBP;
  bf16* hs = as + (size_t)p.K * VP * AP;
  bf16* ys = hs + (size_t)BM * HP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int V = p.V, F = p.frames;
  const int m0 = blockIdx.x * F;
  const int fc = min(F, p.M - m0);
  const int col8 = tap::lane_col8(lane);

  stage_adjacency<false>(as, p);
  stage_rows<AFF>(hs, HP, p.x, p.C_in, BM, m0, fc, p);
  for (int e = threadIdx.x; e < (YR - BM) * RBP; e += blockDim.x)
    ys[BM * RBP + e] = __float2bfloat16_rn(0.f);  // rows past the tile
  __syncthreads();

  const int units = F * (BN / 16);
  for (int nb = 0; nb < p.C_out; nb += BN) {
    float z[MAXU][2][2][4];
#pragma unroll
    for (int i = 0; i < MAXU; ++i) tap::zero(z[i]);
    for (int k = 0; k < p.K; ++k) {
      y_tile<SAVE>(p, hs, HP, ring, ys, k, nb, m0, fc);
      __syncthreads();
      uint32_t af[2][2][4];
      adjacency_frags(af, as + (size_t)k * VP * AP, lane);
#pragma unroll
      for (int i = 0; i < MAXU; ++i) {
        const int u = warp + 8 * i;
        if (u >= units) break;
        const int f = u / (BN / 16), cg = u % (BN / 16);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          tap::mma_k16_frag<2, 2>(
              z[i], af[kk],
              tap::smem_u32(ys + (f * V + kk * 16 + (lane & 15)) * RBP +
                            cg * 16 + col8));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < MAXU; ++i) {
      const int u = warp + 8 * i;
      if (u >= units) break;
      const int f = u / (BN / 16), cg = u % (BN / 16);
      if (f >= fc) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = tap::acc_row(mi, 2 * h, lane);
            const int o = nb + cg * 16 + tap::acc_col(nj, 0, lane);
            if (v < V)
              store2(p.out + at(p, v, m0 + f, p.C_out) + o, o, p.C_out,
                     z[i][mi][nj][2 * h], z[i][mi][nj][2 * h + 1]);
          }
    }
  }
}

// The backward's row kernel.  A fixed number of CTAs loop over the F-frame
// tiles (tile = blockIdx.x, + gridDim.x, ...), each with g staged once:
//   * t_k = round(A_k^T . g) per frame, a (VP x VP) . (VP x C_out) product
//     (units of 16 columns), written to p.t as bf16 (rounded by
//     definition, so the store changes no value);
//   * with need_da (always with SAVE), dA_k += g_f . y_k,f^T per frame and
//     column block, y_k recomputed by y_tile from h or, with SAVE, staged
//     from p.y.  Warp w owns the 16 x 16 sub-tile (w & 3) of the VP x VP
//     output and the k16 steps of parity w >> 2; its sums go to a float32
//     shared slice per (k, parity), each element one thread's, summed in a
//     fixed order and written to p.partial once, at the end.
// Shared: ring | A^T [K][VP][AP] | gs [YR][GP] | hs [BM][HP] | ys [YR][RBP]
//         | sda [K][2][VP][VP] float.
template <bool AFF, bool SAVE>
__global__ void __launch_bounds__(tap::kThreads)
spatial_mma_t_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = tap::pitch_of(p.C_in), GP = tap::pitch_of(p.C_out);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* ats = ring + 2 * KC * RBP;
  bf16* gs = ats + (size_t)p.K * VP * AP;
  bf16* hs = gs + (size_t)YR * GP;
  bf16* ys = hs + (size_t)BM * HP;
  float* sda = reinterpret_cast<float*>(ys + YR * RBP);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int V = p.V, F = p.frames, C_out = p.C_out;
  const int col8 = tap::lane_col8(lane);
  const int sub = warp & 3, half = warp >> 2;
  const bool need_da = SAVE || p.need_da;
  const int ng = (C_out + 15) / 16;
  const int tiles = (p.M + F - 1) / F;
  const size_t MV = (size_t)p.M * V;

  stage_adjacency<true>(ats, p);
  for (int e = threadIdx.x; e < 2 * p.K * VP * VP; e += blockDim.x)
    sda[e] = 0.f;
  for (int e = threadIdx.x; e < (YR - BM) * RBP; e += blockDim.x)
    ys[BM * RBP + e] = __float2bfloat16_rn(0.f);  // rows past the tile
  __syncthreads();

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * F;
    const int fc = min(F, p.M - m0);
    stage_rows<false>(gs, GP, p.g, C_out, YR, m0, fc, p);
    if (!SAVE && need_da) stage_rows<AFF>(hs, HP, p.x, p.C_in, BM, m0, fc, p);
    __syncthreads();
    for (int k = 0; k < p.K; ++k) {
      // t_k = round(A_k^T . g)
      uint32_t af[2][2][4];
      adjacency_frags(af, ats + (size_t)k * VP * AP, lane);
      for (int u = warp; u < fc * ng; u += 8) {
        const int f = u / ng, cg = u - f * ng;
        float acc[2][2][4];
        tap::zero(acc);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          tap::mma_k16_frag<2, 2>(
              acc, af[kk],
              tap::smem_u32(gs + (f * V + kk * 16 + (lane & 15)) * GP +
                            cg * 16 + col8));
        bf16* tk = p.t + ((size_t)k * MV + (size_t)(m0 + f) * V) * C_out;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int wj = tap::acc_row(mi, 2 * h, lane);
              const int o = cg * 16 + tap::acc_col(nj, 0, lane);
              if (wj < V)
                store2(tk + (size_t)wj * C_out + o, o, C_out,
                       acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
            }
      }
      if (!need_da) continue;
      // dA_k += g . y_k^T over the tile's frames and channels
      float dacc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[j][e] = 0.f;
      for (int nb = 0; nb < C_out; nb += BN) {
        if constexpr (SAVE) {
          const bf16* yk = p.y + (size_t)k * MV * C_out;
          for (int e = threadIdx.x; e < YR * (BN / 8); e += blockDim.x) {
            const int r = e / (BN / 8);
            const int c = (e - r * (BN / 8)) * 8;
            const int f = r / V;
            const bool valid = f < fc;
            const bf16* row =
                yk + (valid ? at(p, r - f * V, m0 + f, C_out) + nb : 0);
            tap::stage8<false>(ys + r * RBP + c, row, c, C_out - nb, valid,
                               nullptr, nullptr, 0);
          }
          __syncthreads();
        } else {
          y_tile<false>(p, hs, HP, ring, ys, k, nb, m0, fc);
          __syncthreads();
        }
        const int steps = (min(BN, C_out - nb) + 15) / 16;
        for (int f = 0; f < fc; ++f)
          for (int kk = half; kk < steps; kk += 2)
            tap::mma_k16_nk(
                dacc,
                tap::smem_u32(gs + (f * V + (sub >> 1) * 16 +
                                    tap::a_lane_row(lane)) * GP +
                              nb + kk * 16 + col8),
                tap::smem_u32(ys + (f * V + (sub & 1) * 16 +
                                    tap::at_lane_row(lane)) * RBP +
                              kk * 16 + tap::at_lane_col(lane)));
        __syncthreads();  // ys is restaged for the next column block
      }
      float* dk = sda + (size_t)(k * 2 + half) * VP * VP;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dk[((sub >> 1) * 16 + tap::acc_row(0, e, lane)) * VP +
             (sub & 1) * 16 + tap::acc_col(j, e, lane)] += dacc[j][e];
    }
    __syncthreads();  // gs and hs are restaged for the next tile
  }
  float* slice = p.partial + (size_t)blockIdx.x * p.K * V * V;
  for (int e = threadIdx.x; e < p.K * V * V; e += blockDim.x) {
    const int k = e / (V * V);
    const int vw = e - k * V * V;
    const int v = vw / V, wj = vw - v * V;
    const float* dk = sda + (size_t)k * 2 * VP * VP + v * VP + wj;
    slice[e] = dk[0] + dk[VP * VP];
  }
}

// dh = sum_k t_k . W_k^T as a GEMM over the M*V rows (K = K*C_out): a CTA
// owns BM rows and BN of the C_in columns, its 8 warps 4 x 2 tiles of
// 32 x 32; chunks of KC columns of t_k and the matching rows of W_k^T
// stream through one ring.  Epilogue: dpre = dh [through the ReLU mask],
// dx = round(dpre [* s1]); with AFF the column sums of dpre * x and dpre
// over the CTA's rows go to its slice of p.partial, [tile][ds1 | dt1].
// Shared: t ring [2][BM][TP] | W^T ring [2][KC][RBP] | red [2][4][BN].
template <bool AFF>
__global__ void __launch_bounds__(tap::kThreads)
spatial_mma_dx_kernel(Params p) {
  constexpr int TP = KC + tap::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ra = reinterpret_cast<bf16*>(smem_raw);
  bf16* rb = ra + 2 * BM * TP;
  float* red = reinterpret_cast<float*>(rb + 2 * KC * RBP);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int C_in = p.C_in, C_out = p.C_out;
  const int R = p.M * p.V;
  const int r0 = blockIdx.x * BM;
  const int nb = blockIdx.y * BN;
  const int rows = min(BM, R - r0);
  const int Kp = tap::round16(C_out);
  const int nkc = (Kp + KC - 1) / KC;
  const int col8 = tap::lane_col8(lane);

  float acc[2][4][4];
  tap::zero(acc);
  tap::ring_loop(
      p.K * nkc,
      [&](int ch) {
        const int k = ch / nkc;
        const int c0 = (ch - k * nkc) * KC;
        tap::stage_tile(ra + (ch & 1) * BM * TP, TP,
                        p.t + ((size_t)k * R + r0) * C_out + c0, C_out, BM,
                        rows, KC, C_out - c0);
        tap::stage_tile(rb + (ch & 1) * KC * RBP, RBP,
                        p.wT + ((size_t)k * C_out + c0) * C_in + nb, C_in, KC,
                        C_out - c0, BN, C_in - nb);
        tap::cp_async_commit();
      },
      [&](int ch) {
        const int c0 = (ch % nkc) * KC;
        const int steps = min(KC, Kp - c0) / 16;
        const bf16* as = ra + (ch & 1) * BM * TP;
        const bf16* bs = rb + (ch & 1) * KC * RBP;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if (kk >= steps) break;
          uint32_t a_addr[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            a_addr[mi] = tap::smem_u32(
                as + (wm * 32 + mi * 16 + tap::a_lane_row(lane)) * TP +
                kk * 16 + col8);
          tap::mma_k16<2, 4>(
              acc, a_addr,
              tap::smem_u32(bs + (kk * 16 + (lane & 15)) * RBP + wn * 32 +
                            col8));
        }
      });

  float cs[4][2], ct[4][2];  // AFF: column sums of dpre * x and dpre
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
    cs[nj][0] = cs[nj][1] = ct[nj][0] = ct[nj][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + tap::acc_row(mi, 2 * h, lane);
      if (r >= rows) continue;
      const int gr = r0 + r;
      const int m = gr / p.V;
      const size_t base = at(p, gr - m * p.V, m, C_in);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int i = nb + wn * 32 + tap::acc_col(nj, 0, lane);
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          v[q] = acc[mi][nj][2 * h + q];
          if constexpr (AFF) {
            if (i + q < C_in) {
              const float xv = __bfloat162float(p.x[base + i + q]);
              const float pre = tap::affine(xv, p.s1[i + q], p.t1[i + q]);
              const float dp = (p.relu1 && !(pre > 0.f)) ? 0.f : v[q];
              cs[nj][q] += dp * xv;
              ct[nj][q] += dp;
              v[q] = dp * p.s1[i + q];
            }
          }
        }
        store2(p.dx + base + i, i, C_in, v[0], v[1]);
      }
    }
  if constexpr (AFF) {
    // the thread's rows, then the warp's eight row groups (xor over lane
    // bits 2-4), then the four warp rows in order
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float a = cs[nj][q], b = ct[nj][q];
#pragma unroll
        for (int s = 4; s < 32; s <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, s);
          b += __shfl_xor_sync(0xffffffffu, b, s);
        }
        if (lane < 4) {
          const int col = wn * 32 + tap::acc_col(nj, q, lane);
          red[wm * BN + col] = a;
          red[(4 + wm) * BN + col] = b;
        }
      }
    __syncthreads();
    float* slice = p.partial + (size_t)blockIdx.x * 2 * C_in;
    for (int c = threadIdx.x; c < BN; c += blockDim.x) {
      if (nb + c >= C_in) continue;
      float a = 0.f, b = 0.f;
      for (int w = 0; w < 4; ++w) {
        a += red[w * BN + c];
        b += red[(4 + w) * BN + c];
      }
      slice[nb + c] = a;
      slice[C_in + nb + c] = b;
    }
  }
}

// dW_k[c, o] = sum over the rows r of h[r][c] * t_k[r][o]: a CTA owns one
// k, DBM = 64 input channels, DBN = 32 * NJ output channels and one split
// of the M*V rows; its 8 warps are 2 x 4 tiles of 32 x 8*NJ.  h (recomputed
// from x while staging: the affine, the ReLU, the rounding) and t_k stream
// through a ring in chunks of KR rows.  The CTAs of the first input-channel
// tile also sum t_k's columns (db_k).  Slice p.partial[split] is
// [K*C_in*C_out (dW) | K*C_out (db)].
template <bool AFF, int NJ>
__global__ void __launch_bounds__(tap::kThreads)
spatial_mma_dw_kernel(Params p) {
  constexpr int WN = 4, DBM = 64, DBN = 8 * NJ * WN;
  constexpr int DAP = DBM + tap::kPad, DBP = DBN + tap::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ha = reinterpret_cast<bf16*>(smem_raw);  // [2][KR][DAP]
  bf16* ts = ha + 2 * KR * DAP;                  // [2][KR][DBP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int C_in = p.C_in, C_out = p.C_out;
  const int nct = (C_in + DBM - 1) / DBM;
  const int k = blockIdx.x / nct;
  const int c0 = (blockIdx.x - k * nct) * DBM;
  const int n0 = blockIdx.y * DBN;
  const int R = p.M * p.V;
  const int k_begin = blockIdx.z * p.split_rows;
  const int k_end = min(R, k_begin + p.split_rows);
  const int nchunks = (k_end - k_begin + KR - 1) / KR;
  const bool do_db = c0 == 0;
  const bool t_aligned = C_out % 8 == 0;
  const bool x_aligned = !AFF && C_in % 8 == 0;
  const bf16* tk = p.t + (size_t)k * R * C_out;

  auto stage = [&](int ch) {
    const int kb = k_begin + ch * KR;
    bf16* hd = ha + (ch & 1) * KR * DAP;
    bf16* td = ts + (ch & 1) * KR * DBP;
    for (int e = threadIdx.x; e < KR * (DBN / 8); e += blockDim.x) {
      const int r = e / (DBN / 8);
      const int c = (e - r * (DBN / 8)) * 8;
      const int gr = kb + r;
      const int valid = gr < k_end ? min(8, max(0, C_out - n0 - c)) : 0;
      const bf16* src = valid > 0 ? tk + (size_t)gr * C_out + n0 + c : tk;
      bf16* d = td + r * DBP + c;
      if (t_aligned) {
        tap::cp_async16(tap::smem_u32(d), src, valid * (int)sizeof(bf16));
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          d[q] = q < valid ? src[q] : __float2bfloat16_rn(0.f);
      }
    }
    for (int e = threadIdx.x; e < KR * (DBM / 8); e += blockDim.x) {
      const int r = e / (DBM / 8);
      const int c = (e - r * (DBM / 8)) * 8;
      const int gr = kb + r;
      const bool valid = gr < k_end;
      const bf16* row = p.x;
      if (valid) {
        const int m = gr / p.V;
        row = p.x + at(p, gr - m * p.V, m, C_in) + c0;
      }
      bf16* d = hd + r * DAP + c;
      if (x_aligned) {
        const int n = valid ? min(8, max(0, C_in - c0 - c)) : 0;
        tap::cp_async16(tap::smem_u32(d), n > 0 ? row + c : p.x,
                        n * (int)sizeof(bf16));
      } else {
        tap::stage8<AFF>(d, row, c, C_in - c0, valid, p.s1 + c0, p.t1 + c0,
                         p.relu1);
      }
    }
    tap::cp_async_commit();
  };

  float acc[2][NJ][4];
  tap::zero(acc);
  float sb = 0.f;
  const int col8 = tap::lane_col8(lane);
  tap::ring_loop(nchunks, stage, [&](int ch) {
    const bf16* hd = ha + (ch & 1) * KR * DAP;
    const bf16* td = ts + (ch & 1) * KR * DBP;
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk) {
      uint32_t a_addr[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        a_addr[mi] = tap::smem_u32(hd + (kk * 16 + tap::at_lane_row(lane)) *
                                            DAP +
                                   wm * 32 + mi * 16 + tap::at_lane_col(lane));
      tap::mma_k16<2, NJ, true>(
          acc, a_addr,
          tap::smem_u32(td + (kk * 16 + (lane & 15)) * DBP + wn * 8 * NJ +
                        col8));
    }
    if (do_db && (int)threadIdx.x < DBN) {
      for (int r = 0; r < KR; ++r)
        sb += __bfloat162float(td[r * DBP + threadIdx.x]);
    }
  });

  const size_t E = (size_t)p.K * C_in * C_out + (size_t)p.K * C_out;
  float* slice = p.partial + (size_t)blockIdx.z * E;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + wm * 32 + tap::acc_row(mi, e, lane);
        const int o = n0 + wn * 8 * NJ + tap::acc_col(nj, e, lane);
        if (c < C_in && o < C_out)
          slice[((size_t)k * C_in + c) * C_out + o] = acc[mi][nj][e];
      }
  if (do_db && (int)threadIdx.x < DBN && n0 + (int)threadIdx.x < C_out)
    slice[(size_t)p.K * C_in * C_out + (size_t)k * C_out + n0 + threadIdx.x] =
        sb;
}

template <typename Kern>
cudaError_t prepare(Kern kernel, int smem_bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <bool AFF, bool SAVE>
cudaError_t forward(const Params& p, int smem, cudaStream_t st) {
  auto kernel = spatial_mma_fwd_kernel<AFF, SAVE>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(p.M + p.frames - 1) / p.frames, tap::kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

struct BwdPlan {
  int ctas, t_smem, dx_smem, nj_dw, splits, dw_smem;
  float* partial_da;
  float* partial_dx;
  float* partial_dw;
};

// t kernel, dx kernel, dW kernel, then the passes that sum their slices in
// order into grads = [dW | db | dA (| ds1 | dt1)].
template <bool AFF, bool SAVE>
cudaError_t backward(Params p, const BwdPlan& b, float* grads,
                     cudaStream_t st) {
  const long long R = (long long)p.M * p.V;
  const long long e_dw = (long long)p.K * p.C_in * p.C_out +
                         (long long)p.K * p.C_out;
  const long long e_da = (long long)p.K * p.V * p.V;
  auto tk = spatial_mma_t_kernel<AFF, SAVE>;
  cudaError_t err = prepare(tk, b.t_smem);
  if (err != cudaSuccess) return err;
  p.partial = b.partial_da;
  tk<<<b.ctas, tap::kThreads, b.t_smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dxk = spatial_mma_dx_kernel<AFF>;
  if ((err = prepare(dxk, b.dx_smem)) != cudaSuccess) return err;
  p.partial = b.partial_dx;
  const int tiles_x = (int)((R + BM - 1) / BM);
  dxk<<<dim3(tiles_x, (p.C_in + BN - 1) / BN), tap::kThreads, b.dx_smem,
        st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dwk = b.nj_dw == 4 ? spatial_mma_dw_kernel<AFF, 4>
                          : spatial_mma_dw_kernel<AFF, 2>;
  if ((err = prepare(dwk, b.dw_smem)) != cudaSuccess) return err;
  p.partial = b.partial_dw;
  const int dbn = 32 * b.nj_dw;
  dwk<<<dim3(p.K * ((p.C_in + 63) / 64), (p.C_out + dbn - 1) / dbn,
             b.splits),
        tap::kThreads, b.dw_smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = train::launch_reduce(b.partial_dw, grads, b.splits, e_dw, st);
  if (err != cudaSuccess) return err;
  err = train::launch_reduce(b.partial_da, grads + e_dw, b.ctas, e_da, st);
  if (err != cudaSuccess || !AFF) return err;
  return train::launch_reduce_columns(b.partial_dx, grads + e_dw + e_da,
                                      tiles_x, 2 * p.C_in, st);
}

// A tile's shape holds for the kernels' fixed tiles: V <= VP joints, F <=
// MAX_FRAMES frames of them in BM rows, every frame's VP-row window inside
// the YR staged rows; rows and scratch offsets fit in an int.
bool bad_dims(int V, int M, int C_in, int C_out, int K, int frames) {
  return V < 1 || V > VP || M < 1 || C_in < 1 || C_out < 1 || K < 1 ||
         frames < 1 || frames > MAX_FRAMES || frames * V > BM ||
         (frames - 1) * V + VP > YR ||
         (long long)M * V * (C_in > C_out ? C_in : C_out) >= (1LL << 31);
}

}  // namespace spatial_mma

// ---- C interface -----------------------------------------------------------
// The float32 launchers run the scalar kernels; is_bf16 must be 0 (bf16
// runs the tensor-core launchers at the end of this file).
extern "C" int spatial_block_fwd_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, void* out, int V, int M, int C_in,
    int C_out, int K, int frames, int relu1, int is_bf16, int smem_bytes,
    void* stream) {
  if (frames < 1 || M < 1 || is_bf16) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_fwd<float, true>(x, s1, t1, w, b, a, out, d, smem_bytes,
      s);
}

// grads: float32 [dW | db | dA | ds1 | dt1], the sums of the CTAs' slices
// of partial (ctas slices of the same layout).
extern "C" int spatial_block_bwd_launch(
    const void* x, const void* g, const void* s1, const void* t1,
    const void* w, const void* wT, const void* b, const void* a, void* dx,
    void* partial, void* grads, int V, int M, int C_in, int C_out, int K,
    int frames, int ctas, int relu1, int need_da, int is_bf16,
    int smem_bytes, void* stream) {
  if (bad_bwd_args(M, frames, ctas) || is_bf16)
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_bwd<float, true>(x, g, s1, t1, w, wT, b, a, dx, partial,
      grads, ctas, need_da, d, smem_bytes, s);
}

// spatial_block_save: the forward also writes y (K, V, M, C_out) in T, and
// the backward reads it for dA (grads as spatial_block_bwd_launch's, with
// dA always computed; b is not needed).
extern "C" int spatial_block_save_fwd_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, void* out, void* y, int V, int M, int C_in,
    int C_out, int K, int frames, int relu1, int is_bf16, int smem_bytes,
    void* stream) {
  if (frames < 1 || M < 1 || is_bf16) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_fwd<float, true, true>(x, s1, t1, w, b, a, out, d,
      smem_bytes, s, y);
}

extern "C" int spatial_block_save_bwd_launch(
    const void* x, const void* g, const void* y, const void* s1,
    const void* t1, const void* w, const void* wT, const void* a, void* dx,
    void* partial, void* grads, int V, int M, int C_in, int C_out, int K,
    int frames, int ctas, int relu1, int is_bf16, int smem_bytes,
    void* stream) {
  if (bad_bwd_args(M, frames, ctas) || is_bf16)
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_bwd<float, true, true>(x, g, s1, t1, w, wT, nullptr, a, dx,
      partial, grads, ctas, 1, d, smem_bytes, s, y);
}

// The plain graph convolution: vmajor = 1 for (V, M, C) tensors, 0 for
// (N, T, V, C) ones (M = N*T).
extern "C" int spatial_conv_fwd_launch(
    const void* x, const void* w, const void* b, const void* a, void* out,
    int V, int M, int C_in, int C_out, int K, int frames, int vmajor,
    int is_bf16, int smem_bytes, void* stream) {
  if (frames < 1 || M < 1 || is_bf16) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, 0, vmajor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_fwd<float, false>(x, nullptr, nullptr, w, b, a, out, d,
      smem_bytes, s);
}

// grads: float32 [dW | db | dA], the sums of the CTAs' slices of partial.
extern "C" int spatial_conv_bwd_launch(
    const void* x, const void* g, const void* w, const void* wT,
    const void* b, const void* a, void* dx, void* partial, void* grads,
    int V, int M, int C_in, int C_out, int K, int frames, int ctas,
    int vmajor, int need_da, int is_bf16, int smem_bytes, void* stream) {
  if (bad_bwd_args(M, frames, ctas) || is_bf16)
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, 0, vmajor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_bwd<float, false>(x, g, nullptr, nullptr, w, wT, b, a, dx,
      partial, grads, ctas, need_da, d, smem_bytes, s);
}

// The bf16 launchers run the tensor-core kernels for every op on this
// source: aff = 1 is spatial_block (V-major x, the affine and ReLU), with
// save = 1 spatial_block_save; aff = 0 spatial_conv (vmajor picks the
// layout; s1, t1 unused).  frames is F of spatial_block.py
// plan_spatial_mma_forward; y is the saved (K, ...) expansion (save only).
extern "C" int spatial_mma_fwd_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, void* out, void* y, int V, int M, int C_in,
    int C_out, int K, int frames, int aff, int save, int relu1, int vmajor,
    int smem_bytes, void* stream) {
  if (spatial_mma::bad_dims(V, M, C_in, C_out, K, frames) || (save && !aff))
    return (int)cudaErrorInvalidValue;
  spatial_mma::Params p{};
  p.x = static_cast<const tap::bf16*>(x);
  p.s1 = static_cast<const float*>(s1);
  p.t1 = static_cast<const float*>(t1);
  p.w = static_cast<const tap::bf16*>(w);
  p.b = static_cast<const tap::bf16*>(b);
  p.a = static_cast<const tap::bf16*>(a);
  p.out = static_cast<tap::bf16*>(out);
  p.y = static_cast<tap::bf16*>(y);
  p.V = V;
  p.M = M;
  p.C_in = C_in;
  p.C_out = C_out;
  p.K = K;
  p.frames = frames;
  p.relu1 = relu1;
  p.vmajor = vmajor;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (save)
    err = spatial_mma::forward<true, true>(p, smem_bytes, s);
  else if (aff)
    err = spatial_mma::forward<true, false>(p, smem_bytes, s);
  else
    err = spatial_mma::forward<false, false>(p, smem_bytes, s);
  return (int)err;
}

// One op call's backward: the t kernel (ctas CTAs over the F-frame tiles,
// t the (K, M*V, C_out) bf16 scratch, partial_da its [ctas][K*V*V]
// slices), the dx kernel (partial_dx: [ceil(M*V / 128)][2*C_in], aff
// only), the dW kernel (splits slices of split_rows rows in partial_dw,
// each [K*C_in*C_out | K*C_out]; N tiles of 32 * nj_dw channels) and the
// passes that sum the slices in order into grads = [dW | db | dA
// (| ds1 | dt1)].  need_da = 0 (without save) skips dA, which is then 0.
extern "C" int spatial_mma_bwd_launch(
    const void* x, const void* g, const void* s1, const void* t1,
    const void* w, const void* wT, const void* b, const void* a,
    const void* y, void* dx, void* t, void* partial_da, void* partial_dx,
    void* partial_dw, void* grads, int V, int M, int C_in, int C_out, int K,
    int frames, int aff, int save, int relu1, int vmajor, int need_da,
    int ctas, int t_smem, int dx_smem, int nj_dw, int splits, int split_rows,
    int dw_smem, void* stream) {
  const long long rows = (long long)M * V;
  if (spatial_mma::bad_dims(V, M, C_in, C_out, K, frames) || (save && !aff) ||
      ctas < 1 || ctas > (M + frames - 1) / frames ||
      (nj_dw != 2 && nj_dw != 4) || splits < 1 || split_rows < 1 ||
      (long long)splits * split_rows < rows ||
      (long long)(splits - 1) * split_rows >= rows)
    return (int)cudaErrorInvalidValue;
  spatial_mma::Params p{};
  p.x = static_cast<const tap::bf16*>(x);
  p.g = static_cast<const tap::bf16*>(g);
  p.s1 = static_cast<const float*>(s1);
  p.t1 = static_cast<const float*>(t1);
  p.w = static_cast<const tap::bf16*>(w);
  p.wT = static_cast<const tap::bf16*>(wT);
  p.b = static_cast<const tap::bf16*>(b);
  p.a = static_cast<const tap::bf16*>(a);
  p.y = const_cast<tap::bf16*>(static_cast<const tap::bf16*>(y));
  p.dx = static_cast<tap::bf16*>(dx);
  p.t = static_cast<tap::bf16*>(t);
  p.V = V;
  p.M = M;
  p.C_in = C_in;
  p.C_out = C_out;
  p.K = K;
  p.frames = frames;
  p.relu1 = relu1;
  p.vmajor = vmajor;
  p.need_da = need_da;
  p.split_rows = split_rows;
  spatial_mma::BwdPlan plan{ctas,
                         t_smem,
                         dx_smem,
                         nj_dw,
                         splits,
                         dw_smem,
                         static_cast<float*>(partial_da),
                         static_cast<float*>(partial_dx),
                         static_cast<float*>(partial_dw)};
  float* out = static_cast<float*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (save)
    err = spatial_mma::backward<true, true>(p, plan, out, s);
  else if (aff)
    err = spatial_mma::backward<true, false>(p, plan, out, s);
  else
    err = spatial_mma::backward<false, false>(p, plan, out, s);
  return (int)err;
}
