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
// (Dims, or RowArgs on the bf16 path) picks the layout in place: V-major
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
// for dA, the t_k and dh products) and moves x, g and dx: 0.02-0.11 ms a
// block.  SAVE trades the recompute's 2*M*V*C_in*K*C_out operations for
// K*M*V*C_out*sizeof(T) bytes written by the forward and read by the
// backward: 125 MB a block at blocks 8-9 (M = 4,864, C_in = C_out = 256,
// K = 2, bf16), 32 GFLOP.  (chip_smoke.py spatial_cost and save_cost
// recompute both per block.)
//
// Design, bf16 (every main path): Hopper's warpgroup MMA (wgmma.cuh), in
// namespace spatial_wg; a CTA is a producer warpgroup and two consumer
// warpgroups of 64 rows.  A tile of the row kernels is F whole frames (the
// aggregation mixes joints): F*V of the 128 rows (F = 5 of 25 joints: 125
// rows).  The weights go through TMA always: the wrappers pad W's and
// W^T's rows to 16-byte strides (C % 8 != 0: 36, 2) with zero columns, and
// the t and h scratch tensors are allocated at such a pitch; only
// activation rows without 16-byte strides take plain loads.
//   * Forward (spatial_wg_fwd_kernel), persistent CTAs, two an SM where
//     their shared bytes allow.  Warp 0 streams W_k's chunks of kc C_in
//     rows by one 64-column slab by TMA into 128B-swizzled stages with full
//     and empty mbarriers, resident (loaded once a CTA) where a tile's
//     chunks fit in 8 stages (C_in <= 128 at C_out <= 64, ...); warps 1-3
//     stage each tile's h a buffer ahead.  Per slab, the consumers compute
//     y_k = round(h . W_k + b_k) for every partition with wgmma m64n64k16
//     (y_slab: A, h, from registers by ldmatrix) into shared memory [with
//     SAVE also out to the saved tensor], then z = sum_k A_k . y_k per frame
//     on mma.sync as a (32 x 32) . (32 x 64) product, the joints padded to
//     32 with zeros in A, z in float32 registers never live beside the
//     wgmma accumulators; z leaves through shared memory in 16-byte pieces.
//     This is block_eval.cu's spatial kernel without its lengths and its
//     second affine, in both layouts.
//   * Backward, three kernels and the ordered reductions, one op call:
//     - the t kernel (spatial_wg_t_kernel), persistent, two CTAs an SM
//       (a second wave where one fits), per tile and 64-column slab: t_k =
//       round(A_k^T . g) per frame on mma.sync, out to a bf16 scratch t
//       (K, M*V, round8(C_out)) in x's row order as each thread's pairs (t
//       is rounded by definition, so storing it changes no value); with
//       need_da, dA_k += g . y_k^T per frame on mma.sync, y_k recomputed by
//       the forward's own y_slab (the same h staging, the same W chunks in
//       the same order, so bit for bit the forward's y_k) or, with SAVE,
//       staged from the saved tensor beside g.  Warps 1-3 stage h (one or
//       two buffers) and g [and y] (one or two slab buffers) ahead; warp 0
//       streams W.  dA's sums stay in shared memory and go to the CTA's
//       partial slice once; the grid does not depend on the shared bytes,
//       so the save op's dA sums in the recompute's order.
//     - the dx kernel (spatial_wg_dx_kernel) is one GEMM over the M*V rows
//       with depth K*C_out: dh = sum_k t_k . W_k^T; each stage brings a t
//       box (128 rows by 64 channels of one partition) and the matching 64
//       rows of W_k^T by TMA, A (t) by ldmatrix from the swizzled box,
//       wgmma m64nBNk16 over the whole C_in.  Its epilogue writes dx =
//       round(dpre [* s1]) [and the tile's column sums of dpre * x and
//       dpre], and h (round(relu?(x * s1 + t1)), or x where x's rows lack
//       16-byte strides) to a scratch at a padded pitch for the dW kernel;
//       warps 1-3 stage the tile's x during the GEMM (N <= 128), and at
//       N = 64 dx and h leave through shared memory in 16-byte pieces.
//     - the dW kernel (spatial_wg_dw_kernel), dW_k = h^T . t_k, db_k = sum
//       t_k, splits the rows into whole chunks of 128; each stage brings h's
//       box (or x's) and a t box for every partition by TMA; A = h^T by
//       ldmatrix.trans, wgmma m64n64k16, each consumer warpgroup its
//       partitions; two producer warps sum t's columns for db.
//     The slices are summed in a fixed order (train_common.cuh): no
//     atomics, and the gradients repeat bit for bit.
//   Byte floor of this backward (spatial_block, need_da, bf16): g and x
//   read by the t kernel, t written once and read by dx and dW, x read and
//   dx and h written by dx, h read by dW: 2*M*V*(C_out + 3*K*C_out +
//   5*C_in) bytes, 0.22 ms a block at 3.35 TB/s at blocks 1-3 and 8-9 (747
//   MB), 0.13 ms at block 0, against the op's bound of 0.02-0.11 ms.  The t
//   scratch is 373 MB of the 747: fusing dx into the t kernel would save a
//   third of it where W^T stays resident (C <= 128) at the cost of the t
//   kernel's shared memory, the largest of the backward's.
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
// 32, K <= 4, w (K, C_in, round8(C_out)) and wT (K, C_out, round8(C_in))
// zero-padded, and the frames, rings, grids and shared bytes that
// spatial_block.py plan_spatial_mma_forward and plan_spatial_mma_backward
// give (the launchers check them against the layouts).  Each launcher
// returns cudaGetLastError() after its launches.

#include "tile_rows.cuh"
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

// ---- bf16: the warpgroup kernels (wgmma.cuh) --------------------------------
namespace spatial_wg {

using tap::bf16;
using tile_rows::halve;
using tile_rows::round_up;
constexpr int BM = 128;              // rows of a tile: 2 consumer warpgroups
constexpr int KC = wg::kBoxRows;     // W rows of a ring stage (64), or 32
constexpr int kThreads = 384;        // a producer warpgroup, 2 consumers
constexpr int kMaxResident = 8;      // stages of a resident W
constexpr int SN = 64;               // output channels of a slab
constexpr int VP = 32;               // joints, zero-padded, of A's products
constexpr int MAX_FRAMES = 6;        // frames of a tile
constexpr int MAXU = MAX_FRAMES * (SN / 16) / 8;  // units of a consumer warp
constexpr int AP = VP + tap::kPad;   // pitch of a padded adjacency
constexpr int YP = SN + tap::kPad;   // pitch of a slab buffer
// rows of a slab buffer: frame f's aggregation reads rows f*V .. f*V + 31
constexpr int YR = BM + 16;
constexpr int SLAB_BYTES = YR * YP * 2;
constexpr int DX_TILE = BM * 128;    // dx: a stage's t box, 128 rows of 64
constexpr int DW_KR = 128;           // dW: rows of a chunk
constexpr int DW_BOX = DW_KR * 128;  // dW: a box of 64 channels of a chunk
constexpr int kMaxK = 4;             // partitions (dW: two a warpgroup)
constexpr int kSmBytes = 232448;     // a CTA's most shared bytes
// the most shared bytes of a CTA that shares its SM with another: half of
// the SM's 228 KB less the 1 KB each CTA's block reserves
constexpr int kHalfSmBytes = 233472 / 2 - 1024;

// Registers by CTAs an SM: setmaxnreg moves the producer warpgroup's
// share to the consumers (one CTA: 128 * 40 + 256 * 232 = 64,512 of
// 65,536; two: 128 * 32 + 256 * 104 = 30,720, all that a CTA launched at
// 80 a thread holds).
template <int CTAS>
struct Regs {
  static constexpr int producer = CTAS == 2 ? 32 : 40;
  static constexpr int consumer = CTAS == 2 ? 104 : 232;
};

// Shared bytes (spatial_block.py mirrors each).  The forward: the alignment
// slack, the W ring (stages of kc rows by one slab) and its barriers, the
// two h buffers' barriers, b_k as float32 per column (C_out rounded up to
// a slab), s1 and t1 per input channel, the K padded adjacencies, two
// buffers of h of a tile's rows, a slab's y_k for each partition.
__host__ __device__ inline int fwd_smem_bytes(int c_in, int c_out, int k, int kc,
                                        int stages) {
  return wg::kAtomBytes + stages * (kc * 128 + 16) + 32 +
         4 * k * round_up(c_out, SN) + 8 * tap::round16(c_in) +
         2 * k * VP * AP + 2 * 2 * BM * tap::pitch_of(c_in) + k * SLAB_BYTES;
}
// The t kernel: the slack, the W ring and its barriers (stages = 0 where y_k
// is not recomputed), the h and g buffers' barriers, b_k, s1 and t1, the dA
// sums [K][2][VP][VP] in float32, the K padded adjacencies A_k^T, hbufs
// buffers of h (0 where y_k is not recomputed), gslots g slab buffers
// (with SAVE each also holds the K saved y_k slabs), and where y_k is
// recomputed (hbufs > 0) its slab.
__host__ __device__ inline int t_smem_bytes(int c_in, int c_out, int k, int kc,
                                            int stages, int hbufs, int gslots,
                                            bool save) {
  return wg::kAtomBytes + stages * (kc * 128 + 16) + 64 +
         4 * k * round_up(c_out, SN) + 8 * tap::round16(c_in) +
         4 * k * 2 * VP * VP + 2 * k * VP * AP +
         hbufs * BM * tap::pitch_of(c_in) * 2 +
         gslots * (1 + (save ? k : 0)) * SLAB_BYTES +
         (hbufs > 0 ? SLAB_BYTES : 0);
}
// The dx kernel: the slack, the ring (a stage: a t box of 128 rows by 64
// channels and bn / 64 boxes of W^T's 64 rows) and its barriers, the x
// tile's barrier, the column sums [2][8][bn] and s1, t1 [2][bn] in
// float32, and with xtile the tile's x rows at pitch_of(c_in).
__host__ __device__ inline int dx_smem_bytes(int bn, int stages, int c_in,
                                             bool xtile) {
  return wg::kAtomBytes + stages * (DX_TILE + bn * 128 + 16) + 16 +
         2 * 8 * bn * 4 + 2 * bn * 4 +
         (xtile ? BM * tap::pitch_of(c_in) * 2 : 0);
}
// The dW kernel: the slack, the ring (a stage: h's box and a t box for
// each partition, DW_KR rows by 64 channels each) and its barriers, db's
// column sums [64][8] in float32.
__host__ __device__ inline int dw_smem_bytes(int k, int stages) {
  return wg::kAtomBytes + stages * ((1 + k) * DW_BOX + 16) + 64 * 8 * 4;
}

// Offset of (joint v, frame m, channel 0) in a tensor of C channels:
// V-major (V, M, C), or frame-major (M, V, C).  With C = 1 it is the row's
// index, the row order of x, dx and the t and h scratch tensors.
__device__ __forceinline__ size_t at(int vmajor, int V, int M, int v, int m,
                                     int C) {
  return vmajor ? ((size_t)v * M + m) * C : ((size_t)m * V + v) * C;
}

struct RowArgs {
  CUtensorMap wmap;   // W (K, C_in, round8(C_out)) as (C_out, C_in, K): boxes
                      // of 64 columns by kc rows of one partition
  const bf16* x;      // x's layout, C_in channels
  const bf16* g;      // t kernel: dL/dz, z's layout
  const float* s1;    // AFF
  const float* t1;
  const bf16* b;      // (K, C_out)
  const bf16* a;      // (K, V, V)
  bf16* out;          // forward: z
  bf16* y;            // SAVE: (K, ...) in z's layout, the rounded y_k
  bf16* t;            // t kernel: (K, V*M, TP), rows in x's row order
  float* partial;     // t kernel: [cta][K*V*V], dA
  int V, M, C_in, C_out, K, frames, kc, stages, hbufs, gslots, relu1,
      vmajor, need_da, TP;
};

// Eight channels c .. c + 7 of one h row: round(relu?(x * sc + sh)), from
// x's copy in place (aligned) or from x's row.  Past C_in the scales and
// shifts are zero, so h is zero there.
__device__ __forceinline__ void h8(bf16* dst, const bf16* row, int c, int C,
                                   bool aligned, const float* sc,
                                   const float* sh, int relu1) {
  alignas(16) bf16 v[8];
  if (aligned) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(dst);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = c + q < C ? row[c + q] : __float2bfloat16_rn(0.f);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float h = tap::affine(__bfloat162float(v[q]), sc[q], sh[q]);
    v[q] = __float2bfloat16_rn(relu1 ? fmaxf(h, 0.f) : h);
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// h of a tile's BM rows (row r = f*V + v: joint v of frame m0 + f) into hs
// at pitch HP: round(relu?(x * s1 + t1)) with AFF, else x; zero past the
// tile's fc frames and past C_in (s1s and t1s, the scales and shifts staged
// in shared memory, are zero there).  Where x's rows are 16-byte aligned
// the threads copy their pieces with cp.async and, with AFF, turn them
// into h in place (each its own copies, which its wait has made visible to
// it); else plain loads.  Threads i, i + n, ...; where n is a multiple of
// the pieces a row, a thread's pieces share one column, whose eight scales
// and shifts it keeps in registers.  The forward and the t kernel both
// stage h here, so their h agree bit for bit.
template <bool AFF>
__device__ __forceinline__ void stage_h(bf16* hs, int HP, const RowArgs& p,
                                        const float* s1s, const float* t1s,
                                        int m0, int fc, int i, int n) {
  const int C = p.C_in, V = p.V;
  const int pieces = tap::round16(C) / 8;
  const bool aligned =
      C % 8 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  if (aligned) {
    for (int e = i; e < BM * pieces; e += n) {
      const int r = e / pieces;
      const int c = (e - r * pieces) * 8;
      const int f = r / V;
      const bool valid = f < fc && c < C;
      const bf16* src =
          valid ? p.x + at(p.vmajor, V, p.M, r - f * V, m0 + f, C) + c : p.x;
      tap::cp_async16(tap::smem_u32(hs + (size_t)r * HP + c), src,
                      valid ? 16 : 0);
    }
    tap::cp_async_commit();
    tap::cp_async_wait<0>();
    if constexpr (!AFF) return;
  }
  auto piece = [&](int r, int c, const float* sc, const float* sh) {
    const int f = r / V;
    bf16* dst = hs + (size_t)r * HP + c;
    if (f >= fc) {  // a row past the tile: zero (copied as zero above)
      if (!aligned) *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      return;
    }
    const bf16* row = p.x + at(p.vmajor, V, p.M, r - f * V, m0 + f, C);
    if constexpr (AFF)
      h8(dst, row, c, C, aligned, sc, sh, p.relu1);
    else
      tap::stage8<false>(dst, row, c, C, true, nullptr, nullptr, 0);
  };
  if (n % pieces == 0) {
    const int c = (i % pieces) * 8;
    float sc[8], sh[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sc[q] = AFF ? s1s[c + q] : 0.f;
      sh[q] = AFF ? t1s[c + q] : 0.f;
    }
    for (int r = i / pieces; r < BM; r += n / pieces) piece(r, c, sc, sh);
  } else {
    for (int e = i; e < BM * pieces; e += n) {
      const int r = e / pieces;
      const int c = (e - r * pieces) * 8;
      piece(r, c, s1s + c, t1s + c);
    }
  }
}

// Columns n0 .. n0 + 63 of the tile's rows of src (C channels in z's
// layout) into a slab buffer: row r = f*V + v, zero past the tile's fc
// frames, up to YR rows, and past C.  cp.async where src's rows are
// 16-byte aligned, else plain loads; threads i, i + n, ...
__device__ __forceinline__ void stage_slab(bf16* dst, const bf16* src, int C,
                                           int n0, int m0, int fc,
                                           const RowArgs& p, int i, int n) {
  const bool vec = C % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int e = i; e < YR * (SN / 8); e += n) {
    const int r = e / (SN / 8);
    const int c = (e - r * (SN / 8)) * 8;
    const int f = r / p.V;
    const bool valid = f < fc;
    const bf16* row =
        src + (valid ? at(p.vmajor, p.V, p.M, r - f * p.V, m0 + f, C) + n0
                     : 0);
    bf16* d = dst + r * YP + c;
    if (vec) {
      const bool in = valid && n0 + c < C;
      tap::cp_async16(tap::smem_u32(d), in ? row + c : src, in ? 16 : 0);
    } else {
      tap::stage8<false>(d, row, c, C - n0, valid, nullptr, nullptr, 0);
    }
  }
  if (vec) {
    tap::cp_async_commit();
    tap::cp_async_wait<0>();
  }
}

// The tile's rows (frames f < fc, joints v < V) of a slab buffer, columns
// 0 .. cols - 1, to columns n0 .. of dst (rows of C elements in x's or z's
// row order: (v, m) at at(..., C)), in 16-byte pieces where vec, else
// element by element; by the 256 consumer threads (ct = 0 .. 255).  Rows
// go out in dst's order: a V-major joint's frames are contiguous.
__device__ __forceinline__ void store_slab(bf16* dst, int C, const bf16* src,
                                           bool vec, int n0, int cols, int m0,
                                           int fc, const RowArgs& p, int ct) {
  const int V = p.V;
  const int per = vec ? (cols + 7) / 8 : cols;
  for (int e = ct; e < V * fc * per; e += 256) {
    const int vf = e / per, q = e - vf * per;
    int v, f;
    if (p.vmajor) {
      v = vf / fc;
      f = vf - v * fc;
    } else {
      f = vf / V;
      v = vf - f * V;
    }
    bf16* row = dst + at(p.vmajor, V, p.M, v, m0 + f, C) + n0;
    const bf16* s = src + (f * V + v) * YP;
    if (vec)
      *reinterpret_cast<uint4*>(row + q * 8) =
          *reinterpret_cast<const uint4*>(s + q * 8);
    else
      row[q] = s[q];
  }
}

// The K adjacencies as VP x VP tiles [k][row][col] of pitch AP, zero past
// V; TRANS stores A_k^T.
template <bool TRANS>
__device__ __forceinline__ void stage_adjacency(bf16* dst, const bf16* a,
                                                int K, int V, int i, int n) {
  for (int e = i; e < K * VP * VP; e += n) {
    const int k = e / (VP * VP);
    const int r = (e / VP) % VP, c = e % VP;
    bf16 val = __float2bfloat16_rn(0.f);
    if (r < V && c < V)
      val = TRANS ? a[((size_t)k * V + c) * V + r]
                  : a[((size_t)k * V + r) * V + c];
    dst[(k * VP + r) * AP + c] = val;
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

// The W ring of the forward and the t kernel: W_k's chunks of kc C_in rows
// by one 64-column slab, 128B-swizzled, in the order (tile,) slab,
// partition, C_in chunk; resident (each of a tile's chunks in a stage of
// its own, loaded once a CTA) where a tile's chunks fit in the stages.
struct Ring {
  uint32_t base;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int nst, nchunks, stage_bytes, kc, nkc, Kp;
  bool resident;
};

// y_k of one slab: round(h . W_k[:, n0 .. n0 + 63] + b_k) of this thread's
// rows of its warpgroup's 64 into yk (pitch YP), on wgmma m64n64k16 with A
// (h) from registers by ldmatrix at a_row and W_k's nkc chunks from the
// ring, from chunk `ch` on; each chunk's group waits for the one before it,
// whose stage it releases.  The forward and the t kernel both compute y_k
// here, on the same h and the same chunks in the same order, so their y_k
// agree bit for bit (spatial_block_save's gradients equal spatial_block's).
__device__ __forceinline__ void y_slab(bf16* yk, const float* bk,
                                       const Ring& rg, uint32_t a_row,
                                       int& ch, int lane, int rbase) {
  float acc[SN / 2];
  uint32_t fa[2][KC / 16][4];
#pragma unroll
  for (int q = 0; q < SN / 2; ++q) acc[q] = 0.f;
  int pending = -1;
  auto chunk = [&](uint32_t(&a)[KC / 16][4]) {
    const int st = rg.resident ? ch % rg.nchunks : ch % rg.nst;
    const int k0 = ch % rg.nkc * rg.kc;
    const int steps = min(rg.kc, rg.Kp - k0) / 16;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      if (kk < steps)
        tap::ldsm_x4(a[kk], a_row + (uint32_t)(k0 + kk * 16) * 2);
    wg::mbar_wait(wg::smem_u32(rg.full + st),
                  rg.resident ? 0 : (ch / rg.nst) & 1);
    const uint64_t desc =
        wg::desc_sw128(rg.base + st * rg.stage_bytes, rg.stage_bytes);
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      if (kk < steps) wg::mma_rs<SN>(acc, a[kk], wg::desc_step(desc, kk));
    wg::commit();
    wg::wait<1>();
    wg::fence_operand(acc);
    if (pending >= 0 && lane == 0 && !rg.resident)
      wg::mbar_arrive(wg::smem_u32(rg.empty + pending % rg.nst));
    pending = ch++;
  };
  for (int c = 0; c < rg.nkc; c += 2) {
    chunk(fa[0]);
    if (c + 1 < rg.nkc) chunk(fa[1]);
  }
  wg::wait<0>();
  wg::fence_operand(acc);
  if (lane == 0 && !rg.resident)
    wg::mbar_arrive(wg::smem_u32(rg.empty + pending % rg.nst));
#pragma unroll
  for (int j = 0; j < SN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(yk + (rbase + 8 * h) * YP + cl) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] + bk[cl],
                                acc[4 * j + 2 * h + 1] + bk[cl + 1]);
    }
}

// The W ring's producer: warp 0 of a CTA, chunks g = issued .. total - 1
// (g % nchunks the tile's chunk: slab ch / (nkc K), partition
// (ch / nkc) % K, C_in chunk ch % nkc), by TMA from lane 0 once the
// consumers released the stage.
__device__ __forceinline__ void w_producer(const RowArgs& p, const Ring& rg,
                                           int issued, int total, int lane) {
  if (lane != 0) return;
  for (int g = issued; g < total; ++g) {
    const int st = g % rg.nst, ch = g % rg.nchunks;
    if (g >= rg.nst)
      wg::mbar_wait(wg::smem_u32(rg.empty + st), ((g / rg.nst) & 1) ^ 1);
    const uint32_t fb = wg::smem_u32(rg.full + st);
    wg::mbar_expect_tx(fb, rg.stage_bytes);
    wg::tma_load_3d(rg.base + st * rg.stage_bytes, &p.wmap, fb,
                    ch / (rg.nkc * p.K) * SN, ch % rg.nkc * rg.kc,
                    ch / rg.nkc % p.K);
  }
}

// The first chunks of the ring, issued by thread 0 at the start.
__device__ __forceinline__ int w_prologue(const RowArgs& p, const Ring& rg,
                                          int total) {
  const int issued = min(rg.nst, total);
  for (int g = 0; g < issued; ++g) {
    const int ch = g % rg.nchunks;
    const uint32_t fb = wg::smem_u32(rg.full + g);
    wg::mbar_expect_tx(fb, rg.stage_bytes);
    wg::tma_load_3d(rg.base + g * rg.stage_bytes, &p.wmap, fb,
                    ch / (rg.nkc * p.K) * SN, ch % rg.nkc * rg.kc,
                    ch / rg.nkc % p.K);
  }
  return issued;
}

// The forward: z = sum_k A_k . y_k of the M frames, F whole frames a tile
// (the aggregation mixes joints), a persistent CTA taking tiles
// blockIdx.x, + gridDim.x, ...  Warp 0 produces the W ring; warps 1-3
// stage each tile's h a buffer ahead (full and empty mbarriers a buffer);
// warpgroups 1 and 2 compute y_k of 64 rows each for every partition of a
// slab (y_slab) [and with SAVE store them], then z per frame on mma.sync
// as a (32 x 32) . (32 x 64) product, the joints padded to 32 with zeros
// in A, in units of (frame, 16 columns), consumer warp w taking w, w + 8,
// ...; z is rounded once and leaves through shared memory in 16-byte
// pieces.  The stage-1 accumulators and z are never live together.
// Shared: ring [stages][kc][64] | full, empty [stages] | hfull, hempty [2]
//         | b [K][cp] | s1, t1 [Kp] | A [K][VP][AP] | hs [2][BM][HP] |
//         ys [K][YR][YP] (y_0's rows also take a slab's z on its way out).
template <bool AFF, bool SAVE, int CTAS>
__global__ void __launch_bounds__(kThreads, CTAS)
spatial_wg_fwd_kernel(const __grid_constant__ RowArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = wg::align_atom(smem_raw);
  const int kc = p.kc, nst = p.stages, STAGE = kc * 128;
  const int K = p.K, V = p.V, M = p.M, C_in = p.C_in, C_out = p.C_out;
  const int cp = round_up(C_out, SN);
  const int HP = tap::pitch_of(C_in);
  const int Kp = tap::round16(C_in);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * STAGE);
  uint64_t* empty = full + nst;
  uint64_t* hfull = empty + nst;
  uint64_t* hempty = hfull + 2;
  float* bs = reinterpret_cast<float*>(hempty + 2);
  float* s1s = bs + K * cp;
  float* t1s = s1s + Kp;
  bf16* as = reinterpret_cast<bf16*>(t1s + Kp);
  bf16* hs = as + K * VP * AP;
  bf16* ys = hs + 2 * BM * HP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = p.frames;
  const int ntiles = (M + F - 1) / F;
  const int my_tiles =
      (int)blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nkc = (Kp + kc - 1) / kc;
  const int nchunks = (cp / SN) * K * nkc;  // a tile's
  const bool resident = nchunks <= nst;
  const int total = resident ? nchunks : my_tiles * nchunks;
  const Ring rg{wg::smem_u32(ring), full, empty, nst, nchunks, STAGE, kc,
                nkc, Kp, resident};
  int issued = 0;  // chunks whose TMA went out before the staging
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), 8);  // the 8 consumer warps
    }
    for (int b = 0; b < 2; ++b) {
      wg::mbar_init(wg::smem_u32(hfull + b), 96);  // warps 1-3
      wg::mbar_init(wg::smem_u32(hempty + b), 8);  // the consumer warps
    }
    wg::fence_barrier_init();
    issued = w_prologue(p, rg, total);
  }
  for (int e = tid; e < K * cp; e += blockDim.x) {
    const int k = e / cp, o = e - k * cp;
    bs[e] = o < C_out ? __bfloat162float(p.b[k * C_out + o]) : 0.f;
  }
  for (int c = tid; c < Kp; c += blockDim.x) {
    s1s[c] = AFF && c < C_in ? p.s1[c] : 0.f;
    t1s[c] = AFF && c < C_in ? p.t1[c] : 0.f;
  }
  stage_adjacency<false>(as, p.a, K, V, tid, blockDim.x);
  for (int e = tid; e < K * (YR - BM) * YP; e += blockDim.x) {
    const int k = e / ((YR - BM) * YP);  // rows past the tile: zero
    ys[(k * YR + BM) * YP + e % ((YR - BM) * YP)] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  if (warp < 4) {  // ---- producers ----
    wg::setmaxnreg_dec<Regs<CTAS>::producer>();
    if (warp == 0) {
      w_producer(p, rg, issued, total, lane);
    } else {  // h of each tile, a buffer ahead
      for (int it = 0; it < my_tiles; ++it) {
        const int b = it & 1;
        if (it >= 2)
          wg::mbar_wait(wg::smem_u32(hempty + b), ((it >> 1) & 1) ^ 1);
        const int m0 = (blockIdx.x + it * gridDim.x) * F;
        stage_h<AFF>(hs + b * BM * HP, HP, p, s1s, t1s, m0, min(F, M - m0),
                     tid - 32, 96);
        wg::mbar_arrive(wg::smem_u32(hfull + b));
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, rows 64 * cw .. ----
  wg::setmaxnreg_inc<Regs<CTAS>::consumer>();
  const int cw = warp / 4 - 1, wi = warp & 3, cwarp = warp - 4;
  const int ct = tid - 128;
  const int col8 = tap::lane_col8(lane);
  const uint32_t a_lane =
      (uint32_t)(((cw * 64 + wi * 16 + tap::a_lane_row(lane)) * HP + col8) * 2);
  const int rbase = cw * 64 + wi * 16 + (lane >> 2);
  const int units = F * (SN / 16);
  // z and y leave in 16-byte pieces where their rows allow
  const bool zvec =
      C_out % 8 == 0 && (reinterpret_cast<uintptr_t>(p.out) & 15) == 0;
  const bool yvec =
      C_out % 8 == 0 && (reinterpret_cast<uintptr_t>(p.y) & 15) == 0;
  int ch = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const int b = it & 1;
    const int m0 = (blockIdx.x + it * gridDim.x) * F;
    const int fc = min(F, M - m0);
    const uint32_t a_row = wg::smem_u32(hs + b * BM * HP) + a_lane;
    wg::mbar_wait(wg::smem_u32(hfull + b), (it >> 1) & 1);
    for (int n0 = 0; n0 < cp; n0 += SN) {
      for (int k = 0; k < K; ++k)
        y_slab(ys + k * YR * YP, bs + k * cp + n0, rg, a_row, ch, lane, rbase);
      // the last slab's products have read h: the buffer is free
      if (n0 + SN >= cp && lane == 0) wg::mbar_arrive(wg::smem_u32(hempty + b));
      wg::named_sync(2, 256);  // both warpgroups' y_k of the slab are in
      const int cols = min(SN, C_out - n0);
      if constexpr (SAVE) {
        for (int k = 0; k < K; ++k)
          store_slab(p.y + (size_t)k * V * M * C_out, C_out, ys + k * YR * YP,
                     yvec, n0, cols, m0, fc, p, ct);
      }
      // z = sum_k A_k . y_k per frame: (VP x VP) . (VP x 16) a unit
      float z[MAXU][2][2][4];
#pragma unroll
      for (int i = 0; i < MAXU; ++i) tap::zero(z[i]);
      for (int k = 0; k < K; ++k) {
        const bf16* yk = ys + k * YR * YP;
        uint32_t af[2][2][4];
        adjacency_frags(af, as + k * VP * AP, lane);
#pragma unroll
        for (int i = 0; i < MAXU; ++i) {
          const int u = cwarp + 8 * i;
          if (u >= units) break;
          const int f = u / (SN / 16), cg = u % (SN / 16);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            tap::mma_k16_frag<2, 2>(
                z[i], af[kk],
                tap::smem_u32(yk + (f * V + kk * 16 + (lane & 15)) * YP +
                              cg * 16 + col8));
        }
      }
      // the slab's z, rounded once, into y_0's rows (every warp has read
      // y), then out in 16-byte pieces
      wg::named_sync(2, 256);
      bf16* zt = ys;
#pragma unroll
      for (int i = 0; i < MAXU; ++i) {
        const int u = cwarp + 8 * i;
        if (u >= units) break;
        const int f = u / (SN / 16), cg = u % (SN / 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int v = tap::acc_row(mi, 2 * h, lane);
              const int cl = cg * 16 + tap::acc_col(nj, 0, lane);
              if (v < V)
                *reinterpret_cast<__nv_bfloat162*>(zt + (f * V + v) * YP +
                                                   cl) =
                    __floats2bfloat162_rn(z[i][mi][nj][2 * h],
                                          z[i][mi][nj][2 * h + 1]);
            }
      }
      wg::named_sync(2, 256);
      store_slab(p.out, C_out, zt, zvec, n0, cols, m0, fc, p, ct);
      wg::named_sync(2, 256);  // y is read: the next slab or tile may write
    }
  }
}

// The backward's row kernel, persistent as the forward: for each tile and
// each slab of 64 output channels,
//   * t_k = round(A_k^T . g) per frame on mma.sync (units of (frame, 16
//     columns)), straight out to p.t as each thread's bf16 pairs (rounded
//     by definition, so the store changes no value).  Through shared memory
//     in 16-byte pieces it took two barriers a partition; 16-byte pieces
//     built by quad shuffles measured no faster (PERF.md);
//   * with need_da (always with SAVE), dA_k += g_f . y_k,f^T per frame: y_k
//     recomputed by y_slab from h and the W ring, as the forward computes
//     it, or, with SAVE, staged from p.y beside g.  Warp w owns the 16 x 16
//     sub-tile (w & 3) of the VP x VP output and the k16 steps of parity
//     w >> 2; its sums go to a float32 shared slice per (k, parity), each
//     element one thread's, and to p.partial once, at the end.  The grid
//     is two CTAs an SM whatever the shared bytes (a second wave where one
//     fits), so the save op's t kernel takes the tiles in the recompute's
//     order and its dA is the recompute's bit for bit.
// Warp 0 produces the W ring (recompute only); warps 1-3 stage each tile's
// h (recompute only; hbufs buffers) and each slab's g [and saved y_k] into
// gslots slab buffers, with full and empty mbarriers.  The planner takes
// the most buffers that let two CTAs share an SM, else the most that fit.
// Shared: ring | full, empty [stages] | hfull, hempty, gfull, gempty [2] |
//         b [K][cp] | s1, t1 [Kp] | sda [K][2][VP][VP] float | A^T
//         [K][VP][AP] | hs [hbufs][BM][HP] | g [gslots][1 (+K)][YR][YP] |
//         y slab [YR][YP] (recompute only).
template <bool AFF, bool SAVE, int CTAS>
__global__ void __launch_bounds__(kThreads, CTAS)
spatial_wg_t_kernel(const __grid_constant__ RowArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = wg::align_atom(smem_raw);
  const bool rec = !SAVE && p.need_da;  // y_k recomputed from h
  const int kc = p.kc, nst = rec ? p.stages : 0, STAGE = kc * 128;
  const int hb = rec ? p.hbufs : 0;
  const int hbm = hb > 0 ? hb : 1;  // divides tile indices where hb is 0
  const int gsn = p.gslots;
  const int K = p.K, V = p.V, M = p.M, C_in = p.C_in, C_out = p.C_out;
  const int cp = round_up(C_out, SN);
  const int HP = tap::pitch_of(C_in);
  const int Kp = tap::round16(C_in);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * STAGE);
  uint64_t* empty = full + nst;
  uint64_t* hfull = empty + nst;
  uint64_t* hempty = hfull + 2;
  uint64_t* gfull = hempty + 2;
  uint64_t* gempty = gfull + 2;
  float* bs = reinterpret_cast<float*>(gempty + 2);
  float* s1s = bs + K * cp;
  float* t1s = s1s + Kp;
  float* sda = t1s + Kp;
  bf16* ats = reinterpret_cast<bf16*>(sda + K * 2 * VP * VP);
  bf16* hs = ats + K * VP * AP;
  bf16* gbuf = hs + hb * BM * HP;
  const int gslot = (1 + (SAVE ? K : 0)) * YR * YP;
  bf16* ys = gbuf + gsn * gslot;  // recompute only
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = p.frames;
  const int ntiles = (M + F - 1) / F;
  const int my_tiles =
      (int)blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nslab = cp / SN;
  const int nkc = (Kp + kc - 1) / kc;
  const int nchunks = rec ? nslab * K * nkc : 1;
  const bool resident = rec && nchunks <= nst;
  const int total = !rec ? 0 : resident ? nchunks : my_tiles * nchunks;
  const Ring rg{wg::smem_u32(ring), full, empty, nst, nchunks, STAGE, kc,
                nkc, Kp, resident};
  int issued = 0;
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), 8);
    }
    for (int b = 0; b < 2; ++b) {
      wg::mbar_init(wg::smem_u32(hfull + b), 96);
      wg::mbar_init(wg::smem_u32(hempty + b), 8);
      wg::mbar_init(wg::smem_u32(gfull + b), 96);
      wg::mbar_init(wg::smem_u32(gempty + b), 8);
    }
    wg::fence_barrier_init();
    if (rec) issued = w_prologue(p, rg, total);
  }
  for (int e = tid; e < K * cp; e += blockDim.x) {
    const int k = e / cp, o = e - k * cp;
    bs[e] = o < C_out && !SAVE ? __bfloat162float(p.b[k * C_out + o]) : 0.f;
  }
  for (int c = tid; c < Kp; c += blockDim.x) {
    s1s[c] = AFF && c < C_in ? p.s1[c] : 0.f;
    t1s[c] = AFF && c < C_in ? p.t1[c] : 0.f;
  }
  for (int e = tid; e < K * 2 * VP * VP; e += blockDim.x) sda[e] = 0.f;
  stage_adjacency<true>(ats, p.a, K, V, tid, blockDim.x);
  if (rec) {
    for (int e = tid; e < (YR - BM) * YP; e += blockDim.x)
      ys[BM * YP + e] = __float2bfloat16_rn(0.f);  // rows past the tile
  }
  __syncthreads();

  if (warp < 4) {  // ---- producers ----
    wg::setmaxnreg_dec<Regs<CTAS>::producer>();
    if (warp == 0) {
      if (rec) w_producer(p, rg, issued, total, lane);
    } else {
      int gs = 0;  // slabs staged so far
      for (int it = 0; it < my_tiles; ++it) {
        const int m0 = (blockIdx.x + it * gridDim.x) * F;
        const int fc = min(F, M - m0);
        if (rec) {  // h of the tile, hbufs buffers
          const int b = it % hbm;
          if (it >= hbm)
            wg::mbar_wait(wg::smem_u32(hempty + b), ((it / hbm) & 1) ^ 1);
          stage_h<AFF>(hs + b * BM * HP, HP, p, s1s, t1s, m0, fc, tid - 32,
                       96);
          wg::mbar_arrive(wg::smem_u32(hfull + b));
        }
        for (int s = 0; s < nslab; ++s, ++gs) {
          const int slot = gs % gsn;
          if (gs >= gsn)
            wg::mbar_wait(wg::smem_u32(gempty + slot), ((gs / gsn) & 1) ^ 1);
          bf16* gsl = gbuf + slot * gslot;
          stage_slab(gsl, p.g, C_out, s * SN, m0, fc, p, tid - 32, 96);
          if constexpr (SAVE) {
            for (int k = 0; k < K; ++k)
              stage_slab(gsl + (1 + k) * YR * YP,
                         p.y + (size_t)k * V * M * C_out, C_out, s * SN, m0,
                         fc, p, tid - 32, 96);
          }
          wg::mbar_arrive(wg::smem_u32(gfull + slot));
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2 ----
  wg::setmaxnreg_inc<Regs<CTAS>::consumer>();
  const int cw = warp / 4 - 1, wi = warp & 3, cwarp = warp - 4;
  const int ct = tid - 128;
  const int col8 = tap::lane_col8(lane);
  const int sub = cwarp & 3, half = cwarp >> 2;
  const uint32_t a_lane =
      (uint32_t)(((cw * 64 + wi * 16 + tap::a_lane_row(lane)) * HP + col8) * 2);
  const int rbase = cw * 64 + wi * 16 + (lane >> 2);
  const size_t rows = (size_t)M * V;
  int ch = 0, gs = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const int m0 = (blockIdx.x + it * gridDim.x) * F;
    const int fc = min(F, M - m0);
    const int b = it % hbm;
    uint32_t a_row = 0;
    if (rec) {
      a_row = wg::smem_u32(hs + b * BM * HP) + a_lane;
      wg::mbar_wait(wg::smem_u32(hfull + b), (it / hbm) & 1);
    }
    for (int s = 0; s < nslab; ++s, ++gs) {
      const int n0 = s * SN, slot = gs % gsn;
      const int cols = min(SN, C_out - n0);
      wg::mbar_wait(wg::smem_u32(gfull + slot), (gs / gsn) & 1);
      const bf16* gsl = gbuf + slot * gslot;
      // t_k = round(A_k^T . g) of the slab, per frame
      for (int k = 0; k < K; ++k) {
        bf16* tk = p.t + (size_t)k * rows * p.TP;
        uint32_t af[2][2][4];
        adjacency_frags(af, ats + k * VP * AP, lane);
#pragma unroll
        for (int i = 0; i < MAXU; ++i) {
          const int u = cwarp + 8 * i;
          if (u >= fc * (SN / 16)) break;
          const int f = u / (SN / 16), cg = u % (SN / 16);
          float acc[2][2][4];
          tap::zero(acc);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            tap::mma_k16_frag<2, 2>(
                acc, af[kk],
                tap::smem_u32(gsl + (f * V + kk * 16 + (lane & 15)) * YP +
                              cg * 16 + col8));
          // straight out as bf16 pairs (no barrier waits on a store)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nj = 0; nj < 2; ++nj)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int wj = tap::acc_row(mi, 2 * h, lane);
                const int o = n0 + cg * 16 + tap::acc_col(nj, 0, lane);
                if (wj < V && o < p.TP)
                  *reinterpret_cast<__nv_bfloat162*>(
                      tk + at(p.vmajor, V, M, wj, m0 + f, p.TP) + o) =
                      __floats2bfloat162_rn(acc[mi][nj][2 * h],
                                            acc[mi][nj][2 * h + 1]);
              }
        }
      }
      if (SAVE || p.need_da) {
        // dA_k += g . y_k^T over the tile's frames and the slab's columns
        const int steps = (cols + 15) / 16;
        for (int k = 0; k < K; ++k) {
          const bf16* yk;
          if constexpr (SAVE) {
            yk = gsl + (1 + k) * YR * YP;
          } else {
            y_slab(ys, bs + k * cp + n0, rg, a_row, ch, lane, rbase);
            wg::named_sync(2, 256);  // both warpgroups' rows are in
            yk = ys;
          }
          float dacc[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dacc[j][e] = 0.f;
          for (int f = 0; f < fc; ++f)
            for (int kk = half; kk < steps; kk += 2)
              tap::mma_k16_nk(
                  dacc,
                  tap::smem_u32(gsl + (f * V + (sub >> 1) * 16 +
                                       tap::a_lane_row(lane)) * YP +
                                kk * 16 + col8),
                  tap::smem_u32(yk + (f * V + (sub & 1) * 16 +
                                      tap::at_lane_row(lane)) * YP +
                                kk * 16 + tap::at_lane_col(lane)));
          float* dk = sda + (size_t)(k * 2 + half) * VP * VP;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dk[((sub >> 1) * 16 + tap::acc_row(0, e, lane)) * VP +
                 (sub & 1) * 16 + tap::acc_col(j, e, lane)] += dacc[j][e];
          if constexpr (!SAVE) wg::named_sync(2, 256);  // ys is rewritten
        }
      }
      if (lane == 0) wg::mbar_arrive(wg::smem_u32(gempty + slot));
    }
    // the tile's last y_k products have read h: the buffer is free
    if (rec && lane == 0) wg::mbar_arrive(wg::smem_u32(hempty + b));
  }
  wg::named_sync(2, 256);
  float* slice = p.partial + (size_t)blockIdx.x * K * V * V;
  for (int e = ct; e < K * V * V; e += 256) {
    const int k = e / (V * V);
    const int vw = e - k * V * V;
    const int v = vw / V, wj = vw - v * V;
    const float* dk = sda + (size_t)k * 2 * VP * VP + v * VP + wj;
    slice[e] = dk[0] + dk[VP * VP];
  }
}

struct DxArgs {
  CUtensorMap tmap;   // t (K, rows, TP) as (C_out, rows, K): 64 x 128 x 1
  CUtensorMap wmap;   // W^T (K, C_out, round8(C_in)) as (C_in, C_out, K):
                      // 64 x 64 x 1
  const bf16* x;      // (rows, C_in): x in either layout
  const float* s1;    // AFF
  const float* t1;
  bf16* dx;           // (rows, C_in)
  bf16* h;            // null, or (rows, hpitch): h (AFF) or x, for dW
  float* partial;     // AFF: [tile][ds1 (C_in) | dt1 (C_in)]
  int rows, C_in, C_out, K, stages, relu1, hpitch, xtile;
};

// Registers of the dx kernel by N tile, as temporal_block.cu's GEMM: two
// CTAs an SM at N = 64, else one.
template <int BN>
struct DxRegs {
  static constexpr int ctas = BN == 64 ? 2 : 1;
  static constexpr int producer = BN == 64 ? 24 : 40;
  static constexpr int consumer = BN == 64 ? 104 : 232;
};

// dh = sum_k t_k . W_k^T as one GEMM over the V*M rows (x's row order) with
// depth K * C_out: a CTA owns BM = 128 rows and the whole C_in (BN of it,
// the rest zero); warpgroup 0's thread 0 streams the chunks (a t box of
// the tile's rows by 64 channels of one partition, and the matching 64 rows
// of W_k^T) by TMA through a ring of 2-4 stages; warpgroups 1 and 2 each
// compute 64 rows with wgmma m64nBNk16, A (t) by ldmatrix from the
// swizzled box.  Epilogue: dpre = dh [through the ReLU mask], dx =
// round(dpre [* s1]); with AFF the column sums of dpre * x and dpre over
// the tile's rows go to its slice of p.partial; with p.h the rows' h
// (round(relu?(x * s1 + t1)), or x) go to p.h for the dW kernel, both
// through the ring's bytes in 16-byte pieces at N = 64.  Where
// the epilogue reads x (AFF, or p.h) and p.xtile, warps 1-3 stage the
// tile's x rows into shared memory while the consumers run the GEMM, so
// the epilogue finds them there (loaded after the GEMM, their latency
// showed in every tile).
// Shared: ring [stages][t box | W^T boxes] | full, empty [stages] | xfull |
//         column sums [2][8][BN] | s1, t1 [2][BN] | x [BM][pitch(C_in)].
template <bool AFF, int BN>
__global__ void __launch_bounds__(kThreads, DxRegs<BN>::ctas)
spatial_wg_dx_kernel(const __grid_constant__ DxArgs p) {
  constexpr int NB = BN / wg::kBoxCols;
  constexpr int STAGE = DX_TILE + NB * 64 * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = wg::align_atom(smem_raw);
  const int nst = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * STAGE);
  uint64_t* empty = full + nst;
  uint64_t* xfull = empty + nst;
  float* red = reinterpret_cast<float*>(xfull + 2);
  float* cvec = red + 2 * 8 * BN;
  bf16* xs = reinterpret_cast<bf16*>(cvec + 2 * BN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BM;
  const int C_in = p.C_in;
  const int XP = tap::pitch_of(C_in);
  const bool need_x = AFF || p.h != nullptr;
  // no x tile fits beside a ring of three stages at N = 256 (the planner
  // never asks): that instantiation keeps the plain loads alone
  const bool xtile = BN <= 128 && need_x && p.xtile;
  const int nco = (p.C_out + SN - 1) / SN;
  const int nchunks = p.K * nco;
  const uint32_t ring_u = wg::smem_u32(ring);
  // chunk ch: channels (ch % nco) * 64 .. of partition ch / nco
  auto tma_chunk = [&](int ch) {
    const int st = ch % nst, k = ch / nco, o0 = (ch - k * nco) * SN;
    const uint32_t fb = wg::smem_u32(full + st);
    const uint32_t s = ring_u + st * STAGE;
    wg::mbar_expect_tx(fb, STAGE);
    wg::tma_load_3d(s, &p.tmap, fb, o0, r0, k);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      wg::tma_load_3d(s + DX_TILE + j * 64 * 128, &p.wmap, fb,
                      j * wg::kBoxCols, o0, k);
  };
  int issued = 0;
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), 8);  // the 8 consumer warps
    }
    wg::mbar_init(wg::smem_u32(xfull), 96);         // warps 1-3
    wg::fence_barrier_init();
    issued = min(nst, nchunks);
    for (int ch = 0; ch < issued; ++ch) tma_chunk(ch);
  }
  for (int t = tid; t < BN; t += blockDim.x) {
    cvec[t] = AFF && t < C_in ? p.s1[t] : 0.f;
    cvec[BN + t] = AFF && t < C_in ? p.t1[t] : 0.f;
  }
  __syncthreads();

  if (warp < 4) {  // ---- producers: the ring; the x tile ----
    wg::setmaxnreg_dec<DxRegs<BN>::producer>();
    if (tid == 0) {
      for (int ch = issued; ch < nchunks; ++ch) {
        const int st = ch % nst;
        wg::mbar_wait(wg::smem_u32(empty + st), ((ch / nst) & 1) ^ 1);
        tma_chunk(ch);
      }
    } else if (warp >= 1 && xtile) {
      // rows r0 .. r0 + 127 of x, zero past the end and past C_in
      const int pieces = tap::round16(C_in) / 8;
      const bool vec =
          C_in % 8 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
      for (int e = tid - 32; e < BM * pieces; e += 96) {
        const int r = e / pieces;
        const int c = (e - r * pieces) * 8;
        const bool valid = r0 + r < p.rows;
        const bf16* row = p.x + (valid ? (size_t)(r0 + r) * C_in : 0);
        bf16* d = xs + r * XP + c;
        if (vec) {
          const bool in = valid && c < C_in;
          tap::cp_async16(tap::smem_u32(d), in ? row + c : p.x, in ? 16 : 0);
        } else {
          tap::stage8<false>(d, row, c, C_in, valid, nullptr, nullptr, 0);
        }
      }
      tap::cp_async_commit();
      tap::cp_async_wait<0>();
      wg::mbar_arrive(wg::smem_u32(xfull));
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, rows 64 * cw .. ----
  wg::setmaxnreg_inc<DxRegs<BN>::consumer>();
  const int cw = warp / 4 - 1, wi = warp & 3;
  const int arow = cw * 64 + wi * 16 + (lane & 15);
  float acc[BN / 2];
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
  uint32_t fa[2][4][4];
  // One chunk: its A fragments by ldmatrix from the landed t box, its four
  // k16 steps as one wgmma group; the group before it is waited for, and
  // its stage released.
  auto chunk = [&](int ch, uint32_t(&a)[4][4]) {
    const int st = ch % nst;
    const uint32_t s = ring_u + st * STAGE;
    wg::mbar_wait(wg::smem_u32(full + st), (ch / nst) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tap::ldsm_x4(a[kk], s + wg::sw128(arow, kk * 2 + (lane >> 4)));
    const uint64_t desc = wg::desc_sw128(s + DX_TILE, 64 * 128);
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs<BN>(acc, a[kk], wg::desc_step(desc, kk));
    wg::commit();
    wg::wait<1>();
    wg::fence_operand(acc);
    if (ch > 0 && lane == 0)
      wg::mbar_arrive(wg::smem_u32(empty + (ch - 1) % nst));
  };
  for (int ch = 0; ch < nchunks; ch += 2) {
    chunk(ch, fa[0]);
    if (ch + 1 < nchunks) chunk(ch + 1, fa[1]);
  }
  wg::wait<0>();
  wg::fence_operand(acc);

  // Epilogue: this thread's rows rbase and rbase + 8 of the tile, columns
  // 8 jn + 2 (lane & 3) + q; -1 marks a row past the end.
  const int rbase = cw * 64 + wi * 16 + (lane >> 2);
  long long base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + rbase + 8 * h;
    base[h] = r < p.rows ? (long long)r : -1;
  }
  const int col0 = 2 * (lane & 3);
  const bool even = C_in % 2 == 0;
  if (xtile) wg::mbar_wait(wg::smem_u32(xfull), 0);
  // At N = 64, dx and h leave through the ring's bytes (free once both
  // warpgroups are past the GEMM) in 16-byte pieces of whole rows, where
  // rows allow: each thread's scattered bf16 pairs took a third more.  At
  // N = 128 and 256 the pairs measured faster (PERF.md).
  const int OP = tap::pitch_of(C_in);
  bf16* dtile = reinterpret_cast<bf16*>(ring);
  bf16* htile = dtile + BM * OP;
  const bool tiled =
      BN == 64 && C_in % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(p.dx) & 15) == 0 &&
      nst * STAGE >= (p.h != nullptr ? 2 : 1) * BM * OP * 2;
  if (tiled) wg::named_sync(2, 256);
  // Groups of eight n8 blocks (64 columns): a group's x values are loaded
  // first, all at once (read-only, so none waits on the stores before it);
  // with AFF the column sums of dpre * x and dpre over the group: the
  // thread's two rows, then the warp's eight row groups (lane bits 4, 3, 2)
  // by halving exchanges, after which lane group lane >> 2 holds block
  // 8 jg + (lane >> 2)'s sums.
#pragma unroll
  for (int jg = 0; jg < BN / 64; ++jg) {
    float part[32];
    float2 xg[8][2];
#pragma unroll
    for (int jl = 0; jl < 8; ++jl) {
      const int o = col0 + (jg * 8 + jl) * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xg[jl][h] = make_float2(0.f, 0.f);
        if (!need_x || base[h] < 0) continue;
        if (xtile) {  // staged: zero past C_in
          if (o < C_in)
            xg[jl][h] = __bfloat1622float2(*reinterpret_cast<
                const __nv_bfloat162*>(xs + (rbase + 8 * h) * XP + o));
          continue;
        }
        const bf16* xr = p.x + base[h] * C_in + o;
        if (o + 1 < C_in && even) {
          xg[jl][h] = __bfloat1622float2(
              __ldg(reinterpret_cast<const __nv_bfloat162*>(xr)));
        } else if (o < C_in) {
          xg[jl][h].x = __bfloat162float(__ldg(xr));
        }
      }
    }
#pragma unroll
    for (int jl = 0; jl < 8; ++jl) {
      const int jn = jg * 8 + jl;
      const int o = col0 + jn * 8;
      const bool pair = o + 1 < C_in && even;
      float cs[2] = {0.f, 0.f}, ctt[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (base[h] < 0) continue;
        float v[2] = {acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]};
        float hv[2] = {xg[jl][h].x, xg[jl][h].y};
        if constexpr (AFF) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float sc = cvec[o + q];
            const float pre = tap::affine(hv[q], sc, cvec[BN + o + q]);
            const float dp = (p.relu1 && !(pre > 0.f)) ? 0.f : v[q];
            cs[q] += dp * hv[q];
            ctt[q] += dp;
            v[q] = dp * sc;
            hv[q] = p.relu1 ? fmaxf(pre, 0.f) : pre;
          }
        }
        if (tiled) {  // C_in % 8 == 0: o < C_in holds a whole pair
          if (o < C_in) {
            const int at = (rbase + 8 * h) * OP + o;
            *reinterpret_cast<__nv_bfloat162*>(dtile + at) =
                __floats2bfloat162_rn(v[0], v[1]);
            if (p.h != nullptr)
              *reinterpret_cast<__nv_bfloat162*>(htile + at) =
                  __floats2bfloat162_rn(hv[0], hv[1]);
          }
          continue;
        }
        if (p.h != nullptr)
          tile_rows::store2(p.h + base[h] * p.hpitch + o, hv, o, C_in, pair);
        tile_rows::store2(p.dx + base[h] * C_in + o, v, o, C_in, pair);
      }
      part[4 * jl] = cs[0];
      part[4 * jl + 1] = cs[1];
      part[4 * jl + 2] = ctt[0];
      part[4 * jl + 3] = ctt[1];
    }
    if constexpr (AFF) {
      halve<16, 4>(part, lane);
      halve<8, 3>(part, lane);
      halve<4, 2>(part, lane);
      const int col = (jg * 8 + (lane >> 2)) * 8 + 2 * (lane & 3);
      red[(cw * 4 + wi) * BN + col] = part[0];
      red[(cw * 4 + wi) * BN + col + 1] = part[1];
      red[(8 + cw * 4 + wi) * BN + col] = part[2];
      red[(8 + cw * 4 + wi) * BN + col + 1] = part[3];
    }
  }
  if (AFF || tiled) wg::named_sync(2, 256);
  if (tiled) {  // the tile's rows out, whole 16-byte pieces
    const int pieces = C_in / 8;
    const int nrows = min(BM, p.rows - r0);
    for (int e = tid - 128; e < nrows * pieces; e += 256) {
      const int r = e / pieces;
      const int c = (e - r * pieces) * 8;
      *reinterpret_cast<uint4*>(p.dx + (size_t)(r0 + r) * C_in + c) =
          *reinterpret_cast<const uint4*>(dtile + r * OP + c);
      if (p.h != nullptr)
        *reinterpret_cast<uint4*>(p.h + (size_t)(r0 + r) * p.hpitch + c) =
            *reinterpret_cast<const uint4*>(htile + r * OP + c);
    }
  }
  if constexpr (AFF) {  // then the eight warps in order
    float* slice = p.partial + (size_t)blockIdx.x * 2 * C_in;
    for (int t = tid - 128; t < BN; t += 256) {
      if (t >= C_in) continue;
      float a = 0.f, b = 0.f;
      for (int w = 0; w < 8; ++w) {
        a += red[w * BN + t];
        b += red[(8 + w) * BN + t];
      }
      slice[t] = a;
      slice[C_in + t] = b;
    }
  }
}

struct DwArgs {
  CUtensorMap hmap;   // h (rows, hpitch), or x, as (C_in, rows, 1):
                      // 64 x DW_KR x 1
  CUtensorMap tmap;   // t (K, rows, TP) as (C_out, rows, K): 64 x DW_KR x 1
  float* partial;     // [split][K*C_in*C_out (dW) | K*C_out (db)]
  int rows, C_in, C_out, K, split_rows, stages;
};

// dW_k[c, o] = sum over the rows r of h[r][c] * t_k[r][o]: a CTA owns 64
// input channels, 64 output channels, every partition and one split of the
// rows.  Warpgroup 0's thread 0 brings each chunk of DW_KR rows by TMA into
// a ring of 2-4 stages, h's box and a t box for each partition; its warps 2
// and 3 sum t_k's columns from the stages (db_k) in the CTAs of the first
// input-channel tile.  Consumer warpgroup cw computes partitions cw, cw +
// 2, ... (KPW of them): A = h^T by ldmatrix.trans from the swizzled box,
// m64n64k16; a partition past K re-reads the first and is not stored (a
// branch around the wgmma would make ptxas serialize them).  Splits are
// whole chunks, so a box never reaches into the next split's rows; rows
// past the end are TMA's zero fill.
template <int KPW>
__global__ void __launch_bounds__(kThreads, 1)
spatial_wg_dw_kernel(const __grid_constant__ DwArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = wg::align_atom(smem_raw);
  const int K = p.K, nst = p.stages;
  const int STAGE = (1 + K) * DW_BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + nst * STAGE);
  uint64_t* empty = full + nst;
  float* red = reinterpret_cast<float*>(empty + nst);  // [64][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * 64, n0 = blockIdx.y * SN;
  const int k_begin = blockIdx.z * p.split_rows;
  const int k_end = min(p.rows, k_begin + p.split_rows);
  const int nchunks = (k_end - k_begin + DW_KR - 1) / DW_KR;
  const bool do_db = c0 == 0;
  const size_t E = (size_t)K * p.C_in * p.C_out + (size_t)K * p.C_out;
  float* slice = p.partial + (size_t)blockIdx.z * E;
  const uint32_t st_u = wg::smem_u32(stages);
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      // the consumer warps, and the two db warps where they sum
      wg::mbar_init(wg::smem_u32(empty + i), 8 + (do_db ? 2 : 0));
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup ----
    if (tid == 0) {
      for (int ch = 0; ch < nchunks; ++ch) {
        const int st = ch % nst;
        if (ch >= nst)
          wg::mbar_wait(wg::smem_u32(empty + st), ((ch / nst) & 1) ^ 1);
        const uint32_t fb = wg::smem_u32(full + st);
        const uint32_t s = st_u + st * STAGE;
        const int r = k_begin + ch * DW_KR;
        wg::mbar_expect_tx(fb, STAGE);
        wg::tma_load_3d(s, &p.hmap, fb, c0, r, 0);
        for (int k = 0; k < K; ++k)
          wg::tma_load_3d(s + (1 + k) * DW_BOX, &p.tmap, fb, n0, r, k);
      }
    } else if (warp >= 2 && do_db) {
      // db_k: thread i sums 16-byte chunk i % 8 of rows i / 8, + 8, ... of
      // each t box, then the eight threads of a chunk column in order
      const int i = tid - 64;
      float sb[kMaxK][8];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
#pragma unroll
        for (int q = 0; q < 8; ++q) sb[k][q] = 0.f;
      for (int ch = 0; ch < nchunks; ++ch) {
        const int st = ch % nst;
        wg::mbar_wait(wg::smem_u32(full + st), (ch / nst) & 1);
        const unsigned char* s = stages + st * STAGE;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (k >= K) break;
          for (int e = i; e < DW_KR * 8; e += 64) {
            alignas(16) bf16 v[8];
            *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(
                s + (1 + k) * DW_BOX + wg::sw128(e / 8, e % 8));
#pragma unroll
            for (int q = 0; q < 8; ++q) sb[k][q] += __bfloat162float(v[q]);
          }
        }
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(wg::smem_u32(empty + st));
      }
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= K) break;
#pragma unroll
        for (int q = 0; q < 8; ++q) red[i * 8 + q] = sb[k][q];
        wg::named_sync(1, 64);
        const int c8 = i / 8, q = i % 8;
        if (n0 + i < p.C_out) {
          float a = 0.f;
          for (int t = c8; t < 64; t += 8) a += red[t * 8 + q];
          slice[(size_t)K * p.C_in * p.C_out + (size_t)k * p.C_out + n0 + i] =
              a;
        }
        wg::named_sync(1, 64);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw takes partitions cw, cw + 2, ... ----
  const int cw = warp / 4 - 1, wi = warp & 3;
  float acc[KPW][SN / 2];
  bool mine[KPW];
  int kmat[KPW];
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
#pragma unroll
    for (int q = 0; q < SN / 2; ++q) acc[i][q] = 0.f;
    mine[i] = cw + 2 * i < K;
    kmat[i] = mine[i] ? cw + 2 * i : 0;
  }
  uint32_t fa[2][4];
  const int krow = tap::at_lane_row(lane);
  // this lane's 16-byte chunk of an h row: channels wi * 16 + 0 or 8
  const int zc = wi * 2 + (tap::at_lane_col(lane) >> 3);
  for (int ch = 0; ch < nchunks; ++ch) {
    const int st = ch % nst;
    const uint32_t s = st_u + st * STAGE;
    wg::mbar_wait(wg::smem_u32(full + st), (ch / nst) & 1);
#pragma unroll
    for (int kk = 0; kk < DW_KR / 16; ++kk) {
      tap::ldsm_x4_t(fa[kk & 1], s + wg::sw128(kk * 16 + krow, zc));
#pragma unroll
      for (int i = 0; i < KPW; ++i) wg::fence_operand(acc[i]);
      wg::fence();
#pragma unroll
      for (int i = 0; i < KPW; ++i)
        wg::mma_rs<SN>(acc[i], fa[kk & 1],
                       wg::desc_step(wg::desc_sw128(s + (1 + kmat[i]) * DW_BOX,
                                                    DW_BOX),
                                     kk));
      wg::commit();
      wg::wait<1>();
    }
    wg::wait<0>();
#pragma unroll
    for (int i = 0; i < KPW; ++i) wg::fence_operand(acc[i]);
    if (lane == 0) wg::mbar_arrive(wg::smem_u32(empty + st));
  }

#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    if (!mine[i]) continue;
#pragma unroll
    for (int jn = 0; jn < SN / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wi * 16 + (lane >> 2) + 8 * h;
        const int o = n0 + jn * 8 + 2 * (lane & 3);
        if (c >= p.C_in) continue;
        float* dst = slice + ((size_t)kmat[i] * p.C_in + c) * p.C_out + o;
        const float v0 = acc[i][4 * jn + 2 * h];
        const float v1 = acc[i][4 * jn + 2 * h + 1];
        if (o + 1 < p.C_out && p.C_out % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (o < p.C_out) dst[0] = v0;
          if (o + 1 < p.C_out) dst[1] = v1;
        }
      }
  }
}

template <typename Kern>
cudaError_t prepare(Kern kernel, int smem_bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The TMA map of a bf16 tensor (mats, rows, cols) at `pitch` elements a
// row (a multiple of 8: 16-byte strides), read in boxes of 64 columns by
// box_rows rows of one matrix, 128B-swizzled, zero outside (cols, rows,
// mats): the padding columns past cols are never read.
inline bool rows_map(CUtensorMap* map, const void* base, int mats, int rows,
                     int cols, int pitch, int box_rows) {
  if (pitch % 8 != 0 || (reinterpret_cast<uintptr_t>(base) & 15) != 0 ||
      wg::encode_tiled() == nullptr)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 2,
                                 (cuuint64_t)rows * pitch * 2};
  const cuuint32_t box[3] = {wg::kBoxCols, (cuuint32_t)box_rows, 1};
  return wg::encode_map(map, base, 3, dims, strides, box);
}

template <bool AFF, bool SAVE>
cudaError_t forward(const RowArgs& p, int ctas_sm, int smem,
                    cudaStream_t st) {
  auto kernel = ctas_sm == 2 ? spatial_wg_fwd_kernel<AFF, SAVE, 2>
                             : spatial_wg_fwd_kernel<AFF, SAVE, 1>;
  cudaError_t err = prepare(kernel, smem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = (p.M + p.frames - 1) / p.frames;
  kernel<<<min(tiles, ctas_sm * sms), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool AFF, int BN>
cudaError_t dx_bn(const DxArgs& a, int smem, cudaStream_t st) {
  auto kernel = spatial_wg_dx_kernel<AFF, BN>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.rows + BM - 1) / BM, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool AFF>
cudaError_t dx(const DxArgs& a, int bn, int smem, cudaStream_t st) {
  if (bn == 64) return dx_bn<AFF, 64>(a, smem, st);
  if (bn == 128) return dx_bn<AFF, 128>(a, smem, st);
  return dx_bn<AFF, 256>(a, smem, st);
}

// Launch parameters of one backward (spatial_block.py
// plan_spatial_mma_backward).
struct BwdPlan {
  int t_ctas, t_smem, dx_bn, dx_smem, dw_splits, dw_smem;
};

// The t kernel, the dx kernel, the dW kernel, then the passes that sum
// their slices in order into grads = [dW | db | dA (| ds1 | dt1)].
template <bool AFF, bool SAVE>
cudaError_t backward(const RowArgs& rp, DxArgs& xa, const DwArgs& wa,
                     const BwdPlan& b, float* partial_da, float* grads,
                     cudaStream_t st) {
  const int ctas_sm = b.t_smem <= kHalfSmBytes ? 2 : 1;
  auto tk = ctas_sm == 2 ? spatial_wg_t_kernel<AFF, SAVE, 2>
                         : spatial_wg_t_kernel<AFF, SAVE, 1>;
  cudaError_t err = prepare(tk, b.t_smem);
  if (err != cudaSuccess) return err;
  tk<<<b.t_ctas, kThreads, b.t_smem, st>>>(rp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = dx<AFF>(xa, b.dx_bn, b.dx_smem, st)) != cudaSuccess) return err;

  const int kpw = (wa.K + 1) / 2;
  auto dwk = kpw == 1 ? spatial_wg_dw_kernel<1> : spatial_wg_dw_kernel<2>;
  if ((err = prepare(dwk, b.dw_smem)) != cudaSuccess) return err;
  dwk<<<dim3((wa.C_in + 63) / 64, (wa.C_out + SN - 1) / SN, b.dw_splits),
        kThreads, b.dw_smem, st>>>(wa);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long e_dw = (long long)wa.K * wa.C_in * wa.C_out +
                         (long long)wa.K * wa.C_out;
  const long long e_da = (long long)rp.K * rp.V * rp.V;
  err = train::launch_reduce(wa.partial, grads, b.dw_splits, e_dw, st);
  if (err != cudaSuccess) return err;
  err = train::launch_reduce(partial_da, grads + e_dw, b.t_ctas, e_da, st);
  if (err != cudaSuccess || !AFF) return err;
  return train::launch_reduce_columns(xa.partial, grads + e_dw + e_da,
                                      (xa.rows + BM - 1) / BM, 2 * xa.C_in,
                                      st);
}

// A tile's shape holds for the kernels' fixed tiles: V <= VP joints, F <=
// MAX_FRAMES frames of them in BM rows, every frame's VP-row window inside
// the YR rows of a slab buffer; K <= kMaxK; rows fit in an int.
bool bad_dims(int V, int M, int C_in, int C_out, int K, int frames) {
  return V < 1 || V > VP || M < 1 || C_in < 1 || C_out < 1 || K < 1 ||
         K > kMaxK || frames < 1 || frames > MAX_FRAMES || frames * V > BM ||
         (frames - 1) * V + VP > YR ||
         (long long)M * V * (C_in > C_out ? C_in : C_out) >= (1LL << 31);
}

// A W ring of 32 or 64 rows a stage, 2 to kMaxResident stages.
inline bool bad_ring(int kc, int stages) {
  return (kc != 32 && kc != 64) || stages < 2 || stages > kMaxResident;
}

}  // namespace spatial_wg

// ---- C interface -----------------------------------------------------------
// The float32 launchers run the scalar kernels (bf16 runs the warpgroup
// launchers at the end of this file).
extern "C" int spatial_block_fwd_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, void* out, int V, int M, int C_in,
    int C_out, int K, int frames, int relu1, int smem_bytes, void* stream) {
  if (frames < 1 || M < 1) return (int)cudaErrorInvalidValue;
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
    int frames, int ctas, int relu1, int need_da, int smem_bytes,
    void* stream) {
  if (bad_bwd_args(M, frames, ctas)) return (int)cudaErrorInvalidValue;
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
    int C_out, int K, int frames, int relu1, int smem_bytes, void* stream) {
  if (frames < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, relu1, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_fwd<float, true, true>(x, s1, t1, w, b, a, out, d,
      smem_bytes, s, y);
}

extern "C" int spatial_block_save_bwd_launch(
    const void* x, const void* g, const void* y, const void* s1,
    const void* t1, const void* w, const void* wT, const void* a, void* dx,
    void* partial, void* grads, int V, int M, int C_in, int C_out, int K,
    int frames, int ctas, int relu1, int smem_bytes, void* stream) {
  if (bad_bwd_args(M, frames, ctas)) return (int)cudaErrorInvalidValue;
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
    int smem_bytes, void* stream) {
  if (frames < 1 || M < 1) return (int)cudaErrorInvalidValue;
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
    int vmajor, int need_da, int smem_bytes, void* stream) {
  if (bad_bwd_args(M, frames, ctas)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, M, C_in, C_out, K, frames, 0, vmajor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_bwd<float, false>(x, g, nullptr, nullptr, w, wT, b, a, dx,
      partial, grads, ctas, need_da, d, smem_bytes, s);
}

// The bf16 launchers run the warpgroup kernels for every op on this
// source: aff = 1 is spatial_block (V-major x, the affine and ReLU), with
// save = 1 spatial_block_save; aff = 0 spatial_conv (vmajor picks the
// layout; s1, t1 unused).  w is (K, C_in, round8(C_out)), zero past C_out;
// frames, kc, stages and smem are spatial_block.py
// plan_spatial_mma_forward's; y is the saved (K, ...) expansion (save
// only).
extern "C" int spatial_mma_fwd_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, void* out, void* y, int V, int M, int C_in,
    int C_out, int K, int frames, int aff, int save, int relu1, int vmajor,
    int kc, int stages, int smem, void* stream) {
  using namespace spatial_wg;
  if (bad_dims(V, M, C_in, C_out, K, frames) || (save && !aff) ||
      bad_ring(kc, stages) || smem < fwd_smem_bytes(C_in, C_out, K, kc, stages) ||
      smem > kSmBytes)
    return (int)cudaErrorInvalidValue;
  RowArgs p{};
  if (!rows_map(&p.wmap, w, K, C_in, C_out, round_up(C_out, 8), kc))
    return (int)cudaErrorInvalidValue;
  p.x = static_cast<const bf16*>(x);
  p.s1 = static_cast<const float*>(s1);
  p.t1 = static_cast<const float*>(t1);
  p.b = static_cast<const bf16*>(b);
  p.a = static_cast<const bf16*>(a);
  p.out = static_cast<bf16*>(out);
  p.y = static_cast<bf16*>(y);
  p.V = V;
  p.M = M;
  p.C_in = C_in;
  p.C_out = C_out;
  p.K = K;
  p.frames = frames;
  p.kc = kc;
  p.stages = stages;
  p.relu1 = relu1;
  p.vmajor = vmajor;
  const int ctas_sm = smem <= kHalfSmBytes ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (save)
    err = forward<true, true>(p, ctas_sm, smem, s);
  else if (aff)
    err = forward<true, false>(p, ctas_sm, smem, s);
  else
    err = forward<false, false>(p, ctas_sm, smem, s);
  return (int)err;
}

// One op call's backward: the t kernel (t_ctas persistent CTAs, a W ring
// of t_stages stages of t_kc rows and t_hbufs h buffers where y_k is
// recomputed, t_gslots g slab buffers; t the (K, M*V, round8(C_out)) bf16
// scratch in x's row order, partial_da its [t_ctas][K*V*V] slices), the dx
// kernel (an N tile of
// dx_bn, a ring of dx_stages, the tile's x staged in shared memory where
// dx_xtile; partial_dx [ceil(M*V / 128)][2*C_in], aff
// only; h the (M*V, round8(C_in)) scratch it fills for the dW kernel, or
// null where the dW kernel reads x: no affine and 16-byte rows), the dW
// kernel (dw_splits slices of dw_split_rows rows, a multiple of 128, in
// partial_dw, each [K*C_in*C_out | K*C_out]; a ring of dw_stages) and the
// passes that sum the slices in order into grads = [dW | db | dA
// (| ds1 | dt1)].  wT is (K, C_out, round8(C_in)), zero past C_in.
// need_da = 0 (without save) skips dA, which is then 0.
extern "C" int spatial_mma_bwd_launch(
    const void* x, const void* g, const void* s1, const void* t1,
    const void* w, const void* wT, const void* b, const void* a,
    const void* y, void* dx, void* t, void* h, void* partial_da,
    void* partial_dx, void* partial_dw, void* grads, int V, int M, int C_in,
    int C_out, int K, int frames, int aff, int save, int relu1, int vmajor,
    int need_da, int t_ctas, int t_kc, int t_stages, int t_hbufs,
    int t_gslots, int t_smem,
    int dx_bn, int dx_stages, int dx_xtile, int dx_smem, int dw_stages,
    int dw_splits,
    int dw_split_rows, int dw_smem, void* stream) {
  using namespace spatial_wg;
  const long long rows = (long long)M * V;
  const bool rec = need_da && !save;
  const int tiles = frames > 0 ? (M + frames - 1) / frames : 0;
  const bool x_rows = !aff && C_in % 8 == 0 &&
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (bad_dims(V, M, C_in, C_out, K, frames) || (save && !aff) ||
      (t_kc != 32 && t_kc != 64) ||
      (rec && (bad_ring(t_kc, t_stages) || t_hbufs < 1 || t_hbufs > 2)) ||
      t_gslots < 1 || t_gslots > 2 ||
      t_smem < t_smem_bytes(C_in, C_out, K, t_kc, rec ? t_stages : 0,
                            rec ? t_hbufs : 0, t_gslots, save) ||
      t_smem > kSmBytes || t_ctas < 1 || t_ctas > tiles ||
      (dx_bn != 64 && dx_bn != 128 && dx_bn != 256) || C_in > dx_bn ||
      dx_stages < 2 || dx_stages > 4 ||
      dx_smem < dx_smem_bytes(dx_bn, dx_stages, C_in, dx_xtile != 0) ||
      dx_smem > kSmBytes || dw_stages < 2 || dw_stages > 4 ||
      dw_smem < dw_smem_bytes(K, dw_stages) || dw_smem > kSmBytes ||
      dw_splits < 1 || dw_split_rows < 1 || dw_split_rows % DW_KR != 0 ||
      (long long)dw_splits * dw_split_rows < rows ||
      (long long)(dw_splits - 1) * dw_split_rows >= rows ||
      (h == nullptr && !x_rows))
    return (int)cudaErrorInvalidValue;
  const int TP = round_up(C_out, 8), HP = round_up(C_in, 8);
  RowArgs rp{};
  DxArgs xa{};
  DwArgs wa{};
  if (!rows_map(&rp.wmap, w, K, C_in, C_out, TP, t_kc) ||
      !rows_map(&xa.tmap, t, K, (int)rows, C_out, TP, BM) ||
      !rows_map(&xa.wmap, wT, K, C_out, C_in, HP, wg::kBoxRows) ||
      !rows_map(&wa.hmap, h != nullptr ? h : x, 1, (int)rows, C_in,
                h != nullptr ? HP : C_in, DW_KR))
    return (int)cudaErrorInvalidValue;
  wa.tmap = xa.tmap;  // the same boxes: 64 channels by 128 rows
  rp.x = static_cast<const bf16*>(x);
  rp.g = static_cast<const bf16*>(g);
  rp.s1 = static_cast<const float*>(s1);
  rp.t1 = static_cast<const float*>(t1);
  rp.b = static_cast<const bf16*>(b);
  rp.a = static_cast<const bf16*>(a);
  rp.y = const_cast<bf16*>(static_cast<const bf16*>(y));
  rp.t = static_cast<bf16*>(t);
  rp.partial = static_cast<float*>(partial_da);
  rp.V = V;
  rp.M = M;
  rp.C_in = C_in;
  rp.C_out = C_out;
  rp.K = K;
  rp.frames = frames;
  rp.kc = t_kc;
  rp.stages = t_stages;
  rp.hbufs = t_hbufs;
  rp.gslots = t_gslots;
  rp.relu1 = relu1;
  rp.vmajor = vmajor;
  rp.need_da = need_da;
  rp.TP = TP;
  xa.x = rp.x;
  xa.s1 = rp.s1;
  xa.t1 = rp.t1;
  xa.dx = static_cast<bf16*>(dx);
  xa.h = static_cast<bf16*>(h);
  xa.partial = static_cast<float*>(partial_dx);
  xa.rows = (int)rows;
  xa.C_in = C_in;
  xa.C_out = C_out;
  xa.K = K;
  xa.stages = dx_stages;
  xa.relu1 = relu1;
  xa.hpitch = HP;
  xa.xtile = dx_xtile;
  wa.partial = static_cast<float*>(partial_dw);
  wa.rows = (int)rows;
  wa.C_in = C_in;
  wa.C_out = C_out;
  wa.K = K;
  wa.split_rows = dw_split_rows;
  wa.stages = dw_stages;
  const BwdPlan plan{t_ctas, t_smem, dx_bn, dx_smem, dw_splits, dw_smem};
  float* out = static_cast<float*>(grads);
  float* pda = static_cast<float*>(partial_da);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (save)
    err = backward<true, true>(rp, xa, wa, plan, pda, out, s);
  else if (aff)
    err = backward<true, false>(rp, xa, wa, plan, pda, out, s);
  else
    err = backward<false, false>(rp, xa, wa, plan, pda, out, s);
  return (int)err;
}
