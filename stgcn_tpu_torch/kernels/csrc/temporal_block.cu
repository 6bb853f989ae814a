// temporal_block and temporal_conv: the gamma x 1 temporal convolution
// with stride s, forward and backward, for Hopper.  temporal_block is the
// train path's temporal op (an affine and ReLU first); temporal_conv is the
// plain temporal convolution of the standalone-conv routes.
//
// Replaces five Pallas TPU kernels of the JAX package:
//   * stgcn_tpu/kernels/block_fused.py  temporal_block_vm
//       (_temporal_fwd_kernel, _temporal_bwd_kernel)
//   * stgcn_tpu/kernels/block_packed.py temporal_block_packed
//       (_tp_fwd_kernel, _tp_bwd_kernel)
//   * stgcn_tpu/kernels/temporal_conv.py temporal_conv_fused
//       (_fwd_kernel, _make_dx_kernel, _make_dw_kernel), on (N, T, V, C)
//   * stgcn_tpu/kernels/temporal_conv_vm.py temporal_conv_fused_vm
//       (_shiftsum_kernel for the forward and dx, _make_dw_kernel), on
//       V-major (R = V*N, T, C)
// The first two compute temporal_block's function, the last two
// temporal_conv's, which is temporal_block's with the affine and ReLU taken
// out.  The template flag AFF keeps or drops the affine, the ReLU, the ds2
// and dt2 sums and their scratch, and the multiply of dz by s2.  The packed
// variant's two-frame rows, the parity lane merge and the host-side parity
// streams for stride 2, and the 128-lane or 16-joint padding were TPU
// layout workarounds; these kernels take the logical layouts and any
// channel counts.  Dims.vmajor picks the layout in place: V-major
// (V, N, T, C) (which is (R, T, C) with V = R, N = 1), where a frame is C
// elements apart and a joint N*T*C; or (N, T, V, C), where a joint is C
// apart and a frame V*C.
//
// Function, for joint v, sequence n, output frame t ("round" = to the
// activation dtype T; sums in float32; pad = (gamma - 1) / 2; AFF only in
// brackets):
//   zh[f] = round([relu?](z[f] [* s2 + t2])) for 0 <= f < T, and 0 on the
//           padding frames (zero padding after the activation)
//   u[t]  = round(sum_g zh[t*s - pad + g] . Wt_g + bt)
// Backward, given g = dL/du in T:
//   dzh[f] = sum over (t, tap) with t*s - pad + tap = f of g[t] . Wt_tap^T
//   dpre   = dzh [* [pre > 0]] (relu2 only),  dz = round(dpre [* s2])
//   dWt_g  = sum_t zh[t*s - pad + g]^T . g[t],  dbt = sum g
//   [ds2   = sum dpre * z,  dt2 = sum dpre]
// The weight and affine gradients sum over all rows: each CTA keeps float32
// partial sums in its slice of a scratch tensor and a second pass adds the
// slices in a fixed order (train_common.cuh).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the forward
// needs 2*N*T_out*V*gamma*C_in*C_out operations (18.2 GFLOP for a C=64
// block and 36.3 to 72.7 for C=128 and 256 at the main path's B=64, T=304)
// against under 125 MB moved: 0.02 to 0.07 ms of tensor-core time against
// about 0.03 ms of memory time.  The backward does twice the operations.
//
// Design.  This first version is scalar FMA on the CUDA cores, far from that
// bound on purpose: the simple kernel that is right.  Joints are
// independent in a temporal conv, so a CTA of 256 threads may take a group
// of VG joints.
//   * Forward: a CTA owns TT output frames of one sequence and VG joints.
//     It loads the (TT-1)*s + gamma input frames its taps read (the halo),
//     [applies the affine and ReLU once,] keeps zh in shared memory as
//     float32, and runs the taps as 4x4 register tiles.
//   * Backward: a CTA owns FT *input* frames, so that no two CTAs write one
//     dz element: it gathers dz from the rows of g whose taps reach its
//     frames, instead of scattering.  It spreads those rows over the
//     FT + gamma - 1 frame positions they sit at (zeros between them at
//     stride 2 and outside the sequence), so every tap is a plain offset,
//     and every input frame gets its dz, also those at the end of T that
//     no output tap reaches.  dWt is summed over the same (input frame,
//     tap) pairs, each pair belonging to one CTA, and dbt over the output
//     rows t with t*s inside the CTA's frames.
//     A fixed number of CTAs loop over the (frames, sequence, joint group)
//     work items, so the partial slices stay few.
// TT, FT and VG are chosen to fit in 227 KB (temporal_block.py
// plan_forward / plan_backward, temporal_conv.py plan_conv).  Tensor-core
// tiles are later work.
//
// Launch contract (checked by the Python wrappers): z, g, Wt in T; s2, t2
// (AFF only) and bt float32; Wt is (gamma, C_in, C_out) and WtT
// (gamma, C_out, C_in); dynamic shared memory 4*((TT-1)*s + gamma)*VG*C_in
// bytes for the forward and 4*(FT*C_in + (FT + gamma - 1)*C_out)*VG for
// the backward.  Each launcher returns cudaGetLastError() after its
// launches.

#include "train_common.cuh"

namespace {

using train::accumulate;
using train::from_f;
using train::kThreads;
using train::rnd;
using train::tile_product;
using train::to_f;

struct Dims {
  int V, N, T, Ci, Co, gamma, stride, pad, T_out, tile, vg, relu2, vmajor;
};

// Offset of (sequence n, frame t, joint v, channel 0) in a tensor of TT
// frames and C channels, V-major (VM) or (N, T, V, C).
template <bool VM>
__device__ __forceinline__ size_t at(const Dims& d, int n, int t, int v,
                                     int TT, int C) {
  return VM ? (((size_t)v * d.N + n) * TT + t) * C
            : (((size_t)n * TT + t) * d.V + v) * C;
}

// The affine's input to the ReLU, rounded as torch rounds it (no FMA).
__device__ __forceinline__ float affine(float zv, const float* s2,
                                        const float* t2, int c) {
  return __fadd_rn(__fmul_rn(zv, s2[c]), t2[c]);
}

// zh of one element: z [through the affine and ReLU], rounded to T.
template <typename T, bool AFF>
__device__ __forceinline__ float temporal_in(float zv, const float* s2,
                                             const float* t2, int c,
                                             const Dims& d) {
  if constexpr (AFF) {
    float h = affine(zv, s2, t2, c);
    if (d.relu2) h = fmaxf(h, 0.f);
    return rnd<T>(h);
  } else {
    return zv;
  }
}

// Both kernels declare a floor of one CTA per SM.  With the default bounds
// ptxas gave them 57-80 registers a thread and the tap loops ran 25-50%
// slower than with this floor, under which it gives them 63-96 (H100, same
// results bit for bit).
template <typename T, bool AFF, bool VM>
__global__ void __launch_bounds__(kThreads, 1)
temporal_fwd_kernel(const T* __restrict__ z, const float* __restrict__ s2,
                    const float* __restrict__ t2, const T* __restrict__ wt,
                    const float* __restrict__ bt, T* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) float zh[];  // [TF][VG][Ci]
  const int Ci = d.Ci, Co = d.Co, VG = d.vg, s = d.stride;
  const int t0 = blockIdx.x * d.tile;
  const int n = blockIdx.y;
  const int v0 = blockIdx.z * VG;
  const int vc = min(VG, d.V - v0);
  const int ttc = min(d.tile, d.T_out - t0);
  const int tin0 = t0 * s - d.pad;
  const int tfc = (ttc - 1) * s + d.gamma;

  for (int e = threadIdx.x; e < tfc * vc * Ci; e += blockDim.x) {
    const int f = e / (vc * Ci);
    const int rem = e - f * vc * Ci;
    const int v = rem / Ci, c = rem - v * Ci;
    const int tg = tin0 + f;
    float h = 0.f;
    if (tg >= 0 && tg < d.T)
      h = temporal_in<T, AFF>(to_f(z[at<VM>(d, n, tg, v0 + v, d.T, Ci) + c]),
                              s2, t2, c, d);
    zh[(f * VG + v) * Ci + c] = h;
  }
  __syncthreads();

  tile_product<4, 4>(
      1, ttc * vc, Co, d.gamma, Ci,
      [&](int, int r, int g, int c) {
        const int t = r / vc, v = r - t * vc;
        return zh[((t * s + g) * VG + v) * Ci + c];
      },
      [&](int, int g, int c, int o) {
        return to_f(wt[((size_t)g * Ci + c) * Co + o]);
      },
      [&](int, int r, int o, float acc) {
        const int t = r / vc, v = r - t * vc;
        out[at<VM>(d, n, t0 + t, v0 + v, d.T_out, Co) + o] =
            from_f<T>(acc + bt[o]);
      });
}

// Partial-sum slice of one CTA: dWt [gamma][Ci][Co], dbt [Co], and with
// AFF ds2 [Ci], dt2 [Ci].
template <typename T, bool AFF, bool VM>
__global__ void __launch_bounds__(kThreads, 1)
temporal_bwd_kernel(const T* __restrict__ z, const T* __restrict__ g,
                    const float* __restrict__ s2, const float* __restrict__ t2,
                    const T* __restrict__ wtT, T* __restrict__ dz,
                    float* __restrict__ partial, long long E, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int Ci = d.Ci, Co = d.Co, VG = d.vg, s = d.stride, FT = d.tile;
  const int G = d.gamma;
  const int GU = FT + G - 1;
  float* zh = smem;                 // [FT][VG][Ci] zh, then dpre
  float* gu = zh + FT * VG * Ci;    // [GU][VG][Co] g spread over frames
  float* p_dwt = partial + (size_t)blockIdx.x * E;
  float* p_dbt = p_dwt + (size_t)G * Ci * Co;
  float* p_ds2 = p_dbt + Co;
  float* p_dt2 = p_ds2 + Ci;
  const int nft = (d.T + FT - 1) / FT;
  const int ngv = (d.V + VG - 1) / VG;
  const int items = nft * d.N * ngv;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const bool first = item == (int)blockIdx.x;
    const int ft = item % nft;
    const int n = (item / nft) % d.N;
    const int v0 = (item / (nft * d.N)) * VG;
    const int vc = min(VG, d.V - v0);
    const int f0 = ft * FT;
    const int fc = min(FT, d.T - f0);
    // gu row l holds g[t] where t*s = f0 + pad - (G-1) + l, and zeros where
    // no output row sits; tap `tap` of frame f0+f then reads gu row
    // f + G-1 - tap, so the taps need no bounds or parity tests.
    const int p0 = f0 + d.pad - (G - 1);

    for (int e = threadIdx.x; e < fc * vc * Ci; e += blockDim.x) {
      const int f = e / (vc * Ci);
      const int rem = e - f * vc * Ci;
      const int v = rem / Ci, c = rem - v * Ci;
      zh[(f * VG + v) * Ci + c] = temporal_in<T, AFF>(
          to_f(z[at<VM>(d, n, f0 + f, v0 + v, d.T, Ci) + c]), s2, t2, c, d);
    }
    for (int e = threadIdx.x; e < GU * vc * Co; e += blockDim.x) {
      const int l = e / (vc * Co);
      const int rem = e - l * vc * Co;
      const int v = rem / Co, o = rem - v * Co;
      const int p = p0 + l;
      float gv = 0.f;
      if (p >= 0 && p % s == 0 && p / s < d.T_out)
        gv = to_f(g[at<VM>(d, n, p / s, v0 + v, d.T_out, Co) + o]);
      gu[(l * VG + v) * Co + o] = gv;
    }
    __syncthreads();

    // dbt: this item owns the output rows t with f0 <= t*s < f0 + fc, which
    // sit at gu rows pad .. pad + fc - 1
    for (int o = threadIdx.x; o < Co; o += blockDim.x) {
      float sb = 0.f;
      for (int l = d.pad; l < d.pad + fc; ++l)
        for (int v = 0; v < vc; ++v) sb += gu[(l * VG + v) * Co + o];
      accumulate(&p_dbt[o], sb, first);
    }
    // dWt_tap += zh[f]^T . gu[f + G-1 - tap] over this item's frames/joints
    tile_product<4, 4>(
        G, Ci, Co, fc, vc,
        [&](int, int c, int f, int v) { return zh[(f * VG + v) * Ci + c]; },
        [&](int tap, int f, int v, int o) {
          return gu[((f + G - 1 - tap) * VG + v) * Co + o];
        },
        [&](int tap, int c, int o, float acc) {
          accumulate(&p_dwt[((size_t)tap * Ci + c) * Co + o], acc, first);
        });
    __syncthreads();  // zh is overwritten with dpre below

    // dzh[f] = sum_tap gu[f + G-1 - tap] . Wt_tap^T; [through the ReLU] to dz
    tile_product<4, 4>(
        1, fc * vc, Ci, G, Co,
        [&](int, int r, int tap, int o) {
          const int f = r / vc, v = r - f * vc;
          return gu[((f + G - 1 - tap) * VG + v) * Co + o];
        },
        [&](int, int tap, int o, int c) {
          return to_f(wtT[((size_t)tap * Co + o) * Ci + c]);
        },
        [&](int, int r, int c, float acc) {
          const int f = r / vc, v = r - f * vc;
          const size_t gi = at<VM>(d, n, f0 + f, v0 + v, d.T, Ci) + c;
          if constexpr (AFF) {
            const float pre = affine(to_f(z[gi]), s2, t2, c);
            const float dp = (d.relu2 && !(pre > 0.f)) ? 0.f : acc;
            dz[gi] = from_f<T>(dp * s2[c]);
            zh[(f * VG + v) * Ci + c] = dp;
          } else {
            dz[gi] = from_f<T>(acc);
          }
        });
    __syncthreads();
    if constexpr (AFF) {
      for (int c = threadIdx.x; c < Ci; c += blockDim.x) {
        float ss = 0.f, st = 0.f;
        for (int f = 0; f < fc; ++f)
          for (int v = 0; v < vc; ++v) {
            const float dp = zh[(f * VG + v) * Ci + c];
            const float zv =
                to_f(z[at<VM>(d, n, f0 + f, v0 + v, d.T, Ci) + c]);
            ss += dp * zv;
            st += dp;
          }
        accumulate(&p_ds2[c], ss, first);
        accumulate(&p_dt2[c], st, first);
      }
      __syncthreads();
    }
  }
}

Dims make_dims(int V, int N, int T, int Ci, int Co, int gamma, int stride,
               int T_out, int tile, int vg, int relu2, int vmajor) {
  Dims d;
  d.V = V;
  d.N = N;
  d.T = T;
  d.Ci = Ci;
  d.Co = Co;
  d.gamma = gamma;
  d.stride = stride;
  d.pad = (gamma - 1) / 2;
  d.T_out = T_out;
  d.tile = tile;
  d.vg = vg;
  d.relu2 = relu2;
  d.vmajor = vmajor;
  return d;
}

template <typename T, bool AFF, bool VM>
cudaError_t launch_fwd(const void* z, const void* s2, const void* t2,
                       const void* wt, const void* bt, void* out,
                       const Dims& d, int smem_bytes, cudaStream_t stream) {
  auto kernel = temporal_fwd_kernel<T, AFF, VM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((d.T_out + d.tile - 1) / d.tile, d.N, (d.V + d.vg - 1) / d.vg);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(z), static_cast<const float*>(s2),
      static_cast<const float*>(t2), static_cast<const T*>(wt),
      static_cast<const float*>(bt), static_cast<T*>(out), d);
  return cudaGetLastError();
}

template <typename T, bool AFF, bool VM>
cudaError_t launch_bwd(const void* z, const void* g, const void* s2,
                       const void* t2, const void* wtT, void* dz,
                       void* partial, void* grads, int ctas, const Dims& d,
                       int smem_bytes, cudaStream_t stream) {
  auto kernel = temporal_bwd_kernel<T, AFF, VM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const long long E = (long long)d.gamma * d.Ci * d.Co + d.Co +
                      (AFF ? 2LL * d.Ci : 0LL);
  kernel<<<ctas, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(g),
      static_cast<const float*>(s2), static_cast<const float*>(t2),
      static_cast<const T*>(wtT), static_cast<T*>(dz),
      static_cast<float*>(partial), E, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return train::launch_reduce(static_cast<const float*>(partial),
                              static_cast<float*>(grads), ctas, E, stream);
}

bool bad_fwd_args(int tt, int vg, int stride, int T_out) {
  return tt < 1 || vg < 1 || stride < 1 || T_out < 1;
}

bool bad_bwd_args(int V, int N, int T, int ft, int vg, int stride, int ctas) {
  return ft < 1 || vg < 1 || stride < 1 || ctas < 1 ||
         ctas > ((T + ft - 1) / ft) * N * ((V + vg - 1) / vg);
}

// The launchers of one activation dtype and affine flag, for either layout.
template <typename T, bool AFF>
cudaError_t fwd(const void* z, const void* s2, const void* t2, const void* wt,
                const void* bt, void* out, const Dims& d, int smem_bytes,
                cudaStream_t s) {
  return d.vmajor
             ? launch_fwd<T, AFF, true>(z, s2, t2, wt, bt, out, d,
                                        smem_bytes, s)
             : launch_fwd<T, AFF, false>(z, s2, t2, wt, bt, out, d,
                                         smem_bytes, s);
}

template <typename T, bool AFF>
cudaError_t bwd(const void* z, const void* g, const void* s2, const void* t2,
                const void* wtT, void* dz, void* partial, void* grads,
                int ctas, const Dims& d, int smem_bytes, cudaStream_t s) {
  return d.vmajor ? launch_bwd<T, AFF, true>(z, g, s2, t2, wtT, dz, partial,
                                             grads, ctas, d, smem_bytes, s)
                  : launch_bwd<T, AFF, false>(z, g, s2, t2, wtT, dz, partial,
                                              grads, ctas, d, smem_bytes, s);
}

}  // namespace

extern "C" int temporal_block_fwd_launch(
    const void* z, const void* s2, const void* t2, const void* wt,
    const void* bt, void* out, int V, int N, int T, int C, int gamma,
    int stride, int T_out, int tt, int vg, int relu2, int is_bf16,
    int smem_bytes, void* stream) {
  if (bad_fwd_args(tt, vg, stride, T_out)) return (int)cudaErrorInvalidValue;
  const Dims d =
      make_dims(V, N, T, C, C, gamma, stride, T_out, tt, vg, relu2, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? fwd<__nv_bfloat16, true>(z, s2, t2, wt, bt, out, d,
                                                  smem_bytes, s)
                       : fwd<float, true>(z, s2, t2, wt, bt, out, d,
                                          smem_bytes, s));
}

// grads: float32 [dWt | dbt | ds2 | dt2], the sums of the CTAs' slices of
// partial (ctas slices of the same layout).
extern "C" int temporal_block_bwd_launch(
    const void* z, const void* g, const void* s2, const void* t2,
    const void* wtT, void* dz, void* partial, void* grads, int V, int N,
    int T, int C, int gamma, int stride, int T_out, int ft, int vg, int ctas,
    int relu2, int is_bf16, int smem_bytes, void* stream) {
  if (bad_bwd_args(V, N, T, ft, vg, stride, ctas))
    return (int)cudaErrorInvalidValue;
  const Dims d =
      make_dims(V, N, T, C, C, gamma, stride, T_out, ft, vg, relu2, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? bwd<__nv_bfloat16, true>(z, g, s2, t2, wtT, dz,
                                                  partial, grads, ctas, d,
                                                  smem_bytes, s)
                       : bwd<float, true>(z, g, s2, t2, wtT, dz, partial,
                                          grads, ctas, d, smem_bytes, s));
}

// The plain temporal convolution: vmajor = 1 for (V, N, T, C) tensors
// (pass V = R, N = 1 for (R, T, C)), 0 for (N, T, V, C) ones.
extern "C" int temporal_conv_fwd_launch(
    const void* x, const void* w, const void* b, void* out, int V, int N,
    int T, int C_in, int C_out, int gamma, int stride, int T_out, int tt,
    int vg, int vmajor, int is_bf16, int smem_bytes, void* stream) {
  if (bad_fwd_args(tt, vg, stride, T_out)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, N, T, C_in, C_out, gamma, stride, T_out, tt,
                           vg, 0, vmajor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? fwd<__nv_bfloat16, false>(x, nullptr, nullptr, w, b,
                                                   out, d, smem_bytes, s)
                       : fwd<float, false>(x, nullptr, nullptr, w, b, out, d,
                                           smem_bytes, s));
}

// grads: float32 [dW | db], the sums of the CTAs' slices of partial.
extern "C" int temporal_conv_bwd_launch(
    const void* x, const void* g, const void* wT, void* dx, void* partial,
    void* grads, int V, int N, int T, int C_in, int C_out, int gamma,
    int stride, int T_out, int ft, int vg, int ctas, int vmajor, int is_bf16,
    int smem_bytes, void* stream) {
  if (bad_bwd_args(V, N, T, ft, vg, stride, ctas))
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, N, T, C_in, C_out, gamma, stride, T_out, ft,
                           vg, 0, vmajor);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? bwd<__nv_bfloat16, false>(x, g, nullptr, nullptr,
                                                   wT, dx, partial, grads,
                                                   ctas, d, smem_bytes, s)
                       : bwd<float, false>(x, g, nullptr, nullptr, wT, dx,
                                           partial, grads, ctas, d,
                                           smem_bytes, s));
}
