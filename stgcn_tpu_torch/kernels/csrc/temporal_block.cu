// temporal_block: affine(+ReLU) followed by the gamma x 1 temporal
// convolution with stride s, forward and backward, for Hopper.  The train
// path's temporal op.
//
// Replaces two Pallas TPU kernels of the JAX package that compute the same
// function in two layouts:
//   * stgcn_tpu/kernels/block_fused.py  temporal_block_vm
//       (_temporal_fwd_kernel, _temporal_bwd_kernel)
//   * stgcn_tpu/kernels/block_packed.py temporal_block_packed
//       (_tp_fwd_kernel, _tp_bwd_kernel)
// The packed variant's two-frame rows, the parity lane merge for stride 2
// and the 128-lane padding were TPU layout workarounds; these kernels take
// the logical V-major (V, N, T, C) layout and any channel count.
//
// Function, for joint v, sequence n, output frame t ("round" = to the
// activation dtype T; sums in float32; pad = (gamma - 1) / 2):
//   zh[f] = round(relu?(z[f] * s2 + t2)) for 0 <= f < T, and 0 on the
//           padding frames (zero padding after the activation)
//   u[t]  = round(sum_g zh[t*s - pad + g] . Wt_g + bt)
// Backward, given g = dL/du in T:
//   dzh[f] = sum over (t, tap) with t*s - pad + tap = f of g[t] . Wt_tap^T
//   dpre   = dzh * [pre > 0] (relu2 only),  dz = round(dpre * s2)
//   dWt_g  = sum_t zh[t*s - pad + g]^T . g[t],  dbt = sum g
//   ds2    = sum dpre * z,  dt2 = sum dpre
// The weight and affine gradients sum over all rows: each CTA keeps float32
// partial sums in its slice of a scratch tensor and a second pass adds the
// slices in a fixed order (train_common.cuh).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the forward
// needs 2*N*T_out*V*gamma*C^2 operations (18.2 GFLOP for a C=64 block and
// 36.3 to 72.7 for C=128 at the main path's B=64, T=304) against under
// 125 MB moved: 0.02 to 0.07 ms of tensor-core time against about 0.03 ms
// of memory time.  The backward does twice the operations.
//
// Design.  This first version is scalar FMA on the CUDA cores, far from that
// bound on purpose: the simple kernel that is right.  Joints are
// independent in a temporal conv, so a CTA of 256 threads may take a group
// of VG joints.
//   * Forward: a CTA owns TT output frames of one sequence and VG joints.
//     It loads the (TT-1)*s + gamma input frames its taps read (the halo),
//     applies the affine and ReLU once, keeps zh in shared memory as
//     float32, and runs the taps as 4x4 register tiles.
//   * Backward: a CTA owns FT *input* frames, so that no two CTAs write one
//     dz element: it gathers dz from the rows of g whose taps reach its
//     frames, instead of scattering.  It spreads those rows over the
//     FT + gamma - 1 frame positions they sit at (zeros between them at
//     stride 2 and outside the sequence), so every tap is a plain offset.
//     dWt is summed over the same (input frame, tap) pairs, each pair
//     belonging to one CTA, and dbt over the output rows t with t*s inside
//     the CTA's frames.
//     A fixed number of CTAs loop over the (frames, sequence, joint group)
//     work items, so the partial slices stay few.
// TT, FT and VG are the largest whose buffers fit in 227 KB
// (temporal_block.py plan_forward / plan_backward).  Tensor-core tiles are
// later work.
//
// Launch contract (checked by the Python wrapper): z, g, Wt in T; s2, t2,
// bt float32; Wt is (gamma, C_in=C, C_out=C) and WtT (gamma, C_out, C_in);
// dynamic shared memory 4*((TT-1)*s + gamma)*VG*C bytes for the forward and
// 4*(2*FT + gamma - 1)*VG*C for the backward.  Each launcher
// returns cudaGetLastError() after its launches.

#include "train_common.cuh"

namespace {

using train::accumulate;
using train::from_f;
using train::kThreads;
using train::rnd;
using train::tile_product;
using train::to_f;

struct Dims {
  int V, N, T, C, gamma, stride, pad, T_out, tile, vg, relu2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
temporal_fwd_kernel(const T* __restrict__ z, const float* __restrict__ s2,
                    const float* __restrict__ t2, const T* __restrict__ wt,
                    const float* __restrict__ bt, T* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) float zh[];  // [TF][VG][C]
  const int C = d.C, VG = d.vg, s = d.stride;
  const int t0 = blockIdx.x * d.tile;
  const int n = blockIdx.y;
  const int v0 = blockIdx.z * VG;
  const int vc = min(VG, d.V - v0);
  const int ttc = min(d.tile, d.T_out - t0);
  const int tin0 = t0 * s - d.pad;
  const int tfc = (ttc - 1) * s + d.gamma;

  for (int e = threadIdx.x; e < tfc * vc * C; e += blockDim.x) {
    const int f = e / (vc * C);
    const int rem = e - f * vc * C;
    const int v = rem / C, c = rem - v * C;
    const int tg = tin0 + f;
    float h = 0.f;
    if (tg >= 0 && tg < d.T) {
      const float zv =
          to_f(z[(((size_t)(v0 + v) * d.N + n) * d.T + tg) * C + c]);
      h = __fadd_rn(__fmul_rn(zv, s2[c]), t2[c]);
      if (d.relu2) h = fmaxf(h, 0.f);
      h = rnd<T>(h);
    }
    zh[(f * VG + v) * C + c] = h;
  }
  __syncthreads();

  tile_product<4, 4>(
      1, ttc * vc, C, d.gamma, C,
      [&](int, int r, int g, int c) {
        const int t = r / vc, v = r - t * vc;
        return zh[((t * s + g) * VG + v) * C + c];
      },
      [&](int, int g, int c, int o) { return to_f(wt[((size_t)g * C + c) * C + o]); },
      [&](int, int r, int o, float acc) {
        const int t = r / vc, v = r - t * vc;
        out[(((size_t)(v0 + v) * d.N + n) * d.T_out + t0 + t) * C + o] =
            from_f<T>(acc + bt[o]);
      });
}

// Partial-sum slice of one CTA: dWt [gamma][C][C], dbt [C], ds2 [C],
// dt2 [C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
temporal_bwd_kernel(const T* __restrict__ z, const T* __restrict__ g,
                    const float* __restrict__ s2, const float* __restrict__ t2,
                    const T* __restrict__ wtT, T* __restrict__ dz,
                    float* __restrict__ partial, long long E, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int C = d.C, VG = d.vg, s = d.stride, FT = d.tile, G = d.gamma;
  const int GU = FT + G - 1;
  float* zh = smem;                 // [FT][VG][C] zh, then dpre
  float* gu = zh + FT * VG * C;     // [GU][VG][C] g spread over frames
  float* p_dwt = partial + (size_t)blockIdx.x * E;
  float* p_dbt = p_dwt + (size_t)G * C * C;
  float* p_ds2 = p_dbt + C;
  float* p_dt2 = p_ds2 + C;
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

    for (int e = threadIdx.x; e < fc * vc * C; e += blockDim.x) {
      const int f = e / (vc * C);
      const int rem = e - f * vc * C;
      const int v = rem / C, c = rem - v * C;
      const float zv =
          to_f(z[(((size_t)(v0 + v) * d.N + n) * d.T + f0 + f) * C + c]);
      float h = __fadd_rn(__fmul_rn(zv, s2[c]), t2[c]);
      if (d.relu2) h = fmaxf(h, 0.f);
      zh[(f * VG + v) * C + c] = rnd<T>(h);
    }
    for (int e = threadIdx.x; e < GU * vc * C; e += blockDim.x) {
      const int l = e / (vc * C);
      const int rem = e - l * vc * C;
      const int v = rem / C, o = rem - v * C;
      const int p = p0 + l;
      float gv = 0.f;
      if (p >= 0 && p % s == 0 && p / s < d.T_out)
        gv = to_f(g[(((size_t)(v0 + v) * d.N + n) * d.T_out + p / s) * C + o]);
      gu[(l * VG + v) * C + o] = gv;
    }
    __syncthreads();

    // dbt: this item owns the output rows t with f0 <= t*s < f0 + fc, which
    // sit at gu rows pad .. pad + fc - 1
    for (int o = threadIdx.x; o < C; o += blockDim.x) {
      float sb = 0.f;
      for (int l = d.pad; l < d.pad + fc; ++l)
        for (int v = 0; v < vc; ++v) sb += gu[(l * VG + v) * C + o];
      accumulate(&p_dbt[o], sb, first);
    }
    // dWt_tap += zh[f]^T . gu[f + G-1 - tap] over this item's frames/joints
    tile_product<4, 4>(
        G, C, C, fc, vc,
        [&](int, int c, int f, int v) { return zh[(f * VG + v) * C + c]; },
        [&](int tap, int f, int v, int o) {
          return gu[((f + G - 1 - tap) * VG + v) * C + o];
        },
        [&](int tap, int c, int o, float acc) {
          accumulate(&p_dwt[((size_t)tap * C + c) * C + o], acc, first);
        });
    __syncthreads();  // zh is overwritten with dpre below

    // dzh[f] = sum_tap gu[f + G-1 - tap] . Wt_tap^T; through the ReLU to dz
    tile_product<4, 4>(
        1, fc * vc, C, G, C,
        [&](int, int r, int tap, int o) {
          const int f = r / vc, v = r - f * vc;
          return gu[((f + G - 1 - tap) * VG + v) * C + o];
        },
        [&](int, int tap, int o, int c) {
          return to_f(wtT[((size_t)tap * C + o) * C + c]);
        },
        [&](int, int r, int c, float acc) {
          const int f = r / vc, v = r - f * vc;
          const size_t gi = (((size_t)(v0 + v) * d.N + n) * d.T + f0 + f) * C + c;
          const float pre = __fadd_rn(__fmul_rn(to_f(z[gi]), s2[c]), t2[c]);
          const float dp = (d.relu2 && !(pre > 0.f)) ? 0.f : acc;
          dz[gi] = from_f<T>(dp * s2[c]);
          zh[(f * VG + v) * C + c] = dp;
        });
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float ss = 0.f, st = 0.f;
      for (int f = 0; f < fc; ++f)
        for (int v = 0; v < vc; ++v) {
          const float dp = zh[(f * VG + v) * C + c];
          const float zv =
              to_f(z[(((size_t)(v0 + v) * d.N + n) * d.T + f0 + f) * C + c]);
          ss += dp * zv;
          st += dp;
        }
      accumulate(&p_ds2[c], ss, first);
      accumulate(&p_dt2[c], st, first);
    }
    __syncthreads();
  }
}

Dims make_dims(int V, int N, int T, int C, int gamma, int stride, int T_out,
               int tile, int vg, int relu2) {
  Dims d;
  d.V = V;
  d.N = N;
  d.T = T;
  d.C = C;
  d.gamma = gamma;
  d.stride = stride;
  d.pad = (gamma - 1) / 2;
  d.T_out = T_out;
  d.tile = tile;
  d.vg = vg;
  d.relu2 = relu2;
  return d;
}

template <typename T>
cudaError_t launch_fwd(const void* z, const void* s2, const void* t2,
                       const void* wt, const void* bt, void* out,
                       const Dims& d, int smem_bytes, cudaStream_t stream) {
  auto kernel = temporal_fwd_kernel<T>;
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

template <typename T>
cudaError_t launch_bwd(const void* z, const void* g, const void* s2,
                       const void* t2, const void* wtT, void* dz,
                       void* partial, void* grads, int ctas, const Dims& d,
                       int smem_bytes, cudaStream_t stream) {
  auto kernel = temporal_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const long long E = (long long)d.gamma * d.C * d.C + 3LL * d.C;
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

}  // namespace

extern "C" int temporal_block_fwd_launch(
    const void* z, const void* s2, const void* t2, const void* wt,
    const void* bt, void* out, int V, int N, int T, int C, int gamma,
    int stride, int T_out, int tt, int vg, int relu2, int is_bf16,
    int smem_bytes, void* stream) {
  if (tt < 1 || vg < 1 || stride < 1 || T_out < 1)
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, N, T, C, gamma, stride, T_out, tt, vg, relu2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16>(z, s2, t2, wt, bt, out, d,
                                                   smem_bytes, s)
                       : launch_fwd<float>(z, s2, t2, wt, bt, out, d,
                                           smem_bytes, s));
}

// grads: float32 [dWt | dbt | ds2 | dt2], the sums of the CTAs' slices of
// partial (ctas slices of the same layout).
extern "C" int temporal_block_bwd_launch(
    const void* z, const void* g, const void* s2, const void* t2,
    const void* wtT, void* dz, void* partial, void* grads, int V, int N,
    int T, int C, int gamma, int stride, int T_out, int ft, int vg, int ctas,
    int relu2, int is_bf16, int smem_bytes, void* stream) {
  if (ft < 1 || vg < 1 || stride < 1 || ctas < 1 ||
      ctas > ((T + ft - 1) / ft) * N * ((V + vg - 1) / vg))
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, N, T, C, gamma, stride, T_out, ft, vg, relu2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bwd<__nv_bfloat16>(z, g, s2, t2, wtT, dz,
                                                   partial, grads, ctas, d,
                                                   smem_bytes, s)
                       : launch_bwd<float>(z, g, s2, t2, wtT, dz, partial,
                                           grads, ctas, d, smem_bytes, s));
}
