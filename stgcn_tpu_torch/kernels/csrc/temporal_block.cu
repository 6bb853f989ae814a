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
// channel counts.  The layout is picked in place: V-major (V, N, T, C)
// (which is (R, T, C) with V = R, N = 1), where a frame is C elements apart
// and a joint N*T*C; or (N, T, V, C), where a joint is C apart and a frame
// V*C.
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
// The weight and affine gradients sum over all rows: CTAs write float32
// partial sums into their own slices of a scratch tensor and a second pass
// adds the slices in a fixed order (train_common.cuh), so the gradients
// repeat bit for bit.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the forward
// needs 2*N*T_out*V*gamma*C_in*C_out operations, at the main path's B=64,
// T=304 35.9 GFLOP for a C=64 block (T_out=304), 71.7 for C=128 (T_out=152)
// and 143.4 for C=256 (T_out=76): 0.036 to 0.145 ms of tensor-core time,
// against 25 to 125 MB moved, 0.007 to 0.037 ms of memory time.  The
// backward does twice the operations.  (chip_smoke.py temporal_cost
// recomputes both per block.)
//
// Design, bf16 (every main path): tensor cores through tap_mma.cuh.
//   * Forward: an implicit GEMM, M = the (joint line, output frame) rows,
//     N = C_out, K = gamma x C_in.  Rows are flattened with the frame
//     fastest, so a CTA of BM rows needs about BM*s + gamma - s input
//     frames of one or two lines (the halo): it stages them once as bf16
//     in shared memory [, applying the affine, the ReLU and the rounding on
//     the way, which gives exactly zh].  Each row reads its tap g at a
//     per-row offset + g; Wt chunks of KC input channels stream through
//     the cp.async ring.  The epilogue adds bt, rounds and stores.
//   * dx: the same GEMM on g and WtT.  At stride s the input frames split
//     by parity p = f mod s: frame f = j*s + p takes only the taps with
//     t*s - pad + tap = f, tap = tap0 + i*s, over the contiguous g rows
//     t = j + e0 - i; for gamma = 9, pad = 4, s = 2 even frames take taps
//     0,2,4,6,8 and odd frames taps 1,3,5,7, so no product with a zero row
//     is left.  [The epilogue recomputes the pre-activation from z, masks
//     by the ReLU, writes dz = round(dpre * s2) and adds the column sums
//     of dpre * z and dpre of its rows into its CTA's slice.]  Frames no
//     tap reaches get dz = 0 from zero-filled g rows.
//   * dWt: per tap, dWt_tap = zh_shifted^T . g is a GEMM with K = the
//     N*T_out*V rows, split across CTAs into float32 partial slices (about
//     two CTAs per SM), summed in slice order.  [zh is recomputed from z
//     while staging.]  dbt, the column sum of g, is taken in the same pass
//     by the CTAs of tap 0.
//   The wrapper's backward is one op call: dx, dWt and the reduction
//   passes are launched together.
// Design, float32 (the port's check type; on tensor cores it would be
// TF32): scalar FMA on the CUDA cores.  A CTA of 256 threads may take a
// group of VG joints.
//   * Forward: a CTA owns TT output frames of one sequence and VG joints.
//     It loads the (TT-1)*s + gamma input frames its taps read (the halo),
//     [applies the affine and ReLU once,] keeps zh in shared memory as
//     float32, and runs the taps as 4x4 register tiles.
//   * Backward: a CTA owns FT *input* frames, so that no two CTAs write one
//     dz element: it gathers dz from the rows of g whose taps reach its
//     frames, spread over the FT + gamma - 1 frame positions they sit at
//     (zeros between them at stride 2 and outside the sequence).  dWt is
//     summed over the same (input frame, tap) pairs, each pair belonging
//     to one CTA, and dbt over the output rows t with t*s inside the CTA's
//     frames.  A fixed number of CTAs loop over the (frames, sequence,
//     joint group) work items, so the partial slices stay few.
// Tiles are chosen to fit in 227 KB (temporal_block.py plan_forward,
// plan_backward and plan_mma, temporal_conv.py plan_conv).
//
// Launch contract (checked by the Python wrappers): z, g, Wt in T; s2, t2
// (AFF only) and bt float32; Wt is (gamma, C_in, C_out) and WtT
// (gamma, C_out, C_in); the dynamic shared memory the planners give.  Each
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

// ---- bf16: the tensor-core kernels (tap_mma.cuh) ---------------------------
namespace mma_path {

using tap::bf16;
constexpr int KC = 32;  // weight rows (input channels) per ring stage
constexpr int KR = 64;  // dWt: rows of the GEMM's K per chunk

// Offset of (line, frame f, channel 0) in a tensor of TT frames and C
// channels.  A line is one (joint, sequence) pair: line v*N + n of a
// V-major (V, N, T, C) tensor, line n*V + v of an (N, T, V, C) one.
template <bool VM>
__device__ __forceinline__ size_t line_at(int line, int f, int TT, int C,
                                          int V) {
  if constexpr (VM) {
    return ((size_t)line * TT + f) * C;
  } else {
    const int n = line / V;
    const int v = line - n * V;
    return (((size_t)n * TT + f) * V + v) * C;
  }
}

struct GemmArgs {
  const bf16* x;      // the GEMM's input rows: z (forward) or g (dx)
  const bf16* z;      // dx with AFF: the op's input, for the epilogue
  const float* s2;    // AFF
  const float* t2;    // AFF
  const bf16* w;      // (gamma, K_in, N_out): Wt (forward) or WtT (dx)
  const float* bias;  // forward: bt
  bf16* out;          // forward: u (T_out frames); dx: dz (T frames)
  float* partial;     // dx with AFF: [slice][ds2 (N_out) | dt2 (N_out)]
  int V, N, T, T_out, K_in, N_out, gamma, stride, pad, relu2, tiles_x;
};

// The forward (DX false) or one input-frame parity of dx (DX true,
// parity blockIdx.z) as an implicit GEMM.  A CTA owns BM rows of the
// flattened (line, output frame) rows and BN output channels; its 8 warps
// are WM x WN tiles of 32 x 32.
template <bool AFF, bool VM, bool DX, int WN>
__global__ void __launch_bounds__(tap::kThreads)
tap_gemm_kernel(GemmArgs p) {
  constexpr int WM = 8 / WN, BM = 32 * WM, BN = 32 * WN;
  constexpr int BP = BN + tap::kPad;  // pitch of a ring stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);       // [2][KC][BP]
  int* rowoff = reinterpret_cast<int*>(ring + 2 * KC * BP);  // [BM]
  float* red = reinterpret_cast<float*>(rowoff + BM);   // [2][WM][BN]
  bf16* as = reinterpret_cast<bf16*>(red + (DX && AFF ? 2 * WM * BN : 0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int s = p.stride;

  // Tap i multiplies weight tap tap0 + i*tstep into staged row
  // (row offset + shift(i)); a line's rows j read its staged frames from
  // j*walk + off0 on; row j writes output frame j*ostride + par.
  int J, ntap, tap0, tstep, off0, walk, Tx, To, ostride, par;
  if constexpr (DX) {
    par = blockIdx.z;
    J = (p.T - par + s - 1) / s;
    tap0 = (par + p.pad) % s;
    ntap = (p.gamma - tap0 + s - 1) / s;
    off0 = (par + p.pad - tap0) / s - (ntap - 1);
    tstep = s;
    walk = 1;
    Tx = p.T_out;
    To = p.T;
    ostride = s;
  } else {
    par = 0;
    J = p.T_out;
    tap0 = 0;
    ntap = p.gamma;
    off0 = -p.pad;
    tstep = 1;
    walk = s;
    Tx = p.T;
    To = p.T_out;
    ostride = 1;
  }
  const int R = p.V * p.N * J;  // rows fit in int (checked by the launcher)
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const size_t slice = (size_t)(blockIdx.z * p.tiles_x + blockIdx.x) * 2 *
                       p.N_out;
  if (r0 >= R) {  // a parity with fewer rows: an empty slice
    if constexpr (DX && AFF) {
      for (int t = threadIdx.x; t < BN; t += blockDim.x)
        if (n0 + t < p.N_out) {
          p.partial[slice + n0 + t] = 0.f;
          p.partial[slice + p.N_out + n0 + t] = 0.f;
        }
    }
    return;
  }
  const int Kp = tap::round16(p.K_in);
  const int AP = Kp + tap::kPad;
  const int nkc = (Kp + KC - 1) / KC;
  const int nchunks = ntap * nkc;

  auto issue = [&](int ch) {
    const int i = ch / nkc;
    const int k0 = (ch - i * nkc) * KC;
    const int rows_valid = min(KC, p.K_in - k0);
    const bf16* src =
        rows_valid > 0
            ? p.w + ((size_t)(tap0 + i * tstep) * p.K_in + k0) * p.N_out + n0
            : p.w;
    tap::stage_tile(ring + (ch & 1) * KC * BP, BP, src, p.N_out, KC,
                    rows_valid, BN, p.N_out - n0);
    tap::cp_async_commit();
  };
  issue(0);  // the first weight chunk loads while the rows are staged

  // The tile's rows: `first` rows of line l0 from frame row ja0, then
  // whole lines; each line's staged frames follow the previous line's.
  const int rows = min(BM, R - r0);
  const int l0 = r0 / J;
  const int ja0 = r0 - l0 * J;
  const int first = min(J - ja0, rows);
  const int len_first = (first - 1) * walk + ntap;
  const int len_full = (J - 1) * walk + ntap;
  const int rest = rows - first;
  const int S = len_first + (rest / J) * len_full +
                (rest % J ? (rest % J - 1) * walk + ntap : 0);
  for (int r = threadIdx.x; r < BM; r += blockDim.x) {
    int off = 0;  // rows past the end read row 0 and are not stored
    if (r < first) {
      off = r * walk;
    } else if (r < rows) {
      const int q = r - first;
      off = len_first + (q / J) * len_full + (q % J) * walk;
    }
    rowoff[r] = off;
  }
  const int pieces = Kp / 8;
  for (int e = threadIdx.x; e < S * pieces; e += blockDim.x) {
    const int sr = e / pieces;
    const int c = (e - sr * pieces) * 8;
    int l, f;
    if (sr < len_first) {
      l = l0;
      f = ja0 * walk + off0 + sr;
    } else {
      const int q = sr - len_first;
      l = l0 + 1 + q / len_full;
      f = off0 + q % len_full;
    }
    const bool valid = f >= 0 && f < Tx;
    const bf16* row = p.x + (valid ? line_at<VM>(l, f, Tx, p.K_in, p.V) : 0);
    tap::stage8<AFF && !DX>(as + (size_t)sr * AP + c, row, c, p.K_in, valid,
                            p.s2, p.t2, p.relu2);
  }
  __syncthreads();

  int my_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    my_off[i] = rowoff[wm * 32 + i * 16 + tap::a_lane_row(lane)];
  const int col8 = tap::lane_col8(lane);
  float acc[2][4][4];
  tap::zero(acc);
  tap::ring_loop(
      nchunks,
      [&](int ch) {
        if (ch > 0) issue(ch);  // chunk 0 went out before the rows' staging
      },
      [&](int ch) {
        const int i = ch / nkc;
        const int k0 = (ch - i * nkc) * KC;
        const int shift = DX ? ntap - 1 - i : i;
        const int steps = min(KC, Kp - k0) / 16;
        const bf16* bs = ring + (ch & 1) * KC * BP;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          if (kk >= steps) break;
          uint32_t a_addr[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            a_addr[mi] = tap::smem_u32(as + (size_t)(my_off[mi] + shift) * AP +
                                       k0 + kk * 16 + col8);
          tap::mma_k16<2, 4>(
              acc, a_addr,
              tap::smem_u32(bs + (kk * 16 + (lane & 15)) * BP + wn * 32 +
                            col8));
        }
      });

  // Epilogue.  Row bases of this thread's four rows (two m16 blocks, two
  // halves); -1 marks a row past the tile's end.
  long long base[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + tap::acc_row(mi, 2 * h, lane);
      base[mi][h] = -1;
      if (r < rows) {
        const int gr = r0 + r;
        const int l = gr / J;
        const int j = gr - l * J;
        base[mi][h] = (long long)line_at<VM>(l, j * ostride + par, To,
                                             p.N_out, p.V);
      }
    }
  float cs[4][2], ct[4][2];  // dx with AFF: column sums of dpre*z, dpre
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) cs[nj][0] = cs[nj][1] = ct[nj][0] =
      ct[nj][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (base[mi][h] < 0) continue;
        const int o = n0 + wn * 32 + tap::acc_col(nj, 0, lane);
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int oc = o + q;
          v[q] = acc[mi][nj][2 * h + q];
          if (oc >= p.N_out) continue;
          if constexpr (!DX) {
            v[q] += p.bias[oc];
          } else if constexpr (AFF) {
            const float zv = __bfloat162float(p.z[base[mi][h] + oc]);
            const float pre = tap::affine(zv, p.s2[oc], p.t2[oc]);
            const float dp = (p.relu2 && !(pre > 0.f)) ? 0.f : v[q];
            cs[nj][q] += dp * zv;
            ct[nj][q] += dp;
            v[q] = dp * p.s2[oc];
          }
        }
        bf16* dst = p.out + base[mi][h] + o;
        if (o + 1 < p.N_out && p.N_out % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (o < p.N_out) dst[0] = __float2bfloat16_rn(v[0]);
          if (o + 1 < p.N_out) dst[1] = __float2bfloat16_rn(v[1]);
        }
      }
  if constexpr (DX && AFF) {
    // Column sums: the thread's rows, then the warp's eight row groups
    // (xor over lane bits 2-4), then the WM warps in order.
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float a = cs[nj][q], b = ct[nj][q];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, m);
          b += __shfl_xor_sync(0xffffffffu, b, m);
        }
        if (lane < 4) {
          const int col = wn * 32 + tap::acc_col(nj, q, lane);
          red[wm * BN + col] = a;
          red[(WM + wm) * BN + col] = b;
        }
      }
    __syncthreads();
    for (int t = threadIdx.x; t < BN; t += blockDim.x) {
      if (n0 + t >= p.N_out) continue;
      float a = 0.f, b = 0.f;
      for (int w = 0; w < WM; ++w) {
        a += red[w * BN + t];
        b += red[(WM + w) * BN + t];
      }
      p.partial[slice + n0 + t] = a;
      p.partial[slice + p.N_out + n0 + t] = b;
    }
  }
}

struct DwtArgs {
  const bf16* z;     // the op's input (V-major or (N, T, V, C)), C_in
  const bf16* g;     // dL/du, C_out
  const float* s2;   // AFF
  const float* t2;   // AFF
  float* partial;    // [split][gamma*C_in*C_out (dWt) | C_out (dbt)]
  int V, N, T, T_out, Ci, Co, gamma, stride, pad, relu2, split_rows;
};

// dWt_tap[c, o] = sum over rows (line, t) of zh[line, t*s - pad + tap][c]
// * g[line, t][o]: a CTA owns one tap, BM = 64 input channels, BN output
// channels and one split of the rows; its 8 warps are 2 x 4 tiles of
// 32 x 8*NJ.  zh (A, stored [row][c]) and g (B, [row][o]) stream through a
// two-stage ring in chunks of KR rows.  The CTAs of tap 0 and the first
// channel tile also sum g's columns (dbt).
template <bool AFF, bool VM, int NJ>
__global__ void __launch_bounds__(tap::kThreads)
tap_dwt_kernel(DwtArgs p) {
  constexpr int WN = 4, BM = 64, BN = 8 * NJ * WN;
  constexpr int AP = BM + tap::kPad, BP = BN + tap::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* za = reinterpret_cast<bf16*>(smem_raw);  // [2][KR][AP]
  bf16* gs = za + 2 * KR * AP;                   // [2][KR][BP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int nct = (p.Ci + BM - 1) / BM;
  const int tap_i = blockIdx.x / nct;
  const int c0 = (blockIdx.x - tap_i * nct) * BM;
  const int n0 = blockIdx.y * BN;
  const int R = p.V * p.N * p.T_out;
  const int k_begin = blockIdx.z * p.split_rows;
  const int k_end = min(R, k_begin + p.split_rows);
  const int nchunks = (int)((k_end - k_begin + KR - 1) / KR);
  const bool do_dbt = tap_i == 0 && c0 == 0;
  const bool g_aligned = p.Co % 8 == 0;
  const bool z_aligned = !AFF && p.Ci % 8 == 0;

  auto stage = [&](int ch) {
    const int kb = k_begin + ch * KR;
    bf16* zd = za + (ch & 1) * KR * AP;
    bf16* gd = gs + (ch & 1) * KR * BP;
    for (int e = threadIdx.x; e < KR * (BN / 8); e += blockDim.x) {
      const int r = e / (BN / 8);
      const int c = (e - r * (BN / 8)) * 8;
      const int gr = kb + r;
      int valid = 0;
      const bf16* src = p.g;
      if (gr < k_end) {
        const int l = gr / p.T_out;
        const int t = gr - l * p.T_out;
        valid = min(8, max(0, p.Co - n0 - c));
        if (valid > 0) src = p.g + line_at<VM>(l, t, p.T_out, p.Co, p.V) + n0 + c;
      }
      bf16* d = gd + r * BP + c;
      if (g_aligned) {
        tap::cp_async16(tap::smem_u32(d), src, valid * (int)sizeof(bf16));
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          d[k] = k < valid ? src[k] : __float2bfloat16_rn(0.f);
      }
    }
    for (int e = threadIdx.x; e < KR * (BM / 8); e += blockDim.x) {
      const int r = e / (BM / 8);
      const int c = (e - r * (BM / 8)) * 8;
      const int gr = kb + r;
      bool valid = false;
      const bf16* row = p.z;
      if (gr < k_end) {
        const int l = gr / p.T_out;
        const int t = gr - l * p.T_out;
        const int f = t * p.stride - p.pad + tap_i;
        valid = f >= 0 && f < p.T;
        if (valid) row = p.z + line_at<VM>(l, f, p.T, p.Ci, p.V) + c0;
      }
      bf16* d = zd + r * AP + c;
      if (z_aligned) {
        const int n = valid ? min(8, max(0, p.Ci - c0 - c)) : 0;
        tap::cp_async16(tap::smem_u32(d), n > 0 ? row + c : p.z,
                        n * (int)sizeof(bf16));
      } else {
        tap::stage8<AFF>(d, row, c, p.Ci - c0, valid, p.s2 + c0, p.t2 + c0,
                         p.relu2);
      }
    }
    tap::cp_async_commit();
  };

  float acc[2][NJ][4];
  tap::zero(acc);
  float sb = 0.f;
  const int col8 = tap::lane_col8(lane);
  tap::ring_loop(nchunks, stage, [&](int ch) {
    const bf16* zd = za + (ch & 1) * KR * AP;
    const bf16* gd = gs + (ch & 1) * KR * BP;
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk) {
      uint32_t a_addr[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        a_addr[mi] = tap::smem_u32(zd + (kk * 16 + tap::at_lane_row(lane)) * AP +
                                   wm * 32 + mi * 16 + tap::at_lane_col(lane));
      const uint32_t b_addr = tap::smem_u32(gd + (kk * 16 + (lane & 15)) * BP +
                                            wn * 8 * NJ + col8);
      tap::mma_k16<2, NJ, true>(acc, a_addr, b_addr);
    }
    if (do_dbt && (int)threadIdx.x < BN) {
      for (int r = 0; r < KR; ++r)
        sb += __bfloat162float(gd[r * BP + threadIdx.x]);
    }
  });

  const size_t E = (size_t)p.gamma * p.Ci * p.Co + p.Co;
  float* slice = p.partial + (size_t)blockIdx.z * E;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + wm * 32 + tap::acc_row(mi, e, lane);
        const int o = n0 + wn * 8 * NJ + tap::acc_col(nj, e, lane);
        if (c < p.Ci && o < p.Co)
          slice[((size_t)tap_i * p.Ci + c) * p.Co + o] = acc[mi][nj][e];
      }
  if (do_dbt && threadIdx.x < BN && n0 + (int)threadIdx.x < p.Co)
    slice[(size_t)p.gamma * p.Ci * p.Co + n0 + threadIdx.x] = sb;
}

template <typename K>
cudaError_t prepare(K kernel, int smem_bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <bool AFF, bool VM, int WN>
cudaError_t gemm_fwd(const GemmArgs& a, int smem, cudaStream_t st) {
  constexpr int BM = 32 * (8 / WN), BN = 32 * WN;
  auto kernel = tap_gemm_kernel<AFF, VM, false, WN>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long R = (long long)a.V * a.N * a.T_out;
  dim3 grid((unsigned)((R + BM - 1) / BM), (a.N_out + BN - 1) / BN, 1);
  kernel<<<grid, tap::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool AFF, bool VM, int WN>
cudaError_t gemm_dx(const GemmArgs& a, int smem, cudaStream_t st) {
  constexpr int BN = 32 * WN;
  auto kernel = tap_gemm_kernel<AFF, VM, true, WN>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.tiles_x, (a.N_out + BN - 1) / BN, a.stride);
  kernel<<<grid, tap::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool AFF, bool VM, int NJ>
cudaError_t dwt(const DwtArgs& a, int splits, int smem, cudaStream_t st) {
  constexpr int BM = 64, BN = 32 * NJ;
  auto kernel = tap_dwt_kernel<AFF, VM, NJ>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.gamma * ((a.Ci + BM - 1) / BM), (a.Co + BN - 1) / BN, splits);
  kernel<<<grid, tap::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// WN (warps along N) is 2 or 4: N tiles of 64 or 128 channels.
template <bool AFF, bool VM>
cudaError_t forward(const GemmArgs& a, int wn, int smem, cudaStream_t st) {
  return wn == 4 ? gemm_fwd<AFF, VM, 4>(a, smem, st)
                 : gemm_fwd<AFF, VM, 2>(a, smem, st);
}

// dWt's NJ (2 or 4): N tiles of 64 or 128 channels.
template <bool AFF, bool VM>
cudaError_t backward(const GemmArgs& dx, int wn_dx, int dx_smem,
                     const DwtArgs& dw, int nj_dw, int dw_smem, int splits,
                     float* grads, cudaStream_t st) {
  cudaError_t err = wn_dx == 4 ? gemm_dx<AFF, VM, 4>(dx, dx_smem, st)
                               : gemm_dx<AFF, VM, 2>(dx, dx_smem, st);
  if (err != cudaSuccess) return err;
  err = nj_dw == 4 ? dwt<AFF, VM, 4>(dw, splits, dw_smem, st)
                   : dwt<AFF, VM, 2>(dw, splits, dw_smem, st);
  if (err != cudaSuccess) return err;
  const long long E = (long long)dw.gamma * dw.Ci * dw.Co + dw.Co;
  err = train::launch_reduce(dw.partial, grads, splits, E, st);
  if (err != cudaSuccess || !AFF) return err;
  return train::launch_reduce_columns(dx.partial, grads + E,
                                     dx.stride * dx.tiles_x, 2 * dx.N_out,
                                     st);
}

}  // namespace mma_path

// ---- C interface -----------------------------------------------------------
// The float32 launchers run the scalar kernels.
extern "C" int temporal_block_fwd_launch(
    const void* z, const void* s2, const void* t2, const void* wt,
    const void* bt, void* out, int V, int N, int T, int C, int gamma,
    int stride, int T_out, int tt, int vg, int relu2, int smem_bytes,
    void* stream) {
  if (bad_fwd_args(tt, vg, stride, T_out)) return (int)cudaErrorInvalidValue;
  const Dims d =
      make_dims(V, N, T, C, C, gamma, stride, T_out, tt, vg, relu2, 1);
  return (int)fwd<float, true>(z, s2, t2, wt, bt, out, d, smem_bytes,
                               static_cast<cudaStream_t>(stream));
}

// grads: float32 [dWt | dbt | ds2 | dt2], the sums of the CTAs' slices of
// partial (ctas slices of the same layout).
extern "C" int temporal_block_bwd_launch(
    const void* z, const void* g, const void* s2, const void* t2,
    const void* wtT, void* dz, void* partial, void* grads, int V, int N,
    int T, int C, int gamma, int stride, int T_out, int ft, int vg, int ctas,
    int relu2, int smem_bytes, void* stream) {
  if (bad_bwd_args(V, N, T, ft, vg, stride, ctas))
    return (int)cudaErrorInvalidValue;
  const Dims d =
      make_dims(V, N, T, C, C, gamma, stride, T_out, ft, vg, relu2, 1);
  return (int)bwd<float, true>(z, g, s2, t2, wtT, dz, partial, grads, ctas,
                               d, smem_bytes,
                               static_cast<cudaStream_t>(stream));
}

// The plain temporal convolution: vmajor = 1 for (V, N, T, C) tensors
// (pass V = R, N = 1 for (R, T, C)), 0 for (N, T, V, C) ones.
extern "C" int temporal_conv_fwd_launch(
    const void* x, const void* w, const void* b, void* out, int V, int N,
    int T, int C_in, int C_out, int gamma, int stride, int T_out, int tt,
    int vg, int vmajor, int smem_bytes, void* stream) {
  if (bad_fwd_args(tt, vg, stride, T_out)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, N, T, C_in, C_out, gamma, stride, T_out, tt,
                           vg, 0, vmajor);
  return (int)fwd<float, false>(x, nullptr, nullptr, w, b, out, d,
                                smem_bytes, static_cast<cudaStream_t>(stream));
}

// grads: float32 [dW | db], the sums of the CTAs' slices of partial.
extern "C" int temporal_conv_bwd_launch(
    const void* x, const void* g, const void* wT, void* dx, void* partial,
    void* grads, int V, int N, int T, int C_in, int C_out, int gamma,
    int stride, int T_out, int ft, int vg, int ctas, int vmajor,
    int smem_bytes, void* stream) {
  if (bad_bwd_args(V, N, T, ft, vg, stride, ctas))
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, N, T, C_in, C_out, gamma, stride, T_out, ft,
                           vg, 0, vmajor);
  return (int)bwd<float, false>(x, g, nullptr, nullptr, wT, dx, partial,
                                grads, ctas, d, smem_bytes,
                                static_cast<cudaStream_t>(stream));
}

// The bf16 launchers run the tensor-core kernels, for both ops: aff = 1
// is temporal_block (V-major z, the affine and ReLU), aff = 0
// temporal_conv (vmajor picks the layout; s2, t2 unused).  wn (2 or 4)
// sets the N tile of 64 or 128 channels, as temporal_block.py plan_mma
// gives it with the shared bytes.
extern "C" int temporal_mma_fwd_launch(
    const void* x, const void* s2, const void* t2, const void* wt,
    const void* bt, void* out, int V, int N, int T, int C_in, int C_out,
    int gamma, int stride, int aff, int relu2, int vmajor, int wn,
    int smem_bytes, void* stream) {
  if (stride < 1 || gamma < 1 || gamma % 2 == 0 || (wn != 2 && wn != 4) ||
      (long long)V * N * T >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  mma_path::GemmArgs a{};
  a.x = static_cast<const tap::bf16*>(x);
  a.s2 = static_cast<const float*>(s2);
  a.t2 = static_cast<const float*>(t2);
  a.w = static_cast<const tap::bf16*>(wt);
  a.bias = static_cast<const float*>(bt);
  a.out = static_cast<tap::bf16*>(out);
  a.V = V;
  a.N = N;
  a.T = T;
  a.pad = (gamma - 1) / 2;
  a.T_out = (T + 2 * a.pad - gamma) / stride + 1;
  a.K_in = C_in;
  a.N_out = C_out;
  a.gamma = gamma;
  a.stride = stride;
  a.relu2 = relu2;
  if (a.T_out < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (aff)
    err = mma_path::forward<true, true>(a, wn, smem_bytes, s);
  else if (vmajor)
    err = mma_path::forward<false, true>(a, wn, smem_bytes, s);
  else
    err = mma_path::forward<false, false>(a, wn, smem_bytes, s);
  return (int)err;
}

// One op call's backward: the dx kernel (tiles_x row tiles per input-frame
// parity, partial_dx its [stride * tiles_x][2 * C_in] ds2 | dt2 slices,
// aff only), the dWt kernel (splits slices of split_rows rows in
// partial_dw, each [gamma * C_in * C_out | C_out]; N tiles of 32 * nj_dw
// channels) and the passes that sum the slices in order into grads =
// [dWt | dbt (| ds2 | dt2)].  Rows (V * N * T) must fit in an int.
extern "C" int temporal_mma_bwd_launch(
    const void* x, const void* g, const void* s2, const void* t2,
    const void* wtT, void* dx, void* partial_dw, void* partial_dx,
    void* grads, int V, int N, int T, int C_in, int C_out, int gamma,
    int stride, int aff, int relu2, int vmajor, int wn_dx, int tiles_x,
    int dx_smem, int nj_dw, int splits, int split_rows, int dw_smem,
    void* stream) {
  const int pad = (gamma - 1) / 2;
  const int T_out = (T + 2 * pad - gamma) / stride + 1;
  const long long lines = (long long)V * N;
  const long long dx_rows = lines * ((T + stride - 1) / stride);
  if (stride < 1 || gamma < 1 || gamma % 2 == 0 || T_out < 1 ||
      lines * T >= (1LL << 31) || (wn_dx != 2 && wn_dx != 4) ||
      (nj_dw != 2 && nj_dw != 4) || splits < 1 || split_rows < 1 ||
      (long long)splits * split_rows < lines * T_out ||
      (long long)tiles_x * (32 * (8 / wn_dx)) < dx_rows)
    return (int)cudaErrorInvalidValue;
  mma_path::GemmArgs a{};
  a.x = static_cast<const tap::bf16*>(g);
  a.z = static_cast<const tap::bf16*>(x);
  a.s2 = static_cast<const float*>(s2);
  a.t2 = static_cast<const float*>(t2);
  a.w = static_cast<const tap::bf16*>(wtT);
  a.out = static_cast<tap::bf16*>(dx);
  a.partial = static_cast<float*>(partial_dx);
  a.V = V;
  a.N = N;
  a.T = T;
  a.T_out = T_out;
  a.K_in = C_out;
  a.N_out = C_in;
  a.gamma = gamma;
  a.stride = stride;
  a.pad = pad;
  a.relu2 = relu2;
  a.tiles_x = tiles_x;
  mma_path::DwtArgs w{};
  w.z = static_cast<const tap::bf16*>(x);
  w.g = static_cast<const tap::bf16*>(g);
  w.s2 = static_cast<const float*>(s2);
  w.t2 = static_cast<const float*>(t2);
  w.partial = static_cast<float*>(partial_dw);
  w.V = V;
  w.N = N;
  w.T = T;
  w.T_out = T_out;
  w.Ci = C_in;
  w.Co = C_out;
  w.gamma = gamma;
  w.stride = stride;
  w.pad = pad;
  w.relu2 = relu2;
  w.split_rows = split_rows;
  float* out = static_cast<float*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (aff)
    err = mma_path::backward<true, true>(a, wn_dx, dx_smem, w, nj_dw,
                                         dw_smem, splits, out, s);
  else if (vmajor)
    err = mma_path::backward<false, true>(a, wn_dx, dx_smem, w, nj_dw,
                                          dw_smem, splits, out, s);
  else
    err = mma_path::backward<false, false>(a, wn_dx, dx_smem, w, nj_dw,
                                           dw_smem, splits, out, s);
  return (int)err;
}
