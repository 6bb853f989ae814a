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
// activation dtype T; sums in float32; pad = (gamma - 1) / 2 for
// temporal_block, the caller's 0 <= pad <= (gamma - 1) / 2 for temporal_conv
// (0: the valid conv of a time shard's slab with its halo); AFF only in
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
// recomputes both per block.)  So the tensor cores bound every block, and
// what keeps a kernel from them is feeding them: operands read again from
// L2, barriers, latency that nothing overlaps, and the epilogue.
//
// Design, bf16 (every main path): Hopper's warpgroup MMA (wgmma.cuh).
//   * Forward: an implicit GEMM, M = the (joint line, output frame) rows,
//     N = C_out, K = gamma x C_in.  A CTA owns 128 rows and the whole
//     C_out up to 256 (so its input rows are staged, and their affine
//     computed, once): a producer warpgroup and two consumer warpgroups of
//     64 rows each, registers moved to the consumers with setmaxnreg (two
//     CTAs an SM at N = 64).  Rows are flattened with the frame fastest,
//     so a tile of 128 rows needs about 128*s + gamma - s input frames of
//     one to three lines (the halo): every thread stages them once as bf16
//     with cp.async [, then applies the affine, the ReLU and the rounding
//     in place, which gives exactly zh], while TMA already brings the
//     first weight stages.  Each row reads tap i at its staged row offset
//     + i: wgmma takes A from registers (ldmatrix at each row's own
//     address, which no shared-memory descriptor could express), m64nNk16.
//     B, the weights of one tap and 64 input channels (32 where a ring of
//     64 would hold fewer than three stages), comes by TMA into a ring of
//     2-4 128B-swizzled stages with full and empty mbarriers: no CTA-wide
//     barrier per chunk, and each A fragment feeds a whole N = 256 row.
//     The epilogue adds bt, rounds and stores; the per-column constants
//     wait in shared memory, so no load waits behind a store.
//   * dx: the same GEMM on g and WtT.  At stride s the input frames split
//     by parity p = f mod s: frame f = j*s + p takes only the taps with
//     t*s - pad + tap = f, tap = tap0 + i*s, over the contiguous g rows
//     t = j + e0 - i; for gamma = 9, pad = 4, s = 2 even frames take taps
//     0,2,4,6,8 and odd frames taps 1,3,5,7, so no product with a zero row
//     is left.  [The epilogue recomputes the pre-activation from z, masks
//     by the ReLU, writes dz = round(dpre * s2) and zh = round(relu(pre))
//     for dWt, and adds the column sums of dpre * z and dpre of its rows
//     into its CTA's slice (the eight warps' sums in order); z comes in and
//     dz, zh go out through shared memory in whole 16-byte pieces of
//     rows.]  Frames no tap reaches get dz = 0 from zero-filled g rows.
//   * dWt: dWt_tap = zh_shifted^T . g, K = the N*T_out*V rows, split
//     across CTAs (one an SM) into float32 partial slices summed in slice
//     order.  A CTA owns 64 x 64 channels and up to 9 taps: its producer
//     stages each chunk of 128 g rows and the zh frames their taps read
//     once, by TMA (V-major; each line's frames in 8-row boxes) or
//     cp.async, into a ring of 2-4 stages; three consumer warpgroups take
//     three taps each from that staging (A = zh^T by ldmatrix.trans at the
//     rows' offsets + tap, B = g swizzled), so at C = 256 each zh row is
//     staged 4 times (once per C_out tile) and each g row 4 times (once
//     per C_in tile).  [zh is the dx kernel's.]  dbt, the column sum of
//     g, is taken from the same
//     stages by the CTAs of the first tap group and channel tile.
//   The wrapper's backward is one op call: dx, dWt and the reduction
//   passes are launched together.
//   Any channel count runs: K and N tails are zero-filled (TMA's
//   out-of-bounds fill, or the copies' zero fill), and weights or rows
//   without 16-byte strides (C % 8 != 0) go through plain loads into the
//   same swizzled layouts.
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
// plan_backward, plan_mma_forward and plan_mma_backward, temporal_conv.py
// plan_conv).
//
// Launch contract (checked by the Python wrappers): z, g, Wt in T; s2, t2
// (AFF only) and bt float32; Wt is (gamma, C_in, C_out) and WtT
// (gamma, C_out, C_in); the dynamic shared memory the planners give.  Each
// launcher returns cudaGetLastError() after its launches.

#include "tap_mma.cuh"
#include "tile_rows.cuh"
#include "wgmma.cuh"
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
    // sit at gu rows G-1-pad .. G-1-pad + fc - 1 (every output row has
    // t*s < T, since 2 pad <= G - 1)
    const int l0 = G - 1 - d.pad;
    for (int o = threadIdx.x; o < Co; o += blockDim.x) {
      float sb = 0.f;
      for (int l = l0; l < l0 + fc; ++l)
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
               int pad, int T_out, int tile, int vg, int relu2, int vmajor) {
  Dims d;
  d.V = V;
  d.N = N;
  d.T = T;
  d.Ci = Ci;
  d.Co = Co;
  d.gamma = gamma;
  d.stride = stride;
  d.pad = pad;
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

// A padding the kernels take: 0 <= pad <= (gamma - 1) / 2, so that every
// output row t has t*s < T (the backward's dbt ownership).
inline bool bad_pad(int gamma, int pad) {
  return pad < 0 || 2 * pad > gamma - 1;
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

// ---- bf16: the warpgroup kernels (wgmma.cuh) --------------------------------
namespace mma_path {

using namespace tile_rows;
using tap::bf16;
constexpr int BM = 128;             // GEMM rows of a tile: 2 warpgroups x 64
constexpr int KC = wg::kBoxRows;    // input channels of a ring stage (64),
                                    // or 32 where a deeper ring needs it
constexpr int kGemmThreads = 384;   // a producer warpgroup, 2 consumers
constexpr int kMaxStages = 4;

// Registers of the GEMM kernel by N tile: two CTAs an SM at N = 64, else
// one; setmaxnreg moves the producer's share to the consumers (one CTA:
// 128 * 40 + 256 * 232 = 64,512 of 65,536; two: 128 * 24 + 256 * 104 =
// 29,696 of the 30,720 a CTA launches with at 80 a thread).
template <int BN>
struct GemmRegs {
  static constexpr int ctas = BN == 64 ? 2 : 1;
  static constexpr int producer = BN == 64 ? 24 : 40;
  static constexpr int consumer = BN == 64 ? 104 : 232;
};
constexpr int DW_KR = 128;          // dWt: GEMM K rows (rows of g) a chunk
constexpr int DW_BM = 64;           // dWt: input channels of a CTA (wgmma M)
constexpr int DW_BN = 64;           // dWt: output channels of a CTA (N)
constexpr int kDwConsumers = 3;     // consumer warpgroups of the dWt kernel
constexpr int DW_TPW = 3;           // taps a consumer warpgroup
constexpr int DW_TAPS = kDwConsumers * DW_TPW;  // taps of a CTA
constexpr int DW_GBYTES = DW_KR * 128;  // g of a stage: swizzled, 16 KB
constexpr int kDwtThreads = 128 * (1 + kDwConsumers);
// 128 * 56 + 384 * 152 = 65,536
constexpr int kDwProducerRegs = 56, kDwConsumerRegs = 152;

// The most zh rows a dWt chunk stages (temporal_block.py dwt_rows): as
// staged_rows, with each line's frames padded to 8 rows.
__host__ __device__ inline int dwt_rows(int per_line, int walk, int ntap) {
  int seg = (DW_KR - 1 + per_line - 1) / per_line + 1;
  if (seg > DW_KR) seg = DW_KR;
  return staged_rows(DW_KR, per_line, walk, ntap) + 7 * seg;
}

// Shared bytes of the GEMM kernel (temporal_block.py gemm_smem): the
// alignment slack, the ring (stages of kc input channels) and its
// barriers, the row offsets, [the column sums of dx with AFF,] the
// epilogue's per-column constants, the staged rows.
inline int gemm_smem(int bn, int kc, int stages, int staged, int k_in,
                     bool dx_aff) {
  return wg::kAtomBytes + stages * (bn * kc * 2 + 16) + 4 * BM +
         (dx_aff ? 2 * 8 * bn * 4 : 0) + 2 * bn * 4 +
         staged * tap::pitch_of(k_in) * 2;
}

// A dWt stage: g's DW_KR rows, then the zrows staged zh rows, both in
// 128-byte rows of 64 channels, 128B-swizzled, each starting on a swizzle
// atom; then the rows' offsets.  Whole atoms, so every stage starts
// aligned.
__host__ __device__ inline int dw_zh_bytes(int zrows) {
  return round_up(zrows * 128, wg::kAtomBytes);
}
__host__ __device__ inline int dw_stage_bytes(int zrows) {
  return round_up(DW_GBYTES + dw_zh_bytes(zrows) + 4 * DW_KR,
                  wg::kAtomBytes);
}
inline int dwt_smem(int zrows, int stages) {  // temporal_block.py dwt_smem
  return wg::kAtomBytes + stages * (dw_stage_bytes(zrows) + 16) + 128 * 8 * 4;
}

struct GemmArgs {
  CUtensorMap wmap;   // the weights' TMA map, when tma
  const bf16* x;      // the GEMM's input rows: z (forward) or g (dx)
  const bf16* z;      // dx with AFF: the op's input, for the epilogue
  const float* s2;    // AFF
  const float* t2;    // AFF
  const bf16* w;      // (gamma, K_in, N_out): Wt (forward) or WtT (dx)
  const float* bias;  // forward: bt
  bf16* out;          // forward: u (T_out frames); dx: dz (T frames)
  bf16* zh;           // dx with AFF: zh of every input row, for dWt
  float* partial;     // dx with AFF: [slice][ds2 (N_out) | dt2 (N_out)]
  int V, N, T, T_out, K_in, N_out, gamma, stride, pad, relu2, tiles_x,
      stages, kc, tma;
};

// The forward (DX false) or one input-frame parity of dx (DX true,
// parity blockIdx.z) as an implicit GEMM.  A CTA owns BM = 128 rows of
// the flattened (line, output frame) rows and BN output channels (the
// whole C_out up to 256); warpgroup 0 produces the weight ring, 1 and 2
// each compute 64 rows with wgmma m64nBNk16.  Every thread stages the
// tile's input frames first (A, read by ldmatrix at each row's offset
// plus the tap's shift) while TMA brings the ring's first stages; the
// weights stream in chunks of kc input channels of one tap.
template <bool AFF, bool VM, bool DX, int BN>
__global__ void __launch_bounds__(kGemmThreads, GemmRegs<BN>::ctas)
tap_gemm_kernel(const __grid_constant__ GemmArgs p) {
  constexpr int NB = BN / wg::kBoxCols;  // 64-column tiles of a stage
  const int kc = p.kc;
  const int box = kc * 128;              // bytes of a 64-column tile
  const int STAGE = NB * box;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = wg::align_atom(smem_raw);   // [stages][NB][kc][64]
  const int nst = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * STAGE);
  uint64_t* empty = full + nst;
  int* rowoff = reinterpret_cast<int*>(empty + nst);         // [BM]
  float* red = reinterpret_cast<float*>(rowoff + BM);        // [2][8][BN]
  // the epilogue's columns: bt (forward), or s2 and t2 (dx with AFF)
  float* cvec = red + (DX && AFF ? 2 * 8 * BN : 0);          // [2][BN]
  bf16* as = reinterpret_cast<bf16*>(cvec + 2 * BN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
      for (int t = tid; t < BN; t += blockDim.x)
        if (n0 + t < p.N_out) {
          p.partial[slice + n0 + t] = 0.f;
          p.partial[slice + p.N_out + n0 + t] = 0.f;
        }
    }
    return;
  }
  const int Kp = tap::round16(p.K_in);
  const int AP = Kp + tap::kPad;
  const int nkc = (Kp + kc - 1) / kc;
  const int nchunks = ntap * nkc;
  const uint32_t ring_u = wg::smem_u32(ring);
  // TMA of chunk ch into its stage: tap i's kc input channels from k0
  auto tma_chunk = [&](int ch) {
    const int st = ch % nst;
    const int i = ch / nkc;
    const uint32_t fb = wg::smem_u32(full + st);
    wg::mbar_expect_tx(fb, STAGE);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      wg::tma_load_3d(ring_u + st * STAGE + j * box, &p.wmap, fb,
                      n0 + j * wg::kBoxCols, (ch - i * nkc) * kc,
                      tap0 + i * tstep);
  };
  int issued = 0;  // chunks whose TMA went out before the rows' staging
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), 8);  // the 8 consumer warps
    }
    wg::fence_barrier_init();
    if (p.tma) {
      issued = min(nst, nchunks);
      for (int ch = 0; ch < issued; ++ch) tma_chunk(ch);
    }
  }
  Tile tl;
  tl.init(r0, BM, R, J, walk, ntap, off0);
  for (int r = tid; r < BM; r += blockDim.x) rowoff[r] = tl.rowoff(r);
  for (int t = tid; t < BN; t += blockDim.x) {
    const bool in = n0 + t < p.N_out;
    if constexpr (!DX) {
      cvec[t] = in ? p.bias[n0 + t] : 0.f;
    } else if constexpr (AFF) {
      cvec[t] = in ? p.s2[n0 + t] : 0.f;
      cvec[BN + t] = in ? p.t2[n0 + t] : 0.f;
    }
  }
  stage_rows<AFF && !DX, VM>(as, AP, tl, p.x, Tx, p.K_in, 0, Kp, p.s2, p.t2,
                             p.relu2, p.V, tid, blockDim.x);
  __syncthreads();

  if (warp < 4) {  // ---- producer: the weight ring ----
    wg::setmaxnreg_dec<GemmRegs<BN>::producer>();
    for (int ch = issued; ch < nchunks; ++ch) {
      const int st = ch % nst;
      const int i = ch / nkc;
      const int k0 = (ch - i * nkc) * kc;
      const int wtap = tap0 + i * tstep;
      const uint32_t fb = wg::smem_u32(full + st);
      if (p.tma) {
        if (tid == 0) {
          if (ch >= nst)
            wg::mbar_wait(wg::smem_u32(empty + st), ((ch / nst) & 1) ^ 1);
          tma_chunk(ch);
        }
      } else {  // weights TMA cannot read: plain loads, same layout
        if (ch >= nst)
          wg::mbar_wait(wg::smem_u32(empty + st), ((ch / nst) & 1) ^ 1);
        for (int e = tid; e < NB * kc * 8; e += 128) {
          const int j = e / (kc * 8);
          const int kr = (e / 8) % kc;
          const int c8 = e % 8;
          const int k = k0 + kr;
          const int n = n0 + j * wg::kBoxCols + c8 * 8;
          alignas(16) bf16 v[8];
          const bf16* src = p.w + ((size_t)wtap * p.K_in + k) * p.N_out + n;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = (k < p.K_in && n + q < p.N_out) ? src[q]
                                                   : __float2bfloat16_rn(0.f);
          *reinterpret_cast<uint4*>(ring + st * STAGE + j * box +
                                    wg::sw128(kr, c8)) =
              *reinterpret_cast<const uint4*>(v);
        }
        wg::fence_proxy_async();
        wg::named_sync(1, 128);
        if (tid == 0) wg::mbar_arrive(fb);
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, rows 64 * cw .. ----
  wg::setmaxnreg_inc<GemmRegs<BN>::consumer>();
  const int cw = warp / 4 - 1;
  const int wi = warp & 3;
  const int my_off = rowoff[cw * 64 + wi * 16 + tap::a_lane_row(lane)];
  const uint32_t a_base =
      wg::smem_u32(as) + (uint32_t)(tap::lane_col8(lane) * 2);
  float acc[BN / 2];
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
  uint32_t fa[2][KC / 16][4];
  // One chunk: A fragments by ldmatrix, then the k16 steps as one wgmma
  // group; the group before it is waited for, and its stage released.
  auto chunk = [&](int ch, uint32_t(&a)[KC / 16][4]) {
    const int st = ch % nst;
    const int i = ch / nkc;
    const int k0 = (ch - i * nkc) * kc;
    const int shift = DX ? ntap - 1 - i : i;
    const int steps = min(kc, Kp - k0) / 16;
    const uint32_t arow = a_base + (uint32_t)(((my_off + shift) * AP + k0) * 2);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      if (kk < steps) tap::ldsm_x4(a[kk], arow + kk * 32);
    wg::mbar_wait(wg::smem_u32(full + st), (ch / nst) & 1);
    const uint64_t desc = wg::desc_sw128(ring_u + st * STAGE, box);
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      if (kk < steps) wg::mma_rs<BN>(acc, a[kk], wg::desc_step(desc, kk));
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
  // n0 + 8 jn + 2 (lane & 3) + q; -1 marks a row past the tile's end.
  const int rbase = cw * 64 + wi * 16 + (lane >> 2);
  long long base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    base[h] = -1;
    if (r < tl.rows) {
      const int gr = r0 + r;
      const int l = gr / J;
      const int j = gr - l * J;
      base[h] = (long long)line_at<VM>(l, j * ostride + par, To, p.N_out, p.V);
    }
  }
  // dx with AFF and whole 16-byte pieces of rows (N_out % 8 == 0): z comes
  // in, and dz and zh go out, through shared memory in coalesced pieces
  // rather than as each thread's scattered pairs: z into the ring's bytes
  // (then dz over it, in place), zh into the staged rows', both at pitch
  // AP (dx with AFF is square, so AP covers N_out).  `tiled` says so.  At
  // N = 256 the direct pairs measured faster on the H100 (PERF.md).
  bool tiled = false;
  bf16* ztile = reinterpret_cast<bf16*>(ring);
  bf16* htile = as;
  const int ct = tid - 128;  // this thread among the 256 consumers
  auto tile_pieces = [&](auto&& piece) {
    for (int e = ct; e < BM * (BN / 8); e += 256) {
      const int r = e / (BN / 8);
      const int c = (e - r * (BN / 8)) * 8;
      if (rowoff[r] >= 0 && n0 + c < p.N_out) piece(r, c, rowoff[r]);
    }
  };
  if constexpr (DX && AFF) {
    tiled = BN <= 128 && p.N_out % 8 == 0 && nst * STAGE >= BM * AP * 2 &&
            ((reinterpret_cast<uintptr_t>(p.z) |
              reinterpret_cast<uintptr_t>(p.out) |
              reinterpret_cast<uintptr_t>(p.zh)) & 15) == 0;
    if (tiled) {
      wg::named_sync(2, 256);  // both warpgroups are done with the ring
      if (ct < BM) {           // each row's index in (rows, N_out)
        int ri = -1;
        if (ct < tl.rows) {
          const int gr = r0 + ct;
          const int l = gr / J;
          ri = (int)(line_at<VM>(l, (gr - l * J) * ostride + par, To, 1,
                                 p.V));
        }
        rowoff[ct] = ri;
      }
      wg::named_sync(2, 256);
      tile_pieces([&](int r, int c, int ri) {
        tap::cp_async16(tap::smem_u32(ztile + r * AP + c),
                        p.z + (size_t)ri * p.N_out + n0 + c, 16);
      });
      tap::cp_async_commit();
      tap::cp_async_wait<0>();
      wg::named_sync(2, 256);
    }
  }
  // Groups of eight n8 blocks (64 columns).  With AFF, a group's z values
  // are loaded first, all at once (read-only loads, so none waits on the
  // stores before it), and dx's column sums of dpre * z and dpre taken
  // over the group: the thread's two rows, then the warp's eight row
  // groups (lane bits 4, 3, 2) by halving exchanges, after which lane group
  // lane >> 2 holds block 8 jg + (lane >> 2)'s sums.
  const int col0 = n0 + 2 * (lane & 3);
  const bool even = p.N_out % 2 == 0;
#pragma unroll
  for (int jg = 0; jg < BN / 64; ++jg) {
    float part[32];  // [block jl][dpre z col 0, col 1, dpre col 0, col 1]
    float2 zg[8][2];  // dx with AFF: z of the group's columns, both rows
    if constexpr (DX && AFF) {
#pragma unroll
      for (int jl = 0; jl < 8; ++jl) {
        const int o = col0 + (jg * 8 + jl) * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          zg[jl][h] = make_float2(0.f, 0.f);
          if (base[h] < 0) continue;
          if (tiled) {
            if (o < p.N_out)
              zg[jl][h] = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      ztile + (rbase + 8 * h) * AP + (o - n0)));
            continue;
          }
          const bf16* zr = p.z + base[h] + o;
          if (o + 1 < p.N_out && even) {
            zg[jl][h] = __bfloat1622float2(
                __ldg(reinterpret_cast<const __nv_bfloat162*>(zr)));
          } else if (o < p.N_out) {
            zg[jl][h].x = __bfloat162float(__ldg(zr));
          }
        }
      }
    }
#pragma unroll
    for (int jl = 0; jl < 8; ++jl) {
      const int jn = jg * 8 + jl;
      const int o = col0 + jn * 8;
      const bool pair = o + 1 < p.N_out && even;
      const int cl = o - n0;  // the column within the tile
      float cs[2] = {0.f, 0.f}, ct[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (base[h] >= 0) {
          float v[2] = {acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]};
          if constexpr (!DX) {
            v[0] += cvec[cl];
            v[1] += cvec[cl + 1];
          } else if constexpr (AFF) {
            const float zv[2] = {zg[jl][h].x, zg[jl][h].y};
            float hv[2];  // zh = round([relu](pre)), the dWt kernel's input
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float sc = cvec[cl + q];
              const float pre = tap::affine(zv[q], sc, cvec[BN + cl + q]);
              const float dp = (p.relu2 && !(pre > 0.f)) ? 0.f : v[q];
              cs[q] += dp * zv[q];
              ct[q] += dp;
              v[q] = dp * sc;
              hv[q] = p.relu2 ? fmaxf(pre, 0.f) : pre;
            }
            if (tiled) {  // both in the tiles, stored below
              if (o < p.N_out) {
                const int at = (rbase + 8 * h) * AP + cl;
                *reinterpret_cast<__nv_bfloat162*>(htile + at) =
                    __floats2bfloat162_rn(hv[0], hv[1]);
                *reinterpret_cast<__nv_bfloat162*>(ztile + at) =
                    __floats2bfloat162_rn(v[0], v[1]);
              }
              continue;
            }
            store2(p.zh + base[h] + o, hv, o, p.N_out, pair);
          }
          store2(p.out + base[h] + o, v, o, p.N_out, pair);
        }
      }
      part[4 * jl] = cs[0];
      part[4 * jl + 1] = cs[1];
      part[4 * jl + 2] = ct[0];
      part[4 * jl + 3] = ct[1];
    }
    if constexpr (DX && AFF) {
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
  if constexpr (DX && AFF) {  // then the eight warps in order
    wg::named_sync(2, 256);
    if (tiled) {  // dz and zh out of the tiles, in whole pieces
      tile_pieces([&](int r, int c, int ri) {
        const size_t at = (size_t)ri * p.N_out + n0 + c;
        *reinterpret_cast<uint4*>(p.out + at) =
            *reinterpret_cast<const uint4*>(ztile + r * AP + c);
        *reinterpret_cast<uint4*>(p.zh + at) =
            *reinterpret_cast<const uint4*>(htile + r * AP + c);
      });
    }
    for (int t = tid - 128; t < BN; t += 256) {
      if (n0 + t >= p.N_out) continue;
      float a = 0.f, b = 0.f;
      for (int w = 0; w < 8; ++w) {
        a += red[w * BN + t];
        b += red[(8 + w) * BN + t];
      }
      p.partial[slice + n0 + t] = a;
      p.partial[slice + p.N_out + n0 + t] = b;
    }
  }
}

struct DwtArgs {
  CUtensorMap gmap;  // tma: g as (C_out, rows), 64 x DW_KR boxes
  CUtensorMap zmap;  // tma: zh as (C_in, T, lines), 64 x 8 x 1 boxes
  const bf16* zh;    // the taps' input (V-major or (N, T, V, C)), C_in: the
                     // op's input, or with the affine the dx kernel's zh
  const bf16* g;     // dL/du, C_out
  float* partial;    // [split][gamma*C_in*C_out (dWt) | C_out (dbt)]
  int V, N, T, T_out, Ci, Co, gamma, stride, pad, split_rows, zrows, stages,
      tma;
};

// dWt_tap[c, o] = sum over rows (line, t) of zh[line, t*s - pad + tap][c]
// * g[line, t][o].  A CTA owns DW_BM input channels, DW_BN output
// channels, up to DW_TAPS taps and one split of the rows.  Its producer
// warpgroup stages each chunk of DW_KR rows once, into a ring of 3-4
// stages: the rows of g (swizzled, the wgmma B) and the zh frames those
// rows' taps read (the chunk plus its halo, each line's frames from a
// multiple of 8 rows), with each row's offset.  V-major tensors with
// 16-byte rows go through TMA: one warp computes the offsets and one
// thread issues a box of g and 8-row boxes of zh per line, zero-filled
// outside the frames; two more warps sum g's columns (dbt) from the
// stages.  Otherwise the warpgroup copies with cp.async, nst - 2 chunks
// ahead of the one it publishes.  Each of the three consumer warpgroups
// computes three taps from that one staging: A = zh^T by ldmatrix.trans at
// the rows' offsets plus the tap, m64n64k16.  With the affine, zh comes
// from the dx kernel's epilogue, which has every input row's
// pre-activation at hand, so staging is the same copy for both ops.
template <bool VM>
__global__ void __launch_bounds__(kDwtThreads, 1)
tap_dwt_kernel(const __grid_constant__ DwtArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = wg::align_atom(smem_raw);
  const int stage_bytes = dw_stage_bytes(p.zrows);
  const int nst = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + nst * stage_bytes);
  uint64_t* empty = full + nst;
  float* red = reinterpret_cast<float*>(empty + nst);  // [128][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nct = (p.Ci + DW_BM - 1) / DW_BM;
  const int tg = blockIdx.x / nct;
  const int c0 = (blockIdx.x - tg * nct) * DW_BM;
  const int tap_lo = tg * DW_TAPS;
  const int ntap = min(DW_TAPS, p.gamma - tap_lo);
  const int n0 = blockIdx.y * DW_BN;
  const int R = p.V * p.N * p.T_out;
  const int k_begin = blockIdx.z * p.split_rows;
  const int k_end = min(R, k_begin + p.split_rows);
  const int nchunks = (k_end - k_begin + DW_KR - 1) / DW_KR;
  const bool do_dbt = tg == 0 && c0 == 0;
  const size_t E = (size_t)p.gamma * p.Ci * p.Co + p.Co;
  float* slice = p.partial + (size_t)blockIdx.z * E;
  // a stage's g, zh and row offsets
  auto g_of = [&](int st) { return stages + st * stage_bytes; };
  auto zh_of = [&](int st) {
    return reinterpret_cast<bf16*>(g_of(st) + DW_GBYTES);
  };
  auto ro_of = [&](int st) {
    return reinterpret_cast<int*>(g_of(st) + DW_GBYTES +
                                  dw_zh_bytes(p.zrows));
  };
  auto chunk_tile = [&](int ch, Tile& tl) {
    tl.init(k_begin + ch * DW_KR, DW_KR, k_end, p.T_out, p.stride, ntap,
            tap_lo - p.pad, true);
  };
  // the consumer warps, and with TMA the two dbt warps, release a stage
  const int releasers = 4 * kDwConsumers + (p.tma && do_dbt ? 2 : 0);
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), releasers);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup ----
    wg::setmaxnreg_dec<kDwProducerRegs>();
    float sb[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) sb[q] = 0.f;
    // dbt's sums: `n` threads from i, each over 16-byte chunk i % 8 of g's
    // rows i / 8, + n / 8, ... of a stage
    auto sum_g = [&](int st, int i, int n) {
      for (int e = i; e < DW_KR * 8; e += n) {
        alignas(16) bf16 v[8];
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(
            g_of(st) + wg::sw128(e / 8, e % 8));
#pragma unroll
        for (int q = 0; q < 8; ++q) sb[q] += __bfloat162float(v[q]);
      }
    };
    // dbt: the 16 (or 8) threads of each chunk column, in order
    auto write_dbt = [&](int i, int n, int bar_id) {
      if (i < n) {
#pragma unroll
        for (int q = 0; q < 8; ++q) red[i * 8 + q] = sb[q];
      }
      wg::named_sync(bar_id, n);
      if (i < DW_BN && n0 + i < p.Co) {
        const int c8 = i / 8, q = i % 8;
        float a = 0.f;
        for (int t = c8; t < n; t += 8) a += red[t * 8 + q];
        slice[(size_t)p.gamma * p.Ci * p.Co + n0 + i] = a;
      }
    };
    if (p.tma) {
      if (warp == 0) {  // the row offsets and the TMA boxes
        for (int ch = 0; ch < nchunks; ++ch) {
          const int st = ch % nst;
          if (ch >= nst)
            wg::mbar_wait(wg::smem_u32(empty + st), ((ch / nst) & 1) ^ 1);
          Tile tl;
          chunk_tile(ch, tl);
          int* ro = ro_of(st);
          for (int r = lane; r < DW_KR; r += 32) ro[r] = tl.rowoff(r);
          __syncwarp();
          if (lane == 0) {
            const uint32_t fb = wg::smem_u32(full + st);
            wg::mbar_expect_tx(fb, DW_GBYTES + (tl.S / 8) * wg::kAtomBytes);
            wg::tma_load_2d(wg::smem_u32(g_of(st)), &p.gmap, fb, n0,
                            k_begin + ch * DW_KR);
            const uint32_t zs = wg::smem_u32(zh_of(st));
            // each line's frames in 8-row boxes
            int sr = 0, line = tl.l0, f = tl.ja0 * tl.walk + tl.off0;
            int len = tl.len_first, lp = tl.lp_first;
            while (sr < tl.S) {
              for (int b = 0; b < len; b += 8)
                wg::tma_load_3d(zs + (sr + b) * 128, &p.zmap, fb, c0, f + b,
                                line);
              sr += lp;
              ++line;
              f = tl.off0;
              len = min(tl.len_full, tl.S - sr);
              lp = tl.lp_full;
            }
          }
        }
      } else if (warp >= 2 && do_dbt) {
        const int i = tid - 64;
        for (int ch = 0; ch < nchunks; ++ch) {
          const int st = ch % nst;
          wg::mbar_wait(wg::smem_u32(full + st), (ch / nst) & 1);
          sum_g(st, i, 64);
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(wg::smem_u32(empty + st));
        }
        write_dbt(i, 64, 1);
      }
      return;
    }
    const bool g_vec =
        p.Co % 8 == 0 && (reinterpret_cast<uintptr_t>(p.g) & 15) == 0;
    // Chunk ch into its stage once the consumers released it: the rows'
    // offsets, then g's rows and the zh rows as one cp.async group (plain
    // loads where rows are not 16-byte aligned).
    auto issue = [&](int ch) {
      const int st = ch % nst;
      unsigned char* sg = g_of(st);
      int* ro = ro_of(st);
      if (ch >= nst)
        wg::mbar_wait(wg::smem_u32(empty + st), ((ch / nst) & 1) ^ 1);
      const int kb = k_begin + ch * DW_KR;
      Tile tl;
      chunk_tile(ch, tl);
      for (int r = tid; r < DW_KR; r += 128) ro[r] = tl.rowoff(r);
      // g: thread tid stages 16-byte chunk c8 = tid % 8 of rows tid / 8,
      // + 16, ..., walking their (line, t)
      const int c8 = tid % 8;
      const int n = n0 + c8 * 8;
      LinePos gp;
      {
        const int gr = kb + tid / 8;
        const int l = gr / p.T_out;
        gp.set(l, gr - l * p.T_out, p.V);
      }
      for (int r = tid / 8; r < DW_KR; r += 16) {
        const bool valid = kb + r < k_end && n < p.Co;
        const bf16* src =
            valid ? p.g + pos_at<VM>(gp, p.T_out, p.Co, p.V) + n : p.g;
        if (g_vec) {
          tap::cp_async16(wg::smem_u32(sg + wg::sw128(r, c8)), src,
                          valid ? 16 : 0);
        } else {
          alignas(16) bf16 v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = valid && n + q < p.Co ? src[q] : __float2bfloat16_rn(0.f);
          *reinterpret_cast<uint4*>(sg + wg::sw128(r, c8)) =
              *reinterpret_cast<const uint4*>(v);
        }
        gp.f += 16;
        while (gp.f >= p.T_out) {
          gp.f -= p.T_out;
          gp.next_line(p.V);
        }
      }
      if (p.Ci % 8 == 0 && (reinterpret_cast<uintptr_t>(p.zh) & 15) == 0)
        copy_rows<VM, true>(zh_of(st), 0, tl, p.zh, p.T, p.Ci, c0, DW_BM,
                            p.V, tid, 128);
      else
        load_rows<false, VM, true>(zh_of(st), 0, tl, p.zh, p.T, p.Ci, c0,
                                   DW_BM, nullptr, nullptr, 0, p.V, tid,
                                   128);
    };
    // Chunk ch, its copies landed: dbt's sums, then the full barrier.
    auto publish = [&](int ch) {
      const int st = ch % nst;
      if (do_dbt) sum_g(st, tid, 128);
      wg::fence_proxy_async();
      wg::named_sync(1, 128);
      if (tid == 0) wg::mbar_arrive(wg::smem_u32(full + st));
    };
    // One cp.async group a chunk (empty ones past the end); chunk ch is
    // published once chunk ch + ahead is issued.  Issuing chunk ch waits
    // for chunk ch - nst, two behind the last one published (a ring of two
    // stages, the shallowest the planner falls back to, runs no chunk
    // ahead).
    const int ahead = nst - 2;
    for (int ch = 0; ch < nchunks + ahead; ++ch) {
      if (ch < nchunks) issue(ch);
      tap::cp_async_commit();
      if (ch >= ahead) {
        if (ahead >= 2)
          tap::cp_async_wait<2>();
        else if (ahead == 1)
          tap::cp_async_wait<1>();
        else
          tap::cp_async_wait<0>();
        publish(ch - ahead);
      }
    }
    if (do_dbt) write_dbt(tid, 128, 1);
    return;
  }

  // ---- consumers: warpgroup cw takes taps tap_lo + cw + 3 i ----
  wg::setmaxnreg_inc<kDwConsumerRegs>();
  const int cw = warp / 4 - 1;
  const int wi = warp & 3;
  float acc[DW_TPW][DW_BN / 2];
#pragma unroll
  for (int i = 0; i < DW_TPW; ++i)
#pragma unroll
    for (int q = 0; q < DW_BN / 2; ++q) acc[i][q] = 0.f;
  // Every warpgroup runs DW_TPW products: a tap past the group's end
  // re-reads the group's first tap and is not stored (a branch around the
  // wgmma would make ptxas serialize them).
  bool mine[DW_TPW];
  int shift[DW_TPW];
#pragma unroll
  for (int i = 0; i < DW_TPW; ++i) {
    mine[i] = cw + kDwConsumers * i < ntap;
    shift[i] = mine[i] ? cw + kDwConsumers * i : 0;
  }
  uint32_t fa[2][DW_TPW][4];
  const int krow = tap::at_lane_row(lane);
  // this lane's 16-byte chunk of a zh row: channels wi * 16 + 0 or 8
  const int zc = wi * 2 + (tap::at_lane_col(lane) >> 3);
  for (int ch = 0; ch < nchunks; ++ch) {
    const int st = ch % nst;
    const int* ro = ro_of(st);
    const uint32_t zs_u = wg::smem_u32(zh_of(st));
    const uint64_t desc = wg::desc_sw128(wg::smem_u32(g_of(st)), DW_GBYTES);
    wg::mbar_wait(wg::smem_u32(full + st), (ch / nst) & 1);
#pragma unroll
    for (int kk = 0; kk < DW_KR / 16; ++kk) {
      const int off = ro[kk * 16 + krow];
#pragma unroll
      for (int i = 0; i < DW_TPW; ++i)
        tap::ldsm_x4_t(fa[kk & 1][i],
                       zs_u + wg::sw128(off + shift[i], zc));
#pragma unroll
      for (int i = 0; i < DW_TPW; ++i) wg::fence_operand(acc[i]);
      wg::fence();
#pragma unroll
      for (int i = 0; i < DW_TPW; ++i)
        wg::mma_rs<DW_BN>(acc[i], fa[kk & 1][i], wg::desc_step(desc, kk));
      wg::commit();
      wg::wait<1>();
    }
    wg::wait<0>();
#pragma unroll
    for (int i = 0; i < DW_TPW; ++i) wg::fence_operand(acc[i]);
    if (lane == 0) wg::mbar_arrive(wg::smem_u32(empty + st));
  }

#pragma unroll
  for (int i = 0; i < DW_TPW; ++i) {
    if (!mine[i]) continue;
    const int tp = tap_lo + cw + kDwConsumers * i;
#pragma unroll
    for (int jn = 0; jn < DW_BN / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wi * 16 + (lane >> 2) + 8 * h;
        const int o = n0 + jn * 8 + 2 * (lane & 3);
        if (c >= p.Ci) continue;
        float* dst = slice + ((size_t)tp * p.Ci + c) * p.Co + o;
        const float v0 = acc[i][4 * jn + 2 * h], v1 = acc[i][4 * jn + 2 * h + 1];
        if (o + 1 < p.Co && p.Co % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (o < p.Co) dst[0] = v0;
          if (o + 1 < p.Co) dst[1] = v1;
        }
      }
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem_bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <bool AFF, bool VM, bool DX, int BN>
cudaError_t gemm(const GemmArgs& a, dim3 grid, int smem, cudaStream_t st) {
  auto kernel = tap_gemm_kernel<AFF, VM, DX, BN>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGemmThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The N tile: 64, 128 or 256 output channels.
template <bool AFF, bool VM, bool DX>
cudaError_t gemm_bn(const GemmArgs& a, int bn, int smem, cudaStream_t st) {
  dim3 grid;
  if constexpr (DX) {
    grid = dim3(a.tiles_x, (a.N_out + bn - 1) / bn, a.stride);
  } else {
    const long long R = (long long)a.V * a.N * a.T_out;
    grid = dim3((unsigned)((R + BM - 1) / BM), (a.N_out + bn - 1) / bn, 1);
  }
  switch (bn) {
    case 64:
      return gemm<AFF, VM, DX, 64>(a, grid, smem, st);
    case 128:
      return gemm<AFF, VM, DX, 128>(a, grid, smem, st);
    default:
      return gemm<AFF, VM, DX, 256>(a, grid, smem, st);
  }
}

template <bool VM>
cudaError_t dwt(const DwtArgs& a, int splits, int smem, cudaStream_t st) {
  auto kernel = tap_dwt_kernel<VM>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((a.gamma + DW_TAPS - 1) / DW_TAPS) * ((a.Ci + DW_BM - 1) / DW_BM),
            (a.Co + DW_BN - 1) / DW_BN, splits);
  kernel<<<grid, kDwtThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool AFF, bool VM>
cudaError_t backward(const GemmArgs& dx, int bn_dx, int dx_smem,
                     const DwtArgs& dw, int splits, int dw_smem,
                     float* grads, cudaStream_t st) {
  cudaError_t err = gemm_bn<AFF, VM, true>(dx, bn_dx, dx_smem, st);
  if (err != cudaSuccess) return err;
  err = dwt<VM>(dw, splits, dw_smem, st);
  if (err != cudaSuccess) return err;
  const long long E = (long long)dw.gamma * dw.Ci * dw.Co + dw.Co;
  err = train::launch_reduce(dw.partial, grads, splits, E, st);
  if (err != cudaSuccess || !AFF) return err;
  return train::launch_reduce_columns(dx.partial, grads + E,
                                     dx.stride * dx.tiles_x, 2 * dx.N_out,
                                     st);
}

// The weights' ring: TMA where it can read them, else plain loads.
inline void weight_source(GemmArgs& a, const void* w, int gamma) {
  a.tma = wg::tma_can_read(w, a.N_out) &&
          wg::encode_weight_map(&a.wmap, w, gamma, a.K_in, a.N_out, a.kc);
}

// dWt's staging: TMA for V-major g and zh with 16-byte rows, over splits
// of whole chunks; else cp.async.
inline void dwt_source(DwtArgs& a, bool vmajor) {
  const cuuint64_t lines = (cuuint64_t)a.V * a.N;
  const cuuint64_t gdims[2] = {(cuuint64_t)a.Co, lines * a.T_out};
  const cuuint64_t gstrides[1] = {(cuuint64_t)a.Co * 2};
  const cuuint32_t gbox[2] = {wg::kBoxCols, DW_KR};
  const cuuint64_t zdims[3] = {(cuuint64_t)a.Ci, (cuuint64_t)a.T, lines};
  const cuuint64_t zstrides[2] = {(cuuint64_t)a.Ci * 2,
                                  (cuuint64_t)a.T * a.Ci * 2};
  const cuuint32_t zbox[3] = {wg::kBoxCols, 8, 1};
  a.tma = vmajor && a.split_rows % DW_KR == 0 &&
          wg::tma_can_read(a.g, a.Co) && wg::tma_can_read(a.zh, a.Ci) &&
          wg::encode_map(&a.gmap, a.g, 2, gdims, gstrides, gbox) &&
          wg::encode_map(&a.zmap, a.zh, 3, zdims, zstrides, zbox);
}

inline bool bad_tile(int bn, int kc, int stages) {
  return (bn != 64 && bn != 128 && bn != 256) || (kc != 32 && kc != 64) ||
         stages < 2 || stages > kMaxStages;
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
  const Dims d = make_dims(V, N, T, C, C, gamma, stride, (gamma - 1) / 2,
                           T_out, tt, vg, relu2, 1);
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
  const Dims d = make_dims(V, N, T, C, C, gamma, stride, (gamma - 1) / 2,
                           T_out, ft, vg, relu2, 1);
  return (int)bwd<float, true>(z, g, s2, t2, wtT, dz, partial, grads, ctas,
                               d, smem_bytes,
                               static_cast<cudaStream_t>(stream));
}

// The plain temporal convolution: vmajor = 1 for (V, N, T, C) tensors
// (pass V = R, N = 1 for (R, T, C)), 0 for (N, T, V, C) ones; pad frames
// of zeros on both ends.
extern "C" int temporal_conv_fwd_launch(
    const void* x, const void* w, const void* b, void* out, int V, int N,
    int T, int C_in, int C_out, int gamma, int stride, int pad, int T_out,
    int tt, int vg, int vmajor, int smem_bytes, void* stream) {
  if (bad_fwd_args(tt, vg, stride, T_out) || bad_pad(gamma, pad))
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, N, T, C_in, C_out, gamma, stride, pad, T_out,
                           tt, vg, 0, vmajor);
  return (int)fwd<float, false>(x, nullptr, nullptr, w, b, out, d,
                                smem_bytes, static_cast<cudaStream_t>(stream));
}

// grads: float32 [dW | db], the sums of the CTAs' slices of partial.
extern "C" int temporal_conv_bwd_launch(
    const void* x, const void* g, const void* wT, void* dx, void* partial,
    void* grads, int V, int N, int T, int C_in, int C_out, int gamma,
    int stride, int pad, int T_out, int ft, int vg, int ctas, int vmajor,
    int smem_bytes, void* stream) {
  if (bad_bwd_args(V, N, T, ft, vg, stride, ctas) || bad_pad(gamma, pad))
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(V, N, T, C_in, C_out, gamma, stride, pad, T_out,
                           ft, vg, 0, vmajor);
  return (int)bwd<float, false>(x, g, nullptr, nullptr, wT, dx, partial,
                                grads, ctas, d, smem_bytes,
                                static_cast<cudaStream_t>(stream));
}

// The bf16 launchers run the warpgroup kernels, for both ops: aff = 1 is
// temporal_block (V-major z, the affine and ReLU), aff = 0 temporal_conv
// (vmajor picks the layout; s2, t2 unused).  pad is the frames of zeros
// on both ends ((gamma - 1) / 2 for temporal_block).  bn (64, 128 or 256)
// is the N
// tile, kc (64 or 32) the input channels of a weight ring stage and stages
// (2-4) the ring's depth, as temporal_block.py plan_mma_forward gives them
// with the shared bytes.
extern "C" int temporal_mma_fwd_launch(
    const void* x, const void* s2, const void* t2, const void* wt,
    const void* bt, void* out, int V, int N, int T, int C_in, int C_out,
    int gamma, int stride, int pad, int aff, int relu2, int vmajor, int bn,
    int kc, int stages, int smem_bytes, void* stream) {
  if (stride < 1 || gamma < 1 || gamma % 2 == 0 || bad_pad(gamma, pad) ||
      mma_path::bad_tile(bn, kc, stages) ||
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
  a.pad = pad;
  a.T_out = (T + 2 * a.pad - gamma) / stride + 1;
  a.K_in = C_in;
  a.N_out = C_out;
  a.gamma = gamma;
  a.stride = stride;
  a.relu2 = relu2;
  a.stages = stages;
  a.kc = kc;
  if (a.T_out < 1 ||
      smem_bytes < mma_path::gemm_smem(
                       bn, kc, stages,
                       mma_path::staged_rows(mma_path::BM, a.T_out, stride,
                                             gamma),
                       C_in, false))
    return (int)cudaErrorInvalidValue;
  mma_path::weight_source(a, wt, gamma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (aff)
    err = mma_path::gemm_bn<true, true, false>(a, bn, smem_bytes, s);
  else if (vmajor)
    err = mma_path::gemm_bn<false, true, false>(a, bn, smem_bytes, s);
  else
    err = mma_path::gemm_bn<false, false, false>(a, bn, smem_bytes, s);
  return (int)err;
}

// One op call's backward: the dx kernel (tiles_x row tiles of 128 per
// input-frame parity, N tiles of bn_dx, a ring of stages_dx stages of
// kc_dx channels;
// partial_dx its [stride * tiles_x][2 * C_in] ds2 | dt2 slices, and zh
// a bf16 scratch of x's shape that takes round([relu](x * s2 + t2)), aff
// only), the dWt kernel (splits slices of split_rows rows in partial_dw,
// each [gamma * C_in * C_out | C_out]; a ring of dw_stages, 2-4) and
// the passes that sum the slices
// in order into grads = [dWt | dbt (| ds2 | dt2)].  Rows (V * N * T) must
// fit in an int.
extern "C" int temporal_mma_bwd_launch(
    const void* x, const void* g, const void* s2, const void* t2,
    const void* wtT, void* dx, void* partial_dw, void* partial_dx, void* zh,
    void* grads, int V, int N, int T, int C_in, int C_out, int gamma,
    int stride, int pad, int aff, int relu2, int vmajor, int bn_dx,
    int kc_dx, int stages_dx, int tiles_x, int dx_smem, int splits,
    int split_rows, int dw_stages, int dw_smem, void* stream) {
  const int T_out = (T + 2 * pad - gamma) / stride + 1;
  const long long lines = (long long)V * N;
  const long long dx_rows = lines * ((T + stride - 1) / stride);
  if (stride < 1 || gamma < 1 || gamma % 2 == 0 || bad_pad(gamma, pad) ||
      T_out < 1 || lines * T >= (1LL << 31) ||
      mma_path::bad_tile(bn_dx, kc_dx, stages_dx) ||
      splits < 1 || split_rows < 1 || dw_stages < 2 || dw_stages > 4 ||
      (aff && zh == nullptr) ||
      (long long)splits * split_rows < lines * T_out ||
      (long long)tiles_x * mma_path::BM < dx_rows)
    return (int)cudaErrorInvalidValue;
  int staged = 0;  // the dx tiles' staged rows, the larger parity's
  for (int par = 0; par < stride; ++par) {
    const int per_line = (T - par + stride - 1) / stride;
    const int tap0 = (par + pad) % stride;
    const int ntap = (gamma - tap0 + stride - 1) / stride;
    if (per_line > 0) {
      const int rows = mma_path::staged_rows(mma_path::BM, per_line, 1, ntap);
      if (rows > staged) staged = rows;
    }
  }
  const int zrows = mma_path::dwt_rows(
      T_out, stride, gamma < mma_path::DW_TAPS ? gamma : mma_path::DW_TAPS);
  if (dx_smem < mma_path::gemm_smem(bn_dx, kc_dx, stages_dx, staged, C_out,
                                    aff != 0) ||
      dw_smem < mma_path::dwt_smem(zrows, dw_stages))
    return (int)cudaErrorInvalidValue;
  mma_path::GemmArgs a{};
  a.x = static_cast<const tap::bf16*>(g);
  a.z = static_cast<const tap::bf16*>(x);
  a.s2 = static_cast<const float*>(s2);
  a.t2 = static_cast<const float*>(t2);
  a.w = static_cast<const tap::bf16*>(wtT);
  a.out = static_cast<tap::bf16*>(dx);
  a.partial = static_cast<float*>(partial_dx);
  a.zh = static_cast<tap::bf16*>(zh);
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
  a.stages = stages_dx;
  a.kc = kc_dx;
  mma_path::weight_source(a, wtT, gamma);
  mma_path::DwtArgs w{};
  w.zh = static_cast<const tap::bf16*>(aff ? zh : x);
  w.g = static_cast<const tap::bf16*>(g);
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
  w.split_rows = split_rows;
  w.zrows = zrows;
  mma_path::dwt_source(w, vmajor != 0 || aff != 0);
  w.stages = dw_stages;
  float* out = static_cast<float*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (aff)
    err = mma_path::backward<true, true>(a, bn_dx, dx_smem, w, splits,
                                         dw_smem, out, s);
  else if (vmajor)
    err = mma_path::backward<false, true>(a, bn_dx, dx_smem, w, splits,
                                          dw_smem, out, s);
  else
    err = mma_path::backward<false, false>(a, bn_dx, dx_smem, w, splits,
                                           dw_smem, out, s);
  return (int)err;
}
