// block_eval: one whole ST-GCN eval block, for Hopper.
//
// Replaces two Pallas TPU kernels of the JAX package, which compute the same
// function in two layouts:
//   * stgcn_tpu/kernels/block_fused.py  fused_block_vm          (_mega_kernel)
//   * stgcn_tpu/kernels/block_packed.py fused_block_packed_eval (_mega_packed_kernel)
// The packed variant's two-frames-per-128-lane rows, the 128-lane channel
// padding and the padded-T chaining were layout workarounds for the TPU;
// these kernels take the logical (V, N, T, C) layout and need none of them.
//
// Function, per sequence n and output frame t (the rounding points are the
// TPU kernel's; "round" means rounding to the activation dtype T):
//   h   = round(relu?(x * s1 + t1))              x zeroed at frames >= len[n]
//   y_k = round(h . W_k + b_k)                   f32 accumulation
//   z   = sum_k A_k . y_k                        f32 accumulation
//   z   = relu(z * s2 + t2)                      order "pre" only
//   z   = 0 outside the frames [0, T), then round
//   u   = sum_g z[t*s - pad_l + g] . Wt_g + bt   f32 accumulation
//   u   = u * s2 + t2                            order "post" only
//   u  += x[t]  (identity)  or  round(x[t*s] . Wr + br)  (projection)
//   out = round(relu?(u))
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s).  For one block
// with M = N*T input frames, M' = N*T_out output frames, V joints, K
// partitions, the function needs
//   2*M*V*C_in*K*C_out (stage 1) + 2*M*K*V*V*C_out (aggregation)
//   + 2*M'*V*gamma*C_out^2 (temporal taps) + 2*M'*V*C_in*C_out (projection)
// operations and moves (M*V*C_in + M'*V*C_out) * sizeof(T) bytes of block
// input and output (weights are under 2.5 MB a block).  Summed over the ten
// blocks of DEFAULT_PLAN at B=64, T=304, V=25, K=2, gamma=9 that is about
// 1.0e12 operations (the temporal taps are 78% of them) and about 1.2e9
// bytes in bf16: 1.0 ms of tensor-core time against 0.35 ms of memory time,
// so the forward is compute-bound with a bound of about 1.0 ms.  (The
// figures are recomputed per block from the shapes by chip_smoke.py.)
//
// Design, bf16 (the serving path): Hopper's warpgroup MMA (wgmma.cuh), in
// two kernels a call, three with the projection shortcut (the wrapper's
// one call counts one launch), with z passing through device memory:
//   * block_eval_spatial_kernel writes z (pre-order affine and ReLU
//     applied, rounded once) to a V-major bf16 scratch.  A tile is F whole
//     frames (the aggregation mixes joints): F*V of the 128 rows of two
//     consumer warpgroups (F = 5 of 25 joints: 125 rows).  The CTAs are
//     persistent, two an SM where their shared bytes allow (C_in <= 64).
//     Warp 0 streams W_k's chunks of 64 C_in rows by one 64-column slab by
//     TMA into 128B-swizzled stages with full and empty mbarriers; where a
//     tile's chunks fit in 8 stages (C_in <= 128) W stays resident, loaded
//     once a CTA.  Warps 1-3 stage each tile's h a tile ahead into one of
//     two buffers (x by cp.async, then the affine in place; full and empty
//     mbarriers a buffer).  Per slab, the consumers compute y_k =
//     round(h . W_k + b_k) for every partition with wgmma m64n64k16 (A, h,
//     from registers by ldmatrix) into shared memory, then z = sum_k A_k .
//     y_k per frame on mma.sync as a (32 x 32) . (32 x 64) product, the
//     joints padded to 32 with zeros in A (staged once a CTA), z in float32
//     registers (never live beside the wgmma accumulators); the slab's z
//     goes out through shared memory in 16-byte pieces (each thread's
//     scattered 4-byte pairs measured slower, PERF.md).
//   * block_eval_taps_kernel is the temporal taps as temporal_block.cu's
//     forward GEMM: rows (line, output frame), a line one (joint, sequence)
//     pair, in tiles of 128 rows (two consumer warpgroups of 64) by the
//     whole C_out (wgmma m64nBNk16, BN = 64, 128 or 256); each tile's z
//     frames, its halo included, are staged once by every thread
//     (tile_rows.cuh), and row r reads tap g at its own staged offset + g,
//     so the stride and the halo need no descriptor; Wt's chunks come by
//     TMA through a ring of 3-4 stages.  The epilogue adds bt [, the
//     post-order affine], the shortcut (x[t], or the rounded projection
//     that the projection pass left in the output), the ReLU, and rounds;
//     its per-column constants wait in shared memory.
//   * With the projection shortcut the same kernel (PROJ) runs first as a
//     one-tap GEMM over the rows x[t*s] with Wr's chunks through the ring,
//     and writes round(x[t*s] . Wr + br) into the output.
//   Why z goes through device memory: a CTA that kept its z resident would
//   recompute the spatial part of its tile's halo frames, (TT-1)*s + gamma
//   of them for TT output frames: at the tiles that fit in 227 KB beside a
//   ring, 1.5x the spatial work at C_out = 64 and 2.75-3x at C_out = 256,
//   where the spatial work is 24-31% of the taps' (chip_smoke.py
//   block_cost).  Written once and read once instead, z moves 62-125 MB
//   each way a block at B=64, T=304, 0.04-0.07 ms at 3.35 TB/s; on the
//   H100 the spatial kernel without its z stores ran 0.013-0.054 ms faster
//   a block (scripts/torch_block_eval_ablation.py).  A cluster along time would avoid both but copy its halo between
//   CTAs' shared memory; the split is the simplest of the three.
//   Measured (H100 80GB HBM3, 700 W, B=64, T=304; PERF.md): 6.1 ms a
//   forward against a 1.0 ms bound, the spatial kernel 0.11-0.44 ms a
//   block and the taps 0.20-0.52 (N=64-256), 1.03-1.30x the port's split
//   train kernels (spatial_block, then temporal_block), which skip the
//   shortcut.
//   Any channel count runs: K and N tails are zero-filled (TMA's
//   out-of-bounds fill or the copies' zero fill), and weights or rows
//   without 16-byte strides (C % 8 != 0, C_in = 2 for the first block) go
//   through plain loads into the same layouts.
// Design, float32 (the port's check type; on tensor cores it would be
// TF32): plain scalar FMA on the CUDA cores.  One CTA of 256 threads takes
// one sequence, a tile of TT output frames and a group of VG joints; it
// computes z for the (TT-1)*s + gamma input frames its taps read, keeps it
// in shared memory (z never goes to device memory) and runs the taps as
// 8 x 4 register tiles with weights read through L1/L2.
//
// Launch contract (checked by the Python wrapper before the call): C_out
// <= 256.  float32: V <= MAXR * (256 / C_out) and the tiles and shared
// bytes of block_eval.py plan_tiles.  bf16: V <= 32, the frames, rings,
// N tile and shared bytes of block_eval.py plan_mma (the launcher checks
// them against the layouts too), and a bf16 scratch z of (V, N, T,
// C_out).  The launchers return cudaGetLastError() after
// their launches.

#include "tap_mma.cuh"
#include "tile_rows.cuh"
#include "wgmma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // temporal phase: output rows per thread
constexpr int kCols = 4;  // temporal phase: output channels per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Params {
  const void* x;      // (V, N, T, C_in)            T
  const float* s1;    // (C_in,)
  const float* t1;    // (C_in,)
  const void* w;      // (K, C_in, C_out)           T
  const void* b;      // (K, C_out)                 T
  const void* a;      // (K, V, V)                  T
  const void* wt;     // (gamma, C_out, C_out)      T
  const float* bt;    // (C_out,)
  const float* s2;    // (C_out,)
  const float* t2;    // (C_out,)
  const void* wr;     // (C_in, C_out)  or null     T
  const float* br;    // (C_out,)       or null
  const int* lengths; // (N,)           or null
  void* out;          // (V, N, T_out, C_out)       T
  int V, N, T, C_in, C_out, K, gamma, stride, pad_l, T_out, tt, vg;
  int order_pre, shortcut, relu1, final_relu;  // shortcut: 0 none, 1 id, 2 proj
};

template <typename T, int MAXR>
__global__ void __launch_bounds__(kThreads) block_eval_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const T* __restrict__ b = static_cast<const T*>(p.b);
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const T* __restrict__ wt = static_cast<const T*>(p.wt);
  const T* __restrict__ wr = static_cast<const T*>(p.wr);
  T* __restrict__ out = static_cast<T*>(p.out);

  const int V = p.V, C_in = p.C_in, C_out = p.C_out;
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * p.tt;
  const int v0 = blockIdx.z * p.vg;
  const int vcount = min(p.vg, V - v0);
  const int tf = (p.tt - 1) * p.stride + p.gamma;
  const size_t frame_elems = (size_t)p.vg * C_out;
  T* zs = reinterpret_cast<T*>(smem_raw);  // [tf][vg][C_out]
  T* hs = zs + (size_t)tf * frame_elems;   // [V][C_in]
  T* ys = hs + (size_t)V * C_in;           // [V][C_out]
  const int tid = threadIdx.x;
  const int len = p.lengths != nullptr ? p.lengths[n] : p.T;
  const int tin0 = t0 * p.stride - p.pad_l;

  // ---- spatial phase: z for the tf input frames, kept in shared memory ----
  // Thread (ry, o1) owns output channel o1 of rows ry, ry + rg, ...
  const int rg = kThreads / C_out;
  const int o1 = tid % C_out;
  const int ry = tid / C_out;
  const bool active1 = ry < rg;
  const int mr = (V + rg - 1) / rg;
  const float s2o = active1 ? p.s2[o1] : 0.f;
  const float t2o = active1 ? p.t2[o1] : 0.f;

  for (int f = 0; f < tf; ++f) {
    const int tg = tin0 + f;
    T* zf = zs + (size_t)f * frame_elems;
    if (tg < 0 || tg >= p.T) {  // the temporal conv's zero padding
      for (int e = tid; e < vcount * C_out; e += kThreads) zf[e] = from_f<T>(0.f);
      continue;
    }
    const bool frame_valid = tg < len;
    for (int e = tid; e < V * C_in; e += kThreads) {
      const int jw = e / C_in;
      const int i = e - jw * C_in;
      const float xv =
          frame_valid ? to_f(x[(((size_t)jw * p.N + n) * p.T + tg) * C_in + i]) : 0.f;
      float h = fmaf(xv, p.s1[i], p.t1[i]);
      if (p.relu1) h = fmaxf(h, 0.f);
      hs[e] = from_f<T>(h);
    }
    __syncthreads();

    float za[MAXR];
#pragma unroll
    for (int m = 0; m < MAXR; ++m) za[m] = 0.f;
    for (int k = 0; k < p.K; ++k) {
      if (active1) {  // stage 1: ys = round(hs . W_k + b_k)
        float ya[MAXR];
#pragma unroll
        for (int m = 0; m < MAXR; ++m) ya[m] = 0.f;
        const T* wk = w + (size_t)k * C_in * C_out + o1;
        for (int i = 0; i < C_in; ++i) {
          const float wv = to_f(wk[(size_t)i * C_out]);
#pragma unroll
          for (int m = 0; m < MAXR; ++m) {
            if (m < mr) {
              const int row = min(ry + m * rg, V - 1);
              ya[m] = fmaf(to_f(hs[row * C_in + i]), wv, ya[m]);
            }
          }
        }
        const float bk = to_f(b[k * C_out + o1]);
#pragma unroll
        for (int m = 0; m < MAXR; ++m) {
          const int row = ry + m * rg;
          if (m < mr && row < V) ys[row * C_out + o1] = from_f<T>(ya[m] + bk);
        }
      }
      __syncthreads();
      if (active1) {  // aggregation: za += A_k . ys
        const T* ak = a + (size_t)k * V * V + (size_t)v0 * V;
        for (int jw = 0; jw < V; ++jw) {
          const float yv = to_f(ys[jw * C_out + o1]);
#pragma unroll
          for (int m = 0; m < MAXR; ++m) {
            const int vl = ry + m * rg;
            if (m < mr && vl < vcount) za[m] = fmaf(to_f(ak[vl * V + jw]), yv, za[m]);
          }
        }
      }
      __syncthreads();
    }
    if (active1) {
#pragma unroll
      for (int m = 0; m < MAXR; ++m) {
        const int vl = ry + m * rg;
        if (m < mr && vl < vcount) {
          float z = za[m];
          if (p.order_pre) z = fmaxf(fmaf(z, s2o, t2o), 0.f);
          zf[vl * C_out + o1] = from_f<T>(z);
        }
      }
    }
  }
  __syncthreads();

  // ---- temporal phase: gamma taps over the resident z, then the epilogue ---
  // Thread (ty, tx) owns rows ty + i*rth (i < kRows) of each pass and
  // output channels tx + j*ct (j < kCols).  A row is (frame t, joint vl).
  const int ct = (C_out + kCols - 1) / kCols;
  const int rth = kThreads / ct;
  const int tx = tid % ct;
  const int ty = tid / ct;
  if (ty >= rth) return;  // no barrier follows
  const int rows = p.tt * vcount;
  for (int rbase = 0; rbase < rows; rbase += rth * kRows) {
    int zoff[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = min(rbase + ty + i * rth, rows - 1);
      const int t = r / vcount;
      const int vl = r - t * vcount;
      zoff[i] = (t * p.stride * p.vg + vl) * C_out;
    }
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

    for (int g = 0; g < p.gamma; ++g) {
      const T* wg = wt + (size_t)g * C_out * C_out;
      const T* zg = zs + (size_t)g * frame_elems;
      for (int c = 0; c < C_out; ++c) {
        float wv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int o = tx + j * ct;
          wv[j] = o < C_out ? to_f(wg[(size_t)c * C_out + o]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float zv = to_f(zg[zoff[i] + c]);
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(zv, wv[j], acc[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rbase + ty + i * rth;
      if (r >= rows) continue;
      const int t = r / vcount;
      const int vl = r - t * vcount;
      const int tg = t0 + t;
      if (tg >= p.T_out) continue;
      const size_t xrow = ((size_t)(v0 + vl) * p.N + n) * p.T;
      const size_t orow = (((size_t)(v0 + vl) * p.N + n) * p.T_out + tg) * C_out;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int o = tx + j * ct;
        if (o >= C_out) continue;
        float u = acc[i][j] + p.bt[o];
        if (!p.order_pre) u = fmaf(u, p.s2[o], p.t2[o]);
        if (p.shortcut == 1) {
          u += to_f(x[(xrow + tg) * C_in + o]);
        } else if (p.shortcut == 2) {
          const T* xr = x + (xrow + (size_t)tg * p.stride) * C_in;
          float rs = 0.f;
          for (int ci = 0; ci < C_in; ++ci)
            rs = fmaf(to_f(xr[ci]), to_f(wr[(size_t)ci * C_out + o]), rs);
          u += to_f(from_f<T>(rs + p.br[o]));
        }
        if (p.final_relu) u = fmaxf(u, 0.f);
        out[orow + o] = from_f<T>(u);
      }
    }
  }
}

// ---- bf16: the warpgroup kernels (wgmma.cuh) --------------------------------
namespace be_mma {

using tap::bf16;
using tile_rows::Tile;
constexpr int BM = 128;              // rows of a tile: 2 consumer warpgroups
constexpr int KC = wg::kBoxRows;     // input channels of a ring stage (64),
                                     // or 32 where the ring needs it
constexpr int kMmaThreads = 384;     // a producer warpgroup, 2 consumers
constexpr int kMaxResident = 8;      // spatial: stages of a resident W
constexpr int SN = 64;               // spatial: output channels of a slab
constexpr int VP = 32;               // joints, zero-padded, of A's products
constexpr int MAX_FRAMES = 6;        // spatial: frames of a tile
constexpr int MAXU = MAX_FRAMES * (SN / 16) / 8;  // z units of a warp
constexpr int AP = VP + tap::kPad;   // pitch of a padded adjacency
constexpr int YP = SN + tap::kPad;   // pitch of y
// rows of a y buffer: frame f's aggregation reads rows f*V .. f*V + 31
constexpr int YR = BM + 16;

// Registers by CTAs an SM: setmaxnreg moves the producer warpgroup's
// share to the consumers (one CTA: 128 * 40 + 256 * 232 = 64,512 of
// 65,536; two: 128 * 32 + 256 * 104 = 30,720, all that a CTA launched at
// 80 a thread holds).  The taps kernel takes two CTAs an SM at N = 64,
// else one; the spatial kernel two where its shared bytes allow.
template <int CTAS>
struct Regs {
  static constexpr int producer = CTAS == 2 ? 32 : 40;
  static constexpr int consumer = CTAS == 2 ? 104 : 232;
};

// Shared bytes of the spatial kernel (block_eval.py spatial_smem): the
// alignment slack, the ring (stages of kc rows by one slab) and its
// barriers, the two h buffers' barriers, b_k, s2 and t2 as float32 per
// column (C_out rounded up to a slab), s1 and t1 per input channel
// (round16(C_in)), the K padded adjacencies, two buffers of h of a tile's
// rows, y_k of a slab for each partition.
inline int spatial_smem(int c_in, int c_out, int k, int kc, int stages) {
  const int cp = tile_rows::round_up(c_out, SN);
  return wg::kAtomBytes + stages * (kc * 128 + 16) + 32 + 4 * (k + 2) * cp +
         8 * tap::round16(c_in) + 2 * k * VP * AP +
         2 * 2 * BM * tap::pitch_of(c_in) + 2 * k * YR * YP;
}
// The most shared bytes of a CTA that shares its SM with another: half of
// the SM's 228 KB less the 1 KB each CTA's block reserves.
constexpr int kHalfSmBytes = 233472 / 2 - 1024;

// Shared bytes of the taps kernel (block_eval.py taps_smem): the slack,
// the ring (stages of kc input channels by BN) and its barriers, the row
// offsets, the epilogue's three float32 constants a column, the staged
// rows.
inline int taps_smem(int bn, int kc, int stages, int staged, int k_in) {
  return wg::kAtomBytes + stages * (bn * kc * 2 + 16) + 4 * BM +
         3 * bn * 4 + staged * tap::pitch_of(k_in) * 2;
}

struct SpatialArgs {
  CUtensorMap wmap;     // tma: W as (C_out, C_in, K), 64 x kc x 1 boxes
  const bf16* x;        // (V, M, C_in), M = N*T frames
  const float* s1;      // (C_in,)
  const float* t1;
  const bf16* w;        // (K, C_in, C_out)
  const bf16* b;        // (K, C_out)
  const bf16* a;        // (K, V, V)
  const float* s2;      // (C_out,), order pre
  const float* t2;
  const int* lengths;   // (N,) or null
  bf16* z;              // (V, M, C_out)
  int V, N, T, C_in, C_out, K, frames, kc, stages, tma, order_pre, relu1;
};

// The weights of one ring stage by plain loads, where TMA cannot read them
// (rows without 16-byte strides): `rows` K rows from k0 of matrix mat of
// w (mats, K_in, N_out), the 64-column tiles j < nb from column n0, into
// the stage's 128B-swizzled layout, zero past K_in and N_out; by threads
// i, i + n, ...
__device__ __forceinline__ void load_stage(unsigned char* stage, int box,
                                           const bf16* w, int mat, int k0,
                                           int rows, int n0, int nb,
                                           int K_in, int N_out, int i,
                                           int n) {
  for (int e = i; e < nb * rows * 8; e += n) {
    const int j = e / (rows * 8);
    const int kr = (e / 8) % rows;
    const int c8 = e % 8;
    const int k = k0 + kr;
    const int col = n0 + j * wg::kBoxCols + c8 * 8;
    alignas(16) bf16 v[8];
    const bf16* src = w + ((size_t)mat * K_in + k) * N_out + col;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = (k < K_in && col + q < N_out) ? src[q]
                                           : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(stage + j * box + wg::sw128(kr, c8)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// Eight channels c .. c + 7 of one h row: round(relu?(x * sc + sh)), x
// zero unless live, from x's copy in place (aligned) or from x's row.
// Past C_in the scales and shifts are zero, so h is zero there.
__device__ __forceinline__ void h8(bf16* dst, const bf16* row, int c, int C,
                                   bool aligned, bool live, const float* sc,
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
    const float h =
        tap::affine(live ? __bfloat162float(v[q]) : 0.f, sc[q], sh[q]);
    v[q] = __float2bfloat16_rn(relu1 ? fmaxf(h, 0.f) : h);
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// h of a spatial tile's BM rows (row r = f*V + v: joint v of frame m0 + f)
// into hs at pitch HP: round(relu?(x * s1 + t1)), x taken as zero at
// frames at or past the sequence's length; zero past the tile's fc frames
// and past C_in (s1s and t1s, the scales and shifts staged in shared
// memory, are zero there).  Where x's rows are 16-byte aligned the threads
// copy their pieces with cp.async, then turn them into h in place (each
// its own copies, which its wait has made visible to it); else plain
// loads.  Thread i of n takes pieces i, i + n, ...; where n is a multiple
// of the pieces a row, they share one column, whose eight scales and
// shifts the thread keeps in registers.
__device__ __forceinline__ void stage_h(bf16* hs, int HP,
                                        const SpatialArgs& p,
                                        const float* s1s, const float* t1s,
                                        int m0, int fc, int i, int n) {
  const int C = p.C_in, V = p.V, M = p.N * p.T;
  const int pieces = tap::round16(C) / 8;
  const bool aligned =
      C % 8 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  unsigned live = 0;  // bit f: frame m0 + f lies inside its sequence
  for (int f = 0; f < fc; ++f) {
    const int m = m0 + f, seq = m / p.T;
    if (p.lengths == nullptr || m - seq * p.T < p.lengths[seq])
      live |= 1u << f;
  }
  if (aligned) {
    for (int e = i; e < BM * pieces; e += n) {
      const int r = e / pieces;
      const int c = (e - r * pieces) * 8;
      const int f = r / V;
      const bool valid = f < fc && c < C;
      const bf16* src =
          valid ? p.x + ((size_t)(r - f * V) * M + m0 + f) * C + c : p.x;
      tap::cp_async16(tap::smem_u32(hs + (size_t)r * HP + c), src,
                      valid ? 16 : 0);
    }
    tap::cp_async_commit();
    tap::cp_async_wait<0>();
  }
  auto piece = [&](int r, int c, const float* sc, const float* sh) {
    const int f = r / V;
    bf16* dst = hs + (size_t)r * HP + c;
    if (f >= fc) {  // a row past the tile: zero (copied as zero above)
      if (!aligned) *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      return;
    }
    h8(dst, p.x + ((size_t)(r - f * V) * M + m0 + f) * C, c, C, aligned,
       (live >> f) & 1u, sc, sh, p.relu1);
  };
  if (n % pieces == 0) {
    const int c = (i % pieces) * 8;
    float sc[8], sh[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sc[q] = s1s[c + q];
      sh[q] = t1s[c + q];
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

// z of the M = N*T frames, F whole frames a tile: a persistent CTA takes
// tiles blockIdx.x, + gridDim.x, ...  Warp 0 produces the W_k ring (the
// chunks of each tile in the order slab, partition, C_in chunk); warps 1-3
// stage each tile's h into one of two buffers ahead of the consumers, with
// a full and an empty mbarrier a buffer; warpgroups 1 and 2 compute y_k of
// 64 rows each on wgmma for every partition of a slab, then the
// aggregation per frame on mma.sync: units of (frame, 16 columns),
// consumer warp w taking w, w + 8, ...  The stage-1 accumulators and z are
// never live together, so two CTAs share an SM where the shared bytes
// allow (CTAS = 2).
// Shared: ring [stages][kc][64] | full, empty [stages] | hfull, hempty [2]
//         | b [K][cp] | s2, t2 [cp] | s1, t1 [Kp] | A [K][VP][AP] |
//         hs [2][BM][HP] | ys [K][YR][YP] (y_0's rows also take a slab's z
//         on its way out).
template <int CTAS>
__global__ void __launch_bounds__(kMmaThreads, CTAS)
block_eval_spatial_kernel(const __grid_constant__ SpatialArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = wg::align_atom(smem_raw);
  const int kc = p.kc, nst = p.stages, STAGE = kc * 128;
  const int K = p.K, V = p.V, C_in = p.C_in, C_out = p.C_out;
  const int cp = tile_rows::round_up(C_out, SN);
  const int HP = tap::pitch_of(C_in);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * STAGE);
  uint64_t* empty = full + nst;
  uint64_t* hfull = empty + nst;
  uint64_t* hempty = hfull + 2;
  float* bs = reinterpret_cast<float*>(hempty + 2);
  float* s2s = bs + K * cp;
  float* t2s = s2s + cp;
  const int Kp = tap::round16(C_in);
  float* s1s = t2s + cp;
  float* t1s = s1s + Kp;
  bf16* as = reinterpret_cast<bf16*>(t1s + Kp);
  bf16* hs = as + K * VP * AP;
  bf16* ys = hs + 2 * BM * HP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.N * p.T, F = p.frames;
  const int ntiles = (M + F - 1) / F;
  const int my_tiles =
      (int)blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nkc = (Kp + kc - 1) / kc;
  const int nchunks = (cp / SN) * K * nkc;  // a tile's
  // W resident: every chunk of a tile has its own stage, loaded once a CTA
  const bool resident = nchunks <= nst;
  const int total = resident ? nchunks : my_tiles * nchunks;
  const uint32_t ring_u = wg::smem_u32(ring);
  // chunk g: the tile's chunk ch = g % nchunks, of slab ch / (K nkc),
  // partition (ch / nkc) % K, C_in chunk ch % nkc
  auto tma_chunk = [&](int g) {
    const int st = g % nst, ch = g % nchunks;
    const uint32_t fb = wg::smem_u32(full + st);
    wg::mbar_expect_tx(fb, STAGE);
    wg::tma_load_3d(ring_u + st * STAGE, &p.wmap, fb, ch / (nkc * K) * SN,
                    ch % nkc * kc, ch / nkc % K);
  };
  int issued = 0;  // chunks whose TMA went out before the staging
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      wg::mbar_init(wg::smem_u32(full + i), 1);
      wg::mbar_init(wg::smem_u32(empty + i), 8);  // the 8 consumer warps
    }
    for (int b = 0; b < 2; ++b) {
      wg::mbar_init(wg::smem_u32(hfull + b), 96);   // warps 1-3
      wg::mbar_init(wg::smem_u32(hempty + b), 8);   // the consumer warps
    }
    wg::fence_barrier_init();
    if (p.tma) {
      issued = min(nst, total);
      for (int g = 0; g < issued; ++g) tma_chunk(g);
    }
  }
  for (int e = tid; e < K * cp; e += blockDim.x) {
    const int k = e / cp, o = e - k * cp;
    bs[e] = o < C_out ? __bfloat162float(p.b[k * C_out + o]) : 0.f;
  }
  for (int o = tid; o < cp; o += blockDim.x) {
    s2s[o] = o < C_out ? p.s2[o] : 0.f;
    t2s[o] = o < C_out ? p.t2[o] : 0.f;
  }
  for (int c = tid; c < Kp; c += blockDim.x) {
    s1s[c] = c < C_in ? p.s1[c] : 0.f;
    t1s[c] = c < C_in ? p.t1[c] : 0.f;
  }
  for (int e = tid; e < K * VP * VP; e += blockDim.x) {
    const int k = e / (VP * VP);
    const int r = (e / VP) % VP, c = e % VP;
    as[(k * VP + r) * AP + c] = r < V && c < V
                                    ? p.a[((size_t)k * V + r) * V + c]
                                    : __float2bfloat16_rn(0.f);
  }
  for (int e = tid; e < K * (YR - BM) * YP; e += blockDim.x) {
    const int k = e / ((YR - BM) * YP);  // rows past the tile: zero
    ys[(k * YR + BM) * YP + e % ((YR - BM) * YP)] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  if (warp < 4) {  // ---- producers ----
    wg::setmaxnreg_dec<Regs<CTAS>::producer>();
    if (warp == 0) {  // the W_k ring
      for (int g = issued; g < total; ++g) {
        const int st = g % nst, ch = g % nchunks;
        if (p.tma) {
          if (lane == 0) {
            if (g >= nst)
              wg::mbar_wait(wg::smem_u32(empty + st), ((g / nst) & 1) ^ 1);
            tma_chunk(g);
          }
        } else {  // weights TMA cannot read: plain loads, same layout
          if (g >= nst)
            wg::mbar_wait(wg::smem_u32(empty + st), ((g / nst) & 1) ^ 1);
          load_stage(ring + st * STAGE, STAGE, p.w, ch / nkc % K,
                     ch % nkc * kc, kc, ch / (nkc * K) * SN, 1, C_in, C_out,
                     lane, 32);
          wg::fence_proxy_async();
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(wg::smem_u32(full + st));
        }
      }
    } else {  // h of each tile, a buffer ahead
      for (int it = 0; it < my_tiles; ++it) {
        const int b = it & 1;
        if (it >= 2)
          wg::mbar_wait(wg::smem_u32(hempty + b), ((it >> 1) & 1) ^ 1);
        const int m0 = (blockIdx.x + it * gridDim.x) * F;
        stage_h(hs + b * BM * HP, HP, p, s1s, t1s, m0, min(F, M - m0),
                tid - 32, 96);
        wg::mbar_arrive(wg::smem_u32(hfull + b));
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, rows 64 * cw .. ----
  wg::setmaxnreg_inc<Regs<CTAS>::consumer>();
  const int cw = warp / 4 - 1, wi = warp & 3, cwarp = warp - 4;
  const int col8 = tap::lane_col8(lane);
  const uint32_t a_lane =
      (uint32_t)(((cw * 64 + wi * 16 + tap::a_lane_row(lane)) * HP + col8) * 2);
  uint32_t a_row = 0;  // this lane's h row in the tile's buffer
  const int rbase = cw * 64 + wi * 16 + (lane >> 2);
  const int units = F * (SN / 16);
  // z leaves in 16-byte pieces where its rows allow
  const bool zvec =
      C_out % 8 == 0 && (reinterpret_cast<uintptr_t>(p.z) & 15) == 0;
  float acc[SN / 2];
  uint32_t fa[2][KC / 16][4];
  int ch = 0, pending = -1;  // pending: the chunk whose stage is held
  // One chunk: A fragments by ldmatrix, then its k16 steps as one wgmma
  // group; the group before it is waited for, and its stage released.
  auto chunk = [&](uint32_t(&a)[KC / 16][4]) {
    const int st = resident ? ch % nchunks : ch % nst;
    const int k0 = ch % nkc * kc;
    const int steps = min(kc, Kp - k0) / 16;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      if (kk < steps) tap::ldsm_x4(a[kk], a_row + (uint32_t)(k0 + kk * 16) * 2);
    wg::mbar_wait(wg::smem_u32(full + st), resident ? 0 : (ch / nst) & 1);
    const uint64_t desc = wg::desc_sw128(ring_u + st * STAGE, STAGE);
    wg::fence_operand(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      if (kk < steps) wg::mma_rs<SN>(acc, a[kk], wg::desc_step(desc, kk));
    wg::commit();
    wg::wait<1>();
    wg::fence_operand(acc);
    if (pending >= 0 && lane == 0 && !resident)
      wg::mbar_arrive(wg::smem_u32(empty + pending % nst));
    pending = ch++;
  };
  for (int it = 0; it < my_tiles; ++it) {
    const int b = it & 1;
    const int m0 = (blockIdx.x + it * gridDim.x) * F;
    const int fc = min(F, M - m0);
    a_row = wg::smem_u32(hs + b * BM * HP) + a_lane;
    wg::mbar_wait(wg::smem_u32(hfull + b), (it >> 1) & 1);
    for (int n0 = 0; n0 < cp; n0 += SN) {
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int q = 0; q < SN / 2; ++q) acc[q] = 0.f;
        for (int c = 0; c < nkc; c += 2) {
          chunk(fa[0]);
          if (c + 1 < nkc) chunk(fa[1]);
        }
        wg::wait<0>();
        wg::fence_operand(acc);
        if (lane == 0 && !resident)
          wg::mbar_arrive(wg::smem_u32(empty + pending % nst));
        pending = -1;
        // y_k = round(h . W_k + b_k) of this warp's rows and the slab
        bf16* yk = ys + k * YR * YP;
        const float* bk = bs + k * cp + n0;
#pragma unroll
        for (int j = 0; j < SN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cl = 8 * j + 2 * (lane & 3);
            *reinterpret_cast<__nv_bfloat162*>(yk + (rbase + 8 * h) * YP +
                                               cl) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h] + bk[cl],
                                      acc[4 * j + 2 * h + 1] + bk[cl + 1]);
          }
      }
      // the last slab's products have read h: the buffer is free
      if (n0 + SN >= cp && lane == 0) wg::mbar_arrive(wg::smem_u32(hempty + b));
      wg::named_sync(2, 256);  // both warpgroups' y_k of the slab are in
      // z = sum_k A_k . y_k per frame: (VP x VP) . (VP x 16) a unit
      float z[MAXU][2][2][4];
#pragma unroll
      for (int i = 0; i < MAXU; ++i) tap::zero(z[i]);
      for (int k = 0; k < K; ++k) {
        const bf16* yk = ys + k * YR * YP;
        uint32_t af[2][2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            tap::ldsm_x4(af[kk][mi],
                         tap::smem_u32(as + (k * VP + mi * 16 +
                                             tap::a_lane_row(lane)) * AP +
                                       kk * 16 + col8));
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
      // the slab's z: [relu(z * s2 + t2),] rounded once, into y_0's rows
      // (every warp has read y), then out to the scratch in 16-byte pieces
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
              if (v >= V) continue;
              float val[2] = {z[i][mi][nj][2 * h], z[i][mi][nj][2 * h + 1]};
              if (p.order_pre) {
#pragma unroll
                for (int q = 0; q < 2; ++q)
                  val[q] = fmaxf(tap::affine(val[q], s2s[n0 + cl + q],
                                             t2s[n0 + cl + q]),
                                 0.f);
              }
              *reinterpret_cast<__nv_bfloat162*>(zt + (f * V + v) * YP + cl) =
                  __floats2bfloat162_rn(val[0], val[1]);
            }
      }
      wg::named_sync(2, 256);
      // rows (v, f) with f fastest: a joint's frames are contiguous in z
      const int cols = min(SN, C_out - n0);
      if (zvec) {
        const int pc = cols / 8;
        for (int e = tid - 128; e < V * fc * pc; e += 256) {
          const int vf = e / pc, q = e - vf * pc;
          const int v = vf / fc, f = vf - v * fc;
          *reinterpret_cast<uint4*>(p.z + ((size_t)v * M + m0 + f) * C_out +
                                    n0 + q * 8) =
              *reinterpret_cast<const uint4*>(zt + (f * V + v) * YP + q * 8);
        }
      } else {
        for (int e = tid - 128; e < V * fc * cols; e += 256) {
          const int vf = e / cols, c = e - vf * cols;
          const int v = vf / fc, f = vf - v * fc;
          p.z[((size_t)v * M + m0 + f) * C_out + n0 + c] =
              zt[(f * V + v) * YP + c];
        }
      }
      wg::named_sync(2, 256);  // y is read: the next slab or tile may write
    }
  }
}

struct TapArgs {
  CUtensorMap wmap;   // tma: the weights as (C_out, K_in, ntap), 64 x kc x 1
  const bf16* x;      // the rows' input (lines, T, K_in): z, or x (PROJ)
  const bf16* w;      // (ntap, K_in, C_out): Wt, or Wr (PROJ)
  const float* bias;  // bt, or br (PROJ)
  const float* s2;    // order post
  const float* t2;
  const bf16* xs;     // identity shortcut: the block's x (lines, T, C_out)
  bf16* out;          // (lines, T_out, C_out); with the projection shortcut
                      // it holds round(x[t*s] . Wr + br) when the taps run
  int lines, T, T_out, K_in, C_out, ntap, stride, off0, kc, stages, tma,
      order_post, shortcut, final_relu;
};

// Two neighbouring columns o, o + 1 of a bf16 row as float32, the second
// only below n.
__device__ __forceinline__ float2 load2(const bf16* src, int o, int n,
                                        bool pair) {
  if (pair)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  return make_float2(o < n ? __bfloat162float(src[0]) : 0.f,
                     o + 1 < n ? __bfloat162float(src[1]) : 0.f);
}

// The taps (PROJ false: ntap = gamma taps over z from frame t*s - pad) or
// the projection (PROJ: one tap over x at frame t*s) as an implicit GEMM.
// A CTA owns BM rows of the flattened (line, output frame) rows and the
// whole C_out (BN of it, the rest zero); warpgroup 0 produces the weight
// ring, 1 and 2 each compute 64 rows with wgmma m64nBNk16.  Every thread
// stages the tile's input frames first (A, read by ldmatrix at each row's
// offset plus the tap) while TMA brings the ring's first stages; the
// weights stream in chunks of kc input channels of one tap.  (Persistent
// CTAs that staged the next tile's rows with their producer warps measured
// slower at N >= 128 and 0.03 ms faster a block at N = 64, PERF.md.)
// Shared: ring [stages][BN/64][kc][64] | full, empty [stages] |
//         rowoff [BM] | bias, s2, t2 [BN] | the staged rows [S][SP].
template <int BN, bool PROJ>
__global__ void __launch_bounds__(kMmaThreads, BN == 64 ? 2 : 1)
block_eval_taps_kernel(const __grid_constant__ TapArgs p) {
  constexpr int CTAS = BN == 64 ? 2 : 1;  // an SM
  constexpr int NB = BN / wg::kBoxCols;   // 64-column tiles of a stage
  const int kc = p.kc;
  const int box = kc * 128;               // bytes of a 64-column tile
  const int STAGE = NB * box;
  const int nst = p.stages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = wg::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * STAGE);
  uint64_t* empty = full + nst;
  int* rowoff = reinterpret_cast<int*>(empty + nst);
  float* cvec = reinterpret_cast<float*>(rowoff + BM);
  bf16* as = reinterpret_cast<bf16*>(cvec + 3 * BN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int J = p.T_out;
  const int R = p.lines * J;  // rows fit in int (checked by the launcher)
  const int r0 = blockIdx.x * BM;
  const int Kp = tap::round16(p.K_in);
  const int SP = Kp + tap::kPad;  // pitch of the staged rows
  const int nkc = (Kp + kc - 1) / kc;
  const int nchunks = p.ntap * nkc;
  const uint32_t ring_u = wg::smem_u32(ring);
  // TMA of chunk ch into its stage: tap ch / nkc, kc input channels
  auto tma_chunk = [&](int ch) {
    const int st = ch % nst;
    const int i = ch / nkc;
    const uint32_t fb = wg::smem_u32(full + st);
    wg::mbar_expect_tx(fb, STAGE);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      wg::tma_load_3d(ring_u + st * STAGE + j * box, &p.wmap, fb,
                      j * wg::kBoxCols, (ch - i * nkc) * kc, i);
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
  tl.init(r0, BM, R, J, p.stride, p.ntap, p.off0);
  for (int r = tid; r < BM; r += blockDim.x) rowoff[r] = tl.rowoff(r);
  for (int t = tid; t < BN; t += blockDim.x) {
    const bool in = t < p.C_out;
    cvec[t] = in ? p.bias[t] : 0.f;
    cvec[BN + t] = in && p.order_post ? p.s2[t] : 0.f;
    cvec[2 * BN + t] = in && p.order_post ? p.t2[t] : 0.f;
  }
  tile_rows::stage_rows<false, true>(as, SP, tl, p.x, p.T, p.K_in, 0, Kp,
                                     nullptr, nullptr, 0, 1, tid, blockDim.x);
  __syncthreads();

  if (warp < 4) {  // ---- producer: the weight ring ----
    wg::setmaxnreg_dec<Regs<CTAS>::producer>();
    for (int ch = issued; ch < nchunks; ++ch) {
      const int st = ch % nst;
      const int i = ch / nkc;
      if (p.tma) {
        if (tid == 0) {
          if (ch >= nst)
            wg::mbar_wait(wg::smem_u32(empty + st), ((ch / nst) & 1) ^ 1);
          tma_chunk(ch);
        }
      } else {  // weights TMA cannot read: plain loads, same layout
        if (ch >= nst)
          wg::mbar_wait(wg::smem_u32(empty + st), ((ch / nst) & 1) ^ 1);
        load_stage(ring + st * STAGE, box, p.w, i, (ch - i * nkc) * kc, kc, 0,
                   NB, p.K_in, p.C_out, tid, 128);
        wg::fence_proxy_async();
        wg::named_sync(1, 128);
        if (tid == 0) wg::mbar_arrive(wg::smem_u32(full + st));
      }
    }
    return;
  }

  // ---- consumers: warpgroups 1 and 2, rows 64 * cw .. ----
  wg::setmaxnreg_inc<Regs<CTAS>::consumer>();
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
    const int steps = min(kc, Kp - k0) / 16;
    const uint32_t arow = a_base + (uint32_t)(((my_off + i) * SP + k0) * 2);
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
  // 8 jn + 2 (lane & 3) + q.
  const int rbase = cw * 64 + wi * 16 + (lane >> 2);
  const bool even = p.C_out % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    if (r >= tl.rows) continue;
    const int gr = r0 + r;
    const int l = gr / J;
    const int j = gr - l * J;
    bf16* orow = p.out + ((size_t)l * J + j) * p.C_out;
    // the shortcut's row: x[t] (identity), or the projection in the output
    const bf16* srow =
        p.shortcut == 1 ? p.xs + ((size_t)l * p.T + j) * p.C_out : orow;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int o = 8 * jn + 2 * (lane & 3);
      if (o >= p.C_out) continue;
      const bool pair = o + 1 < p.C_out && even;
      float v[2] = {acc[4 * jn + 2 * h] + cvec[o],
                    acc[4 * jn + 2 * h + 1] + cvec[o + 1]};
      if constexpr (!PROJ) {
        if (p.order_post) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            v[q] = tap::affine(v[q], cvec[BN + o + q], cvec[2 * BN + o + q]);
        }
        if (p.shortcut != 0) {
          const float2 sv = load2(srow + o, o, p.C_out, pair);
          v[0] += sv.x;
          v[1] += sv.y;
        }
        if (p.final_relu) {
          v[0] = fmaxf(v[0], 0.f);
          v[1] = fmaxf(v[1], 0.f);
        }
      }
      tile_rows::store2(orow + o, v, o, p.C_out, pair);
    }
  }
}

template <typename Kern>
cudaError_t prepare(Kern kernel, int smem_bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <int BN, bool PROJ>
cudaError_t taps(const TapArgs& a, int smem, cudaStream_t st) {
  auto kernel = block_eval_taps_kernel<BN, PROJ>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.lines * a.T_out + BM - 1) / BM;
  kernel<<<tiles, kMmaThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The N tile: 64, 128 or 256 output channels.
template <bool PROJ>
cudaError_t taps_bn(const TapArgs& a, int bn, int smem, cudaStream_t st) {
  switch (bn) {
    case 64:
      return taps<64, PROJ>(a, smem, st);
    case 128:
      return taps<128, PROJ>(a, smem, st);
    default:
      return taps<256, PROJ>(a, smem, st);
  }
}

// A weight ring of 32 or 64 rows a stage, 2-4 stages for the taps, up to
// kMaxResident for the spatial kernel (a resident W has a stage for each of
// a tile's chunks).
inline bool bad_ring(int kc, int stages) {
  return (kc != 32 && kc != 64) || stages < 2 || stages > kMaxResident;
}

// The weights' ring: TMA where it can read them (16-byte strides), else
// plain loads.
inline int weight_tma(CUtensorMap* map, const void* w, int mats, int k_in,
                      int n_out, int kc) {
  return wg::tma_can_read(w, n_out) &&
         wg::encode_weight_map(map, w, mats, k_in, n_out, kc);
}

}  // namespace be_mma


template <typename T, int MAXR>
cudaError_t launch(const Params& p, int smem_bytes, cudaStream_t stream) {
  auto kernel = block_eval_kernel<T, MAXR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T_out + p.tt - 1) / p.tt, p.N, (p.V + p.vg - 1) / p.vg);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// float32: the scalar kernel, one CTA a (frame tile, sequence, joint
// group), with the tiles and shared bytes of block_eval.py plan_tiles.
extern "C" int block_eval_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, const void* wt, const void* bt,
    const void* s2, const void* t2, const void* wr, const void* br,
    const void* lengths, void* out, int V, int N, int T, int C_in, int C_out,
    int K, int gamma, int stride, int T_out, int tt, int vg, int order_pre,
    int shortcut, int relu1, int final_relu, int smem_bytes, void* stream) {
  if (C_out < 1 || C_out > kThreads) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.s1 = static_cast<const float*>(s1);
  p.t1 = static_cast<const float*>(t1);
  p.w = w;
  p.b = b;
  p.a = a;
  p.wt = wt;
  p.bt = static_cast<const float*>(bt);
  p.s2 = static_cast<const float*>(s2);
  p.t2 = static_cast<const float*>(t2);
  p.wr = wr;
  p.br = static_cast<const float*>(br);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.V = V;
  p.N = N;
  p.T = T;
  p.C_in = C_in;
  p.C_out = C_out;
  p.K = K;
  p.gamma = gamma;
  p.stride = stride;
  p.pad_l = (gamma - 1) / 2;
  p.T_out = T_out;
  p.tt = tt;
  p.vg = vg;
  p.order_pre = order_pre;
  p.shortcut = shortcut;
  p.relu1 = relu1;
  p.final_relu = final_relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mr = (V + kThreads / C_out - 1) / (kThreads / C_out);
  if (mr <= 8) return (int)launch<float, 8>(p, smem_bytes, s);
  if (mr <= 16) return (int)launch<float, 16>(p, smem_bytes, s);
  if (mr <= 32) return (int)launch<float, 32>(p, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// bf16: the spatial kernel into the scratch z (V, N, T, C_out), [the
// projection into out,] then the taps into out, on one stream.  The
// spatial kernel takes `frames` frames a CTA and a ring of s_stages
// stages of s_kc rows; the taps an N tile of bn, a ring of t_stages stages
// of t_kc input channels; the projection (shortcut 2) the same N tile and
// a ring of p_stages stages of p_kc; each with the shared bytes that
// block_eval.py plan_mma gives.
extern "C" int block_eval_mma_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, const void* wt, const void* bt,
    const void* s2, const void* t2, const void* wr, const void* br,
    const void* lengths, void* out, void* z, int V, int N, int T, int C_in,
    int C_out, int K, int gamma, int stride, int order_pre, int shortcut,
    int relu1, int final_relu, int frames, int s_kc, int s_stages,
    int s_smem, int bn, int t_kc, int t_stages, int t_smem, int p_kc,
    int p_stages, int p_smem, void* stream) {
  using namespace be_mma;
  const int pad = (gamma - 1) / 2;
  const int T_out = stride >= 1 ? (T + 2 * pad - gamma) / stride + 1 : 0;
  const bool proj = shortcut == 2;
  if (V < 1 || V > VP || frames < 1 || frames > MAX_FRAMES ||
      frames * V > BM || C_out < 1 || C_out > 256 || C_out > bn ||
      (bn != 64 && bn != 128 && bn != 256) || stride < 1 || gamma < 1 ||
      gamma % 2 == 0 || T_out < 1 ||
      bad_ring(s_kc, s_stages) || bad_ring(t_kc, t_stages) || t_stages > 4 ||
      (proj && (bad_ring(p_kc, p_stages) || p_stages > 4)) ||
      (long long)V * N * T >= (1LL << 31) ||
      s_smem < spatial_smem(C_in, C_out, K, s_kc, s_stages) ||
      t_smem < taps_smem(bn, t_kc, t_stages,
                         tile_rows::staged_rows(BM, T_out, stride, gamma),
                         C_out) ||
      (proj && p_smem < taps_smem(bn, p_kc, p_stages,
                                  tile_rows::staged_rows(BM, T_out, stride, 1),
                                  C_in)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  SpatialArgs sa{};
  sa.x = static_cast<const bf16*>(x);
  sa.s1 = static_cast<const float*>(s1);
  sa.t1 = static_cast<const float*>(t1);
  sa.w = static_cast<const bf16*>(w);
  sa.b = static_cast<const bf16*>(b);
  sa.a = static_cast<const bf16*>(a);
  sa.s2 = static_cast<const float*>(s2);
  sa.t2 = static_cast<const float*>(t2);
  sa.lengths = static_cast<const int*>(lengths);
  sa.z = static_cast<bf16*>(z);
  sa.V = V;
  sa.N = N;
  sa.T = T;
  sa.C_in = C_in;
  sa.C_out = C_out;
  sa.K = K;
  sa.frames = frames;
  sa.kc = s_kc;
  sa.stages = s_stages;
  sa.order_pre = order_pre;
  sa.relu1 = relu1;
  sa.tma = weight_tma(&sa.wmap, w, K, C_in, C_out, s_kc);
  const int ctas = s_smem <= kHalfSmBytes ? 2 : 1;  // an SM
  auto spatial = ctas == 2 ? block_eval_spatial_kernel<2>
                           : block_eval_spatial_kernel<1>;
  cudaError_t err = prepare(spatial, s_smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N * T + frames - 1) / frames;
  spatial<<<min(tiles, ctas * sms), kMmaThreads, s_smem, st>>>(sa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  TapArgs ta{};
  ta.lines = V * N;
  ta.T = T;
  ta.T_out = T_out;
  ta.C_out = C_out;
  ta.stride = stride;
  ta.out = static_cast<bf16*>(out);
  if (proj) {  // round(x[t*s] . Wr + br) into out
    TapArgs pa = ta;
    pa.x = static_cast<const bf16*>(x);
    pa.w = static_cast<const bf16*>(wr);
    pa.bias = static_cast<const float*>(br);
    pa.K_in = C_in;
    pa.ntap = 1;
    pa.off0 = 0;
    pa.kc = p_kc;
    pa.stages = p_stages;
    pa.tma = weight_tma(&pa.wmap, wr, 1, C_in, C_out, p_kc);
    err = taps_bn<true>(pa, bn, p_smem, st);
    if (err != cudaSuccess) return (int)err;
  }
  ta.x = static_cast<const bf16*>(z);
  ta.w = static_cast<const bf16*>(wt);
  ta.bias = static_cast<const float*>(bt);
  ta.s2 = static_cast<const float*>(s2);
  ta.t2 = static_cast<const float*>(t2);
  ta.xs = static_cast<const bf16*>(x);
  ta.K_in = C_out;
  ta.ntap = gamma;
  ta.off0 = -pad;
  ta.kc = t_kc;
  ta.stages = t_stages;
  ta.order_post = !order_pre;
  ta.shortcut = shortcut;
  ta.final_relu = final_relu;
  ta.tma = weight_tma(&ta.wmap, wt, gamma, C_out, C_out, t_kc);
  return (int)taps_bn<false>(ta, bn, t_smem, st);
}

extern "C" const char* block_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
