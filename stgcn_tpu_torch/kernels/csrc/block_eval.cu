// block_eval: one whole ST-GCN eval block in one CUDA kernel, for Hopper.
//
// Replaces two Pallas TPU kernels of the JAX package, which compute the same
// function in two layouts:
//   * stgcn_tpu/kernels/block_fused.py  fused_block_vm          (_mega_kernel)
//   * stgcn_tpu/kernels/block_packed.py fused_block_packed_eval (_mega_packed_kernel)
// The packed variant's two-frames-per-128-lane rows, the 128-lane channel
// padding and the padded-T chaining were layout workarounds for the TPU;
// this kernel takes the logical (V, N, T, C) layout and needs none of them.
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
// Design, bf16 (the serving path): the products on the tensor cores
// through tap_mma.cuh.  One CTA of 256 threads takes one sequence, a tile
// of TT output frames and a group of VG joints (VG = V where it fits).  It
// computes z for the TF = (TT-1)*s + gamma input frames that its taps read,
// one frame at a time, and keeps them in shared memory as bf16 with a
// padded pitch: z never goes to device memory.  Per frame, stage 1
// (y_k = round(h . W_k + b_k), the V = 25 joint rows padded to 32, K =
// C_in) runs on mma.sync with W_k streaming through the cp.async ring; the
// K-way aggregation A_k . y_k (25 x 25, about 5% of the operations) stays
// on the CUDA cores.  The temporal phase is an implicit GEMM over the
// resident z: row (t, vl) of tap g reads zs[(t*s + g)*VG + vl], so the
// stride and the halo are per-row offsets; Wt tap chunks come through the
// ring; the projection shortcut round(x[t*s] . Wr + br) is one more
// one-tap product, its A fragments read from x in device memory, run
// first and kept rounded in registers.  Neighbouring tiles recompute the
// spatial part of their overlapping frames: TF/(TT*s) times the spatial
// work (TT is smaller than in float32 at C_out = 256, where the ring and
// the padded pitch take room).
// Design, float32 (the port's check type): plain scalar FMA on the CUDA
// cores, the same tiling with z in float32 and the taps as 8 x 4 register
// tiles with weights read through L1/L2.
//
// Launch contract (checked by the Python wrapper before the call): C_out
// <= 256; V <= MAXR * (256 / C_out); the dynamic shared memory is what
// block_eval.py plan_tiles gives (at most 227 KB).  The launcher returns
// cudaGetLastError() after the launch.

#include "tap_mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using tap::bf16;
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

// ---- bf16: tensor cores for stage 1, the projection and the taps ---------
constexpr int KC = 32;  // weight rows per ring stage

__device__ __forceinline__ float affine_rn(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);  // as torch rounds x * s + t
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One bf16 element of row `row` (C channels), zero past C.
__device__ __forceinline__ float elem(const bf16* row, int c, int C) {
  return c < C ? __bfloat162float(row[c]) : 0.f;
}

// A CTA (TT output frames of sequence n, VG joints) stages nothing but z
// and one frame's h and y:
//   zs [TF][VG][ZP]  z of the TF input frames its taps read, ZP = pitch(C_out)
//   hs [32][HP]      one frame's h, rows V..31 and the channel tail zero
//   ys [V][C_out]    one partition's y of that frame
//   ring [2][KC][RP] weight chunks (W_k, Wr, Wt), RP = round64(C_out) + 8
template <int MAXR>
__global__ void __launch_bounds__(kThreads) block_eval_mma_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bf16* __restrict__ x = static_cast<const bf16*>(p.x);
  const bf16* __restrict__ w = static_cast<const bf16*>(p.w);
  const bf16* __restrict__ b = static_cast<const bf16*>(p.b);
  const bf16* __restrict__ a = static_cast<const bf16*>(p.a);
  const bf16* __restrict__ wt = static_cast<const bf16*>(p.wt);
  const bf16* __restrict__ wr = static_cast<const bf16*>(p.wr);
  bf16* __restrict__ out = static_cast<bf16*>(p.out);

  const int V = p.V, C_in = p.C_in, C_out = p.C_out, VG = p.vg;
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * p.tt;
  const int v0 = blockIdx.z * VG;
  const int vcount = min(VG, V - v0);
  const int tf = (p.tt - 1) * p.stride + p.gamma;
  const int ZP = tap::pitch_of(C_out), HP = tap::pitch_of(C_in);
  const int NB = (C_out + 63) / 64 * 64, RP = NB + tap::kPad;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* zs = ring + 2 * KC * RP;
  bf16* hs = zs + (size_t)tf * VG * ZP;
  bf16* ys = hs + 32 * HP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col8 = tap::lane_col8(lane);
  const int len = p.lengths != nullptr ? p.lengths[n] : p.T;
  const int tin0 = t0 * p.stride - p.pad_l;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // zero z (padding frames, channel tails) and h (rows past V, tails)
  for (int e = tid; e < tf * VG * ZP + 32 * HP; e += kThreads) zs[e] = zero;
  __syncthreads();

  // ---- spatial phase: z for the tf input frames, kept in shared memory ----
  // Stage 1 on the tensor cores: warp w owns y columns 32w .. 32w+31 of the
  // 32 (joint) rows.  The aggregation runs on the CUDA cores: thread
  // (ry, o1) owns output channel o1 of rows ry, ry + rg, ...
  const int rg = kThreads / C_out;
  const int o1 = tid % C_out;
  const int ry = tid / C_out;
  const bool active1 = ry < rg;
  const int mr = (V + rg - 1) / rg;
  const float s2o = active1 ? p.s2[o1] : 0.f;
  const float t2o = active1 ? p.t2[o1] : 0.f;
  const int nkc1 = (tap::round16(C_in) + KC - 1) / KC;
  const bool w_stage1 = warp * 32 < C_out;

  for (int f = 0; f < tf; ++f) {
    const int tg = tin0 + f;
    if (tg < 0 || tg >= p.T) continue;  // the taps' zero padding: zs is 0
    bf16* zf = zs + (size_t)f * VG * ZP;
    const bool frame_valid = tg < len;
    for (int e = tid; e < V * C_in; e += kThreads) {
      const int jw = e / C_in;
      const int i = e - jw * C_in;
      const float xv =
          frame_valid ? __bfloat162float(x[(((size_t)jw * p.N + n) * p.T + tg) * C_in + i])
                      : 0.f;
      float h = affine_rn(xv, p.s1[i], p.t1[i]);
      if (p.relu1) h = fmaxf(h, 0.f);
      hs[jw * HP + i] = __float2bfloat16_rn(h);
    }
    float za[MAXR];
#pragma unroll
    for (int m = 0; m < MAXR; ++m) za[m] = 0.f;
    for (int k = 0; k < p.K; ++k) {
      // ys = round(hs . W_k + b_k)
      float acc[2][4][4];
      tap::zero(acc);
      const bf16* wk = w + (size_t)k * C_in * C_out;
      tap::ring_loop(
          nkc1,
          [&](int ch) {
            const int k0 = ch * KC;
            tap::stage_tile(ring + (ch & 1) * KC * RP, RP,
                            k0 < C_in ? wk + (size_t)k0 * C_out : wk, C_out,
                            KC, C_in - k0, NB, C_out);
            tap::cp_async_commit();
          },
          [&](int ch) {
            if (!w_stage1) return;
            const int k0 = ch * KC;
            const int steps = min(KC, tap::round16(C_in) - k0) / 16;
            const bf16* bs = ring + (ch & 1) * KC * RP;
#pragma unroll
            for (int kk = 0; kk < KC / 16; ++kk) {
              if (kk >= steps) break;
              uint32_t a_addr[2];
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
                a_addr[mi] = tap::smem_u32(
                    hs + (mi * 16 + tap::a_lane_row(lane)) * HP + k0 +
                    kk * 16 + col8);
              tap::mma_k16<2, 4>(
                  acc, a_addr,
                  tap::smem_u32(bs + (kk * 16 + (lane & 15)) * RP +
                                warp * 32 + col8));
            }
          });
      if (w_stage1) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = tap::acc_row(mi, e, lane);
              const int o = warp * 32 + tap::acc_col(nj, e, lane);
              if (row < V && o < C_out)
                ys[row * C_out + o] = __float2bfloat16_rn(
                    acc[mi][nj][e] + __bfloat162float(b[k * C_out + o]));
            }
      }
      __syncthreads();
      if (active1) {  // aggregation: za += A_k . ys
        const bf16* ak = a + (size_t)k * V * V + (size_t)v0 * V;
        for (int jw = 0; jw < V; ++jw) {
          const float yv = __bfloat162float(ys[jw * C_out + o1]);
#pragma unroll
          for (int m = 0; m < MAXR; ++m) {
            const int vl = ry + m * rg;
            if (m < mr && vl < vcount)
              za[m] = fmaf(__bfloat162float(ak[vl * V + jw]), yv, za[m]);
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
          if (p.order_pre) z = fmaxf(affine_rn(z, s2o, t2o), 0.f);
          zf[vl * ZP + o1] = __float2bfloat16_rn(z);
        }
      }
    }
  }
  __syncthreads();

  // ---- temporal phase: [the projection and] the gamma taps, then the
  // epilogue.  Units of 32 rows (frame t, joint vl) x 64 channels; warp w
  // takes units w, w + 8, ...  Every warp walks the same weight chunks:
  // [Wr's, then] Wt's, tap by tap.
  const int ttc = min(p.tt, p.T_out - t0);
  const int rows = ttc * vcount;
  const int nbn = NB / 64;
  const int units = (rows + 31) / 32 * nbn;
  const bool proj = p.shortcut == 2;
  const int nproj = proj ? (tap::round16(C_in) + KC - 1) / KC : 0;
  const int nkc2 = (tap::round16(C_out) + KC - 1) / KC;
  for (int round0 = 0; round0 < units; round0 += kThreads / 32) {
    const int unit = round0 + warp;
    const bool has_unit = unit < units;
    const int mb = has_unit ? unit / nbn : 0;
    const int nb = has_unit ? unit - mb * nbn : 0;
    // this lane's ldmatrix rows (zs row at tap 0) and projection rows
    int zrow[2];
    const bf16* xrow[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      int r = mb * 32 + mi * 16 + tap::a_lane_row(lane);
      r = r < rows ? r : 0;
      const int t = r / vcount, vl = r - (r / vcount) * vcount;
      zrow[mi] = t * p.stride * VG + vl;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int rr = mb * 32 + mi * 16 + (lane >> 2) + 8 * h;
        rr = rr < rows ? rr : 0;
        const int tt = rr / vcount, vv = rr - tt * vcount;
        xrow[mi][h] = x + (((size_t)(v0 + vv) * p.N + n) * p.T +
                           (size_t)(t0 + tt) * p.stride) * C_in;
      }
    }
    float acc[2][8][4];
    tap::zero(acc);
    uint32_t pr[2][8][2];  // the rounded projection, two bf16 a register
    tap::ring_loop(
        nproj + p.gamma * nkc2,
        [&](int ch) {
          const bf16* src;
          int rows_valid;
          if (ch < nproj) {
            const int k0 = ch * KC;
            rows_valid = C_in - k0;
            src = rows_valid > 0 ? wr + (size_t)k0 * C_out : wr;
          } else {
            const int g = (ch - nproj) / nkc2;
            const int k0 = (ch - nproj - g * nkc2) * KC;
            rows_valid = C_out - k0;
            src = rows_valid > 0 ? wt + ((size_t)g * C_out + k0) * C_out : wt;
          }
          tap::stage_tile(ring + (ch & 1) * KC * RP, RP, src, C_out, KC,
                          rows_valid, NB, C_out);
          tap::cp_async_commit();
        },
        [&](int ch) {
          if (!has_unit) return;
          const bf16* bs = ring + (ch & 1) * KC * RP;
          if (ch < nproj) {  // A straight from x in device memory
            const int k0 = ch * KC;
            const int steps = min(KC, tap::round16(C_in) - k0) / 16;
            for (int kk = 0; kk < steps; ++kk) {
              const int c = k0 + kk * 16 + 2 * (lane & 3);
              uint32_t af[2][4];
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const bf16* xr = xrow[mi][q & 1];
                  const int cq = c + 8 * (q >> 1);
                  af[mi][q] = pack2(elem(xr, cq, C_in), elem(xr, cq + 1, C_in));
                }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                uint32_t bf[4];
                tap::ldsm_x4_t(bf, tap::smem_u32(
                    bs + (kk * 16 + (lane & 15)) * RP + nb * 64 + j * 16 +
                    col8));
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                  tap::mma_bf16(acc[mi][2 * j], af[mi], bf[0], bf[1]);
                  tap::mma_bf16(acc[mi][2 * j + 1], af[mi], bf[2], bf[3]);
                }
              }
            }
            if (ch == nproj - 1) {  // round(x . Wr + br), then the taps
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int nj = 0; nj < 8; ++nj)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int o = nb * 64 + tap::acc_col(nj, 0, lane);
                    const float b0 = o < C_out ? p.br[o] : 0.f;
                    const float b1 = o + 1 < C_out ? p.br[o + 1] : 0.f;
                    pr[mi][nj][h] = pack2(acc[mi][nj][2 * h] + b0,
                                          acc[mi][nj][2 * h + 1] + b1);
                    acc[mi][nj][2 * h] = acc[mi][nj][2 * h + 1] = 0.f;
                  }
            }
            return;
          }
          const int g = (ch - nproj) / nkc2;
          const int k0 = (ch - nproj - g * nkc2) * KC;
          const int steps = min(KC, tap::round16(C_out) - k0) / 16;
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk) {
            if (kk >= steps) break;
            uint32_t a_addr[2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              a_addr[mi] = tap::smem_u32(zs + (size_t)(zrow[mi] + g * VG) * ZP +
                                         k0 + kk * 16 + col8);
            tap::mma_k16<2, 8>(
                acc, a_addr,
                tap::smem_u32(bs + (kk * 16 + (lane & 15)) * RP + nb * 64 +
                              col8));
          }
        });
    if (!has_unit) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mb * 32 + mi * 16 + (lane >> 2) + 8 * h;
        if (r >= rows) continue;
        const int t = r / vcount, vl = r - t * vcount;
        const int tg = t0 + t;
        const size_t xi = (((size_t)(v0 + vl) * p.N + n) * p.T + tg) * C_in;
        const size_t oi = (((size_t)(v0 + vl) * p.N + n) * p.T_out + tg) * C_out;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const int o = nb * 64 + tap::acc_col(nj, 0, lane);
          float u[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int oc = min(o + q, C_out - 1);
            float v = acc[mi][nj][2 * h + q] + p.bt[oc];
            if (!p.order_pre) v = affine_rn(v, p.s2[oc], p.t2[oc]);
            if (p.shortcut == 1) {
              v += __bfloat162float(x[xi + oc]);
            } else if (proj) {
              const __nv_bfloat162 pv =
                  *reinterpret_cast<const __nv_bfloat162*>(&pr[mi][nj][h]);
              v += q == 0 ? __low2float(pv) : __high2float(pv);
            }
            if (p.final_relu) v = fmaxf(v, 0.f);
            u[q] = v;
          }
          bf16* dst = out + oi + o;
          if (o + 1 < C_out && C_out % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(u[0], u[1]);
          } else {
            if (o < C_out) dst[0] = __float2bfloat16_rn(u[0]);
            if (o + 1 < C_out) dst[1] = __float2bfloat16_rn(u[1]);
          }
        }
      }
  }
}

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

template <int MAXR>
cudaError_t launch_mma(const Params& p, int smem_bytes, cudaStream_t stream) {
  auto kernel = block_eval_mma_kernel<MAXR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T_out + p.tt - 1) / p.tt, p.N, (p.V + p.vg - 1) / p.vg);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

// bf16 on the tensor-core kernel, float32 on the scalar one.
template <typename T>
cudaError_t dispatch_rows(const Params& p, int smem_bytes, cudaStream_t stream) {
  const int rg = kThreads / p.C_out;
  const int mr = (p.V + rg - 1) / rg;
  if constexpr (sizeof(T) == 2) {
    if (mr <= 8) return launch_mma<8>(p, smem_bytes, stream);
    if (mr <= 16) return launch_mma<16>(p, smem_bytes, stream);
    if (mr <= 32) return launch_mma<32>(p, smem_bytes, stream);
  } else {
    if (mr <= 8) return launch<T, 8>(p, smem_bytes, stream);
    if (mr <= 16) return launch<T, 16>(p, smem_bytes, stream);
    if (mr <= 32) return launch<T, 32>(p, smem_bytes, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int block_eval_launch(
    const void* x, const void* s1, const void* t1, const void* w,
    const void* b, const void* a, const void* wt, const void* bt,
    const void* s2, const void* t2, const void* wr, const void* br,
    const void* lengths, void* out, int V, int N, int T, int C_in, int C_out,
    int K, int gamma, int stride, int T_out, int tt, int vg, int order_pre,
    int shortcut, int relu1, int final_relu, int is_bf16, int smem_bytes,
    void* stream) {
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
  cudaError_t err = is_bf16 ? dispatch_rows<__nv_bfloat16>(p, smem_bytes, s)
                            : dispatch_rows<float>(p, smem_bytes, s);
  return (int)err;
}

extern "C" const char* block_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
