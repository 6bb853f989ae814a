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
// Design.  This first version is plain scalar FMA on the CUDA cores, on
// purpose far from that bound: it is the simple kernel that is right, and
// tensor-core (wgmma) tiles are later work.  One CTA of 256 threads takes
// one sequence, a tile of TT output frames and a group of VG joints
// (VG = V unless the tile would not fit in shared memory, as for float32 at
// C_out = 256).  It computes z for the TF = (TT-1)*s + gamma input frames
// that its taps read, one frame at a time, and keeps them in shared memory:
// z never goes to device memory.  It then runs the gamma taps from shared
// memory, with weights read through L1/L2.  Neighbouring tiles recompute
// the spatial part of their overlapping frames: TF/(TT*s) times the
// spatial work, about 20% of a block's operations.
//
// Launch contract (checked by the Python wrapper before the call): C_out
// <= 256; V <= MAXR * (256 / C_out); the dynamic shared memory is
// sizeof(T) * (TF*VG*C_out + V*C_in + V*C_out) bytes and at most 227 KB.
// The launcher returns cudaGetLastError() after the launch.

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

template <typename T>
cudaError_t dispatch_rows(const Params& p, int smem_bytes, cudaStream_t stream) {
  const int rg = kThreads / p.C_out;
  const int mr = (p.V + rg - 1) / rg;
  if (mr <= 8) return launch<T, 8>(p, smem_bytes, stream);
  if (mr <= 16) return launch<T, 16>(p, smem_bytes, stream);
  if (mr <= 32) return launch<T, 32>(p, smem_bytes, stream);
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
