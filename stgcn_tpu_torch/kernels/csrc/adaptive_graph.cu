// 2s-AGCN's adaptive graph and its per-sample aggregation, bf16 on Hopper.
//
// Activations are V-major (V, NM, T, C) bf16 rows, as the port's train ops
// take them; `NM` counts the bodies of every clip.  For a unit with K
// subsets and embedding width Ce (stgcn_tpu_torch/kernels/adaptive_graph.py
// holds the plain versions, same rounding points):
//
//   E      = round(x . W + b)                (W: C_in x 2K*Ce, theta then phi)
//   S_k[n] = sum_{t,c} theta_k[i,n,t,c] phi_k[j,n,t,c] / (Ce*T)   (float32)
//   C_k[n] = softmax over i of S_k[n]        (float32, column softmax)
//   z[w,n,t,k*C+c] = round(sum_v Ahat[n,k,v,w] x[v,n,t,c])   (Ahat float32)
//
// Kernels:
// * agcn_gemm_kernel: C = op(A) op(B) (+ bias) on the tensor cores (WMMA
//   16x16x16 bf16, float32 accumulation), 64x64 tiles of 4 warps, k in
//   steps of 32 through two stages of shared memory.  Each operand's tile
//   is copied as it lies in memory (cp.async, 16 bytes, where a run of 8
//   is whole and aligned), and a transposed operand is read by a
//   column-major fragment; a split
//   over k writes float32 partial slices that the wrapper sums in order.
//   It is the embedding (x . W), its dx (dE . W^T) and its dW (x^T . dE).
// * agcn_gram_kernel: a CTA a (sample, subset) and a split of the depth:
//   the Gram of two row sets over (t, c), a chunk of depth at a time
//   staged depth-major in shared memory as float32 (16-byte loads where
//   the widths allow) with the joints padded to a multiple of 4, each
//   thread a 4x4 tile of the output over a share of the chunk (two 16-byte
//   reads for 16 multiply-adds), written to a partial slice;
//   agcn_gram_finish_kernel adds the slices in order and, with `softmax`,
//   scales and takes the column softmax (the adaptive graph), without it
//   writes the raw sums (dAhat of the aggregation, with x and dz as the two
//   row sets).
// * agcn_gram_bwd_kernel: one CTA a (sample, subset) and a share of the
//   depth: dS from C and dC (softmax backward, scaled) and its transpose
//   in shared memory, then for every (t, c) dtheta = dS . phi and
//   dphi = dS^T . theta into dE, dS's rows read 4 at a time.
// * agcn_agg_fwd_kernel / agcn_agg_bwd_kernel: a thread two (t, c)
//   columns of one sample (one in the backward), their V joints (K x V
//   gradients) in registers, Ahat of the sample in shared memory laid out
//   so that each output's weights are contiguous (16-byte broadcast
//   reads): z for every (k, w), or dx from dz.
//
// Plain C interface (no PyTorch header); every launcher returns a
// cudaError_t as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace agcn {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int KMAX = 4;        // subsets a kernel takes

// ---- GEMM ------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int PAD = 8;         // keeps 16-row fragments 32-byte aligned
constexpr int GEMM_THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + R) x cols [c0, c0 + CC) of a row-major matrix (ld)
// into shared memory (ld_dst), zero outside rows < r_lim, cols < c_lim:
// runs of 8 that are whole and aligned by cp.async (in flight until the
// group is waited for), the rest by plain loads.
template <int R, int CC>
__device__ __forceinline__ void load_tile(bf16* dst, int ld_dst,
                                          const bf16* __restrict__ src,
                                          int ld, int r0, int c0, int r_lim,
                                          int c_lim, int tid) {
  const bool vec = (ld % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(src) % 16 == 0);
  for (int idx = tid; idx < R * (CC / 8); idx += GEMM_THREADS) {
    const int r = idx / (CC / 8), cc = (idx % (CC / 8)) * 8;
    const int gr = r0 + r, gc = c0 + cc;
    bf16* d = dst + r * ld_dst + cc;
    if (vec && gr < r_lim && gc + 8 <= c_lim) {
      cp_async16(d, src + (int64_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (gr < r_lim && gc + e < c_lim)
                   ? src[(int64_t)gr * ld + gc + e] : __float2bfloat16(0.0f);
    }
  }
}

// A(m, k) = A_T ? a[k * lda + m] : a[m * lda + k]
// B(k, n) = B_T ? b[n * ldb + k] : b[k * ldb + n]
// out[z][m][n] (float32 partial slice z of the split) or out[m][n] bf16,
// + bias[n] (bf16 out only).  Two stages: the next k step's tiles load
// while the tensor cores work on this one's.
template <bool A_T, bool B_T, bool OUT_F32>
__global__ void __launch_bounds__(GEMM_THREADS)
agcn_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 const float* __restrict__ bias, void* __restrict__ out,
                 int M, int N, int K, int lda, int ldb, int kchunk) {
  // A's tile as it lies: (m, k) rows of BK, or (k, m) rows of BM
  constexpr int A_LD = (A_T ? BM : BK) + PAD;
  constexpr int B_LD = (B_T ? BK : BN) + PAD;
  constexpr int A_SZ = (A_T ? BK : BM) * A_LD;
  constexpr int B_SZ = (B_T ? BN : BK) * B_LD;
  __shared__ __align__(128) bf16 As[2][A_SZ];
  __shared__ __align__(128) bf16 Bs[2][B_SZ];
  __shared__ __align__(128) float Cs[4][16 * 16];
  using ALayout = typename std::conditional<A_T, wmma::col_major,
                                            wmma::row_major>::type;
  using BLayout = typename std::conditional<B_T, wmma::col_major,
                                            wmma::row_major>::type;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  auto stage = [&](int buf, int k0) {
    if (A_T) load_tile<BK, BM>(As[buf], A_LD, a, lda, k0, m0, kend, M, tid);
    else load_tile<BM, BK>(As[buf], A_LD, a, lda, m0, k0, M, kend, tid);
    if (B_T) load_tile<BN, BK>(Bs[buf], B_LD, b, ldb, n0, k0, N, kend, tid);
    else load_tile<BK, BN>(Bs[buf], B_LD, b, ldb, k0, n0, kend, N, tid);
    cp_async_commit();
  };
  if (kbeg < kend) stage(0, kbeg);
  for (int k0 = kbeg, it = 0; k0 < kend; k0 += BK, ++it) {
    const int buf = it & 1;
    if (k0 + BK < kend) {
      stage(buf ^ 1, k0 + BK);
      cp_async_wait<1>();            // this step's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* at = As[buf];
    const bf16* bt = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + 16 * i;
        wmma::load_matrix_sync(fa[i], A_T ? at + kk * A_LD + m
                                          : at + m * A_LD + kk, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + 16 * j;
        wmma::load_matrix_sync(fb[j], B_T ? bt + n * B_LD + kk
                                          : bt + kk * B_LD + n, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();                 // the buffer is free for the next load
  }
  float* cs = Cs[warp];
  float* outf = static_cast<float*>(out) + (int64_t)blockIdx.z * M * N;
  bf16* outb = static_cast<bf16*>(out);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm + 16 * i + e / 16;
        const int gn = n0 + wn + 16 * j + e % 16;
        if (gm < M && gn < N) {
          float v = cs[e];
          if (OUT_F32) {
            outf[(int64_t)gm * N + gn] = v;
          } else {
            if (bias != nullptr) v += bias[gn];
            outb[(int64_t)gm * N + gn] = __float2bfloat16(v);
          }
        }
      }
      __syncwarp();
    }
}

// ---- Gram over (t, c), optional scaled column softmax ----------------------

constexpr int DC = 128;        // depth of a staged chunk
constexpr int VP = 28;         // joints padded to a multiple of 4 (V <= 28)
constexpr int TB = VP / 4;     // 4x4 output tiles along a side
constexpr int GROUPS = 5;      // threads a tile, over the chunk's depth
constexpr int GRAM_THREADS = TB * TB * GROUPS;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// P row i of sample n, subset k, depth (t, c):
//   p[((i * NM + n) * T + t) * ldp + offp + k * kstep_p + c]
struct GramArgs {
  const bf16* p; int ldp, offp, kstep_p;
  const bf16* q; int ldq, offq, kstep_q;
  int nm, t, w, k, v;
  int vec;                     // 8-wide loads: w, ld, offsets, bases allow
  int64_t per_split;           // depth a split, a multiple of DC
  float* partial;              // (splits, NM * K, VP * VP)
};

// one row's run of DC depth elements into shared memory, as float32
__device__ __forceinline__ void stage_row(float (*dst)[VP], int i,
                                          const bf16* __restrict__ src,
                                          int64_t row0, int ld, int off,
                                          int w, int64_t d0, int64_t d_end,
                                          int vec, int tid, int nthreads,
                                          int V) {
  if (vec) {
    for (int u = tid; u < DC / 8; u += nthreads) {
      const int64_t d = d0 + 8 * u;
      float v8[8] = {};
      if (i < V && d < d_end) {
        const int64_t t = d / w, c = d % w;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + (row0 + t) * ld + off + c);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v8[j] = __bfloat162float(e[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[8 * u + j][i] = v8[j];
    }
  } else {
    for (int dd = tid; dd < DC; dd += nthreads) {
      const int64_t d = d0 + dd;
      float v = 0.0f;
      if (i < V && d < d_end) {
        const int64_t t = d / w, c = d % w;
        v = __bfloat162float(src[(row0 + t) * ld + off + c]);
      }
      dst[dd][i] = v;
    }
  }
}

// partial[split][n*K + k] = the Gram over the split's share of the depth
__global__ void __launch_bounds__(GRAM_THREADS)
agcn_gram_kernel(GramArgs g) {
  __shared__ __align__(16) float Ps[DC][VP];
  __shared__ __align__(16) float Qs[DC][VP];
  __shared__ __align__(16) float red[GROUPS][VP * VP];
  const int n = blockIdx.x / g.k, k = blockIdx.x % g.k;
  const int V = g.v, tid = threadIdx.x;
  const int grp = tid / (TB * TB), tile = tid % (TB * TB);
  const int i0 = (tile / TB) * 4, j0 = (tile % TB) * 4;
  float acc[4][4] = {};
  const int64_t depth = (int64_t)g.t * g.w;
  const int64_t d_beg = (int64_t)blockIdx.y * g.per_split;
  const int64_t d_end = min(depth, d_beg + g.per_split);
  const int offp = g.offp + k * g.kstep_p, offq = g.offq + k * g.kstep_q;
  // the staging threads: a warp's worth a row, rows spread over the CTA
  const int lanes = 8, rows_at_once = GRAM_THREADS / lanes;
  const int r_of = tid / lanes, l_of = tid % lanes;
  for (int64_t d0 = d_beg; d0 < d_end; d0 += DC) {
    for (int i = r_of; i < VP; i += rows_at_once) {
      const int64_t row0 = ((int64_t)min(i, V - 1) * g.nm + n) * g.t;
      stage_row(Ps, i, g.p, row0, g.ldp, offp, g.w, d0, d_end, g.vec, l_of,
                lanes, V);
      stage_row(Qs, i, g.q, row0, g.ldq, offq, g.w, d0, d_end, g.vec, l_of,
                lanes, V);
    }
    __syncthreads();
    if (grp < GROUPS) {
      for (int dd = grp; dd < DC; dd += GROUPS) {
        const float4 p = ld4(&Ps[dd][i0]), q = ld4(&Qs[dd][j0]);
        const float pa[4] = {p.x, p.y, p.z, p.w};
        const float qa[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] += pa[a] * qa[b];
      }
    }
    __syncthreads();
  }
  if (grp < GROUPS) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) red[grp][(i0 + a) * VP + j0 + b] = acc[a][b];
  }
  __syncthreads();
  float* part = g.partial +
      ((int64_t)blockIdx.y * g.nm * g.k + blockIdx.x) * VP * VP;
  for (int o = tid; o < VP * VP; o += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < GROUPS; ++q) s += red[q][o];
    part[o] = s;
  }
}

// the splits' partial Grams summed in order; with `softmax` scaled and the
// column softmax taken (the adaptive graph), else the raw sums (dAhat)
__global__ void agcn_gram_finish_kernel(const float* __restrict__ partial,
                                        int splits, int nmk, int V,
                                        float scale, int softmax,
                                        float* __restrict__ out_all) {
  __shared__ float sm[VP * VP];
  __shared__ float ex[VP * VP];
  const int tid = threadIdx.x;
  for (int o = tid; o < VP * VP; o += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < splits; ++q)
      s += partial[((int64_t)q * nmk + blockIdx.x) * VP * VP + o];
    sm[o] = s;
  }
  __syncthreads();
  float* out = out_all + (int64_t)blockIdx.x * V * V;
  if (!softmax) {
    for (int o = tid; o < V * V; o += blockDim.x)
      out[o] = sm[(o / V) * VP + o % V];
    return;
  }
  if (tid < V) {             // the column softmax over i of column tid
    const int col = tid;
    float mx = -INFINITY;
    for (int i = 0; i < V; ++i) mx = fmaxf(mx, sm[i * VP + col] * scale);
    float sum = 0.0f;
    for (int i = 0; i < V; ++i) {
      const float e = expf(sm[i * VP + col] * scale - mx);
      ex[i * VP + col] = e;
      sum += e;
    }
    const float inv = 1.0f / sum;
    for (int i = 0; i < V; ++i) out[i * V + col] = ex[i * VP + col] * inv;
  }
}

// ---- softmax backward and the Gram's dtheta / dphi -------------------------

struct GramBwdArgs {
  const float* c;              // (NM, K, V, V) the softmax
  const float* dc;             // its gradient
  const bf16* e;               // (V, NM, T, ld): theta_k at k*ce, phi_k at (K+k)*ce
  bf16* de;
  int ld, nm, t, ce, k, v;
  float scale;
};

__global__ void agcn_gram_bwd_kernel(GramBwdArgs g) {
  __shared__ __align__(16) float ds[VP * VP];    // dS[i][j]
  __shared__ __align__(16) float dst[VP * VP];   // dS[j][i]
  __shared__ float colsum[VP];
  const int n = blockIdx.x / g.k, k = blockIdx.x % g.k;
  const int V = g.v, tid = threadIdx.x;
  const float* c = g.c + ((int64_t)n * g.k + k) * V * V;
  const float* dc = g.dc + ((int64_t)n * g.k + k) * V * V;
  if (tid < V) {
    float s = 0.0f;
    for (int i = 0; i < V; ++i) s += c[i * V + tid] * dc[i * V + tid];
    colsum[tid] = s;
  }
  __syncthreads();
  for (int o = tid; o < VP * VP; o += blockDim.x) {
    const int i = o / VP, j = o % VP;
    float v = 0.0f;
    if (i < V && j < V)
      v = c[i * V + j] * (dc[i * V + j] - colsum[j]) * g.scale;
    ds[i * VP + j] = v;
    dst[j * VP + i] = v;
  }
  __syncthreads();
  const int64_t depth = (int64_t)g.t * g.ce;
  const int off_t = k * g.ce, off_p = (g.k + k) * g.ce;
  const int64_t jstride = (int64_t)g.nm * g.t * g.ld;   // a joint's rows
  for (int64_t d = (int64_t)blockIdx.y * blockDim.x + tid; d < depth;
       d += (int64_t)gridDim.y * blockDim.x) {
    const int64_t t = d / g.ce, cc = d % g.ce;
    const int64_t base = ((int64_t)n * g.t + t) * g.ld + cc;
    float th[VP], ph[VP];
#pragma unroll
    for (int i = 0; i < VP; ++i) {
      th[i] = i < V ? __bfloat162float(g.e[i * jstride + base + off_t]) : 0.0f;
      ph[i] = i < V ? __bfloat162float(g.e[i * jstride + base + off_p]) : 0.0f;
    }
#pragma unroll 1
    for (int i = 0; i < V; ++i) {
      float dth = 0.0f, dph = 0.0f;
#pragma unroll
      for (int j = 0; j < VP; j += 4) {
        const float4 r = ld4(&ds[i * VP + j]), s = ld4(&dst[i * VP + j]);
        dth += r.x * ph[j] + r.y * ph[j + 1] + r.z * ph[j + 2] + r.w * ph[j + 3];
        dph += s.x * th[j] + s.y * th[j + 1] + s.z * th[j + 2] + s.w * th[j + 3];
      }
      g.de[i * jstride + base + off_t] = __float2bfloat16(dth);
      g.de[i * jstride + base + off_p] = __float2bfloat16(dph);
    }
  }
}

// ---- per-sample aggregation ------------------------------------------------

constexpr int AGG_THREADS = 256;

constexpr int AGG_COLS = 2;    // (t, c) columns a thread

// z[w, n, t, k*C + c] = round(sum_v a[n, k, v, w] x[v, n, t, c]); the
// sample's a in shared memory as as[k][w][v], v padded to VP with zeros;
// a thread AGG_COLS columns, so each 16-byte read feeds 8 multiply-adds
__global__ void __launch_bounds__(AGG_THREADS)
agcn_agg_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                    bf16* __restrict__ z, int nm, int T, int C, int K,
                    int V) {
  __shared__ __align__(16) float as[KMAX * VP * VP];
  const int n = blockIdx.y;
  for (int o = threadIdx.x; o < K * VP * VP; o += blockDim.x) {
    const int k = o / (VP * VP), w = (o / VP) % VP, v = o % VP;
    as[o] = (v < V && w < V) ? a[(((int64_t)n * K + k) * V + v) * V + w]
                             : 0.0f;
  }
  __syncthreads();
  const int64_t tc = (int64_t)T * C;
  const int64_t col0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) *
                       AGG_COLS;
  if (col0 >= tc) return;
  const int64_t vstride = (int64_t)nm * T * C;
  const int64_t zw = (int64_t)nm * T * K * C;   // a joint's rows of z
  float xv[AGG_COLS][VP];
  int64_t zbase[AGG_COLS];
#pragma unroll
  for (int q = 0; q < AGG_COLS; ++q) {
    const int64_t col = min(col0 + q, tc - 1);
    const int64_t t = col / C, c = col % C;
    const int64_t xbase = ((int64_t)n * T + t) * C + c;
    zbase[q] = ((int64_t)n * T + t) * K * C + c;
#pragma unroll
    for (int v = 0; v < VP; ++v)
      xv[q][v] = v < V ? __bfloat162float(x[v * vstride + xbase]) : 0.0f;
  }
  for (int k = 0; k < K; ++k) {
#pragma unroll 1
    for (int w = 0; w < V; ++w) {
      const float* aw = as + (k * VP + w) * VP;
      float s[AGG_COLS] = {};
#pragma unroll
      for (int v = 0; v < VP; v += 4) {
        const float4 r = ld4(aw + v);
#pragma unroll
        for (int q = 0; q < AGG_COLS; ++q)
          s[q] += r.x * xv[q][v] + r.y * xv[q][v + 1] + r.z * xv[q][v + 2] +
                  r.w * xv[q][v + 3];
      }
#pragma unroll
      for (int q = 0; q < AGG_COLS; ++q)
        if (col0 + q < tc)
          z[w * zw + zbase[q] + (int64_t)k * C] = __float2bfloat16(s[q]);
    }
  }
}

// dx[v, n, t, c] = round(sum_k sum_w a[n, k, v, w] dz[w, n, t, k*C + c]);
// a in shared memory as as[v][k][w] (w padded to VP with zeros), so that
// one output's K * VP weights are contiguous; a thread one column, its
// K x V gradients in registers
__global__ void __launch_bounds__(AGG_THREADS)
agcn_agg_bwd_kernel(const bf16* __restrict__ dz, const float* __restrict__ a,
                    bf16* __restrict__ dx, int nm, int T, int C, int K,
                    int V) {
  __shared__ __align__(16) float as[VP * KMAX * VP];
  const int n = blockIdx.y;
  for (int o = threadIdx.x; o < VP * K * VP; o += blockDim.x) {
    const int v = o / (K * VP), k = (o / VP) % K, w = o % VP;
    as[o] = (v < V && w < V) ? a[(((int64_t)n * K + k) * V + v) * V + w]
                             : 0.0f;
  }
  __syncthreads();
  const int64_t tc = (int64_t)T * C;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= tc) return;
  const int64_t t = col / C, c = col % C;
  const int64_t zw = (int64_t)nm * T * K * C;
  const int64_t zbase = ((int64_t)n * T + t) * K * C + c;
  float g[KMAX][VP];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int w = 0; w < VP; ++w)
      g[k][w] = (k < K && w < V)
                    ? __bfloat162float(dz[w * zw + zbase + (int64_t)k * C])
                    : 0.0f;
  const int64_t vstride = (int64_t)nm * T * C;
  const int64_t xbase = ((int64_t)n * T + t) * C + c;
#pragma unroll 1
  for (int v = 0; v < V; ++v) {
    const float* av = as + v * K * VP;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
#pragma unroll
        for (int w = 0; w < VP; w += 4) {
          const float4 r = ld4(av + k * VP + w);
          s += r.x * g[k][w] + r.y * g[k][w + 1] + r.z * g[k][w + 2] +
               r.w * g[k][w + 3];
        }
      }
    }
    dx[v * vstride + xbase] = __float2bfloat16(s);
  }
}

template <bool A_T, bool B_T, bool OUT_F32>
static int gemm(const bf16* a, const bf16* b, const float* bias, void* out,
                int M, int N, int K, int lda, int ldb, int splits, int kchunk,
                cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  agcn_gemm_kernel<A_T, B_T, OUT_F32><<<grid, GEMM_THREADS, 0, s>>>(
      a, b, bias, out, M, N, K, lda, ldb, kchunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace agcn

using agcn::bf16;

// C = op(A) op(B) (+ bias): mode 0 bf16 out with bias (A, B as stored),
// mode 1 bf16 out, B transposed (dE . W^T), mode 2 float32 partial slices,
// A transposed (x^T . dE), `splits` slices of `kchunk` rows of k.
extern "C" int agcn_gemm_launch(const void* a, const void* b, const void* bias,
                                void* out, int M, int N, int K, int lda,
                                int ldb, int mode, int splits, int kchunk,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  const float* pbias = static_cast<const float*>(bias);
  switch (mode) {
    case 0: return agcn::gemm<false, false, false>(pa, pb, pbias, out, M, N, K,
                                                   lda, ldb, 1, K, s);
    case 1: return agcn::gemm<false, true, false>(pa, pb, nullptr, out, M, N, K,
                                                  lda, ldb, 1, K, s);
    case 2: return agcn::gemm<true, false, true>(pa, pb, nullptr, out, M, N, K,
                                                 lda, ldb, splits, kchunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// partial: (splits, NM * K, 28 * 28) float32 scratch
extern "C" int agcn_gram_launch(const void* p, int ldp, int offp, int kstep_p,
                                const void* q, int ldq, int offq, int kstep_q,
                                int nm, int t, int w, int k, int v,
                                float scale, int softmax, int splits,
                                void* partial, void* out, void* stream) {
  if (v > agcn::VP || v < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto al = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  const int vec = w % 8 == 0 && ldp % 8 == 0 && ldq % 8 == 0 &&
                  offp % 8 == 0 && offq % 8 == 0 && kstep_p % 8 == 0 &&
                  kstep_q % 8 == 0 && al(p) && al(q);
  const int64_t depth = (int64_t)t * w;
  int64_t per = (depth + splits - 1) / splits;
  per = (per + agcn::DC - 1) / agcn::DC * agcn::DC;
  agcn::GramArgs g{static_cast<const bf16*>(p), ldp, offp, kstep_p,
                   static_cast<const bf16*>(q), ldq, offq, kstep_q,
                   nm, t, w, k, v, vec, per, static_cast<float*>(partial)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int used = (int)((depth + per - 1) / per);
  agcn::agcn_gram_kernel<<<dim3(nm * k, used), agcn::GRAM_THREADS, 0, s>>>(g);
  agcn::agcn_gram_finish_kernel<<<nm * k, 32, 0, s>>>(
      static_cast<const float*>(partial), used, nm * k, v, scale, softmax,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int agcn_gram_bwd_launch(const void* c, const void* dc,
                                    const void* e, void* de, int ld, int nm,
                                    int t, int ce, int k, int v, float scale,
                                    int splits, void* stream) {
  if (v > agcn::VP || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  agcn::GramBwdArgs g{static_cast<const float*>(c),
                      static_cast<const float*>(dc),
                      static_cast<const bf16*>(e), static_cast<bf16*>(de),
                      ld, nm, t, ce, k, v, scale};
  dim3 grid(nm * k, splits);
  agcn::agcn_gram_bwd_kernel<<<grid, 128, 0,
                               static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int agcn_agg_launch(const void* src, const void* a, void* dst,
                               int nm, int t, int c, int k, int v,
                               int backward, void* stream) {
  if (v > agcn::VP || v < 1 || k > agcn::KMAX || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t units =
      backward ? (int64_t)t * c
               : ((int64_t)t * c + agcn::AGG_COLS - 1) / agcn::AGG_COLS;
  dim3 grid((unsigned)((units + agcn::AGG_THREADS - 1) / agcn::AGG_THREADS),
            nm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (backward)
    agcn::agcn_agg_bwd_kernel<<<grid, agcn::AGG_THREADS, 0, s>>>(
        static_cast<const bf16*>(src), static_cast<const float*>(a),
        static_cast<bf16*>(dst), nm, t, c, k, v);
  else
    agcn::agcn_agg_fwd_kernel<<<grid, agcn::AGG_THREADS, 0, s>>>(
        static_cast<const bf16*>(src), static_cast<const float*>(a),
        static_cast<bf16*>(dst), nm, t, c, k, v);
  return static_cast<int>(cudaGetLastError());
}
