// A warp-level bf16 product on Hopper's tensor cores (mma.sync), shared by
// the bf16 kernels of temporal_block.cu, block_eval.cu and spatial_block.cu.
//
// The pieces:
//   * ldmatrix reads the bf16 operands from shared memory: A row-major
//     (x4), or A stored K-major (x4.trans, as the dWt and dW kernels read
//     their A); B stored K-major, [k][n], with x4.trans, or N-major with a
//     plain x4 (mma_k16_nk).
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 multiplies, with
//     float32 accumulators in registers.  A warp owns a 16*MI x 8*NJ tile:
//     the per-frame aggregations of block_eval.cu and spatial_block.cu
//     (the 32 x 32 adjacency times 16 columns), the spatial backward's t_k
//     and dA.
//   * Shared rows have a padded pitch of round16(C) + 8 bf16: consecutive
//     rows start 16 bytes apart modulo 128, so the eight row addresses of
//     one ldmatrix phase fall in eight different bank groups, and every row
//     starts 16-byte aligned.
//   * cp.async copies 16 bytes a thread (zero-filled past the valid bytes)
//     for the kernels' own row staging.
//   * stage8() stages activation rows [through an affine and ReLU, rounded
//     to bf16 on the way].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tap {
namespace {  // each translation unit keeps its own copy

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;        // bf16 elements of padding on each shared row

__host__ __device__ constexpr int round16(int c) { return (c + 15) / 16 * 16; }
// Pitch, in elements, of a shared row holding c channels.
__host__ __device__ constexpr int pitch_of(int c) { return round16(c) + kPad; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from src to shared dst; bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lane addresses.  A warp tile's m16 block i starts at tile row 16*i; the
// lane supplies the address of one row of one 8x8 matrix:
//   a_lane_row(): row (lane & 15) of the m16 block, column offset
//     (lane >> 4) * 8 (A row-major, [m][k]; add it to the row's address);
//   b_lane_row(): k row (lane & 15) of the k16 step, column offset
//     (lane >> 4) * 8 (B K-major, [k][n], read transposed);
//   at_lane_row()/at_lane_col(): k row (lane & 7) + (lane >> 4) * 8 and m
//     column ((lane >> 3) & 1) * 8 (A stored K-major, [k][m], transposed).
__device__ __forceinline__ int a_lane_row(int lane) { return lane & 15; }
__device__ __forceinline__ int lane_col8(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int at_lane_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int at_lane_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

// acc[MI][NJ] += A (16*MI x 16) . B (16 x 8*NJ), one k16 step, with the A
// fragments already in registers (loaded once with ldsm_x4 and reused
// across column tiles, as the 32 x 32 adjacency is); b_addr: shared
// address of B row (step's k + (lane & 15)) at the warp tile's first
// column plus lane_col8(lane).
template <int MI, int NJ>
__device__ __forceinline__ void mma_k16_frag(float (&acc)[MI][NJ][4],
                                             const uint32_t (&a)[MI][4],
                                             uint32_t b_addr) {
  static_assert(NJ % 2 == 0, "B is read 16 columns at a time");
#pragma unroll
  for (int j = 0; j < NJ / 2; ++j) {
    uint32_t b[4];
    ldsm_x4_t(b, b_addr + j * 16 * (uint32_t)sizeof(bf16));
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      mma_bf16(acc[i][2 * j], a[i], b[0], b[1]);
      mma_bf16(acc[i][2 * j + 1], a[i], b[2], b[3]);
    }
  }
}

// acc[2] (two n8 blocks) += A (16 x 16) . B (16 x 16) with B stored
// N-major, [n][k] (the transpose of the usual [k][n]), read by a plain
// ldmatrix.x4: a_addr the shared address of this lane's A row
// (a_lane_row) at the step's first column plus lane_col8(lane); b_addr
// the shared address of B row n = at_lane_row(lane) (n rows 0-15 of the
// tile) at k column at_lane_col(lane).  Matrices 0-3 are (n 0-7, k 0-7), (n 0-7, k 8-15),
// (n 8-15, k 0-7), (n 8-15, k 8-15): b0, b1 of each n8 block.
__device__ __forceinline__ void mma_k16_nk(float (&acc)[2][4],
                                           uint32_t a_addr, uint32_t b_addr) {
  uint32_t a[4], b[4];
  ldsm_x4(a, a_addr);
  ldsm_x4(b, b_addr);
  mma_bf16(acc[0], a, b[0], b[1]);
  mma_bf16(acc[1], a, b[2], b[3]);
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Position of accumulator element e (0..3) of fragment (i, j) in the warp
// tile: row 16*i + (lane >> 2) + 8*(e >> 1), column 8*j + 2*(lane & 3) +
// (e & 1).
__device__ __forceinline__ int acc_row(int i, int e, int lane) {
  return 16 * i + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int j, int e, int lane) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

// The affine's input to the ReLU, rounded as torch rounds it (no FMA).
__device__ __forceinline__ float affine(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);
}

// Eight channels c .. c+7 of one activation row into shared memory: zero
// where !valid (a padding frame, a row past the tile) or past C; [through
// the affine v * scale[c] + shift[c] and, with relu, the ReLU, rounded,
// with AFF].  Vector loads where C is a multiple of 8 (the row then starts
// 16-byte aligned).
template <bool AFF>
__device__ __forceinline__ void stage8(bf16* dst, const bf16* row, int c,
                                       int C, bool valid, const float* scale,
                                       const float* shift, int relu) {
  alignas(16) bf16 v[8];
  if (valid && C % 8 == 0 && c < C) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(row + c);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = (valid && c + k < C) ? row[c + k] : __float2bfloat16_rn(0.f);
  }
  if constexpr (AFF) {
    if (valid) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (c + k >= C) break;
        float x = affine(__bfloat162float(v[k]), scale[c + k], shift[c + k]);
        if (relu) x = fmaxf(x, 0.f);
        v[k] = __float2bfloat16_rn(x);
      }
    }
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

}  // namespace
}  // namespace tap
