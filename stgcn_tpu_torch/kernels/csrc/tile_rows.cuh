// The rows of a tap GEMM tile, shared by the bf16 warpgroup kernels of
// temporal_block.cu and block_eval.cu: an implicit GEMM whose rows are
// (line, output frame) pairs flattened line by line, with a line one
// (joint, sequence) pair, reads each row's input frames at that row's own
// offset into the tile's staged rows (a strided frame walk and the taps'
// halo are offsets).  Here are the tile's geometry (Tile), the walk over
// its staged rows, their staging from device memory (cp.async where rows
// are 16-byte aligned, else plain loads; zero outside the frames [0, TT)
// and past the channels), and two pieces of an epilogue, which
// spatial_block.cu's dx kernel shares: a warp's column sums by halving
// exchanges and the paired bf16 store.

#pragma once

#include "tap_mma.cuh"
#include "wgmma.cuh"

namespace tile_rows {
namespace {  // each translation unit keeps its own copy

using tap::bf16;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The most input rows a tile of bm GEMM rows stages (temporal_block.py
// staged_rows): each line its rows touch needs (rows - 1) * walk + ntap,
// so rows split over seg lines need walk * (bm - seg) + seg * ntap, most
// with the most lines where ntap >= walk and with the fewest where
// ntap < walk (one tap at stride 2).
__host__ __device__ inline int staged_rows(int bm, int per_line, int walk,
                                           int ntap) {
  int seg = (bm - 1 + per_line - 1) / per_line + 1;
  if (seg > bm) seg = bm;
  if (ntap < walk) seg = (bm + per_line - 1) / per_line;
  return walk * (bm - seg) + seg * ntap;
}

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

constexpr int kNoFrame = -(1 << 30);  // a staged row that holds no frame

// The rows of a tile: `rows` flattened (line, j) rows from r0, J of them
// a line.  Their input frames are staged line by line: `first` rows of
// line l0 from row ja0, then whole lines, each line's rows needing
// (rows - 1) * walk + ntap frames from frame j0 * walk + off0 (the halo).
// With pad8 each line's frames start on a multiple of 8 staged rows (the
// dWt kernel's 8-row TMA boxes); the rows past a line's frames hold no
// frame and are never read.  Row r reads its tap i at staged row
// rowoff(r) + i; rows past the end read staged row 0 and are not stored.
struct Tile {
  int rows, J, walk, off0, l0, ja0, first, len_first, len_full, lp_first,
      lp_full, S;

  __device__ void init(int r0, int bm, int end, int J_, int walk_,
                       int ntap, int off0_, bool pad8 = false) {
    J = J_;
    walk = walk_;
    off0 = off0_;
    rows = min(bm, end - r0);
    l0 = r0 / J;
    ja0 = r0 - l0 * J;
    first = min(J - ja0, rows);
    len_first = (first - 1) * walk + ntap;
    len_full = (J - 1) * walk + ntap;
    lp_first = pad8 ? round_up(len_first, 8) : len_first;
    lp_full = pad8 ? round_up(len_full, 8) : len_full;
    const int rest = rows - first;
    const int tail = rest % J ? (rest % J - 1) * walk + ntap : 0;
    S = lp_first + (rest / J) * lp_full + (pad8 ? round_up(tail, 8) : tail);
  }
  __device__ int rowoff(int r) const {
    if (r < first) return r * walk;
    if (r >= rows) return 0;
    const int q = r - first;
    return lp_first + (q / J) * lp_full + (q % J) * walk;
  }
  // (line, frame) of staged row sr; kNoFrame on a padding row
  __device__ void frame(int sr, int& l, int& f) const {
    if (sr < lp_first) {
      l = l0;
      f = sr < len_first ? ja0 * walk + off0 + sr : kNoFrame;
    } else {
      const int q = sr - lp_first;
      l = l0 + 1 + q / lp_full;
      const int pos = q % lp_full;
      f = pos < len_full ? off0 + pos : kNoFrame;
    }
  }
};

// A position in a line-major walk over rows: line l (= n * V + v of an
// (N, T, V, C) tensor) and frame f, moved on without divisions.
struct LinePos {
  int l, n, v, f;
  __device__ void set(int line, int frame, int V) {
    l = line;
    n = line / V;
    v = line - n * V;
    f = frame;
  }
  __device__ void next_line(int V) {
    ++l;
    if (++v == V) {
      v = 0;
      ++n;
    }
  }
};

// line_at() of a walk position.
template <bool VM>
__device__ __forceinline__ size_t pos_at(const LinePos& p, int TT, int C,
                                         int V) {
  return VM ? ((size_t)p.l * TT + p.f) * C
            : (((size_t)p.n * TT + p.f) * V + p.v) * C;
}

// The staged rows sr, sr + step, ... of a tile: each one's line and frame,
// walked segment by segment (the first line's frames, then a line's at a
// time), with no division a row.
struct RowWalk {
  LinePos p;
  int f0, pos, len, lp;  // the line's first frame, row in it, frames, rows

  __device__ void init(const Tile& tl, int sr, int V) {
    int line;
    if (sr < tl.lp_first) {
      line = tl.l0;
      f0 = tl.ja0 * tl.walk + tl.off0;
      pos = sr;
      len = tl.len_first;
      lp = tl.lp_first;
    } else {
      const int q = sr - tl.lp_first;
      line = tl.l0 + 1 + q / tl.lp_full;
      f0 = tl.off0;
      pos = q % tl.lp_full;
      len = tl.len_full;
      lp = tl.lp_full;
    }
    p.set(line, 0, V);
    p.f = frame();
  }
  __device__ int frame() const { return pos < len ? f0 + pos : kNoFrame; }
  __device__ void advance(const Tile& tl, int step, int V) {
    pos += step;
    while (pos >= lp) {  // past the line's rows: into the next line's
      pos -= lp;
      p.next_line(V);
      f0 = tl.off0;
      len = tl.len_full;
      lp = tl.lp_full;
    }
    p.f = frame();
  }
};

// Staged row sr, columns c .. c + 7: at pitch P, or (SW) in 128-byte rows
// of 64 channels, 128B-swizzled (sw128()).
template <bool SW>
__device__ __forceinline__ bf16* staged_at(bf16* dst, int P, int sr, int c) {
  if constexpr (SW) {
    return reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(dst) +
                                   wg::sw128(sr, c >> 3));
  } else {
    return dst + (size_t)sr * P + c;
  }
}

// Copies of a tile's staged rows: `cols` columns (a multiple of 8) from
// column c0 of x's rows (C channels, a multiple of 8; TT frames), zero past
// C and on frames outside [0, TT), into dst at pitch P, by threads i, i + n,
// ...  All are cp.async, so every copy is in flight at once; the caller
// commits and waits.  Where n is a multiple of the pieces a row, a
// thread's pieces share one column and it walks their rows.
template <bool VM, bool SW = false>
__device__ __forceinline__ void copy_rows(bf16* dst, int P, const Tile& tl,
                                          const bf16* x, int TT, int C,
                                          int c0, int cols, int V, int i,
                                          int n) {
  const int pieces = cols / 8;
  if (n % pieces == 0) {
    const int step = n / pieces;
    const int c = (i % pieces) * 8;
    const bool col_ok = c0 + c < C;
    int sr = i / pieces;
    if (sr >= tl.S) return;
    RowWalk w;
    w.init(tl, sr, V);
    for (; sr < tl.S; sr += step) {
      const bool valid = col_ok && w.p.f >= 0 && w.p.f < TT;
      const bf16* src = valid ? x + pos_at<VM>(w.p, TT, C, V) + c0 + c : x;
      tap::cp_async16(tap::smem_u32(staged_at<SW>(dst, P, sr, c)), src,
                      valid ? 16 : 0);
      w.advance(tl, step, V);
    }
    return;
  }
  for (int e = i; e < tl.S * pieces; e += n) {
    const int sr = e / pieces;
    const int c = (e - sr * pieces) * 8;
    int l, f;
    tl.frame(sr, l, f);
    const bool valid = f >= 0 && f < TT && c0 + c < C;
    const bf16* src = valid ? x + line_at<VM>(l, f, TT, C, V) + c0 + c : x;
    tap::cp_async16(tap::smem_u32(staged_at<SW>(dst, P, sr, c)), src,
                    valid ? 16 : 0);
  }
}

// The affine and ReLU, rounded, of eight staged channels in place.
__device__ __forceinline__ void affine8(bf16* d, const float* sc,
                                        const float* sh, int relu2) {
  alignas(16) bf16 v[8];
  *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(d);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float h = tap::affine(__bfloat162float(v[k]), sc[k], sh[k]);
    if (relu2) h = fmaxf(h, 0.f);
    v[k] = __float2bfloat16_rn(h);
  }
  *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
}

// The affine and ReLU, rounded, in place over the rows copy_rows() brought
// in, by the same threads (each on its own copies, which its cp.async wait
// has made visible to it): valid frames and channels only, so the padding
// stays zero.  As copy_rows, a thread whose pieces share one column walks
// their rows with its eight scales and shifts in registers.
__device__ __forceinline__ void affine_rows(bf16* dst, int P, const Tile& tl,
                                            int TT, int C, int c0, int cols,
                                            const float* s2, const float* t2,
                                            int relu2, int V, int i, int n) {
  const int pieces = cols / 8;
  if (n % pieces == 0) {
    const int step = n / pieces;
    const int c = (i % pieces) * 8;
    int sr = i / pieces;
    if (c0 + c >= C || sr >= tl.S) return;
    float sc[8], sh[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sc[k] = s2[c0 + c + k];
      sh[k] = t2[c0 + c + k];
    }
    RowWalk w;
    w.init(tl, sr, V);
    for (; sr < tl.S; sr += step) {
      if (w.p.f >= 0 && w.p.f < TT)
        affine8(dst + (size_t)sr * P + c, sc, sh, relu2);
      w.advance(tl, step, V);
    }
    return;
  }
  for (int e = i; e < tl.S * pieces; e += n) {
    const int sr = e / pieces;
    const int c = (e - sr * pieces) * 8;
    int l, f;
    tl.frame(sr, l, f);
    if (f < 0 || f >= TT || c0 + c >= C) continue;
    affine8(dst + (size_t)sr * P + c, s2 + c0 + c, t2 + c0 + c, relu2);
  }
}

// Plain loads of the same rows where x's rows are not 16-byte aligned
// (C % 8 != 0), [through the affine and ReLU on the way].
template <bool AFF, bool VM, bool SW = false>
__device__ __forceinline__ void load_rows(bf16* dst, int P, const Tile& tl,
                                          const bf16* x, int TT, int C,
                                          int c0, int cols, const float* s2,
                                          const float* t2, int relu2, int V,
                                          int i, int n) {
  const int pieces = cols / 8;
  for (int e = i; e < tl.S * pieces; e += n) {
    const int sr = e / pieces;
    const int c = (e - sr * pieces) * 8;
    int l, f;
    tl.frame(sr, l, f);
    const bool valid = f >= 0 && f < TT;
    const bf16* row = x + (valid ? line_at<VM>(l, f, TT, C, V) + c0 : 0);
    tap::stage8<AFF>(staged_at<SW>(dst, P, sr, c), row, c, C - c0, valid,
                     s2 + c0, t2 + c0, relu2);
  }
}

// Stage a tile's rows by threads i, i + n, ...: copy_rows (then
// affine_rows with AFF) where x's rows are 16-byte aligned, else
// load_rows.  The caller publishes them with a barrier.
template <bool AFF, bool VM>
__device__ __forceinline__ void stage_rows(bf16* dst, int P, const Tile& tl,
                                           const bf16* x, int TT, int C,
                                           int c0, int cols, const float* s2,
                                           const float* t2, int relu2, int V,
                                           int i, int n) {
  if (C % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    copy_rows<VM>(dst, P, tl, x, TT, C, c0, cols, V, i, n);
    tap::cp_async_commit();
    tap::cp_async_wait<0>();
    if constexpr (AFF)
      affine_rows(dst, P, tl, TT, C, c0, cols, s2, t2, relu2, V, i, n);
  } else {
    load_rows<AFF, VM>(dst, P, tl, x, TT, C, c0, cols, s2, t2, relu2, V, i,
                       n);
  }
}

// One halving exchange of a warp's column sums across lane bit BIT: the
// lanes with the bit set keep part[HALF .. 2 HALF), the others part[0 ..
// HALF), each adding its partner's copy of what it keeps into part[0 ..
// HALF).
template <int HALF, int BIT>
__device__ __forceinline__ void halve(float (&part)[32], int lane) {
  const bool upper = (lane >> BIT) & 1;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = upper ? part[HALF + i] : part[i];
    const float give = upper ? part[i] : part[HALF + i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, give, 1 << BIT);
  }
}

// Two neighbouring columns o, o + 1 of a bf16 row, rounded; one paired
// store where both exist and the row's width is even.
__device__ __forceinline__ void store2(bf16* dst, const float (&v)[2], int o,
                                       int n, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(v[0], v[1]);
  } else {
    if (o < n) dst[0] = __float2bfloat16_rn(v[0]);
    if (o + 1 < n) dst[1] = __float2bfloat16_rn(v[1]);
  }
}

}  // namespace
}  // namespace tile_rows
