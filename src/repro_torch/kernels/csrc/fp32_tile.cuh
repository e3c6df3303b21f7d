// Kernel 5's fp32 register-blocked tile (distance_matrix.cu), as kernel 1
// (stream_topk.cu) runs it.
//
// The two compute the cross term <q, x> of a tile of query rows against a
// tile of 128 corpus rows the same way, so that kernel 1 and the
// distances-out route through kernel 5 agree bit for bit: each output is
// one fmaf chain over d in index order, starting from +0.0 (the zero
// padding of a ragged chunk adds fmaf(0, 0, acc) = acc, whatever the chunk
// width), and the epilogue rounds each operation on its own (__fsub_rn /
// __fmul_rn / __fadd_rn; nvcc would otherwise contract qsq - 2 * cross into
// an FMA).  No split of d, no TF32 or other tensor-core emulation: each
// would change bits.  Kernel 5 keeps its own copy of these lines: built
// from this header it ran 2.9 % slower on an H100 (same instructions,
// other registers; PERF.md, PR 18).  The k = 256 route tests hold the two
// bit for bit.
//
// The layout: 256 threads, a thread owns MI query rows (two 4-wide groups
// 64 apart when the tile has 128 rows, one when it has 64) and 8 corpus
// rows (two 4-wide groups 64 apart).  Warps are 2 (corpus) x 4 (queries),
// each 8 x 4 threads, so each k step reads a thread's values as 16-byte
// shared loads with broadcast.  The operands are staged k-major
// ([BD][rows + 4]): the pad of 4 words keeps the transposed stores
// conflict-free and the 16-byte reads aligned.
#pragma once

#include <cuda_runtime.h>

namespace fp32_tile {

constexpr int BN = 128;        // corpus rows per tile
constexpr int BD = 8;          // contraction chunk
constexpr int THREADS = 256;   // 16 x 16
constexpr int LDX = BN + 4;    // padded k-major row of a corpus stage buffer

enum Mode { L2SQ = 0, IP = 1, COS = 2 };

template <int MODE>
__device__ __forceinline__ float epilogue(float cross, float qn, float xn) {
  if (MODE == L2SQ)
    return fmaxf(__fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), xn), 0.0f);
  if (MODE == IP) return __fadd_rn(-cross, xn);
  return __fadd_rn(__fsub_rn(1.0f, cross), xn);
}

// Columns [col, col + 4) of row `row` of the row-major [rows, d] matrix A,
// zeros outside it.  VEC: d % 4 == 0 and A 16-byte aligned, so the four
// columns lie wholly inside or wholly outside the row.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ A, int row,
                                        int rows, int col, int d) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= rows) return v;
  const float* p = A + (size_t)row * d + col;
  if (VEC) {
    if (col < d) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (col < d) v.x = __ldg(p);
    if (col + 1 < d) v.y = __ldg(p + 1);
    if (col + 2 < d) v.z = __ldg(p + 2);
    if (col + 3 < d) v.w = __ldg(p + 3);
  }
  return v;
}

// Store row `row`'s four columns [c, c + 4) k-major: s[c + j][row], rows of
// LD words.
template <int LD>
__device__ __forceinline__ void store_kmajor(float* s, int row, int c,
                                             float4 v) {
  s[(c + 0) * LD + row] = v.x;
  s[(c + 1) * LD + row] = v.y;
  s[(c + 2) * LD + row] = v.z;
  s[(c + 3) * LD + row] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Where thread `tid` sits in the tile: its corpus columns are 4tx..4tx+3
// and 64+4tx..; its query rows 4ty..4ty+3 (and 64+4ty.. when MI = 8).
__device__ __forceinline__ int tile_tx(int tid) {
  return ((tid / 32) % 2) * 8 + (tid % 32) % 8;
}
__device__ __forceinline__ int tile_ty(int tid) {
  return ((tid / 32) / 2) * 4 + (tid % 32) / 8;
}

// Local query row of a thread's output row i, and local corpus column of
// its output column j.
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i / 4) * 64 + 4 * ty + i % 4;
}
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j / 4) * 64 + 4 * tx + j % 4;
}

// One staged chunk of BD columns: acc[i][j] = fmaf(q[i], x[j], acc[i][j])
// for kk ascending.  qb is a [BD][LDQ] query stage buffer, xb a [BD][LDX]
// corpus one.
template <int MI, int LDQ>
__device__ __forceinline__ void fma_chunk(float (&acc)[MI][8],
                                          const float* qb, const float* xb,
                                          int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < BD; ++kk) {
    const float4 a0 = ld4(qb + kk * LDQ + 4 * ty);
    const float4 a1 = MI == 8 ? ld4(qb + kk * LDQ + 64 + 4 * ty) : a0;
    const float4 b0 = ld4(xb + kk * LDX + 4 * tx);
    const float4 b1 = ld4(xb + kk * LDX + 64 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace fp32_tile
