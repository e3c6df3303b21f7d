// Streaming fused distance + top-k for Hopper (sm_90a).
//
// Replaces: repro/kernels/distance_topk/distance_topk.py::stream_topk_pallas
// (with _stream_topk_kernel, merge_topk_rounds and
// repro/kernels/distance/distance.py::distance_epilogue).
//
// What it computes: for every query q and every corpus row x,
//   l2sq: max((qsq[q] - 2 * <q, x>) + xsq[x], 0)
//   ip  : -<q, x> + xsq[x]
//   cos : (1 - <q, x>) + xsq[x]
// and keeps, per query, the k smallest (dist, id) pairs, ascending, ties to
// the smaller id, (+inf, -1) where fewer than k finite candidates exist.
// xsq carries the squared norms (l2sq) or an additive 0/+inf penalty
// (ip, cos); a +inf entry masks its row in every mode.  The [nq, n]
// distance matrix never reaches device memory.
//
// What bounds it on an H100: the cross term is 2*nq*n*d fp32 operations.
// It runs in full fp32 on the CUDA cores (TF32 tensor cores would break the
// reference's fp32 contract), so at nq = 10^4, n = 10^6, d = 128 the work is
// 2.56 TFLOP against 67 TFLOP/s (SXM data sheet): ~38 ms, far above the
// 0.5 GB / 3.35 TB/s ~ 0.15 ms it takes to read X once.  Compute-bound.
//
// Design:
//  * one block owns 64 queries and a contiguous range of corpus rows; the
//    corpus axis is split across blocks (grid.y) so that even a few query
//    tiles fill all 132 SMs.  A second kernel merges the per-split lists by
//    (dist, id).  Nothing carries between blocks: Hopper runs them in
//    parallel and in no order.
//  * per corpus tile of 64 rows, the 64x64 cross tile is accumulated in
//    registers (16x16 threads, 4x4 outputs each, strided so that shared
//    memory reads are conflict-free) over d in chunks of 32 staged through
//    shared memory, fp32 FMA in index order.
//  * selection: each query's running top-k is a sorted list in shared
//    memory.  A candidate is tested against the list's last (dist, id)
//    before it goes anywhere, so once the list is full almost every
//    candidate is dropped by one compare; survivors are buffered and one
//    thread per query inserts them.  A tile with no survivor in the whole
//    block skips the insert phase (one __syncthreads_or).
//  * the ragged edges (nq, n, d not multiples of the tiles) are masked
//    in-kernel: X is never padded or copied.
// Simple and right first: no TMA, no wgmma, no double buffering yet.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

using namespace repro_topk;

constexpr int BQ = 64;         // queries per block
constexpr int BN = 64;         // corpus rows per tile
constexpr int BD = 32;         // contraction chunk
constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_K = 256;

enum Mode { L2SQ = 0, IP = 1, COS = 2 };

__device__ __forceinline__ float epilogue(float cross, float qn, float xn,
                                          int mode) {
  if (mode == L2SQ)
    return fmaxf(__fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), xn), 0.0f);
  if (mode == IP) return __fadd_rn(-cross, xn);
  return __fadd_rn(__fsub_rn(1.0f, cross), xn);
}

__global__ void __launch_bounds__(THREADS)
stream_topk_kernel(const float* __restrict__ Q, const float* __restrict__ X,
                   const float* __restrict__ qsq,
                   const float* __restrict__ xsq, float* __restrict__ part_d,
                   int* __restrict__ part_i, int nq, int n, int d, int k,
                   int mode, int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);           // [BD][BQ + 1]
  float* xs = qs + BD * (BQ + 1);                       // [BD][BN + 1]
  float* list_d = xs + BD * (BN + 1);                   // [BQ][k]
  int* list_i = reinterpret_cast<int*>(list_d + BQ * k);  // [BQ][k]
  float* buf_d = reinterpret_cast<float*>(list_i + BQ * k);  // [BQ][BN]
  int* buf_i = reinterpret_cast<int*>(buf_d + BQ * BN);      // [BQ][BN]
  int* cnt = buf_i + BQ * BN;                                // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const long long begin_ll = (long long)split * rows_per_split;
  const int row_begin = (int)(begin_ll < n ? begin_ll : n);
  const int row_end =
      (int)(begin_ll + rows_per_split < n ? begin_ll + rows_per_split : n);

  list_init(list_d, list_i, BQ * k, tid, THREADS);
  if (tid < BQ) cnt[tid] = 0;

  for (int n0 = row_begin; n0 < row_end; n0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int c0 = 0; c0 < d; c0 += BD) {
      __syncthreads();
      for (int e = tid; e < BQ * BD; e += THREADS) {
        const int r = e / BD, c = e % BD;
        const int qrow = q0 + r, col = c0 + c;
        qs[c * (BQ + 1) + r] =
            (qrow < nq && col < d) ? Q[(size_t)qrow * d + col] : 0.0f;
      }
      for (int e = tid; e < BN * BD; e += THREADS) {
        const int r = e / BD, c = e % BD;
        const int xrow = n0 + r, col = c0 + c;
        xs[c * (BN + 1) + r] =
            (xrow < row_end && col < d) ? X[(size_t)xrow * d + col] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BD; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[kk * (BQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[kk * (BN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // epilogue + threshold filter against each query's current k-th pair
    int any = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = ty + 16 * i;
      const int qrow = q0 + ql;
      if (qrow >= nq) continue;
      const float qn = qsq[qrow];
      const float kd = list_d[ql * k + k - 1];
      const int ki = list_i[ql * k + k - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int xrow = n0 + tx + 16 * j;
        if (xrow >= row_end) continue;
        const float dist = epilogue(acc[i][j], qn, xsq[xrow], mode);
        if (beats(dist, xrow, kd, ki)) {
          const int pos = atomicAdd(&cnt[ql], 1);
          buf_d[ql * BN + pos] = dist;
          buf_i[ql * BN + pos] = xrow;
          any = 1;
        }
      }
    }
    if (__syncthreads_or(any)) {
      if (tid < BQ) {
        float* ld = list_d + tid * k;
        int* li = list_i + tid * k;
        const int c = cnt[tid];
        for (int p = 0; p < c; ++p) {
          const float dd = buf_d[tid * BN + p];
          const int ii = buf_i[tid * BN + p];
          if (beats(dd, ii, ld[k - 1], li[k - 1])) list_insert(ld, li, k, dd, ii);
        }
        cnt[tid] = 0;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * k; e += THREADS) {
    const int qrow = q0 + e / k;
    if (qrow < nq) {
      const size_t o = ((size_t)split * nq + qrow) * k + (e % k);
      part_d[o] = list_d[e];
      part_i[o] = list_i[e];
    }
  }
}

}  // namespace

extern "C" int stream_topk_launch(const float* Q, const float* X,
                                  const float* qsq, const float* xsq,
                                  float* part_d, int* part_i, float* out_d,
                                  int* out_i, int nq, int n, int d, int k,
                                  int mode, int n_splits, int rows_per_split,
                                  void* stream) {
  if (nq < 1 || n < 1 || d < 1 || k < 1 || k > MAX_K || n_splits < 1 ||
      n_splits > repro_topk::MAX_SPLITS || mode < 0 || mode > 2 ||
      rows_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (BD * (BQ + 1) + BD * (BN + 1)) +
                      (sizeof(float) + sizeof(int)) * (size_t)BQ * k +
                      (sizeof(float) + sizeof(int)) * (size_t)BQ * BN +
                      sizeof(int) * BQ;
  cudaError_t e = cudaFuncSetAttribute(
      stream_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((nq + BQ - 1) / BQ, n_splits);
  stream_topk_kernel<<<grid, THREADS, smem, s>>>(Q, X, qsq, xsq, part_d,
                                                 part_i, nq, n, d, k, mode,
                                                 rows_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  repro_topk::merge_splits_kernel<<<(nq + 127) / 128, 128, 0, s>>>(
      part_d, part_i, out_d, out_i, nq, k, n_splits);
  return (int)cudaGetLastError();
}
