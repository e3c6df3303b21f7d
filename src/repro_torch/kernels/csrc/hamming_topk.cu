// Hamming distance + top-k over packed binary codes for Hopper (sm_90a).
//
// Replaces: repro/kernels/hamming/hamming.py::hamming_topk_pallas (with
// _hamming_kernel and distance_topk.merge_topk_rounds).
//
// What it computes: codes are w 32-bit words per row (the reference's
// uint32 bits, held as int32 by the port).  For every query q and corpus
// row x < n_valid, dist = popcount(q XOR x) summed over the words, as a
// float32 of an integer (exact), and per query the k smallest (dist, row)
// pairs, ascending, ties to the smaller row, (+inf, -1) where fewer than k
// rows exist.  Rows at or past n_valid are shape padding and never win.
//
// What bounds it on an H100: operations.  At nq = 10^4, n = 10^6, w = 8
// the work is 8 * 10^10 popcounts (and as many XORs and adds) on 32 MB of
// codes.  The CUDA programming guide's throughput table gives compute
// capability 9.0 16 population counts per clock per SM against 64 for
// 32-bit XOR and add, so the popcount pipe sets the bound:
// 8e10 / (16 * 132 SMs * 1.98 GHz) ~ 19 ms.  The bytes (32 MB + 0.3 MB
// of queries) take 0.01 ms at 3.35 TB/s.
//
// Design (the layout of stream_topk.cu, with XOR + __popc in place of the
// FMA): one block owns 64 queries and a contiguous range of corpus rows;
// the corpus axis is split across blocks (grid.y) so that few query tiles
// still fill the card, and merge_splits_kernel merges the per-range lists
// by (dist, row).  Per tile of 64 rows, 16x16 threads each accumulate 4x4
// integer distances over the words staged in shared memory (query words
// stay resident when w <= 32).  Selection: each query's running top-k is
// a sorted list in shared memory; a candidate is tested against the list's
// last (dist, row) first, so once the list is full almost every candidate
// is dropped by one compare; survivors are buffered and one thread per
// query inserts them.  Ragged edges are masked in-kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

using namespace repro_topk;

constexpr int BQ = 64;         // queries per block
constexpr int BN = 64;         // corpus rows per tile
constexpr int BW = 32;         // words per staged chunk
constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_K = 256;

__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int row0, int rows, int row_end,
                                      int c0, int cw, int w, int tid) {
  for (int e = tid; e < rows * cw; e += THREADS) {
    const int r = e / cw, c = e % cw;
    const int row = row0 + r;
    dst[c * (rows + 1) + r] =
        row < row_end ? src[(size_t)row * w + c0 + c] : 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
hamming_topk_kernel(const uint32_t* __restrict__ Q,
                    const uint32_t* __restrict__ X,
                    float* __restrict__ part_d, int* __restrict__ part_i,
                    int nq, int n, int w, int n_valid, int k,
                    int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);     // [BW][BQ + 1]
  uint32_t* xs = qs + BW * (BQ + 1);                    // [BW][BN + 1]
  float* list_d = reinterpret_cast<float*>(xs + BW * (BN + 1));  // [BQ][k]
  int* list_i = reinterpret_cast<int*>(list_d + BQ * k);         // [BQ][k]
  float* buf_d = reinterpret_cast<float*>(list_i + BQ * k);      // [BQ][BN]
  int* buf_i = reinterpret_cast<int*>(buf_d + BQ * BN);          // [BQ][BN]
  int* cnt = buf_i + BQ * BN;                                    // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long long begin_ll = (long long)blockIdx.y * rows_per_split;
  const int row_begin = (int)(begin_ll < n ? begin_ll : n);
  const int row_end =
      (int)(begin_ll + rows_per_split < n ? begin_ll + rows_per_split : n);
  const bool q_resident = w <= BW;

  list_init(list_d, list_i, BQ * k, tid, THREADS);
  if (tid < BQ) cnt[tid] = 0;
  if (q_resident) stage(qs, Q, q0, BQ, nq, 0, w, w, tid);

  for (int n0 = row_begin; n0 < row_end; n0 += BN) {
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int c0 = 0; c0 < w; c0 += BW) {
      const int cw = min(BW, w - c0);
      __syncthreads();
      if (!q_resident) stage(qs, Q, q0, BQ, nq, c0, cw, w, tid);
      stage(xs, X, n0, BN, row_end, c0, cw, w, tid);
      __syncthreads();
      for (int c = 0; c < cw; ++c) {
        uint32_t a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[c * (BQ + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[c * (BN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
      }
    }

    // threshold filter against each query's current k-th pair
    int any = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = ty + 16 * i;
      if (q0 + ql >= nq) continue;
      const float kd = list_d[ql * k + k - 1];
      const int ki = list_i[ql * k + k - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int xrow = n0 + tx + 16 * j;
        if (xrow >= row_end || xrow >= n_valid) continue;
        const float dist = (float)acc[i][j];
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
      const size_t o = ((size_t)blockIdx.y * nq + qrow) * k + (e % k);
      part_d[o] = list_d[e];
      part_i[o] = list_i[e];
    }
  }
}

// The distances-out entry behind ops.hamming_topk for k > MAX_K: the
// [nq, n] popcount distances into a float32 buffer with row stride ldo,
// rows at or past n_valid at +inf; the wrapper then selects by (dist, row).
// One thread per corpus row, DQ queries per block (their words staged in
// shared memory), so each row's words are read once per DQ queries.
constexpr int DQ = 8;

__global__ void __launch_bounds__(THREADS)
hamming_dist_kernel(const uint32_t* __restrict__ Q,
                    const uint32_t* __restrict__ X, float* __restrict__ out,
                    int nq, int n, int w, int n_valid, long long ldo) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);     // [DQ][w]
  const int q0 = blockIdx.y * DQ;
  const int gq = min(DQ, nq - q0);
  for (int e = threadIdx.x; e < gq * w; e += THREADS)
    qs[e] = Q[(size_t)q0 * w + e];
  __syncthreads();
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  int acc[DQ];
#pragma unroll
  for (int g = 0; g < DQ; ++g) acc[g] = 0;
  for (int c = 0; c < w; ++c) {
    const uint32_t xw = __ldg(X + (size_t)row * w + c);
#pragma unroll
    for (int g = 0; g < DQ; ++g)
      if (g < gq) acc[g] += __popc(qs[g * w + c] ^ xw);
  }
#pragma unroll
  for (int g = 0; g < DQ; ++g)
    if (g < gq)
      out[(size_t)(q0 + g) * ldo + row] =
          row < n_valid ? (float)acc[g] : INFINITY;
}

}  // namespace

extern "C" int hamming_dist_launch(const uint32_t* Q, const uint32_t* X,
                                   float* out, int nq, int n, int w,
                                   int n_valid, long long ldo, void* stream) {
  if (nq < 1 || n < 1 || w < 1 || n_valid < 0 || ldo < n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * (size_t)DQ * w;
  cudaError_t e = cudaFuncSetAttribute(
      hamming_dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // grid.y holds at most 65,535 query groups: launch in slices of queries
  constexpr int SLICE = 65535 * DQ;
  for (int q0 = 0; q0 < nq; q0 += SLICE) {
    const int rows = nq - q0 < SLICE ? nq - q0 : SLICE;
    dim3 grid((n + THREADS - 1) / THREADS, (rows + DQ - 1) / DQ);
    hamming_dist_kernel<<<grid, THREADS, smem, s>>>(
        Q + (size_t)q0 * w, X, out + (size_t)q0 * ldo, rows, n, w, n_valid,
        ldo);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

extern "C" int hamming_topk_launch(const uint32_t* Q, const uint32_t* X,
                                   float* part_d, int* part_i, float* out_d,
                                   int* out_i, int nq, int n, int w,
                                   int n_valid, int k, int n_splits,
                                   int rows_per_split, void* stream) {
  if (nq < 1 || n < 1 || w < 1 || k < 1 || k > MAX_K || n_splits < 1 ||
      n_splits > repro_topk::MAX_SPLITS || rows_per_split < 1 || n_valid < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * (BW * (BQ + 1) + BW * (BN + 1)) +
                      (sizeof(float) + sizeof(int)) * (size_t)BQ * k +
                      (sizeof(float) + sizeof(int)) * (size_t)BQ * BN +
                      sizeof(int) * BQ;
  cudaError_t e = cudaFuncSetAttribute(
      hamming_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((nq + BQ - 1) / BQ, n_splits);
  hamming_topk_kernel<<<grid, THREADS, smem, s>>>(
      Q, X, part_d, part_i, nq, n, w, n_valid, k, rows_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  repro_topk::merge_splits_kernel<<<(nq + 127) / 128, 128, 0, s>>>(
      part_d, part_i, out_d, out_i, nq, k, n_splits);
  return (int)cudaGetLastError();
}
