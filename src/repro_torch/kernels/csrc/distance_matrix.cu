// Tiled distance matrix for Hopper (sm_90a).
//
// Replaces: repro/kernels/distance/distance.py::distance_matrix_pallas (with
// _distance_kernel and distance_epilogue).
//
// What it computes: out[q, x] for every query q < nq and corpus row x < n,
//   l2sq: max((qsq[q] - 2 * <q, x>) + xsq[x], 0)
//   ip  : -<q, x> + xsq[x]
//   cos : (1 - <q, x>) + xsq[x]
// written into a float32 buffer with row stride ldo.  The public op passes
// the squared norms for l2sq and zeros for ip / cos (the Pallas kernel adds
// 0.0 there); the distances-out route of ops.stream_topk passes kernel 1's
// own xsq operand (norms plus the +inf penalty of masked rows).
//
// Arithmetic: kernel 1's, so that the route gives stream_topk.cu's
// distances bit for bit.  Each entry is one fmaf chain over d in index
// order, starting from 0, staged through the same 32-wide chunks (the zero
// padding of a ragged chunk adds fmaf(0, 0, acc) exactly as there), and
// the epilogue rounds each operation on its own (__fsub_rn / __fmul_rn /
// __fadd_rn): nvcc would otherwise contract qsq - 2 * cross into an FMA.
//
// What bounds it on an H100: operations.  At nq = 1,024, n = 10^6, d = 128
// the cross term is 2.6 * 10^11 fp32 operations on the CUDA cores (TF32
// tensor cores would break the fp32 contract): 3.9 ms at 67 TFLOP/s.  The
// bytes (512 MB of X, 4.1 GB of output) take 1.4 ms at 3.35 TB/s.
//
// Design: one block per 64 x 64 output tile, 16 x 16 threads with 4 x 4
// outputs each (strided, so that shared-memory reads are conflict-free),
// the d-loop over 32-wide chunks staged through shared memory -- the inner
// loop of stream_topk.cu without its selection.  Ragged edges are masked
// in-kernel: Q and X are never padded or copied (the Pallas wrapper pads
// them to tiles).  Simple and right first: no TMA, no wgmma.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries per tile
constexpr int BN = 64;         // corpus rows per tile
constexpr int BD = 32;         // contraction chunk
constexpr int THREADS = 256;   // 16 x 16

enum Mode { L2SQ = 0, IP = 1, COS = 2 };

__device__ __forceinline__ float epilogue(float cross, float qn, float xn,
                                          int mode) {
  if (mode == L2SQ)
    return fmaxf(__fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), xn), 0.0f);
  if (mode == IP) return __fadd_rn(-cross, xn);
  return __fadd_rn(__fsub_rn(1.0f, cross), xn);
}

__global__ void __launch_bounds__(THREADS)
distance_matrix_kernel(const float* __restrict__ Q,
                       const float* __restrict__ X,
                       const float* __restrict__ qsq,
                       const float* __restrict__ xsq, float* __restrict__ out,
                       int nq, int n, int d, long long ldo, int mode) {
  __shared__ float qs[BD * (BQ + 1)];
  __shared__ float xs[BD * (BN + 1)];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int q0 = blockIdx.y * BQ;

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
          (xrow < n && col < d) ? X[(size_t)xrow * d + col] : 0.0f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= nq) continue;
    const float qn = qsq[qrow];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int xrow = n0 + tx + 16 * j;
      if (xrow < n)
        out[(size_t)qrow * ldo + xrow] =
            epilogue(acc[i][j], qn, xsq[xrow], mode);
    }
  }
}

}  // namespace

extern "C" int distance_matrix_launch(const float* Q, const float* X,
                                      const float* qsq, const float* xsq,
                                      float* out, int nq, int n, int d,
                                      long long ldo, int mode, void* stream) {
  if (nq < 1 || n < 1 || d < 1 || ldo < n || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // grid.y holds at most 65,535 query tiles: launch in slices of queries
  constexpr int SLICE = 65535 * BQ;
  for (int q0 = 0; q0 < nq; q0 += SLICE) {
    const int rows = nq - q0 < SLICE ? nq - q0 : SLICE;
    dim3 grid((n + BN - 1) / BN, (rows + BQ - 1) / BQ);
    distance_matrix_kernel<<<grid, THREADS, 0, s>>>(
        Q + (size_t)q0 * d, X, qsq + q0, xsq, out + (size_t)q0 * ldo, rows,
        n, d, ldo, mode);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
