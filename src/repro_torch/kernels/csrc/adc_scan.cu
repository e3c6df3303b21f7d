// ADC (asymmetric distance) code scan + running top-C for Hopper (sm_90a).
//
// Replaces: repro/kernels/adc_scan/adc_scan.py::adc_scan_pallas (with
// _adc_kernel, adc_scan_kernel_path and rerank_topk's
// merge_topk_unique_rounds).
//
// What it computes: codes [n, m] uint8 (one code word per subspace) and
// per-query lookup tables luts [b, m, K] float32.  For every query q and
// row i < n, d[q, i] = sum_j luts[q, j, codes[i, j]], summed over
// j = 0 .. m-1 in index order, and per query the C smallest (d, row) pairs,
// ascending, ties to the smaller row, (+inf, -1) where fewer than C rows
// exist.  The reference folds with a unique-by-id select; a full scan
// holds every row once, so unique-by-id is plain (dist, row) order here.
//
// What bounds it on an H100: by the published peaks, operations -- b*n*m
// float adds (1.6e11 at b = 10^4, n = 10^6, m = 16: 2.4 ms at 67 TFLOP/s)
// against 16 MB of codes plus b*m*K*4 bytes of tables (164 MB, 0.05 ms).
// What a table design really meets is the shared-memory lookup rate: one
// 4-byte lookup per add at 32 lanes per clock per SM is ~19 ms at that
// shape, more where lanes of a warp hit the same bank.
//
// Design: the TPU kernel turns the lookup into a one-hot x LUT matmul
// because a TPU has no fast gather; Hopper does, so the tables sit in
// shared memory and each code indexes them directly.  One block owns G
// queries (their tables, when they fit in shared memory: 16 KB per query
// for PQ with m = 16, K = 256; 128 KB for int8 at d = 128, so G = 1; a
// table too large for shared memory is read through L1/L2 instead) and a
// contiguous range of rows; 256 threads take one row each per tile, load
// its m code bytes once (16-byte loads when m is a multiple of 16) and
// produce G distances.  Selection is buffered: a row whose distance beats
// the query's current C-th pair is appended to a per-query buffer; when a
// buffer could overflow (and at the end) one warp per query bitonic-sorts
// the buffer and merges it into the sorted list (C up to 1024, rounded up
// to a power of two P): list ascending against buffer descending is a
// bitonic sequence, so one half-cleaner keeps the P smallest and a
// bitonic merge sorts them.  The corpus axis may be split across blocks;
// merge_splits_kernel then merges the per-range lists by (dist, row).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

using namespace repro_topk;

constexpr int THREADS = 256;   // rows per tile, one per thread
constexpr int TILE = THREADS;
constexpr int MAX_G = 8;       // queries per block (one merging warp each)
constexpr int MAX_C = 1024;
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ void cas(float* d, int* id, int i, int j,
                                    bool up) {
  const float di = d[i], dj = d[j];
  const int ii = id[i], ij = id[j];
  if (up ? pair_less(dj, ij, di, ii) : pair_less(di, ii, dj, ij)) {
    d[i] = dj;
    d[j] = di;
    id[i] = ij;
    id[j] = ii;
  }
}

// One warp folds a query's buffer (cnt entries) into its sorted list of P
// entries (P a power of two, P <= BUF).
__device__ void warp_merge(float* ld, int* li, float* bd, int* bi, int* cnt,
                           int P, int lane) {
  const int c = *cnt;
  if (c == 0) return;
  int S = P;
  while (S < c) S <<= 1;                       // S <= BUF, a power of two
  for (int t = c + lane; t < S; t += 32) {
    bd[t] = INFINITY;
    bi[t] = -1;
  }
  __syncwarp();
  for (int size = 2; size <= S; size <<= 1) {  // buffer ascending
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < S / 2; t += 32) {
        const int i = 2 * stride * (t / stride) + t % stride;
        cas(bd, bi, i, i + stride, (i & size) == 0);
      }
      __syncwarp();
    }
  }
  // list (ascending) ++ reversed buffer prefix (descending) is bitonic:
  // the half-cleaner leaves the P smallest, bitonic, in the list
  for (int i = lane; i < P; i += 32) {
    const float db = bd[P - 1 - i];
    const int ib = bi[P - 1 - i];
    if (pair_less(db, ib, ld[i], li[i])) {
      ld[i] = db;
      li[i] = ib;
    }
  }
  __syncwarp();
  for (int stride = P >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < P / 2; t += 32) {
      const int i = 2 * stride * (t / stride) + t % stride;
      cas(ld, li, i, i + stride, true);
    }
    __syncwarp();
  }
  if (lane == 0) *cnt = 0;
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
adc_scan_kernel(const uint8_t* __restrict__ codes,
                const float* __restrict__ luts, float* __restrict__ part_d,
                int* __restrict__ part_i, int b, int n, int m, int K, int C,
                int P, int BUF, int G, int lut_smem, int vec16,
                int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_len = m * K;
  float* lut_s = reinterpret_cast<float*>(smem);          // [G][m][K]
  float* ld = lut_s + (lut_smem ? G * lut_len : 0);       // [G][P]
  int* li = reinterpret_cast<int*>(ld + G * P);           // [G][P]
  float* bd = reinterpret_cast<float*>(li + G * P);       // [G][BUF]
  int* bi = reinterpret_cast<int*>(bd + G * BUF);         // [G][BUF]
  int* cnt = bi + G * BUF;                                // [G]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * G;
  const int gq = min(G, b - q0);
  const long long begin_ll = (long long)blockIdx.y * rows_per_split;
  const int row_begin = (int)(begin_ll < n ? begin_ll : n);
  const int row_end =
      (int)(begin_ll + rows_per_split < n ? begin_ll + rows_per_split : n);

  const float* lut_q = luts + (size_t)q0 * lut_len;
  if (lut_smem)
    for (int e = tid; e < gq * lut_len; e += THREADS) lut_s[e] = lut_q[e];
  const float* lut_base = lut_smem ? lut_s : lut_q;
  for (int e = tid; e < G * P; e += THREADS) {
    ld[e] = INFINITY;
    li[e] = -1;
  }
  if (tid < G) cnt[tid] = 0;
  __syncthreads();

  for (int t0 = row_begin; t0 < row_end; t0 += TILE) {
    const int row = t0 + tid;
    const bool live = row < row_end;
    float dist[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) dist[g] = 0.0f;
    if (live) {
      const uint8_t* code = codes + (size_t)row * m;
      for (int j0 = 0; j0 < m; j0 += 16) {
        const int jn = min(16, m - j0);
        uint32_t cw[4];
        if (vec16) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(code + j0));
          cw[0] = v.x;
          cw[1] = v.y;
          cw[2] = v.z;
          cw[3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t word = 0;
#pragma unroll
            for (int s = 0; s < 4; ++s)
              if (4 * q + s < jn)
                word |= (uint32_t)__ldg(code + j0 + 4 * q + s) << (8 * s);
            cw[q] = word;
          }
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < gq) {
            const float* L = lut_base + (size_t)g * lut_len + j0 * K;
            float a = dist[g];
#pragma unroll
            for (int jj = 0; jj < 16; ++jj)
              if (jj < jn)
                a = __fadd_rn(a, L[jj * K + ((cw[jj / 4] >> (8 * (jj % 4)))
                                             & 0xffu)]);
            dist[g] = a;
          }
        }
      }
    }
    // threshold filter against each query's current C-th pair
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < gq && live &&
          beats(dist[g], row, ld[g * P + C - 1], li[g * P + C - 1])) {
        const int pos = atomicAdd(&cnt[g], 1);
        bd[g * BUF + pos] = dist[g];
        bi[g * BUF + pos] = row;
      }
    }
    __syncthreads();
    int need = 0;                     // could the next tile overflow?
    for (int g = 0; g < gq; ++g) need |= cnt[g] > BUF - TILE;
    if (need) {
      if (warp < gq)
        warp_merge(ld + warp * P, li + warp * P, bd + warp * BUF,
                   bi + warp * BUF, cnt + warp, P, lane);
      __syncthreads();
    }
  }
  if (warp < gq)
    warp_merge(ld + warp * P, li + warp * P, bd + warp * BUF, bi + warp * BUF,
               cnt + warp, P, lane);
  __syncthreads();
  for (int e = tid; e < gq * C; e += THREADS) {
    const int g = e / C, t = e % C;
    const size_t o = ((size_t)blockIdx.y * b + q0 + g) * C + t;
    part_d[o] = ld[g * P + t];
    part_i[o] = li[g * P + t];
  }
}

}  // namespace

extern "C" int adc_scan_launch(const uint8_t* codes, const float* luts,
                               float* part_d, int* part_i, float* out_d,
                               int* out_i, int b, int n, int m, int K, int C,
                               int P, int BUF, int G, int lut_smem,
                               int n_splits, int rows_per_split,
                               void* stream) {
  const bool pow2 = P > 0 && (P & (P - 1)) == 0 && BUF > 0 &&
                    (BUF & (BUF - 1)) == 0;
  if (b < 1 || n < 1 || m < 1 || K < 1 || C < 1 || C > MAX_C || !pow2 ||
      P < C || BUF < P || BUF < 2 * TILE || G < 1 || G > MAX_G ||
      n_splits < 1 || n_splits > repro_topk::MAX_SPLITS ||
      rows_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (lut_smem ? (size_t)G * m * K : 0) +
      (sizeof(float) + sizeof(int)) * (size_t)G * (P + BUF) +
      sizeof(int) * (size_t)G;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      adc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec16 = (m % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool direct = n_splits == 1;
  dim3 grid((b + G - 1) / G, n_splits);
  adc_scan_kernel<<<grid, THREADS, smem, s>>>(
      codes, luts, direct ? out_d : part_d, direct ? out_i : part_i, b, n, m,
      K, C, P, BUF, G, lut_smem, vec16, rows_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return (int)e;
  repro_topk::merge_splits_kernel<<<(b + 127) / 128, 128, 0, s>>>(
      part_d, part_i, out_d, out_i, b, C, n_splits);
  return (int)cudaGetLastError();
}
