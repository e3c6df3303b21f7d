// Embedding-bag gather-reduce for Hopper (sm_90a).
//
// Replaces: repro/kernels/embedbag/embedbag.py::embedding_bag_pallas (with
// _embedbag_kernel).
//
// What it computes: lookups i (sorted by bag by the wrapper) name a table
// row indices[i] and a weight weights[i].  The wrapper cuts them into runs
// of equal bag ids (start, end, bag) and keeps the last run of each bag:
// the Pallas kernel re-initialises a bag's row at each new run, so with
// assume_sorted=True and unsorted bags the last run wins.  For each run the
// kernel writes
//   out[bag] = row_0 * w_0;  out[bag] += row_i * w_i  (i in lookup order)
// with row_i = table[indices[i]] read as float32, the multiply and the add
// rounded separately (__fmul_rn / __fadd_rn: no FMA contraction) and the
// running value rounded to the table's type after every step, as the
// Pallas kernel stores its output block in the table's type.  So the plain
// version's sequential sum matches bit for bit.  Bags without a run keep
// the zeros the wrapper allocated (empty bags, ops.py:30-32 of the
// reference).
//
// What bounds it on an H100: bytes.  Each lookup reads one D-wide row
// (512 B at D = 128 fp32) and its index and weight; each bag writes one
// row.  At N = 524,288 lookups, B = 65,536 bags, D = 128: ~308 MB, 0.09 ms
// at 3.35 TB/s; the operations (2 N D) are negligible.  Rows are scattered
// over a 20 GB table, so the rate rests on how many row loads are in
// flight.
//
// Design: one warp per run, 8 warps per block.  The warp loads up to 32
// (index, weight) pairs of its run with one coalesced load and hands them
// out by shuffle, so no row load waits on an index load; lanes stride over
// D (a 128-float row is four coalesced 128-byte loads of the warp), each
// lane keeping its columns' running sums in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 4;            // columns per lane per pass: 128 per warp
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round a float32 to T and back: the store of the Pallas output block.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const int* __restrict__ indices,
                     const float* __restrict__ weights,
                     const T* __restrict__ table,
                     const int* __restrict__ run_start,
                     const int* __restrict__ run_end,
                     const int* __restrict__ run_bag, T* __restrict__ out,
                     int n_runs, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= n_runs) return;
  const int start = run_start[r], end = run_end[r];
  T* orow = out + (size_t)run_bag[r] * D;
  for (int c0 = 0; c0 < D; c0 += 32 * COLS) {
    float acc[COLS];
#pragma unroll
    for (int t = 0; t < COLS; ++t) acc[t] = 0.0f;
    for (int base = start; base < end; base += 32) {
      int my_idx = 0;
      float my_w = 0.0f;
      if (base + lane < end) {
        my_idx = indices[base + lane];
        my_w = weights[base + lane];
      }
      const int m = min(32, end - base);
      for (int p = 0; p < m; ++p) {
        const int idx = __shfl_sync(FULL, my_idx, p);
        const float w = __shfl_sync(FULL, my_w, p);
        const T* trow = table + (size_t)idx * D;
        const bool first = base + p == start;
#pragma unroll
        for (int t = 0; t < COLS; ++t) {
          const int c = c0 + lane + 32 * t;
          if (c < D) {
            const float row = __fmul_rn(to_f32<T>(trow[c]), w);
            acc[t] = round_to<T>(first ? row : __fadd_rn(acc[t], row));
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      const int c = c0 + lane + 32 * t;
      if (c < D) orow[c] = from_f32<T>(acc[t]);
    }
  }
}

}  // namespace

// dtype: 0 = float32 table and output, 1 = bfloat16.
extern "C" int embedding_bag_launch(const int* indices, const float* weights,
                                    const void* table, const int* run_start,
                                    const int* run_end, const int* run_bag,
                                    void* out, int n_runs, int D, int dtype,
                                    void* stream) {
  if (n_runs < 1 || D < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = (n_runs + WARPS - 1) / WARPS;
  if (dtype == 0)
    embedding_bag_kernel<float><<<blocks, THREADS, 0, s>>>(
        indices, weights, reinterpret_cast<const float*>(table), run_start,
        run_end, run_bag, reinterpret_cast<float*>(out), n_runs, D);
  else
    embedding_bag_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        indices, weights, reinterpret_cast<const __nv_bfloat16*>(table),
        run_start, run_end, run_bag, reinterpret_cast<__nv_bfloat16*>(out),
        n_runs, D);
  return (int)cudaGetLastError();
}
