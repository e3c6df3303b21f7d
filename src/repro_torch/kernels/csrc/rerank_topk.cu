// Fused candidate rerank for Hopper (sm_90a): gather + exact distance +
// running unique-by-id top-k.
//
// Replaces: repro/kernels/rerank_topk/rerank_topk.py::rerank_topk_pallas
// (with _rerank_kernel and merge_topk_unique_rounds).
//
// What it computes: query b has a window of C candidates, each a corpus row
// rows[b, c], an output id ids[b, c] and a penalty pen[b, c].  Its distance
//   l2sq: (qsq[b] - 2 * <q, x>) + pen     (pen carries the cached |x|^2;
//                                          no clamp, as in the reference)
//   cos : (1 - <q, x>) + pen
//   ham : popcount(q XOR x) over uint32 words, as float, + pen
// and the result is the k best DISTINCT ids: each id at its smallest
// distance, ascending by (dist, id), (+inf, -1) padding.  Every copy of an
// id counts, wherever it sits in the window; id -1 and +inf never win.  The
// [b, C, d] gathered tensor never exists.
//
// What bounds it on an H100: the bytes of the gathered rows.  Each valid
// candidate reads one d-word row (512 B at d = 128 fp32) and does 2d
// operations on it, so the kernel is memory-bound (3.35 TB/s) long before
// the fp32 rate matters.  Masked slots (pen = +inf: probes past n_probes,
// entries past a list's end or past the scan budget) cannot win and are
// never loaded, so the bytes are those of the valid candidates only.
//
// Design: one warp per query (4 per block), no block-wide barriers.  The
// warp loads 32 candidates' (row, id, pen) coalesced, then walks them row
// by row: every lane reads 16 bytes of the row (float4 / uint4 when d is a
// multiple of 4, so one 128-float row is one coalesced 512-byte load) and
// the partial dot products meet in a butterfly of shuffles.  The 32 fresh
// distances are tested against the query's current k-th (dist, id); the
// survivors are inserted into the sorted list in shared memory by lane 0,
// which also retires a worse copy of the same id.  Rows that many queries
// share (IVF probes the same lists) are served from the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

using namespace repro_topk;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_K = 256;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { L2SQ = 0, COS = 1, HAM = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// <q, x_row> with q staged in shared memory; every lane ends with the sum.
__device__ __forceinline__ float row_dot(const float* __restrict__ X,
                                         const float* qrow, int row, int d,
                                         bool vec4, int lane) {
  float acc = 0.0f;
  const float* x = X + (size_t)row * d;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(qrow);
    for (int c = lane; c < d / 4; c += 32) {
      const float4 a = __ldg(x4 + c);
      const float4 b = q4[c];
      acc = fmaf(b.x, a.x, acc);
      acc = fmaf(b.y, a.y, acc);
      acc = fmaf(b.z, a.z, acc);
      acc = fmaf(b.w, a.w, acc);
    }
  } else {
    for (int c = lane; c < d; c += 32) acc = fmaf(qrow[c], __ldg(x + c), acc);
  }
  return warp_sum(acc);
}

__device__ __forceinline__ int row_hamming(const uint32_t* __restrict__ X,
                                           const uint32_t* qrow, int row,
                                           int d, bool vec4, int lane) {
  int acc = 0;
  const uint32_t* x = X + (size_t)row * d;
  if (vec4) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const uint4* q4 = reinterpret_cast<const uint4*>(qrow);
    for (int c = lane; c < d / 4; c += 32) {
      const uint4 a = __ldg(x4 + c);
      const uint4 b = q4[c];
      acc += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
             __popc(a.w ^ b.w);
    }
  } else {
    for (int c = lane; c < d; c += 32) acc += __popc(qrow[c] ^ __ldg(x + c));
  }
  return warp_sum_int(acc);
}

// The exact distance of one candidate row; every lane ends with it.
__device__ __forceinline__ float slot_distance(const void* __restrict__ Xv,
                                               const uint32_t* qwords,
                                               int row, float qn, float pen,
                                               int d, bool vec4, int mode,
                                               int lane) {
  if (mode == HAM) {
    const int h = row_hamming(reinterpret_cast<const uint32_t*>(Xv), qwords,
                              row, d, vec4, lane);
    return __fadd_rn((float)h, pen);
  }
  const float cross =
      row_dot(reinterpret_cast<const float*>(Xv),
              reinterpret_cast<const float*>(qwords), row, d, vec4, lane);
  return (mode == L2SQ) ? __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), pen)
                        : __fadd_rn(__fsub_rn(1.0f, cross), pen);
}

__global__ void __launch_bounds__(THREADS)
rerank_topk_kernel(const int* __restrict__ rows, const void* __restrict__ Qv,
                   const float* __restrict__ qsq, const int* __restrict__ ids,
                   const float* __restrict__ pen, const void* __restrict__ Xv,
                   float* __restrict__ out_d, int* __restrict__ out_i, int b,
                   int C, int d, int k, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d_pad = (d + 3) / 4 * 4;                      // keeps 16B alignment
  uint32_t* qwords = reinterpret_cast<uint32_t*>(smem) + warp * d_pad;
  float* ld = reinterpret_cast<float*>(smem) + WARPS * d_pad + warp * k;
  int* li = reinterpret_cast<int*>(smem) + WARPS * d_pad + WARPS * k + warp * k;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= b) return;               // whole warp: no block-wide barrier below

  const uint32_t* Qw = reinterpret_cast<const uint32_t*>(Qv);
  for (int c = lane; c < d; c += 32) qwords[c] = Qw[(size_t)q * d + c];
  list_init(ld, li, k, lane, 32);
  __syncwarp();

  const bool vec4 = (d % 4) == 0;
  const float qn = (mode == L2SQ) ? qsq[q] : 0.0f;
  const size_t base_q = (size_t)q * C;
  for (int base = 0; base < C; base += 32) {
    const int j = base + lane;
    int row = 0, id = -1;
    float p = INFINITY;
    if (j < C) {
      row = rows[base_q + j];
      id = ids[base_q + j];
      p = pen[base_q + j];
    }
    float mine = INFINITY;
    const int m = min(32, C - base);
    for (int r = 0; r < m; ++r) {
      const float pr = __shfl_sync(FULL, p, r);
      const int ir = __shfl_sync(FULL, id, r);
      const int rr = __shfl_sync(FULL, row, r);
      if (!(pr < INFINITY) || ir < 0) continue;  // can never win: no load
      const float dist =
          slot_distance(Xv, qwords, rr, qn, pr, d, vec4, mode, lane);
      if (lane == r) mine = dist;
    }
    const bool pass = beats(mine, id, ld[k - 1], li[k - 1]);
    unsigned todo = __ballot_sync(FULL, pass);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const float cd = __shfl_sync(FULL, mine, src);
      const int ci = __shfl_sync(FULL, id, src);
      if (lane == 0) list_insert_unique(ld, li, k, cd, ci);
      __syncwarp();
    }
  }
  for (int t = lane; t < k; t += 32) {
    out_d[(size_t)q * k + t] = ld[t];
    out_i[(size_t)q * k + t] = li[t];
  }
}

// The window distances-out entry behind ops.rerank_topk for k > MAX_K:
// the [b, C] distances of the window into a float32 buffer, with the
// kernel's arithmetic; masked slots (+inf penalty or id -1) are +inf and
// never loaded.  The wrapper then makes the unique-by-id select.  One warp
// per query, as above.
__global__ void __launch_bounds__(THREADS)
rerank_dist_kernel(const int* __restrict__ rows, const void* __restrict__ Qv,
                   const float* __restrict__ qsq, const int* __restrict__ ids,
                   const float* __restrict__ pen, const void* __restrict__ Xv,
                   float* __restrict__ out, int b, int C, int d, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d_pad = (d + 3) / 4 * 4;
  uint32_t* qwords = reinterpret_cast<uint32_t*>(smem) + warp * d_pad;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= b) return;
  const uint32_t* Qw = reinterpret_cast<const uint32_t*>(Qv);
  for (int c = lane; c < d; c += 32) qwords[c] = Qw[(size_t)q * d + c];
  __syncwarp();
  const bool vec4 = (d % 4) == 0;
  const float qn = (mode == L2SQ) ? qsq[q] : 0.0f;
  const size_t base_q = (size_t)q * C;
  for (int base = 0; base < C; base += 32) {
    const int j = base + lane;
    int row = 0, id = -1;
    float p = INFINITY;
    if (j < C) {
      row = rows[base_q + j];
      id = ids[base_q + j];
      p = pen[base_q + j];
    }
    float mine = INFINITY;
    const int m = min(32, C - base);
    for (int r = 0; r < m; ++r) {
      const float pr = __shfl_sync(FULL, p, r);
      const int ir = __shfl_sync(FULL, id, r);
      const int rr = __shfl_sync(FULL, row, r);
      if (!(pr < INFINITY) || ir < 0) continue;
      const float dist =
          slot_distance(Xv, qwords, rr, qn, pr, d, vec4, mode, lane);
      if (lane == r) mine = dist;
    }
    if (j < C) out[base_q + j] = mine;
  }
}

}  // namespace

extern "C" int rerank_dist_launch(const int* rows, const void* Q,
                                  const float* qsq, const int* ids,
                                  const float* pen, const void* X, float* out,
                                  int b, int C, int d, int mode,
                                  void* stream) {
  if (b < 1 || C < 1 || d < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int d_pad = (d + 3) / 4 * 4;
  const size_t smem = sizeof(uint32_t) * (size_t)WARPS * d_pad;
  cudaError_t e = cudaFuncSetAttribute(
      rerank_dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  rerank_dist_kernel<<<(b + WARPS - 1) / WARPS, THREADS, smem, s>>>(
      rows, Q, qsq, ids, pen, X, out, b, C, d, mode);
  return (int)cudaGetLastError();
}

extern "C" int rerank_topk_launch(const int* rows, const void* Q,
                                  const float* qsq, const int* ids,
                                  const float* pen, const void* X,
                                  float* out_d, int* out_i, int b, int C,
                                  int d, int k, int mode, void* stream) {
  if (b < 1 || C < 1 || d < 1 || k < 1 || k > MAX_K || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int d_pad = (d + 3) / 4 * 4;
  const size_t smem = sizeof(uint32_t) * (size_t)WARPS * d_pad +
                      (sizeof(float) + sizeof(int)) * (size_t)WARPS * k;
  cudaError_t e = cudaFuncSetAttribute(
      rerank_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  rerank_topk_kernel<<<(b + WARPS - 1) / WARPS, THREADS, smem, s>>>(
      rows, Q, qsq, ids, pen, X, out_d, out_i, b, C, d, k, mode);
  return (int)cudaGetLastError();
}
