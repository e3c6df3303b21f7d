// Single-token GQA decode attention with online softmax for Hopper (sm_90a).
//
// Replaces: repro/kernels/decode_attn/decode_attn.py::decode_attention_pallas
// (with _decode_attn_kernel) and the vmap over KV heads of
// repro/kernels/decode_attn/ops.py.
//
// What it computes: q [B, H, dh], a KV cache k, v [B, S, KV, dh] (H = KV * G:
// query head kv * G + g reads KV head kv) and valid lengths [B].  Per
// (b, kv) and in blocks of bs positions (the reference's S padded with zero
// rows to a multiple of bs), in float32:
//   q' = q * scale;  s = q' . k_pos, or -1e30 where pos >= lengths[b];
//   m_new = max(m, max s);  alpha = exp(m - m_new);  p = exp(s - m_new);
//   l = l * alpha + sum p;  acc = acc * alpha + p . v;  m = m_new
// and out = acc / max(l, 1e-30) in q's type.  A row with lengths[b] <= 0
// averages v over the padded length, as the reference does; a block wholly
// past lengths[b] > 0 changes nothing there (p = 0, alpha = 1 exactly), so
// it is skipped.
//
// What bounds it on an H100: bytes.  Each valid cache row of k and v is
// read once (dh * 2 bytes each in bf16); at phi-4-mini's decode shape (B =
// 128, KV = 8, dh = 128, S = 32,768) the full cache is 17.2 GB, 5.1 ms at
// 3.35 TB/s, against 4 B H S dh = 5.2 * 10^10 fp32 operations (0.8 ms at
// 67 TFLOP/s).
//
// Design: one block per (kv head, batch row), all G query heads of the group
// in the block, so each cache row is read once for G heads; the cache is
// read in place through its strides (no per-head copy: the reference's vmap
// over axis 2 would copy 17 GB at that shape).  Per block of bs positions:
// K rows are staged 64 at a time into shared memory as float32 (rows padded
// to dh + 1 words: conflict-free), one thread per (head, position) takes the
// dot product in index order; one warp per head takes the block max and the
// probabilities; then V rows are staged the same way and each thread owns
// up to 8 (head, column) entries of the output, accumulating p . v for the
// block before the alpha update.  At B = 1 only KV blocks run: a split over
// S with a combine pass is later work.
//
// Launch contract: B of any size (the launcher slices the batch over
// grid.y's 65,535 rows); G * dh <= 2,048 outputs per block and
// smem_bytes(G, dh, bs) <= 232,448 (the wrapper, decode_attn.py, splits
// each KV head's G query heads into groups that fit both, and refuses only
// a single head whose smem_bytes(1, dh, bs) does not fit).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SUB = 64;            // cache rows staged at a time
constexpr int MAX_ACC = 8;         // output entries per thread: G * dh <= 2048
constexpr float NEG = -1e30f;      // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stage cache rows [pos0, pos0 + rows) of one (b, kv) into dst [rows][dh+1]
// as float32; rows at or past S are the reference's zero padding.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           size_t row_stride, int pos0,
                                           int rows, int S, int dh) {
  for (int e = threadIdx.x; e < rows * dh; e += THREADS) {
    const int r = e / dh, c = e % dh;
    const int pos = pos0 + r;
    dst[r * (dh + 1) + c] =
        pos < S ? to_f32<T>(src[(size_t)pos * row_stride + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int S, int KV, int G, int dh, int bs,
                   int n_blocks, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [G][dh]   scaled queries
  float* sc = qs + G * dh;                // [G][bs]   scores, then p
  float* rows_s = sc + G * bs;            // [SUB][dh + 1]
  float* m_s = rows_s + SUB * (dh + 1);   // [G]
  float* l_s = m_s + G;                   // [G]
  float* a_s = l_s + G;                   // [G]      alpha of the block

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int H = KV * G;
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * dh;
  for (int e = tid; e < G * dh; e += THREADS)
    qs[e] = __fmul_rn(to_f32<T>(qb[e]), scale);
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG;
    l_s[g] = 0.0f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int t = 0; t < MAX_ACC; ++t) acc[t] = 0.0f;

  const int len = lengths[b];
  const int run = len > 0 ? min(n_blocks, (len + bs - 1) / bs) : n_blocks;
  const size_t row_stride = (size_t)KV * dh;
  const size_t origin = (size_t)b * S * KV * dh + (size_t)kvh * dh;
  const T* kb = k + origin;
  const T* vb = v + origin;
  __syncthreads();

  for (int j = 0; j < run; ++j) {
    const int base = j * bs;
    for (int sub = 0; sub < bs; sub += SUB) {           // scores
      const int rows = min(SUB, bs - sub);
      stage_rows<T>(rows_s, kb, row_stride, base + sub, rows, S, dh);
      __syncthreads();
      for (int e = tid; e < G * rows; e += THREADS) {
        const int g = e / rows, r = e % rows;
        const float* qg = qs + g * dh;
        const float* kr = rows_s + r * (dh + 1);
        float dot = 0.0f;
        for (int c = 0; c < dh; ++c) dot = fmaf(qg[c], kr[c], dot);
        sc[g * bs + sub + r] = (base + sub + r < len) ? dot : NEG;
      }
      __syncthreads();
    }
    for (int g = warp; g < G; g += WARPS) {             // softmax stats
      float* sg = sc + g * bs;
      float mx = NEG;
      for (int i = lane; i < bs; i += 32) mx = fmaxf(mx, sg[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int i = lane; i < bs; i += 32) {
        const float p = expf(__fsub_rn(sg[i], m_new));
        sg[i] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_prev, m_new));
        l_s[g] = __fadd_rn(__fmul_rn(l_s[g], alpha), sum);
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    float pv[MAX_ACC];
#pragma unroll
    for (int t = 0; t < MAX_ACC; ++t) pv[t] = 0.0f;
    for (int sub = 0; sub < bs; sub += SUB) {           // p . v
      const int rows = min(SUB, bs - sub);
      stage_rows<T>(rows_s, vb, row_stride, base + sub, rows, S, dh);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < MAX_ACC; ++t) {
        const int e = tid + THREADS * t;
        if (e < G * dh) {
          const int g = e / dh, c = e % dh;
          const float* pg = sc + g * bs + sub;
          float a = pv[t];
          for (int r = 0; r < rows; ++r)
            a = fmaf(pg[r], rows_s[r * (dh + 1) + c], a);
          pv[t] = a;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < MAX_ACC; ++t) {
      const int e = tid + THREADS * t;
      if (e < G * dh)
        acc[t] = __fadd_rn(__fmul_rn(acc[t], a_s[e / dh]), pv[t]);
    }
  }
  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * dh;
#pragma unroll
  for (int t = 0; t < MAX_ACC; ++t) {
    const int e = tid + THREADS * t;
    if (e < G * dh)
      ob[e] = from_f32<T>(__fdiv_rn(acc[t], fmaxf(l_s[e / dh], 1e-30f)));
  }
}

size_t smem_bytes(int G, int dh, int bs) {
  return sizeof(float) *
         ((size_t)G * dh + (size_t)G * bs + (size_t)SUB * (dh + 1) + 3 * G);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int S, int KV, int G, int dh, int bs,
           int n_blocks, float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(G, dh, bs);
  cudaError_t e = cudaFuncSetAttribute(
      decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // grid.y holds at most 65,535 batch rows: launch in slices of the batch
  constexpr int SLICE = 65535;
  for (int b0 = 0; b0 < B; b0 += SLICE) {
    const int rows = B - b0 < SLICE ? B - b0 : SLICE;
    const size_t qo = (size_t)b0 * KV * G * dh;
    const size_t co = (size_t)b0 * S * KV * dh;
    dim3 grid(KV, rows);
    decode_attn_kernel<T><<<grid, THREADS, smem, s>>>(
        reinterpret_cast<const T*>(q) + qo, reinterpret_cast<const T*>(k) + co,
        reinterpret_cast<const T*>(v) + co, lengths + b0,
        reinterpret_cast<T*>(out) + qo, S, KV, G, dh, bs, n_blocks, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace

// dtype: 0 = float32 q, k, v and output, 1 = bfloat16.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out, int B, int S,
                                  int KV, int G, int dh, int bs, float scale,
                                  int dtype, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || G < 1 || dh < 1 || bs < 1 ||
      G * dh > THREADS * MAX_ACC || dtype < 0 || dtype > 1 ||
      smem_bytes(G, dh, bs) > 232448)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (S + bs - 1) / bs;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, B, S, KV, G, dh, bs, n_blocks,
                         scale, s);
  return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, KV, G, dh, bs,
                               n_blocks, scale, s);
}
