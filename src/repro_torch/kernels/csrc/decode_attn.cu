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
// Design: two passes on one stream.  The partition pass runs one block per
// (kv head, batch row, partition), all G query heads of the group in the
// block, so each cache row is read once for G heads; the cache is read in
// place through its strides (no per-head copy: the reference's vmap over
// axis 2 would copy 17 GB at that shape).  A partition is a run of
// part_blocks whole bs-blocks (the last one may be shorter); inside it the
// block runs the online softmax above from m = -1e30, l = 0, acc = 0.  Per
// block of bs positions: K rows are staged 64 at a time into shared memory
// as float32 (rows padded to dh + 1 words: conflict-free), one thread per
// (head, position) takes the dot product in index order; one warp per head
// takes the block max and the probabilities; then V rows are staged the
// same way and each thread owns up to 8 (head, column) entries of the
// output, accumulating p . v for the block before the alpha update.  The
// block writes its partial (m, l, acc[G][dh]) in float32 to a workspace
// [P][B][H] (acc [P][B][H][dh]) that the wrapper allocates.
//
// The combine pass takes, per (b, query head, column) and in ascending p:
//   M = max_p m_p;  w_p = exp(m_p - M);
//   out = (sum_p w_p acc_p) / max(sum_p w_p l_p, 1e-30)  in q's type.
// It runs for every P, 1 included (w = 1: the single partition's own
// divide), so there is one path.  Every partition block writes a partial,
// also one that starts past lengths[b] > 0: that one writes the neutral
// (m = -1e30, l = 0, acc = 0) and returns, so the combine never reads
// memory nobody wrote, and its w_p = exp(-1e30 - M) is 0 beside the
// finite M of the valid partitions.  A row with lengths[b] <= 0 has m_p =
// -1e30 in every partition, so w_p = 1 and the combine averages v over the
// padded length, as the reference does.  Neither case needs its own code.
//
// P: the wrapper (decode_attn.py::partitions) takes the fewest partitions
// that make the blocks of one launch 16 resident waves (occupancy from
// decode_attn_blocks_per_sm: 5 blocks per SM at these shapes), from shapes
// only, never from the lengths: P = 11 of 6 blocks at decode_32k (1,024
// (kv, b) pairs), P = 512 of 2 blocks at gemma3-27b's long_500k with B = 1
// (16 pairs, 1,024 blocks of 512 positions).
// The block body is the next piece of work: 16-byte asynchronous staging
// in bf16, score chains split across lanes, all 8 warps in the score loop.
//
// Launch contract: B of any size (the launcher slices the batch over
// grid.y's 65,535 rows); 1 <= part_blocks <= n_blocks; G * dh <= 2,048
// outputs per block and smem_bytes(G, dh, bs) <= 232,448 (the wrapper,
// decode_attn.py, splits each KV head's G query heads into groups that fit
// both, and refuses only a single head whose smem_bytes(1, dh, bs) does
// not fit).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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

// The partition pass: grid (KV * P, batch rows of the slice); ws_* point
// at the slice's first row of partition 0, part_stride = B * H apart.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_part(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ ws_m, float* __restrict__ ws_l,
                 float* __restrict__ ws_acc, size_t part_stride, int S,
                 int KV, int G, int dh, int bs, int n_blocks, int part_blocks,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [G][dh]   scaled queries
  float* sc = qs + G * dh;                // [G][bs]   scores, then p
  float* rows_s = sc + G * bs;            // [SUB][dh + 1]
  float* m_s = rows_s + SUB * (dh + 1);   // [G]
  float* l_s = m_s + G;                   // [G]
  float* a_s = l_s + G;                   // [G]      alpha of the block

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.x % KV, part = blockIdx.x / KV;
  const int b = blockIdx.y;
  const int H = KV * G;
  const size_t row = part * part_stride + (size_t)b * H + (size_t)kvh * G;
  float* mb = ws_m + row;
  float* lb = ws_l + row;
  float* ab = ws_acc + row * dh;
  const int len = lengths[b];
  const int run = len > 0 ? min(n_blocks, (len + bs - 1) / bs) : n_blocks;
  const int j0 = part * part_blocks;
  if (j0 >= run) {                  // wholly past the length: neutral
    for (int e = tid; e < G * dh; e += THREADS) ab[e] = 0.0f;
    for (int g = tid; g < G; g += THREADS) {
      mb[g] = NEG;
      lb[g] = 0.0f;
    }
    return;
  }
  const int j1 = min(run, j0 + part_blocks);
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

  const size_t row_stride = (size_t)KV * dh;
  const size_t origin = (size_t)b * S * KV * dh + (size_t)kvh * dh;
  const T* kb = k + origin;
  const T* vb = v + origin;
  __syncthreads();

  for (int j = j0; j < j1; ++j) {
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
#pragma unroll
  for (int t = 0; t < MAX_ACC; ++t) {
    const int e = tid + THREADS * t;
    if (e < G * dh) ab[e] = acc[t];
  }
  for (int g = tid; g < G; g += THREADS) {
    mb[g] = m_s[g];
    lb[g] = l_s[g];
  }
}

// The combine pass over n = rows * dh outputs (rows = B * H): the P
// partials of each (row, column) in ascending p, exactly as the plain
// version adds them (no fused multiply-add).  At B = 1 it has one warp per
// SM or fewer, each walking all P partials (512 at long_500k): the loops
// are unrolled 16 deep so that 16 loads are in flight, not one.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_combine(const float* __restrict__ ws_m,
                    const float* __restrict__ ws_l,
                    const float* __restrict__ ws_acc, T* __restrict__ out,
                    size_t rows, int dh, int P) {
  const size_t n = rows * dh;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (size_t)gridDim.x * THREADS) {
    const size_t r = e / dh;
    float M = NEG;
#pragma unroll 16
    for (int p = 0; p < P; ++p) M = fmaxf(M, ws_m[p * rows + r]);
    float num = 0.0f, den = 0.0f;
#pragma unroll 16
    for (int p = 0; p < P; ++p) {
      const float w = expf(__fsub_rn(ws_m[p * rows + r], M));
      num = __fadd_rn(num, __fmul_rn(w, ws_acc[p * n + e]));
      den = __fadd_rn(den, __fmul_rn(w, ws_l[p * rows + r]));
    }
    out[e] = from_f32<T>(__fdiv_rn(num, fmaxf(den, 1e-30f)));
  }
}

size_t smem_bytes(int G, int dh, int bs) {
  return sizeof(float) *
         ((size_t)G * dh + (size_t)G * bs + (size_t)SUB * (dh + 1) + 3 * G);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* ws_m, float* ws_l, float* ws_acc, int B, int S,
           int KV, int G, int dh, int bs, int n_blocks, int part_blocks,
           float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(G, dh, bs);
  cudaError_t e = cudaFuncSetAttribute(
      decode_attn_part<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int P = (n_blocks + part_blocks - 1) / part_blocks;
  const size_t H = (size_t)KV * G, rows = (size_t)B * H;
  // grid.y holds at most 65,535 batch rows: launch in slices of the batch
  constexpr int SLICE = 65535;
  for (int b0 = 0; b0 < B; b0 += SLICE) {
    const int nb = B - b0 < SLICE ? B - b0 : SLICE;
    const size_t qo = (size_t)b0 * H * dh;
    const size_t co = (size_t)b0 * S * KV * dh;
    const size_t wo = (size_t)b0 * H;
    dim3 grid(KV * P, nb);
    decode_attn_part<T><<<grid, THREADS, smem, s>>>(
        reinterpret_cast<const T*>(q) + qo, reinterpret_cast<const T*>(k) + co,
        reinterpret_cast<const T*>(v) + co, lengths + b0, ws_m + wo,
        ws_l + wo, ws_acc + wo * dh, rows, S, KV, G, dh, bs, n_blocks,
        part_blocks, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t n = rows * dh;
  const size_t want = (n + THREADS - 1) / THREADS;
  const unsigned blocks = want < (1u << 20) ? (unsigned)want : (1u << 20);
  decode_attn_combine<T><<<blocks, THREADS, 0, s>>>(
      ws_m, ws_l, ws_acc, reinterpret_cast<T*>(out), rows, dh, P);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_attn_part<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, decode_attn_part<T>,
                                                      THREADS, smem);
  return (int)e;
}

bool valid(int G, int dh, int bs, int dtype) {
  return G >= 1 && dh >= 1 && bs >= 1 && G * dh <= THREADS * MAX_ACC &&
         dtype >= 0 && dtype <= 1 && smem_bytes(G, dh, bs) <= 232448;
}

}  // namespace

// dtype: 0 = float32 q, k, v and output, 1 = bfloat16.  ws_m, ws_l [P][B][H]
// and ws_acc [P][B][H][dh] float32 (H = KV * G, P = ceil(n_blocks /
// part_blocks)): the partials, each written by the partition pass before
// the combine pass reads it.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out, float* ws_m,
                                  float* ws_l, float* ws_acc, int B, int S,
                                  int KV, int G, int dh, int bs,
                                  int part_blocks, float scale, int dtype,
                                  void* stream) {
  if (B < 1 || S < 1 || KV < 1 || !valid(G, dh, bs, dtype))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (S + bs - 1) / bs;
  if (part_blocks < 1 || part_blocks > n_blocks ||
      (long long)KV * ((n_blocks + part_blocks - 1) / part_blocks) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, ws_m, ws_l, ws_acc, B, S, KV,
                         G, dh, bs, n_blocks, part_blocks, scale, s);
  return launch<__nv_bfloat16>(q, k, v, lengths, out, ws_m, ws_l, ws_acc, B,
                               S, KV, G, dh, bs, n_blocks, part_blocks, scale,
                               s);
}

// Resident partition-pass blocks per SM for G heads at (dh, bs) in *out,
// from the occupancy calculator (registers, shared memory, threads).
extern "C" int decode_attn_blocks_per_sm(int G, int dh, int bs, int dtype,
                                         int* out) {
  if (!valid(G, dh, bs, dtype)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, dh, bs);
  return dtype == 0 ? blocks_per_sm<float>(smem, out)
                    : blocks_per_sm<__nv_bfloat16>(smem, out);
}
