// ADC (asymmetric distance) code scan + running top-C for Hopper (sm_90a).
//
// Replaces: repro/kernels/adc_scan/adc_scan.py::adc_scan_pallas (with
// _adc_kernel, adc_scan_kernel_path and rerank_topk's
// merge_topk_unique_rounds).
//
// What it computes: codes [n, m] uint8 (one code word per subspace) and
// per-query lookup tables luts [b, m, K] float32.  For every query q and
// row i < n, d[q, i] = sum_j luts[q, j, codes[i, j]], summed over
// j = 0 .. m-1 in index order from 0.0f, and per query the C smallest
// (d, row) pairs, ascending, ties to the smaller row, (+inf, -1) where
// fewer than C rows exist.  The reference folds with a unique-by-id
// select; a full scan holds every row once, so unique-by-id is plain
// (dist, row) order here.
//
// What bounds it on an H100: by the published peaks, operations -- b*n*m
// float adds (1.6e11 at b = 10^4, n = 10^6, m = 16: 2.4 ms at 67 TFLOP/s)
// against 16 MB of codes plus b*m*K*4 bytes of tables (164 MB, 0.05 ms).
// What a table design really meets is the shared-memory lookup rate: one
// 4-byte lookup per add at 32 banks per clock per SM is ~19 ms at that
// shape, and more by the wavefronts a warp's lookup costs where lanes hit
// the same bank with different words.
//
// Design: the TPU kernel turns the lookup into a one-hot x LUT matmul
// because a TPU has no fast gather; Hopper does, so the tables sit in
// shared memory and each code indexes them directly (a tensor-core
// product would reassociate the index-order sum).  A block owns G queries
// (4 or 1) and a contiguous range of rows.  Their tables are stored
// interleaved, [m][K][G]: the G entries of one (subspace, code) are
// adjacent words, written there by a transposing load from luts
// [b, m, K].  A lane owns all G queries (one 16-byte load per lookup at
// G = 4) and R rows, so only lanes of different rows can meet in a bank:
// on uniform codes ~2.54 wavefronts per 32 lookups at G = 4 and 3.15 at
// G = 1 (one query's table [m][K], the int8 case with its 128 KB table).
// One code byte, one extraction and one address serve G lookups; a
// chunk's 16 subspaces have their loads in flight before their adds, and
// the next step's code words are loaded before the current step's
// lookups.  Measured on an H100 (PERF.md), the lookups cost 3.0 cycles
// per 32 at G = 4 with 16 warps an SM, not the bank model's 2.5; an SM
// with 8 warps (a block whose table takes 128 KB) loses a further third
// to latency, so int8's table gets a wide block of 1,024 threads.  A
// table too large for shared memory (G = 1 only) is read through L1/L2
// from luts itself.
// kernels/adc_scan/adc_scan.py::interleaved_sums mirrors the index
// arithmetic (tables, lanes, rows) in torch.
//
// Selection is buffered: a (row, query) whose distance beats the query's
// current C-th pair (held in the lane's registers, re-read after each
// merge) is appended to the query's buffer of BUF pairs.  When a buffer
// could overflow in the next tile (and at the end), one warp per query
// bitonic-sorts the buffer and merges it into the sorted list of P =
// pow2(C) pairs (C up to 1024); BUF may be smaller than P, so that a
// block's tables, lists and buffers fit two blocks an SM at C = 1000.  The
// corpus axis may be split across blocks; merge_splits_kernel then merges
// the per-range lists by (dist, row).  kernels/adc_scan/adc_scan.py::plan
// picks the variant (G, R, threads), BUF and the splits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

using namespace repro_topk;

constexpr int THREADS = 256;   // threads a block (the wide variant: 1024)
constexpr int TILE = THREADS;  // rows per block of the sums-out entry
constexpr int MAX_G = 8;       // queries per block of the sums-out entry
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

// The first slot of compare-exchange t at a power-of-two stride: t's bits
// above the stride's moved up one place (2 * stride * (t / stride) +
// t % stride, without a division).
__device__ __forceinline__ int pair_index(int t, int stride) {
  return ((t & -stride) << 1) | (t & (stride - 1));
}

// One warp sorts n (a power of two) pairs by a bitonic merge: the input is
// bitonic; the output ascending when up, else descending.
__device__ __forceinline__ void warp_bitonic_merge(float* d, int* id, int n,
                                                   bool up, int lane) {
  for (int stride = n >> 1; stride > 0; stride >>= 1) {
    for (int t = lane; t < n / 2; t += 32) {
      const int i = pair_index(t, stride);
      cas(d, id, i, i + stride, up);
    }
    __syncwarp();
  }
}

// One warp folds a query's buffer (cnt entries, cnt <= BUF) into its sorted
// list of P entries (P a power of two): the P smallest of both, ascending.
// The buffer is padded to S = pow2(cnt) and sorted.  The list's last
// T = min(S, P) entries against the buffer's T smallest read backwards
// (ascending against descending) keep the T smallest of those, bitonic;
// every list entry before them stays, since at most T pairs can pass it.
// With T < P the tail is sorted descending, so the list is ascending then
// descending, and one bitonic merge of P sorts it.
__device__ void warp_merge(float* ld, int* li, float* bd, int* bi, int* cnt,
                           int P, int lane) {
  const int c = *cnt;
  if (c == 0) return;
  int S = 1;
  while (S < c) S <<= 1;
  for (int t = c + lane; t < S; t += 32) {
    bd[t] = INFINITY;
    bi[t] = -1;
  }
  __syncwarp();
  for (int size = 2; size <= S; size <<= 1) {  // buffer ascending
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < S / 2; t += 32) {
        const int i = pair_index(t, stride);
        cas(bd, bi, i, i + stride, (i & size) == 0);
      }
      __syncwarp();
    }
  }
  const int T = S < P ? S : P;
  float* td = ld + (P - T);
  int* ti = li + (P - T);
  for (int i = lane; i < T; i += 32) {
    const float db = bd[T - 1 - i];
    const int ib = bi[T - 1 - i];
    if (pair_less(db, ib, td[i], ti[i])) {
      td[i] = db;
      ti[i] = ib;
    }
  }
  __syncwarp();
  if (T < P) warp_bitonic_merge(td, ti, T, false, lane);
  warp_bitonic_merge(ld, li, P, true, lane);
  if (lane == 0) *cnt = 0;
  __syncwarp();
}

// The 16 code bytes of subspaces j0 .. j0 + 15 of each of the lane's R rows
// (zero past the row's jn = min(16, m - j0) bytes and for rows past
// row_end): one 16-byte load a row when vec16, else byte by byte.
template <int R>
__device__ __forceinline__ void load_codes(uint32_t (&cw)[R][4],
                                           const uint8_t* __restrict__ codes,
                                           int m, int t0, int j0, int p,
                                           int rpp, int row_end, int vec16) {
  const int jn = min(16, m - j0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = t0 + r * rpp + p;
    const uint8_t* code = codes + (size_t)row * m + j0;
    if (row < row_end && vec16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(code));
      cw[r][0] = v.x;
      cw[r][1] = v.y;
      cw[r][2] = v.z;
      cw[r][3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (row < row_end && 4 * q + s < jn)
            word |= (uint32_t)__ldg(code + 4 * q + s) << (8 * s);
        cw[r][q] = word;
      }
    }
  }
}

// acc[0 .. G) += the G adjacent table words at e, each with one rounding.
template <int G, bool SMEM>
__device__ __forceinline__ void lookup_add(float* acc, const float* e) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(e);
    acc[0] = __fadd_rn(acc[0], t.x);
    acc[1] = __fadd_rn(acc[1], t.y);
    acc[2] = __fadd_rn(acc[2], t.z);
    acc[3] = __fadd_rn(acc[3], t.w);
  } else if constexpr (SMEM) {
    acc[0] = __fadd_rn(acc[0], *e);
  } else {
    acc[0] = __fadd_rn(acc[0], __ldg(e));
  }
}

// acc[r] += the table entries of subspaces j0 .. j0 + jn - 1 at the code
// bytes cw[r] of the lane's R rows, subspace by subspace; tj points at
// subspace j0's entries (GK words a subspace).  FULL (jn = 16) has no
// guard, so that all 16 * R loads of a chunk can be in flight before their
// adds.
template <int G, int R, bool SMEM, bool FULL>
__device__ __forceinline__ void scan_chunk(float (&acc)[R][G],
                                           const uint32_t (&cw)[R][4],
                                           const float* tj, int GK, int jn) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    if (FULL || jj < jn) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t c =
            __byte_perm(cw[r][jj >> 2], 0u, 0x4440u | (jj & 3));
        lookup_add<G, SMEM>(acc[r], tj + c * G);
      }
    }
    tj += GK;
  }
}

// The scan: block (x, y) of NT threads owns queries [x * G, x * G + G) and
// rows [y * rows_per_split, ...).  Thread tid owns the block's G queries
// and, in a tile starting at t0, rows t0 + r * NT + tid, r < R.  Shared
// memory: the tables [m][K][G] (when SMEM), the lists [G][P] (dist, row),
// the buffers [G][BUF] and their counts [G].  The wide variant puts more
// warps on a table that leaves room for one block an SM: 1,024 threads on
// int8's (128 KB).
template <int G, int R, bool SMEM, int NT>
__global__ void __launch_bounds__(NT, NT == THREADS && R <= 2 ? 2 : 1)
adc_scan_kernel(const uint8_t* __restrict__ codes,
                const float* __restrict__ luts, float* __restrict__ part_d,
                int* __restrict__ part_i, int b, int n, int m, int K, int C,
                int P, int BUF, int vec16, int rows_per_split) {
  static_assert(SMEM || G == 1, "the cache route reads one query's table");
  static_assert(G == 1 || G == 4, "lookup_add loads 1 or 4 words");
  constexpr int TR = R * NT;           // rows per tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_len = m * K;
  float* lut_s = reinterpret_cast<float*>(smem);
  float* ld = lut_s + (SMEM ? (size_t)G * lut_len : 0);
  int* li = reinterpret_cast<int*>(ld + G * P);
  float* bd = reinterpret_cast<float*>(li + G * P);
  int* bi = reinterpret_cast<int*>(bd + G * BUF);
  int* cnt = bi + G * BUF;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * G;
  const int gq = min(G, b - q0);       // live queries (the tail group: fewer)
  const long long begin_ll = (long long)blockIdx.y * rows_per_split;
  const int row_begin = (int)(begin_ll < n ? begin_ll : n);
  const int row_end =
      (int)(begin_ll + rows_per_split < n ? begin_ll + rows_per_split : n);

  if constexpr (SMEM) {
    // Transposing load: word e of the G tables (coalesced per query) to
    // words e*G .. e*G + G - 1, U words a thread in flight at a time; a
    // phase's stores are contiguous.  Queries past the tail group's gq get
    // zeros and never enter a list.
    constexpr int U = G == 4 ? 4 : 8;
    for (int e0 = tid; e0 < lut_len; e0 += U * NT) {
      float v[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT;
#pragma unroll
        for (int g = 0; g < G; ++g)
          v[u][g] = e < lut_len && g < gq
                        ? __ldg(luts + (size_t)(q0 + g) * lut_len + e)
                        : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT;
        if (e >= lut_len) break;
        float* dst = lut_s + (size_t)e * G;
        if constexpr (G == 4) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        } else {
          dst[0] = v[u][0];
        }
      }
    }
  }
  for (int e = tid; e < G * P; e += NT) {
    ld[e] = INFINITY;
    li[e] = -1;
  }
  if (tid < G) cnt[tid] = 0;
  __syncthreads();

  const float* tab;
  if constexpr (SMEM)
    tab = lut_s;
  else
    tab = luts + (size_t)q0 * lut_len;
  const int GK = G * K;                // words of one subspace's entries
  float thr_d[G];                      // each query's C-th pair
  int thr_i[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    thr_d[g] = INFINITY;
    thr_i[g] = -1;
  }

  uint32_t cur[R][4], nxt[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[r][q] = nxt[r][q] = 0u;
  if (row_begin < row_end)
    load_codes<R>(cur, codes, m, row_begin, 0, tid, NT, row_end, vec16);

  for (int t0 = row_begin; t0 < row_end; t0 += TR) {
    float acc[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[r][g] = 0.0f;
    for (int j0 = 0; j0 < m; j0 += 16) {
      // the next step's code words first: tile t0's next 16 subspaces, or
      // the next tile's first
      int nt0 = t0, nj0 = j0 + 16;
      if (nj0 >= m) {
        nt0 += TR;
        nj0 = 0;
      }
      if (nt0 < row_end)
        load_codes<R>(nxt, codes, m, nt0, nj0, tid, NT, row_end, vec16);
      const float* tj = tab + (size_t)j0 * GK;
      if (m - j0 >= 16)
        scan_chunk<G, R, SMEM, true>(acc, cur, tj, GK, 16);
      else
        scan_chunk<G, R, SMEM, false>(acc, cur, tj, GK, m - j0);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) cur[r][q] = nxt[r][q];
    }
    // threshold filter against each query's C-th pair; a buffer that
    // passed BUF - TR entries could overflow in the next tile
    bool over = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = t0 + r * NT + tid;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (q < gq && row < row_end &&
            beats(acc[r][q], row, thr_d[q], thr_i[q])) {
          const int pos = atomicAdd(&cnt[q], 1);
          bd[q * BUF + pos] = acc[r][q];
          bi[q * BUF + pos] = row;
          over |= pos >= BUF - TR;
        }
      }
    }
    if (__syncthreads_or(over)) {
      if (warp < gq)
        warp_merge(ld + warp * P, li + warp * P, bd + warp * BUF,
                   bi + warp * BUF, cnt + warp, P, lane);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (q < gq) {
          thr_d[q] = ld[q * P + C - 1];
          thr_i[q] = li[q * P + C - 1];
        }
      }
    }
  }
  if (warp < gq)
    warp_merge(ld + warp * P, li + warp * P, bd + warp * BUF, bi + warp * BUF,
               cnt + warp, P, lane);
  __syncthreads();
  for (int e = tid; e < gq * C; e += NT) {
    const int g = e / C, t = e % C;
    const size_t o = ((size_t)blockIdx.y * b + q0 + g) * C + t;
    part_d[o] = ld[g * P + t];
    part_i[o] = li[g * P + t];
  }
}

// The sums-out entry behind ops.adc_scan for C > MAX_C: the [b, n] ADC
// sums into a float32 buffer with row stride ldo, each summed over the
// subspaces in index order from 0 as above (so bit for bit the sums the
// scan kernel ranks); the wrapper then selects by (dist, row).  One thread
// per row, G queries per block, their tables in shared memory when
// lut_smem (else read through L1/L2).
__global__ void __launch_bounds__(THREADS)
adc_sums_kernel(const uint8_t* __restrict__ codes,
                const float* __restrict__ luts, float* __restrict__ out,
                int b, int n, int m, int K, int G, int lut_smem,
                long long ldo) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);          // [G][m][K]
  const int lut_len = m * K;
  const int q0 = blockIdx.y * G;
  const int gq = min(G, b - q0);
  const float* lut_q = luts + (size_t)q0 * lut_len;
  if (lut_smem) {
    for (int e = threadIdx.x; e < gq * lut_len; e += THREADS)
      lut_s[e] = lut_q[e];
    __syncthreads();
  }
  const float* lut_base = lut_smem ? lut_s : lut_q;
  const int row = blockIdx.x * TILE + threadIdx.x;
  if (row >= n) return;
  const uint8_t* code = codes + (size_t)row * m;
  for (int g = 0; g < gq; ++g) {
    const float* L = lut_base + (size_t)g * lut_len;
    float a = 0.0f;
    for (int j = 0; j < m; ++j) a = __fadd_rn(a, L[j * K + __ldg(code + j)]);
    out[(size_t)(q0 + g) * ldo + row] = a;
  }
}

using ScanFn = void (*)(const uint8_t*, const float*, float*, int*, int, int,
                        int, int, int, int, int, int, int);

// The compiled variants (G queries a block, R rows a lane, NT threads a
// block, tables in shared memory or through the caches), the ones that won
// on the compressed paths' shapes in benchmarks/sweep_adc_plan.py's sweep
// of G in {8, 4, 2, 1}, R in {1, 2, 4} and 256 threads (plus wide blocks),
// and what small batches and tables too large for shared memory need:
// four queries' tables under 256 threads, one under 256 (a small table:
// several blocks an SM) or 1,024 (int8's 128 KB: one block an SM), and
// one read through the caches.
ScanFn scan_variant(int G, int R, int NT, int lut_smem) {
  if (!lut_smem)
    return G == 1 && R == 1 && NT == THREADS
               ? adc_scan_kernel<1, 1, false, THREADS> : nullptr;
  if (G == 4 && NT == THREADS && R == 1)
    return adc_scan_kernel<4, 1, true, THREADS>;
  if (G == 1 && NT == THREADS && R == 1)
    return adc_scan_kernel<1, 1, true, THREADS>;
  if (G == 1 && NT == 1024 && R == 2) return adc_scan_kernel<1, 2, true, 1024>;
  return nullptr;
}

}  // namespace

extern "C" int adc_sums_launch(const uint8_t* codes, const float* luts,
                               float* out, int b, int n, int m, int K, int G,
                               int lut_smem, long long ldo, void* stream) {
  if (b < 1 || n < 1 || m < 1 || K < 1 || G < 1 || G > MAX_G || ldo < n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = lut_smem ? sizeof(float) * (size_t)G * m * K : 0;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      adc_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // grid.y holds at most 65,535 query groups: launch in slices of queries
  const int slice = 65535 * G;
  for (int q0 = 0; q0 < b; q0 += slice) {
    const int rows = b - q0 < slice ? b - q0 : slice;
    dim3 grid((n + TILE - 1) / TILE, (rows + G - 1) / G);
    adc_sums_kernel<<<grid, THREADS, smem, s>>>(
        codes, luts + (size_t)q0 * m * K, out + (size_t)q0 * ldo, rows, n, m,
        K, G, lut_smem, ldo);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// Resident blocks per SM of the (G, R, NT, lut_smem) variant with smem bytes
// of dynamic shared memory (the occupancy calculator's answer).
extern "C" int adc_scan_blocks_per_sm(int G, int R, int NT, int lut_smem,
                                      int smem, int* out) {
  ScanFn fn = scan_variant(G, R, NT, lut_smem);
  if (fn == nullptr || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, NT,
                                                            (size_t)smem);
}

extern "C" int adc_scan_launch(const uint8_t* codes, const float* luts,
                               float* part_d, int* part_i, float* out_d,
                               int* out_i, int b, int n, int m, int K, int C,
                               int P, int BUF, int G, int R, int NT,
                               int lut_smem, int n_splits,
                               int rows_per_split, void* stream) {
  ScanFn fn = scan_variant(G, R, NT, lut_smem);
  const bool pow2 = P > 0 && (P & (P - 1)) == 0 && BUF > 0 &&
                    (BUF & (BUF - 1)) == 0;
  if (fn == nullptr || b < 1 || n < 1 || m < 1 || K < 1 || C < 1 ||
      C > MAX_C || !pow2 || P < C || BUF < R * NT ||
      n_splits < 1 || n_splits > repro_topk::MAX_SPLITS || rows_per_split < 1 ||
      rows_per_split % (R * NT) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (lut_smem ? (size_t)G * m * K : 0) +
      (sizeof(float) + sizeof(int)) * (size_t)G * (P + BUF) +
      sizeof(int) * (size_t)G;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec16 =
      (m % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool direct = n_splits == 1;
  dim3 grid((b + G - 1) / G, n_splits);
  fn<<<grid, NT, smem, s>>>(codes, luts, direct ? out_d : part_d,
                                 direct ? out_i : part_i, b, n, m, K, C, P,
                                 BUF, vec16, rows_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return (int)e;
  repro_topk::merge_splits_kernel<<<(b + 127) / 128, 128, 0, s>>>(
      part_d, part_i, out_d, out_i, b, C, n_splits);
  return (int)cudaGetLastError();
}
