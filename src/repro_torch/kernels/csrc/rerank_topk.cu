// Fused candidate rerank for Hopper (sm_90a): exact distances + a running
// unique-by-id top-k, with two entries.
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
// [b, C, d] gathered tensor never exists.  <q, x> is one fmaf chain over d
// in index order from +0.0, and the epilogue rounds each operation on its
// own (__fsub_rn / __fmul_rn / __fadd_rn), in both entries, so that the
// two give the same bits on the same window.
//
// 1. The generic entry (rerank_topk_launch; the window distances-out entry
//    rerank_dist_launch shares its body): the TPU kernel's contract, for
//    every consumer but IVF's fp32 search (the LSH schemes, RPForest, the
//    Hamming rerankers, IVF-PQ's exact rerank).  Bound on an H100: the bytes
//    of the valid candidates' rows (512 B each at d = 128 fp32) and the 12
//    operand bytes of every slot, at 3.35 TB/s; a row is used by one query,
//    so it comes from device memory unless another query's window just read
//    it.  Design: one warp per query (a block), its list in shared memory.
//    The warp loads the operands of 8 groups of 32 slots at once (the next 8
//    while it works on these), so a masked slot costs its 12 bytes and
//    nothing else.  In each group one ballot compacts the valid slots; their
//    rows are staged into shared memory with cp.async (16-byte copies where
//    d % 4 == 0 and X is aligned, 4-byte ones otherwise; chunks of at most
//    128 words of d), two stages deep, so the next group's rows load while
//    this one is scored.  A row's stride is an odd number of 16-byte units
//    (or words), so lanes reading one row each hit distinct banks.  Lane j
//    scores candidate j; the ones that beat the k-th pair enter the list
//    one at a time (warp_insert_unique).  On an H100 at 700 W (PERF.md):
//    13.2 ms at IVF's window at k = 10 (23.4 for the former serial row
//    walk), about 2.4 TB/s of rows and operands; the one-chain sum is
//    further from the exact cross term than the walk's lane tree (2.0e-3
//    against 4.3e-4 at distances near 256).
//
// 2. The list entry (rerank_lists_launch + rerank_merge_launch): IVF's
//    fp32 search without the window.  The same result as the generic entry
//    on the window [b, P lists x M rows] that probe_window builds, computed
//    list by list.  Bound: 2 * (valid pairs) * d fp32 operations (1.37e10
//    at IVF's main shape, 0.20 ms at 67 TFLOP/s), or the probed lists' rows
//    read once.  Design: the wrapper sorts the (query, probe slot) pairs by
//    list (ops.py::pair_build); a block owns one list and a chunk of BM of
//    its queries, and runs kernel 1's 128-column tile (fp32_tile.cuh) with
//    the gathered query rows as A and the list's contiguous rows (the
//    cluster-major corpus) as B, double-buffered, one barrier per 8-wide
//    chunk.  The epilogue is the rerank's (no clamp); a dead row
//    (row_live) or one past the list's scan budget takes id -1.  Selection
//    is kernel 1's (a threshold against each row's k-th pair, a 16-pair
//    buffer per query, rounds, one warp per query inserting), unique by
//    id.  Each block writes one partial list per (query, probe slot); the
//    merge kernel, one warp per query, merges a query's live partial lists
//    by (dist, id), each id once.  Lists are taken longest first (perm),
//    so the longest blocks do not end the grid alone.  A block holds 64
//    query rows (kernel 1's 64-row tile).  On an H100 at 700 W (PERF.md):
//    1.7 ms of list kernel at IVF's main window at k = 10, against a
//    0.20 ms bound; its selection, a partial list per (query, list) that
//    starts empty, weighs more as k grows (k = 256: 30 ms).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_tile.cuh"
#include "topk_list.cuh"

namespace {

using namespace repro_topk;

constexpr int MAX_K = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_BLOCK = 232448;   // shared memory a block may have

enum Mode { L2SQ = 0, COS = 1, HAM = 2 };

__device__ __forceinline__ float rerank_epilogue(int mode, float cross,
                                                 float qn, float pen) {
  return mode == L2SQ
             ? __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), pen)
             : __fadd_rn(__fsub_rn(1.0f, cross), pen);
}

// ------------------------------------------------------------- generic entry

constexpr int GROUPS = 8;     // slot groups of 32 whose operands load at once
constexpr int DW = 128;       // words of d staged per pipeline item

enum Out { TOPK = 0, DIST = 1 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Words between two staged rows: the chunk width rounded up to whole
// 16-byte units (VEC) or words, then to an odd count of them.
__host__ __device__ __forceinline__ int stage_stride(int d, bool vec) {
  const int w = d < DW ? d : DW;
  return vec ? 4 * (((w + 3) / 4) | 1) : (w | 1);
}

size_t generic_smem_bytes(int d, int k, bool vec, int out) {
  const int d_pad = (d + 3) / 4 * 4;
  return 4 * ((size_t)d_pad + 2 * 32 * stage_stride(d, vec) + 2 * 32 * 4) +
         (out == TOPK ? 8 * (size_t)k : 0);
}

// Stage words [c0, c0 + w) of the n rows srow[0..n) into dst (rows `stride`
// words apart).  Units of 16 bytes (VEC) or 4; where a row has at least 32
// units the warp copies a row at a time, else 32 / units rows at a time.
template <bool VEC>
__device__ __forceinline__ void stage_rows(uint32_t* dst,
                                           const int* srow, int n,
                                           const uint32_t* __restrict__ X,
                                           int d, int c0, int w, int stride,
                                           int lane) {
  constexpr int U = VEC ? 4 : 1;
  const int units = (w + U - 1) / U;
  if (units >= 32) {
    for (int r = 0; r < n; ++r) {
      const uint32_t* src = X + (size_t)srow[r] * d + c0;
      for (int u = lane; u < units; u += 32) {
        if (VEC)
          cp_async16(dst + r * stride + 4 * u, src + 4 * u);
        else
          cp_async4(dst + r * stride + u, src + u);
      }
    }
  } else {
    const int per = 32 / units;
    const int r0 = lane / units, u = lane % units;
    if (r0 < per) {
      for (int r = r0; r < n; r += per) {
        const uint32_t* src = X + (size_t)srow[r] * d + c0 + U * u;
        if (VEC)
          cp_async16(dst + r * stride + 4 * u, src);
        else
          cp_async4(dst + r * stride + u, src);
      }
    }
  }
}

// One chunk of lane `lane`'s candidate: the fmaf chain (or popcount sum)
// over words [c0, c0 + w) of its staged row against q.
template <int MODE, bool VEC>
__device__ __forceinline__ void score_chunk(float& acc, int& hacc,
                                            const uint32_t* x,
                                            const uint32_t* q, int w) {
  if (VEC) {
    for (int c = 0; c < w; c += 4) {
      const uint4 xv = *reinterpret_cast<const uint4*>(x + c);
      const uint4 qv = *reinterpret_cast<const uint4*>(q + c);
      if (MODE == HAM) {
        hacc += __popc(xv.x ^ qv.x) + __popc(xv.y ^ qv.y) +
                __popc(xv.z ^ qv.z) + __popc(xv.w ^ qv.w);
      } else {
        acc = fmaf(__uint_as_float(qv.x), __uint_as_float(xv.x), acc);
        acc = fmaf(__uint_as_float(qv.y), __uint_as_float(xv.y), acc);
        acc = fmaf(__uint_as_float(qv.z), __uint_as_float(xv.z), acc);
        acc = fmaf(__uint_as_float(qv.w), __uint_as_float(xv.w), acc);
      }
    }
  } else {
    for (int c = 0; c < w; ++c) {
      if (MODE == HAM)
        hacc += __popc(x[c] ^ q[c]);
      else
        acc = fmaf(__uint_as_float(q[c]), __uint_as_float(x[c]), acc);
    }
  }
}

// The generic entry's body.  OUT == TOPK keeps the k best distinct ids of
// query blockIdx.x; OUT == DIST writes its [C] distances (+inf where
// masked) for the distances-out route.
template <int MODE, bool VEC, int OUT>
__global__ void __launch_bounds__(32)
rerank_window_kernel(const int* __restrict__ rows,
                     const uint32_t* __restrict__ Q,
                     const float* __restrict__ qsq,
                     const int* __restrict__ ids,
                     const float* __restrict__ pen,
                     const uint32_t* __restrict__ X, float* __restrict__ out_d,
                     int* __restrict__ out_i, int C, int d, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int q = blockIdx.x;
  const int d_pad = (d + 3) / 4 * 4;
  const int stride = stage_stride(d, VEC);
  uint32_t* qw = reinterpret_cast<uint32_t*>(smem);          // [d_pad]
  uint32_t* stage = qw + d_pad;                              // [2][32][stride]
  int* srow = reinterpret_cast<int*>(stage + 2 * 32 * stride);  // [2][32]
  int* sid = srow + 64;                                      // [2][32]
  float* spen = reinterpret_cast<float*>(sid + 64);          // [2][32]
  int* sslot = reinterpret_cast<int*>(spen + 64);            // [2][32]
  float* ld = reinterpret_cast<float*>(sslot + 64);          // [k]
  int* li = reinterpret_cast<int*>(ld + k);                  // [k]

  for (int c = lane; c < d_pad; c += 32)
    qw[c] = c < d ? Q[(size_t)q * d + c] : 0u;
  if (OUT == TOPK) list_init(ld, li, k, lane, 32);
  __syncwarp();
  const float qn = MODE == L2SQ ? qsq[q] : 0.0f;
  const size_t base = (size_t)q * C;
  const int chunks = (d + DW - 1) / DW;
  const unsigned below = (1u << lane) - 1u;

  // the pipeline: an item is (group, chunk of d); `pending` is staged in
  // data buffer p_db, its group's operands in meta buffer p_mb
  bool pending = false;
  int p_db = 0, p_mb = 0, p_c = 0, p_n = 0;
  int db = 0, mb = 1;
  float acc = 0.0f;
  int hacc = 0;

  auto score = [&]() {
    const int c0 = p_c * DW;
    const int w = min(DW, d - c0);
    if (lane < p_n) {
      if (p_c == 0) {
        acc = 0.0f;
        hacc = 0;
      }
      score_chunk<MODE, VEC>(acc, hacc, stage + (p_db * 32 + lane) * stride,
                             qw + c0, w);
    }
    if (p_c + 1 < chunks) return;
    float mine = INFINITY;
    int myid = -1;
    if (lane < p_n) {
      const float p = spen[p_mb * 32 + lane];
      mine = MODE == HAM ? __fadd_rn((float)hacc, p)
                         : rerank_epilogue(MODE, acc, qn, p);
      myid = sid[p_mb * 32 + lane];
    }
    if (OUT == DIST) {
      if (lane < p_n) out_d[base + sslot[p_mb * 32 + lane]] = mine;
      return;
    }
    unsigned todo = __ballot_sync(FULL, beats(mine, myid, ld[k - 1],
                                              li[k - 1]));
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      warp_insert_unique(ld, li, k, __shfl_sync(FULL, mine, src),
                         __shfl_sync(FULL, myid, src), lane);
    }
  };

  int cr[GROUPS], ci[GROUPS], nr[GROUPS], ni[GROUPS];
  float cp[GROUPS], np[GROUPS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int j = 32 * g + lane;
    const bool in = j < C;
    cr[g] = in ? rows[base + j] : 0;
    ci[g] = in ? ids[base + j] : -1;
    cp[g] = in ? pen[base + j] : INFINITY;
  }
  for (int s0 = 0; s0 < C; s0 += 32 * GROUPS) {
    const int s1 = s0 + 32 * GROUPS;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {   // the next batch's operands
      const int j = s1 + 32 * g + lane;
      const bool in = j < C;
      nr[g] = in ? rows[base + j] : 0;
      ni[g] = in ? ids[base + j] : -1;
      np[g] = in ? pen[base + j] : INFINITY;
    }
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int slot = s0 + 32 * g + lane;
      const bool valid = ci[g] >= 0 && cp[g] < INFINITY;
      if (OUT == DIST && slot < C && !valid) out_d[base + slot] = INFINITY;
      const unsigned mask = __ballot_sync(FULL, valid);
      if (!mask) continue;
      mb ^= 1;
      if (valid) {
        const int at = mb * 32 + __popc(mask & below);
        srow[at] = cr[g];
        sid[at] = ci[g];
        spen[at] = cp[g];
        sslot[at] = slot;
      }
      __syncwarp();
      const int n = __popc(mask);
      for (int c = 0; c < chunks; ++c) {
        stage_rows<VEC>(stage + db * 32 * stride, srow + mb * 32, n, X, d,
                        c * DW, min(DW, d - c * DW), stride, lane);
        cp_async_commit();
        if (pending) {
          cp_async_wait<1>();
          __syncwarp();
          score();
          __syncwarp();
        }
        pending = true;
        p_db = db;
        p_mb = mb;
        p_c = c;
        p_n = n;
        db ^= 1;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      cr[g] = nr[g];
      ci[g] = ni[g];
      cp[g] = np[g];
    }
  }
  if (pending) {
    cp_async_wait<0>();
    __syncwarp();
    score();
  }
  if (OUT == TOPK) {
    __syncwarp();
    for (int t = lane; t < k; t += 32) {
      out_d[(size_t)q * k + t] = ld[t];
      out_i[(size_t)q * k + t] = li[t];
    }
  }
}

template <int MODE, bool VEC, int OUT>
int launch_window(const int* rows, const void* Q, const float* qsq,
                  const int* ids, const float* pen, const void* X,
                  float* out_d, int* out_i, int b, int C, int d, int k,
                  cudaStream_t s) {
  const size_t smem = generic_smem_bytes(d, k, VEC, OUT);
  if (smem > (size_t)SMEM_BLOCK) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      rerank_window_kernel<MODE, VEC, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  rerank_window_kernel<MODE, VEC, OUT><<<b, 32, smem, s>>>(
      rows, reinterpret_cast<const uint32_t*>(Q), qsq, ids, pen,
      reinterpret_cast<const uint32_t*>(X), out_d, out_i, C, d, k);
  return (int)cudaGetLastError();
}

template <int OUT>
int dispatch_window(const int* rows, const void* Q, const float* qsq,
                    const int* ids, const float* pen, const void* X,
                    float* out_d, int* out_i, int b, int C, int d, int k,
                    int mode, cudaStream_t s) {
  const bool vec = d % 4 == 0 && (uintptr_t)X % 16 == 0;
#define REPRO_WINDOW(M, V)                                                 \
  return launch_window<M, V, OUT>(rows, Q, qsq, ids, pen, X, out_d, out_i, \
                                  b, C, d, k, s)
  if (vec) {
    if (mode == L2SQ) REPRO_WINDOW(L2SQ, true);
    if (mode == COS) REPRO_WINDOW(COS, true);
    REPRO_WINDOW(HAM, true);
  }
  if (mode == L2SQ) REPRO_WINDOW(L2SQ, false);
  if (mode == COS) REPRO_WINDOW(COS, false);
  REPRO_WINDOW(HAM, false);
#undef REPRO_WINDOW
}

// ---------------------------------------------------------------- list entry

using fp32_tile::BD;
using fp32_tile::BN;
using fp32_tile::fma_chunk;
using fp32_tile::LDX;
using fp32_tile::load4;
using fp32_tile::store_kmajor;
using fp32_tile::THREADS;
using fp32_tile::tile_col;
using fp32_tile::tile_row;
using fp32_tile::tile_tx;
using fp32_tile::tile_ty;

constexpr int CAP = 16;          // survivors buffered per query and round
constexpr int BM = 64;           // query rows per list block

// A list block's shared bytes: kernel 1's stage buffers and norms, the
// tile's ids [2][BN], each query row's query and pair index, and per row
// its list (kp pairs), its buffer (CAP pairs) and a count.
size_t list_smem_bytes(int kp) {
  return sizeof(float) * (2 * BD * (BM + 4 + LDX) + BM + 2 * BN) +
         sizeof(int) * (2 * BN + 2 * BM) +
         (size_t)BM * (8 * kp + 8 * CAP + 4);
}

template <bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
rerank_lists_kernel(const float* __restrict__ Q,
                    const float* __restrict__ qsq,
                    const float* __restrict__ X,
                    const float* __restrict__ xsq,
                    const int* __restrict__ row_ids,
                    const unsigned char* __restrict__ row_live,
                    const int* __restrict__ starts,
                    const int* __restrict__ sizes,
                    const int* __restrict__ order,
                    const int* __restrict__ pstart,
                    const int* __restrict__ counts,
                    const int* __restrict__ perm,
                    const int* __restrict__ cum,
                    const int* __restrict__ scan_ptr,
                    float* __restrict__ part_d, int* __restrict__ part_i,
                    int nq, int d, int P, int n_lists, int M, int scan_host,
                    int kp) {
  constexpr int MI = BM / 16;      // query rows per thread
  constexpr int LDQ = BM + 4;
  // which list and which chunk of its queries: the first i with
  // cum[i] > blockIdx.x, in the longest-first order perm
  const int blk = blockIdx.x;
  if (blk >= cum[n_lists - 1]) return;   // past the end: the grid's bound
  int lo = 0, hi = n_lists - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (cum[mid] > blk)
      hi = mid;
    else
      lo = mid + 1;
  }
  const int L = perm[lo];
  const int chunk = blk - (lo ? cum[lo - 1] : 0);
  const int p0 = pstart[L] + chunk * BM;
  const int nrows = min(BM, counts[L] - chunk * BM);
  const int scan = scan_ptr ? max(*scan_ptr, 1) : scan_host;
  const int row_begin = starts[L];
  const int row_end = row_begin + min(min(sizes[L], M), scan);

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);         // [2][BD][LDQ]
  float* xs = qs + 2 * BD * LDQ;                      // [2][BD][LDX]
  float* qn_s = xs + 2 * BD * LDX;                    // [BM]
  float* xn_s = qn_s + BM;                            // [2][BN], tile parity
  int* xid_s = reinterpret_cast<int*>(xn_s + 2 * BN);  // [2][BN]
  int* qrow_s = xid_s + 2 * BN;                       // [BM]
  int* pair_s = qrow_s + BM;                          // [BM]
  float* list_d = reinterpret_cast<float*>(pair_s + BM);      // [BM][kp]
  int* list_i = reinterpret_cast<int*>(list_d + BM * kp);     // [BM][kp]
  float* buf_d = reinterpret_cast<float*>(list_i + BM * kp);  // [BM][CAP]
  int* buf_i = reinterpret_cast<int*>(buf_d + BM * CAP);      // [BM][CAP]
  int* cnt = buf_i + BM * CAP;                                // [BM]

  const int tid = threadIdx.x;
  const int tx = tile_tx(tid), ty = tile_ty(tid);
  const int warp = tid / 32, lane = tid % 32;
  const int lr = tid / 2, lc = (tid % 2) * 4;
  const int chunks = (d + BD - 1) / BD;

  list_init(list_d, list_i, BM * kp, tid, THREADS);
  if (tid < BM) {
    cnt[tid] = 0;
    int qr = nq, pr = -1;
    float qn = 0.0f;
    if (tid < nrows) {
      pr = order[p0 + tid];
      qr = pr / P;
      if (MODE == L2SQ) qn = __ldg(qsq + qr);
    }
    qrow_s[tid] = qr;
    pair_s[tid] = pr;
    qn_s[tid] = qn;
  }
  __syncthreads();
  const int my_q = lr < BM ? qrow_s[lr] : nq;   // nq: a zero row

  int n0 = row_begin;
  float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), xv = qv;
  if (n0 < row_end) {   // chunk 0 of the first tile
    if (lr < BM) {
      qv = load4<VEC>(Q, my_q, nq, lc, d);
      store_kmajor<LDQ>(qs, lr, lc, qv);
    }
    xv = load4<VEC>(X, n0 + lr, row_end, lc, d);
    store_kmajor<LDX>(xs, lr, lc, xv);
  }
  __syncthreads();

  int buf = 0;
  for (int par = 0; n0 < row_end; n0 += BN, par ^= 1) {
    const int next = n0 + BN;
    // this tile's norm and id of column tid, stored after chunk 0: id -1
    // for a dead row or one past the list's end, so that it never enters
    float xn_v = 0.0f;
    int xid_v = -1;
    if (tid < BN && n0 + tid < row_end) {
      const int row = n0 + tid;
      if (MODE == L2SQ) xn_v = __ldg(xsq + row);
      if (row_live == nullptr || row_live[row]) xid_v = __ldg(row_ids + row);
    }

    float acc[MI][8];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int c = 0; c < chunks; ++c) {
      const bool last = c + 1 == chunks;
      const bool more = !last || next < row_end;
      if (more) {   // chunk c + 1 of this tile, or chunk 0 of the next
        const int pn = last ? next : n0;
        const int pc = last ? 0 : (c + 1) * BD;
        if (lr < BM) qv = load4<VEC>(Q, my_q, nq, pc + lc, d);
        xv = load4<VEC>(X, pn + lr, row_end, pc + lc, d);
      }
      fma_chunk<MI, LDQ>(acc, qs + buf * BD * LDQ, xs + buf * BD * LDX, tx,
                         ty);
      if (more) {
        if (lr < BM) store_kmajor<LDQ>(qs + (buf ^ 1) * BD * LDQ, lr, lc, qv);
        store_kmajor<LDX>(xs + (buf ^ 1) * BD * LDX, lr, lc, xv);
      }
      if (c == 0 && tid < BN) {
        xn_s[par * BN + tid] = xn_v;
        xid_s[par * BN + tid] = xid_v;
      }
      __syncthreads();
      buf ^= 1;
    }

    // distances in place of the cross terms; pend marks the outputs that
    // beat their row's k-th pair (bit 8 i + j for acc[i][j])
    const float* xn = xn_s + par * BN;
    const int* xid = xid_s + par * BN;
    unsigned long long pend = 0;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int ql = tile_row(ty, i);
      const float qn = qn_s[ql];
      // a row past the chunk's queries takes nothing: no pair is below
      // (-inf, .)
      const float kd = ql < nrows ? list_d[ql * kp + kp - 1] : -INFINITY;
      const int ki = list_i[ql * kp + kp - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile_col(tx, j);
        acc[i][j] = rerank_epilogue(MODE, acc[i][j], qn, xn[col]);
        if (beats(acc[i][j], xid[col], kd, ki)) pend |= 1ull << (8 * i + j);
      }
    }

    // rounds: push into the buffers, insert, test what is left again
    for (;;) {
      const int any = pend != 0;
      if (any) {
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int ql = tile_row(ty, i);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const unsigned long long bit = 1ull << (8 * i + j);
            if (pend & bit) {
              const int pos = atomicAdd(&cnt[ql], 1);
              if (pos < CAP) {
                buf_d[ql * CAP + pos] = acc[i][j];
                buf_i[ql * CAP + pos] = xid[tile_col(tx, j)];
                pend &= ~bit;
              }
            }
          }
        }
      }
      if (!__syncthreads_or(any)) break;
      // warp w inserts for rows w, w + 8, ...: lane l reads the count of
      // row w + 8 l, and the warp visits the ones with pairs
      const int mine = lane < BM / 8 ? cnt[warp + 8 * lane] : 0;
      for (unsigned todo = __ballot_sync(FULL, mine > 0); todo;
           todo &= todo - 1) {
        const int l = __ffs(todo) - 1;
        const int ql = warp + 8 * l;
        const int c = min(__shfl_sync(FULL, mine, l), CAP);
        for (int p = 0; p < c; ++p)
          warp_insert_unique(list_d + ql * kp, list_i + ql * kp, kp,
                             buf_d[ql * CAP + p], buf_i[ql * CAP + p], lane);
      }
      if (mine > 0) cnt[warp + 8 * lane] = 0;
      // what is still held found its buffer full
      if (!__syncthreads_or(pend != 0)) break;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if ((pend >> (8 * i)) & 0xffull) {
          const int ql = tile_row(ty, i);
          const float kd = list_d[ql * kp + kp - 1];
          const int ki = list_i[ql * kp + kp - 1];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const unsigned long long bit = 1ull << (8 * i + j);
            if ((pend & bit) && !beats(acc[i][j], xid[tile_col(tx, j)], kd,
                                       ki))
              pend &= ~bit;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * kp; e += THREADS) {
    const int r = e / kp;
    if (r < nrows) {
      const size_t o = (size_t)pair_s[r] * kp + (e % kp);
      part_d[o] = list_d[e];
      part_i[o] = list_i[e];
    }
  }
}

// Merge a query's live partial lists ([P] lists of kp pairs; slot p is
// live when p < n_probes) into its kk best distinct ids, by (dist, id).
// One warp per query: lane l keeps the heads of lists l, l + 32, ...; each
// step a butterfly finds the least head (ties to the lower list), the
// winner's list advances, and the pair is written unless its id is out
// already (ids repeat only through an id_map).
constexpr int MERGE_WARPS = 4;

__global__ void __launch_bounds__(32 * MERGE_WARPS)
rerank_merge_kernel(const float* __restrict__ part_d,
                    const int* __restrict__ part_i,
                    const int* __restrict__ nprobes_ptr,
                    float* __restrict__ out_d, int* __restrict__ out_i, int b,
                    int P, int kp, int kk, int np_host) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  if (q >= b) return;              // whole warp; no block barrier below
  float* hd = reinterpret_cast<float*>(smem) + (size_t)warp * (3 * P + kk);
  int* hi = reinterpret_cast<int*>(hd + P);
  int* head = hi + P;
  int* seen = head + P;
  const int live = min(max(nprobes_ptr ? *nprobes_ptr : np_host, 0), P);
  const size_t base = (size_t)q * P * kp;
  for (int l = lane; l < live; l += 32) {
    head[l] = 0;
    hd[l] = part_d[base + (size_t)l * kp];
    hi[l] = part_i[base + (size_t)l * kp];
  }
  __syncwarp();
  int t = 0;
  while (t < kk) {
    float bd = INFINITY;
    int bi = -1, bl = -1;
    for (int l = lane; l < live; l += 32) {
      if (beats(hd[l], hi[l], bd, bi)) {
        bd = hd[l];
        bi = hi[l];
        bl = l;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(FULL, bd, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      const int ol = __shfl_xor_sync(FULL, bl, o);
      if (ol >= 0 && (bl < 0 || pair_less(od, oi, bd, bi) ||
                      (od == bd && oi == bi && ol < bl))) {
        bd = od;
        bi = oi;
        bl = ol;
      }
    }
    if (bl < 0) break;             // every live list is spent
    if (lane == bl % 32) {
      const int h = ++head[bl];
      const bool more = h < kp;
      hd[bl] = more ? part_d[base + (size_t)bl * kp + h] : INFINITY;
      hi[bl] = more ? part_i[base + (size_t)bl * kp + h] : -1;
    }
    bool dup = false;
    for (int u = lane; u < t; u += 32) dup |= seen[u] == bi;
    if (!__any_sync(FULL, dup)) {
      if (lane == 0) {
        out_d[(size_t)q * kk + t] = bd;
        out_i[(size_t)q * kk + t] = bi;
        seen[t] = bi;
      }
      ++t;
    }
    __syncwarp();
  }
  for (int u = t + lane; u < kk; u += 32) {
    out_d[(size_t)q * kk + u] = INFINITY;
    out_i[(size_t)q * kk + u] = -1;
  }
}

size_t merge_smem_bytes(int P, int kk) {
  return sizeof(int) * (size_t)MERGE_WARPS * (3 * (size_t)P + kk);
}

struct ListArgs {
  const float *Q, *qsq, *X, *xsq;
  const int* row_ids;
  const unsigned char* row_live;
  const int *starts, *sizes, *order, *pstart, *counts, *perm, *cum, *scan;
  float* part_d;
  int* part_i;
  int nq, d, P, n_lists, M, scan_host, kp, grid_x;
  cudaStream_t s;
};

template <bool VEC, int MODE>
cudaError_t prepare_lists(int kp, size_t* smem) {
  *smem = list_smem_bytes(kp);
  if (*smem > (size_t)SMEM_BLOCK) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(rerank_lists_kernel<VEC, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <bool VEC, int MODE>
struct ListLaunch {
  static int run(const ListArgs& a) {
    size_t smem = 0;
    cudaError_t e = prepare_lists<VEC, MODE>(a.kp, &smem);
    if (e != cudaSuccess) return (int)e;
    rerank_lists_kernel<VEC, MODE><<<a.grid_x, THREADS, smem, a.s>>>(
        a.Q, a.qsq, a.X, a.xsq, a.row_ids, a.row_live, a.starts, a.sizes,
        a.order, a.pstart, a.counts, a.perm, a.cum, a.scan, a.part_d,
        a.part_i, a.nq, a.d, a.P, a.n_lists, a.M, a.scan_host, a.kp);
    return (int)cudaGetLastError();
  }
};

template <bool VEC, int MODE>
struct ListOccupancy {
  static int run(const ListArgs& a, int* out) {
    size_t smem = 0;
    cudaError_t e = prepare_lists<VEC, MODE>(a.kp, &smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, rerank_lists_kernel<VEC, MODE>, THREADS, smem);
    return (int)e;
  }
};

template <template <bool, int> class F, typename... T>
int dispatch_lists(bool vec, int mode, const ListArgs& a, T... rest) {
  if (vec)
    return mode == L2SQ ? F<true, L2SQ>::run(a, rest...)
                        : F<true, COS>::run(a, rest...);
  return mode == L2SQ ? F<false, L2SQ>::run(a, rest...)
                      : F<false, COS>::run(a, rest...);
}

bool valid_list_shape(int kp, int mode) {
  return kp >= 1 && kp <= MAX_K && (mode == L2SQ || mode == COS);
}

}  // namespace

extern "C" int rerank_dist_launch(const int* rows, const void* Q,
                                  const float* qsq, const int* ids,
                                  const float* pen, const void* X, float* out,
                                  int b, int C, int d, int mode,
                                  void* stream) {
  if (b < 1 || C < 1 || d < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  return dispatch_window<DIST>(rows, Q, qsq, ids, pen, X, out, nullptr, b, C,
                               d, 1, mode,
                               reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int rerank_topk_launch(const int* rows, const void* Q,
                                  const float* qsq, const int* ids,
                                  const float* pen, const void* X,
                                  float* out_d, int* out_i, int b, int C,
                                  int d, int k, int mode, void* stream) {
  if (b < 1 || C < 1 || d < 1 || k < 1 || k > MAX_K || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  return dispatch_window<TOPK>(rows, Q, qsq, ids, pen, X, out_d, out_i, b, C,
                               d, k, mode,
                               reinterpret_cast<cudaStream_t>(stream));
}

// Shared bytes of a list block with partial lists of kp pairs (the
// wrapper's plan computes the same; a CUDA test holds the two equal), -1
// if kp is out of range.
extern "C" long long rerank_lists_smem_bytes(int kp) {
  return valid_list_shape(kp, L2SQ) ? (long long)list_smem_bytes(kp) : -1;
}

// Resident list blocks per SM, from the occupancy calculator.
extern "C" int rerank_lists_blocks_per_sm(int kp, int vec, int mode,
                                          int* out) {
  if (!valid_list_shape(kp, mode)) return (int)cudaErrorInvalidValue;
  ListArgs a = {};
  a.kp = kp;
  return dispatch_lists<ListOccupancy>(vec != 0, mode, a, out);
}

// The list pass: grid_x blocks; part_* are [b, P, kp].
extern "C" int rerank_lists_launch(
    const float* Q, const float* qsq, const float* X, const float* xsq,
    const int* row_ids, const unsigned char* row_live, const int* starts,
    const int* sizes, const int* order, const int* pstart, const int* counts,
    const int* perm, const int* cum, const int* scan, float* part_d,
    int* part_i, int nq, int d, int P, int n_lists, int M, int scan_host,
    int kp, int grid_x, int mode, void* stream) {
  if (nq < 1 || d < 1 || P < 1 || n_lists < 1 || M < 1 || scan_host < 1 ||
      !valid_list_shape(kp, mode) || grid_x < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && (uintptr_t)Q % 16 == 0 &&
                   (uintptr_t)X % 16 == 0;
  const ListArgs a = {Q,      qsq,     X,      xsq,       row_ids, row_live,
                      starts, sizes,   order,  pstart,    counts,  perm,
                      cum,    scan,    part_d, part_i,    nq,      d,
                      P,      n_lists, M,      scan_host, kp,      grid_x,
                      reinterpret_cast<cudaStream_t>(stream)};
  return dispatch_lists<ListLaunch>(vec, mode, a);
}

// The merge pass: [b, P, kp] partial lists -> [b, kk].
extern "C" int rerank_merge_launch(const float* part_d, const int* part_i,
                                   const int* nprobes, float* out_d,
                                   int* out_i, int b, int P, int kp, int kk,
                                   int np_host, void* stream) {
  if (b < 1 || P < 1 || kp < 1 || kk < 1 || kk > MAX_K)
    return (int)cudaErrorInvalidValue;
  const size_t smem = merge_smem_bytes(P, kk);
  if (smem > (size_t)SMEM_BLOCK) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      rerank_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  rerank_merge_kernel<<<(b + MERGE_WARPS - 1) / MERGE_WARPS,
                        32 * MERGE_WARPS, smem, s>>>(
      part_d, part_i, nprobes, out_d, out_i, b, P, kp, kk, np_host);
  return (int)cudaGetLastError();
}
