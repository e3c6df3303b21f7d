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
// the smaller id, (+inf, -1) where fewer than k finite candidates exist,
// for 1 <= k <= 256.  xsq carries the squared norms (l2sq) or an additive
// 0/+inf penalty (ip, cos); a +inf entry masks its row in every mode.  The
// [nq, n] distance matrix never reaches device memory.
//
// What bounds it on an H100: operations.  The cross term is 2*nq*n*d fp32
// operations on the CUDA cores (TF32 tensor cores would break the
// reference's fp32 contract): at nq = 10^4, n = 10^6, d = 128, 2.56 TFLOP
// against 67 TFLOP/s (SXM data sheet), ~38 ms, far above the 0.5 GB /
// 3.35 TB/s ~ 0.15 ms it takes to read X once.  What holds it (H100 80GB
// HBM3 at 700 W, PERF.md, PR 18): 75.5 ms there at k = 10, 51 % of the
// peak against kernel 5's 59 %.  The FFMA loop is kernel 5's; the rest is
// the selection after each tile: 64 epilogues and tests per thread, and
// two barriers where the block has survivors.
// At large k the inserts weigh more: a corpus range inserts about
// k (1 + ln(m / k)) pairs per query over its m rows, so the plan cuts the
// corpus into few ranges there (k = 100: 44 ms at nq = 4,096).
//
// Design:
//  * the cross term is kernel 5's tile (fp32_tile.cuh): 128 corpus rows by
//    BM query rows, 256 threads, each with 8 corpus rows and BM / 16 query
//    rows in registers, 16-byte shared loads with broadcast, operands staged
//    k-major in double buffers, one barrier per 8-wide chunk; 16-byte
//    global loads where d % 4 == 0 and the bases are aligned, scalar
//    masked loads otherwise.  Its arithmetic is kernel 5's, so the k > 256
//    route through kernel 5 gives these distances bit for bit.
//  * a block owns one query tile and one contiguous range of corpus rows
//    (grid.y: the splits), and walks the range tile by tile; the chunks of
//    its tiles form one stream (the last chunk of a tile prefetches the
//    first of the next).  grid.x is the query tile, so the blocks in flight
//    walk the same ranges and X comes mostly from L2.  A second kernel
//    (merge_splits_kernel) merges the per-split lists by (dist, id).  The
//    split count is the wrapper's (distance_topk.py::launch_plan: waves of
//    resident blocks, from the occupancy calculator, against inserts).
//  * BM is a template argument: 128 query rows where two blocks of that
//    size fit an SM's shared memory at this k, 64 otherwise (the wrapper's
//    plan, distance_topk.py::launch_plan): a block's lists take BM * k * 8
//    bytes, 262,144 at BM = 128 and k = 256, more than a block can have.
//  * selection keeps the tile's distances in the registers that held the
//    cross terms.  Each thread tests its outputs against its rows' k-th
//    (dist, id) pair and pushes the ones that beat it into a per-query
//    buffer of CAP pairs in shared memory; then one warp per query inserts
//    the buffer into that query's sorted list (warp_insert: a ballot finds
//    the place, the lanes move the entries above it, so no lane walks the
//    list).  An output that found its buffer full stays in registers:
//    after the insert it is tested again against the new k-th, and the
//    rounds go on until no thread holds one.  Nothing is computed twice,
//    and the result is the exact k smallest by (dist, id) whatever the
//    order of the atomics and the rounds.  A tile with no survivor in the
//    block costs one __syncthreads_or, one whose survivors fit their
//    buffers two.
//  * ragged edges (nq, n, d not multiples of the tiles) are masked
//    in-kernel: Q and X are never padded or copied.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_tile.cuh"
#include "topk_list.cuh"

namespace {

using namespace fp32_tile;
using namespace repro_topk;

constexpr int CAP = 16;          // survivors buffered per query and round
constexpr int MAX_K = 256;
constexpr int SMEM_BLOCK = 232448;   // shared memory a block may have

// A block's shared bytes: the stage buffers ([2][BD][bm + 4] and
// [2][BD][BN + 4]), the query norms [bm] and the corpus norms [2][BN], and
// per query row its list (k pairs), its buffer (CAP pairs) and a count.
size_t smem_bytes(int bm, int k) {
  return sizeof(float) * (2 * BD * (bm + 4 + LDX) + bm + 2 * BN) +
         (size_t)bm * (8 * k + 8 * CAP + 4);
}

// One warp inserts (d, id) into a sorted list of k <= MAX_K pairs if it
// beats the k-th: lane l holds slots l, l + 32, ...; the place is the count
// of entries before (d, id) (a ballot per 32 slots), and the entries from
// there on move up one slot, the top 32 first, so that each is read before
// the lane below overwrites it.
__device__ __forceinline__ void warp_insert(float* ld, int* li, int k,
                                            float d, int id, int lane) {
  if (!beats(d, id, ld[k - 1], li[k - 1])) return;   // the same in every lane
  int pos = 0;
#pragma unroll
  for (int r = 0; r < MAX_K / 32; ++r) {
    if (32 * r >= k) break;
    const int s = 32 * r + lane;
    const bool before = s < k && pair_less(ld[s], li[s], d, id);
    pos += __popc(__ballot_sync(0xffffffffu, before));
  }
#pragma unroll
  for (int r = MAX_K / 32 - 1; r >= 0; --r) {
    if (32 * r >= k || 32 * r + 31 <= pos) continue;
    const int s = 32 * r + lane;
    const bool move = s > pos && s < k;
    float dv = 0.0f;
    int iv = 0;
    if (move) {
      dv = ld[s - 1];
      iv = li[s - 1];
    }
    __syncwarp();
    if (move) {
      ld[s] = dv;
      li[s] = iv;
    }
  }
  __syncwarp();
  if (lane == 0) {
    ld[pos] = d;
    li[pos] = id;
  }
  __syncwarp();
}

template <int BM, bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
stream_topk_kernel(const float* __restrict__ Q, const float* __restrict__ X,
                   const float* __restrict__ qsq,
                   const float* __restrict__ xsq, float* __restrict__ part_d,
                   int* __restrict__ part_i, int nq, int n, int d, int k,
                   int rows_per_split) {
  constexpr int MI = BM / 16;      // query rows per thread
  constexpr int LDQ = BM + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);         // [2][BD][LDQ]
  float* xs = qs + 2 * BD * LDQ;                      // [2][BD][LDX]
  float* qn_s = xs + 2 * BD * LDX;                    // [BM]
  float* xn_s = qn_s + BM;                            // [2][BN], tile parity
  float* list_d = xn_s + 2 * BN;                      // [BM][k]
  int* list_i = reinterpret_cast<int*>(list_d + BM * k);      // [BM][k]
  float* buf_d = reinterpret_cast<float*>(list_i + BM * k);   // [BM][CAP]
  int* buf_i = reinterpret_cast<int*>(buf_d + BM * CAP);      // [BM][CAP]
  int* cnt = buf_i + BM * CAP;                                // [BM]

  const int tid = threadIdx.x;
  const int tx = tile_tx(tid), ty = tile_ty(tid);
  const int warp = tid / 32, lane = tid % 32;
  // staging: thread t fetches columns [lc, lc + 4) of tile row lr
  const int lr = tid / 2, lc = (tid % 2) * 4;
  const int chunks = (d + BD - 1) / BD;
  const int q0 = blockIdx.x * BM;
  const long long begin = (long long)blockIdx.y * rows_per_split;
  const int row_begin = (int)(begin < n ? begin : n);
  const int row_end =
      (int)(begin + rows_per_split < n ? begin + rows_per_split : n);

  list_init(list_d, list_i, BM * k, tid, THREADS);
  if (tid < BM) {
    cnt[tid] = 0;
    qn_s[tid] = q0 + tid < nq ? __ldg(qsq + q0 + tid) : 0.0f;
  }

  int n0 = row_begin;
  float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), xv = qv;
  if (n0 < row_end) {   // chunk 0 of the first tile
    if (lr < BM) {
      qv = load4<VEC>(Q, q0 + lr, nq, lc, d);
      store_kmajor<LDQ>(qs, lr, lc, qv);
    }
    xv = load4<VEC>(X, n0 + lr, row_end, lc, d);
    store_kmajor<LDX>(xs, lr, lc, xv);
  }
  __syncthreads();

  int buf = 0;
  for (int par = 0; n0 < row_end; n0 += BN, par ^= 1) {
    const int next = n0 + BN;
    // this tile's corpus norm of thread t, stored after chunk 0; +inf past
    // the range, so that no distance there beats a k-th pair
    const float xn_v = tid >= BN ? 0.0f
                       : n0 + tid < row_end ? __ldg(xsq + n0 + tid)
                                            : INFINITY;

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
        if (lr < BM) qv = load4<VEC>(Q, q0 + lr, nq, pc + lc, d);
        xv = load4<VEC>(X, pn + lr, row_end, pc + lc, d);
      }
      fma_chunk<MI, LDQ>(acc, qs + buf * BD * LDQ, xs + buf * BD * LDX, tx,
                         ty);
      // the other buffers were last read before the previous barrier
      if (more) {
        if (lr < BM) store_kmajor<LDQ>(qs + (buf ^ 1) * BD * LDQ, lr, lc, qv);
        store_kmajor<LDX>(xs + (buf ^ 1) * BD * LDX, lr, lc, xv);
      }
      if (c == 0 && tid < BN) xn_s[par * BN + tid] = xn_v;
      __syncthreads();
      buf ^= 1;
    }

    // distances in place of the cross terms; pend marks the outputs that
    // beat their row's k-th pair (bit 8 i + j for acc[i][j])
    const float* xn = xn_s + par * BN;
    unsigned long long pend = 0;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int ql = tile_row(ty, i);
      const float qn = qn_s[ql];
      // a query row past nq takes nothing: no distance is below -inf.  A
      // row id is never negative, and a distance that beats a list's k-th
      // pair is finite, so pair_less is beats here.
      const float kd = q0 + ql < nq ? list_d[ql * k + k - 1] : -INFINITY;
      const int ki = list_i[ql * k + k - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile_col(tx, j);
        acc[i][j] = epilogue<MODE>(acc[i][j], qn, xn[col]);
        if (pair_less(acc[i][j], n0 + col, kd, ki))
          pend |= 1ull << (8 * i + j);
      }
    }

    // rounds: push into the buffers, insert, test what is left again.  A
    // tile whose survivors all fit their buffers takes two barriers, one
    // without survivors one.
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
                buf_i[ql * CAP + pos] = n0 + tile_col(tx, j);
                pend &= ~bit;
              }
            }
          }
        }
      }
      if (!__syncthreads_or(any)) break;
      // warp w inserts for queries w, w + 8, ...: lane l reads the count
      // of query w + 8 l, and the warp visits the ones with pairs
      const int mine = lane < BM / 8 ? cnt[warp + 8 * lane] : 0;
      for (unsigned todo = __ballot_sync(0xffffffffu, mine > 0); todo;
           todo &= todo - 1) {
        const int l = __ffs(todo) - 1;
        const int ql = warp + 8 * l;
        const int c = min(__shfl_sync(0xffffffffu, mine, l), CAP);
        for (int p = 0; p < c; ++p)
          warp_insert(list_d + ql * k, list_i + ql * k, k,
                      buf_d[ql * CAP + p], buf_i[ql * CAP + p], lane);
      }
      if (mine > 0) cnt[warp + 8 * lane] = 0;
      // what is still held found its buffer full
      if (!__syncthreads_or(pend != 0)) break;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if ((pend >> (8 * i)) & 0xffull) {
          const int ql = tile_row(ty, i);
          const float kd = list_d[ql * k + k - 1];
          const int ki = list_i[ql * k + k - 1];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const unsigned long long bit = 1ull << (8 * i + j);
            if ((pend & bit) && !beats(acc[i][j], n0 + tile_col(tx, j), kd, ki))
              pend &= ~bit;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * k; e += THREADS) {
    const int qrow = q0 + e / k;
    if (qrow < nq) {
      const size_t o = ((size_t)blockIdx.y * nq + qrow) * k + (e % k);
      part_d[o] = list_d[e];
      part_i[o] = list_i[e];
    }
  }
}

template <int BM, bool VEC, int MODE>
cudaError_t prepare(int k, size_t* smem) {
  *smem = smem_bytes(BM, k);
  if (*smem > (size_t)SMEM_BLOCK) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(stream_topk_kernel<BM, VEC, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

struct Args {
  const float *Q, *X, *qsq, *xsq;
  float* part_d;
  int* part_i;
  int nq, n, d, k, n_splits, rows_per_split;
  cudaStream_t s;
};

template <int BM, bool VEC, int MODE>
int launch(const Args& a) {
  size_t smem = 0;
  cudaError_t e = prepare<BM, VEC, MODE>(a.k, &smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.nq + BM - 1) / BM, a.n_splits);
  stream_topk_kernel<BM, VEC, MODE><<<grid, THREADS, smem, a.s>>>(
      a.Q, a.X, a.qsq, a.xsq, a.part_d, a.part_i, a.nq, a.n, a.d, a.k,
      a.rows_per_split);
  return (int)cudaGetLastError();
}

template <int BM, bool VEC, int MODE>
int blocks_per_sm(const Args& a, int* out) {
  size_t smem = 0;
  cudaError_t e = prepare<BM, VEC, MODE>(a.k, &smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, stream_topk_kernel<BM, VEC, MODE>, THREADS, smem);
  return (int)e;
}

// Runs F<BM, VEC, MODE>(a, out...) for the run-time variant.
template <template <int, bool, int> class F, typename... T>
int dispatch(int bm, bool vec, int mode, const Args& a, T... rest) {
  if (bm == 128) {
    if (vec) {
      if (mode == L2SQ) return F<128, true, L2SQ>::run(a, rest...);
      if (mode == IP) return F<128, true, IP>::run(a, rest...);
      return F<128, true, COS>::run(a, rest...);
    }
    if (mode == L2SQ) return F<128, false, L2SQ>::run(a, rest...);
    if (mode == IP) return F<128, false, IP>::run(a, rest...);
    return F<128, false, COS>::run(a, rest...);
  }
  if (vec) {
    if (mode == L2SQ) return F<64, true, L2SQ>::run(a, rest...);
    if (mode == IP) return F<64, true, IP>::run(a, rest...);
    return F<64, true, COS>::run(a, rest...);
  }
  if (mode == L2SQ) return F<64, false, L2SQ>::run(a, rest...);
  if (mode == IP) return F<64, false, IP>::run(a, rest...);
  return F<64, false, COS>::run(a, rest...);
}

template <int BM, bool VEC, int MODE>
struct Launch {
  static int run(const Args& a) { return launch<BM, VEC, MODE>(a); }
};

template <int BM, bool VEC, int MODE>
struct Occupancy {
  static int run(const Args& a, int* out) {
    return blocks_per_sm<BM, VEC, MODE>(a, out);
  }
};

bool valid_shape(int bm, int k) {
  return (bm == 64 || bm == 128) && k >= 1 && k <= MAX_K;
}

}  // namespace

// Shared bytes a block of `bm` query rows takes at this k (the wrapper's
// plan computes the same; a CUDA test holds the two equal), -1 if the
// variant does not exist.
extern "C" long long stream_topk_smem_bytes(int bm, int k) {
  return valid_shape(bm, k) ? (long long)smem_bytes(bm, k) : -1;
}

// Resident blocks per SM of the variant (bm query rows; vec: 16-byte loads;
// mode) at this k, from the occupancy calculator (registers, shared memory,
// threads).
extern "C" int stream_topk_blocks_per_sm(int bm, int k, int vec, int mode,
                                         int* out) {
  if (!valid_shape(bm, k) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.k = k;
  return dispatch<Occupancy>(bm, vec != 0, mode, a, out);
}

extern "C" int stream_topk_launch(const float* Q, const float* X,
                                  const float* qsq, const float* xsq,
                                  float* part_d, int* part_i, float* out_d,
                                  int* out_i, int nq, int n, int d, int k,
                                  int mode, int bm, int n_splits,
                                  int rows_per_split, void* stream) {
  if (nq < 1 || n < 1 || d < 1 || !valid_shape(bm, k) || n_splits < 1 ||
      n_splits > MAX_SPLITS || mode < 0 || mode > 2 || rows_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && (uintptr_t)Q % 16 == 0 &&
                   (uintptr_t)X % 16 == 0;
  const Args a = {Q, X, qsq, xsq, part_d, part_i, nq, n, d, k, n_splits,
                  rows_per_split, s};
  const int status = dispatch<Launch>(bm, vec, mode, a);
  if (status != (int)cudaSuccess) return status;
  merge_splits_kernel<<<(nq + 127) / 128, 128, 0, s>>>(part_d, part_i, out_d,
                                                       out_i, nq, k, n_splits);
  return (int)cudaGetLastError();
}
