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
// order, starting from +0.0 (the zero padding of a ragged chunk adds
// fmaf(0, 0, acc) = acc, whatever the chunk width), and the epilogue rounds
// each operation on its own (__fsub_rn / __fmul_rn / __fadd_rn): nvcc would
// otherwise contract qsq - 2 * cross into an FMA.  No split of d, no TF32
// or other tensor-core emulation: each would change bits.
//
// What bounds it on an H100: operations.  At nq = 1,024, n = 10^6, d = 128
// the cross term is 2.6 * 10^11 fp32 operations on the CUDA cores: 3.9 ms at
// 67 TFLOP/s.  The bytes take 1.4 ms at 3.35 TB/s: X (512 MB) read from
// device memory once -- the query tile is the fastest index of the grid, so
// the blocks that share an X tile run together and the rest of its reads
// hit L2 -- Q (0.5 MB) kept in L2, and the 4.1 GB output written once.
//
// Design: the register-blocked SGEMM tile.
//  * 128 x 128 output tiles, 256 threads a block, 8 x 8 outputs a thread as
//    two 4-wide groups per axis, 64 rows / columns apart.  A warp covers 4 x
//    8 threads, so each k step reads its 8 Q and 8 X values as four 16-byte
//    shared loads with broadcast (4 loads per 64 FFMA).
//  * the operands are staged k-major ([BD][128 + 4]) in two shared buffers:
//    while chunk c is multiplied, chunk c + 1 is fetched with 16-byte global
//    loads into registers, then stored transposed into the other buffer, one
//    barrier per chunk.  The pad of 4 words keeps the transposed stores
//    conflict-free and the 16-byte reads aligned.
//  * tiles are numbered query tile fastest (q_tile = t % q_tiles, n_tile =
//    t / q_tiles), and as many blocks as fit on the card at once (2 per SM)
//    walk them with a stride of the grid: the tiles in flight are
//    consecutive, so X comes from device memory about once, and nothing
//    limits n to a grid dimension.  A block's chunks form one stream across
//    its tiles -- the last chunk of a tile prefetches the first of the next
//    -- so no tile starts on a cold load.  Launches are sliced over queries
//    only where the tiles would pass 2^31 - 1.
//  * the epilogue takes the tile's qsq and xsq from shared memory (fetched
//    during the tile's first chunk, double-buffered by the tile's parity),
//    and the mode is a template argument: no global load and no branch on
//    the way out.  The output, written once, goes out as one 16-byte
//    streaming store (__stcs) per thread and 4 columns where ldo % 4 == 0
//    and the 4 columns exist, else as scalar stores.
//  * ragged edges (rows, and d not a multiple of 4 or of the chunk) are
//    masked in-kernel with zeros: Q and X are never padded or copied.  Rows
//    with d % 4 != 0 or unaligned bases take scalar loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // queries per tile
constexpr int BN = 128;        // corpus rows per tile
constexpr int BD = 8;          // contraction chunk
constexpr int LDS = BM + 4;    // padded k-major row of a stage buffer
constexpr int THREADS = 256;   // 16 x 16, 8 x 8 outputs each

enum Mode { L2SQ = 0, IP = 1, COS = 2 };

template <int MODE>
__device__ __forceinline__ float epilogue(float cross, float qn, float xn) {
  if (MODE == L2SQ)
    return fmaxf(__fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, cross)), xn), 0.0f);
  if (MODE == IP) return __fadd_rn(-cross, xn);
  return __fadd_rn(__fsub_rn(1.0f, cross), xn);
}

// Columns [col, col + 4) of row `row` of the row-major [rows, d] matrix A,
// zeros outside it.  VEC: d % 4 == 0 and A 16-byte aligned, so the four
// columns lie wholly inside or wholly outside the row.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ A, int row,
                                        int rows, int col, int d) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= rows) return v;
  const float* p = A + (size_t)row * d + col;
  if (VEC) {
    if (col < d) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (col < d) v.x = __ldg(p);
    if (col + 1 < d) v.y = __ldg(p + 1);
    if (col + 2 < d) v.z = __ldg(p + 2);
    if (col + 3 < d) v.w = __ldg(p + 3);
  }
  return v;
}

// Store row `row`'s four columns [c, c + 4) k-major: s[c + j][row].
__device__ __forceinline__ void store_kmajor(float* s, int row, int c,
                                             float4 v) {
  s[(c + 0) * LDS + row] = v.x;
  s[(c + 1) * LDS + row] = v.y;
  s[(c + 2) * LDS + row] = v.z;
  s[(c + 3) * LDS + row] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Tiles are numbered query tile fastest (q_tile = t % q_tiles, n_tile = t /
// q_tiles); block b takes tiles b, b + gridDim.x, ...  The chunks of its
// tiles form one stream: the last chunk of a tile prefetches the first of
// the next, so no tile starts on a cold load.
template <bool VEC, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
distance_matrix_kernel(const float* __restrict__ Q,
                       const float* __restrict__ X,
                       const float* __restrict__ qsq,
                       const float* __restrict__ xsq, float* __restrict__ out,
                       int nq, int n, int d, long long ldo, unsigned q_tiles,
                       unsigned tiles, int vec_out) {
  __shared__ __align__(16) float qs[2][BD * LDS];
  __shared__ __align__(16) float xs[2][BD * LDS];
  // a tile's qsq (128 rows) then xsq (128 columns), by the tile's parity
  __shared__ __align__(16) float norms[2][BM + BN];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // warps 2 (corpus) x 4 (queries), each 8 x 4 threads
  const int tx = (warp % 2) * 8 + lane % 8;   // columns 4tx.., 64 + 4tx..
  const int ty = (warp / 2) * 4 + lane / 8;   // rows 4ty.., 64 + 4ty..
  // staging: thread t fetches columns [lc, lc + 4) of tile row lr
  const int lr = tid / 2, lc = (tid % 2) * 4;
  const int chunks = (d + BD - 1) / BD;

  unsigned tile = blockIdx.x;
  int q0 = (int)(tile % q_tiles) * BM;
  int n0 = (int)(tile / q_tiles) * BN;
  float4 qv = load4<VEC>(Q, q0 + lr, nq, lc, d);
  float4 xv = load4<VEC>(X, n0 + lr, n, lc, d);
  store_kmajor(qs[0], lr, lc, qv);
  store_kmajor(xs[0], lr, lc, xv);
  __syncthreads();

  int buf = 0;
  for (int par = 0; tile < tiles; tile += gridDim.x, par ^= 1) {
    const unsigned next = tile + gridDim.x;
    const unsigned nt = next < tiles ? next : tile;
    const int next_q0 = (int)(nt % q_tiles) * BM;
    const int next_n0 = (int)(nt / q_tiles) * BN;
    // this tile's norm entry of thread t, stored after chunk 0
    const int nr = tid < BM ? q0 + tid : n0 + tid - BM;
    const float nv = tid < BM ? (nr < nq ? __ldg(qsq + nr) : 0.0f)
                              : (nr < n ? __ldg(xsq + nr) : 0.0f);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int c = 0; c < chunks; ++c) {
      const bool last = c + 1 == chunks;
      const bool more = !last || next < tiles;
      if (more) {   // chunk c + 1 of this tile, or chunk 0 of the next
        const int pq = last ? next_q0 : q0, pn = last ? next_n0 : n0;
        const int pc = last ? 0 : (c + 1) * BD;
        qv = load4<VEC>(Q, pq + lr, nq, pc + lc, d);
        xv = load4<VEC>(X, pn + lr, n, pc + lc, d);
      }
      const float* qb = qs[buf];
      const float* xb = xs[buf];
#pragma unroll
      for (int kk = 0; kk < BD; ++kk) {
        const float4 a0 = ld4(qb + kk * LDS + 4 * ty);
        const float4 a1 = ld4(qb + kk * LDS + 64 + 4 * ty);
        const float4 b0 = ld4(xb + kk * LDS + 4 * tx);
        const float4 b1 = ld4(xb + kk * LDS + 64 + 4 * tx);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      // the other buffers were last read before the previous barrier
      if (more) {
        store_kmajor(qs[buf ^ 1], lr, lc, qv);
        store_kmajor(xs[buf ^ 1], lr, lc, xv);
      }
      if (c == 0) norms[par][tid] = nv;
      __syncthreads();
      buf ^= 1;
    }

    const float* nb = norms[par];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float4 q4 = ld4(nb + g * 64 + 4 * ty);
      const float qn[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const int i = 4 * g + i4;
        const int qrow = q0 + g * 64 + 4 * ty + i4;
        if (qrow >= nq) continue;
        float* orow = out + (size_t)qrow * ldo;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + h * 64 + 4 * tx;
          const float4 x4 = ld4(nb + BM + h * 64 + 4 * tx);
          const float4 v = make_float4(
              epilogue<MODE>(acc[i][4 * h + 0], qn[i4], x4.x),
              epilogue<MODE>(acc[i][4 * h + 1], qn[i4], x4.y),
              epilogue<MODE>(acc[i][4 * h + 2], qn[i4], x4.z),
              epilogue<MODE>(acc[i][4 * h + 3], qn[i4], x4.w));
          if (vec_out && col + 3 < n) {
            __stcs(reinterpret_cast<float4*>(orow + col), v);
          } else {
            if (col < n) orow[col] = v.x;
            if (col + 1 < n) orow[col + 1] = v.y;
            if (col + 2 < n) orow[col + 2] = v.z;
            if (col + 3 < n) orow[col + 3] = v.w;
          }
        }
      }
    }
    q0 = next_q0;
    n0 = next_n0;
  }
}

template <bool VEC, int MODE>
int launch(const float* Q, const float* X, const float* qsq, const float* xsq,
           float* out, int nq, int n, int d, long long ldo, int vec_out,
           cudaStream_t s) {
  auto kernel = distance_matrix_kernel<VEC, MODE>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  // tile numbers stay below 2^31 (so tile + gridDim.x fits 32 bits): slice
  // the queries only where the tiles would pass that
  const long long n_tiles = (n + BN - 1) / BN;
  const long long max_q_tiles = 2147483647LL / n_tiles;
  const long long slice = (max_q_tiles < 1 ? 1 : max_q_tiles) * BM;
  for (long long q0 = 0; q0 < nq; q0 += slice) {
    const int rows = (int)(nq - q0 < slice ? nq - q0 : slice);
    const long long q_tiles = (rows + BM - 1) / BM;
    const long long tiles = q_tiles * n_tiles;
    const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
    kernel<<<grid, THREADS, 0, s>>>(Q + (size_t)q0 * d, X, qsq + q0, xsq,
                                     out + (size_t)q0 * ldo, rows, n, d, ldo,
                                     (unsigned)q_tiles, (unsigned)tiles,
                                     vec_out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

template <bool VEC>
int launch_mode(int mode, const float* Q, const float* X, const float* qsq,
                const float* xsq, float* out, int nq, int n, int d,
                long long ldo, int vec_out, cudaStream_t s) {
  if (mode == L2SQ)
    return launch<VEC, L2SQ>(Q, X, qsq, xsq, out, nq, n, d, ldo, vec_out, s);
  if (mode == IP)
    return launch<VEC, IP>(Q, X, qsq, xsq, out, nq, n, d, ldo, vec_out, s);
  return launch<VEC, COS>(Q, X, qsq, xsq, out, nq, n, d, ldo, vec_out, s);
}

}  // namespace

extern "C" int distance_matrix_launch(const float* Q, const float* X,
                                      const float* qsq, const float* xsq,
                                      float* out, int nq, int n, int d,
                                      long long ldo, int mode, void* stream) {
  if (nq < 1 || n < 1 || d < 1 || ldo < n || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && (uintptr_t)Q % 16 == 0 &&
                   (uintptr_t)X % 16 == 0;
  const int vec_out = ldo % 4 == 0 && (uintptr_t)out % 16 == 0;
  if (vec)
    return launch_mode<true>(mode, Q, X, qsq, xsq, out, nq, n, d, ldo,
                             vec_out, s);
  return launch_mode<false>(mode, Q, X, qsq, xsq, out, nq, n, d, ldo,
                            vec_out, s);
}
