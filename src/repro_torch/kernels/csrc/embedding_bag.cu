// Embedding-bag gather-reduce for Hopper (sm_90a).
//
// Replaces: repro/kernels/embedbag/embedbag.py::embedding_bag_pallas (with
// _embedbag_kernel).
//
// What it computes: lookups i (sorted by bag by the wrapper) name a table
// row indices[i] and a weight weights[i].  Each bag b owns the span
// [span_start[b], span_end[b]) of the lookups of its last run (the Pallas
// kernel re-initialises a bag's row at each new run, so with
// assume_sorted=True and unsorted bags the last run wins); an empty bag
// has start == end.  The kernel writes every row of out once:
//   out[b] = row_0 * w_0;  out[b] += row_i * w_i  (i in lookup order)
// with row_i = table[indices[i]] read as float32, the multiply and the add
// rounded separately (__fmul_rn / __fadd_rn: no FMA contraction) and the
// running value rounded to the table's type after every step, as the
// Pallas kernel stores its output block in the table's type; out[b] = 0
// for an empty bag.  So the plain version's sequential sum matches bit for
// bit.
//
// What bounds it on an H100: bytes.  Each lookup reads one D-wide row
// (512 B at D = 128 fp32) and its index and weight; each bag writes one
// row.  At N = 524,288 lookups, B = 65,536 bags, D = 128: ~308 MB, 0.09 ms
// at 3.35 TB/s; the operations (2 N D) are negligible.  Rows are scattered
// over a 20 GB table, so the rate rests on how many row loads are in
// flight: bytes in flight over the gather's latency.
//
// Design (the adds of a bag stay in lookup order, so the gain must come
// from rows in flight, not from a tree sum):
//  * A group of L lanes owns a row: lane l takes the 16-byte (8-, 4- or
//    2-byte, as the row's size and the table's alignment allow: VB) vectors
//    l, l + L, ... (CPL of them; wider rows take more passes), read with
//    ld.global.nc.L1::no_allocate (a row is read once).  A 512-byte fp32
//    row is one request of a warp; a 256-byte bf16 row one of 16 lanes, so
//    a warp carries two groups.
//  * A group walks the lookups of a range of consecutive bags as one
//    stream (bags_per_group of them, from the plan), resetting at each
//    bag's first lookup and storing at its last, and writing zeros for an
//    empty bag as it passes.  The stream runs in batches of U lookups:
//    the U rows of a batch are loaded together (U independent loads in
//    flight per lane), the next batch's indices and weights are loaded
//    while they fly, and then the U rows are added in order.  A batch
//    crosses bag boundaries, so one-hot bags keep U rows in flight as
//    100-lookup bags do.
//  * A block (256 threads) stages the spans of its bags in shared memory,
//    so finding the next lookup costs no global load on the stream's path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int VB>
struct Raw {
  uint32_t w[VB / 4];
};
template <>
struct Raw<2> {
  uint16_t h;
};

__device__ __forceinline__ void load_nc(Raw<16>& r, const void* p) {
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
      : "l"(p));
}
__device__ __forceinline__ void load_nc(Raw<8>& r, const void* p) {
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
      : "=r"(r.w[0]), "=r"(r.w[1])
      : "l"(p));
}
__device__ __forceinline__ void load_nc(Raw<4>& r, const void* p) {
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r.w[0]) : "l"(p));
}
__device__ __forceinline__ void load_nc(Raw<2>& r, const void* p) {
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(r.h) : "l"(p));
}

// Element i of a vector, as float32.
template <typename T, int VB>
__device__ __forceinline__ float element(const Raw<VB>& r, int i);
template <>
__device__ __forceinline__ float element<float, 16>(const Raw<16>& r, int i) {
  return __uint_as_float(r.w[i]);
}
template <>
__device__ __forceinline__ float element<float, 8>(const Raw<8>& r, int i) {
  return __uint_as_float(r.w[i]);
}
template <>
__device__ __forceinline__ float element<float, 4>(const Raw<4>& r, int i) {
  return __uint_as_float(r.w[i]);
}
template <int VB>
__device__ __forceinline__ float bf16_element(const Raw<VB>& r, int i) {
  const uint32_t w = r.w[i / 2];
  return __uint_as_float(i % 2 == 0 ? w << 16 : w & 0xffff0000u);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16, 16>(const Raw<16>& r,
                                                            int i) {
  return bf16_element<16>(r, i);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16, 8>(const Raw<8>& r,
                                                           int i) {
  return bf16_element<8>(r, i);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16, 4>(const Raw<4>& r,
                                                           int i) {
  return bf16_element<4>(r, i);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16, 2>(const Raw<2>& r,
                                                           int) {
  return __uint_as_float(static_cast<uint32_t>(r.h) << 16);
}

// The bits of a float32 in the table's type (exact for a value that
// round_to<T> has already rounded).
template <typename T>
__device__ __forceinline__ uint32_t bits_of(float v);
template <>
__device__ __forceinline__ uint32_t bits_of<float>(float v) {
  return __float_as_uint(v);
}
template <>
__device__ __forceinline__ uint32_t bits_of<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
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

// Store the W = VB / 4 words (a 2-byte vector: one half-word) of a vector.
template <int VB>
__device__ __forceinline__ void store_words(char* p, const uint32_t* w) {
  if constexpr (VB == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (VB == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else if constexpr (VB == 4)
    *reinterpret_cast<uint32_t*>(p) = w[0];
  else
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
}

// Store E = VB / sizeof(T) values as one vector in the table's type.
template <typename T, int VB>
__device__ __forceinline__ void store_vec(char* p,
                                          const float (&v)[VB / sizeof(T)]) {
  constexpr int W = VB < 4 ? 1 : VB / 4;
  uint32_t w[W];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = bits_of<T>(v[j]);
  } else if constexpr (VB == 2) {
    w[0] = bits_of<T>(v[0]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      w[j] = bits_of<T>(v[2 * j]) | (bits_of<T>(v[2 * j + 1]) << 16);
  }
  store_words<VB>(p, w);
}

template <int VB>
__device__ __forceinline__ void store_zero(char* p) {
  constexpr int W = VB < 4 ? 1 : VB / 4;
  uint32_t w[W];
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = 0u;
  store_words<VB>(p, w);
}

// One (T, VB, CPL, U) variant.  The launch has grid blocks of THREADS
// threads; a block owns block_bags = (THREADS / 32) * (32 / L) *
// bags_per_group consecutive bags, group g of it the bags_per_group from
// g * bags_per_group.  Lanes 32 - 32 % L .. 31 of a warp idle.
template <typename T, int VB, int CPL, int U>
__global__ void __launch_bounds__(THREADS, 1)
embedding_bag_stream(const int* __restrict__ indices,
                     const float* __restrict__ weights,
                     const T* __restrict__ table,
                     const int* __restrict__ span_start,
                     const int* __restrict__ span_end, T* __restrict__ out,
                     int n_bags, int D, int L, int bags_per_group) {
  constexpr int E = VB / (int)sizeof(T);
  extern __shared__ int spans[];
  const int per_warp = 32 / L;
  const int block_bags = (THREADS / 32) * per_warp * bags_per_group;
  const int B0 = blockIdx.x * block_bags;
  const int nb = min(block_bags, n_bags - B0);
  int* s_sm = spans;
  int* e_sm = spans + block_bags;
  for (int i = threadIdx.x; i < nb; i += THREADS) {
    s_sm[i] = __ldg(span_start + B0 + i);
    e_sm[i] = __ldg(span_end + B0 + i);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, sub = lane / L;
  if (sub >= per_warp) return;
  const int l = lane % L;
  const int lb0 = ((threadIdx.x / 32) * per_warp + sub) * bags_per_group;
  const int lb1 = min(lb0 + bags_per_group, nb);
  if (lb0 >= lb1) return;
  const size_t row_bytes = (size_t)D * sizeof(T);
  const int NV = (int)(row_bytes / VB);
  const char* tab = reinterpret_cast<const char*>(table);
  char* obase = reinterpret_cast<char*>(out) + (size_t)B0 * row_bytes;

  for (int v0 = 0; v0 < NV; v0 += L * CPL) {   // one pass for NV <= L * CPL
    int cb = lb0 - 1, p = 0, e = 0;
    bool fresh = false;
    // The next lookup of the stream: meta = local bag << 2 | first << 1 |
    // last, or -1 past the group's last lookup; empty bags on the way get
    // their zeros here.
    auto next = [&](int& meta, int& idx, float& w) {
      while (p == e && cb + 1 < lb1) {
        ++cb;
        p = s_sm[cb];
        e = e_sm[cb];
        fresh = true;
        if (p == e) {
          char* o = obase + (size_t)cb * row_bytes;
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            const int v = v0 + l + L * t;
            if (v < NV) store_zero<VB>(o + (size_t)v * VB);
          }
        }
      }
      if (p < e) {
        meta = (cb << 2) | (fresh ? 2 : 0) | (p + 1 == e ? 1 : 0);
        idx = __ldg(indices + p);
        w = __ldg(weights + p);
        ++p;
        fresh = false;
      } else {
        meta = -1;
        idx = 0;
        w = 0.0f;
      }
    };
    int meta[U], nidx[U];
    float nw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) next(meta[u], nidx[u], nw[u]);
    float acc[CPL][E];
#pragma unroll
    for (int t = 0; t < CPL; ++t)
#pragma unroll
      for (int i = 0; i < E; ++i) acc[t][i] = 0.0f;
    while (meta[0] >= 0) {
      Raw<VB> rows[U][CPL];
      int cm[U];
      float cw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cm[u] = meta[u];
        cw[u] = nw[u];
        if (cm[u] >= 0) {
          const char* r = tab + (size_t)nidx[u] * row_bytes;
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            const int v = v0 + l + L * t;
            if (v < NV) load_nc(rows[u][t], r + (size_t)v * VB);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) next(meta[u], nidx[u], nw[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (cm[u] < 0) continue;
        const bool first = cm[u] & 2;
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          if (v0 + l + L * t >= NV) continue;
#pragma unroll
          for (int i = 0; i < E; ++i) {
            const float x = __fmul_rn(element<T, VB>(rows[u][t], i), cw[u]);
            acc[t][i] = round_to<T>(first ? x : __fadd_rn(acc[t][i], x));
          }
        }
        if (cm[u] & 1) {
          char* o = obase + (size_t)(cm[u] >> 2) * row_bytes;
#pragma unroll
          for (int t = 0; t < CPL; ++t) {
            const int v = v0 + l + L * t;
            if (v < NV) store_vec<T, VB>(o + (size_t)v * VB, acc[t]);
          }
        }
      }
    }
  }
}

// The compiled variants (dtype, VB, CPL, U), one U for each (VB, CPL):
// embedbag.VARIANTS lists the same; 0 = float32, 1 = bfloat16.
#define EMBEDBAG_VARIANTS(X)                                              \
  X(0, 16, 1, 8) X(0, 16, 2, 4) X(0, 16, 4, 2) X(0, 8, 1, 8)             \
  X(0, 8, 2, 4) X(0, 8, 4, 4) X(0, 4, 1, 8)                              \
  X(1, 16, 1, 8) X(1, 16, 2, 4) X(1, 16, 4, 2) X(1, 8, 1, 8)             \
  X(1, 8, 2, 4) X(1, 8, 4, 4) X(1, 4, 1, 8) X(1, 2, 1, 8)

template <int DT>
struct Elem;
template <>
struct Elem<0> {
  using type = float;
};
template <>
struct Elem<1> {
  using type = __nv_bfloat16;
};

const void* variant(int dtype, int vec, int cpl, int U) {
#define EMBEDBAG_PICK(DT, VB, C, UU)                                      \
  if (dtype == DT && vec == VB && cpl == C && U == UU)                    \
    return reinterpret_cast<const void*>(                                 \
        &embedding_bag_stream<typename Elem<DT>::type, VB, C, UU>);
  EMBEDBAG_VARIANTS(EMBEDBAG_PICK)
#undef EMBEDBAG_PICK
  return nullptr;
}

}  // namespace

// dtype: 0 = float32 table and output, 1 = bfloat16.  The plan
// (embedbag.plan) gives vec, cpl, U, L, bags_per_group, grid and smem
// (2 ints a bag of a block).
extern "C" int embedding_bag_launch(const int* indices, const float* weights,
                                    const void* table, const int* span_start,
                                    const int* span_end, void* out,
                                    int n_bags, int D, int dtype, int vec,
                                    int cpl, int U, int L,
                                    int bags_per_group, int grid, int smem,
                                    void* stream) {
  const void* fn = variant(dtype, vec, cpl, U);
  if (fn == nullptr || n_bags < 1 || D < 1 || L < 1 || L > 32 ||
      bags_per_group < 1 || grid < 1 || smem < 0 ||
      (long long)grid * (THREADS / 32) * (32 / L) * bags_per_group < n_bags)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&indices, &weights, &table,  &span_start, &span_end,
                  &out,     &n_bags,  &D,      &L,          &bags_per_group};
  cudaError_t err =
      cudaLaunchKernel(fn, dim3(grid), dim3(THREADS), args, (size_t)smem,
                       reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a variant with smem bytes of shared memory.
extern "C" int embedding_bag_blocks_per_sm(int dtype, int vec, int cpl, int U,
                                           int smem, int* out) {
  const void* fn = variant(dtype, vec, cpl, U);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, THREADS, (size_t)smem);
}
