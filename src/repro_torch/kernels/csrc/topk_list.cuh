// Sorted (dist, id) lists shared by the kernels.
//
// A list holds k entries ascending by (dist, id): distance first, the
// smaller id on distance ties -- the tie rule of the reference's in-kernel
// selects (merge_topk_rounds / merge_topk_unique_rounds).  Empty slots are
// (+inf, -1); a candidate with a non-finite distance or id -1 never enters.
#pragma once

#include <math.h>

namespace repro_topk {

__device__ __forceinline__ bool pair_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Would (d, id) enter a full list whose last entry is (kd, ki)?
__device__ __forceinline__ bool beats(float d, int id, float kd, int ki) {
  return id >= 0 && d < INFINITY && pair_less(d, id, kd, ki);
}

__device__ __forceinline__ void list_init(float* ld, int* li, int k, int tid,
                                          int nthreads) {
  for (int t = tid; t < k; t += nthreads) {
    ld[t] = INFINITY;
    li[t] = -1;
  }
}

// Insert (d, id) into the sorted list, dropping the last entry.  The caller
// has checked beats(d, id, ld[k-1], li[k-1]).
__device__ __forceinline__ void list_insert(float* ld, int* li, int k, float d,
                                            int id) {
  int p = k - 1;
  while (p > 0 && pair_less(d, id, ld[p - 1], li[p - 1])) {
    ld[p] = ld[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  ld[p] = d;
  li[p] = id;
}

// Unique-by-id insert: the list keeps each id once, at its smallest
// distance.  An id already present at a distance <= d is left alone; one
// present at a larger distance is taken out before (d, id) goes in.
__device__ __forceinline__ void list_insert_unique(float* ld, int* li, int k,
                                                   float d, int id) {
  for (int p = 0; p < k; ++p) {
    if (li[p] == id) {
      if (!(d < ld[p])) return;
      for (int t = p; t < k - 1; ++t) {
        ld[t] = ld[t + 1];
        li[t] = li[t + 1];
      }
      ld[k - 1] = INFINITY;
      li[k - 1] = -1;
      break;
    }
  }
  if (beats(d, id, ld[k - 1], li[k - 1])) list_insert(ld, li, k, d, id);
}

// One warp's unique-by-id insert into a sorted list of k <= 256 pairs, with
// list_insert_unique's result: lane l reads slots l, l + 32, ...; a ballot
// finds the id's slot (k if absent) and another counts the entries before
// (d, id).  The entries from there up to the id's old slot (or to the last
// one, which falls off) move up one slot, the top 32 first, so that each is
// read before the lane below overwrites it.  Every lane must call it with
// the same (d, id).
__device__ __forceinline__ void warp_insert_unique(float* ld, int* li, int k,
                                                   float d, int id,
                                                   int lane) {
  if (!(id >= 0 && d < INFINITY)) return;
  int old = k, pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int s = base + lane;
    const bool in = s < k;
    const float sd = in ? ld[s] : INFINITY;
    const int si = in ? li[s] : -1;
    const unsigned same = __ballot_sync(0xffffffffu, in && si == id);
    if (same && old == k) old = base + __ffs(same) - 1;
    pos += __popc(__ballot_sync(0xffffffffu, in && pair_less(sd, si, d, id)));
  }
  if (old < k ? !(d < ld[old]) : !beats(d, id, ld[k - 1], li[k - 1])) return;
  const int end = old < k ? old : k - 1;
  for (int base = (end / 32) * 32; base >= 0; base -= 32) {
    if (base + 31 <= pos) break;
    const int s = base + lane;
    const bool move = s > pos && s <= end;
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

// Most corpus ranges a query's scan may be split into (merge_splits).
constexpr int MAX_SPLITS = 128;

// Merge the n_splits sorted per-split lists of each query into one, by
// (dist, id): one thread per query, repeated selection over the list heads.
// part_* are [n_splits][nq][k]; out_* are [nq][k].
__global__ void merge_splits_kernel(const float* __restrict__ part_d,
                                    const int* __restrict__ part_i,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i, int nq, int k,
                                    int n_splits) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  int head[MAX_SPLITS];
  for (int s = 0; s < n_splits; ++s) head[s] = 0;
  for (int t = 0; t < k; ++t) {
    float bd = INFINITY;
    int bi = -1, bs = -1;
    for (int s = 0; s < n_splits; ++s) {
      if (head[s] >= k) continue;
      const size_t o = ((size_t)s * nq + q) * k + head[s];
      const float dd = part_d[o];
      const int ii = part_i[o];
      if (beats(dd, ii, bd, bi)) {
        bd = dd;
        bi = ii;
        bs = s;
      }
    }
    if (bs >= 0) head[bs] += 1;
    out_d[(size_t)q * k + t] = bd;
    out_i[(size_t)q * k + t] = bi;
  }
}

}  // namespace repro_topk
