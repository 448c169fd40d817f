// Device helpers shared by the two intersection kernels, support_fine.cu
// and peel_fused.cu: the binary search of one sorted row, a warp scan, and
// the flattened-probe loop over a warp's work items, which either counts
// each item's matches or hands each match to the caller.
//
// Rows are runs of strictly ascending int32 entries of one `col` array;
// each entry has a one-byte flag at the same index of `flags`: 1 for an
// entry that counts, 0 for one that does not.  peel_fused.cu also marks
// entries 2 (dying), which a count does not count.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace intersect {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// First index in [lo, hi) of the strictly ascending entries at `base` that
// is >= v (hi when none is).  Plain (L1-cached) loads: the rows are not
// written while they are searched.
__device__ __forceinline__ int32_t lower_bound(const int32_t* __restrict__ col, int32_t base,
                                               int32_t lo, int32_t hi, int32_t v) {
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (col[base + mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
  for (int offset = 1; offset < kWarp; offset *= 2) {
    const int n = __shfl_up_sync(kFull, v, offset);
    if (lane >= offset) v += n;
  }
  return v;
}

// A flag, read through L2 (kFlagsL2: flags that other CTAs write during the
// launch) or through L1 (flags that are fixed for the launch).
template <bool kFlagsL2>
__device__ __forceinline__ uint8_t load_flag(const uint8_t* p) {
  if (kFlagsL2) return __ldcg(p);
  return *p;
}

// Flattened probes over the work items of one warp, one item a lane (n = 0
// for a lane without one): item k is the chunk [s0, s0 + n) of `col`, each
// of whose entries is binary-searched in the row [l0, l0 + dl).  The items'
// chunks are laid end to end (a warp scan of n) and the warp takes 32
// entries at a time, one probe a thread, so that short chunks do not leave
// most of the warp idle.  For each entry u whose flag is not 0 and whose
// value is found at index w of its long row, on_match(tag of its item, u,
// flag of u, w) runs on the probing thread.  Warp-uniform call.
template <bool kFlagsL2, typename OnMatch>
__device__ __forceinline__ void match_flat(const int32_t* col, const uint8_t* flags, int32_t s0,
                                           int32_t n, int32_t l0, int32_t dl, int32_t tag,
                                           int lane, OnMatch on_match) {
  const int incl = warp_incl_scan(n, lane);
  const int total = __shfl_sync(kFull, incl, kWarp - 1);
  for (int j0 = 0; j0 < total; j0 += kWarp) {  // warp-uniform
    const int j = j0 + lane;
    int k = 0;  // the item holding probe j: the first with incl > j
#pragma unroll
    for (int step = kWarp / 2; step > 0; step >>= 1)
      if (__shfl_sync(kFull, incl, k + step - 1) <= j) k += step;
    const int32_t ks0 = __shfl_sync(kFull, s0, k);
    const int32_t first = __shfl_sync(kFull, incl - n, k);
    const int32_t kl0 = __shfl_sync(kFull, l0, k);
    const int32_t kdl = __shfl_sync(kFull, dl, k);
    const int32_t ktag = __shfl_sync(kFull, tag, k);
    if (j < total) {
      // The entry's own flag is loaded before the search, which does not
      // wait for it (a dead entry costs a search, not a serial L2 trip).
      const int32_t u = ks0 + (j - first);
      const uint8_t flag_u = load_flag<kFlagsL2>(flags + u);
      const int32_t v = col[u];
      const int32_t pos = lower_bound(col, kl0, 0, kdl, v);
      if (flag_u != 0 && pos < kdl && col[kl0 + pos] == v) on_match(ktag, u, flag_u, kl0 + pos);
    }
  }
}

// match_flat, counting for each item the entries whose flag and whose
// match's flag are both 1.  On return (after a __syncwarp) warp_counts[k]
// holds item k's count.  Warp-uniform call.
template <bool kFlagsL2>
__device__ __forceinline__ void count_flat(const int32_t* col, const uint8_t* flags, int32_t s0,
                                           int32_t n, int32_t l0, int32_t dl,
                                           int32_t* warp_counts, int lane) {
  warp_counts[lane] = 0;
  __syncwarp();
  match_flat<kFlagsL2>(col, flags, s0, n, l0, dl, lane, lane,
                       [&](int32_t k, int32_t, uint8_t flag_u, int32_t w) {
                         if (flag_u == 1 && load_flag<kFlagsL2>(flags + w) == 1)
                           atomicAdd(warp_counts + k, 1);
                       });
  __syncwarp();
}

}  // namespace intersect
