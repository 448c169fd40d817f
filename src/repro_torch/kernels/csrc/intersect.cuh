// Device helpers shared by the two intersection kernels, support_fine.cu
// and peel_fused.cu: the binary search of one sorted row, a warp scan, and
// the flattened-probe loop that counts a warp's work items.
//
// Rows are runs of strictly ascending int32 entries of one `col` array;
// each entry has a one-byte flag (alive) at the same index of `flags`.
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
__device__ __forceinline__ bool load_flag(const uint8_t* p) {
  if (kFlagsL2) return __ldcg(p) != 0;
  return *p != 0;
}

// Flattened probes over the work items of one warp, one item a lane (n = 0
// for a lane without one): item k is the chunk [s0, s0 + n) of `col`, each
// of whose entries is binary-searched in the row [l0, l0 + dl).  The items'
// chunks are laid end to end (a warp scan of n) and the warp takes 32
// entries at a time, one probe a thread, so that short chunks do not leave
// most of the warp idle.  A probe counts where both entries are flagged.
// On return (after a __syncwarp) warp_counts[k] holds item k's count.
// Warp-uniform call.
template <bool kFlagsL2>
__device__ __forceinline__ void count_flat(const int32_t* col, const uint8_t* flags, int32_t s0,
                                           int32_t n, int32_t l0, int32_t dl,
                                           int32_t* warp_counts, int lane) {
  const int incl = warp_incl_scan(n, lane);
  const int total = __shfl_sync(kFull, incl, kWarp - 1);
  warp_counts[lane] = 0;
  __syncwarp();
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
    if (j < total) {
      // The entry's own flag is loaded before the search, which does not
      // wait for it (a dead entry costs a search, not a serial L2 trip).
      const int32_t u = ks0 + (j - first);
      const bool live_u = load_flag<kFlagsL2>(flags + u);
      const int32_t v = col[u];
      const int32_t pos = lower_bound(col, kl0, 0, kdl, v);
      if (live_u && pos < kdl && col[kl0 + pos] == v && load_flag<kFlagsL2>(flags + kl0 + pos))
        atomicAdd(warp_counts + k, 1);
    }
  }
  __syncwarp();
}

}  // namespace intersect
