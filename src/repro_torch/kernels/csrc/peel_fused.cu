// One whole truss level per launch (the fused level peel) for Hopper, sm_90a.
//
// Replaces repro/kernels/peel_fused.py::make_fused_level (body _level_kernel,
// src/repro/kernels/peel_fused.py:260).  On the TPU the level is one
// grid-less program holding the whole packed problem; on an H100 that would
// be one CTA.  Here it is one cooperative launch of a persistent grid
// (occupancy x SM count CTAs, all co-resident), whose phases are separated
// by grid-wide barriers (cooperative_groups::this_grid().sync()).
//
// Function (every array int32 unless noted; bools are one byte, 0/1):
//   per launch: flive[t] = frozen[t] && ftruss[t] >= cur_k[slot(t)]
//   per inner trip, while some slot is live (!latch && !done) and
//   trips < inner_limit:
//     (a) ualive[u] = (alive | flive)[u2d[u]]        (u2d == nnzp on pads)
//     (b) over tiles of `block` lanes: a tile with no free alive lane is
//         skipped and its supports written 0; otherwise one warp per lane t
//         with b = colidx[t] != 0 and (alive | flive)[t] counts
//         |{c : (a, c) and (b, c) alive}| over the undirected rows of
//         a = edge_row[t] and b (row v starts at urowptr[v-1], 0 for v = 0,
//         and holds udeg[v] strictly ascending entries of ucolidx).  Then
//         alive[t] &= s >= cur_k - 2, and each death adds one to the
//         slot's `changed` count;
//     (c) per slot: live slots count one iteration, and latch when nothing
//         changed.  Every CTA keeps its own copy of latch/iters in shared
//         memory, computed from the same counts, so all CTAs agree on when
//         the loop ends;
//   then the level bookkeeping of build_peel's converged branch (trussness,
//   `left` per slot, retire, cur_k advance, kmax, levels, edges) and the
//   prune-ahead against the advanced threshold.
// Slot s owns lanes [s * slot_nnz, (s+1) * slot_nnz); block divides slot_nnz,
// so a tile lies in one slot (the wrapper and validate_fused_tiling check).
//
// Bound: the level reads each input once (the problem: colidx, edge_row,
// u2d, ucolidx, urowptr, udeg; the state; frozen, ftruss) and writes each
// output once, about 4 * (2 nnzp + 2 unnzp + 2 n) + 19 nnzp bytes, over
// device memory; the intersection steps of each inner trip's alive set over
// the integer peak are below that.  The kernel itself re-reads the problem
// on every trip, and its intersections are data-dependent probes into rows
// that mostly sit in L2, so like support_fine.cu it is limited by the
// latency of those probes and by hub rows, far above the bound.  What the
// design does about it: supports, alive flags and the per-slot latch never
// leave the launch between trips (no host round trip, no torch op per
// trip); dead tiles cost one byte per lane; the per-trip
// `changed` counts are integer atomics only on deaths (at most nnzp over a
// whole peel); and two grid barriers per trip replace the host readback.
// Splitting hub rows across warps is left for later.
//
// schedule "bsearch": the 32 lanes of a warp stride over a's row and each
// binary-searches its entry in b's row (as support_fine.cu).  schedule
// "compare": a warp-wide merge of the two rows, 32 entries of each at a time
// compared all against all by shuffles, advancing the side whose chunk ends
// lower; both start at the first entry the other row can match.  Both count
// every match exactly once, so the state is bit-identical for every block x
// schedule.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  // The packed problem (read-only).
  const int32_t* __restrict__ colidx;
  const int32_t* __restrict__ edge_row;
  const int32_t* __restrict__ urowptr;
  const int32_t* __restrict__ udeg;
  const int32_t* __restrict__ ucolidx;
  const int32_t* __restrict__ u2d;
  // The state in, and the frozen lanes (read-only).
  const uint8_t* __restrict__ alive_in;
  const int32_t* __restrict__ truss_in;
  const int32_t* __restrict__ cur_k_in;
  const int32_t* __restrict__ kmax_in;
  const int32_t* __restrict__ levels_in;
  const int32_t* __restrict__ iters_in;
  const uint8_t* __restrict__ done_in;
  const int32_t* __restrict__ edges_in;
  const int32_t* __restrict__ titers_in;
  const uint8_t* __restrict__ frozen;
  const int32_t* __restrict__ ftruss;
  const uint8_t* __restrict__ single;
  // The state out.  `alive` and `supp` are also the working buffers, read by
  // other CTAs during the launch: never through the read-only cache.
  uint8_t* alive;
  int32_t* supp;
  int32_t* truss;
  int32_t* cur_k;
  int32_t* kmax;
  int32_t* levels;
  int32_t* iters;
  uint8_t* done;
  int32_t* titers;
  int32_t* edges;
  // Scratch: flive (nnzp), ualive (unnzp), counts (changed[2][S], left[S]).
  uint8_t* flive;
  uint8_t* ualive;
  int32_t* counts;
  int64_t nnzp;
  int64_t unnzp;
  int32_t slot_nnz;
  int32_t num_slots;
  int32_t block;
  int32_t inner_limit;
};

__device__ __forceinline__ int32_t row_start(const Args& a, int32_t v) {
  return v > 0 ? a.urowptr[v - 1] : 0;
}

// First index in [0, n) of the strictly ascending row at `base` whose entry
// is >= v (warp-uniform when its arguments are).
__device__ __forceinline__ int32_t lower_bound(const int32_t* __restrict__ col,
                                               int32_t base, int32_t n, int32_t v) {
  int32_t lo = 0, hi = n;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (col[base + mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Per-lane partial count; the caller sums the warp.  ualive is read through
// L2 (__ldcg): other CTAs wrote it this trip.
__device__ int count_bsearch(const Args& a, int32_t a0, int32_t da, int32_t b0,
                             int32_t db, int lane) {
  int count = 0;
  for (int32_t i = lane; i < da; i += kWarp) {
    if (!__ldcg(a.ualive + a0 + i)) continue;
    const int32_t v = a.ucolidx[a0 + i];
    const int32_t lo = lower_bound(a.ucolidx, b0, db, v);
    if (lo < db && a.ucolidx[b0 + lo] == v && __ldcg(a.ualive + b0 + lo)) ++count;
  }
  return count;
}

__device__ int count_merge(const Args& a, int32_t a0, int32_t da, int32_t b0,
                           int32_t db, int lane) {
  if (da == 0 || db == 0) return 0;
  // Entries below the other row's first entry cannot match.
  int32_t ia = lower_bound(a.ucolidx, a0, da, a.ucolidx[b0]);
  int32_t ib = lower_bound(a.ucolidx, b0, db, a.ucolidx[a0]);
  int count = 0;
  while (ia < da && ib < db) {  // warp-uniform
    const int32_t pa = ia + lane, pb = ib + lane;
    // Past a row's end: sentinels above every vertex id, unequal to each other.
    const int32_t va = pa < da ? a.ucolidx[a0 + pa] : INT_MAX;
    const int32_t vb = pb < db ? a.ucolidx[b0 + pb] : INT_MAX - 1;
    const int32_t amax = __shfl_sync(kFull, va, kWarp - 1);
    const int32_t bmax = __shfl_sync(kFull, vb, kWarp - 1);
    const int32_t amin = __shfl_sync(kFull, va, 0);
    const int32_t bmin = __shfl_sync(kFull, vb, 0);
    if (amin <= bmax && bmin <= amax) {
      // Dead or absent entries compare as -1 (a) and -2 (b): never equal.
      const int32_t ma = (pa < da && __ldcg(a.ualive + a0 + pa)) ? va : -1;
      const int32_t mb = (pb < db && __ldcg(a.ualive + b0 + pb)) ? vb : -2;
#pragma unroll
      for (int k = 0; k < kWarp; ++k) count += ma == __shfl_sync(kFull, mb, k);
    }
    if (amax <= bmax) ia += kWarp;
    if (bmax <= amax) ib += kWarp;
  }
  return count;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int offset = kWarp / 2; offset > 0; offset /= 2)
    v += __shfl_down_sync(kFull, v, offset);
  return v;
}

// Whether any slot is still live; also a CTA barrier over latch.
__device__ __forceinline__ bool any_live(const Args& a, const int32_t* latch) {
  int live = 0;
  for (int s = threadIdx.x; s < a.num_slots; s += blockDim.x)
    live |= !latch[s] && !a.done_in[s];
  return __syncthreads_or(live) != 0;
}

template <bool kBsearch>
__global__ void __launch_bounds__(kThreads) peel_fused_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int32_t smem[];
  const int32_t S = a.num_slots;
  int32_t* latch = smem;         // per slot: converged this launch
  int32_t* iters = smem + S;     // per slot: iterations so far
  int32_t* left_cta = smem + 2 * S;  // per slot: this CTA's alive lanes
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t ntiles = a.nnzp / a.block;
  int32_t* left = a.counts + 2 * S;

  // Phase 0: working copies, frozen-live flags, zeroed counters.
  for (int64_t t = tid; t < a.nnzp; t += nthreads) {
    const int32_t slot = static_cast<int32_t>(t / a.slot_nnz);
    a.alive[t] = a.alive_in[t];
    a.flive[t] = a.frozen[t] && a.ftruss[t] >= a.cur_k_in[slot];
    a.supp[t] = 0;
  }
  for (int64_t i = tid; i < 3 * static_cast<int64_t>(S); i += nthreads) a.counts[i] = 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    latch[s] = 0;
    iters[s] = a.iters_in[s];
    left_cta[s] = 0;
  }
  grid.sync();

  int32_t trips = 0;
  // any_live first: its barrier also orders the last latch update before
  // the bookkeeping below reads it.
  while (any_live(a, latch) && trips < a.inner_limit) {
    // (a) the undirected alive flags of this trip.
    for (int64_t u = tid; u < a.unnzp; u += nthreads) {
      const int32_t d = a.u2d[u];
      a.ualive[u] = d < a.nnzp && (__ldcg(a.alive + d) | __ldcg(a.flive + d));
    }
    grid.sync();

    // (b) supports and the prune, tile by tile.
    int32_t* changed = a.counts + (trips & 1) * S;
    for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int64_t base = tile * a.block;
      int any = 0;
      for (int i = threadIdx.x; i < a.block; i += blockDim.x) any |= __ldcg(a.alive + base + i);
      if (!__syncthreads_or(any)) {
        for (int i = threadIdx.x; i < a.block; i += blockDim.x) a.supp[base + i] = 0;
        continue;
      }
      const int32_t slot = static_cast<int32_t>(base / a.slot_nnz);
      const int32_t thresh = a.cur_k_in[slot] - 2;
      for (int j = warp; j < a.block; j += kWarps) {
        const int64_t t = base + j;
        const int32_t b = a.colidx[t];
        const bool al = __ldcg(a.alive + t) != 0;
        int count = 0;
        if (b != 0 && (al || __ldcg(a.flive + t))) {  // warp-uniform
          const int32_t ra = a.edge_row[t];
          const int32_t a0 = row_start(a, ra), da = a.udeg[ra];
          const int32_t b0 = row_start(a, b), db = a.udeg[b];
          count = kBsearch ? count_bsearch(a, a0, da, b0, db, lane)
                           : count_merge(a, a0, da, b0, db, lane);
          count = warp_sum(count);
        }
        if (lane == 0) {
          a.supp[t] = count;
          if (al && count < thresh) {
            a.alive[t] = 0;
            atomicAdd(changed + slot, 1);
          }
        }
      }
    }
    grid.sync();

    // (c) the per-slot latch, identically in every CTA.  CTA 0 zeroes the
    // other parity of `changed`: every CTA read it last trip, before the
    // barrier above, and the next trip adds to it only after a barrier.
    int32_t* other = a.counts + ((trips + 1) & 1) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int32_t ch = __ldcg(changed + s);
      if (!latch[s] && !a.done_in[s]) {
        ++iters[s];
        if (ch == 0) latch[s] = 1;
      }
      if (blockIdx.x == 0) other[s] = 0;
    }
    ++trips;
  }

  // Level bookkeeping: trussness of converged slots, and `left` per slot.
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = tile * a.block;
    const int32_t slot = static_cast<int32_t>(base / a.slot_nnz);
    const bool conv = latch[slot] && !a.done_in[slot];
    const int32_t k = a.cur_k_in[slot];
    int n_alive = 0;
    for (int i = threadIdx.x; i < a.block; i += blockDim.x) {
      const int64_t t = base + i;
      const bool al = __ldcg(a.alive + t) != 0;
      a.truss[t] = (conv && al) ? k : a.truss_in[t];
      n_alive += al;
    }
    n_alive = warp_sum(n_alive);
    if (lane == 0 && n_alive) atomicAdd(left_cta + slot, n_alive);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    if (left_cta[s]) atomicAdd(left + s, left_cta[s]);
  grid.sync();

  // Retire / advance, then prune ahead against the new threshold.
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = tile * a.block;
    const int32_t slot = static_cast<int32_t>(base / a.slot_nnz);
    const bool conv = latch[slot] && !a.done_in[slot];
    const bool nonempty = __ldcg(left + slot) > 0;
    const bool retired = conv && (!nonempty || a.single[slot]);
    const int32_t k_next = a.cur_k_in[slot] + ((conv && !retired) ? 1 : 0);
    for (int i = threadIdx.x; i < a.block; i += blockDim.x) {
      const int64_t t = base + i;
      const int32_t s_t = __ldcg(a.supp + t);
      const bool keep = __ldcg(a.alive + t) && s_t >= k_next - 2;
      a.alive[t] = keep;
      a.supp[t] = keep ? s_t : 0;
    }
  }
  if (blockIdx.x == 0) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const bool conv = latch[s] && !a.done_in[s];
      const int32_t n_left = __ldcg(left + s);
      const bool retired = conv && (n_left == 0 || a.single[s]);
      a.cur_k[s] = a.cur_k_in[s] + ((conv && !retired) ? 1 : 0);
      a.kmax[s] = (conv && n_left > 0) ? a.cur_k_in[s] : a.kmax_in[s];
      a.levels[s] = a.levels_in[s] + (conv ? 1 : 0);
      a.iters[s] = iters[s];
      a.done[s] = a.done_in[s] || retired;
      a.edges[s] = a.done_in[s] ? a.edges_in[s] : n_left;
    }
    if (threadIdx.x == 0) a.titers[0] = a.titers_in[0] + trips;
  }
}

template <bool kBsearch>
int launch(Args& args, int device, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&peel_fused_kernel<kBsearch>);
  const size_t smem = 3 * sizeof(int32_t) * static_cast<size_t>(args.num_slots);
  cudaError_t err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t ntiles = args.nnzp / args.block;
  int64_t grid = static_cast<int64_t>(per_sm) * sms;
  if (grid > ntiles) grid = ntiles;  // no CTA without a tile
  if (grid < 1) grid = 1;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads),
                                    params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one level on `stream`; returns the cudaError_t of the launch
// (0 = success).  Pointers in the order of struct Args.
int peel_fused_launch(const void* colidx, const void* edge_row, const void* urowptr,
                      const void* udeg, const void* ucolidx, const void* u2d,
                      const void* alive_in, const void* truss_in, const void* cur_k_in,
                      const void* kmax_in, const void* levels_in, const void* iters_in,
                      const void* done_in, const void* edges_in, const void* titers_in,
                      const void* frozen, const void* ftruss, const void* single,
                      void* alive, void* supp, void* truss, void* cur_k, void* kmax,
                      void* levels, void* iters, void* done, void* titers, void* edges,
                      void* flive, void* ualive, void* counts,
                      long long nnzp, long long unnzp, int slot_nnz, int num_slots,
                      int block, int inner_limit, int bsearch, int device, void* stream) {
  if (nnzp <= 0 || num_slots < 1 || block < 1 || nnzp % block || slot_nnz % block)
    return cudaErrorInvalidValue;
  Args args{
      static_cast<const int32_t*>(colidx),   static_cast<const int32_t*>(edge_row),
      static_cast<const int32_t*>(urowptr),  static_cast<const int32_t*>(udeg),
      static_cast<const int32_t*>(ucolidx),  static_cast<const int32_t*>(u2d),
      static_cast<const uint8_t*>(alive_in), static_cast<const int32_t*>(truss_in),
      static_cast<const int32_t*>(cur_k_in), static_cast<const int32_t*>(kmax_in),
      static_cast<const int32_t*>(levels_in), static_cast<const int32_t*>(iters_in),
      static_cast<const uint8_t*>(done_in),  static_cast<const int32_t*>(edges_in),
      static_cast<const int32_t*>(titers_in), static_cast<const uint8_t*>(frozen),
      static_cast<const int32_t*>(ftruss),   static_cast<const uint8_t*>(single),
      static_cast<uint8_t*>(alive),          static_cast<int32_t*>(supp),
      static_cast<int32_t*>(truss),          static_cast<int32_t*>(cur_k),
      static_cast<int32_t*>(kmax),           static_cast<int32_t*>(levels),
      static_cast<int32_t*>(iters),          static_cast<uint8_t*>(done),
      static_cast<int32_t*>(titers),         static_cast<int32_t*>(edges),
      static_cast<uint8_t*>(flive),          static_cast<uint8_t*>(ualive),
      static_cast<int32_t*>(counts),
      static_cast<int64_t>(nnzp),            static_cast<int64_t>(unnzp),
      slot_nnz, num_slots, block, inner_limit};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bsearch ? launch<true>(args, device, s) : launch<false>(args, device, s);
}

const char* peel_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
