// Owner-mode fine-grained support (the paper's Alg. 3 computeSupports,
// collision-free form) for Hopper, sm_90a.
//
// Replaces repro/kernels/support_fine.py::support_fine_pallas
// (src/repro/kernels/support_fine.py:86) together with the window gather
// that feeds it on the TPU (repro/kernels/ops.py::support_fine).  The TPU
// pre-gathers (E, W) windows because gathers are slow there; here each warp
// reads its own CSR rows, so no window array exists.
//
// Function: for each directed lane t with b = colidx[t] != 0 and alive[t],
//   out[t] = |{ c : (a, c) alive and (b, c) alive }|,  a = edge_row[t],
// over the undirected rows: row v starts at urowptr[v-1] (0 for v = 0) and
// holds udeg[v] entries of ucolidx, strictly ascending.  Row extents come
// from udeg, never from urowptr differences: the aligned layout leaves pad
// lanes between rows.  Undirected lane u is alive when its directed lane
// u2d[u] (>= nnzp on pad lanes) is alive and ucolidx[u] != 0.  Every other
// lane gets 0.
//
// Bound: each input read once (the problem's rows, u2d, alive) and the
// output written once, a few tens of MB over device memory, well under
// 0.1 ms; the intersection steps (per alive lane the cheaper of a merge and
// a binary search of the shorter row in the longer) over the integer peak
// are below that.  What limits the kernel instead is the latency of the
// data-dependent probes: each binary search is a chain of dependent loads
// into rows that sit in L2 (the rows of rmat-15 are 16 MB), and the work per
// lane ranges from nothing (a dead or pad lane) to thousands of probes (a
// pair of hub rows).  The design keeps every thread with a probe in flight
// and gives no thread work that cannot change the result:
// - two launches on one stream.  The first (build_worklist) lifts alive to
//   the undirected lanes (one byte each, in scratch) and compacts the alive
//   real lanes into a worklist in scratch with warp ballots, one atomic per
//   warp; pad lanes, dead lanes and empty slots cost nothing past it.  The
//   wrapper zeroes `out`, so the second launch touches only listed lanes;
// - the shorter of the lane's two rows is walked: each of its entries is
//   binary-searched in the longer row, and a hit counts only where both
//   entries are alive (a hub to a leaf costs the leaf's few probes, not
//   the hub's thousands);
// - flattened probes (intersect.cuh::count_flat): a warp claims up to
//   kMaxClaim items by an atomic cursor (fewer when the list is short, so
//   that every warp gets a share), lays their chunks end to end by a warp
//   scan, and runs them one probe a thread, so short rows do not idle the
//   warp.  Claims are small: the items' costs differ by hundreds of times,
//   and small claims keep warps from ending the launch on a long tail;
// - hub rows split: a lane whose shorter row exceeds split_row entries is
//   split_ways items, each a chunk of that row, which several warps take;
//   they add into out[t] with integer atomics, exact in any order.  Split
//   items come first in the item order, so that the heaviest are taken
//   first.
// Nothing is compacted per launch (the fused kernel compacts rows to the
// alive set once per level and amortises it over the level's trips; here
// one launch is one support pass), so walks and searches cover dead
// entries too.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "intersect.cuh"

namespace {

using intersect::count_flat;
using intersect::kFull;
using intersect::kWarp;

constexpr int kThreads = 256;  // the most threads a block of either kernel takes
constexpr int kWarps = kThreads / kWarp;
constexpr int kBlocksPerSm = 8;  // the second launch's grid: SMs x this
// The most items a warp claims at a time.  Small claims balance items whose
// costs differ by hundreds of times (a sweep on the H100 over 4 to 32 put
// 4 first).
constexpr int kMaxClaim = 4;
static_assert(kMaxClaim <= kWarp, "a claim is one item a lane");

// `counts` (int32, zeroed by the wrapper): the 64-bit item cursor (words 0
// and 1, 8-byte aligned; warps claim past the end of the list, so it
// outgrows the item count), then the lengths of the two halves of the
// list: unsplit lanes from the front, split lanes from the back.
enum : int { kRegCount = 2, kSplitCount = 3 };

__device__ __forceinline__ int32_t row_start(const int32_t* __restrict__ urowptr, int32_t v) {
  return v > 0 ? urowptr[v - 1] : 0;
}

__global__ void __launch_bounds__(kThreads)
build_worklist(const int32_t* __restrict__ edge_row, const int32_t* __restrict__ colidx,
               const uint8_t* __restrict__ alive, const int32_t* __restrict__ udeg,
               const int32_t* __restrict__ ucolidx, const int32_t* __restrict__ u2d,
               uint8_t* __restrict__ ualive, int32_t* __restrict__ list,
               int32_t* __restrict__ counts, int64_t nnzp, int64_t unnzp, int32_t split_row,
               int32_t* __restrict__ launch_count) {
  if (launch_count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launch_count, 1);
  const int lane = threadIdx.x % kWarp;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;

  for (int64_t u = tid; u < unnzp; u += nthreads) {
    const uint32_t e = static_cast<uint32_t>(u2d[u]);
    ualive[u] = e < static_cast<uint64_t>(nnzp) && alive[e] && ucolidx[u] != 0;
  }

  const unsigned lt = (1u << lane) - 1;
  for (int64_t t0 = tid - lane; t0 < nnzp; t0 += nthreads) {  // warp-uniform
    const int64_t t = t0 + lane;
    bool keep = false, split = false;
    if (t < nnzp) {
      const int32_t b = colidx[t];
      keep = b != 0 && alive[t];
      if (keep) split = min(udeg[edge_row[t]], udeg[b]) > split_row;
    }
    const unsigned m_reg = __ballot_sync(kFull, keep && !split);
    const unsigned m_spl = __ballot_sync(kFull, keep && split);
    int32_t base_reg = 0, base_spl = 0;
    if (lane == 0) {
      if (m_reg) base_reg = atomicAdd(counts + kRegCount, __popc(m_reg));
      if (m_spl) base_spl = atomicAdd(counts + kSplitCount, __popc(m_spl));
    }
    base_reg = __shfl_sync(kFull, base_reg, 0);
    base_spl = __shfl_sync(kFull, base_spl, 0);
    if (keep && !split) list[base_reg + __popc(m_reg & lt)] = static_cast<int32_t>(t);
    if (keep && split) list[nnzp - 1 - (base_spl + __popc(m_spl & lt))] = static_cast<int32_t>(t);
  }
}

struct Problem {
  const int32_t* __restrict__ edge_row;
  const int32_t* __restrict__ colidx;
  const int32_t* __restrict__ urowptr;
  const int32_t* __restrict__ udeg;
  const int32_t* __restrict__ ucolidx;
  const uint8_t* __restrict__ ualive;
  const int32_t* __restrict__ list;
  int32_t* counts;  // the cursor is claimed with atomics during the launch
  int32_t* __restrict__ out;
  int64_t nnzp;
  int32_t split_ways;
};

// One work item: the chunk [s0, s0 + n) of the shorter row of lane t's
// pair, to be searched in the longer row [l0, l0 + dl).
struct Item {
  int32_t t;      // the lane; -1 for no item
  int32_t s0, n, l0, dl;
  int32_t whole;  // 1: the item is the whole lane (store), 0: a chunk (add)
};

// Item q: the split lanes' chunks first (q < n_split_items: chunk
// q % split_ways of the lane q / split_ways places from the back of the
// list), then the unsplit lanes from the front.
__device__ __forceinline__ Item resolve(const Problem& a, int64_t q, int64_t n_split_items) {
  Item it{-1, 0, 0, 0, 0, 1};
  int32_t chunk = 0, ways = 1;
  if (q < n_split_items) {
    it.t = a.list[a.nnzp - 1 - q / a.split_ways];
    chunk = static_cast<int32_t>(q % a.split_ways);
    ways = a.split_ways;
    it.whole = 0;
  } else {
    it.t = a.list[q - n_split_items];
  }
  const int32_t ra = a.edge_row[it.t], b = a.colidx[it.t];
  const int32_t da = a.udeg[ra], db = a.udeg[b];
  const bool a_short = da <= db;
  const int32_t ds = a_short ? da : db;
  it.l0 = row_start(a.urowptr, a_short ? b : ra);
  it.dl = a_short ? db : da;
  const int32_t len = (ds + ways - 1) / ways;
  const int32_t lo = chunk * len;
  const int32_t hi = min(lo + len, ds);
  it.s0 = row_start(a.urowptr, a_short ? ra : b) + lo;
  it.n = max(hi - lo, 0);
  return it;
}

// Warps claim up to kMaxClaim items at a time by an atomic cursor, fewer
// when the list is too short to give every warp kMaxClaim.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) count_items(Problem a) {
  __shared__ int32_t warp_counts_all[kWarps][kWarp];
  const int lane = threadIdx.x % kWarp;
  int32_t* warp_counts = warp_counts_all[threadIdx.x / kWarp];
  unsigned long long* cursor = reinterpret_cast<unsigned long long*>(a.counts);
  const int64_t n_split_items = static_cast<int64_t>(a.counts[kSplitCount]) * a.split_ways;
  const int64_t n_items = n_split_items + a.counts[kRegCount];
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp);
  int64_t share = (n_items + n_warps - 1) / n_warps;
  if (share > kMaxClaim) share = kMaxClaim;
  if (share < 1) share = 1;
  while (true) {
    unsigned long long claimed = 0;
    if (lane == 0) claimed = atomicAdd(cursor, static_cast<unsigned long long>(share));
    const int64_t base = static_cast<int64_t>(__shfl_sync(kFull, claimed, 0));
    if (base >= n_items) break;
    const int64_t q = base + lane;  // lane i resolves item i of the claim
    Item mine{-1, 0, 0, 0, 0, 1};
    if (q < min(base + share, n_items)) mine = resolve(a, q, n_split_items);
    count_flat<false>(a.ucolidx, a.ualive, mine.s0, mine.n, mine.l0, mine.dl, warp_counts, lane);
    const int32_t c = warp_counts[lane];
    if (mine.t >= 0 && c) {
      if (mine.whole) a.out[mine.t] = c;
      else atomicAdd(a.out + mine.t, c);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns the first nonzero cudaError_t
// of the two launches (0 = success).  `out` and `counts` must come zeroed;
// ualive (unnzp bytes) and list (nnzp int32) are scratch.  threads_list and
// threads_count are the two launches' block sizes (multiples of 32, at most
// 256).  `launch_count`, when not null, is one int32 on the device to which
// the worklist launch adds one each time it runs (a call captured into a
// CUDA graph runs whenever the graph does).
int support_fine_launch(const void* edge_row, const void* colidx, const void* alive,
                        const void* urowptr, const void* udeg, const void* ucolidx,
                        const void* u2d, void* ualive, void* list, void* counts, void* out,
                        long long nnzp, long long unnzp, int split_row, int split_ways,
                        int threads_list, int threads_count, void* stream,
                        void* launch_count) {
  if (nnzp <= 0) return 0;
  // Lanes are int32 in the worklist.
  if (nnzp > INT_MAX || unnzp < 0 || split_row < 0 || split_ways < 1 ||
      threads_list < kWarp || threads_list % kWarp || threads_count < kWarp ||
      threads_count % kWarp)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  const long long lanes = nnzp > unnzp ? nnzp : unnzp;
  long long blocks = (lanes + threads_list - 1) / threads_list;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  build_worklist<<<static_cast<unsigned>(blocks), threads_list, 0, s>>>(
      static_cast<const int32_t*>(edge_row), static_cast<const int32_t*>(colidx),
      static_cast<const uint8_t*>(alive), static_cast<const int32_t*>(udeg),
      static_cast<const int32_t*>(ucolidx), static_cast<const int32_t*>(u2d),
      static_cast<uint8_t*>(ualive), static_cast<int32_t*>(list), static_cast<int32_t*>(counts),
      static_cast<int64_t>(nnzp), static_cast<int64_t>(unnzp), split_row,
      static_cast<int32_t*>(launch_count));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  Problem a{static_cast<const int32_t*>(edge_row), static_cast<const int32_t*>(colidx),
            static_cast<const int32_t*>(urowptr),  static_cast<const int32_t*>(udeg),
            static_cast<const int32_t*>(ucolidx),  static_cast<const uint8_t*>(ualive),
            static_cast<const int32_t*>(list),     static_cast<int32_t*>(counts),
            static_cast<int32_t*>(out),            static_cast<int64_t>(nnzp),
            split_ways};
  count_items<<<static_cast<unsigned>(kBlocksPerSm * sms), threads_count, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* support_fine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
