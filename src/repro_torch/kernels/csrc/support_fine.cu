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
// pair of hub rows).  The design keeps every thread with a probe in flight,
// gives no thread work that cannot change the result, and keeps atomics on
// one global word off the per-warp path (the L2 serialises them: claimed a
// few at a time by each warp, a planar mesh's 1.1 M short items would queue
// 280 K atomics on one cursor, about 0.7 ns each on the H100):
// - two launches on one stream.  The first (build_worklist) lifts alive to
//   the undirected lanes (one byte each, in scratch) and compacts the alive
//   real lanes into a worklist in scratch.  A block classifies a tile of
//   kTileSteps lanes a thread, sums its warps' ballots in shared memory and
//   reserves its span of each half of the list with one atomic a tile;
//   pad lanes, dead lanes and empty slots cost nothing past it.  The
//   wrapper zeroes `out`, so the second launch touches only listed lanes;
// - the shorter of the lane's two rows is walked: each of its entries is
//   binary-searched in the longer row, and a hit counts only where both
//   entries are alive (a hub to a leaf costs the leaf's few probes, not
//   the hub's thousands);
// - flattened probes (intersect.cuh::count_flat): a warp draws up to
//   kMaxClaim items, lays their chunks end to end by a warp scan, and runs
//   them one probe a thread, so short rows do not idle the warp.  A draw
//   takes fewer items when the list cannot give every warp kMinDraws
//   draws: the items' costs differ by hundreds of times, and many small
//   draws keep warps from ending the launch on a long tail, while a long
//   list of short items keeps more probes in flight a warp (a sweep on the
//   H100: 8 and 12 first of 4 to 12 and 1 to 24);
// - claims per block, draws per warp: a block of 16 warps claims a batch
//   of whole chunks (a chunk is one draw for each of its warps) from the
//   global cursor with one atomic, and its warps draw from the batch by a
//   cursor in shared memory.  The batch is guided: a claim takes the chunks
//   left over kGuide times the blocks of the grid (at least one, at most
//   kMaxBatchChunks), so batches shrink as the list drains and the launch
//   ends on one-chunk batches, a draw a warp, as per-warp claims did; the
//   first batches are a third of a block's share, so that a block whose
//   first items are heavy still ends with the others (a batch of a whole
//   share left rmat-15's blocks about 30% apart).  The warp that takes a
//   batch's last draw claims the next batch, so that it is ready when the
//   batch runs out.  A planar mesh's pass makes a few thousand claims;
//   each block adds its claims and reservations to one word at its exit;
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

constexpr int kThreads = 512;  // the most threads a block of either kernel takes
constexpr int kWarps = kThreads / kWarp;
// The second launch's grid: SMs x this, 2,048 threads an SM at kThreads
// (so 32 registers a thread).  Fewer, larger blocks make fewer claims.
constexpr int kBlocksPerSm = 4;
// The most items a warp draws at a time, and the fewest draws each warp
// of the grid should get from the list: a draw takes fewer items than
// kMaxClaim when the list is too short to give every warp kMinDraws.
// Large draws keep more probes in flight a warp; many draws a warp balance
// items whose costs differ by hundreds of times.
constexpr int kMaxClaim = 8;
constexpr int kMinDraws = 12;
static_assert(kMaxClaim <= kWarp, "a draw is one item a lane");
// Lanes each thread of the worklist launch classifies in one tile (one bit
// of a mask each): a block reserves a tile's listed lanes at once.
constexpr int kTileSteps = 16;
static_assert(kTileSteps <= 32, "a tile's steps are bits of one word");
// A claim takes the unclaimed chunks over kGuide times the blocks: the first
// batches are a third of a block's even share, so that a block whose early
// items are heavy (split hub rows come first) still finishes with the others.
constexpr int kGuide = 3;
// A block's batch: the first chunk (32 bits), the chunks in it (8 bits) and
// the items its warps have drawn (24 bits, which never pass the batch's
// items, at most kMaxBatchChunks * kWarps * kMaxClaim, by more than one
// draw a warp).
constexpr int kMaxBatchChunks = 255;
constexpr unsigned long long kNoBatch = 0xffffffffull << 32;  // the list is claimed
static_assert((kMaxBatchChunks + 1) * kWarps * kMaxClaim < (1 << 24), "a batch's draws fit");

// `counts` (int32, zeroed by the wrapper): the 64-bit chunk cursor (words 0
// and 1, 8-byte aligned; blocks may claim past the end of the list, so it
// may outgrow the chunk count), the lengths of the two halves of the list
// (unsplit lanes from the front, split lanes from the back), and the global
// claims and reservations both launches made.
enum : int { kRegCount = 2, kSplitCount = 3, kClaims = 4 };

__device__ __forceinline__ int32_t row_start(const int32_t* __restrict__ urowptr, int32_t v) {
  return v > 0 ? urowptr[v - 1] : 0;
}

// Lists each alive real lane once: unsplit lanes from the front of `list`,
// split lanes from the back.  A block's tile is kTileSteps x blockDim.x
// lanes, step j of thread i its lane j * blockDim.x + i; the tile's lanes of
// each half lie together in the list, warp by warp, step by step.
__global__ void __launch_bounds__(kThreads)
build_worklist(const int32_t* __restrict__ edge_row, const int32_t* __restrict__ colidx,
               const uint8_t* __restrict__ alive, const int32_t* __restrict__ udeg,
               const int32_t* __restrict__ ucolidx, const int32_t* __restrict__ u2d,
               uint8_t* __restrict__ ualive, int32_t* __restrict__ list,
               int32_t* __restrict__ counts, int64_t nnzp, int64_t unnzp, int32_t split_row,
               int32_t* __restrict__ launch_count) {
  // Each warp's listed lanes of the tile, then its offset in the block's
  // span, for the two halves; the span's start in each half.
  __shared__ int32_t warp_span[2][kWarps];
  __shared__ int32_t block_base[2];
  if (launch_count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launch_count, 1);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;

  for (int64_t u = tid; u < unnzp; u += nthreads) {
    const uint32_t e = static_cast<uint32_t>(u2d[u]);
    ualive[u] = e < static_cast<uint64_t>(nnzp) && alive[e] && ucolidx[u] != 0;
  }

  const unsigned lt = (1u << lane) - 1;
  const int64_t tile = static_cast<int64_t>(blockDim.x) * kTileSteps;
  int32_t reservations = 0;  // thread 0's
  for (int64_t t0 = blockIdx.x * tile; t0 < nnzp; t0 += gridDim.x * tile) {  // block-uniform
    unsigned reg = 0, spl = 0;  // bit j: step j's lane is listed unsplit, split
#pragma unroll
    for (int j = 0; j < kTileSteps; ++j) {
      const int64_t t = t0 + static_cast<int64_t>(j) * blockDim.x + threadIdx.x;
      if (t < nnzp) {
        const int32_t b = colidx[t];
        if (b != 0 && alive[t]) {
          if (min(udeg[edge_row[t]], udeg[b]) > split_row) spl |= 1u << j;
          else reg |= 1u << j;
        }
      }
    }
    const int n_reg = __reduce_add_sync(kFull, __popc(reg));
    const int n_spl = __reduce_add_sync(kFull, __popc(spl));
    if (lane == 0) {
      warp_span[0][warp] = n_reg;
      warp_span[1][warp] = n_spl;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int h = 0; h < 2; ++h) {
        int32_t total = 0;
        for (int w = 0; w < warps; ++w) {
          const int32_t n = warp_span[h][w];
          warp_span[h][w] = total;
          total += n;
        }
        block_base[h] = total ? atomicAdd(counts + (h ? kSplitCount : kRegCount), total) : 0;
        reservations += total != 0;
      }
    }
    __syncthreads();
    int32_t at_reg = block_base[0] + warp_span[0][warp];
    int32_t at_spl = block_base[1] + warp_span[1][warp];
#pragma unroll
    for (int j = 0; j < kTileSteps; ++j) {
      const int32_t t =
          static_cast<int32_t>(t0 + static_cast<int64_t>(j) * blockDim.x + threadIdx.x);
      const unsigned m_reg = __ballot_sync(kFull, (reg >> j) & 1u);
      const unsigned m_spl = __ballot_sync(kFull, (spl >> j) & 1u);
      if ((reg >> j) & 1u) list[at_reg + __popc(m_reg & lt)] = t;
      if ((spl >> j) & 1u) list[nnzp - 1 - (at_spl + __popc(m_spl & lt))] = t;
      at_reg += __popc(m_reg);
      at_spl += __popc(m_spl);
    }
    // warp_span and block_base are rewritten for the next tile only after
    // every warp has passed the next tile's first barrier.
  }
  if (threadIdx.x == 0 && reservations) atomicAdd(counts + kClaims, reservations);
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

// Claims a block's next batch from the global cursor (counts' words 0 and
// 1): the chunks not yet claimed over kGuide times the blocks of the grid,
// at least one and at most kMaxBatchChunks, as a batch word (no item
// drawn), or kNoBatch once every chunk is claimed.  The read before the
// claim keeps blocks from claiming past the end; a read that lags other
// blocks' claims only makes the batch larger.  Adds the claim to the
// block's count.
__device__ __noinline__ unsigned long long claim_batch(int32_t* counts, int64_t n_items,
                                                       int32_t chunk, int32_t* block_claims) {
  unsigned long long* cursor = reinterpret_cast<unsigned long long*>(counts);
  const int64_t n_chunks = (n_items + chunk - 1) / chunk;
  const int64_t done =
      static_cast<int64_t>(*reinterpret_cast<volatile unsigned long long*>(cursor));
  if (done >= n_chunks) return kNoBatch;
  const int64_t spread = static_cast<int64_t>(kGuide) * gridDim.x;
  int64_t take = (n_chunks - done + spread - 1) / spread;
  if (take > kMaxBatchChunks) take = kMaxBatchChunks;
  const int64_t first =
      static_cast<int64_t>(atomicAdd(cursor, static_cast<unsigned long long>(take)));
  atomicAdd(block_claims, 1);
  if (first >= n_chunks) return kNoBatch;
  return static_cast<unsigned long long>(first) << 32 | static_cast<unsigned long long>(take) << 24;
}

// Warps draw `share` items at a time (kMaxClaim, fewer when the list is too
// short to give every warp kMinDraws draws) from their block's batch, a run of
// whole chunks of the item order (a chunk is `share` items for each warp of
// the block).  The warp whose draw is the batch's last claims the block's
// next batch into `ahead`; the warp whose draw finds the batch used up
// installs it, and the warps whose draws come after that wait for it.  A
// warp stops once a draw lies past the end of the list (kNoBatch's first
// chunk lies past any list's end).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) count_items(Problem a) {
  __shared__ int32_t warp_counts_all[kWarps][kWarp];
  __shared__ unsigned long long batch;  // first chunk << 32 | chunks << 24 | items drawn
  __shared__ unsigned long long ahead;  // the next batch's word; 0 while it is being claimed
  __shared__ int32_t block_claims;
  const int lane = threadIdx.x % kWarp;
  int32_t* warp_counts = warp_counts_all[threadIdx.x / kWarp];
  const int64_t n_split_items = static_cast<int64_t>(a.counts[kSplitCount]) * a.split_ways;
  const int64_t n_items = n_split_items + a.counts[kRegCount];
  const int64_t draws = static_cast<int64_t>(gridDim.x) * (blockDim.x / kWarp) * kMinDraws;
  const int32_t share = static_cast<int32_t>(
      max(min((n_items + draws - 1) / draws, static_cast<int64_t>(kMaxClaim)), int64_t{1}));
  const int32_t chunk = share * static_cast<int32_t>(blockDim.x / kWarp);
  if (threadIdx.x == 0) {
    block_claims = 0;
    batch = 0;  // an empty batch at chunk 0: the first draw installs `ahead`
    ahead = claim_batch(a.counts, n_items, chunk, &block_claims);
  }
  __syncthreads();
  while (true) {
    unsigned long long w = 0;
    if (lane == 0) w = atomicAdd(&batch, static_cast<unsigned long long>(share));
    w = __shfl_sync(kFull, w, 0);
    const int64_t first = static_cast<int64_t>(w >> 32) * chunk;
    const int64_t end = first + static_cast<int64_t>((w >> 24) & 0xff) * chunk;
    const int64_t base = first + static_cast<int64_t>(w & 0xffffff);
    if (base < end) {  // a draw from the batch
      if (base >= n_items) break;  // the batch holds the list's end: nothing is left
      if (lane == 0 && base + share == end) {
        const unsigned long long next = claim_batch(a.counts, n_items, chunk, &block_claims);
        *static_cast<volatile unsigned long long*>(&ahead) = next;
      }
      const int64_t q = base + lane;  // lane i resolves item i of the draw
      Item mine{-1, 0, 0, 0, 0, 1};
      if (q < min(base + share, n_items)) mine = resolve(a, q, n_split_items);
      count_flat<false>(a.ucolidx, a.ualive, mine.s0, mine.n, mine.l0, mine.dl, warp_counts, lane);
      const int32_t c = warp_counts[lane];
      if (mine.t >= 0 && c) {
        if (mine.whole) a.out[mine.t] = c;
        else atomicAdd(a.out + mine.t, c);
      }
    } else {
      if (end >= n_items) break;  // the batch held the list's end, or none is left
      if (lane == 0) {
        volatile unsigned long long* vahead = &ahead;
        if (base == end) {  // the batch is used up: install the next one
          unsigned long long next;
          while ((next = *vahead) == 0) __nanosleep(32);
          *vahead = 0;
          __threadfence_block();
          atomicExch(&batch, next);
        } else {  // wait for the warp that installs it
          const volatile unsigned long long* vbatch = &batch;
          while ((*vbatch >> 24) == (w >> 24)) __nanosleep(32);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_claims) atomicAdd(a.counts + kClaims, block_claims);
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns the first nonzero cudaError_t
// of the two launches (0 = success).  `out` and `counts` (kClaims + 1
// int32) must come zeroed; ualive (unnzp bytes) and list (nnzp int32) are
// scratch; counts[kClaims] ends holding the global claims and reservations
// the two launches made.  threads_list and threads_count are the two
// launches' block sizes (multiples of 32, at most kThreads).
// `launch_count`, when not null, is one int32 on the device to which the
// worklist launch adds one each time it runs (a call captured into a CUDA
// graph runs whenever the graph does).
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
