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
//   trips < inner_limit, for every lane t of a live slot with
//   alive[t]: s[t] = |{c : (a, c) and (b, c) in alive | flive}| over the
//   undirected rows of a = edge_row[t] and b = colidx[t] (0 when b == 0;
//   row v starts at urowptr[v-1], 0 for v = 0, and holds udeg[v] strictly
//   ascending entries of ucolidx); then alive[t] &= s[t] >= cur_k - 2, each
//   death adding one to the slot's `changed` count; a live slot counts one
//   iteration, and latches when nothing changed;
//   then the level bookkeeping of build_peel's converged branch (trussness,
//   `left` per slot, retire, cur_k advance, kmax, levels, edges) and the
//   prune-ahead against the advanced threshold, which also records the
//   carried deaths for the next launch (optional; see below).
// Slot s owns lanes [s * slot_nnz, (s+1) * slot_nnz).
// Every launch also adds its counts to the level-counts vector (int64; its
// slots are kUpdateTrips and on, below).
//
// The plain version (fused_level_torch, the reference's _level_kernel)
// recomputes every lane's support on every trip.  Only alive lanes of live
// slots can change the state, so only they are computed here:
// - the support of a lane that is not alive is never read: the prune only
//   touches alive lanes, and `support` comes out masked by alive_next (a
//   frozen-live lane is never alive);
// - a slot that latched on trip i computed s on exactly the alive set that
//   trip i left (nothing changed), so every later trip of the launch would
//   compute the same s again: its lanes leave the worklist;
// - a slot that is done (retired) on entry is a fixed point.  The trip on
//   which it converged computed s on exactly its final alive set, and
//   retirement does not advance cur_k, so its prune-ahead kept every lane
//   and its support in is that s masked by alive; any trip of this launch
//   would compute the same.  Its alive, support and trussness are copied
//   from the state in (supp_in).  The one exception: a launch whose every
//   slot is done runs no trip, and the plain version then prunes ahead
//   with s = 0; so does this kernel.  A slot that is done from
//   init_peel_state has no alive lane and support 0: the copy holds too.
//
// A launch walks only the slots that can change (walk, in shared memory):
// the slots not done at launch, whose rows it compacts and whose lanes it
// peels, then the done slots whose final lanes the state out does not hold
// yet, which it copies; every slot when all are done.  Rows and lanes of
// other slots are neither read nor written.  The state out holds a done
// slot's final lanes when `held` and its done vector (read by every CTA
// before CTA 0 overwrites it) marks the slot: the wrapper sets `held` when
// the state out is the one the launch before last of the same level loop
// returned.  Done only grows within a loop, and the launch that retires a
// slot writes its final lanes, so by induction the state a loop ends on
// holds every slot's final lanes; a loop copies its done slots into each of
// its two states once.  With a fresh state out, every done slot is copied.
//
// Bound: the level reads each input once (the problem, the state, frozen,
// ftruss) and writes each output once, about 4 * (2 nnzp + 2 unnzp + 2 n)
// + 23 nnzp bytes, over device memory (nnzp and unnzp counting the lanes of
// walked slots alone); the intersection steps of each inner
// trip's alive set over the integer peak are below that.  The kernel is
// limited instead by the latency of data-dependent probes into rows that
// mostly sit in L2, and by the fixed cost of two grid barriers a trip.
// What the design does about it:
// - phase (a) of a trip is one of two things.  A count: every lane of the
//   worklist intersects its two rows (always on the first trip of a launch
//   handed no carry).  Or an update from the deaths of the trip before, D:
//   trip i+1's support
//   of a surviving lane e is trip i's minus the triangles of e that lost an
//   edge in D, since both count triangles whose other two edges are alive
//   or frozen-live and A(i+1) is A(i) minus D.  Each dying lane d = (x, y)
//   intersects its two rows, whose entries are still present (alive,
//   frozen-live or dying; a dying entry is marked 2 in calive by the prune
//   and cleared to 0 by the next trip's prune, after the update that reads
//   it); for each c found, with f = (x, c) and g = (y, c), the triangle is
//   skipped when f or g is dying with a smaller lane than d (that lane owns
//   it, so each lost triangle is taken once), and otherwise each of f and g
//   that is an alive survivor loses 1 (an integer atomic on supp: exact in
//   any order; frozen-live, dying and dead lanes never move).  A death
//   costs about one intersection of its pair, so a trip updates when its
//   dying lanes are at most its surviving lanes, and counts otherwise: a
//   rule every CTA applies to the same list counters after the prune's
//   barrier.  Each compacted entry keeps the lane it stands for (clane);
//   the prune appends its deaths to a death list per trip parity, split as
//   the worklists are.  Either way the supports, and so the state, are bit
//   for bit those of a count;
// - the same update carries across launches.  Every live slot of a launch
//   latches (inner_limit never cuts it short), so its supports out are
//   exact on its converged effective set E (alive or frozen-live at
//   cur_k).  The next launch's E' is E less the carried deaths: in each
//   slot that advanced, the lanes the prune-ahead killed and the frozen
//   lanes with ftruss == cur_k, which leave the frozen-live set at cur_k +
//   1.  The prune-ahead, which visits every lane anyway, appends them to a
//   list and writes every lane's entry flag for the next launch into a lane
//   map (present: alive or frozen-live at cur_k + 1; dying: carried;
//   absent) (carry_*, out).  A launch handed that carry (carry_*_in: the
//   launch before in the same level loop, on the state it returned)
//   compacts its rows by the map alone, one byte an entry, so the carried
//   entries come out dying; it seeds its worklist's supports from supp_in,
//   and takes the list as the first trip's death list under the same rule
//   (update when the deaths are at most the worklist, count otherwise);
//   the first trip's prune clears them.  A
//   frozen leaver is exact like any death: it was in E and is not in E',
//   it is never an alive survivor, and its triangles come off their alive
//   survivors once, by the lowest dying lane.  A launch with no carry (a
//   level loop's first, or a state from anywhere else) counts;
// - a worklist: at launch, the alive lanes of live slots are compacted
//   (warp ballots, one atomic per warp) into a list in scratch; each trip's
//   prune phase writes the survivors into the other of two lists, so a trip
//   costs what its alive set costs, and dead tiles, retired and latched
//   slots cost nothing;
// - warps claim `block` list entries per atomic on a cursor per trip
//   parity (fewer when the list is too short to give every warp `block`),
//   so no CTA holds the grid at a barrier with a fixed share;
// - the shorter of the two rows is walked (bsearch probes the longer);
// - a lane whose shorter (compacted) row has more than split_row entries
//   is split into split_ways chunks of that row, separate work items that
//   several warps take; on a count they add into acc[t] with integer
//   atomics (exact in any order), which is why the prune is a phase of its
//   own behind a grid barrier; an update's decrements go to supp directly,
//   and so do those of a split dying lane's chunks;
// - each launch first compacts every undirected row to its entries that
//   are alive or frozen-live (a warp a row, into ccol/calive/cdeg): at
//   high k the rows of the surviving core are mostly dead entries, so the
//   walks and searches of every trip are over what is left at launch.
//   Within the launch a death marks the lane's two compacted entries dying
//   (two binary searches) and the next trip's prune clears them;
// - the per-slot latch is kept in every CTA's shared memory, computed from
//   the same counts, so all CTAs agree on when the loop ends.
//
// schedule "bsearch": the items a warp claimed are flattened into one run
// of probes (a warp scan of their chunk lengths), one probe a thread: the
// entry of the shorter row is binary-searched in the longer row, so short
// rows do not leave most of the warp idle.  schedule "compare": one item
// at a time, a warp-wide merge of the chunk of the shorter row with the
// longer row, 32 entries of each compared all against all by shuffles,
// advancing the side whose window ends lower, and jumping (binary search)
// over a run of one row that lies wholly below the other's window.  Both
// count every match exactly once, so the state is bit-identical for every
// block x schedule.  An update walks the flattened probes under both.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "intersect.cuh"

namespace cg = cooperative_groups;

namespace {

using intersect::count_flat;
using intersect::kFull;
using intersect::kWarp;
using intersect::lower_bound;
using intersect::match_flat;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kUnroll = 4;  // groups of 32 row entries per step of the compaction

// `counts` (int32, zeroed by the wrapper) holds the item cursors of the two
// trip parities first (64-bit, at the front so that they are 8-byte
// aligned: warps claim past the end of the list, so the cursor outgrows
// the item count), then changed[2][S] and left[S], then the lengths of the
// two worklists (unsplit, split) per parity, then those of the two death
// lists.
constexpr int kCursorWords = 4;
enum : int { kRegCount = 0, kSplitCount = 2, kDeathCounts = 4 };
// The slots of the level-counts vector, in the order of the Python table
// repro_torch.kernels.peel_fused.LevelCounts.
enum : int { kUpdateTrips = 0, kCountedLanes = 1, kCarried = 2, kAliveLanes = 3, kWalkedLanes = 4 };
// Per-slot int32 words of dynamic shared memory: latch, iters, left_cta and
// walk (see the kernel).
constexpr int kSlotWords = 4;
// calive: a compacted entry that is absent (dead), present (alive or
// frozen-live), or dying (killed by the last prune; present to the update
// that reads its death, absent to a count).
enum : uint8_t { kAbsent = 0, kPresent = 1, kDying = 2 };

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
  const int32_t* __restrict__ supp_in;
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
  // The state out.  `alive` and `supp` are also working buffers, read by
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
  // Scratch: the rows compacted at launch, ccol, calive and clane (unnzp;
  // row v keeps its start, urowptr[v-1], and holds cdeg[v] entries; clane
  // the lane of each entry); lists and deaths (2 x nnzp each: per parity,
  // unsplit lanes from the front, split lanes from the back); acc (nnzp,
  // split lanes' sums); counts (see above); trip_log (2 x trip_log_len,
  // optional: per trip, the worklist's unsplit and split lanes).
  int32_t* ccol;
  uint8_t* calive;
  int32_t* clane;
  int32_t* cdeg;
  int32_t* lists;
  int32_t* deaths;
  int32_t* acc;
  int32_t* counts;
  int32_t* trip_log;
  int64_t* stamps;        // optional: six %globaltimer readings of CTA 0 (ns)
  int64_t* level_counts;  // the counts the launch adds to (kUpdateTrips and on)
  // Optional: the carried deaths of the launch before, on this state (in:
  // the list of carry_len_in[0] lanes, and carry_flags_in, each lane's
  // compacted-entry flag at this launch: absent, present or dying), and
  // those this launch hands the next (out).  In and out may be the same
  // buffers: the ins are read before the first trip and the outs written by
  // the prune-ahead, with grid barriers between.
  const int32_t* carry_lanes_in;
  const uint8_t* carry_flags_in;
  const int32_t* carry_len_in;
  int32_t* carry_lanes;
  uint8_t* carry_flags;
  int32_t* carry_len;
  int64_t nnzp;
  int64_t unnzp;
  int32_t nrows;
  int32_t slot_nnz;
  int32_t num_slots;
  int32_t block;
  int32_t inner_limit;
  int32_t split_row;
  int32_t split_ways;
  int32_t trip_log_len;
  int32_t held;  // 1: the state out holds the final lanes of the slots its done marks
};

// CTA 0's clock at: entry (0), rows compacted (1), first worklist built
// (2), inner loop done (3), bookkeeping done (4), exit (5).
__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[i] = t;
  }
}

__device__ __forceinline__ int32_t row_start(const Args& a, int32_t v) {
  return v > 0 ? a.urowptr[v - 1] : 0;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int offset = kWarp / 2; offset > 0; offset /= 2) v += __shfl_down_sync(kFull, v, offset);
  return v;
}

// One work item: a chunk of the shorter row of lane t's pair, to be
// intersected with the longer row.  n == 0 for nothing to do.
struct Item {
  int32_t t;      // the lane; -1 when the item is skipped
  int32_t s0;     // first entry of the chunk (index into ccol)
  int32_t n;      // entries in the chunk
  int32_t l0;     // start of the longer row
  int32_t dl;     // its length
  int32_t whole;  // 1: the item is the whole lane (store), 0: a chunk (add)
};

// Item q of the trip's worklist (`list` is this parity's list).
__device__ __forceinline__ Item resolve(const Args& a, const int32_t* list, int64_t q, int32_t n_reg,
                        const int32_t* latch) {
  Item it{-1, 0, 0, 0, 0, 1};
  int32_t t, chunk = 0, ways = 1;
  // Lists were written by other CTAs during the launch: read through L2.
  if (q < n_reg) {
    t = __ldcg(list + q);
  } else {
    const int64_t r = q - n_reg;
    t = __ldcg(list + a.nnzp - 1 - r / a.split_ways);
    chunk = static_cast<int32_t>(r % a.split_ways);
    ways = a.split_ways;
  }
  if (latch[t / a.slot_nnz]) return it;  // latched: its s is final for this launch
  it.t = t;
  it.whole = ways == 1;
  const int32_t b = a.colidx[t];
  if (b == 0) return it;
  const int32_t ra = a.edge_row[t];
  const int32_t da = a.cdeg[ra], db = a.cdeg[b];
  const bool a_short = da <= db;
  const int32_t ds = a_short ? da : db;
  const int32_t s0 = row_start(a, a_short ? ra : b);
  it.l0 = row_start(a, a_short ? b : ra);
  it.dl = a_short ? db : da;
  const int32_t len = (ds + ways - 1) / ways;
  const int32_t lo = chunk * len;
  const int32_t hi = min(lo + len, ds);
  it.s0 = s0 + lo;
  it.n = max(hi - lo, 0);
  return it;
}

// compare: warp-wide merge of ccol[s0, s0 + n) with the row [l0, l0 + dl).
__device__ __forceinline__ int count_merge(const Args& a, const Item& it, int lane) {
  const int32_t* col = a.ccol;
  int32_t ia = 0, ib = 0;
  int count = 0;
  while (ia < it.n && ib < it.dl) {  // warp-uniform
    const int32_t na = min(kWarp, it.n - ia), nb = min(kWarp, it.dl - ib);
    const int32_t va = lane < na ? col[it.s0 + ia + lane] : INT_MAX;
    const int32_t vb = lane < nb ? col[it.l0 + ib + lane] : INT_MAX;
    const int32_t amin = __shfl_sync(kFull, va, 0), amax = __shfl_sync(kFull, va, na - 1);
    const int32_t bmin = __shfl_sync(kFull, vb, 0), bmax = __shfl_sync(kFull, vb, nb - 1);
    // A run wholly below the other window holds no uncounted match: jump it.
    if (amax < bmin) {
      ia = lower_bound(col, it.s0, ia + na, it.n, bmin);
      continue;
    }
    if (bmax < amin) {
      ib = lower_bound(col, it.l0, ib + nb, it.dl, amin);
      continue;
    }
    // Entries not present, or past the window, compare as -1 (a) and -2
    // (b): never equal.
    const int32_t ma = (lane < na && __ldcg(a.calive + it.s0 + ia + lane) == kPresent) ? va : -1;
    const int32_t mb = (lane < nb && __ldcg(a.calive + it.l0 + ib + lane) == kPresent) ? vb : -2;
#pragma unroll
    for (int k = 0; k < kWarp; ++k) count += ma == __shfl_sync(kFull, mb, k);
    if (amax <= bmax) ia += na;
    if (bmax <= amax) ib += nb;
  }
  return count;
}

__device__ __forceinline__ void put_result(const Args& a, const Item& it, int count) {
  if (it.t < 0) return;
  if (it.whole) a.supp[it.t] = count;
  else if (count) atomicAdd(a.acc + it.t, count);
}

// The survivors of one dying lane d's triangle, found by the probe of
// entry u whose match is entry w (see the top: the update).
__device__ __forceinline__ void lose_triangle(const Args& a, int32_t d, int32_t u, uint8_t flag_u,
                                              int32_t w) {
  const uint8_t flag_w = __ldcg(a.calive + w);
  if (flag_w == kAbsent) return;
  const int32_t f = __ldcg(a.clane + u), g = __ldcg(a.clane + w);
  // A dying edge with a smaller lane owns the triangle.
  if ((flag_u == kDying && f < d) || (flag_w == kDying && g < d)) return;
  if (flag_u == kPresent && __ldcg(a.alive + f)) atomicSub(a.supp + f, 1);
  if (flag_w == kPresent && __ldcg(a.alive + g)) atomicSub(a.supp + g, 1);
}

// Items [q0, q1) of the death list, claimed by this warp; q1 - q0 <= 32.
__device__ void run_updates(const Args& a, const int32_t* list, int64_t q0, int64_t q1,
                            int32_t n_reg, const int32_t* latch, int lane) {
  const int n_items = static_cast<int>(q1 - q0);
  Item mine{-1, 0, 0, 0, 0, 1};
  if (lane < n_items) mine = resolve(a, list, q0 + lane, n_reg, latch);
  // Flags are written by other CTAs during the launch: read via L2.
  match_flat<true>(a.ccol, a.calive, mine.s0, mine.n, mine.l0, mine.dl, mine.t, lane,
                   [&](int32_t d, int32_t u, uint8_t flag_u, int32_t w) {
                     lose_triangle(a, d, u, flag_u, w);
                   });
}

// Items [q0, q1) of the worklist, claimed by this warp; q1 - q0 <= 32.
template <bool kBsearch>
__device__ void run_items(const Args& a, const int32_t* list, int64_t q0, int64_t q1,
                          int32_t n_reg, const int32_t* latch, int32_t* warp_counts, int lane) {
  const int n_items = static_cast<int>(q1 - q0);
  Item mine{-1, 0, 0, 0, 0, 1};
  if (lane < n_items) mine = resolve(a, list, q0 + lane, n_reg, latch);
  if (kBsearch) {
    // One probe a thread over the items' chunks, flattened.  The flags
    // (calive) are cleared by other CTAs during the launch: read via L2.
    count_flat<true>(a.ccol, a.calive, mine.s0, mine.n, mine.l0, mine.dl, warp_counts, lane);
    if (lane < n_items) put_result(a, mine, warp_counts[lane]);
    __syncwarp();
  } else {
    for (int k = 0; k < n_items; ++k) {
      Item it;
      it.t = __shfl_sync(kFull, mine.t, k);
      it.s0 = __shfl_sync(kFull, mine.s0, k);
      it.n = __shfl_sync(kFull, mine.n, k);
      it.l0 = __shfl_sync(kFull, mine.l0, k);
      it.dl = __shfl_sync(kFull, mine.dl, k);
      it.whole = __shfl_sync(kFull, mine.whole, k);
      const int count = warp_sum(count_merge(a, it, lane));
      if (lane == 0) put_result(a, it, count);
    }
  }
}

// Appends lane t (where `keep`) to the parity-`p` list of `lists` (the
// worklists or the death lists, whose lengths are at `ctr`), unsplit lanes
// at the front and split lanes at the back; one atomic per warp and side.
// Warp-uniform call.
__device__ __forceinline__ void append(const Args& a, int32_t* lists, int32_t* ctr, int p,
                                       bool keep, bool split, int32_t t, int lane) {
  int32_t* list = lists + p * a.nnzp;
  const unsigned lt = (1u << lane) - 1;
  const unsigned m_reg = __ballot_sync(kFull, keep && !split);
  const unsigned m_spl = __ballot_sync(kFull, keep && split);
  int32_t base_reg = 0, base_spl = 0;
  if (lane == 0) {
    if (m_reg) base_reg = atomicAdd(ctr + kRegCount + p, __popc(m_reg));
    if (m_spl) base_spl = atomicAdd(ctr + kSplitCount + p, __popc(m_spl));
  }
  base_reg = __shfl_sync(kFull, base_reg, 0);
  base_spl = __shfl_sync(kFull, base_spl, 0);
  if (keep && !split) list[base_reg + __popc(m_reg & lt)] = t;
  if (keep && split) list[a.nnzp - 1 - (base_spl + __popc(m_spl & lt))] = t;
}

// Whether lane t's pair is split: its shorter compacted row exceeds
// split_row.
__device__ __forceinline__ bool is_split(const Args& a, int32_t t) {
  const int32_t b = a.colidx[t];
  if (b == 0) return false;
  return min(a.cdeg[a.edge_row[t]], a.cdeg[b]) > a.split_row;
}

// Sets the two compacted entries of the directed lane t = (a, b) to `flag`.
__device__ void mark_undirected(const Args& a, int32_t t, uint8_t flag) {
  const int32_t b = a.colidx[t];
  if (b == 0) return;
  const int32_t ra = a.edge_row[t];
  const int32_t a0 = row_start(a, ra), da = a.cdeg[ra];
  const int32_t b0 = row_start(a, b), db = a.cdeg[b];
  const int32_t i = lower_bound(a.ccol, a0, 0, da, b);
  if (i < da && a.ccol[a0 + i] == b) a.calive[a0 + i] = flag;
  const int32_t j = lower_bound(a.ccol, b0, 0, db, ra);
  if (j < db && a.ccol[b0 + j] == ra) a.calive[b0 + j] = flag;
}

// Appends the slots s < S with take(s) to list[n, ...), in order, and
// returns the new length.  Warp-uniform call.
template <class Take>
__device__ int32_t collect_slots(int32_t S, int32_t* list, int32_t n, int lane, Take take) {
  for (int32_t s0 = 0; s0 < S; s0 += kWarp) {
    const int32_t s = s0 + lane;
    const bool in = s < S && take(s);
    const unsigned m = __ballot_sync(kFull, in);
    if (in) list[n + __popc(m & ((1u << lane) - 1))] = s;
    n += __popc(m);
  }
  return n;
}

// Whether any slot is still live; also a CTA barrier over latch.
__device__ __forceinline__ bool any_live(const Args& a, const int32_t* latch) {
  int live = 0;
  for (int s = threadIdx.x; s < a.num_slots; s += blockDim.x) live |= !latch[s] && !a.done_in[s];
  return __syncthreads_or(live) != 0;
}

// CTAs per SM asked of the compiler.  The probes of bsearch are latency
// bound and gain from more warps in flight (8 CTAs, 32 registers a thread,
// a few spills) more than they lose; the merge of compare spills too much
// to gain, so it keeps 64 registers (4 CTAs).
template <bool kBsearch>
__global__ void __launch_bounds__(kThreads, kBsearch ? 8 : 4) peel_fused_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int32_t smem[];
  __shared__ int32_t warp_counts_all[kWarps][kWarp];
  __shared__ int32_t walk_len[2];    // the slots walked: not done at launch, all
  const int32_t S = a.num_slots;
  int32_t* latch = smem;             // per slot: converged this launch
  int32_t* iters = smem + S;         // per slot: iterations so far
  int32_t* left_cta = smem + 2 * S;  // per slot: this CTA's alive lanes
  int32_t* walk = smem + 3 * S;      // the slots this launch walks (see the top)
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // Warp-uniform strides for loops that ballot.
  const int64_t wbase = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kWarp;
  const int64_t wstride = nthreads;
  int32_t* changed_all = a.counts + kCursorWords;  // changed[2][S]
  int32_t* left = changed_all + 2 * S;
  int32_t* ctr = changed_all + 3 * S;
  int32_t* dctr = ctr + kDeathCounts;
  unsigned long long* cursor = reinterpret_cast<unsigned long long*>(a.counts);
  int32_t* warp_counts = warp_counts_all[warp];
  stamp(a, 0);

  // Phase 0: the slots to walk; the working alive copy; every undirected
  // row of a slot that is not done compacted to its entries alive or
  // frozen-live at launch, and the carried deaths' entries, dying (entries
  // keep their order, so rows stay sorted), with their lanes; then the
  // first worklist, and the carried deaths as the first trip's death list.
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    latch[s] = 0;
    iters[s] = a.iters_in[s];
    left_cta[s] = 0;
  }
  if (warp == 0) {
    const int32_t n_live = collect_slots(S, walk, 0, lane, [&](int32_t s) { return !a.done_in[s]; });
    int32_t n = S;
    if (n_live > 0) {
      n = collect_slots(S, walk, n_live, lane,
                        [&](int32_t s) { return a.done_in[s] && !(a.held && a.done[s]); });
    } else {
      for (int32_t s = lane; s < S; s += kWarp) walk[s] = s;
    }
    if (lane == 0) {
      walk_len[0] = n_live;
      walk_len[1] = n;
    }
  }
  __syncthreads();
  const int32_t n_live = walk_len[0], n_walk = walk_len[1];
  for (int32_t w = 0; w < n_walk; ++w) {
    const int64_t base = static_cast<int64_t>(walk[w]) * a.slot_nnz;
    for (int64_t i = tid; i < a.slot_nnz; i += nthreads) a.alive[base + i] = a.alive_in[base + i];
  }
  const unsigned lt = (1u << lane) - 1;
  // The rows of the slots not done.  Where the rows split evenly into
  // slots (an aligned pack), slot s holds rows 1 + s * slot_rows on (row 0
  // holds no entry); otherwise every row is visited.  A warp takes 32 rows
  // at a time, strided over the grid's warps so that every warp gets a
  // share of each slot's rows: lane i reads its row's extent and whether
  // its slot is done (the rows of a done slot are never read); the warp
  // then compacts the rows with work one after another.
  const int32_t slot_rows = (a.nrows - 1) % S == 0 ? (a.nrows - 1) / S : 0;
  const int64_t n_rows = slot_rows > 0 ? static_cast<int64_t>(n_live) * slot_rows : a.nrows;
  const int64_t gwarp = wbase / kWarp, nwarps = wstride / kWarp;
  for (int64_t v0 = gwarp; v0 < n_rows; v0 += kWarp * nwarps) {  // warp-uniform
    const int64_t r = v0 + lane * nwarps;
    int32_t mine = 0, r0 = 0, d = 0;
    if (r < n_rows) {
      const int32_t ri = static_cast<int32_t>(r);
      mine = slot_rows > 0 ? 1 + walk[ri / slot_rows] * slot_rows + ri % slot_rows : ri;
      r0 = row_start(a, mine);
      d = a.udeg[mine];
      if (d > 0) {  // a row lies in one slot: its first entry's
        const int32_t e0 = a.u2d[r0];
        if (e0 < a.nnzp && a.done_in[e0 / a.slot_nnz]) d = 0;
      }
      if (d == 0) a.cdeg[mine] = 0;
    }
    for (unsigned rows = __ballot_sync(kFull, d > 0); rows; rows &= rows - 1) {
      const int src = __ffs(rows) - 1;
      const int32_t rs = __shfl_sync(kFull, r0, src), n = __shfl_sync(kFull, d, src);
      int32_t kept = 0;
      // kUnroll groups of 32 entries a step, their loads independent of each
      // other, so that a hub row is not one long chain of dependent loads.
      for (int32_t i0 = 0; i0 < n; i0 += kUnroll * kWarp) {
        uint8_t on[kUnroll];
        int32_t c[kUnroll], e[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int32_t i = i0 + j * kWarp + lane;
          e[j] = i < n ? a.u2d[rs + i] : static_cast<int32_t>(a.nnzp);
          c[j] = i < n ? a.ucolidx[rs + i] : 0;
          on[j] = kAbsent;
          if (e[j] < a.nnzp && a.carry_flags_in != nullptr) {
            on[j] = a.carry_flags_in[e[j]];
          } else if (e[j] < a.nnzp) {
            const bool al = a.alive_in[e[j]], fz = a.frozen[e[j]];
            if (al || (fz && a.ftruss[e[j]] >= a.cur_k_in[e[j] / a.slot_nnz])) on[j] = kPresent;
          }
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const unsigned m = __ballot_sync(kFull, on[j] != kAbsent);
          if (on[j] != kAbsent) {
            const int32_t at = rs + kept + __popc(m & lt);
            a.ccol[at] = c[j];
            a.calive[at] = on[j];
            a.clane[at] = e[j];
          }
          kept += __popc(m);
        }
      }
      if (lane == src) a.cdeg[mine] = kept;
    }
  }
  grid.sync();
  stamp(a, 1);
  // With a carry, the first trip may update: its lanes start from the
  // supports in, which are exact on the alive set the carry was taken from.
  const bool has_carry = a.carry_lanes_in != nullptr;
  for (int32_t w = 0; w < n_live; ++w) {
    const int64_t base = static_cast<int64_t>(walk[w]) * a.slot_nnz;
    for (int64_t i0 = wbase; i0 < a.slot_nnz; i0 += wstride) {  // warp-uniform
      const int64_t t = base + i0 + lane;
      bool keep = false, split = false;
      if (i0 + lane < a.slot_nnz) {
        keep = a.alive_in[t];
        split = keep && is_split(a, static_cast<int32_t>(t));
        if (split) a.acc[t] = 0;
        if (keep && has_carry) a.supp[t] = a.supp_in[t];
      }
      append(a, a.lists, ctr, 0, keep, split, static_cast<int32_t>(t), lane);
    }
  }
  // The carried deaths go to the death list that the first trip reads
  // (parity 1), split by the rows compacted above.
  const int64_t n_carry = has_carry ? *a.carry_len_in : 0;
  for (int64_t q0 = wbase; q0 < n_carry; q0 += wstride) {  // warp-uniform
    const int64_t q = q0 + lane;
    const int32_t t = q < n_carry ? a.carry_lanes_in[q] : 0;
    append(a, a.deaths, dctr, 1, q < n_carry, q < n_carry && is_split(a, t), t, lane);
  }
  grid.sync();
  // Every CTA has read the carry's length; the prune-ahead refills it.  The
  // first worklist holds each alive lane of a live slot once.
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (a.carry_len != nullptr) *a.carry_len = 0;
    a.level_counts[kAliveLanes] += __ldcg(ctr + kRegCount) + __ldcg(ctr + kSplitCount);
  }
  stamp(a, 2);

  int32_t trips = 0, updates = 0;
  bool first_updated = false;  // the first trip updated from the carry
  int64_t counted = 0;         // this thread's lanes, pruned after a count
  // any_live first: its barrier also orders the last latch update before
  // the reads below.
  while (any_live(a, latch) && trips < a.inner_limit) {
    const int p = trips & 1;
    const int32_t* list = a.lists + p * a.nnzp;
    const int32_t n_reg = __ldcg(ctr + kRegCount + p);
    const int32_t n_split = __ldcg(ctr + kSplitCount + p);
    // The last trip's deaths, in the death list of the other parity.
    const int32_t* dead = a.deaths + (p ^ 1) * a.nnzp;
    const int32_t d_reg = __ldcg(dctr + kRegCount + (p ^ 1));
    const int32_t d_split = __ldcg(dctr + kSplitCount + (p ^ 1));
    // Every CTA reads the same counters: the choice is the grid's.  The
    // first trip has deaths to update from only when a carry came in.
    const bool update = (trips > 0 || has_carry) &&
                        static_cast<int64_t>(d_reg) + d_split <= static_cast<int64_t>(n_reg) + n_split;
    updates += update;
    if (trips == 0) first_updated = update;
    if (a.trip_log != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && trips < a.trip_log_len) {
      a.trip_log[2 * trips] = n_reg;
      a.trip_log[2 * trips + 1] = n_split;
    }

    // (a) supports, by a count of the worklist or an update from the death
    // list: warps claim up to `block` items at a time; fewer when the list
    // is short, so that every warp of the grid gets a share.
    const int32_t* items = update ? dead : list;
    const int32_t i_reg = update ? d_reg : n_reg;
    const int64_t n_items = i_reg + static_cast<int64_t>(update ? d_split : n_split) * a.split_ways;
    const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
    int64_t share = (n_items + n_warps - 1) / n_warps;
    if (share > a.block) share = a.block;
    if (share < 1) share = 1;
    const int32_t claim = static_cast<int32_t>(share);
    while (true) {
      unsigned long long claimed = 0;
      if (lane == 0) claimed = atomicAdd(cursor + p, static_cast<unsigned long long>(claim));
      const int64_t base = static_cast<int64_t>(__shfl_sync(kFull, claimed, 0));
      if (base >= n_items) break;
      const int64_t end = min(base + claim, n_items);
      for (int64_t q = base; q < end; q += kWarp) {
        if (update)
          run_updates(a, items, q, min(q + kWarp, end), i_reg, latch, lane);
        else
          run_items<kBsearch>(a, items, q, min(q + kWarp, end), i_reg, latch, warp_counts, lane);
      }
    }
    grid.sync();

    // (b) the prune: survivors go to the other worklist, deaths to this
    // parity's death list, their entries marked dying; the last trip's
    // deaths, read by (a), are cleared.
    const int64_t d_lanes = d_reg + static_cast<int64_t>(d_split);
    for (int64_t q = tid; q < d_lanes; q += nthreads)
      mark_undirected(a, __ldcg(q < d_reg ? dead + q : dead + a.nnzp - 1 - (q - d_reg)), kAbsent);
    int32_t* changed = changed_all + p * S;
    const int64_t n_lanes = n_reg + static_cast<int64_t>(n_split);
    for (int64_t q0 = wbase; q0 < n_lanes; q0 += wstride) {  // warp-uniform
      const int64_t q = q0 + lane;
      bool keep = false, split = false, dies = false;
      int32_t t = 0;
      if (q < n_lanes) {
        split = q >= n_reg;
        t = __ldcg(split ? list + a.nnzp - 1 - (q - n_reg) : list + q);
        const int32_t slot = t / a.slot_nnz;
        if (!latch[slot]) {
          counted += !update;  // a lane whose support this trip counted
          int32_t s;
          if (split && !update) {
            s = __ldcg(a.acc + t);
            a.supp[t] = s;
            a.acc[t] = 0;
          } else {
            s = __ldcg(a.supp + t);
          }
          keep = s >= a.cur_k_in[slot] - 2;
          if (!keep) {
            a.alive[t] = 0;
            atomicAdd(changed + slot, 1);
            dies = !(a.frozen[t] && a.ftruss[t] >= a.cur_k_in[slot]);
            if (dies) mark_undirected(a, t, kDying);
          }
        }
      }
      append(a, a.lists, ctr, p ^ 1, keep, split, t, lane);
      append(a, a.deaths, dctr, p, dies, split, t, lane);
    }
    grid.sync();

    // (c) the per-slot latch, identically in every CTA.  CTA 0 zeroes the
    // other parity of `changed` (every CTA read it last trip, before the
    // barrier above; the next trip adds to it only after a barrier), this
    // parity's worklist counters and cursor and the other parity's death
    // list counters (read this trip, before the barrier above; refilled on
    // the next trip, after a barrier).
    int32_t* other = changed_all + (p ^ 1) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int32_t ch = __ldcg(changed + s);
      if (!latch[s] && !a.done_in[s]) {
        ++iters[s];
        if (ch == 0) latch[s] = 1;
      }
      if (blockIdx.x == 0) other[s] = 0;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctr[kRegCount + p] = 0;
      ctr[kSplitCount + p] = 0;
      dctr[kRegCount + (p ^ 1)] = 0;
      dctr[kSplitCount + (p ^ 1)] = 0;
      cursor[p] = 0;
    }
    ++trips;
  }

  stamp(a, 3);

  // Level bookkeeping: trussness of converged slots, and `left` per slot.
  for (int32_t w = 0; w < n_walk; ++w) {
    const int32_t slot = walk[w];
    const int64_t base = static_cast<int64_t>(slot) * a.slot_nnz;
    const bool conv = latch[slot] && !a.done_in[slot];
    const int32_t k = a.cur_k_in[slot];
    int32_t n_alive = 0;
    for (int64_t i = tid; i < a.slot_nnz; i += nthreads) {
      const int64_t t = base + i;
      const bool al = __ldcg(a.alive + t) != 0;
      a.truss[t] = (conv && al) ? k : a.truss_in[t];
      n_alive += al;
    }
    if (n_alive) atomicAdd(left_cta + slot, n_alive);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    if (left_cta[s]) atomicAdd(left + s, left_cta[s]);
  grid.sync();
  stamp(a, 4);

  // Retire / advance, then prune ahead against the new threshold.  In a
  // slot that advanced, the lanes that leave the effective set (alive or
  // frozen-live) here are the carried deaths: the pruned lanes, and the
  // frozen lanes whose trussness is the level just peeled.
  for (int32_t w = 0; w < n_walk; ++w) {
    const int32_t slot = walk[w];
    const int64_t base = static_cast<int64_t>(slot) * a.slot_nnz;
    const bool was_done = a.done_in[slot] != 0;
    const bool conv = latch[slot] && !was_done;
    const bool nonempty = __ldcg(left + slot) > 0;
    const bool retired = conv && (!nonempty || a.single[slot]);
    const bool advanced = conv && !retired;
    const int32_t k_in = a.cur_k_in[slot];
    const int32_t k_next = k_in + (advanced ? 1 : 0);
    const bool record = a.carry_lanes != nullptr && advanced;
    for (int64_t i0 = wbase; i0 < a.slot_nnz; i0 += wstride) {  // warp-uniform
      const int64_t t = base + i0 + lane;
      bool carried = false;
      if (i0 + lane < a.slot_nnz) {
        const int32_t s_t = was_done ? (trips > 0 ? a.supp_in[t] : 0) : __ldcg(a.supp + t);
        const bool al = __ldcg(a.alive + t) != 0;
        const bool keep = al && s_t >= k_next - 2;
        a.alive[t] = keep;
        a.supp[t] = keep ? s_t : 0;
        if (record) {
          const int32_t ft = a.frozen[t] ? a.ftruss[t] : INT_MIN;
          const bool present = keep || ft >= k_next;
          carried = (al || ft >= k_in) && !present;
          a.carry_flags[t] = present ? kPresent : (carried ? kDying : kAbsent);
        }
      }
      // The carry is one flat list: unsplit (front) only.  Most warps carry
      // nothing and skip the append.
      if (record && __any_sync(kFull, carried))
        append(a, a.carry_lanes, a.carry_len, 0, carried, false, static_cast<int32_t>(t), lane);
    }
  }
  // One atomic a warp.
  for (int offset = kWarp / 2; offset > 0; offset /= 2)
    counted += __shfl_down_sync(kFull, counted, offset);
  if (lane == 0 && counted)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.level_counts + kCountedLanes),
              static_cast<unsigned long long>(counted));
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
    if (threadIdx.x == 0) {
      a.titers[0] = a.titers_in[0] + trips;
      a.level_counts[kUpdateTrips] += updates;
      a.level_counts[kCarried] += first_updated;
      a.level_counts[kWalkedLanes] += static_cast<int64_t>(n_walk) * a.slot_nnz;
    }
  }
  stamp(a, 5);
}

template <bool kBsearch>
cudaError_t launch(Args& args, int device, cudaStream_t stream, cudaEvent_t begin,
                   cudaEvent_t end) {
  const void* fn = reinterpret_cast<const void*>(&peel_fused_kernel<kBsearch>);
  const size_t smem = kSlotWords * sizeof(int32_t) * static_cast<size_t>(args.num_slots);
  cudaError_t err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return err;
  if (smem > 40 * 1024 &&
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
  int64_t grid = static_cast<int64_t>(per_sm) * sms;
  const int64_t enough = (args.nnzp + kThreads - 1) / kThreads;  // a lane a thread
  if (grid > enough) grid = enough;
  if (grid < 1) grid = 1;
  void* params[] = {&args};
  // The timing events bracket the launch call alone, after the queries above.
  if (begin != nullptr && (err = cudaEventRecord(begin, stream)) != cudaSuccess) return err;
  if ((err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(kThreads),
                                         params, smem, stream)) != cudaSuccess)
    return err;
  return end != nullptr ? cudaEventRecord(end, stream) : cudaSuccess;
}

}  // namespace

extern "C" {

// Launches one level on `stream`; returns the cudaError_t of the launch
// (0 = success).  Pointers in the order of struct Args; `counts` must come
// zeroed and `level_counts` must not be null; trip_log and stamps may be
// null, and so may the three carry pointers in (no carry: the first trip
// counts) and the three out (none recorded).  `held` != 0 only when the
// state out is the one the launch before last of the same level loop
// returned (see the top); 0 copies every done slot.  `begin`
// and `end` (cudaEvent_t, or null) are recorded on `stream` just before
// and just after the launch.
int peel_fused_launch(const void* colidx, const void* edge_row, const void* urowptr,
                      const void* udeg, const void* ucolidx, const void* u2d,
                      const void* alive_in, const void* supp_in, const void* truss_in,
                      const void* cur_k_in, const void* kmax_in, const void* levels_in,
                      const void* iters_in, const void* done_in, const void* edges_in,
                      const void* titers_in, const void* frozen, const void* ftruss,
                      const void* single, void* alive, void* supp, void* truss, void* cur_k,
                      void* kmax, void* levels, void* iters, void* done, void* titers,
                      void* edges, void* ccol, void* calive, void* clane, void* cdeg, void* lists,
                      void* deaths, void* acc, void* counts, void* trip_log, void* stamps,
                      void* level_counts, const void* carry_lanes_in, const void* carry_flags_in,
                      const void* carry_len_in, void* carry_lanes, void* carry_flags,
                      void* carry_len, long long nnzp,
                      long long unnzp, int nrows,
                      int slot_nnz,
                      int num_slots, int block, int inner_limit, int split_row, int split_ways,
                      int trip_log_len, int held, int bsearch, int device, void* stream,
                      void* begin, void* end) {
  // Lanes are int32 in the worklists.
  if (nnzp <= 0 || nnzp > INT_MAX || nrows < 1 || num_slots < 1 || block < 1 || nnzp % block ||
      slot_nnz % block || split_ways < 1 || split_row < 0 || level_counts == nullptr ||
      (carry_lanes_in == nullptr) != (carry_flags_in == nullptr) ||
      (carry_lanes_in == nullptr) != (carry_len_in == nullptr) ||
      (carry_lanes == nullptr) != (carry_flags == nullptr) ||
      (carry_lanes == nullptr) != (carry_len == nullptr))
    return cudaErrorInvalidValue;
  Args args{
      static_cast<const int32_t*>(colidx),   static_cast<const int32_t*>(edge_row),
      static_cast<const int32_t*>(urowptr),  static_cast<const int32_t*>(udeg),
      static_cast<const int32_t*>(ucolidx),  static_cast<const int32_t*>(u2d),
      static_cast<const uint8_t*>(alive_in), static_cast<const int32_t*>(supp_in),
      static_cast<const int32_t*>(truss_in), static_cast<const int32_t*>(cur_k_in),
      static_cast<const int32_t*>(kmax_in),  static_cast<const int32_t*>(levels_in),
      static_cast<const int32_t*>(iters_in), static_cast<const uint8_t*>(done_in),
      static_cast<const int32_t*>(edges_in), static_cast<const int32_t*>(titers_in),
      static_cast<const uint8_t*>(frozen),   static_cast<const int32_t*>(ftruss),
      static_cast<const uint8_t*>(single),   static_cast<uint8_t*>(alive),
      static_cast<int32_t*>(supp),           static_cast<int32_t*>(truss),
      static_cast<int32_t*>(cur_k),          static_cast<int32_t*>(kmax),
      static_cast<int32_t*>(levels),         static_cast<int32_t*>(iters),
      static_cast<uint8_t*>(done),           static_cast<int32_t*>(titers),
      static_cast<int32_t*>(edges),          static_cast<int32_t*>(ccol),
      static_cast<uint8_t*>(calive),         static_cast<int32_t*>(clane),
      static_cast<int32_t*>(cdeg),           static_cast<int32_t*>(lists),
      static_cast<int32_t*>(deaths),         static_cast<int32_t*>(acc),
      static_cast<int32_t*>(counts),         static_cast<int32_t*>(trip_log),
      static_cast<int64_t*>(stamps),         static_cast<int64_t*>(level_counts),
      static_cast<const int32_t*>(carry_lanes_in),
      static_cast<const uint8_t*>(carry_flags_in),
      static_cast<const int32_t*>(carry_len_in),
      static_cast<int32_t*>(carry_lanes),     static_cast<uint8_t*>(carry_flags),
      static_cast<int32_t*>(carry_len),
      static_cast<int64_t>(nnzp),
      static_cast<int64_t>(unnzp),           nrows,
      slot_nnz, num_slots, block, inner_limit, split_row, split_ways, trip_log_len, held};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaEvent_t b = static_cast<cudaEvent_t>(begin), e = static_cast<cudaEvent_t>(end);
  const cudaError_t err =
      bsearch ? launch<true>(args, device, s, b, e) : launch<false>(args, device, s, b, e);
  // A refused call is reported here; clear it from the runtime's last-error
  // state so that it is not charged to the caller's next launch.
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// CTAs of the kernel per SM for `num_slots` slots (the cooperative grid is
// this times the SM count), or -(cudaError_t) when the query fails.
int peel_fused_blocks_per_sm(int bsearch, int num_slots) {
  const void* fn = bsearch ? reinterpret_cast<const void*>(&peel_fused_kernel<true>)
                           : reinterpret_cast<const void*>(&peel_fused_kernel<false>);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, kThreads, kSlotWords * sizeof(int32_t) * static_cast<size_t>(num_slots));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return per_sm;
}

const char* peel_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
