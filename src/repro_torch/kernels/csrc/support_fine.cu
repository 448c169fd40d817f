// Owner-mode fine-grained support (the paper's Alg. 3 computeSupports,
// collision-free form) for Hopper, sm_90a.
//
// Replaces repro/kernels/support_fine.py::support_fine_pallas together with
// the window gather that feeds it on the TPU (repro/kernels/ops.py::
// support_fine).  The TPU pre-gathers (E, W) windows because gathers are slow
// there; here each warp reads its own CSR rows, so no window array exists.
//
// Function: for each directed lane t with b = colidx[t] != 0 and alive[t],
//   out[t] = |{ c : (a, c) alive and (b, c) alive }|,  a = edge_row[t],
// over the undirected rows: row v starts at urowptr[v-1] (0 for v = 0) and
// holds udeg[v] entries of ucolidx, strictly ascending.  Row extents come
// from udeg, never from urowptr differences: the aligned layout leaves pad
// lanes between rows.  ualive[u] is the directed alive flag of undirected
// lane u (0 on pad lanes).  Every other lane gets 0.
//
// Design: one warp per directed lane, grid-stride.  The 32 lanes stride over
// a's row; each lane whose entry is alive binary-searches it in b's row and
// counts a hit only where the matching entry is alive; a shuffle reduction
// sums the warp.  The work is data-dependent (sum over alive edges of
// deg(a) * log2(deg(b)) probes) and the rows are reread from L2, so the
// kernel is bound by L2 latency of the dependent probes, far above the
// device-memory bound of its few MB of input.  Iterating the shorter row and
// splitting hub rows across warps are left for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65536;

__global__ void __launch_bounds__(kThreads)
support_fine_kernel(const int32_t* __restrict__ edge_row,
                    const int32_t* __restrict__ colidx,
                    const bool* __restrict__ alive,
                    const int32_t* __restrict__ urowptr,
                    const int32_t* __restrict__ udeg,
                    const int32_t* __restrict__ ucolidx,
                    const bool* __restrict__ ualive,
                    int32_t* __restrict__ out,
                    int64_t nnzp) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t num_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) / kWarp;

  for (int64_t t = warp; t < nnzp; t += num_warps) {
    // Warp-uniform: every lane of the warp reads the same t.
    const int32_t b = colidx[t];
    int count = 0;
    if (b != 0 && alive[t]) {
      const int32_t a = edge_row[t];
      const int32_t a0 = a > 0 ? urowptr[a - 1] : 0;
      const int32_t da = udeg[a];
      const int32_t b0 = b > 0 ? urowptr[b - 1] : 0;
      const int32_t db = udeg[b];
      for (int32_t i = lane; i < da; i += kWarp) {
        if (!ualive[a0 + i]) continue;
        const int32_t v = ucolidx[a0 + i];
        // Lower bound of v in b's strictly ascending row.
        int32_t lo = 0, hi = db;
        while (lo < hi) {
          const int32_t mid = (lo + hi) >> 1;
          if (ucolidx[b0 + mid] < v) lo = mid + 1; else hi = mid;
        }
        if (lo < db && ucolidx[b0 + lo] == v && ualive[b0 + lo]) ++count;
      }
    }
    for (int offset = kWarp / 2; offset > 0; offset /= 2)
      count += __shfl_down_sync(0xffffffffu, count, offset);
    if (lane == 0) out[t] = count;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int support_fine_launch(const void* edge_row, const void* colidx, const void* alive,
                        const void* urowptr, const void* udeg, const void* ucolidx,
                        const void* ualive, void* out, long long nnzp, void* stream) {
  if (nnzp <= 0) return 0;
  const long long warps_per_block = kThreads / kWarp;
  long long blocks = (nnzp + warps_per_block - 1) / warps_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  support_fine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edge_row), static_cast<const int32_t*>(colidx),
      static_cast<const bool*>(alive), static_cast<const int32_t*>(urowptr),
      static_cast<const int32_t*>(udeg), static_cast<const int32_t*>(ucolidx),
      static_cast<const bool*>(ualive), static_cast<int32_t*>(out),
      static_cast<int64_t>(nnzp));
  return static_cast<int>(cudaGetLastError());
}

const char* support_fine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
