// Dense linear-algebraic support (the paper's Alg. 1), S = (U @ U) o U, for
// Hopper, sm_90a.
//
// Replaces repro/kernels/support_dense.py::support_dense_pallas.  The TPU
// kernel walks a sequential (V/B)^3 grid with k innermost and carries the
// f32 sum of each output block in VMEM scratch from one grid step to the
// next.  Blocks of a CUDA grid run in no order, so here one CTA owns a
// 128 x 128 output tile and loops over k itself: nothing carries over
// between CTAs.
//
// Function: U is a (V, V) 0/1 int8 matrix, row-major, V % 128 == 0; UT is
// its transpose, also row-major (the wrapper makes it).  For every i, j
//   out[i, j] = float(sum_k U[i, k] * U[k, j]) * U[i, j]   (float32).
// UT[j, k] = U[k, j], so both operands of the product are read along k
// ("NT").  Nothing assumes that U is symmetric.  The sum is taken exactly
// in int32 (it is at most V), and is exact in float32 while V < 2^24.
//
// Design: 256 threads (8 warps, 2 along M x 4 along N, each 64 x 32
// outputs).  The k loop takes 64 bytes of k per step: the 128 x 64 tiles of
// U and UT are staged in shared memory with 16-byte cp.async, double
// buffered, rows padded to 80 bytes so ldmatrix reads them without bank
// conflicts.  Plain ldmatrix (both operands are k-contiguous) feeds
// mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor cores.  The epilogue
// multiplies by U[i, j] and writes float32.
//
// Bound on this card (H100 SXM): 2 V^3 int8 operations at 1,979 dense TOPS
// against V^2 bytes read for U, V^2 for UT (and U again for the mask) and
// 4 V^2 bytes written at 3.35 TB/s: compute-bound for any V above a few
// hundred.  At V = 32,896 (rmat-15, 1-based and padded) that is about 36 ms
// of operations against about 2 ms of bytes.  The design keeps the tensor
// cores fed from shared memory (each staged byte feeds 128 products), but
// mma.sync without wgmma, TMA or a persistent grid does not reach the
// card's full int8 rate; those are for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;         // outputs per CTA along M and along N
constexpr int kStep = 64;          // bytes of k per pipeline stage
constexpr int kRow = kStep + 16;   // padded shared-memory row (bytes)
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 inputs, s32 accumulators.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
support_dense_kernel(const int8_t* __restrict__ u, const int8_t* __restrict__ ut,
                     float* __restrict__ out, int64_t v) {
  // [stage][row][byte]: rows of U (A operand) and of UT (B operand).
  __shared__ __align__(128) int8_t sa[2][kTile][kRow];
  __shared__ __align__(128) int8_t sb[2][kTile][kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 0..1: 64 rows each
  const int warp_n = warp & 3;   // 0..3: 32 columns each
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t k_steps = v / kStep;

  // Each stage is 2 x 128 rows x 4 chunks of 16 bytes: 4 chunks a thread.
  auto load_stage = [&](int stage, int64_t k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;  // 0..511
      const int r = c >> 2;
      const int b = (c & 3) * 16;
      cp_async16(&sa[stage][r][b], u + (row0 + r) * v + k0 + b);
      cp_async16(&sb[stage][r][b], ut + (col0 + r) * v + k0 + b);
    }
  };

  int32_t acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix.x4 row addresses: lanes 8q..8q+7 give the rows of matrix q.
  // A (16 x 32 bytes): matrices (rows 0-7, k 0-15), (rows 8-15, k 0-15),
  // (rows 0-7, k 16-31), (rows 8-15, k 16-31) = the a0..a3 registers of
  // mma.m16n8k32.  B (two n-tiles of 8 x 32 bytes from UT): matrices
  // (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31)
  // = b0, b1 of the first n-tile, then b0, b1 of the second.
  const int q = lane >> 3;
  const int a_row = (q & 1) * 8 + (lane & 7);
  const int a_col = (q >> 1) * 16;
  const int b_row = (q >> 1) * 8 + (lane & 7);
  const int b_col = (q & 1) * 16;

  load_stage(0, 0);
  cp_async_commit();
  for (int64_t ks = 0; ks < k_steps; ++ks) {
    const int stage = static_cast<int>(ks & 1);
    if (ks + 1 < k_steps) load_stage(stage ^ 1, (ks + 1) * kStep);
    cp_async_commit();
    cp_async_wait<1>();  // this step's stage has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 32) {
      uint32_t a[4][4];
      uint32_t b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], &sa[stage][warp_m * 64 + mi * 16 + a_row][kk + a_col]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(b[nj], &sb[stage][warp_n * 32 + nj * 16 + b_row][kk + b_col]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  // Epilogue: accumulator e of an m16n8 tile sits at row g + 8 * (e >> 1),
  // column 2 * t + (e & 1), where g = lane / 4 and t = lane % 4.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t i = row0 + warp_m * 64 + mi * 16 + g + half * 8;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int64_t j = col0 + warp_n * 32 + ni * 8 + 2 * t;
        const char2 m = *reinterpret_cast<const char2*>(u + i * v + j);
        float2 r;
        r.x = static_cast<float>(acc[mi][ni][half * 2]) * static_cast<float>(m.x);
        r.y = static_cast<float>(acc[mi][ni][half * 2 + 1]) * static_cast<float>(m.y);
        *reinterpret_cast<float2*>(out + i * v + j) = r;
      }
    }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int support_dense_launch(const void* u, const void* ut, void* out, long long v, void* stream) {
  if (v == 0) return 0;
  if (v < 0 || v % kTile || v / kTile > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(v / kTile), static_cast<unsigned>(v / kTile));
  support_dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(u), static_cast<const int8_t*>(ut), static_cast<float*>(out),
      static_cast<int64_t>(v));
  return static_cast<int>(cudaGetLastError());
}

const char* support_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
