// Dense linear-algebraic support (the paper's Alg. 1), S = (U @ U) o U, for
// Hopper, sm_90a.
//
// Replaces repro/kernels/support_dense.py::support_dense_pallas.  The TPU
// kernel walks a sequential (V/B)^3 grid with k innermost and carries the
// f32 sum of each output block in VMEM scratch from one grid step to the
// next.  Blocks of a CUDA grid run in no order, so here a CTA owns whole
// output tiles and loops over k itself: nothing carries over between CTAs.
//
// Function: U is a (V, V) 0/1 int8 matrix, row-major, V % 128 == 0; UT is
// its transpose, also row-major, written by transpose_kernel below into the
// wrapper's scratch before the product starts.  For every i, j
//   out[i, j] = float(sum_k U[i, k] * U[k, j]) * U[i, j]   (float32).
// UT[j, k] = U[k, j], so both operands of the product are read along k.
// wgmma takes 8-bit operands K-major only (no transpose bit as for 16-bit
// types), which is why B is UT and not U.  Nothing assumes that U is
// symmetric.  The sum is exact in int32 (it is at most V), and exact in
// float32 while V < 2^24.
//
// Bound on this card (H100 SXM): 2 V^3 int8 operations at 1,979 dense TOPS
// against V^2 bytes read for U, V^2 for UT (and U again for the mask) and
// 4 V^2 bytes written at 3.35 TB/s: compute-bound for any V above a few
// hundred.  At V = 32,896 (rmat-15, 1-based and padded) that is about 36 ms
// of operations against about 2 ms of bytes.
//
// Design (one persistent CTA per SM, warp-specialised):
// - Output tiles of 128 x 256, walked in a grouped order (kGroupM tiles
//   down, then across) so that the CTAs in flight share a band of U rows
//   and of UT rows in L2.  V / 256 may be odd (V = 32,896 is 128.5 tiles of
//   256): TMA zero-fills the rows of UT past V, and the store is masked.
// - Warpgroup 2 is the producer: one thread issues TMA tiled loads
//   (cp.async.bulk.tensor, 128-byte swizzle) of the 128 x 128 A box (rows
//   of U) and the 256 x 128 B box (rows of UT) into a ring of kStages
//   stages of 48 KB, completing on the stage's `full` mbarrier.
// - Warpgroups 0 and 1 are the consumers, 64 rows each: per stage four
//   wgmma.mma_async m64n256k32 s8 x s8 -> s32 read both operands from
//   shared memory through descriptors, 128 s32 accumulators a thread in
//   registers (setmaxnreg moves registers from the producer to them).  One
//   wgmma group stays in flight; each consumer warp frees a stage (its
//   `empty` mbarrier) once the group that read it has completed.
// - Epilogue: each accumulator times U[i, j], stored as float32 straight
//   from registers (32-byte runs per thread quad); meanwhile the producer
//   already loads the next tile's first stages.
// - Making UT moves 2 V^2 bytes (about 0.65 ms of bytes at V = 32,896).
//   torch's u.t().contiguous() takes several times that on the H100
//   (chip_smoke.py phase 7 times both), so the library has its own tiled
//   transpose.
#include <cuda.h>  // CUtensorMap and its enums (types only: no driver library is linked)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                       // tile rows (two consumer warpgroups of 64)
constexpr int kBN = 256;                       // tile columns (one wgmma n256)
constexpr int kBK = 128;                       // bytes of k per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kGroupM = 16;                    // tiles down per group of the tile order
constexpr int kABytes = kBM * kBK;             // 16 KB
constexpr int kBBytes = kBN * kBK;             // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;  // 48 KB
constexpr int kConsumers = 2;                  // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 /* 1024-byte alignment */ + 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int32_t k, int32_t row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row (1,024-byte) swizzle atoms one
// after another (stride byte offset 1,024; the leading byte offset is unused
// for swizzled K-major layouts).  The tile base is 1,024-byte aligned, so
// the base-offset field is 0; stepping k by 32 bytes inside the row adds to
// the start address.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 256 s32, this warpgroup's rows) += A (64 x 32 s8) * B (32 x 256 s8);
// with scale_d == 0 the old d is ignored (d = A * B).
__device__ __forceinline__ void wgmma_m64n256k32(int32_t (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The grouped tile order: kGroupM tiles down a column band, then the next
// column; the last band may be shorter.
__device__ __forceinline__ void tile_coords(int tile, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int group = tile / per_group;
  const int first_m = group * kGroupM;
  const int rows = min(tiles_m - first_m, kGroupM);
  const int in_group = tile - group * per_group;
  tm = first_m + in_group % rows;
  tn = in_group / rows;
}

__global__ void __launch_bounds__(kThreads, 1)
support_dense_kernel(const __grid_constant__ CUtensorMap map_u,
                     const __grid_constant__ CUtensorMap map_ut,
                     const int8_t* __restrict__ u, float* __restrict__ out, int v) {
  extern __shared__ uint8_t smem_raw[];
  // TMA with the 128-byte swizzle and wgmma both want 1,024-byte aligned tiles.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int tiles_m = v / kBM;
  const int tiles_n = (v + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int k_steps = v / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx arrival
      mbar_init(&empty[s], kConsumers * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warpgroup: give registers away; one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != kConsumers * 128) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_u)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_ut)) : "memory");
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int tm, tn;
      tile_coords(tile, tiles_m, tiles_n, tm, tn);
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every stage free
        uint8_t* sa = smem + stage * kStageBytes;
        mbar_expect_tx(&full[stage], kStageBytes);
        tma_load_2d(sa, &map_u, &full[stage], ks * kBK, tm * kBM);
        tma_load_2d(sa + kABytes, &map_ut, &full[stage], ks * kBK, tn * kBN);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroups 0 and 1: rows [64 wg, 64 wg + 64) of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  int stage = 0;
  uint32_t phase = 0;
  int32_t d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;  // never read: each tile's first wgmma ignores d
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int tm, tn;
    tile_coords(tile, tiles_m, tiles_n, tm, tn);
    int prev = -1;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint8_t* sa = smem + stage * kStageBytes + wg * 64 * kBK;
      const uint8_t* sb = smem + stage * kStageBytes + kABytes;
      const uint64_t da = smem_desc(sa), db = smem_desc(sb);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)  // +32 bytes of k = +2 in the descriptor's address
        wgmma_m64n256k32(d, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
      wgmma_commit();
      // The group before this one has completed: its stage is free.
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // Epilogue.  Accumulator 4 j + e of this thread sits at row
    // 16 warp + lane / 4 + 8 (e >> 1), column 8 j + 2 (lane % 4) + (e & 1)
    // of the warpgroup's 64 x 256 block.
    const int64_t row = static_cast<int64_t>(tm) * kBM + wg * 64 + warp * 16 + lane / 4;
    const int col0 = tn * kBN + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col < v) {  // the ragged last column tile; v and col are even
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t i = row + 8 * h;
          const char2 m = *reinterpret_cast<const char2*>(u + i * v + col);
          float2 r;
          r.x = static_cast<float>(d[4 * j + 2 * h]) * static_cast<float>(m.x);
          r.y = static_cast<float>(d[4 * j + 2 * h + 1]) * static_cast<float>(m.y);
          *reinterpret_cast<float2*>(out + i * v + col) = r;
        }
      }
    }
  }
}

// UT = U^T for a (v, v) int8 matrix, v % 128 == 0: one 128 x 128 tile per
// CTA, read in 16-byte rows into shared memory and written back as 16-byte
// rows of the transpose (rows padded to 132 bytes against bank conflicts).
constexpr int kTT = 128;
constexpr int kTPad = kTT + 4;

__global__ void __launch_bounds__(256) transpose_kernel(const int8_t* __restrict__ u,
                                                        int8_t* __restrict__ ut, int v) {
  __shared__ __align__(16) int8_t tile[kTT][kTPad];
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kTT;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kTT;
#pragma unroll
  for (int i = 0; i < kTT * kTT / 16 / 256; ++i) {
    const int idx = threadIdx.x + i * 256;  // 16-byte chunk: row idx / 8, bytes 16 (idx % 8)
    const int r = idx / 8, c = (idx % 8) * 16;
    const int4 x = *reinterpret_cast<const int4*>(u + (r0 + r) * v + c0 + c);
    const int32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) *reinterpret_cast<int32_t*>(&tile[r][c + 4 * q]) = w[q];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTT * kTT / 16 / 256; ++i) {
    const int idx = threadIdx.x + i * 256;  // output row idx / 8 (a column of the tile)
    const int r = idx / 8, c = (idx % 8) * 16;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t b = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b |= static_cast<uint32_t>(static_cast<uint8_t>(tile[c + 4 * q + e][r])) << (8 * e);
      w[q] = b;
    }
    *reinterpret_cast<int4*>(ut + (c0 + r) * v + r0 + c) =
        make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                  static_cast<int>(w[3]));
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (v, v) row-major int8 matrix seen as boxes of `rows` x 128 bytes.
bool make_map(CUtensorMap* map, const void* base, int v, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(v), static_cast<cuuint64_t>(v)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(v)};  // bytes between rows
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid_v(long long v) {
  // Exact in float32 while v < 2^24; the tile counts must fit the grids.
  return v > 0 && v % kBM == 0 && v / kTT <= 65535 &&
         (v / kBM) * ((v + kBN - 1) / kBN) <= 0x7fffffffLL;
}

cudaError_t launch_transpose(const void* u, void* ut, int v, cudaStream_t stream) {
  const int8_t* src = static_cast<const int8_t*>(u);
  int8_t* dst = static_cast<int8_t*>(ut);
  void* args[] = {&src, &dst, &v};
  return cudaLaunchKernel(reinterpret_cast<const void*>(&transpose_kernel), dim3(v / kTT, v / kTT),
                          dim3(256), args, 0, stream);
}

cudaError_t launch_product(const void* u, void* ut, void* out, int v, cudaStream_t stream) {
  CUtensorMap map_u, map_ut;
  if (!make_map(&map_u, u, v, kBM) || !make_map(&map_ut, ut, v, kBN)) return cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(&support_dense_kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long tiles = static_cast<long long>(v / kBM) * ((v + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  const int8_t* src = static_cast<const int8_t*>(u);
  float* dst = static_cast<float*>(out);
  void* args[] = {&map_u, &map_ut, &src, &dst, &v};
  return cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, kSmemBytes, stream);
}

// A refused call is reported to the caller; clear it from the runtime's
// last-error state so that it is not charged to the caller's next launch.
int report(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// UT = U^T on `stream` (the first half of support_dense_launch, on its own
// for timing); returns the cudaError_t of the launch (0 = success).
int support_dense_transpose(const void* u, void* ut, long long v, void* stream) {
  if (v == 0) return 0;
  if (!valid_v(v)) return static_cast<int>(cudaErrorInvalidValue);
  return report(launch_transpose(u, ut, static_cast<int>(v), static_cast<cudaStream_t>(stream)));
}

// Writes UT = U^T (scratch of v * v bytes), then launches the product, both
// on `stream`; returns the cudaError_t of the launches (0 = success).
int support_dense_launch(const void* u, void* ut, void* out, long long v, void* stream) {
  if (v == 0) return 0;
  if (!valid_v(v)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_transpose(u, ut, static_cast<int>(v), st);
  if (err == cudaSuccess) err = launch_product(u, ut, out, static_cast<int>(v), st);
  return report(err);
}

// Dynamic shared memory of the product kernel (the TMA ring, its alignment
// slack and the ring's barriers), in bytes.
int support_dense_smem_bytes() { return kSmemBytes; }

const char* support_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
