// Hopper (sm_90a) building blocks shared by the hand-written bf16 kernels
// (K4f/K4b's global attention, K1f/K1b's Swin attention branch and their
// GEMM, sm90_gemm.cuh): mbarriers, bulk copies into shared memory, the
// roles of a producer warp and consumer warpgroups, the warpgroup product
// wgmma with the shared-memory descriptors that match TMA's 128-byte
// swizzle, and the host-side encoder of tensor maps.
//
// Tiles: a bf16 tile is rows of 64 elements (128 bytes), loaded by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned buffer: row r at byte
// 128 r, its 16-byte chunk j at chunk j ^ (r % 8). That is wgmma's
// canonical 128-byte-swizzled layout in both majors:
//  * K-major (the product's depth runs along the row): 8-row groups 1024
//    bytes apart (the stride byte offset); a k-step of 16 elements advances
//    the start address by 32 bytes.
//  * MN-major (the depth runs down the rows): one 64-wide swizzle atom
//    across the rows' 64 columns, groups of 8 depth rows 1024 bytes apart;
//    a k-step of 16 rows advances the start address by 2048 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link: the encoder
                   // comes through cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
constexpr int kWgThreads = 128;             // a warpgroup

// A block of kConsumers consumer warpgroups (warps 0 .. 4 kConsumers - 1:
// wgmma takes warpgroups of 4 warps starting at a multiple of 4) and one
// producer warp after them. A thread's registers are bounded by its share
// of an SM sub-partition's 16,384 when the block's warps are dealt over
// the four: 168 for 9 warps (2 consumers), 128 for 13 (3). setmaxnreg,
// which hands a producer warpgroup's registers to the consumers at run
// time, did not raise the compiler's allocation above that bound (the
// dK/dV pass spilled at 168 under a 232-register consumer budget), so the
// producer is one warp and no warpgroup idles beside it.
template <int kConsumers>
struct WarpRoles {
  static constexpr int kThreads = kConsumers * kWgThreads + 32;
  static constexpr int kConsumerWarps = 4 * kConsumers;  // empty arrivals
  static constexpr int kProducerThread = kConsumers * kWgThreads;
};
constexpr long long kSpinLimit = 1ll << 28; // a lost barrier traps, not hangs

// ---- mbarriers ----------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A barrier that
// never completes (a fault in the pipeline) traps after kSpinLimit polls
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (long long i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (i > kSpinLimit) __trap();
  }
}

// mbar_wait by a whole warp, reconverged before the .aligned wgmma ops
__device__ __forceinline__ void mbar_wait_warp(uint64_t* bar,
                                               uint32_t parity) {
  mbar_wait(bar, parity);
  __syncwarp();
}

// One arrival per consumer warp (lane 0, after the warp's reads are done).
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// ---- bulk copies ---------------------------------------------------------
// `bytes` (a multiple of 16, both ends 16-byte aligned) of contiguous
// device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- warp specialisation --------------------------------------------------
// This thread's warpgroup (the producer warp's is kConsumers), made
// warp-uniform for the compiler by a shuffle from lane 0.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWgThreads,
                     0);
}

// The 1024-aligned start of the dynamic shared memory (allocate 1 KB more).
__device__ __forceinline__ unsigned char* smem_base_1k() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return smem_raw + (((a + 1023u) & ~1023u) - a);
}

// ---- wgmma ----------------------------------------------------------------
// Shared-memory descriptor of a 128-byte-swizzled tile starting at p
// (1024-aligned, or offset from such a start by whole k-steps): start
// address >> 4, leading byte offset 16 (unused by these shapes), stride
// byte offset 1024 (>> 4 = 64), layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// descriptor steps, in the 16-byte units of the start-address field
constexpr uint64_t kDescKStep = 32 >> 4;                  // K-major, 16 cols

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue / wait points.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Accumulator layout of wgmma m64nN (f32): warp w of the warpgroup holds
// rows 16 w .. 16 w + 15; with g = lane / 4, c = 2 (lane % 4), element
// 4 i + e sits at row 16 w + g + 8 (e / 2), column 8 i + c + (e % 2).
// The A-from-registers layout of a 64 x 16 bf16 slice is the same per
// 16 columns, so a k-step kk of P (or dS) takes accumulator chunks 2 kk and
// 2 kk + 1 as they are, rounded to bf16 pairs.
template <int R, int K>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[K][4],
                                         const float (&x)[R]) {
  static_assert(R == 8 * K, "a k-step of 16 columns per 8 accumulators");
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, f32) = A (64 x 16, shared) * B (128 x 16, shared, K-major)
// + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) = A (64 x 16, shared) * B (64 x 16, shared, K-major)
// + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, shared,
// MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Error codes of the entry points beyond CUDA's own (negative, so never a
// cudaError_t): the driver has no cuTensorMapEncodeTiled, or it refused a
// map.
constexpr int kErrNoEncoder = -1;
constexpr int kErrTensorMap = -2;

}  // namespace sm90
