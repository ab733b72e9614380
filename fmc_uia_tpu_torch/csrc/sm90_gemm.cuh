// A bf16 TMA + wgmma GEMM for sm_90a, and the Hopper pieces around it that
// the Swin branch kernels (K1f, K1b, K2f, K2b) share: wgmma of every width
// they use, in both operand majors; TMA loads of 2-D and 4-D boxes; the
// host-side tensor maps of a row-major matrix and of a window of a
// [B, Hp, Wp, C] grid.
//
//   C(m, n) = sum_k A(m, k) B(k, n), f32 accumulation, into an epilogue
//   functor epi(m, n, slot, v) with v = C(m, n .. n + 7) for every n that
//   is a multiple of 8 (N % 8 == 0).
//   A(m, k) = A_MN ? A[k * lda + m] : A[m * lda + k]   (MN- or K-major)
//   B(k, n) = B_MN ? B[k * ldb + n] : B[n * ldb + k]
//
// Design. A block computes a kGemmM x BN (128 x 128; 96 or 64 where
// gemm_pick_bn finds a narrower tile fills the card better) tile of C over
// one slot of K (split-K: slot z covers [z kchunk, (z + 1) kchunk), kchunk
// a whole number of 64-deep chunks). One producer warp keeps a ring of
// kGemmStages A and B chunks in flight by TMA (128-byte swizzle, out-of-
// bounds rows and columns read as zeros), with a full and an empty
// mbarrier per stage; two consumer warpgroups, 64 rows of the tile each,
// run wgmma m64nBNk16 from shared memory with f32 accumulators, keep one
// chunk's products in flight while the previous stage is handed back, and
// run the epilogue on the accumulator fragment. Operand majors (see
// sm90_common.cuh): a K-major operand is one box of 64 k x 128 rows; an
// MN-major one is two boxes of 64 m (or n) x 64 k, one swizzle atom each,
// 8 KB apart (the leading byte offset of the descriptor), read with the
// transpose bit: no transposed copy is made. The f32 accumulator fragment
// of m64nN (thread t of warp w: rows 16 w + t / 4 and + 8, columns
// 8 i + 2 (t % 4) and + 1) is staged in shared memory and goes to the
// epilogue as 8 neighbouring columns of a row, for vector stores.
#pragma once

#include <atomic>
#include <initializer_list>

#include "sm90_common.cuh"

namespace sm90 {

typedef __nv_bfloat16 bf16_t;

// ---- more Hopper pieces ------------------------------------------------------
// The descriptor of sw128_desc with a leading byte offset (the distance
// between swizzle atoms along M or N of an MN-major operand wider than 64).
__device__ __forceinline__ uint64_t sw128_desc_lbo(const void* p,
                                                   uint32_t lbo_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}
constexpr uint64_t kDescRows16 = 2048 >> 4;  // 16 rows of 128 bytes

// Shared-memory writes by threads, made visible to wgmma and TMA (the
// async proxy) before they read them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of one warpgroup (named barrier 1 + wg; 0 is __syncthreads').
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Byte offset of element (r, c) of a bf16 tile of 64-element rows in the
// 128-byte swizzle TMA writes and wgmma reads.
__device__ __forceinline__ uint32_t sw128_off(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((((c >> 3) ^ r) & 7) << 4) +
                               ((c & 7) << 1));
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ---- thread block clusters ---------------------------------------------------
// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster that has not exited arrives, then waits for
// the others (release, then acquire: barrier inits and shared-memory work
// before it are visible to the cluster's blocks after it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One arrival on the mbarrier at bar's offset in the cluster's block cta
// (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// tma_load_2d into dst's offset of every block in `mask` (bit r: rank r),
// counted on the mbarrier at bar's offset in each of them.
__device__ __forceinline__ void tma_load_2d_mc(void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// ---- wgmma of width N --------------------------------------------------------
// Wg<N>::ss<TA, TB>(d, da, db, scale_d): d (64 x N, f32; N / 2 a thread)
// = A (64 x 16) B (16 x N) + (scale_d ? d : 0), both from shared memory;
// TA / TB = 1 reads that operand MN-major (the transpose bit).
// Wg<N>::rs<TB>(d, a, db, scale_d): the same with A from registers (the
// accumulator layout of 16 columns, rounded to bf16 pairs: acc_to_a).
template <int N>
struct Wg;

template <>
struct Wg<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <>
struct Wg<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <>
struct Wg<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <>
struct Wg<96> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wg<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};

template <>
struct Wg<192> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[96], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
  }
};
// ---- the GEMM ----------------------------------------------------------------
// The tile is kGemmM x BN: BN = kGemmN (128) but where a product's output
// tiles would leave most of the last wave's SMs idle (gemm_pick_bn: K2f's
// fc2 at C = 384 and 768), 96 or 64.
constexpr int kGemmM = 128, kGemmN = 128, kGemmK = 64;
constexpr int kGemmStages = 4;
using GemmRoles = WarpRoles<2>;

// An N-first product (NF) runs two blocks an SM with 3 stages each, so
// that one block's prologue and epilogue overlap the other's products;
// the others one block an SM with kGemmStages.
__host__ __device__ constexpr int gemm_stages(bool nf) {
  return nf ? 3 : kGemmStages;
}

template <int BN, int S>
struct GemmSmem {  // at the 1024-aligned start of dynamic shared memory
  bf16_t a[S][kGemmM * kGemmK];
  bf16_t b[S][BN * kGemmK];
  uint64_t full[S], empty[S];
  static constexpr uint32_t kStageBytes = (kGemmM + BN) * kGemmK * 2;
  // f32 pitch of the epilogue's staging tile (64 rows a warpgroup), padded
  // against bank conflicts; two of them fit in the stages
  static constexpr int kLdE = BN + 8;
  static_assert(2 * 64 * kLdE * 4 <= S * kStageBytes,
                "the epilogue's staging tiles must fit in the stages");
};
template <int BN, bool NF = false>
constexpr int gemm_smem_bytes() {
  return static_cast<int>(sizeof(GemmSmem<BN, gemm_stages(NF)>)) + 1024;
}

struct GemmDims {
  int M, N, K, kchunk;  // kchunk: depth of a slot, a multiple of kGemmK
};

// Tag names the pass that launches it (a profile tells them apart). NF:
// blockIdx.x walks the N tiles of the M tile blockIdx.y, two blocks an SM
// (else blockIdx.x walks the M tiles, one block an SM).
template <bool A_MN, bool B_MN, class Epi, class Tag, int BN = kGemmN,
          bool NF = false>
__global__ void __launch_bounds__(GemmRoles::kThreads, NF ? 2 : 1)
    gemm_sm90(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb, GemmDims g, Epi epi) {
  static_assert(!B_MN || BN == kGemmN, "an MN-major B takes 128-wide tiles");
  constexpr int kStages = gemm_stages(NF);  // this instance's ring
  using Smem = GemmSmem<BN, kStages>;
  Smem& s = *reinterpret_cast<Smem*>(smem_base_1k());
  const int m0 = (NF ? blockIdx.y : blockIdx.x) * kGemmM;
  const int n0 = (NF ? blockIdx.x : blockIdx.y) * BN;
  const int z = blockIdx.z;
  const int kb = z * g.kchunk;
  const int ke = min(g.K, kb + g.kchunk);
  const int nk = (ke - kb + kGemmK - 1) / kGemmK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], GemmRoles::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp
    if (threadIdx.x == GemmRoles::kProducerThread) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % kStages, k0 = kb + i * kGemmK;
        mbar_wait(&s.empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], Smem::kStageBytes);
        if (A_MN) {
          tma_load_2d(s.a[st], &ta, &s.full[st], m0, k0);
          tma_load_2d(s.a[st] + 64 * kGemmK, &ta, &s.full[st], m0 + 64, k0);
        } else {
          tma_load_2d(s.a[st], &ta, &s.full[st], k0, m0);
        }
        if (B_MN) {
          tma_load_2d(s.b[st], &tb, &s.full[st], n0, k0);
          tma_load_2d(s.b[st] + 64 * kGemmK, &tb, &s.full[st], n0 + 64, k0);
        } else {
          tma_load_2d(s.b[st], &tb, &s.full[st], k0, n0);
        }
      }
    }
    return;
  }
  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile
  constexpr uint64_t kAStep = A_MN ? kDescRows16 : kDescKStep;
  constexpr uint64_t kBStep = B_MN ? kDescRows16 : kDescKStep;
  // No other instruction touches acc until the last wait (the first
  // product ignores its old value): one that did would make the compiler
  // serialise the wgmmas.
  float acc[BN / 2];
  for (int i = 0; i < nk; ++i) {
    const int st = i % kStages;
    mbar_wait_warp(&s.full[st], (i / kStages) & 1);
    const uint64_t da = sw128_desc(s.a[st] + wg * 64 * kGemmK);
    const uint64_t db = B_MN ? sw128_desc_lbo(s.b[st], 64 * kGemmK * 2)
                             : sw128_desc(s.b[st]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kGemmK / 16; ++ks)
      Wg<BN>::template ss<A_MN, B_MN>(acc, da + ks * kAStep,
                                      db + ks * kBStep, i > 0 || ks > 0);
    wg_commit();
    wg_wait<1>();  // chunk i - 1's products are done: hand its stage back
    if (i > 0) warp_arrive(&s.empty[(i - 1) % kStages]);
  }
  wg_wait<0>();
  fence_regs(acc);

  // Epilogue: the fragment goes through shared memory (the stages, free
  // once both warpgroups' products are done), so that each thread hands
  // the functor 8 neighbouring columns of a row and the stores are 16- or
  // 32-byte vectors, a row's BN columns by BN / 8 neighbouring threads.
  asm volatile("bar.sync 3, %0;\n" ::"n"(2 * kWgThreads) : "memory");
  constexpr int kLdE = Smem::kLdE, kRowThreads = BN / 8;
  float* stage = reinterpret_cast<float*>(&s) + wg * 64 * kLdE;
  const int tid = threadIdx.x % kWgThreads, lane = tid & 31;
  const int fr = (tid >> 5) * 16 + (lane >> 2), fc = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    *reinterpret_cast<float2*>(stage + fr * kLdE + 8 * i + fc) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(stage + (fr + 8) * kLdE + 8 * i + fc) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  wg_bar(wg);
#pragma unroll 4
  for (int q = tid; q < 64 * kRowThreads; q += kWgThreads) {
    const int r = q / kRowThreads, col = 8 * (q % kRowThreads);
    const int m = m0 + wg * 64 + r, n = n0 + col;
    if (m >= g.M || n >= g.N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(stage + r * kLdE +
                                                       col);
    const float4 hi = *reinterpret_cast<const float4*>(stage + r * kLdE +
                                                       col + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    epi(m, n, z, v);
  }
}

// ---- host -----------------------------------------------------------------------
// The 2-D tiled map of a bf16 row-major matrix of `rows` rows of `cols`
// elements (row pitch `ld` elements): boxes of 64 columns x box_rows rows,
// 128-byte swizzle, out-of-bounds elements read as zeros.
inline int make_map_2d(CUtensorMap* m, const void* base, long long cols,
                       long long rows, long long ld, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// The 4-D map (c, w, h, b) of a contiguous bf16 [B, Hp, Wp, Ct] grid with
// boxes of 64 channels x ws x ws tokens: one window's N = ws^2 tokens of 64
// channels land as N rows of 128 bytes in token order. The same geometry
// as ops/swin_block.py window_tma_layout, which checks it on the host.
inline int make_map_window(CUtensorMap* m, const void* base, int B, int Hp,
                           int Wp, int Ct, int ws) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Ct),
                              static_cast<cuuint64_t>(Wp),
                              static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(Ct) * 2;
  const cuuint64_t strides[3] = {row, row * Wp, row * Wp * Hp};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(ws),
                             static_cast<cuuint32_t>(ws), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// Allow `bytes` of dynamic shared memory to `kernel` on the current device,
// once per device: `done`, a static of the caller (one per kernel, always
// asked for the same bytes), keeps a bit per device, since the call costs
// host time on every launch otherwise.
inline int smem_limit_once(std::atomic<unsigned long long>& done,
                           const void* kernel, int bytes) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 64;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

// The slots of a split-K product: kchunk tokens each (a multiple of
// kGemmK), the last one short. ops/swin_block.py split_k_plan picks
// kchunk and counts the slots the same way.
inline int gemm_slots(long long K, int kchunk) {
  return static_cast<int>((K + kchunk - 1) / kchunk);
}

// C = A B into epi over M x N, K split into slots of kchunk (kchunk >= K:
// one slot), in tiles of kGemmM x BN. A and B are bf16 with 16-byte
// aligned bases and pitches. Tag: the launching pass, in the kernel's
// name only. NF (N-first) for a product whose A, token rows, is larger
// than L2 and whose B, weights, is small: neighbouring blocks take the N
// tiles of one M tile and share A's rows (M-first, an A larger than L2
// is read from device memory once per N tile).
template <bool A_MN, bool B_MN, class Tag = void, int BN = kGemmN,
          bool NF = false, class Epi>
int gemm_run(const bf16_t* A, long long lda, const bf16_t* B, long long ldb,
             int M, int N, int K, int kchunk, Epi epi, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || N % 8 || kchunk % kGemmK ||
      kchunk < kGemmK || reinterpret_cast<size_t>(A) % 16 ||
      reinterpret_cast<size_t>(B) % 16 || lda % 8 || ldb % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int rc = A_MN ? make_map_2d(&ta, A, M, K, lda, 64)
                : make_map_2d(&ta, A, K, M, lda, kGemmM);
  if (rc == 0)
    rc = B_MN ? make_map_2d(&tb, B, N, K, ldb, 64)
              : make_map_2d(&tb, B, K, N, ldb, BN);
  static std::atomic<unsigned long long> smem_set{0};
  if (rc == 0)
    rc = smem_limit_once(
        smem_set,
        reinterpret_cast<const void*>(gemm_sm90<A_MN, B_MN, Epi, Tag, BN, NF>),
        gemm_smem_bytes<BN, NF>());
  if (rc != 0) return rc;
  const unsigned mt = (M + kGemmM - 1) / kGemmM, nt = (N + BN - 1) / BN;
  if ((NF ? mt : nt) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(NF ? nt : mt, NF ? mt : nt, gemm_slots(K, kchunk));
  gemm_sm90<A_MN, B_MN, Epi, Tag, BN, NF><<<grid, GemmRoles::kThreads,
                                            gemm_smem_bytes<BN, NF>(),
                                            stream>>>(
      ta, tb, GemmDims{M, N, K, kchunk}, epi);
  return static_cast<int>(cudaGetLastError());
}

// The SMs of the current device (asked once a process; 132 on an H100 SXM).
inline int device_sms() {
  static std::atomic<int> sms{0};
  int n = sms.load(std::memory_order_relaxed);
  if (n > 0) return n;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1) {
    cudaGetLastError();
    n = 132;
  }
  sms.store(n, std::memory_order_relaxed);
  return n;
}

// The N tile of an M x N product (one slot, one block an SM) that leaves
// the least idle: the columns a block runs in its wave count, summed over
// the waves, ceil(tiles / SMs) x BN, the least of BN = 128, 96, 64 (ties
// to the wider tile, which reads A fewer times). At C = 768 and 2,048
// tokens, fc2's 16 x 6 tiles of 128 fill 96 of 132 SMs; 16 x 8 of 96 fill
// 128 in one wave of three quarters the work.
inline int gemm_pick_bn(long long M, long long N) {
  const long long sms = device_sms(), mt = (M + kGemmM - 1) / kGemmM;
  int best = kGemmN;
  long long cost = -1;
  for (int bn : {128, 96, 64}) {
    const long long tiles = mt * ((N + bn - 1) / bn);
    const long long c = (tiles + sms - 1) / sms * bn;
    if (cost < 0 || c < cost) {
      cost = c;
      best = bn;
    }
  }
  return best;
}

// ---- epilogues (8 neighbouring columns n .. n + 7 of row m) ------------------
__device__ __forceinline__ void store_bf16x2(bf16_t* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 8 values rounded to bf16 into 16 bytes at p
__device__ __forceinline__ void store_bf16x8(bf16_t* p, const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store_f32x8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

struct EpiOutBf16 {  // out[m, n] = round(v (+ bias[n]))
  bf16_t* out;
  long long ld;
  const float* bias;
  __device__ void operator()(int m, int n, int, const float (&v)[8]) const {
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = bias ? v[j] + bias[n + j] : v[j];
    store_bf16x8(out + m * ld + n, w);
  }
};

struct EpiOutF32 {  // out[m, n] = v
  float* out;
  long long ld;
  __device__ void operator()(int m, int n, int, const float (&v)[8]) const {
    store_f32x8(out + m * ld + n, v);
  }
};

struct EpiSlot {  // part[slot][m][n] = v: split-K partials, summed in order
  float* part;
  int M, N;
  __device__ void operator()(int m, int n, int z, const float (&v)[8]) const {
    store_f32x8(part + (static_cast<long long>(z) * M + m) * N + n, v);
  }
};

}  // namespace sm90
